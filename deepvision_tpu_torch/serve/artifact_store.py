"""Persistent on-disk artifact store for the serving tier.

The port of ``deepvision_tpu/serve/artifact_store.py``. Serialized
request programs (``export.export_callable`` bytes: the forward and the
task head, weights inside) are keyed like the runner cache's buckets,
(model, bucket, dtype, device, weights fingerprint), so that a fresh
server warms its runners FROM DISK instead of re-tracing every (model,
bucket) pair.

Integrity follows the checkpoint manifest (``train/manifest.py``): every
blob is recorded in ``manifest.json`` with its size and SHA-256, writes
stage through a tmp file unique to the writer (pid and a counter) and
commit with one atomic ``os.replace``, and a blob that fails
verification on read is MOVED to ``quarantine/`` (evidence, not
deletion) while the caller traces the model instead. Several servers can
therefore share one ``--store DIR``: concurrent writers each stage
complete bytes, every manifest commit first folds in sibling entries it
finds on disk (so one server's commit does not orphan another's blobs;
keys this process quarantined stay dead), and a writer killed mid-stage
leaves only its own tmp file, which readers ignore.

Concurrency: byte I/O never happens under ``_lock``. The in-process
authority is an in-memory entries dict that the lock protects; blob
bytes and manifest snapshots are staged to writer-unique tmp files
outside the lock, and only the atomic ``os.replace`` commit (guarded by
a snapshot sequence number, so that an older snapshot never overwrites a
newer one) happens inside it.

The weights fingerprint in the key keeps a program exported under one
generation of weights from ever pairing with another.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import threading
from pathlib import Path

__all__ = ["ArtifactStore", "device_desc"]

STORE_VERSION = 1

_tmp_seq = itertools.count()


def device_desc(device) -> str:
    """Canonical device descriptor for store keys: the platform, the
    compute capability and the device count (``cuda:sm_90:1``,
    ``cpu:1``). A program exported for one card architecture is never
    offered to another."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return f"cuda:sm_{major}{minor}:{torch.cuda.device_count()}"
    return f"{device.type}:1"


def _entry_key(model: str, bucket: int, dtype: str, device: str,
               fingerprint: str) -> str:
    return f"{model}|{bucket}|{dtype}|{device}|{fingerprint}"


def _load_manifest_entries(path: Path) -> dict:
    try:
        data = json.loads(path.read_text())
        entries = data.get("entries")
        if not isinstance(entries, dict):
            raise ValueError("manifest has no entries mapping")
        return entries
    except (OSError, ValueError):
        return {}


class ArtifactStore:
    """Content-verified blob store under one root directory.

    Layout::

        root/manifest.json          # key -> {file, size, sha256, ...}
        root/blobs/<model>/<hash>.pt2
        root/quarantine/            # blobs that failed verification

    ``get`` returns the verified bytes or ``None`` (a miss, or a corrupt
    entry quarantined): callers always trace the model instead, so the
    store never makes serving less available than no store at all.
    """

    def __init__(self, root: str | Path, *, log=print):
        self.root = Path(root)
        self._log = log
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.quarantined = 0
        (self.root / "blobs").mkdir(parents=True, exist_ok=True)
        # in-process authority for entries; disk is re-consulted on a
        # miss so another server's puts stay visible (shared --store)
        self._entries = _load_manifest_entries(self._manifest_path)
        self._snap_seq = 0       # snapshot sequence, taken under _lock
        self._committed_seq = 0  # newest snapshot committed to disk
        # tombstones: keys THIS process quarantined. The pre-commit
        # merge of sibling servers' on-disk entries must not resurrect
        # them (a re-put with fresh bytes clears the stone).
        self._removed: set[str] = set()

    # -- manifest ---------------------------------------------------------
    @property
    def _manifest_path(self) -> Path:
        return self.root / "manifest.json"

    def _snapshot_locked(self) -> tuple[int, dict]:
        """Consistent manifest snapshot + its sequence number. Caller
        must hold ``_lock``; the snapshot is written to disk AFTER
        releasing it."""
        self._snap_seq += 1
        return self._snap_seq, {
            "version": STORE_VERSION,
            "entries": {k: dict(v) for k, v in self._entries.items()},
        }

    def _commit_manifest(self, seq: int, manifest: dict) -> None:
        """Merge, stage, commit. Replacing the whole entries dict
        last-writer-wins would orphan blobs that sibling servers
        committed since our last look (their valid artifacts would be
        traced again at every start), so entries on the shared on-disk
        manifest that this process neither knows nor quarantined are
        folded in first; then the snapshot stages through a
        writer-unique tmp file and commits with one atomic
        ``os.replace``, guarded so that a slower writer holding an OLDER
        snapshot never clobbers a newer committed one. The
        cross-process merge is best-effort (no file lock); a commit
        racing a sibling's is healed by the next merge, because the
        adopted entries persist in ``_entries``."""
        disk = _load_manifest_entries(self._manifest_path)
        with self._lock:
            if seq <= self._committed_seq:
                return  # superseded before staging; nothing written
            for k, v in disk.items():
                if k not in self._entries and k not in self._removed:
                    self._entries[k] = dict(v)
                    manifest["entries"][k] = dict(v)
            payload = json.dumps(manifest, indent=0, sort_keys=True)
        tmp = self._manifest_path.with_suffix(
            f".json.tmp.{os.getpid()}.{next(_tmp_seq)}")
        tmp.write_text(payload)
        with self._lock:
            if seq > self._committed_seq:
                os.replace(tmp, self._manifest_path)
                self._committed_seq = seq
                return
        tmp.unlink(missing_ok=True)  # superseded snapshot

    def entries(self) -> dict:
        """The current manifest entries (key -> metadata dict)."""
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    # -- put / get --------------------------------------------------------
    def put(self, data: bytes, *, model: str, bucket: int, dtype: str,
            device: str, fingerprint: str) -> Path:
        """Persist one artifact: stage the blob through a writer-unique
        tmp file, commit with ``os.replace``, then commit the manifest
        entry the same way. Idempotent for identical content."""
        key = _entry_key(model, bucket, dtype, device, fingerprint)
        digest = hashlib.sha256(data).hexdigest()
        # human-greppable model dir; the rest of the key hashed into
        # the filename (device/dtype strings carry separators)
        blob_rel = Path("blobs") / model / (
            hashlib.sha256(key.encode()).hexdigest()[:24] + ".pt2")
        target = self.root / blob_rel
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(
            f".pt2.tmp.{os.getpid()}.{next(_tmp_seq)}")
        tmp.write_bytes(data)
        os.replace(tmp, target)
        with self._lock:
            self._entries[key] = {
                "file": str(blob_rel), "size": len(data),
                "sha256": digest, "model": model, "bucket": int(bucket),
                "dtype": dtype, "device": device, "fingerprint": fingerprint,
            }
            self._removed.discard(key)  # fresh bytes revive the key
            self.puts += 1
            seq, manifest = self._snapshot_locked()
        self._commit_manifest(seq, manifest)
        return target

    def get(self, *, model: str, bucket: int, dtype: str, device: str,
            fingerprint: str) -> bytes | None:
        """Verified bytes for one key, or ``None``. A manifest entry
        whose blob is missing, truncated, or hash-mismatched is
        quarantined on the way past and reported as a miss: the caller
        traces the model instead."""
        key = _entry_key(model, bucket, dtype, device, fingerprint)
        with self._lock:
            want = self._entries.get(key)
        if want is None:
            # another server sharing the store may have exported it since
            # our last look: re-consult the shared on-disk manifest
            disk = _load_manifest_entries(self._manifest_path).get(key)
            if disk is None:
                with self._lock:
                    self.misses += 1
                return None
            with self._lock:
                want = self._entries.setdefault(key, dict(disk))
                self._removed.discard(key)  # sibling re-published it
        path = self.root / want.get("file", "")
        try:
            data = path.read_bytes()
            if len(data) != want["size"]:
                raise ValueError(
                    f"size mismatch: {len(data)} != {want['size']}")
            if hashlib.sha256(data).hexdigest() != want["sha256"]:
                raise ValueError("checksum mismatch")
        except (OSError, ValueError, KeyError, TypeError) as e:
            self._quarantine(key, want, reason=str(e))
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return data

    def reject(self, *, model: str, bucket: int, dtype: str, device: str,
               fingerprint: str, reason: str) -> None:
        """Quarantine a verified-but-unusable entry: the bytes passed
        integrity checks but the program cannot run here (a program of
        another shape under the key, an op this process cannot
        resolve). Rejecting it keeps every later warm-up from paying the
        same failed load and run before tracing."""
        key = _entry_key(model, bucket, dtype, device, fingerprint)
        with self._lock:
            entry = self._entries.get(key)
        if entry is not None:
            self._quarantine(key, entry, reason=reason)

    def _quarantine(self, key: str, entry: dict, *, reason: str) -> None:
        """Move a failing blob to ``quarantine/`` (evidence, not
        deletion) and drop its manifest entry, mirroring
        ``train/manifest.newest_verified_epoch``."""
        self._log(f"[artifact-store] {key}: {reason}; quarantining",
                  flush=True)
        qroot = self.root / "quarantine"
        qroot.mkdir(exist_ok=True)
        src = self.root / entry.get("file", "")
        if src.is_file():
            target = qroot / src.name
            n = 0
            while target.exists():
                n += 1
                target = qroot / f"{src.name}.{n}"
            shutil.move(str(src), str(target))
        with self._lock:
            self._entries.pop(key, None)
            self._removed.add(key)  # merge must not resurrect it
            self.quarantined += 1
            seq, manifest = self._snapshot_locked()
        self._commit_manifest(seq, manifest)

    # -- observability ----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "root": str(self.root),
                "entries": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "puts": self.puts, "quarantined": self.quarantined,
            }
