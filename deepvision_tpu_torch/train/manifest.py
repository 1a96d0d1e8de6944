"""Checkpoint integrity manifests, a copy of
``deepvision_tpu/train/manifest.py``.

A committed epoch's sidecar ``manifest-<epoch>.json`` records each file's
size and SHA-256 under the epoch's directory. ``write_manifest`` stages
through a temporary file unique to the writer and commits with one
atomic ``os.replace``, so a reader sees the old or the new manifest,
never a torn one.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
from pathlib import Path

__all__ = ["MANIFEST_VERSION", "manifest_path", "step_dir", "write_manifest",
           "verify_manifest", "fs_epochs", "newest_verified_epoch"]

MANIFEST_VERSION = 1

_tmp_seq = itertools.count()


def _hash_file(path: Path) -> str:
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


def manifest_path(root: str | Path, epoch: int) -> Path:
    return Path(root) / f"manifest-{epoch}.json"


def step_dir(root: str | Path, epoch: int) -> Path:
    return Path(root) / str(epoch)


def write_manifest(root: str | Path, epoch: int) -> None:
    """Hash the committed epoch directory into its sidecar."""
    root = Path(root)
    sdir = step_dir(root, epoch)
    if not sdir.exists():
        return
    files = {
        str(p.relative_to(sdir)): {"size": p.stat().st_size,
                                   "sha256": _hash_file(p)}
        for p in sorted(sdir.rglob("*")) if p.is_file()
    }
    manifest = {"version": MANIFEST_VERSION, "epoch": int(epoch),
                "files": files}
    target = manifest_path(root, epoch)
    tmp = target.with_suffix(f".json.tmp.{os.getpid()}.{next(_tmp_seq)}")
    tmp.write_text(json.dumps(manifest))
    os.replace(tmp, target)


def verify_manifest(root: str | Path, epoch: int) -> tuple[bool, str]:
    """-> (ok, reason). An epoch with no manifest verifies vacuously; an
    unreadable or mismatching manifest fails it."""
    root = Path(root)
    sdir = step_dir(root, epoch)
    if not sdir.exists():
        return False, "step directory missing"
    mp = manifest_path(root, epoch)
    if not mp.exists():
        return True, "no manifest (pre-integrity checkpoint)"
    try:
        manifest = json.loads(mp.read_text())
        for rel, want in manifest["files"].items():
            p = sdir / rel
            if not p.is_file():
                return False, f"missing file {rel}"
            if p.stat().st_size != want["size"]:
                return False, (f"size mismatch {rel}: "
                               f"{p.stat().st_size} != {want['size']}")
            if _hash_file(p) != want["sha256"]:
                return False, f"checksum mismatch {rel}"
    except (ValueError, KeyError, TypeError, AttributeError, OSError) as e:
        return False, f"unreadable/malformed manifest: {e}"
    return True, "ok"


def fs_epochs(root: str | Path) -> list[int]:
    """Epoch directories on disk, ascending."""
    root = Path(root)
    if not root.exists():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.is_dir() and p.name.isdigit())


def newest_verified_epoch(root: str | Path, *, log=print) -> int | None:
    """The newest epoch whose manifest verifies (None if none does);
    each epoch that fails on the way is reported through ``log``."""
    for epoch in reversed(fs_epochs(root)):
        ok, why = verify_manifest(root, epoch)
        if ok:
            return epoch
        log(f"[ckpt-integrity] epoch {epoch}: {why}", flush=True)
    return None
