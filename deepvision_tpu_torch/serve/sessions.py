"""Crash-safe stateful sessions: per-stream state on the device that
survives a replica's death.

The port of ``deepvision_tpu/serve/sessions.py``. Tracking-by-detection
carries a slate of tracks from frame to frame of a stream; losing it
mid-stream is a reset the client sees. This module makes that state a
recoverable resource:

- :class:`SessionStore` holds each session's state (a track slate, a flat
  ``{name: tensor}`` dict on the served device) with TTL eviction and a
  bounded capacity that sheds NEW sessions at the door (old state is
  never dropped to make room). On a frame cadence it writes a host
  snapshot, crash-safe: the leaves' raw bytes in base64 under a SHA-256
  self-checksum, written to a unique temporary file and moved into place
  with ``os.replace``. The newest verified snapshot wins at restore and
  corrupt ones are quarantined. The snapshot format is the JAX package's
  byte for byte (``SNAPSHOT_VERSION``, the same keys, ``sort_keys``), so
  that a snapshot written by either package restores in the other.

- :class:`TrackingPipeline` serves a stateful DAG over a detect-task
  ``ServedModel``: its detector runs every ``detect_every``-th frame of a
  stream, and on such a frame ``_track_update`` associates the fresh
  detections with the previous slate (nearest centre, EMA blend); between
  detections ``_track_advance`` propagates the slate (constant velocity,
  score decay). Each (bucket) has two programs: detect+update (the
  detector's forward, then the update) and advance, each on the card one
  captured CUDA graph over static slate inputs, on the CPU the same
  functions run eagerly into static outputs (:class:`_StaticProgram`).
  A dispatch copies each stream's slate row (a zero row for a fresh or
  reset stream and for padding) into the static input, runs the program
  and fetches its outputs with one copy. The slate never goes to the host
  on the frame path: the one host trip is the snapshot on its cadence
  (``.cpu()`` of the leaves). The tracker takes its detector's stage
  (forward and weights edition) when it is built; its graphs are
  captured over that edition, so that an eviction of the detector
  (``serve/tenancy.py``) drops them and its restore recaptures them, and
  a hot swap of the detector leaves the tracker on the weights it was
  captured over.

- Every stateful answer carries ``state_reset``: False while the slate's
  lineage is intact (a fresh stream, an in-order frame, a restore from a
  snapshot and a replay), True when state was lost (no snapshot
  survives, or a sequence gap that no replay covered). A reset is never
  silent.

The fault sites (``resilience/faults.py``): ``session_kill`` drops a
committed session's state (its snapshots stay) so that the next frame
restores in-process; ``snapshot_corrupt`` garbles the snapshot just
written, so that a restore must fall back or declare the reset.
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import itertools
import json
import os
import re
import threading
import time
from pathlib import Path

import numpy as np
import torch

from deepvision_tpu_torch.serve.admission import ShedError
from deepvision_tpu_torch.serve.models import _pack, _unpack, capture_lock

__all__ = [
    "SessionStore",
    "TrackingPipeline",
    "synthetic_detector",
    "slate_spec",
    "SNAPSHOT_VERSION",
]

SNAPSHOT_VERSION = 1

_tmp_seq = itertools.count()

_SAFE_SID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# SessionStore counters, exported as ``session_<name>`` metrics
_COUNTERS = ("opened", "evicted_ttl", "shed_capacity", "snapshots",
             "restores", "resets", "snapshot_corrupt", "killed",
             "duplicates")


def _safe_sid(sid: str) -> str:
    """Filesystem-safe snapshot stem for a session id."""
    if _SAFE_SID_RE.match(sid):
        return sid
    return "h" + hashlib.sha1(sid.encode()).hexdigest()[:16]


def _leaf_nbytes(leaf) -> int:
    """Bytes of one state leaf: a tensor on the device or, after a
    restore, a numpy array on the host."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def _host_leaf(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class _Session:
    __slots__ = ("sid", "state", "seq", "opened_t", "last_used",
                 "snap_seq", "last_snap_t", "frames_since_snap")

    def __init__(self, sid: str, now: float):
        self.sid = sid
        self.state = None        # {name: tensor or numpy array} or None
        self.seq = -1            # last APPLIED frame seq (-1: none)
        self.opened_t = now
        self.last_used = now
        self.snap_seq = -1       # seq covered by the newest snapshot
        self.last_snap_t = None  # wall-clock time of the newest snapshot
        self.frames_since_snap = 0


class _Frame:
    """Disposition of one (sid, seq) arrival, what the engine does with
    it. ``action`` is ``apply`` (run the DAG, commit state) or
    ``duplicate`` (seq already applied: a replayed or retried frame,
    answered idempotently without touching state)."""

    __slots__ = ("entry", "action", "reset", "restored", "run_detect")

    def __init__(self, entry, action, reset, restored, run_detect):
        self.entry = entry
        self.action = action
        self.reset = reset
        self.restored = restored
        self.run_detect = run_detect


class SessionStore:
    """Bounded, TTL-evicted table of per-session state with crash-safe
    host snapshots.

    One lock guards the table; the engine's dispatcher is the only state
    writer (``begin_frame``/``commit``), ``admit`` runs on submitting
    threads, and the TTL sweep rides on both. Snapshot files are written
    outside the lock: a slow disk never stalls another stream's frame.
    """

    def __init__(self, *, capacity: int = 64, ttl_s: float = 300.0,
                 snapshot_dir: str | Path | None = None,
                 snapshot_every: int = 8, keep_snapshots: int = 2,
                 injector=None, registry=None):
        self._lock = threading.RLock()
        self._sessions: dict[str, _Session] = {}
        self.capacity = max(1, int(capacity))
        self.ttl_s = float(ttl_s)
        self.snapshot_dir = Path(snapshot_dir) if snapshot_dir else None
        if self.snapshot_dir is not None:
            self.snapshot_dir.mkdir(parents=True, exist_ok=True)
        self.snapshot_every = max(1, int(snapshot_every))
        self.keep_snapshots = max(1, int(keep_snapshots))
        self._injector = injector
        self._c = {k: 0 for k in _COUNTERS}
        self._registry = registry
        if registry is not None:
            for k in _COUNTERS:
                registry.counter(f"session_{k}")

    # -- internal ---------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        self._c[key] += n
        if self._registry is not None:
            self._registry.counter(f"session_{key}").inc(n)

    def _now(self) -> float:
        return time.monotonic()

    def _evict_expired_locked(self) -> list[tuple]:
        """Drop expired sessions; returns the snapshot tasks of the dirty
        ones, which the caller writes after releasing the lock."""
        if self.ttl_s <= 0:
            return []
        now = self._now()
        tasks = []
        dead = [sid for sid, e in self._sessions.items()
                if now - e.last_used > self.ttl_s]
        for sid in dead:
            # a last snapshot, so that an evicted stream that comes back
            # restores instead of resetting (snapshots outlive eviction)
            e = self._sessions[sid]
            if e.state is not None and e.seq > e.snap_seq:
                task = self._capture_locked(e)
                if task is not None:
                    tasks.append(task)
            del self._sessions[sid]
            self._count("evicted_ttl")
        return tasks

    # -- admission (engine.submit path) -----------------------------------
    def admit(self, sid: str) -> None:
        """Open or touch a session at submit time. Sheds NEW sessions
        when the table is full: existing state is never dropped to make
        room (that would be a silent reset)."""
        tasks: list[tuple] = []
        try:
            with self._lock:
                tasks = self._evict_expired_locked()
                e = self._sessions.get(sid)
                if e is not None:
                    e.last_used = self._now()
                    return
                if len(self._sessions) >= self.capacity:
                    self._count("shed_capacity")
                    raise ShedError(
                        f"session capacity {self.capacity} reached; new "
                        f"session {sid!r} shed (existing streams keep "
                        "their state)",
                        retry_after_s=min(self.ttl_s, 5.0))
                self._sessions[sid] = _Session(sid, self._now())
                self._count("opened")
        finally:
            # eviction snapshots land on the shed path too
            for task in tasks:
                self._write_snapshot(*task)

    # -- frame protocol (dispatcher path) ---------------------------------
    def begin_frame(self, sid: str, seq: int, detect_every: int) -> _Frame:
        """Disposition of one arriving frame. Restores from the newest
        verified snapshot when the state is missing; declares (never
        hides) a reset when the lineage cannot be recovered."""
        with self._lock:
            e = self._sessions.get(sid)
            if e is None:
                # a migrated stream's replay arrives without an admit
                e = self._sessions[sid] = _Session(sid, self._now())
                self._count("opened")
            e.last_used = self._now()
            restored = False
            if e.state is None and e.seq < 0:
                restored = self._restore_locked(e)
            if seq <= e.seq:
                self._count("duplicates")
                return _Frame(e, "duplicate", False, restored, False)
            reset = False
            if e.seq < 0:
                # no recoverable lineage: seq 0 is a fresh start, a later
                # one means frames were lost
                reset = seq > 0
            elif seq != e.seq + 1:
                reset = True  # a sequence gap that no replay covered
            if reset:
                e.state = None
                self._count("resets")
            run_detect = (e.state is None) or (seq % detect_every == 0)
            return _Frame(e, "apply", reset, restored, run_detect)

    def commit(self, sid: str, seq: int, state_row) -> None:
        """Commit one applied frame's new state. Runs the snapshot
        cadence and the ``session_kill`` fault site."""
        task = None
        with self._lock:
            e = self._sessions.get(sid)
            if e is None:  # evicted mid-flight; dropped
                return
            e.state = state_row
            e.seq = seq
            e.last_used = self._now()
            e.frames_since_snap += 1
            inj = self._injector
            if inj is not None and inj.check_session_kill():
                # the state is lost, as if its process had died; the
                # snapshots survive, so the next frame restores
                e.state = None
                e.seq = -1
                e.frames_since_snap = 0
                self._count("killed")
                print(f"[fault] dropped session {sid} device state "
                      f"(seq {seq})", flush=True)
                return
            if (self.snapshot_dir is not None
                    and e.frames_since_snap >= self.snapshot_every):
                task = self._capture_locked(e)
        if task is not None:  # file I/O outside the lock
            self._write_snapshot(*task)

    # -- snapshots --------------------------------------------------------
    def _snap_path(self, sid: str, seq: int) -> Path:
        return self.snapshot_dir / f"{_safe_sid(sid)}-{seq:012d}.snap.json"

    def _capture_locked(self, e: _Session) -> tuple | None:
        """``(sid, seq, state)`` for a snapshot, and the cadence's
        bookkeeping; under the lock, no file touched. A later commit
        replaces ``e.state`` and never writes into the captured one."""
        if e.state is None or self.snapshot_dir is None:
            return None
        e.snap_seq = e.seq
        e.last_snap_t = time.time()
        e.frames_since_snap = 0
        return (e.sid, e.seq, e.state)

    def encode_snapshot(self, sid: str, seq: int, state) -> bytes:
        """The snapshot file's bytes for ``state`` at ``seq``: the JAX
        package's format, byte for byte."""
        leaves = {}
        for name in sorted(state):
            arr = _host_leaf(state[name])  # the one on-cadence host sync
            leaves[name] = {
                "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
        body = {"version": SNAPSHOT_VERSION, "sid": sid, "seq": int(seq),
                "leaves": leaves}
        payload = json.dumps(body, sort_keys=True).encode()
        doc = dict(body)
        doc["sha256"] = hashlib.sha256(payload).hexdigest()
        return json.dumps(doc, sort_keys=True).encode()

    def _write_snapshot(self, sid: str, seq: int, state) -> None:
        """Encode and atomically write one captured snapshot, outside the
        lock: a unique temporary file, then one ``os.replace``."""
        target = self._snap_path(sid, seq)
        tmp = target.with_suffix(
            f".json.tmp.{os.getpid()}.{next(_tmp_seq)}")
        tmp.write_bytes(self.encode_snapshot(sid, seq, state))
        os.replace(tmp, target)
        self._count("snapshots")
        if self._injector is not None:
            self._injector.corrupt_snapshot(target)
        self._prune_snapshots(sid)

    def _prune_snapshots(self, sid: str) -> None:
        snaps = sorted(self.snapshot_dir.glob(f"{_safe_sid(sid)}-*.snap.json"))
        for old in snaps[:-self.keep_snapshots]:
            try:
                old.unlink()
            except OSError:
                pass

    @staticmethod
    def verify_snapshot(path: Path) -> tuple[bool, str]:
        """(ok, reason) for one snapshot file: checksum and version."""
        try:
            doc = json.loads(Path(path).read_text())
        except (OSError, ValueError) as exc:
            return False, f"unreadable: {exc}"
        want = doc.pop("sha256", None) if isinstance(doc, dict) else None
        if want is None:
            return False, "missing sha256"
        payload = json.dumps(doc, sort_keys=True).encode()
        got = hashlib.sha256(payload).hexdigest()
        if got != want:
            return False, f"checksum mismatch {got[:12]} != {want[:12]}"
        if doc.get("version") != SNAPSHOT_VERSION:
            return False, f"version {doc.get('version')}"
        return True, "ok"

    @staticmethod
    def load_snapshot(path: Path) -> tuple[int, dict]:
        """A VERIFIED snapshot -> (seq, {name: numpy array}); the raw-byte
        leaves make the round trip bit exact."""
        doc = json.loads(Path(path).read_text())
        state = {}
        for name, leaf in doc["leaves"].items():
            buf = base64.b64decode(leaf["b64"])
            state[name] = np.frombuffer(
                buf, dtype=np.dtype(leaf["dtype"])).reshape(leaf["shape"])
        return int(doc["seq"]), state

    def _restore_locked(self, e: _Session) -> bool:
        if self.snapshot_dir is None:
            return False
        snaps = sorted(
            self.snapshot_dir.glob(f"{_safe_sid(e.sid)}-*.snap.json"),
            reverse=True)  # newest first (seq is zero-padded)
        for path in snaps:
            ok, reason = self.verify_snapshot(path)
            if not ok:
                self._count("snapshot_corrupt")
                print(f"[sessions] quarantined corrupt snapshot {path}: "
                      f"{reason}", flush=True)
                try:
                    os.replace(path, path.with_suffix(".json.corrupt"))
                except OSError:
                    pass
                continue
            seq, host = self.load_snapshot(path)
            # host leaves: the store knows no device. The next dispatch
            # copies the row into its program's static input on the
            # served device, and its commit stores the device row
            e.state = host
            e.seq = seq
            e.snap_seq = seq
            e.frames_since_snap = 0
            self._count("restores")
            return True
        return False

    def flush(self) -> int:
        """Snapshot every session with state past its newest snapshot (a
        graceful close). -> the number of snapshots written."""
        tasks = []
        with self._lock:
            if self.snapshot_dir is None:
                return 0
            for e in self._sessions.values():
                if e.state is not None and e.seq > e.snap_seq:
                    task = self._capture_locked(e)
                    if task is not None:
                        tasks.append(task)
        for task in tasks:  # file I/O outside the lock
            self._write_snapshot(*task)
        return len(tasks)

    def abandon(self) -> None:
        """Drop all state WITHOUT flushing: the crash semantics of an
        in-process replica's kill, so that recovery runs off the cadence
        snapshots as it would after a SIGKILL."""
        with self._lock:
            for e in self._sessions.values():
                e.state = None
                e.seq = -1
            self._sessions.clear()

    # -- introspection ----------------------------------------------------
    def pinned_bytes(self) -> int:
        """Bytes held by live session state, from shapes alone (no host
        sync)."""
        with self._lock:
            return sum(_leaf_nbytes(leaf)
                       for e in self._sessions.values()
                       if e.state is not None
                       for leaf in e.state.values())

    def snapshot_age_s(self) -> float | None:
        """Age of the STALEST live session's newest snapshot (the
        worst-case replay distance); None when nothing was snapshotted."""
        with self._lock:
            ages = [time.time() - e.last_snap_t
                    for e in self._sessions.values()
                    if e.last_snap_t is not None]
            return max(ages) if ages else None

    def stats(self) -> dict:
        with self._lock:
            tasks = self._evict_expired_locked()
            age = self.snapshot_age_s()
            out = {
                "live": len(self._sessions),
                "capacity": self.capacity,
                "ttl_s": self.ttl_s,
                "pinned_bytes": self.pinned_bytes(),
                "snapshot_age_s": (round(age, 3)
                                   if age is not None else None),
                "snapshot_every": self.snapshot_every,
                "counters": dict(self._c),
            }
        for task in tasks:  # eviction snapshots, outside the lock
            self._write_snapshot(*task)
        return out


# ------------------------------------------------------- track-slate math
#
# A stream's slate is a fixed-shape flat dict of ``slots`` tracks:
#   boxes    (slots, 4) f32   normalized corner boxes (x1, y1, x2, y2)
#   velocity (slots, 4) f32   per-frame corner deltas
#   scores   (slots,)   f32   confidence; <= 0 means an empty slot
#   age      (slots,)   f32   frames since the track was (re)acquired
#
# The functions below take a leading batch dim and treat each row on its
# own: the same frames give the same slates whichever replica, batch
# position or restore path computed them.

def slate_spec(slots: int) -> dict:
    """{name: (shape, numpy dtype)} of one stream's slate (no batch
    dim)."""
    return {
        "boxes": ((slots, 4), np.float32),
        "velocity": ((slots, 4), np.float32),
        "scores": ((slots,), np.float32),
        "age": ((slots,), np.float32),
    }


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _zero_slate(slots: int, batch: int, device="cpu") -> dict:
    return {name: torch.zeros((batch, *shape), dtype=_torch_dtype(dtype),
                              device=device)
            for name, (shape, dtype) in slate_spec(slots).items()}


def _centers(boxes: torch.Tensor) -> torch.Tensor:
    # (..., 4) corner boxes -> (..., 2) centers
    return 0.5 * (boxes[..., :2] + boxes[..., 2:])


def _track_update(slates: dict, det: dict, *, slots: int, ema: float):
    """Detect-frame program: the ``slots`` best detections, each matched
    to the previous slate's nearest centre (EMA blend, per-frame
    velocity). -> (new slates, outputs). Ties choose as JAX does: the
    selection is a stable descending sort (``jax.lax.top_k`` takes the
    lower index among equal scores, ``torch.topk`` promises no order), and
    ``argmin`` takes the first of equal distances."""
    scores = torch.where(det["valid"], det["scores"],
                         torch.full_like(det["scores"], -1.0))
    sel_scores, sel_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    sel_scores, sel_idx = sel_scores[:, :slots], sel_idx[:, :slots]
    sel_boxes = torch.gather(det["boxes"], 1,
                             sel_idx[..., None].expand(-1, -1, 4))
    det_valid = sel_scores > 0.0

    prev_boxes = slates["boxes"]
    prev_valid = slates["scores"] > 0.0
    # (B, prev, new) centre distances, invalid previous slots at +inf
    diff = (_centers(prev_boxes)[:, :, None, :]
            - _centers(sel_boxes)[:, None, :, :])
    dist = torch.sqrt((diff * diff).sum(dim=-1))
    dist = torch.where(prev_valid[:, :, None], dist,
                       torch.full_like(dist, float("inf")))
    match = torch.argmin(dist, dim=1)                        # (B, new)
    has_match = torch.isfinite(dist.min(dim=1).values) & det_valid
    m_boxes = torch.gather(prev_boxes, 1, match[..., None].expand(-1, -1, 4))
    m_age = torch.gather(slates["age"], 1, match)

    blend = ema * sel_boxes + (1.0 - ema) * m_boxes
    new_boxes = torch.where(has_match[..., None], blend, sel_boxes)
    velocity = torch.where(has_match[..., None], new_boxes - m_boxes,
                           torch.zeros_like(new_boxes))
    new_scores = torch.clamp(sel_scores, min=0.0)
    age = torch.where(has_match, m_age + 1.0, torch.zeros_like(m_age))

    new_slates = {"boxes": new_boxes, "velocity": velocity,
                  "scores": new_scores, "age": age}
    out = {"boxes": new_boxes, "scores": new_scores,
           "tracked": new_scores > 0.0}
    return new_slates, out


def _track_advance(slates: dict, *, damp: float, decay: float):
    """Interpolation-frame program: constant-velocity propagation with
    velocity damping and score decay. No detector, no host traffic."""
    boxes = slates["boxes"] + slates["velocity"]
    new_slates = {
        "boxes": boxes,
        "velocity": slates["velocity"] * damp,
        "scores": slates["scores"] * decay,
        "age": slates["age"] + 1.0,
    }
    out = {"boxes": boxes, "scores": new_slates["scores"],
           "tracked": new_slates["scores"] > 0.0}
    return new_slates, out


# --------------------------------------------------------- the programs


class _StaticProgram:
    """``fn(x, slates) -> (new slates, outputs)`` over static inputs and
    outputs, the outputs packed into one byte buffer
    (``models._pack``) for one copy out.

    On the card the program is one captured CUDA graph (an eager run on
    a side stream first, so that what a first call does is never
    captured; a capture that fails raises, and nothing falls back to the
    eager path). On the CPU ``fn`` runs eagerly and its results are
    copied into the static outputs. Either way :meth:`run` returns the
    static new slates, which the next call overwrites: a caller that
    keeps a row must clone it. ``launches`` are the port's kernels one
    call launches (``ops.note_captured`` during the capture), credited
    at each replay; ``calls`` counts the calls."""

    def __init__(self, fn, x_shape: tuple | None, x_dtype, slots: int,
                 bucket: int, device: torch.device, pool=None):
        from deepvision_tpu_torch.ops import captured_launches

        self._fn = fn
        self._device = device
        self._x_dtype = x_dtype
        self.bucket = bucket
        self.calls = 0
        self.launches: dict[str, int] = {}
        t0 = time.perf_counter()
        with torch.inference_mode():
            self.slates_in = _zero_slate(slots, bucket, device)
            self.x_in = (torch.zeros(x_shape, dtype=_torch_dtype(x_dtype),
                                     device=device)
                         if x_shape is not None else None)
            if device.type != "cuda":
                slates, out = fn(self.x_in, self.slates_in)
                packed, self._layout = _pack(out)
                self.slates_out = {k: v.clone() for k, v in slates.items()}
                self.packed = packed.clone()
                self.pool_bytes = 0
            else:
                with capture_lock, torch.cuda.device(device):
                    side = torch.cuda.Stream(device)
                    side.wait_stream(torch.cuda.current_stream(device))
                    with torch.cuda.stream(side):
                        _, out = fn(self.x_in, self.slates_in)
                        _, self._layout = _pack(out)
                    torch.cuda.current_stream(device).wait_stream(side)
                    torch.cuda.synchronize(device)
                    torch.cuda.empty_cache()
                    reserved = torch.cuda.memory_reserved(device)
                    counts = captured_launches()
                    self._graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self._graph, pool=pool,
                                          capture_error_mode="thread_local"):
                        slates, out = fn(self.x_in, self.slates_in)
                        self.slates_out = slates
                        self.packed, _ = _pack(out)
                    torch.cuda.synchronize(device)
                    self.pool_bytes = (torch.cuda.memory_reserved(device)
                                       - reserved)
                    after = captured_launches()
                    self.launches = {k: n - counts.get(k, 0)
                                     for k, n in after.items()
                                     if n != counts.get(k, 0)}
            self._host = torch.empty(
                self.packed.shape, dtype=torch.uint8,
                pin_memory=device.type == "cuda")
        self.capture_s = time.perf_counter() - t0

    def run(self, x: np.ndarray | None, rows: list) -> tuple[dict, dict]:
        """Stage ``x`` (``(n, ...)`` host rows, zero-padded to the
        bucket) and ``rows`` (each stream's slate row: device tensors, a
        restored snapshot's numpy arrays, or None for a zero row) into the
        static inputs, run the program and fetch its outputs with one
        copy. -> (the static new slates, the host outputs)."""
        from deepvision_tpu_torch.ops import credit_launches

        if len(rows) > self.bucket:
            raise ValueError(f"a program of bucket {self.bucket} got "
                             f"{len(rows)} slate rows")
        cuda = self._device.type == "cuda"
        with torch.inference_mode(), \
                (torch.cuda.device(self._device) if cuda
                 else contextlib.nullcontext()):
            if self.x_in is not None:
                n = len(x)
                self.x_in[:n].copy_(torch.from_numpy(
                    np.ascontiguousarray(x, self._x_dtype)))
                if n < self.bucket:
                    self.x_in[n:].zero_()
            for k, static in self.slates_in.items():
                for i in range(self.bucket):
                    row = rows[i] if i < len(rows) else None
                    if row is None:
                        static[i].zero_()
                    elif isinstance(row[k], torch.Tensor):
                        static[i].copy_(row[k])
                    else:  # restored host leaves go to the device here
                        static[i].copy_(torch.tensor(row[k]))
            if cuda:
                self._graph.replay()
                self._host.copy_(self.packed, non_blocking=True)
                torch.cuda.current_stream(self._device).synchronize()
            else:
                slates, out = self._fn(self.x_in, self.slates_in)
                for k, v in slates.items():
                    self.slates_out[k].copy_(v)
                self._host.copy_(_pack(out)[0])
        self.calls += 1
        credit_launches(self.launches)
        return self.slates_out, _unpack(self._host.numpy(), self._layout)


class _TrackRunner:
    """The two programs of one bucket of a TrackingPipeline: ``detect``
    (the detector's forward, then ``_track_update``) and ``advance``
    (``_track_advance``), each a :class:`_StaticProgram`. Calling the
    runner runs the detect program on zero slates: what the engine's
    warm-up runs once. The engine's runner stats read ``kind``,
    ``pool_bytes``, ``capture_s``, and ``launches`` and ``calls`` of the
    detect program (a detect replay launches the detector's kernels, an
    advance replay none of them); :meth:`extra_stats` adds the advance
    program's. ``editions``: the detector's weights that the programs
    read (``tenancy``)."""

    def __init__(self, detect: _StaticProgram, advance: _StaticProgram,
                 bucket: int, slots: int, device: torch.device,
                 editions: tuple = ()):
        self.editions = editions
        self.detect = detect
        self.advance = advance
        self.bucket = bucket
        self.slots = slots
        self.kind = "cuda_graph" if device.type == "cuda" else "eager"
        self.pool_bytes = detect.pool_bytes + advance.pool_bytes
        self.capture_s = detect.capture_s + advance.capture_s

    @property
    def launches(self) -> dict:
        return self.detect.launches

    @property
    def calls(self) -> int:
        return self.detect.calls

    def extra_stats(self) -> dict:
        return {"advance_launches": dict(self.advance.launches),
                "advance_calls": self.advance.calls}

    def __call__(self, x: np.ndarray) -> dict:
        _, out = self.detect.run(x, [])
        return out


class TrackingPipeline:
    """Tracking-by-detection as a stateful DAG over a detect-task
    ``ServedModel``.

    The detector runs every ``detect_every``-th frame of each stream (and
    on any frame where the stream has no state); the frames between run
    the advance program only. Each stream's slate lives in ``store`` (a
    :class:`SessionStore`), threaded through the engine's admission and
    deadline path by ``session``/``seq`` on submit.

    It has the ``ServedModel`` surface the engine reads (``name``,
    ``input_shape``, ``dtype_str``, ``buckets``, ``device``,
    ``compile_for``, ``postprocess``) and ``is_stateful = True``, which
    sends its batches to the engine's stateful path.
    """

    is_pipeline = False
    is_stateful = True
    task = "track"
    exported = False

    def __init__(self, name: str, detector, store: SessionStore, *,
                 detect_every: int = 4, slots: int = 4, ema: float = 0.5,
                 damp: float = 0.9, decay: float = 0.9):
        from deepvision_tpu_torch.serve.pipeline import PipelineError

        self.name = name
        self.detector = detector
        self.store = store
        self.detect_every = max(1, int(detect_every))
        self.slots = int(slots)
        self.ema = float(ema)
        self.damp = float(damp)
        self.decay = float(decay)
        self._stage = detector.as_stage()
        self._checked = False
        if getattr(detector, "task", None) != "detect":
            raise PipelineError(
                f"TrackingPipeline {name!r} needs a detect-task model, "
                f"got task {getattr(detector, 'task', None)!r}")

    # -- ServedModel surface ----------------------------------------------
    @property
    def input_shape(self):
        return self.detector.input_shape

    @property
    def input_dtype(self):
        return self.detector.input_dtype

    @property
    def dtype_str(self) -> str:
        return self.detector.dtype_str

    @property
    def buckets(self):
        return self.detector.buckets

    @property
    def device(self) -> torch.device:
        return self.detector.device

    def stage_models(self) -> dict:
        """The detector by its name, the tenant whose weights the
        tracker's graphs read (the contract of ``Pipeline``'s; the JAX
        twin's key ``"detector"`` names its stage, not a tenant)."""
        return {self.detector.name: self.detector}

    def _check_detector(self, bucket: int) -> None:
        """The detector's output contract, from its avals by shape
        propagation (nothing runs); once, since the shapes scale with the
        bucket."""
        from deepvision_tpu_torch.serve.pipeline import PipelineError

        if self._checked:
            return
        out = self._stage.out_avals(bucket)
        need = ("boxes", "scores", "valid")
        if not isinstance(out, dict) or any(k not in out for k in need):
            have = sorted(out) if isinstance(out, dict) else type(out)
            raise PipelineError(
                f"tracking detector {self._stage.name!r} must emit a "
                f"detect-style dict with keys {need}, got {have}")
        if out["scores"].shape[1] < self.slots:
            raise PipelineError(
                f"tracking detector {self._stage.name!r} emits "
                f"{out['scores'].shape[1]} candidates, fewer than the "
                f"{self.slots} slots")
        self._checked = True

    def compile_for(self, bucket: int, pool=None) -> _TrackRunner:
        """The two programs at ``bucket``: on the card two CUDA graphs
        captured into the graph memory pool ``pool``, on the CPU the eager
        functions. The detector's output contract is checked first."""
        import functools

        self._check_detector(bucket)
        forward = self._stage.runner(bucket)
        upd = functools.partial(_track_update, slots=self.slots,
                                ema=self.ema)
        adv = functools.partial(_track_advance, damp=self.damp,
                                decay=self.decay)

        def detect_update(x, slates):
            return upd(slates, forward(x))

        def advance(_x, slates):
            return adv(slates)

        dev = self.device
        detect = _StaticProgram(
            detect_update, (bucket, *self.input_shape), self.input_dtype,
            self.slots, bucket, dev, pool)
        adv_prog = _StaticProgram(advance, None, self.input_dtype,
                                  self.slots, bucket, dev, pool)
        editions = ((self._stage.edition,) if self._stage.edition is not None
                    else ())
        return _TrackRunner(detect, adv_prog, bucket, self.slots, dev,
                            editions)

    def postprocess(self, host: dict, i: int) -> dict:
        """Row ``i`` of the fetched outputs, deterministic fields only:
        the engine merges session, seq and state_reset in."""
        return {
            "boxes": np.asarray(host["boxes"][i]).tolist(),
            "scores": np.asarray(host["scores"][i]).tolist(),
            "tracked": np.asarray(host["tracked"][i]).astype(bool).tolist(),
        }


# ------------------------------------------------- synthetic detector


def synthetic_detector(name: str = "synth", size: int = 16,
                       channels: int = 1, candidates: int = 8,
                       device: str | torch.device | None = None):
    """A weight-free detect-task ``ServedModel`` for stream drills: its
    boxes derive from the means of ``candidates`` equal chunks of the
    frame, computed on ``device`` (default ``"cuda"``, which raises
    without a card), deterministic. The twin of the JAX
    ``synthetic_detector``."""
    from torch import nn

    from deepvision_tpu_torch.device import resolve_device
    from deepvision_tpu_torch.serve.models import ServedModel

    dev = resolve_device(device)
    k = candidates

    def forward(x: torch.Tensor) -> dict:
        b = x.shape[0]
        flat = x.reshape(b, -1)
        n = flat.shape[1]
        chunk = max(1, n // k)
        means = torch.stack(
            [flat[:, i * chunk:(i + 1) * chunk].mean(dim=1)
             for i in range(k)], dim=1)                      # (B, k)
        frac = (torch.tanh(means) + 1.0) * 0.5               # (0, 1)
        # k as a tensor: ATen on the card divides by a Python number as
        # a product with its reciprocal, which is not JAX's quotient
        offs = (torch.arange(k, dtype=torch.float32, device=x.device)
                / torch.full((), float(k), device=x.device))[None, :]
        x1 = torch.clamp(frac * 0.5 + offs * 0.25, 0.0, 0.9)
        y1 = torch.clamp(frac * 0.25 + offs * 0.5, 0.0, 0.9)
        wh = 0.05 + frac * 0.1
        boxes = torch.stack(
            [x1, y1, torch.clamp(x1 + wh, 0.0, 1.0),
             torch.clamp(y1 + wh, 0.0, 1.0)], dim=-1)        # (B, k, 4)
        scores = 0.2 + 0.8 * frac
        return {"boxes": boxes, "scores": scores,
                "classes": torch.zeros_like(scores, dtype=torch.int32),
                "valid": scores > 0.25}

    def post(host, i):
        keep = np.asarray(host["valid"][i]).astype(bool)
        return {"boxes": np.asarray(host["boxes"][i])[keep].tolist(),
                "scores": np.asarray(host["scores"][i])[keep].tolist()}

    return ServedModel(name=name, task="detect", module=nn.Module(),
                       input_shape=(size, size, channels),
                       postprocess=post, device=dev, forward=forward,
                       scale="tanh")
