"""Multi-process host loader: N spawned workers feed one merged stream,
the port's twin of ``deepvision_tpu/data/loader.py``.

- Workers start by **spawn, never fork** (trap C24): forking a process
  that has started threads (the device feed, a thread pool, CUDA's)
  clones their held locks into the child. A spawned child imports the
  factory's module afresh and never touches CUDA (the worker hides the
  cards before the factory runs): it yields host batches, uint8 crops
  or packed JPEG bytes, and the parent's device feed copies and decodes
  them.
- Each worker runs ``factory(worker_id, num_workers) -> iterable of
  batches`` and pushes into its own bounded queue; the parent merges the
  queues ROUND-ROBIN (w0, w1, ..., w0, ...), so the merged order is a
  pure function of the factory and the worker count.
- A worker's exception is raised in the parent at the failed batch, with
  the worker's traceback in the message.
- Batch payloads cross through a ring of reusable
  ``multiprocessing.shared_memory`` segments per worker (``depth + 2``
  slots sized from the first batch with 1.5x headroom); the control
  queue carries slot metadata and the parent hands freed slots back. A
  batch that is not a dict of arrays, or outgrows its slot, or a host
  where shared memory cannot be made, crosses pickled through the queue
  instead; :attr:`MultiProcessLoader.paths` counts the batches of each
  path (also ``loader_shm_batches`` and ``loader_pickle_batches`` in the
  registry), which the Trainer's ``[feed]`` line prints.
- ``max_restarts`` > 0 respawns a dead worker (SIGKILL, OOM, a torn
  pipe, an exception) at its shard position, and the merge retries the
  same rotation slot, so the merged stream equals an undisturbed run's;
  ``fault_injector`` consults the ``worker_kill`` site once per merged
  batch.
- A worker is a process of its own, which the parent's tracer does not
  see: when ``DVTPU_TRACE_SPOOL`` names a directory in its environment,
  it spools its ``host_decode`` spans there as ``decode-w<id>``
  (``obs/distributed.enable_spool_from_env``), so that the merged trace
  gives each worker a row of its own. Without the variable it costs
  nothing, and a spool that fails never kills a worker.

The factory must be picklable: a module-level class instance (see
``data/imagenet.TrainShardFactory``).
"""

from __future__ import annotations

import multiprocessing as mp
import traceback
from queue import Empty, Full
from itertools import islice
from typing import Callable, Iterator

import numpy as np

__all__ = ["MultiProcessLoader", "WorkerError", "mp_batches"]

_BATCH, _DONE, _ERROR, _RING = "batch", "done", "error", "ring"
# payload encodings inside a _BATCH message
_SHM, _PICKLE = "shm", "pickle"
# ring slots beyond the control queue's depth: one being written by the
# worker + one being read by the parent while `depth` sit queued
_RING_EXTRA = 2
# first-batch headroom so minor geometry growth doesn't force fallback
_RING_HEADROOM = 1.5


class WorkerError(RuntimeError):
    """A loader worker died; carries the child traceback."""


def _untrack_shm() -> None:
    """Detach THIS (worker) process from shm resource tracking: the
    segments it creates are owned by the PARENT (which attaches and
    unlinks them at close), and the shared tracker daemon would both
    print spurious "leaked shared_memory" warnings and unlink
    still-live segments at child exit. Python 3.13 grew a per-segment
    ``track=False`` for exactly this; do it process-wide here."""
    from multiprocessing import resource_tracker

    orig_register = resource_tracker.register
    orig_unregister = resource_tracker.unregister

    def register(name, rtype):  # pragma: no cover - runs in the child
        if rtype != "shared_memory":
            orig_register(name, rtype)

    def unregister(name, rtype):  # pragma: no cover - runs in the child
        if rtype != "shared_memory":
            orig_unregister(name, rtype)

    resource_tracker.register = register
    resource_tracker.unregister = unregister


class _Ring:
    """Worker-side slot pool: K reusable segments + a free-slot queue
    the parent returns consumed slot indices on."""

    def __init__(self, nbytes: int, k: int, free_q):
        from multiprocessing import shared_memory

        cap = int(nbytes * _RING_HEADROOM)
        self.cap = cap
        self.segs = [shared_memory.SharedMemory(create=True, size=cap)
                     for _ in range(k)]
        self.free = list(range(k))
        self.free_q = free_q

    def names(self) -> list:
        return [s.name for s in self.segs]

    def acquire(self, stop) -> int | None:
        """Next free slot index; blocks on the parent's returns (stop-
        responsive), None when stopped."""
        while True:
            try:
                while True:  # drain all returned slots
                    self.free.append(self.free_q.get_nowait())
            except Empty:
                pass
            if self.free:
                return self.free.pop()
            if stop.is_set():
                return None
            try:
                self.free.append(self.free_q.get(timeout=0.1))
            except Empty:
                continue

    def dump(self, idx: int, arrays) -> list:
        seg, meta, off = self.segs[idx], [], 0
        for k, v in arrays:
            np.ndarray(v.shape, v.dtype, buffer=seg.buf,
                       offset=off)[...] = v
            meta.append((k, v.shape, v.dtype.str, off))
            off += v.nbytes
        return meta


def _split_batch(batch):
    """-> (array_leaves [(key, ndarray)...], extras dict, total_bytes),
    or None when the batch is not a dict of arrays (pickle fallback)."""
    if not isinstance(batch, dict):
        return None
    arrays, extras, total = [], {}, 0
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.nbytes:
            arrays.append((k, v))
            total += v.nbytes
        else:
            extras[k] = v
    if not arrays:
        return None
    return arrays, extras, total


def _worker_main(factory, worker_id: int, num_workers: int, queue,
                 free_q, stop, depth: int, skip: int = 0) -> None:
    """Child entry point (module-level: must be picklable for spawn).
    ``skip`` > 0 is a RESPAWN resuming a dead worker at its shard
    position: the factory stream is deterministic, so skipping the
    batches the parent already merged replays the incarnation to
    exactly where its predecessor died."""
    import os
    import sys

    # the card belongs to the parent: a worker must never initialize CUDA
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if "torch" in sys.modules:  # one ATen thread a worker
        sys.modules["torch"].set_num_threads(1)
    _untrack_shm()
    ring = None
    ring_sent = False

    def put(item) -> bool:
        while not stop.is_set():
            try:
                queue.put(item, timeout=0.1)
                return True
            except Full:
                continue  # bounded queue: retry until stopped
        return False

    def encode(batch):
        nonlocal ring, ring_sent
        split = _split_batch(batch)
        if split is None:
            return (_PICKLE, batch)
        arrays, extras, total = split
        if ring is None:
            try:
                ring = _Ring(total, depth + _RING_EXTRA, free_q)
            except (OSError, ValueError):  # no /dev/shm: stay on pickle
                ring = False
            if ring:
                if not put((_RING, ring.names())):
                    return None
                ring_sent = True
        if not ring or total > ring.cap:
            return (_PICKLE, batch)
        idx = ring.acquire(stop)
        if idx is None:
            return None  # stopped while waiting for a slot
        return (_SHM, (idx, ring.segs[idx].name,
                       ring.dump(idx, arrays), extras))

    spool = None
    try:
        from deepvision_tpu_torch.obs.distributed import enable_spool_from_env
        from deepvision_tpu_torch.obs.trace import span as _span

        spool = enable_spool_from_env(role=f"decode-w{worker_id}")
    except Exception:  # observability must never kill a decode worker
        def _span(*a, **kw):
            from contextlib import nullcontext

            return nullcontext()
    try:
        stream = factory(worker_id, num_workers)
        if skip:
            stream = islice(stream, skip, None)
        it = iter(stream)
        while True:
            try:
                with _span("host_decode", cat="feed",
                           args={"worker": worker_id}):
                    batch = next(it)
            except StopIteration:
                break
            encoded = encode(batch)
            if encoded is None or not put((_BATCH, encoded)):
                return
        put((_DONE, None))
    except BaseException:
        put((_ERROR, f"loader worker {worker_id}/{num_workers} died:\n"
             + traceback.format_exc()))
    finally:
        if spool is not None:
            spool.close()
        if ring and not ring_sent:
            # the parent never learned these names (stopped before the
            # handshake landed): still ours, reclaim them here
            for s in ring.segs:
                s.close()
                try:
                    s.unlink()
                except FileNotFoundError:  # pragma: no cover
                    pass
        queue.close()


class MultiProcessLoader:
    """Iterator over the round-robin merge of ``num_workers`` spawned
    factory streams; ``depth`` bounds each worker's ready-batch queue
    (host-memory backpressure, same contract as the device prefetcher's
    ``depth``).

    ``max_restarts`` > 0 turns a dead worker (SIGKILL/OOM, torn pipe,
    or a factory exception) from an epoch-fatal :class:`WorkerError`
    into bounded self-healing: the worker is respawned resuming at its
    shard position (``skip`` = batches the parent already merged from
    it, deterministic factory replay), the round-robin merge retries
    the SAME rotation slot, so the merged stream is byte-identical to
    an undisturbed run. Each restart counts into the obs registry
    (``loader_worker_restarts``); ``max_restarts`` CONSECUTIVE deaths
    of one worker without a delivered batch in between fail fast — a
    deterministic fault (bad shard, systematic decode error) replays
    to the same death and must still kill the run loudly.
    ``fault_injector`` consults the ``worker_kill`` chaos site once per
    merged batch (``resilience/faults.py``)."""

    def __init__(self, factory: Callable, num_workers: int, *,
                 depth: int = 2, max_restarts: int = 0,
                 fault_injector=None):
        if num_workers < 1:
            raise ValueError(
                f"need at least 1 worker, got {num_workers}")
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}")
        ctx = mp.get_context("spawn")
        self._ctx = ctx
        self._factory = factory
        self._num_workers = num_workers
        self._depth = depth
        self._max_restarts = int(max_restarts)
        self._injector = fault_injector
        from deepvision_tpu_torch.obs.metrics import default_registry

        reg = default_registry()
        self._restarts = reg.counter("loader_worker_restarts")
        # batches by the path their payload crossed
        self._path_counters = {_SHM: reg.counter("loader_shm_batches"),
                               _PICKLE: reg.counter("loader_pickle_batches")}
        self.paths = {_SHM: 0, _PICKLE: 0}
        self._stop = ctx.Event()
        self._queues = [ctx.Queue(maxsize=depth)
                        for _ in range(num_workers)]
        self._free_qs = [ctx.Queue(maxsize=depth + _RING_EXTRA)
                         for _ in range(num_workers)]
        self._procs = [
            ctx.Process(
                target=_worker_main,
                args=(factory, w, num_workers, self._queues[w],
                      self._free_qs[w], self._stop, depth),
                daemon=True,
                name=f"host-loader-{w}",
            )
            for w in range(num_workers)
        ]
        for p in self._procs:
            p.start()
        self._live = list(range(num_workers))
        self._cursor = 0
        self._consumed = [0] * num_workers  # batches merged per worker
        self._deaths = [0] * num_workers    # consecutive, reset on batch
        self._closed = False
        self._ring_names: set = set()  # every segment any worker made
        self._segs: dict = {}          # name -> attached SharedMemory

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        import os
        import signal

        while self._live:
            if self._cursor >= len(self._live):
                self._cursor = 0
            w = self._live[self._cursor]
            if self._injector is not None \
                    and self._injector.check_worker_kill() \
                    and self._procs[w].is_alive():
                print(f"[fault] SIGKILLing loader worker {w}",
                      flush=True)
                os.kill(self._procs[w].pid, signal.SIGKILL)
            kind, payload = self._get(w)
            if kind == _RING:
                self._adopt_ring(payload)
                continue  # control message: same worker's turn again
            if kind == _BATCH:
                self._cursor += 1
                enc, body = payload
                batch = self._load(w, body) if enc == _SHM else body
                self.paths[enc] += 1
                self._path_counters[enc].inc()
                self._consumed[w] += 1
                self._deaths[w] = 0  # a delivered batch ends the streak
                return batch
            if kind == _ERROR:
                if self._deaths[w] < self._max_restarts:
                    self._respawn(w, payload)
                    continue  # same rotation slot: merge order preserved
                self._live.pop(self._cursor)
                self.close()
                raise WorkerError(
                    payload if not self._deaths[w] else
                    f"{payload}\n(gave up after {self._deaths[w]} "
                    f"consecutive restarts of worker {w}; "
                    f"max_restarts={self._max_restarts})")
            self._live.pop(self._cursor)  # done: drop from rotation
        raise StopIteration

    def _respawn(self, w: int, why: str) -> None:
        """Bounded self-heal: fresh queues (a SIGKILLed child can leave
        a torn pickle in the old pipe), fresh process resuming at the
        shard position already merged; ring segments the dead
        incarnation announced stay adopted and unlink at close()."""
        self._deaths[w] += 1
        self._restarts.inc()
        head = why.strip().splitlines()[0] if why else "died"
        print(f"[loader] worker {w} died ({head}); respawning at shard "
              f"position {self._consumed[w]} "
              f"(restart {self._deaths[w]}/{self._max_restarts})",
              flush=True)
        p = self._procs[w]
        if p.is_alive():
            p.terminate()
        p.join(5.0)
        for q in (self._queues[w], self._free_qs[w]):
            try:
                while True:
                    msg = q.get_nowait()
                    if isinstance(msg, tuple) and msg[0] == _RING:
                        self._adopt_ring(msg[1])
            except Exception:
                pass
            q.close()
            q.cancel_join_thread()
        self._queues[w] = self._ctx.Queue(maxsize=self._depth)
        self._free_qs[w] = self._ctx.Queue(
            maxsize=self._depth + _RING_EXTRA)
        p = self._ctx.Process(
            target=_worker_main,
            args=(self._factory, w, self._num_workers, self._queues[w],
                  self._free_qs[w], self._stop, self._depth,
                  self._consumed[w]),
            daemon=True,
            name=f"host-loader-{w}r{self._deaths[w]}",
        )
        p.start()
        self._procs[w] = p

    def _adopt_ring(self, names) -> None:
        """Adopt just-announced worker segments into THIS process's
        resource tracker immediately. Workers are untracked by design
        (``_untrack_shm``), so until the parent registers a name a
        SIGKILLed/OOM-killed parent (the preemption/chaos scenario)
        would leak every slot that never carried a batch; registering
        at the handshake makes the tracker's shutdown sweep reclaim
        them all. (Attaching registers too, but a slot may never be
        attached.) Registration is idempotent — a later attach or the
        close-time sweep re-registering the same name is harmless."""
        from multiprocessing import resource_tracker

        for name in names:
            self._ring_names.add(name)
            resource_tracker.register(
                name if name.startswith("/") else "/" + name,
                "shared_memory")

    def _load(self, w: int, body):
        """Copy a ring slot out and hand the slot back to worker ``w``."""
        from multiprocessing import shared_memory

        idx, name, meta, extras = body
        seg = self._segs.get(name)
        if seg is None:
            # already tracker-registered at the _RING handshake
            seg = shared_memory.SharedMemory(name=name)
            self._segs[name] = seg
        batch = {k: np.array(np.ndarray(shape, dtype, buffer=seg.buf,
                                        offset=off))
                 for k, shape, dtype, off in meta}
        batch.update(extras)
        try:
            self._free_qs[w].put_nowait(idx)
        except Full:  # impossible by slot accounting; never wedge on it
            pass
        return batch

    def _get(self, w: int):
        q = self._queues[w]
        while True:
            try:
                return q.get(timeout=0.5)
            except Empty:
                if self._closed:
                    raise StopIteration from None
                p = self._procs[w]
                if not p.is_alive():
                    # dead child: one last grace read (its feeder thread
                    # may still be flushing the pipe), then — a child
                    # that died without a sentinel was SIGKILLed/OOMed
                    try:
                        return q.get(timeout=0.5)
                    except Empty:
                        return (_ERROR,
                                f"loader worker {w} exited uncleanly "
                                f"(exitcode {p.exitcode}) with no "
                                "sentinel")
                    except Exception as e:  # torn pickle post-SIGKILL
                        return (_ERROR,
                                f"loader worker {w} left a torn "
                                f"message in its pipe "
                                f"({type(e).__name__}: {e})")
            except Exception as e:
                # a child killed mid-pipe-write leaves a partial pickle
                # the parent's get() chokes on — that's a death, not a
                # parent crash
                return (_ERROR,
                        f"loader worker {w} stream corrupted "
                        f"({type(e).__name__}: {e})")

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent: stop workers, drain queues (a child blocked on a
        full queue cannot exit), join, terminate stragglers, then unlink
        every ring segment (the parent owns shm cleanup — see
        ``_untrack_shm``)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain()
        for p in self._procs:
            p.join(timeout)
            if p.is_alive():
                p.terminate()
                p.join(1.0)
        # post-join second drain: a worker's feeder thread flushes its
        # pipe as the process exits, so a _RING handshake that was in
        # flight during the first drain is only visible NOW — and a
        # missed handshake would leak the whole ring permanently
        self._drain()
        self._unlink_rings()
        for q in (*self._queues, *self._free_qs):
            q.close()
            q.cancel_join_thread()

    def _drain(self) -> None:
        """Discard queued messages (unblocking any child wedged on a
        full pipe), recording ring handshakes on the way past."""
        for q in self._queues:
            try:
                while True:
                    kind, payload = q.get_nowait()
                    if kind == _RING:
                        self._adopt_ring(payload)
            except Empty:
                pass

    def _unlink_rings(self) -> None:
        from multiprocessing import resource_tracker, shared_memory

        for name in self._ring_names:
            seg = self._segs.get(name)
            try:
                if seg is None:
                    seg = shared_memory.SharedMemory(name=name)
                seg.close()
                seg.unlink()  # unregisters the handshake registration
            except FileNotFoundError:
                # already gone: balance the handshake registration or
                # the tracker warns "leaked shared_memory" at exit
                resource_tracker.unregister(
                    name if name.startswith("/") else "/" + name,
                    "shared_memory")
        self._ring_names.clear()
        self._segs.clear()

    def __enter__(self) -> "MultiProcessLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        stop = getattr(self, "_stop", None)
        if stop is not None:
            try:  # daemon children exit; never join in a finalizer
                stop.set()
            except Exception:  # interpreter shutdown tore down mp's state
                pass


def mp_batches(factory: Callable, num_workers: int,
               limit: int | None = None, *, depth: int = 2,
               max_restarts: int = 0, fault_injector=None):
    """Generator over a bounded slice of the merged worker stream that
    closes the pool on EVERY exit (exhaustion, break, GC) — the shape
    ``make_imagenet_data`` hands the Trainer: worker streams may
    ``repeat()`` forever, the parent's ``limit`` is the epoch length.
    ``max_restarts``/``fault_injector`` pass through to the loader's
    bounded worker respawn + ``worker_kill`` chaos site."""
    loader = MultiProcessLoader(factory, num_workers, depth=depth,
                                max_restarts=max_restarts,
                                fault_injector=fault_injector)
    try:
        src = loader if limit is None else islice(loader, limit)
        yield from src
    finally:
        loader.close()
