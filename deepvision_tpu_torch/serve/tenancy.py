"""Multi-tenant weight residency and zero-drop hot swap over captured
CUDA graphs.

The port of ``deepvision_tpu/serve/tenancy.py``. N served models share
one engine's device memory under a byte budget, and a tenant's weights
can be replaced under live load without dropping a request. The JAX
design does not carry over: a JAX runner reads ``edition.variables`` at
call time, so an eviction frees device memory under a cached executable
and a re-materialization is one ``device_put``. A captured CUDA graph
replays the addresses it was captured with. A graph over evicted weights
would read freed memory, and a swap that only re-pointed the parameters
would go on serving the old ones. So in the port:

- **An edition is a tenant's device weights plus every runner captured
  over them.** :class:`WeightsEdition` holds the tenant's ``nn.Module``
  (its parameters and buffers are the weights). The runners over it are
  the tenant's own bucket graphs, every DAG entry-bucket graph that holds
  it as a stage (``serve/pipeline.py``) and every tracking graph over it
  (``serve/sessions.py``). Each runner names the editions it was captured
  over (``runner.editions``) and holds them strongly; the engine registers
  it here with the function that captures it again (:meth:`register`).
- **Eviction** (:meth:`evict`) first drops every registered runner over
  the edition from the runner cache, then moves the weights to pinned
  host memory in place (``tensor.data``: the module and its parameters
  keep their identity). No graph is left that could replay freed memory.
  What the eviction frees is the weights and, once the graphs die, their
  pools. The budget counts weight bytes only, as JAX's does; the graphs'
  pool bytes are reported beside it (``stats()["pool_bytes"]``). An
  eviction waits for the batches in flight over the edition (the
  engine pins a runner's editions for its call, :meth:`pin`).
- **Re-materialization** (:meth:`ensure_resident`, on the dispatch path)
  copies the weights back to new device memory and recaptures exactly
  the runners that the eviction dropped whose editions are all resident
  again, into a fresh graph pool (PyTorch refuses a capture into a pool
  whose graphs have all been freed), each under the key it had, through
  ``CompileCache.install``:
  a recapture is never a cache miss, so a frozen cache's miss counter
  does not move. A restored tenant answers bit for bit as before its
  eviction: its weights are copied back exactly and the graph is
  captured from the same forward at the same shapes, so cuDNN's
  heuristics pick the same algorithms. A failed recapture raises and
  fails that batch; nothing falls back to the eager forward or to the
  old addresses.
- **A swap** (:meth:`swap`) builds a shadow model (a new module and a new
  forward with the new weights, ``ServedModel.shadow``: the live
  parameters, which DAG graphs and batches in flight read, are never
  written) and captures its whole bucket ladder, into a new graph pool,
  on the caller's thread. It installs those runners, flips the tenant's
  module, forward and edition under the residency lock, and only then
  drops the old fingerprint's runners. A batch in flight keeps its own
  runner and drains on the old weights. A swap to the same fingerprint
  is a no-op. A DAG or tracking graph keeps serving the edition it was
  captured over until it is registered again; the old edition is held
  weakly here and counted under ``retired_pinned`` for as long as some
  runner holds it. An evicted tenant whose DAG graphs were dropped is
  re-materialized before its swap, so that those graphs can be
  recaptured over its old weights.
- **Captures and replays run at the same time.** A swap captures while
  the dispatcher replays. Captures take one process-wide lock
  (``models.capture_lock``), because ``torch.cuda.graph`` synchronizes
  the device and empties the allocator's cache, which must not happen
  inside another thread's capture; each capture is
  ``capture_error_mode="thread_local"``, so that the dispatcher's copies
  and replays on other streams stay legal during it. What is exact: the
  weight bytes (:func:`tree_nbytes`), the fingerprints, the counters and
  the answers. What is approximate: a runner's ``pool_bytes``, a delta of
  the allocator's reserved memory across the capture, which a concurrent
  re-materialization or eviction on the dispatcher moves too.

The budget's arithmetic is JAX's: the least recently dispatched tenants
beyond it are evicted, a batch's own tenants never (for a DAG, all its
stage tenants are protected together: the graph needs them all on the
card). The port evicts over the budget after each model's warm-up rather
than at adoption, since a graph can be captured only over resident
weights; this leaves the same tenants resident as adoption-time eviction.
:meth:`summary_line` keeps JAX's grep-stable prefix and appends the
recaptures and their seconds.

Per-tenant isolation (quotas, SLO classes, sheds by tenant) lives in
``admission.AdmissionController``, which the engine and the fleet router
thread the tenant maps through.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["TenancyManager", "WeightsEdition", "fingerprint_variables",
           "tree_nbytes"]


def fingerprint_variables(variables) -> str:
    """The digest of a weights tree in the JAX layout
    (``resilience/sentinel.state_tree``), the same that
    ``ServedModel.weights_fingerprint`` keys the runner cache with.
    ``None`` (an artifact: its weights live in the program) is
    ``"artifact"``."""
    if variables is None:
        return "artifact"
    from deepvision_tpu_torch.resilience.sentinel import tree_fingerprint

    return tree_fingerprint(variables)["digest"]


def tree_nbytes(variables) -> int:
    """The bytes of every leaf of a nested dict (or list) of numpy arrays
    or tensors: over ``state_tree(module)`` of a float32 model (as every
    served model is) the bytes that the JAX package's ``tree_nbytes``
    counts for the same model's variables."""
    if isinstance(variables, dict):
        return sum(tree_nbytes(v) for v in variables.values())
    if isinstance(variables, (list, tuple)):
        return sum(tree_nbytes(v) for v in variables)
    if isinstance(variables, torch.Tensor):
        return variables.numel() * variables.element_size()
    return int(np.asarray(variables).nbytes)


def _weights(module) -> list[torch.Tensor]:
    """The module's parameters and buffers, each once."""
    seen, out = set(), []
    for t in (*module.parameters(), *module.buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


class WeightsEdition:
    """One generation of a tenant's weights: its module, the weights'
    fingerprint and bytes, and whether they are on the device. Identity
    is the unit of swap isolation: runners captured over this edition
    name it in ``runner.editions``; a swap makes a new edition and
    leaves the old one to the runners that hold it. ``fingerprint`` and
    ``nbytes`` are taken from the module when first read, if not given."""

    # __weakref__: retired editions, still held by runners, are tracked
    # weakly so that stats report their memory exactly as long as it is
    # held
    __slots__ = ("module", "resident", "_fingerprint", "_nbytes", "_host",
                 "__weakref__")

    def __init__(self, module, fingerprint: str | None = None,
                 nbytes: int | None = None, *, resident: bool = True):
        self.module = module
        self.resident = resident
        self._fingerprint = fingerprint
        self._nbytes = nbytes
        self._host: list[torch.Tensor] | None = None

    def _measure(self) -> None:
        from deepvision_tpu_torch.resilience.sentinel import state_tree

        tree = state_tree(self.module)
        if self._fingerprint is None:
            self._fingerprint = fingerprint_variables(tree)
        if self._nbytes is None:
            self._nbytes = tree_nbytes(tree)

    @property
    def fingerprint(self) -> str:
        if self._fingerprint is None:
            self._measure()
        return self._fingerprint

    @property
    def nbytes(self) -> int:
        if self._nbytes is None:
            self._measure()
        return self._nbytes

    @torch.no_grad()
    def to_host(self) -> None:
        """Point every weight at a host copy (pinned when it came from
        the card), so that the device copies are freed once nothing else
        holds them. The host copies are kept: serving never changes the
        weights, so a later eviction copies nothing."""
        tensors = _weights(self.module)
        if self._host is None:
            # empty_like keeps each weight's strides (the models' conv
            # kernels are channels_last), so that the copy back has the
            # layout, and the recapture the cuDNN algorithms, of before
            self._host = [
                torch.empty_like(t, device="cpu", pin_memory=True).copy_(t)
                if t.device.type == "cuda" else t.data
                for t in tensors]
        for t, h in zip(tensors, self._host):
            t.data = h

    @torch.no_grad()
    def to_device(self, device) -> None:
        """Copy the weights back to ``device``, at new addresses, in their
        layout (``Tensor.to`` keeps the strides)."""
        for t, h in zip(_weights(self.module), self._host or ()):
            t.data = h.to(device)

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"WeightsEdition({self._fingerprint}, {self._nbytes}B, "
                f"resident={self.resident})")


class _Capture:
    """A registered runner's editions and the function that captures it
    again."""

    __slots__ = ("editions", "rebuild")

    def __init__(self, editions: tuple, rebuild: Callable[[], Any]):
        self.editions = editions
        self.rebuild = rebuild


def _holds(editions: tuple, ed) -> bool:
    return any(e is ed for e in editions)


class TenancyManager:
    """LRU weight residency and hot swap for one engine's tenants, over
    the engine's runner ``cache`` (whose lock is the residency lock, so
    that a runner's capture, its registration and an eviction's drop are
    one order of events).

    ``budget_bytes`` caps the summed resident weight bytes; the least
    recently dispatched tenants beyond it are evicted to host. ``None``
    disables eviction. ``on_drop(keys)`` hears of the keys an eviction
    dropped (the engine then captures their models' graphs into a fresh
    pool: a pool whose graphs have all died cannot take new captures).
    The counters are in :meth:`stats` and :meth:`summary_line`."""

    def __init__(self, cache, *, budget_bytes: int | None = None,
                 log=print, on_drop: Callable | None = None):
        self._cache = cache
        self._budget = budget_bytes
        self._log = log
        self._on_drop = on_drop
        self.lock = cache.lock
        self._idle = threading.Condition(self.lock)
        # serializes swaps only: a swap's captures are slow and must not
        # hold the residency lock that the dispatcher takes a batch
        self._swap_lock = threading.Lock()
        self._tenants: dict[str, Any] = {}
        self._lru: OrderedDict[str, None] = OrderedDict()
        # tenants whose every runner came off the artifact store, with
        # the weights baked into the programs: name -> baked bytes
        self._baked: dict[str, int] = {}
        # swapped-out editions that runners may still hold
        self._retired: list[tuple[str, weakref.ref]] = []
        # cache key -> the runner's capture, for runners in the cache
        # over editions; and those that an eviction dropped
        self._graphs: dict[Any, _Capture] = {}
        self._dropped: dict[Any, _Capture] = {}
        # edition -> batches in flight over it
        self._busy: dict[WeightsEdition, int] = {}
        self.swaps = 0
        self.evictions = 0
        self.rematerializations = 0
        self.recaptures = 0
        self.recapture_s = 0.0

    # -- registration -----------------------------------------------------
    def adopt(self, served) -> None:
        """Register a tenant: take its weights' fingerprint and bytes
        (one pass over ``state_tree``) into its edition. An artifact,
        whose weights live in its program, has no edition and stays
        outside residency."""
        with self.lock:
            if served.name in self._tenants:
                return
            self._tenants[served.name] = served
            if served.edition is None:
                return
            served.edition._measure()
            # it joins the LRU at its warm-up (ensure_resident), so that
            # the budget's evictions follow the warm-up's order

    def register(self, key, runner, rebuild: Callable[[], Any]) -> None:
        """``runner``, just put in the cache under ``key``, was captured
        over ``runner.editions``; ``rebuild()`` captures it again. A
        runner over no edition (a program with its weights baked in) is
        not tracked: no eviction reaches it."""
        eds = tuple(getattr(runner, "editions", ()))
        with self.lock:
            self._dropped.pop(key, None)
            if eds:
                self._graphs[key] = _Capture(eds, rebuild)
            else:
                self._graphs.pop(key, None)

    def forget(self, keys) -> None:
        """The cache dropped ``keys`` for good (a swap)."""
        with self.lock:
            for k in keys:
                self._graphs.pop(k, None)
                self._dropped.pop(k, None)

    def clear(self) -> None:
        """Forget every runner (the engine's close drops them all)."""
        with self.lock:
            self._graphs.clear()
            self._dropped.clear()

    def pin(self, runner) -> None:
        """A batch is about to run on ``runner``: an eviction of its
        editions waits until :meth:`unpin`."""
        with self.lock:
            for ed in getattr(runner, "editions", ()):
                self._busy[ed] = self._busy.get(ed, 0) + 1

    def unpin(self, runner) -> None:
        with self.lock:
            for ed in getattr(runner, "editions", ()):
                n = self._busy.get(ed, 0) - 1
                if n > 0:
                    self._busy[ed] = n
                else:
                    self._busy.pop(ed, None)
            self._idle.notify_all()

    # -- residency --------------------------------------------------------
    def ensure_resident(self, name: str, *, protect=None) -> None:
        """Dispatch-path hook: touch the tenant's LRU slot; if an eviction
        moved its weights to host, copy them back, evict over the budget
        (never ``protect``, default the tenant alone) and recapture the
        dropped runners whose editions are all resident. Cheap when
        already resident."""
        with self.lock:
            served = self._tenants.get(name)
            if served is None or served.edition is None \
                    or name in self._baked:
                # a baked tenant's programs carry their weights: staging
                # the edition would only waste device memory
                return
            restored = not served.edition.resident
            if restored:
                self._rematerialize(served)
            self._lru[name] = None
            self._lru.move_to_end(name)
            self._evict_over_budget(protect=set(protect or ()) | {name})
            if restored:
                self._recapture_ready()

    def settle(self, protect) -> None:
        """Evict over the budget, never a tenant of ``protect``: the
        engine's call after each model's warm-up."""
        with self.lock:
            self._evict_over_budget(protect=set(protect))

    def _rematerialize(self, served) -> None:
        ed = served.edition
        ed.to_device(served.device)
        ed.resident = True
        self.rematerializations += 1
        self._log(f"[tenancy] rematerialized {served.name} "
                  f"({ed.nbytes}B)", flush=True)

    def _recapture_ready(self) -> None:
        """Recapture every dropped runner whose editions are all
        resident, under its old key, through ``install``."""
        for key, cap in list(self._dropped.items()):
            if all(ed.resident for ed in cap.editions):
                self._recapture(key, cap)

    def _recapture(self, key, cap: _Capture):
        t0 = time.perf_counter()
        runner = cap.rebuild()
        self.recapture_s += time.perf_counter() - t0
        self.recaptures += 1
        self._cache.install(key, runner)
        self.register(key, runner, cap.rebuild)
        return runner

    def restore(self, key):
        """The runner of ``key`` if an eviction dropped it and its
        editions are resident again (recaptured now, through
        ``install``), else None: the engine's lookup before a miss."""
        with self.lock:
            cap = self._dropped.get(key)
            if cap is None:
                return None
            if not all(ed.resident for ed in cap.editions):
                raise RuntimeError(
                    f"runner {key!r} was dropped with evicted weights that "
                    "are not resident; refusing to capture over host memory")
            return self._recapture(key, cap)

    def evict(self, name: str) -> bool:
        """Move one tenant's weights to host: drop every registered
        runner over its edition from the cache (kept for a recapture),
        wait out the batches in flight over it, then point the weights
        at host copies, which frees the device copies."""
        with self.lock:
            served = self._tenants.get(name)
            while served is not None and served.edition is not None \
                    and self._busy.get(served.edition):
                self._idle.wait()
            if (served is None or served.edition is None
                    or not served.edition.resident):
                return False
            ed = served.edition
            dropped = []
            for key, cap in list(self._graphs.items()):
                if _holds(cap.editions, ed):
                    del self._graphs[key]
                    if self._cache.drop_where(lambda k, key=key: k == key):
                        self._dropped[key] = cap
                        dropped.append(key)
            if dropped and self._on_drop is not None:
                self._on_drop(dropped)
            ed.to_host()
            ed.resident = False
            self._lru.pop(name, None)
            self.evictions += 1
            self._log(f"[tenancy] evicted {name} ({ed.nbytes}B) to host",
                      flush=True)
            return True

    def release_to_baked(self, served, n_programs: int) -> None:
        """Take a tenant whose whole bucket ladder came off the artifact
        store out of residency: its programs carry the weights as their
        own tensors and no runner reads the edition, so the edition's
        device copy goes to host and the tenant leaves the LRU. The
        programs' bytes (about the weights times the programs) are
        recorded, so that ``stats()`` reports what the budget cannot
        govern. A tenant that a DAG or tracking graph reads keeps its
        edition on the device. A later swap captures edition-backed
        runners and returns the tenant to residency."""
        with self.lock:
            ed = served.edition
            if ed is None:
                return
            readers = sum(_holds(c.editions, ed)
                          for c in self._graphs.values())
            if readers:
                self._log(f"[tenancy] {served.name}: all {n_programs} "
                          f"runners store-warmed, but {readers} graph(s) "
                          "read its weights; the edition stays resident",
                          flush=True)
                return
            if ed.resident:
                ed.to_host()
                ed.resident = False
            self._lru.pop(served.name, None)
            self._baked[served.name] = ed.nbytes * n_programs
            self._log(
                f"[tenancy] {served.name}: all {n_programs} runners "
                f"store-warmed (weights baked in); released the edition's "
                f"device copy ({ed.nbytes}B), baked ~{ed.nbytes * n_programs}"
                f"B outside the residency budget", flush=True)

    def resident_bytes(self) -> int:
        """Device bytes of weight editions: every resident current
        edition and every retired one that a runner still holds. Baked
        programs are counted apart (``stats()["baked_bytes"]``)."""
        with self.lock:
            current = sum(
                t.edition.nbytes for t in self._tenants.values()
                if t.edition is not None and t.edition.resident)
            pinned = sum(ed.nbytes for _n, ed in self._live_retired()
                         if ed.resident)
            return current + pinned

    def _live_retired(self) -> list[tuple[str, Any]]:
        """(tenant, edition) of the swapped-out editions that some runner
        still holds; dead weak references are pruned on the way."""
        kept, out = [], []
        for name, ref in self._retired:
            ed = ref()
            if ed is not None:
                kept.append((name, ref))
                out.append((name, ed))
        self._retired = kept
        return out

    def _evict_over_budget(self, *, protect: set) -> None:
        if self._budget is None:
            return
        while self.resident_bytes() > self._budget:
            victim = next((n for n in self._lru if n not in protect), None)
            if victim is None:
                break  # the protected tenants alone exceed the budget
            self.evict(victim)

    # -- hot swap ---------------------------------------------------------
    def swap(self, served, new_variables, *, ladder, key_fn,
             build: Callable, rebuild: Callable | None = None) -> dict:
        """Zero-drop weight swap. The slow work (the shadow model, a
        capture of every ladder bucket by ``build(shadow, bucket)``)
        happens on the caller's thread against a new edition while the
        dispatcher serves the old one; the runners are installed, then
        the tenant flips under the residency lock, then the old
        fingerprint's runners leave the cache. ``rebuild(served,
        bucket)`` (default ``build``) captures a runner again after an
        eviction."""
        name = served.name
        with self._swap_lock:
            old_fp = served.weights_fingerprint()
            fp = fingerprint_variables(new_variables)
            base = {"model": name, "fingerprint": fp,
                    "old_fingerprint": old_fp,
                    "buckets": [int(b) for b in ladder]}
            if fp == old_fp:
                # a retried swap: the installed ladder already pairs with
                # these bytes, and dropping "old" runners would drop the
                # live ones (old key == new key)
                self._log(f"[tenancy] swap {name}: fingerprint {fp} "
                          "unchanged; no-op", flush=True)
                return {**base, "dropped_executables": 0, "unchanged": True}
            old = served.edition
            with self.lock:
                # DAG or tracking graphs dropped with the evicted old
                # edition are recaptured over it before it retires
                if old is not None and not old.resident and any(
                        k[0] != name and _holds(c.editions, old)
                        for k, c in self._dropped.items()):
                    self._rematerialize(served)
                    self._recapture_ready()
            t0 = time.perf_counter()
            shadow = served.shadow(new_variables, fingerprint=fp)
            runners = {key_fn(shadow, b): build(shadow, b) for b in ladder}
            capture_s = time.perf_counter() - t0
            with self.lock:
                if old is not None:
                    self._retired.append((name, weakref.ref(old)))
                served.flip_to(shadow)
                for b, (key, runner) in zip(ladder, runners.items()):
                    self._cache.install(key, runner)
                    self.register(key, runner,
                                  lambda b=b: (rebuild or build)(served, b))
                # the evicted old edition's own runners stay dropped
                for k in [k for k in self._dropped
                          if k[0] == name and k[3] == old_fp]:
                    del self._dropped[k]
                self._baked.pop(name, None)
                self._lru[name] = None
                self._lru.move_to_end(name)
                self.swaps += 1
            # the old key can never be hit again; a batch in flight holds
            # its own runner and drains regardless
            stale = [k for k, _ in self._cache.items()
                     if k[0] == name and len(k) > 3 and k[3] == old_fp]
            dropped = self._cache.drop_where(lambda k: k in stale)
            self.forget(stale)
            with self.lock:
                self._evict_over_budget(protect={name})
            self._log(f"[tenancy] swapped {name}: {old_fp} -> {fp} "
                      f"({len(runners)} buckets captured in "
                      f"{capture_s:.3f}s, {dropped} stale runners dropped)",
                      flush=True)
            return {**base, "dropped_executables": int(dropped),
                    "capture_s": round(capture_s, 4)}

    # -- observability ----------------------------------------------------
    def pool_bytes(self) -> dict[str, int]:
        """By resident tenant: the graph pool bytes of the cached runners
        over its current edition (its own graphs and the DAG and tracking
        graphs over it), which an eviction frees beside the weights."""
        with self.lock:
            runners = dict(self._cache.items())
            out = {}
            for name, t in sorted(self._tenants.items()):
                ed = t.edition
                if ed is None or not ed.resident:
                    continue
                out[name] = sum(
                    getattr(runners.get(k), "pool_bytes", 0)
                    for k, c in self._graphs.items()
                    if _holds(c.editions, ed))
            return out

    def stats(self) -> dict:
        with self.lock:
            return {
                "tenants": sorted(self._tenants),
                "resident": [n for n, t in sorted(self._tenants.items())
                             if t.edition is not None
                             and t.edition.resident],
                "resident_bytes": self.resident_bytes(),
                "budget_bytes": self._budget,
                "bytes": {n: t.edition.nbytes
                          for n, t in sorted(self._tenants.items())
                          if t.edition is not None},
                "pool_bytes": self.pool_bytes(),
                # device memory the budget cannot govern: store-warmed
                # tenants' baked programs, and swapped-out editions still
                # held by runners (a DAG's stage until re-registered)
                "baked": sorted(self._baked),
                "baked_bytes": sum(self._baked.values()),
                "retired_pinned": [
                    {"tenant": n, "fingerprint": ed.fingerprint,
                     "nbytes": ed.nbytes}
                    for n, ed in self._live_retired() if ed.resident],
                "dropped_runners": len(self._dropped),
                "swaps": self.swaps,
                "evictions": self.evictions,
                "rematerializations": self.rematerializations,
                "recaptures": self.recaptures,
                "recapture_s": round(self.recapture_s, 4),
            }

    def summary_line(self) -> str:
        """The grep-stable exit line (the serving CLI prints it at
        shutdown): JAX's prefix, then the recaptures and their
        seconds."""
        with self.lock:
            resident = len(self.stats()["resident"])
            return (f"[tenancy] swaps={self.swaps} "
                    f"evictions={self.evictions} "
                    f"rematerializations={self.rematerializations} "
                    f"resident={resident}/{len(self._tenants)} "
                    f"recaptures={self.recaptures} "
                    f"recapture_s={self.recapture_s:.3f}")
