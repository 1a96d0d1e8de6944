"""Batched inference engine: queue -> micro-batch -> bucket -> runner.

The port of ``deepvision_tpu/serve/engine.py``'s ``InferenceEngine``. A
dispatcher thread drains the request queue into per-model micro-batches
and pads each batch with zero rows up to a fixed bucket ladder (default
1/4/16/64), so that the device only ever sees a few batch shapes. Each
(model, bucket) has one runner (``ServedModel.compile_for``: a captured
CUDA graph on the card, the eager forward on the CPU) in a
:class:`~deepvision_tpu_torch.serve.compile_cache.CompileCache` keyed by
``(model, bucket, dtype, weights fingerprint)``; :meth:`InferenceEngine.warm`
builds them all before the dispatcher starts, so that no request pays a
build (``stats()["cache"]["misses"]`` stays frozen; ``freeze_cache``
makes a later miss raise). A batch goes to the device with one
host-to-device copy and its outputs come back with one device-to-host
copy.

Guarantees, as in the twin:

- **pad isolation**: padded rows are zero inputs whose outputs are
  dropped before postprocess (eval-mode rows are independent);
- **bounded latency or shed**: admission control rejects work with a
  retry hint once the queue saturates;
- **deadline honesty**: a request whose deadline passes while queued
  resolves with ``TimeoutError``, never a late answer;
- **batch failure containment**: a forward that raises fails exactly
  that batch's futures;
- **clean shutdown**: ``close()`` stops and joins the dispatcher, fails
  every pending future and drops the runners (and with them the CUDA
  graphs and their memory pools);
- **crash containment**: the dispatcher runs under a supervisor
  (``_supervise``): an exception that escapes the loop body fails every
  queued and in-flight future at once (no client waits for its
  deadline), is counted (``dispatcher_crashes``,
  ``dispatcher_restarts``), and the loop restarts after a capped
  exponential backoff, during which :meth:`health` reports
  ``"recovering"`` (``/healthz`` serves 503). A ``fault_injector``
  (``resilience/faults.FaultInjector``) crashes the loop on schedule
  (``crash@N``) where the twin's does.

The artifact store (``serve/artifact_store.py``, ``store=``): every
(model, bucket) first tries the disk, where a verified request program
of this device and these weights (``ServedModel.export_bytes``) loads
and becomes its runner (``stats()["warmed_from_store"]``) in place of
tracing the model; a miss is traced as before and exported back into
the store. A runner over a loaded program (from the store, or a model
served from an artifact, ``models.from_exported``) runs once on a zero
batch through the request path before any request. A stored program that
loads but fails to run is logged, rejected into ``quarantine/`` and the
model traced; a failed export is logged: the store never fails a
warm-up. An artifact's ladder is its exported batch
(``ServedModel.buckets``).

Pipelines (``serve/pipeline.py``, ``pipelines=``): each DAG is served
beside the models under its own name, through the same queue, buckets,
admission and runner cache; its runner of an entry bucket is one CUDA
graph of the whole DAG on the card. :meth:`InferenceEngine.warm` builds
every entry bucket and runs each once on a zero batch, so that with
``freeze_cache`` no request, plain or pipeline, pays a build. A pipeline
never goes into the artifact store, and ``stats()["pipelines"]`` counts
the requests each has served. A request whose deadline passes while its
DAG runs resolves with ``TimeoutError`` ("mid-pipeline"), never a late
answer.

Tenancy (``serve/tenancy.py``): every weight-carrying model, the stage
models of pipelines and trackers among them, is a tenant of the engine's
``TenancyManager``, and every runner is registered with the weights
editions it was captured over. ``residency_bytes`` caps the resident
weight bytes: before a batch runs, its tenants are made resident (an
evicted one's weights come back and its dropped runners are recaptured,
through ``install``), the least recently dispatched others are evicted
beyond the budget (their runners dropped first), and the runner's
editions are pinned for the call, so that no eviction frees weights under
a replay. :meth:`InferenceEngine.hot_swap` replaces one model's weights
under load with zero drops; ``tenant_quota`` and ``slo_class`` are the
admission gate's per-tenant maps. ``stats()["tenancy"]`` and
:attr:`InferenceEngine.tenancy` report it.

Stateful streams (``serve/sessions.py``): a model with ``is_stateful``
(a ``TrackingPipeline``) takes ``submit(x, model=..., session=ID,
seq=N)``; a NEW session is shed at the door when its ``SessionStore`` is
full. A batch holds at most one frame a session (the later frames go
back to the front of the backlog, in order), each frame is dispositioned
by the store (a duplicate is answered idempotently, without a run), and
the detect and the interpolated frames run as two sub-batches, each one
program of the runner. The new state is committed, as a clone of the
program's static output, before the deadline check, so that a client's
retry after a timeout is a duplicate and never forks the stream.
``stats()`` and ``health()`` carry ``"sessions"``; ``close()`` flushes
every dirty session's snapshot, or with ``abandon_sessions=True`` drops
the state without one (a replica's kill).

Observability (``obs/``): ``submit(..., trace=ID)`` carries a request's
distributed trace id (the router's ``X-DVTPU-Trace``). While the tracer
is active (enabled, or a spool or flight recorder attached), each batch
records retroactive spans from the stamps the dispatcher already takes:
``device`` (model, bucket, rows and the batch's trace ids; on the
stateful path its mode and sessions), a ``stage:<node>`` span a DAG
stage inside it (``Pipeline.take_stage_stamps``: the CUDA events of the
DAG's graph, read after the batch's fetch), and for each request with a
trace id ``replica_queue`` and ``postprocess`` (with its session on the
stateful path). No span waits for the card: the only sync is the
output fetch of the runner. A dispatcher crash dumps the flight recorder
(``obs/distributed.flight_dump``) before the pending requests fail.

The engine runs its models in true float32: it turns TF32 off for
cuDNN and cuBLAS (``device.strict_fp32``) before it captures any graph.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Iterable

import numpy as np

from deepvision_tpu_torch.device import strict_fp32
from deepvision_tpu_torch.obs.distributed import flight_dump
from deepvision_tpu_torch.obs.trace import get_tracer
from deepvision_tpu_torch.serve.admission import AdmissionController, ShedError
from deepvision_tpu_torch.serve.artifact_store import (
    ArtifactStore,
    device_desc,
)
from deepvision_tpu_torch.serve.compile_cache import CompileCache
from deepvision_tpu_torch.serve.models import ServedModel
from deepvision_tpu_torch.serve.telemetry import ServeTelemetry
from deepvision_tpu_torch.serve.tenancy import TenancyManager

__all__ = ["InferenceEngine", "ShedError"]

_WAKE = object()  # queue sentinel: wake the dispatcher without a request


class _Request:
    __slots__ = ("model", "x", "future", "t_submit", "deadline", "trace",
                 "session", "seq")

    def __init__(self, model: str, x: np.ndarray, deadline: float | None,
                 trace: str | None = None, session: str | None = None,
                 seq: int | None = None):
        self.model = model
        self.x = x
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        # the distributed trace id, stamped on this request's spans
        self.trace = trace
        # a stateful stream's id and frame number; None when stateless
        self.session = session
        self.seq = seq


class InferenceEngine:
    """Multi-model batched inference on each model's device.

    ``batch_window_s``: after the first request of a batch arrives, how
    long the dispatcher waits for the largest bucket to fill before it
    runs a partial (padded) batch. 0 trades padding for latency; a
    backlog fills buckets regardless.

    ``cache_entries``: the runner cache's LRU bound. ``freeze_cache``:
    freeze the cache after the warm-up, so that a request-time miss
    raises instead of building a runner. ``fault_injector``: a
    ``FaultInjector`` whose ``check_dispatch`` runs before each batch.
    ``restart_backoff_s`` and ``restart_backoff_max_s``: the
    supervisor's first and largest wait before it restarts a crashed
    dispatcher (doubling between). ``store``: an ``ArtifactStore`` or
    its directory, from which :meth:`warm` loads request programs and
    into which it exports the ones it traces. ``telemetry``: a
    ``ServeTelemetry`` (default: one over the process registry); a fleet
    of in-process replicas gives each engine one over a registry of its
    own. ``pipelines``: built ``pipeline.Pipeline`` DAGs over these
    models, served beside them (``submit(x, model=<pipeline name>)``); a
    name that a model has already is refused. ``residency_bytes``: the
    resident weight bytes' budget (None: no eviction); ``tenant_quota``
    and ``slo_class``: per-tenant admission (``admission``).
    """

    def __init__(
        self,
        models: Iterable[ServedModel],
        *,
        buckets: tuple[int, ...] = (1, 4, 16, 64),
        max_queue: int = 256,
        per_model_limit: int | None = None,
        batch_window_s: float = 0.0,
        cache_entries: int = 64,
        freeze_cache: bool = False,
        fault_injector=None,
        restart_backoff_s: float = 0.05,
        restart_backoff_max_s: float = 5.0,
        store=None,
        telemetry: ServeTelemetry | None = None,
        pipelines: Iterable = (),
        residency_bytes: int | None = None,
        tenant_quota: dict[str, int] | None = None,
        slo_class: dict[str, str] | None = None,
    ):
        self._models = {m.name: m for m in models}
        if not self._models:
            raise ValueError("engine needs at least one ServedModel")
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1:
            raise ValueError(
                f"bucket ladder must be sorted, unique and positive, got "
                f"{buckets}")
        self.buckets = tuple(buckets)
        self.precision = strict_fp32()
        self._cache = CompileCache(max_entries=cache_entries)
        for p in pipelines:
            if p.name in self._models:
                raise ValueError(
                    f"pipeline {p.name!r} collides with a served model")
            p.bind(self._cache, self.buckets)
            self._models[p.name] = p
        # one CUDA graph memory pool a model on the card, shared by its
        # buckets' graphs (captured one after another, replayed one at a
        # time)
        self._pools: dict[str, object] = {}
        self.telemetry = telemetry if telemetry is not None \
            else ServeTelemetry()
        self._admission = AdmissionController(
            max_queue=max_queue, per_model_limit=per_model_limit,
            tenant_quota=tenant_quota, slo_class=slo_class)
        self._window = batch_window_s
        self._poll_s = 0.05
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._paused = threading.Event()
        # the backlog and the batch in the dispatcher's hands live on
        # the instance, so a dispatcher crash can fail their futures
        self._pending: dict[str, list[_Request]] = {
            name: [] for name in self._models}
        self._in_flight: list[_Request] = []
        self._recovering = threading.Event()
        # written by the supervisor, read by health() from any thread
        self._health_lock = threading.Lock()
        self._recover_until = 0.0  # monotonic end of the backoff
        self._injector = fault_injector
        self._restart_backoff_s = restart_backoff_s
        self._restart_backoff_max_s = restart_backoff_max_s
        self._backoff_reset_s = 5.0  # healthy this long resets the backoff
        if store is not None and not isinstance(store, ArtifactStore):
            store = ArtifactStore(store, log=self._log)
        self._store = store
        # the (model, bucket, dtype, fingerprint) keys whose runners came
        # off the disk instead of a trace
        self._from_store: set = set()
        self._tenancy = TenancyManager(
            self._cache, budget_bytes=residency_bytes, log=self._log,
            on_drop=self._forget_pools)
        self._adopt_tenants()
        self.warm()
        if freeze_cache:
            self._cache.freeze()
        self._thread = threading.Thread(
            target=self._supervise, name="serve-dispatch", daemon=True)
        self._thread.start()

    # -- setup -----------------------------------------------------------
    def _adopt_tenants(self) -> None:
        """Register every weight-carrying model with the tenancy manager:
        a pipeline's or a tracker's stage models (the same objects as the
        plain path's), else the model itself."""
        for m in self._models.values():
            for sm in self._tenant_models(m):
                self._tenancy.adopt(sm)

    @staticmethod
    def _tenant_models(served) -> list:
        if getattr(served, "is_pipeline", False) \
                or getattr(served, "is_stateful", False):
            return list(served.stage_models().values())
        return [served]

    def _tenant_names(self, served) -> list[str]:
        """The tenants whose weights ``served``'s runners read."""
        return [m.name for m in self._tenant_models(served)]

    def _model_key(self, m: ServedModel, bucket: int) -> tuple:
        """Runner-cache key: ``(model, bucket, dtype, weights
        fingerprint)``. The fingerprint pins a runner to the weights it
        was built for; a model without one keys ``"static"``."""
        fp = getattr(m, "weights_fingerprint", None)
        return (m.name, bucket, m.dtype_str,
                fp() if fp is not None else "static")

    @staticmethod
    def _log(*args, **kw) -> None:
        # store chatter goes to stderr: stdout is the JSONL stream when
        # the serving CLI hosts this engine
        print(*args, file=sys.stderr, **kw)

    def ladder(self, m: ServedModel) -> tuple[int, ...]:
        """``m``'s bucket ladder: its own (an artifact's exported batch)
        or the engine's."""
        return m.buckets if m.buckets else self.buckets

    def _build(self, m: ServedModel, bucket: int, pool=None):
        """``m``'s runner of ``bucket``, on the card captured into
        ``pool`` (default: the model's own graph pool)."""
        if pool is None and m.device.type == "cuda":
            import torch

            if m.name not in self._pools:
                self._pools[m.name] = torch.cuda.graph_pool_handle()
            pool = self._pools[m.name]
        return m.compile_for(bucket, pool)

    def _forget_pools(self, keys) -> None:
        """An eviction dropped the runners of ``keys``: their models'
        recaptures go into a fresh graph pool, since PyTorch cannot
        capture into a pool whose graphs have all been freed."""
        for key in keys:
            self._pools.pop(key[0], None)

    def _capture(self, key, m: ServedModel, bucket: int):
        """Build ``key``'s runner and register it with the editions it
        reads, with the build that captures it again."""
        runner = self._build(m, bucket)
        self._tenancy.register(key, runner,
                               lambda: self._build(m, bucket))
        return runner

    def warm(self) -> None:
        """Build every (model, bucket) runner, and every pipeline's entry
        bucket, so that no request pays a build; time in ``warmup_s``. On
        the card each is an eager forward and a CUDA graph's capture, the
        largest bucket first: the smaller graphs then fit in the pool's
        blocks that the larger one's intermediates freed, and the pool
        holds about what the largest bucket needs, not the sum over the
        ladder.

        With a store, each (model, bucket) but an artifact's first tries
        the disk: a verified program of this device and these weights loads
        into the cache (``install``, no miss counted) in place of the
        trace. A miss is traced as before and exported into the store, so
        that the first server over a directory fills it for the next. A
        runner over a loaded program (from the store or an artifact) then
        runs once on a zero batch through the request path; one from the
        store that fails to build or run is rejected into quarantine and
        the model traced. A pipeline's runner runs once on a zero batch
        too, the whole DAG through the request path, and its stage events
        are read once. The models come first, so that their graphs are
        captured before the DAGs'.

        Each model's tenants are made resident before its runners are
        built (a graph is captured over weights on the card), and after
        them the tenancy manager evicts over the budget, never those
        tenants. A tenant whose whole ladder came from the store gives
        its edition's device copy back (``release_to_baked``)."""
        t0 = time.perf_counter()
        for m in self._models.values():
            names = self._tenant_names(m)
            with self._tenancy.lock:
                for tn in names:
                    self._tenancy.ensure_resident(tn, protect=names)
            for bucket in reversed(self.ladder(m)):
                key = self._model_key(m, bucket)
                storing = self._store is not None and self._storeable(m)
                program = (self._load_store_program(m, bucket) if storing
                           else None)
                if program is not None:
                    try:
                        runner = self._build(m.with_program(program), bucket)
                        self._zero_run(m, runner, bucket)
                    except Exception as e:
                        # no re-export: this very program just failed
                        # to run from its serialized form here
                        self._log(f"[artifact-store] {m.name}@{bucket}: "
                                  f"stored program failed to run ({e}); "
                                  "rejecting + re-tracing")
                        self._reject_store_entry(m, bucket, reason=str(e))
                        storing = False
                    else:
                        self._cache.install(key, runner)
                        self._from_store.add(key)
                        continue
                runner = self._cache.get_or_build(
                    key, lambda m=m, bucket=bucket, key=key:
                    self._capture(key, m, bucket))
                if m.exported or getattr(m, "is_pipeline", False) \
                        or getattr(m, "is_stateful", False):
                    self._zero_run(m, runner, bucket)
                if getattr(m, "is_pipeline", False):
                    # the stage events read once: a build whose graph
                    # events cannot be timed fails the warm-up here
                    m.take_stage_stamps()
                if storing:
                    self._save_store_entry(m, bucket)
            self._tenancy.settle(names)
        if self._store is not None:
            for m in self._models.values():
                keys = [self._model_key(m, b) for b in self.ladder(m)]
                if self._storeable(m) and all(k in self._from_store
                                              for k in keys):
                    self._tenancy.release_to_baked(m, len(keys))
        self.warmup_s = round(time.perf_counter() - t0, 3)

    @staticmethod
    def _storeable(m) -> bool:
        """Models whose request program the store can carry: a plain
        model's. An artifact already is a serialized program, a pipeline
        is built from its stage models, and a stateful model's programs
        read live per-stream state."""
        return not m.exported and not getattr(m, "is_pipeline", False) \
            and not getattr(m, "is_stateful", False)

    @staticmethod
    def _zero_run(m: ServedModel, runner, bucket: int) -> None:
        runner(np.zeros((bucket, *m.input_shape), m.input_dtype))

    def _store_key(self, m: ServedModel, bucket: int) -> dict:
        return {"model": m.name, "bucket": bucket, "dtype": m.dtype_str,
                "device": device_desc(m.device),
                "fingerprint": m.weights_fingerprint()}

    def _load_store_program(self, m: ServedModel, bucket: int):
        """Verified store bytes -> the loaded program, or None (a miss, a
        corrupt entry that the store quarantined, bytes that do not
        load): the caller traces the model, so that the store never
        fails a warm-up, only shortens it."""
        from deepvision_tpu_torch.export import deserialize_exported

        data = self._store.get(**self._store_key(m, bucket))
        if data is None:
            return None
        try:
            return deserialize_exported(data)
        except Exception as e:
            self._log(f"[artifact-store] {m.name}@{bucket}: load failed "
                      f"({e}); re-tracing")
            return None

    def _save_store_entry(self, m: ServedModel, bucket: int) -> None:
        """Best-effort export into the store: a full disk must never take
        serving down with it."""
        try:
            self._store.put(m.export_bytes(bucket),
                            **self._store_key(m, bucket))
        except Exception as e:
            self._log(f"[artifact-store] export {m.name}@{bucket} "
                      f"failed: {e}")

    def _reject_store_entry(self, m: ServedModel, bucket: int, *,
                            reason: str) -> None:
        """Quarantine a store entry that loaded but could not run here,
        best-effort like every store write."""
        try:
            self._store.reject(**self._store_key(m, bucket), reason=reason)
        except Exception as e:
            self._log(f"[artifact-store] reject {m.name}@{bucket} "
                      f"failed: {e}")

    def _bucket_runner(self, served: ServedModel, bucket: int):
        """The cached runner of (model, bucket), with swap consistency: if
        a hot swap flips the model between the key's read and the lookup,
        look again, so that the runner a key names always pairs with the
        weights in that key. A runner that an eviction dropped is
        recaptured (``install``, no miss) once its weights are back."""
        while True:
            key = self._model_key(served, bucket)
            runner = self._tenancy.restore(key)
            if runner is None:
                runner = self._cache.get_or_build(
                    key, lambda: self._capture(key, served, bucket))
            if key == self._model_key(served, bucket):
                return runner

    def _checkout(self, served, bucket: int):
        """The runner of a batch, under the residency lock: the batch's
        tenants made resident (protected together from the budget's
        evictions), the runner looked up, its editions pinned until
        :meth:`TenancyManager.unpin`."""
        names = self._tenant_names(served)
        with self._tenancy.lock:
            for tn in names:
                self._tenancy.ensure_resident(tn, protect=names)
            runner = self._bucket_runner(served, bucket)
            self._tenancy.pin(runner)
        return runner

    # -- tenancy ---------------------------------------------------------
    def hot_swap(self, name: str, variables=None, *,
                 workdir: str | None = None,
                 perturb: float | None = None) -> dict:
        """Zero-drop weight swap of model ``name``, on the caller's
        thread: the new weights go into a shadow model (a new module and
        forward), the whole bucket ladder is captured against it into a
        new graph pool while the dispatcher serves the old one, then the
        model flips between batches and the old fingerprint's runners
        leave the cache. A batch already dispatched drains on the old
        weights; nothing is dropped.

        Exactly one source: ``variables`` (a weights tree in the JAX
        layout, ``resilience/sentinel.state_tree``'s), ``workdir`` (the
        newest verified checkpoint under ``{workdir}/ckpt``) or
        ``perturb`` (every floating leaf of the current tree, batch
        statistics included, plus ``perturb``: a new fingerprint without
        a second checkpoint). A pipeline or a tracker that holds the
        model as a stage keeps serving the weights it was captured over;
        a swap targets a model's front door, never a pipeline, a
        stateful wrapper or an artifact."""
        served = self._models.get(name)
        if served is None:
            raise ValueError(f"unknown model {name!r}; serving "
                             f"{sorted(self._models)}")
        if getattr(served, "is_pipeline", False) \
                or getattr(served, "is_stateful", False):
            kind = ("pipeline" if getattr(served, "is_pipeline", False)
                    else "stateful wrapper")
            raise ValueError(f"{name!r} is a {kind}; hot-swap targets its "
                             "stage models' front doors")
        if served.edition is None:
            raise ValueError(
                f"{name!r} is a torch.export artifact (weights baked into "
                "the program); register a new artifact instead")
        if sum(v is not None for v in (variables, workdir, perturb)) != 1:
            raise ValueError(
                "pass exactly one of variables=, workdir=, perturb=")
        from deepvision_tpu_torch.resilience.sentinel import state_tree

        if workdir is not None:
            from deepvision_tpu_torch.serve.models import restore_state

            module, _ = restore_state(name, workdir, device="cpu")
            variables = state_tree(module)
        if perturb is not None:
            def nudge(tree):
                if isinstance(tree, dict):
                    return {k: nudge(v) for k, v in tree.items()}
                if np.issubdtype(tree.dtype, np.floating):
                    return (tree + perturb).astype(tree.dtype)
                return tree

            variables = nudge(state_tree(served.edition.module))
        pool = None
        if served.device.type == "cuda":
            import torch

            # the new ladder's own pool; until it is the model's, a
            # capture of the model goes into a fresh one, never into the
            # old pool, whose graphs the swap frees
            pool = torch.cuda.graph_pool_handle()
            self._pools.pop(name, None)
        result = self._tenancy.swap(
            served, variables, ladder=self.ladder(served),
            key_fn=self._model_key,
            build=lambda m, b: self._build(m, b, pool),
            rebuild=self._build)
        if result.get("unchanged"):
            return result
        if pool is not None:
            self._pools.setdefault(name, pool)
        # the swap dropped any store-warmed runners of this model
        self._from_store = {k for k in self._from_store if k[0] != name}
        if self._store is not None and self._storeable(served):
            # a replica respawned after the swap warms the new weights
            for bucket in self.ladder(served):
                self._save_store_entry(served, bucket)
        return result

    @property
    def tenancy(self) -> TenancyManager:
        """The engine's ``TenancyManager`` (without a budget unless
        ``residency_bytes`` set one); the serving CLI prints its
        :meth:`~TenancyManager.summary_line` at exit."""
        return self._tenancy

    # -- client surface --------------------------------------------------
    def submit(self, x, model: str | None = None, *,
               timeout_s: float | None = None, trace: str | None = None,
               session: str | None = None,
               seq: int | None = None) -> Future:
        """Enqueue one example (no batch dim) for ``model``; returns a
        Future resolving to the task's result dict. Raises
        :class:`ShedError` at once when admission rejects, and
        ``ValueError`` on a shape or model mismatch. ``trace`` is the
        request's distributed trace id (the router's ``X-DVTPU-Trace``),
        which its ``replica_queue``, ``device`` and ``postprocess`` spans
        carry.

        A stateful model needs ``session`` (the stream's id) and ``seq``
        (the frame's number, from 0); a NEW session is shed here when its
        store is full. ``session`` on a stateless model is a
        ``ValueError``."""
        if model is None:
            if len(self._models) != 1:
                raise ValueError(
                    f"engine hosts {sorted(self._models)}; pass model=")
            (model,) = self._models
        served = self._models.get(model)
        if served is None:
            raise ValueError(f"unknown model {model!r}; serving "
                             f"{sorted(self._models)}")
        if self._stop.is_set():
            raise RuntimeError("engine is closed")
        x = np.asarray(x, dtype=served.input_dtype)
        if x.shape != served.input_shape:
            raise ValueError(
                f"{model!r} expects input shape {served.input_shape}, "
                f"got {x.shape}")
        if getattr(served, "is_stateful", False):
            if session is None or seq is None:
                raise ValueError(
                    f"stateful model {model!r} requires session= and "
                    "seq= on submit")
            if not isinstance(session, str):
                # a session id names its snapshot files
                raise ValueError(f"session must be a string, got "
                                 f"{type(session).__name__}")
            seq = int(seq)
            if seq < 0:
                raise ValueError(f"seq must be >= 0, got {seq}")
            try:
                # capacity sheds NEW sessions at the door; existing
                # streams keep their state (never a silent reset)
                served.store.admit(session)
            except ShedError:
                self.telemetry.record_shed()
                raise
        elif session is not None:
            raise ValueError(
                f"model {model!r} is stateless; session=/seq= is only "
                "valid for stateful models")
        try:
            self._admission.admit(model)
        except ShedError:
            self.telemetry.record_shed()
            raise
        self.telemetry.record_submit()
        req = _Request(model, x, deadline=(
            time.perf_counter() + timeout_s if timeout_s is not None
            else None), trace=trace, session=session, seq=seq)
        self._q.put(req)
        if self._stop.is_set():
            # raced close(): the dispatcher's exit drain may already have
            # passed; whoever resolves the future releases its slot
            self._fail_request(req, RuntimeError("engine closed"))
        return req.future

    def _session_stores(self) -> dict:
        """name -> SessionStore of every stateful model."""
        return {name: m.store for name, m in self._models.items()
                if getattr(m, "is_stateful", False)}

    def stats(self) -> dict:
        """JSON-able state for ``/stats``: models (pipelines among them),
        the requests each pipeline served, ladder, health, queue, the
        runner cache, the runners, the runners that came from the
        store (and the store's counters), telemetry, the process's
        kernel launches so far (``ops.kernel_launches``: true launches,
        each capture's eager forward and each replay's, which a fleet's
        replicas report from their own processes) and, with a stateful
        model, each session store's stats."""
        from deepvision_tpu_torch.ops import kernel_launches

        out = {
            "models": sorted(self._models),
            "pipelines": {
                name: m.requests_served
                for name, m in sorted(self._models.items())
                if getattr(m, "is_pipeline", False)},
            "devices": {n: str(m.device) for n, m in self._models.items()},
            "buckets": list(self.buckets),
            "precision": self.precision,
            "warmup_s": self.warmup_s,
            "health": self.health(),
            "queue": self._admission.stats(),
            "cache": self._cache.stats(),
            "runners": self.runner_stats(),
            "warmed_from_store": sorted(
                f"{k[0]}@{k[1]}" for k in self._from_store),
            "telemetry": self.telemetry.snapshot(),
            "kernel_launches": kernel_launches(),
            "tenancy": self._tenancy.stats(),
        }
        if self._store is not None:
            out["artifact_store"] = self._store.stats()
        stores = self._session_stores()
        if stores:
            out["sessions"] = {name: s.stats()
                               for name, s in sorted(stores.items())}
        return out

    def runner_stats(self) -> dict:
        """By model (and pipeline): the kind of its runners, the bytes its
        graph memory pool reserves (0 on the CPU) and, by bucket, the
        runner's build seconds, the kernel launches of one call and its
        calls so far (a track runner's of its detect program, and its
        advance program's beside them): the runners that the cache holds
        now."""
        out: dict[str, dict] = {}
        for key, r in sorted(self._cache.items(), key=lambda kv: kv[0][:2]):
            name, bucket = key[:2]
            entry = out.setdefault(name, {"kind": r.kind, "pool_bytes": 0,
                                          "buckets": {}})
            entry["pool_bytes"] += r.pool_bytes
            entry["buckets"][str(bucket)] = {
                "capture_s": round(r.capture_s, 4),
                "launches": dict(r.launches), "calls": r.calls,
                **(r.extra_stats() if hasattr(r, "extra_stats") else {})}
        return out

    def health(self) -> dict:
        """Liveness for ``/healthz``: ``"recovering"``, with
        ``retry_after_s`` (the rest of the backoff), while the supervisor
        waits to restart a crashed dispatcher; ``"ok"`` otherwise. The
        crash and restart counts ride along, so that a probe tells a
        self-healed engine from one that never faulted."""
        recovering = self._recovering.is_set()
        out = {
            "status": "recovering" if recovering else "ok",
            "dispatcher_crashes": self.telemetry.dispatcher_crashes,
            "dispatcher_restarts": self.telemetry.dispatcher_restarts,
        }
        if recovering:
            with self._health_lock:
                until = self._recover_until
            out["retry_after_s"] = round(
                max(0.05, until - time.monotonic()), 3)
        stores = self._session_stores()
        if stores:
            # live streams, the bytes their state holds, and the worst
            # snapshot age (how much replay a crash now would need)
            agg = [s.stats() for s in stores.values()]
            ages = [a["snapshot_age_s"] for a in agg
                    if a["snapshot_age_s"] is not None]
            out["sessions"] = {
                "live": sum(a["live"] for a in agg),
                "pinned_bytes": sum(a["pinned_bytes"] for a in agg),
                "snapshot_age_s": max(ages) if ages else None,
            }
        return out

    # pause/resume: deterministic queue build-up (backpressure, deadline
    # expiry) for tests
    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()
        self._q.put(_WAKE)

    # -- dispatcher ------------------------------------------------------
    def _supervise(self) -> None:
        """Run the dispatch loop under crash supervision: an exception
        that escapes the loop body fails every queued and in-flight
        future with the error at once, then the loop restarts after a
        capped exponential backoff, during which :meth:`health` reports
        ``"recovering"``. It reports so before the futures fail, so that
        a client that sees its request fail finds the engine recovering.
        The backoff resets once a loop has lived ``_backoff_reset_s``."""
        backoff = self._restart_backoff_s
        while True:
            t0 = time.monotonic()
            try:
                self._dispatch_loop()
                return  # close(): the loop drained and exited
            except BaseException as e:
                self.telemetry.record_dispatcher_crash()
                if time.monotonic() - t0 > self._backoff_reset_s:
                    backoff = self._restart_backoff_s
                with self._health_lock:
                    self._recover_until = time.monotonic() + backoff
                self._recovering.set()
                # the black box first: the flight recorder's ring holds
                # the spans up to this very moment
                flight_dump("dispatcher_crash")
                n = self._fail_all_pending(RuntimeError(
                    f"dispatcher crashed: {type(e).__name__}: {e}"))
                print(f"[serve-supervisor] dispatcher crashed "
                      f"({type(e).__name__}: {e}); failed {n} pending "
                      f"request(s); restarting in {backoff:.2f}s",
                      file=sys.stderr, flush=True)
                self._stop.wait(backoff)  # close() wakes this at once
                self._recovering.clear()
                if self._stop.is_set():
                    self._fail_all_pending(RuntimeError("engine closed"))
                    return
                backoff = min(backoff * 2, self._restart_backoff_max_s)
                self.telemetry.record_dispatcher_restart()

    def _dispatch_loop(self) -> None:
        pending = self._pending
        rr = list(self._models)  # round-robin cursor over models
        while not self._stop.is_set():
            if self._paused.is_set():
                self._stop.wait(0.002)
                continue
            self._drain_inbound(pending, block=not any(pending.values()))
            if self._stop.is_set() or self._paused.is_set():
                continue
            name = self._next_model(pending, rr)
            if name is None:
                continue
            served = self._models[name]
            ladder_max = self.ladder(served)[-1]
            self._fill_window(pending, name, ladder_max)
            reqs = pending[name][:ladder_max]
            del pending[name][:ladder_max]
            if getattr(served, "is_stateful", False):
                reqs = self._one_frame_a_session(pending[name], reqs)
            # visible to the crash handler from the moment they leave the
            # backlog, so that a crash past this point fails them too
            self._in_flight = reqs
            live = self._expire(reqs)
            if live:
                self._in_flight = live
                if self._injector is not None:
                    self._injector.check_dispatch()  # chaos site
                self._run_batch(served, live)
            self._in_flight = []
        # closing: fail anything still queued so no caller blocks forever
        self._fail_all_pending(RuntimeError("engine closed"))

    @staticmethod
    def _one_frame_a_session(backlog: list, reqs: list) -> list:
        """One frame a session a batch: a program reads each row's slate
        as it was before the batch, so two frames of one stream in a batch
        would both read stale state. The later frames go back to the FRONT
        of the backlog in arrival order, so each stream stays FIFO."""
        seen: set[str] = set()
        keep: list[_Request] = []
        defer: list[_Request] = []
        for r in reqs:
            if r.session in seen:
                defer.append(r)
            else:
                seen.add(r.session)
                keep.append(r)
        backlog[:0] = defer
        return keep

    def _fail_all_pending(self, exc: BaseException) -> int:
        """Resolve every queued and in-flight future with ``exc``."""
        n = 0
        self._drain_inbound(self._pending, block=False)
        for r in self._in_flight:
            n += self._fail_request(r, exc)
        self._in_flight = []
        for reqs in self._pending.values():
            for r in reqs:
                n += self._fail_request(r, exc)
            reqs.clear()
        return n

    def _fail_request(self, r: _Request, exc: BaseException) -> int:
        # whoever resolves the future releases its slot, exactly once
        try:
            r.future.set_exception(exc)
        except InvalidStateError:
            return 0
        self.telemetry.record_failure()
        self._admission.release(r.model)
        return 1

    def _drain_inbound(self, pending, block: bool) -> None:
        try:
            item = (self._q.get(timeout=self._poll_s) if block
                    else self._q.get_nowait())
        except queue.Empty:
            return
        while True:
            if item is not _WAKE:
                pending[item.model].append(item)
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return

    @staticmethod
    def _next_model(pending, rr: list[str]) -> str | None:
        for _ in range(len(rr)):
            name = rr.pop(0)
            rr.append(name)
            if pending[name]:
                return name
        return None

    def _fill_window(self, pending, name: str, ladder_max: int) -> None:
        """Give the queue up to ``batch_window_s`` (from the oldest
        pending request) to fill the largest bucket."""
        if self._window <= 0:
            return
        until = pending[name][0].t_submit + self._window
        while len(pending[name]) < ladder_max and not self._stop.is_set():
            remaining = until - time.perf_counter()
            if remaining <= 0:
                return
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                return
            if item is not _WAKE:
                pending[item.model].append(item)

    def _expire(self, reqs: list[_Request]) -> list[_Request]:
        now = time.perf_counter()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                try:
                    r.future.set_exception(TimeoutError(
                        f"deadline expired after "
                        f"{now - r.t_submit:.3f}s in queue"))
                except InvalidStateError:
                    continue  # raced close() resolved (and released) it
                self.telemetry.record_timeout()
                self._admission.release(r.model)
            else:
                live.append(r)
        return live

    def _bucket_for(self, served: ServedModel, n: int) -> int:
        ladder = self.ladder(served)
        for b in ladder:
            if b >= n:
                return b
        return ladder[-1]

    def _run_batch(self, served: ServedModel, reqs: list[_Request]) -> None:
        if getattr(served, "is_stateful", False):
            self._run_stateful_batch(served, reqs)
            return
        t_dispatch = time.perf_counter()
        n = len(reqs)
        bucket = self._bucket_for(served, n)
        x = np.zeros((bucket, *served.input_shape), served.input_dtype)
        for i, r in enumerate(reqs):
            x[i] = r.x
        try:
            runner = self._checkout(served, bucket)
            try:
                t0 = time.perf_counter()
                host = runner(x)
                t_dev = time.perf_counter() - t0
            finally:
                self._tenancy.unpin(runner)
        except Exception as e:  # forward failure: fail this batch only
            for r in reqs:
                self._fail_request(r, e)
            return
        self.telemetry.record_batch(bucket=bucket, rows=n, device_s=t_dev)
        self._admission.observe_batch(t_dev, n)
        is_pipeline = getattr(served, "is_pipeline", False)
        expired: set[int] = set()
        if is_pipeline:
            served.record_served(n)
            expired = self._expire_mid_pipeline(reqs)
        tracer = get_tracer()
        if tracer.active:
            self._batch_spans(tracer, served, reqs, bucket, t_dispatch,
                              t0, t0 + t_dev, is_pipeline)
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            if id(r) in expired:
                continue  # resolved with TimeoutError, its slot released
            t_pp = time.perf_counter()
            try:
                result = served.postprocess(host, i)
            except Exception as e:
                self._fail_request(r, e)
            else:
                try:
                    r.future.set_result(result)
                except InvalidStateError:
                    continue  # raced close() resolved (and released) it
                self.telemetry.record_request(
                    queue_wait_s=t_dispatch - r.t_submit,
                    e2e_s=now - r.t_submit)
                self._admission.release(r.model)
            if r.trace and tracer.active:
                tracer.record_span("postprocess", t_pp, time.perf_counter(),
                                   cat="serve", args={"trace": r.trace})

    @staticmethod
    def _batch_spans(tracer, served, reqs: list[_Request], bucket: int,
                     t_dispatch: float, t0: float, t1: float,
                     is_pipeline: bool) -> None:
        """The retroactive spans of a stateless batch, from the stamps
        the dispatcher took (``record_span``, the same ``perf_counter``
        clock): ``device``, the runner's call, which ends with the fetch
        of its outputs; a DAG's ``stage:<node>`` spans inside it; each
        traced request's ``replica_queue``."""
        traces = [r.trace for r in reqs if r.trace]
        tracer.record_span(
            "device", t0, t1, cat="serve",
            args={"model": served.name, "bucket": bucket, "rows": len(reqs),
                  **({"traces": traces} if traces else {})})
        if is_pipeline:
            # one span a stage, stamped with every trace id of the batch,
            # so that a request's flow runs router -> replica_queue ->
            # device -> stage:<node> -> postprocess
            for stage_name, s0, s1 in served.take_stage_stamps():
                tracer.record_span(
                    f"stage:{stage_name}", s0, s1, cat="serve",
                    args={"pipeline": served.name, "stage": stage_name,
                          **({"traces": traces} if traces else {})})
        for r in reqs:
            if r.trace:
                tracer.record_span(
                    "replica_queue", r.t_submit, t_dispatch, cat="serve",
                    args={"trace": r.trace, "model": served.name})

    def _expire_mid_pipeline(self, reqs: list[_Request]) -> set[int]:
        """Deadline honesty mid-DAG: a multi-stage run can outlive a
        deadline that the queue-time check passed. Each such request
        resolves with ``TimeoutError`` exactly once (whoever resolves the
        future releases its slot), never with a late answer. -> the ids
        of the requests it resolved."""
        now = time.perf_counter()
        expired = set()
        for r in reqs:
            if r.deadline is None or now <= r.deadline:
                continue
            try:
                r.future.set_exception(TimeoutError(
                    f"deadline expired mid-pipeline after "
                    f"{now - r.t_submit:.3f}s"))
            except InvalidStateError:
                continue  # raced close() resolved (and released) it
            self.telemetry.record_timeout()
            self._admission.release(r.model)
            expired.add(id(r))
        return expired

    def _run_stateful_batch(self, served, reqs: list[_Request]) -> None:
        """One batch of a stateful model (a ``TrackingPipeline``): each
        frame dispositioned by the session store, duplicates answered
        idempotently, then the detect and the interpolated frames as two
        sub-batches, each one program of the runner. The state stays on
        the device: one fetch of each sub-batch's outputs, none of the
        state; the one state fetch is the store's snapshot on its
        cadence, inside ``commit``."""
        store = served.store
        t_dispatch = time.perf_counter()
        frames = [(r, store.begin_frame(r.session, r.seq,
                                        served.detect_every))
                  for r in reqs]
        now = time.perf_counter()
        for r, f in frames:
            if f.action != "duplicate":
                continue
            # an idempotent answer to a replayed or retried frame: seq
            # already applied, nothing run, no state touched
            try:
                r.future.set_result({"session": r.session, "seq": r.seq,
                                     "replayed": True,
                                     "state_reset": False})
            except InvalidStateError:
                continue  # raced close() resolved (and released) it
            self.telemetry.record_request(
                queue_wait_s=t_dispatch - r.t_submit,
                e2e_s=now - r.t_submit)
            self._admission.release(r.model)
        for mode in ("detect", "interp"):
            group = [(r, f) for r, f in frames if f.action == "apply"
                     and f.run_detect == (mode == "detect")]
            if group:
                self._run_stateful_group(served, store, group, mode,
                                         t_dispatch)

    def _run_stateful_group(self, served, store, group, mode: str,
                            t_dispatch: float) -> None:
        n = len(group)
        bucket = self._bucket_for(served, n)
        try:
            runner = self._checkout(served, bucket)
            try:
                # each stream's slate row: its device row, a restored
                # snapshot's host arrays, or None (fresh or reset: zeros)
                rows = [f.entry.state for _r, f in group]
                t0 = time.perf_counter()
                if mode == "detect":
                    x = np.stack([r.x for r, _f in group])
                    new_slates, host = runner.detect.run(x, rows)
                else:
                    new_slates, host = runner.advance.run(None, rows)
                t_dev = time.perf_counter() - t0
            finally:
                self._tenancy.unpin(runner)
        except Exception as e:  # a forward failure: fail the group only
            for r, _f in group:
                self._fail_request(r, e)
            return
        self.telemetry.record_batch(bucket=bucket, rows=n, device_s=t_dev)
        self._admission.observe_batch(t_dev, n)
        tracer = get_tracer()
        if tracer.active:
            traces = [r.trace for r, _f in group if r.trace]
            tracer.record_span(
                "device", t0, t0 + t_dev, cat="serve",
                args={"model": served.name, "bucket": bucket, "rows": n,
                      "mode": mode,
                      "sessions": [r.session for r, _f in group],
                      **({"traces": traces} if traces else {})})
        now = time.perf_counter()
        for i, (r, f) in enumerate(group):
            # commit FIRST: the stream's lineage advances even if this
            # answer expired, so the client's retry is a duplicate and
            # never forks the stream. A clone, never a view: the
            # program's next call overwrites its static outputs
            store.commit(r.session, r.seq,
                         {k: v[i].clone() for k, v in new_slates.items()})
            if r.deadline is not None and now > r.deadline:
                try:
                    r.future.set_exception(TimeoutError(
                        f"deadline expired mid-batch after "
                        f"{now - r.t_submit:.3f}s"))
                except InvalidStateError:
                    continue
                self.telemetry.record_timeout()
                self._admission.release(r.model)
                continue
            t_pp = time.perf_counter()
            try:
                result = served.postprocess(host, i)
                # the same merge on every restore path
                result["session"] = r.session
                result["seq"] = r.seq
                result["detected"] = mode == "detect"
                result["state_reset"] = bool(f.reset)
            except Exception as e:
                self._fail_request(r, e)
                continue
            try:
                r.future.set_result(result)
            except InvalidStateError:
                pass  # raced close() resolved (and released) it
            else:
                self.telemetry.record_request(
                    queue_wait_s=t_dispatch - r.t_submit,
                    e2e_s=now - r.t_submit)
                self._admission.release(r.model)
            if r.trace and tracer.active:
                # the session on the spans: a stream's flow assembles in
                # the merged timeline
                tracer.record_span(
                    "replica_queue", r.t_submit, t_dispatch, cat="serve",
                    args={"trace": r.trace, "model": served.name,
                          "session": r.session})
                tracer.record_span(
                    "postprocess", t_pp, time.perf_counter(), cat="serve",
                    args={"trace": r.trace, "session": r.session})

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout: float = 10.0, *,
              abandon_sessions: bool = False) -> None:
        """Stop the dispatcher and join its thread; pending futures fail
        with RuntimeError('engine closed'). Each session store then
        flushes a snapshot of every dirty session, or with
        ``abandon_sessions=True`` drops the state without one (the crash
        semantics of a replica's kill, so that recovery runs off the
        cadence snapshots). Then drop every runner and graph memory pool,
        which frees the graphs' device memory once the allocator's cache
        is emptied. Idempotent."""
        self._stop.set()
        self._paused.clear()
        self._q.put(_WAKE)
        self._thread.join(timeout)
        for s in {id(s): s for s in self._session_stores().values()
                  }.values():
            if abandon_sessions:
                s.abandon()
            else:
                s.flush()
        self._cache.drop_where(lambda key: True)
        self._tenancy.clear()
        self._pools.clear()

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
