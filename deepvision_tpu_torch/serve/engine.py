"""Batched inference engine: queue -> micro-batch -> bucket -> forward.

The core of ``deepvision_tpu/serve/engine.py``'s ``InferenceEngine`` on
PyTorch. A dispatcher thread drains the request queue into per-model
micro-batches and pads each batch with zero rows up to a fixed bucket
ladder (default 1/4/16/64), so the device only ever sees a few batch
shapes, each run once at start-up by :meth:`InferenceEngine.warm`. A
batch goes to the device with one host-to-device copy and its outputs
come back with one device-to-host copy (``ServedModel.run``).

Guarantees, as in the twin:

- **pad isolation**: padded rows are zero inputs whose outputs are
  dropped before postprocess (eval-mode rows are independent);
- **bounded latency or shed**: admission control rejects work with a
  retry hint once the queue saturates;
- **deadline honesty**: a request whose deadline passes while queued
  resolves with ``TimeoutError``, never a late answer;
- **batch failure containment**: a forward that raises fails exactly
  that batch's futures;
- **clean shutdown**: ``close()`` stops and joins the dispatcher and
  fails every pending future.

Multi-tenancy, the artifact store, pipelines, sessions, fault injection
and the supervisor's restart loop belong to later slices of the port. A
dispatcher that dies here fails every pending future and closes the
engine instead of restarting.

The engine runs its models in true float32: it turns TF32 off for
cuDNN and cuBLAS (``device.strict_fp32``).
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
from deepvision_tpu_torch.serve.admission import AdmissionController, ShedError
from deepvision_tpu_torch.serve.models import ServedModel
from deepvision_tpu_torch.serve.telemetry import ServeTelemetry

__all__ = ["InferenceEngine", "ShedError"]

_WAKE = object()  # queue sentinel: wake the dispatcher without a request


class _Request:
    __slots__ = ("model", "x", "future", "t_submit", "deadline")

    def __init__(self, model: str, x: np.ndarray, deadline: float | None):
        self.model = model
        self.x = x
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline


class InferenceEngine:
    """Multi-model batched inference on each model's device.

    ``batch_window_s``: after the first request of a batch arrives, how
    long the dispatcher waits for the largest bucket to fill before it
    runs a partial (padded) batch. 0 trades padding for latency; a
    backlog fills buckets regardless.
    """

    def __init__(
        self,
        models: Iterable[ServedModel],
        *,
        buckets: tuple[int, ...] = (1, 4, 16, 64),
        max_queue: int = 256,
        per_model_limit: int | None = None,
        batch_window_s: float = 0.0,
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
        self.telemetry = ServeTelemetry()
        self._admission = AdmissionController(
            max_queue=max_queue, per_model_limit=per_model_limit)
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
        self.warm()
        self._thread = threading.Thread(
            target=self._dispatch, name="serve-dispatch", daemon=True)
        self._thread.start()

    # -- setup -----------------------------------------------------------
    def warm(self) -> None:
        """Run every (model, bucket) once on a zero batch, so cuDNN's
        algorithm choice, the kernels' build and the allocator's first
        growth happen before any request; time in ``warmup_s``."""
        t0 = time.perf_counter()
        for m in self._models.values():
            for bucket in self.buckets:
                m.run(np.zeros((bucket, *m.input_shape), m.input_dtype))
        self.warmup_s = round(time.perf_counter() - t0, 3)

    # -- client surface --------------------------------------------------
    def submit(self, x, model: str | None = None, *,
               timeout_s: float | None = None) -> Future:
        """Enqueue one example (no batch dim) for ``model``; returns a
        Future resolving to the task's result dict. Raises
        :class:`ShedError` at once when admission rejects, and
        ``ValueError`` on a shape or model mismatch."""
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
        try:
            self._admission.admit(model)
        except ShedError:
            self.telemetry.record_shed()
            raise
        self.telemetry.record_submit()
        req = _Request(model, x, deadline=(
            time.perf_counter() + timeout_s if timeout_s is not None
            else None))
        self._q.put(req)
        if self._stop.is_set():
            # raced close(): the dispatcher's exit drain may already have
            # passed; whoever resolves the future releases its slot
            self._fail_request(req, RuntimeError("engine closed"))
        return req.future

    def stats(self) -> dict:
        """JSON-able state: models, ladder, queue and telemetry."""
        return {
            "models": sorted(self._models),
            "devices": {n: str(m.device) for n, m in self._models.items()},
            "buckets": list(self.buckets),
            "precision": self.precision,
            "warmup_s": self.warmup_s,
            "queue": self._admission.stats(),
            "telemetry": self.telemetry.snapshot(),
        }

    # pause/resume: deterministic queue build-up (backpressure, deadline
    # expiry) for tests
    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()
        self._q.put(_WAKE)

    # -- dispatcher ------------------------------------------------------
    def _dispatch(self) -> None:
        try:
            self._dispatch_loop()
        except BaseException as e:
            # no restart loop in this slice: fail everything pending now
            # (no client waits for its deadline) and refuse new work
            self._stop.set()
            n = self._fail_all_pending(RuntimeError(
                f"dispatcher crashed: {type(e).__name__}: {e}"))
            print(f"[serve] dispatcher crashed ({type(e).__name__}: {e}); "
                  f"failed {n} pending request(s); engine closed",
                  file=sys.stderr, flush=True)

    def _dispatch_loop(self) -> None:
        pending = self._pending
        rr = list(self._models)  # round-robin cursor over models
        ladder_max = self.buckets[-1]
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
            self._fill_window(pending, name, ladder_max)
            reqs = pending[name][:ladder_max]
            del pending[name][:ladder_max]
            self._in_flight = reqs
            live = self._expire(reqs)
            if live:
                self._in_flight = live
                self._run_batch(self._models[name], live)
            self._in_flight = []
        # closing: fail anything still queued so no caller blocks forever
        self._fail_all_pending(RuntimeError("engine closed"))

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

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run_batch(self, served: ServedModel, reqs: list[_Request]) -> None:
        t_dispatch = time.perf_counter()
        n = len(reqs)
        bucket = self._bucket_for(n)
        x = np.zeros((bucket, *served.input_shape), served.input_dtype)
        for i, r in enumerate(reqs):
            x[i] = r.x
        try:
            t0 = time.perf_counter()
            host = served.run(x)
            t_dev = time.perf_counter() - t0
        except Exception as e:  # forward failure: fail this batch only
            for r in reqs:
                self._fail_request(r, e)
            return
        self.telemetry.record_batch(bucket=bucket, rows=n, device_s=t_dev)
        self._admission.observe_batch(t_dev, n)
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            try:
                result = served.postprocess(host, i)
            except Exception as e:
                self._fail_request(r, e)
                continue
            try:
                r.future.set_result(result)
            except InvalidStateError:
                continue  # raced close() resolved (and released) it
            self.telemetry.record_request(
                queue_wait_s=t_dispatch - r.t_submit,
                e2e_s=now - r.t_submit)
            self._admission.release(r.model)

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher and join its thread; pending futures fail
        with RuntimeError('engine closed'). Idempotent."""
        self._stop.set()
        self._paused.clear()
        self._q.put(_WAKE)
        self._thread.join(timeout)

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
