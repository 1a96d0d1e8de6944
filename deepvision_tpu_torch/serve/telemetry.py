"""Serving telemetry: per-request latency summaries and counters.

The twin of ``deepvision_tpu/serve/telemetry.py``'s ``ServeTelemetry``:
the same ``record_*`` and ``snapshot`` names and the same snapshot keys.
Request wall time is split into queue wait (admitted -> dispatched),
device time (one batch's H2D copy, forward and D2H copy) and end-to-end
latency. Every counter is an ``obs.metrics.Counter`` and every latency
series an ``obs.metrics.Histogram``, registered into the process
registry under ``serve_*`` names (a newer engine's telemetry replaces an
older one's), so that ``GET /metrics`` renders the numbers ``/stats``
reports.
"""

from __future__ import annotations

import threading

from deepvision_tpu_torch.obs.metrics import (
    Counter,
    Histogram,
    Registry,
    default_registry,
)

__all__ = ["LatencyStats", "ServeTelemetry"]


class LatencyStats:
    """A latency series over an ``obs.metrics.Histogram`` (a bounded
    reservoir of the newest ``maxlen`` samples with an exact lifetime
    count and total). ``record`` takes seconds; ``summary`` reports
    milliseconds."""

    def __init__(self, maxlen: int = 8192, hist: Histogram | None = None):
        self._hist = hist if hist is not None else Histogram(maxlen=maxlen)

    def record(self, seconds: float) -> None:
        self._hist.observe(seconds)

    @property
    def count(self) -> int:
        return self._hist.count

    @property
    def total_s(self) -> float:
        return self._hist.total

    def summary(self) -> dict:
        return self._hist.summary()


# exact counters, in snapshot order
_COUNTER_FIELDS = (
    "submitted",      # admitted into the queue
    "completed",      # futures resolved with a result
    "timed_out",      # deadline expired while queued
    "failed",         # forward or postprocess raised
    "shed",           # rejected at admission (backpressure)
    "batches",        # executed device batches
    "rows",           # real rows across executed batches
    "padded_rows",    # zero rows added to reach the bucket
    # the dispatcher's supervisor (engine._supervise): a crash fails the
    # queued and in-flight futures and the loop restarts after a backoff;
    # these tell a self-healed engine from one that never faulted
    "dispatcher_crashes",
    "dispatcher_restarts",
)


class ServeTelemetry:
    """Counters and per-stage latency summaries for one engine,
    registered into ``registry`` (default: the process's)."""

    def __init__(self, registry: Registry | None = None):
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        self._lock = threading.Lock()
        self._c = {f: reg.register(f"serve_{f}", Counter())
                   for f in _COUNTER_FIELDS}
        self.queue_wait = LatencyStats(
            hist=reg.register("serve_queue_wait", Histogram()))
        self.device_time = LatencyStats(
            hist=reg.register("serve_device_time", Histogram()))
        self.e2e = LatencyStats(
            hist=reg.register("serve_e2e_latency", Histogram()))

    def _inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._c[field].inc(n)

    def record_submit(self) -> None:
        self._inc("submitted")

    def record_shed(self) -> None:
        self._inc("shed")

    def record_timeout(self) -> None:
        self._inc("timed_out")

    def record_failure(self) -> None:
        self._inc("failed")

    def record_dispatcher_crash(self) -> None:
        self._inc("dispatcher_crashes")

    def record_dispatcher_restart(self) -> None:
        self._inc("dispatcher_restarts")

    def record_batch(self, *, bucket: int, rows: int,
                     device_s: float) -> None:
        with self._lock:
            self._c["batches"].inc()
            self._c["rows"].inc(rows)
            self._c["padded_rows"].inc(bucket - rows)
            self.device_time.record(device_s)

    def record_request(self, *, queue_wait_s: float, e2e_s: float) -> None:
        with self._lock:
            self._c["completed"].inc()
            self.queue_wait.record(queue_wait_s)
            self.e2e.record(e2e_s)

    def snapshot(self) -> dict:
        with self._lock:
            vals = {f: c.value for f, c in self._c.items()}
            executed = vals["rows"] + vals["padded_rows"]
            return {
                **vals,
                "pad_overhead_frac": (
                    round(vals["padded_rows"] / executed, 4) if executed
                    else 0.0),
                "mean_batch_rows": (
                    round(vals["rows"] / vals["batches"], 2)
                    if vals["batches"] else 0.0),
                "queue_wait": self.queue_wait.summary(),
                "device_time": self.device_time.summary(),
                "e2e_latency": self.e2e.summary(),
            }


# attribute-style counter reads (eng.telemetry.batches, ...), as the twin
for _f in _COUNTER_FIELDS:
    setattr(ServeTelemetry, _f,
            property(lambda self, _f=_f: self._c[_f].value))
del _f
