"""Serving telemetry: per-request latency summaries and counters.

A reduced twin of ``deepvision_tpu/serve/telemetry.py``
(``ServeTelemetry``): the same ``record_*`` and ``snapshot`` names and
the same snapshot keys, on plain counters and bounded latency
reservoirs, with no metrics registry behind them. Request wall time is
split into queue wait (admitted -> dispatched), device time (one
batch's H2D copy, forward and D2H copy) and end-to-end latency.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

__all__ = ["LatencyStats", "ServeTelemetry"]


class LatencyStats:
    """Bounded reservoir of the most recent ``maxlen`` samples with an
    exact lifetime count and total. ``record`` takes seconds;
    ``summary`` reports milliseconds."""

    def __init__(self, maxlen: int = 8192):
        self._lock = threading.Lock()
        self._samples: deque[float] = deque(maxlen=maxlen)
        self.count = 0
        self.total_s = 0.0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self.count += 1
            self.total_s += seconds

    def summary(self) -> dict:
        with self._lock:
            count, total = self.count, self.total_s
            samples = list(self._samples)
        if not samples:
            return {"count": count, "mean_ms": 0.0, "p50_ms": 0.0,
                    "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
        arr = np.asarray(samples, np.float64) * 1e3
        p50, p95, p99 = np.percentile(arr, [50, 95, 99])
        return {"count": count,
                "mean_ms": round(total / count * 1e3, 3),
                "p50_ms": round(float(p50), 3),
                "p95_ms": round(float(p95), 3),
                "p99_ms": round(float(p99), 3),
                "max_ms": round(float(arr.max()), 3)}


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
)


class ServeTelemetry:
    """Counters and per-stage latency summaries for one engine."""

    def __init__(self):
        self._lock = threading.Lock()
        self._c = dict.fromkeys(_COUNTER_FIELDS, 0)
        self.queue_wait = LatencyStats()
        self.device_time = LatencyStats()
        self.e2e = LatencyStats()

    def _inc(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._c[field] += n

    def record_submit(self) -> None:
        self._inc("submitted")

    def record_shed(self) -> None:
        self._inc("shed")

    def record_timeout(self) -> None:
        self._inc("timed_out")

    def record_failure(self) -> None:
        self._inc("failed")

    def record_batch(self, *, bucket: int, rows: int,
                     device_s: float) -> None:
        with self._lock:
            self._c["batches"] += 1
            self._c["rows"] += rows
            self._c["padded_rows"] += bucket - rows
            self.device_time.record(device_s)

    def record_request(self, *, queue_wait_s: float, e2e_s: float) -> None:
        with self._lock:
            self._c["completed"] += 1
            self.queue_wait.record(queue_wait_s)
            self.e2e.record(e2e_s)

    def snapshot(self) -> dict:
        with self._lock:
            vals = dict(self._c)
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
            property(lambda self, _f=_f: self._c[_f]))
del _f
