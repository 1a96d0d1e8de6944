"""Admission control: bounded queues, per-model limits, graceful shed.

The port's own copy of ``deepvision_tpu/serve/admission.py`` without the
SLO budgets, multi-tenant quotas and SLO classes, which come with the
router and tenancy tiers.

When the engine cannot keep up it rejects new work at once with a retry
hint instead of queueing it into unbounded latency: an admitted request
has a bounded worst-case wait (queue depth x observed per-row service
time).
"""

from __future__ import annotations

import threading

__all__ = ["AdmissionController", "ShedError"]

_EWMA_ALPHA = 0.2  # weight of the newest batch in the service-time EWMA


class ShedError(RuntimeError):
    """Request rejected at admission (queue saturated). ``retry_after_s``
    estimates when capacity frees up."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Queue-depth backpressure and per-model concurrency limits.

    - ``max_queue``: requests admitted but not yet resolved, across all
      models; the engine's worst-case memory and latency bound.
    - ``per_model_limit``: optional cap per model, so one hot model
      cannot take the whole queue.

    ``observe_batch`` keeps an EWMA of per-row service time; the shed
    hint is ``depth x row_s``, how long the backlog needs to drain.
    """

    def __init__(self, max_queue: int = 256,
                 per_model_limit: int | None = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.per_model_limit = per_model_limit
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._sheds: dict[str, int] = {}
        self._total = 0
        self._row_s = 0.005  # EWMA per-row service time (seed guess)

    def _shed_locked(self, model: str, message: str) -> ShedError:
        self._sheds[model] = self._sheds.get(model, 0) + 1
        return ShedError(message, self._retry_after_locked())

    def admit(self, model: str) -> None:
        """Reserve a queue slot for one request, or raise ShedError."""
        with self._lock:
            if self._total >= self.max_queue:
                raise self._shed_locked(model, (
                    f"queue full ({self._total}/{self.max_queue} "
                    "pending)"))
            if self.per_model_limit is not None \
                    and self._counts.get(model, 0) >= self.per_model_limit:
                raise self._shed_locked(model, (
                    f"model {model!r} at its concurrency limit "
                    f"({self.per_model_limit})"))
            self._counts[model] = self._counts.get(model, 0) + 1
            self._total += 1

    def release(self, model: str) -> None:
        """Free one slot (request resolved: completed, timed out, failed
        or dropped at close)."""
        with self._lock:
            self._counts[model] = max(0, self._counts.get(model, 0) - 1)
            self._total = max(0, self._total - 1)

    def observe_batch(self, device_s: float, rows: int) -> None:
        if rows <= 0:
            return
        with self._lock:
            self._row_s += _EWMA_ALPHA * (device_s / rows - self._row_s)

    def _retry_after_locked(self) -> float:
        return round(max(0.01, self._total * self._row_s), 3)

    def stats(self) -> dict:
        with self._lock:
            return {
                "depth": self._total,
                "max_queue": self.max_queue,
                "per_model_limit": self.per_model_limit,
                "per_model_depth": dict(self._counts),
                "ewma_row_ms": round(self._row_s * 1e3, 3),
                "sheds_by_model": dict(self._sheds),
            }
