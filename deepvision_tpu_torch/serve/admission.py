"""Admission control: bounded queues, per-model limits, graceful shed.

The port's own copy of ``deepvision_tpu/serve/admission.py``: SLO
budgets (the fleet router's) and the multi-tenant quotas and SLO classes
(``serve/tenancy.py``'s isolation half; a tenant is a model name), with
every shed counted by the tenant it rejected.

When the engine cannot keep up it rejects new work at once with a retry
hint instead of queueing it into unbounded latency: an admitted request
has a bounded worst-case wait (queue depth x observed per-row service
time).
"""

from __future__ import annotations

import threading

__all__ = ["AdmissionController", "ShedError", "SLO_CLASSES"]

_EWMA_ALPHA = 0.2  # weight of the newest batch in the service-time EWMA

# the share of ``max_queue`` that a tenant of each class may hold while
# another tenant is queued too; a lone tenant always has the whole queue
SLO_CLASSES = {"gold": 1.0, "standard": 0.8, "batch": 0.5}


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
    - ``slo_budget_s``: optional per-model p95 deadline budgets (the
      router's SLO table). A request whose estimated wait (backlog depth
      x the service-time EWMA) already exceeds its model's budget is
      shed at the door: queueing it could only give a late answer.
    - ``tenant_quota``: hard caps on a tenant's queued requests, so that
      a noisy tenant sheds alone at its own cap.
    - ``slo_class``: tenant -> ``gold``, ``standard`` or ``batch``
      (:data:`SLO_CLASSES`). While another tenant is queued, a tenant
      may hold only its class's share of ``max_queue``; alone it has
      all of it.

    Every shed is counted for the tenant it rejected
    (``stats()["sheds_by_tenant"]``). ``observe_batch`` keeps an EWMA of
    per-row service time; the shed hint is ``depth x row_s``, how long
    the backlog needs to drain.
    """

    def __init__(self, max_queue: int = 256,
                 per_model_limit: int | None = None,
                 slo_budget_s: dict[str, float] | None = None,
                 tenant_quota: dict[str, int] | None = None,
                 slo_class: dict[str, str] | None = None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        for tenant, cls in (slo_class or {}).items():
            if cls not in SLO_CLASSES:
                raise ValueError(
                    f"unknown SLO class {cls!r} for tenant {tenant!r}; "
                    f"choose from {sorted(SLO_CLASSES)}")
        for tenant, quota in (tenant_quota or {}).items():
            if int(quota) < 1:
                raise ValueError(
                    f"tenant {tenant!r} quota must be >= 1, got {quota}")
        self.max_queue = max_queue
        self.per_model_limit = per_model_limit
        self.slo_budget_s = dict(slo_budget_s or {})
        self.tenant_quota = {t: int(q)
                             for t, q in (tenant_quota or {}).items()}
        self.slo_class = dict(slo_class or {})
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._sheds: dict[str, int] = {}
        self._total = 0
        self._row_s = 0.005  # EWMA per-row service time (seed guess)

    def _shed_locked(self, model: str, message: str) -> ShedError:
        self._sheds[model] = self._sheds.get(model, 0) + 1
        return ShedError(message, self._retry_after_locked())

    def admit(self, model: str) -> None:
        """Reserve a queue slot for one request, or raise ShedError, which
        is counted for ``model`` in ``sheds_by_tenant``."""
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
            quota = self.tenant_quota.get(model)
            if quota is not None and self._counts.get(model, 0) >= quota:
                raise self._shed_locked(model, (
                    f"tenant {model!r} at its admission quota "
                    f"({quota})"))
            cls = self.slo_class.get(model)
            if cls is not None:
                mine = self._counts.get(model, 0)
                contended = self._total > mine  # another tenant is queued
                share = int(SLO_CLASSES[cls] * self.max_queue)
                if contended and mine >= max(1, share):
                    raise self._shed_locked(model, (
                        f"tenant {model!r} ({cls}) at its contended "
                        f"share ({share}/{self.max_queue})"))
            budget = self.slo_budget_s.get(model)
            if budget is not None:
                est_wait = self._total * self._row_s
                if est_wait > budget:
                    raise self._shed_locked(model, (
                        f"estimated queue wait {est_wait:.3f}s exceeds "
                        f"model {model!r} p95 budget {budget}s"))
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
                "sheds_by_tenant": dict(self._sheds),
                **({"slo_budget_s": dict(self.slo_budget_s)}
                   if self.slo_budget_s else {}),
                **({"tenant_quota": dict(self.tenant_quota)}
                   if self.tenant_quota else {}),
                **({"slo_class": dict(self.slo_class)}
                   if self.slo_class else {}),
            }
