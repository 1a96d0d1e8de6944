"""Serving telemetry: per-request latency summaries and counters.

The twin of ``deepvision_tpu/serve/telemetry.py``'s ``ServeTelemetry``
and ``RouterTelemetry``: the same ``record_*`` and ``snapshot`` names,
the same snapshot keys and the same ``[router]`` summary line.
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

__all__ = ["LatencyStats", "RouterTelemetry", "ServeTelemetry"]


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


# router counters, in /stats JSON order. Sheds split by origin: an
# admission shed means the fleet is saturated (autoscale signal), a
# circuit shed that a model's replicas keep failing (fast-fail), a
# no-replica shed that every replica is draining, dead or starting.
_ROUTER_COUNTER_FIELDS = (
    "requests",           # admitted into the router
    "completed",          # futures resolved with a result
    "failed",             # resolved with a non-shed error
    "failovers",          # attempts retried on another replica after a
                          # replica death
    "hedges",             # duplicate attempts launched on a slow primary
    "hedge_wins",         # requests whose hedge resolved first
    "shed_admission",     # router admission (queue, SLO budget) rejects
    "shed_circuit",       # per-model circuit breaker open
    "shed_no_replica",    # no READY replica to route to
    "shed_replica",       # replica-side backpressure that survived the
                          # retry budget (capacity saturated, not absent)
    "replica_deaths",     # replicas observed dead (probe or attempt)
    "replica_restarts",   # replicas respawned by the supervisor
    "scale_ups",          # autoscaler added a replica
    "scale_downs",        # autoscaler drained a replica
    "sessions_migrated",  # streams re-pinned to a survivor
    "session_resets",     # stream answers that DECLARED lost state
)


class RouterTelemetry:
    """Counters, latency histograms and the autoscaler's signal gauges
    for one fleet router, registered under ``router_*`` names (default:
    the process registry, so that ``GET /metrics`` carries the fleet
    view). The gauges are what the autoscaler reads back by name: the
    fleet's queue-wait p95, shed rate and dispatcher crashes, gathered
    from the replicas' own ``/stats`` by the probe loop. Registration is
    latest-wins: a process's newest router owns the names."""

    def __init__(self):
        reg = default_registry()
        self.registry = reg
        self._lock = threading.Lock()
        self._c = {f: reg.register(f"router_{f}", Counter())
                   for f in _ROUTER_COUNTER_FIELDS}
        self.e2e = LatencyStats(       # admitted -> future resolved
            hist=reg.register("router_e2e_latency", Histogram()))
        self.attempt = LatencyStats(   # one replica round trip
            hist=reg.register("router_attempt_latency", Histogram()))
        self.replicas_ready = reg.gauge("router_replicas_ready")
        self.replicas_target = reg.gauge("router_replicas_target")
        self.queue_wait_p95_ms = reg.gauge("router_queue_wait_p95_ms")
        self.shed_rate_per_s = reg.gauge("router_shed_rate_per_s")
        self.dispatcher_crashes = reg.gauge("router_dispatcher_crashes")

    def inc(self, field: str, n: int = 1) -> None:
        self._c[field].inc(n)

    def record_attempt(self, seconds: float) -> None:
        self.attempt.record(seconds)

    def record_completed(self, e2e_s: float) -> None:
        with self._lock:
            self._c["completed"].inc()
            self.e2e.record(e2e_s)

    def snapshot(self) -> dict:
        vals = {f: c.value for f, c in self._c.items()}
        total_sheds = (vals["shed_admission"] + vals["shed_circuit"]
                       + vals["shed_no_replica"] + vals["shed_replica"])
        resolved = vals["completed"] + vals["failed"]
        return {
            **vals,
            "sheds_total": total_sheds,
            # the error budget lived: failed / resolved (sheds are the
            # designed overload answer, not budget burn)
            "failed_frac": (round(vals["failed"] / resolved, 4)
                            if resolved else 0.0),
            "e2e_latency": self.e2e.summary(),
            "attempt_latency": self.attempt.summary(),
        }

    def summary_line(self) -> str:
        """The grep-stable exit line of a fleet."""
        v = self.snapshot()
        return (f"[router] failovers={v['failovers']} "
                f"hedges={v['hedges']} deaths={v['replica_deaths']} "
                f"restarts={v['replica_restarts']} "
                f"sheds={v['sheds_total']} completed={v['completed']} "
                f"failed={v['failed']} "
                f"sessions_migrated={v['sessions_migrated']} "
                f"resets={v['session_resets']}")


for _f in _ROUTER_COUNTER_FIELDS:
    setattr(RouterTelemetry, _f,
            property(lambda self, _f=_f: self._c[_f].value))
del _f
