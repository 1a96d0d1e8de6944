"""SLO-aware fleet router: health-gated load balancing over N replicas.

The port of ``deepvision_tpu/serve/router.py``. A :class:`FleetRouter`
supervises N replicas (``serve/replica.py``: in-process engines for
tests, the port's serving CLI as child processes in production) and
turns them into one serving surface:

- **health-gated balancing**: a request goes to the least-loaded READY
  replica; a replica whose ``/healthz`` degrades (the engine's
  supervisor recovering a crashed dispatcher) is DRAINED as soon as the
  probe loop sees it, and undrained when it answers ok again;
- **failover with exactly-once results**: an attempt that dies with its
  replica is retried on another one (bounded), and a slow attempt is
  *hedged*: a duplicate goes out after ``hedge_after_s`` and the first
  answer wins. Every request resolves its future exactly once;
- **circuit breaker**: a per-model rolling failure window; when a
  model's replicas keep failing the breaker opens and the router sheds
  at once (429 with ``Retry-After``), and a half-open probe closes it
  once the model answers again;
- **SLO-aware admission**: per-model p95 deadline budgets feed the
  admission EWMA (``admission.AdmissionController``): a request that
  would wait past its budget is shed at the door, and the budget is the
  request's deadline ceiling;
- **supervision and autoscaling**: a dead replica is killed for sure
  (reaped) and respawned through the factory, waves gated by a capped
  backoff; an :class:`Autoscaler` reads the signals the probe loop
  publishes into the registry (queue-wait p95, shed rate, dispatcher
  crashes) and adds or drains replicas inside ``[min_replicas,
  max_replicas]`` with hysteresis.

The router never touches a device: a fleet's router process creates no
CUDA context (its replicas do).

Stateful streams (``serve/sessions.py``): a frame submitted with
``session`` and ``seq`` joins its stream's FIFO (one drain a stream, the
streams in parallel) and goes to the stream's pinned replica, a crc32
hash of the session id over the READY slots' ids (stable across router
restarts). When the pin is no longer routable the stream is re-pinned to
a survivor (``sessions_migrated``), and the router replays its bounded
window of the stream's last frames (``session_replay_window``), so that
the survivor rebuilds the state past its newest snapshot; a reset that a
replayed frame declared is passed on to the frame's answer
(``session_resets`` counts the declared resets). A stream frame is never
hedged: a duplicate in flight could apply a state update twice.

The fault sites ``replica_kill`` and ``replica_slow``
(``resilience/faults.py``) are consulted on each routed attempt (a
replayed frame's too) with monotonic occurrence counters, so that a drill
replays exactly.

``tenant_quota`` and ``slo_class`` reach the router's own admission gate
(``admission.AdmissionController``), so that a noisy tenant sheds at the
fleet's front door before it crowds any replica's queue.

Observability: each attempt is a ``router_attempt`` span under the
request's trace id (minted here unless the caller passed one), which
the replica receives in ``X-DVTPU-Trace``; every 2 s the probe tick
appends a ``probe`` note (its counter deltas and ``replicas_ready``) to
the process's flight recorder, when one is installed. The recorder
reads the router's registry as it stands and never the card.
"""

from __future__ import annotations

import sys
import threading
import time
import zlib
from collections import deque
from concurrent.futures import (
    FIRST_COMPLETED,
    Future,
    InvalidStateError,
    ThreadPoolExecutor,
    wait as futures_wait,
)
from dataclasses import dataclass
from typing import Callable

from deepvision_tpu_torch.obs.distributed import (
    get_flight_recorder,
    new_trace_id,
    render_federated,
)
from deepvision_tpu_torch.obs.trace import span
from deepvision_tpu_torch.serve.admission import AdmissionController, ShedError
from deepvision_tpu_torch.serve.replica import ReplicaDeadError
from deepvision_tpu_torch.serve.telemetry import RouterTelemetry

__all__ = [
    "AutoscaleConfig",
    "Autoscaler",
    "CircuitBreaker",
    "CircuitConfig",
    "FleetRouter",
    "RouterShedError",
]

# the respawn backoff: the first wait after a death, doubling to the cap
RESTART_BACKOFF_S = 0.2
RESTART_BACKOFF_MAX_S = 10.0
MAX_WORKERS = 32  # coordinators in flight (twice as many attempt threads)

# replica slot states
STARTING = "starting"
READY = "ready"
DRAINING = "draining"   # health-gated: the probe saw a non-ok status
RETIRING = "retiring"   # autoscale-down: drain, then stop
DEAD = "dead"
STOPPED = "stopped"


class RouterShedError(ShedError):
    """A shed by the router (circuit open, no READY replica), with the
    admission :class:`ShedError`'s ``retry_after_s``, so that both give
    the same 429 and ``Retry-After``."""


# ------------------------------------------------------ circuit breaker


@dataclass
class CircuitConfig:
    """A per-model rolling error budget. The breaker opens when, over the
    last ``window`` attempts (at least ``min_volume`` of them), the
    failure fraction exceeds ``failure_frac``; it stays open ``open_s``,
    then HALF_OPEN admits one probe request: success closes it, failure
    opens it again."""

    window: int = 32
    min_volume: int = 8
    failure_frac: float = 0.5
    open_s: float = 2.0


class CircuitBreaker:
    """closed -> open -> half-open -> closed, for one model."""

    def __init__(self, cfg: CircuitConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or CircuitConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: list[bool] = []  # rolling window, True = failure
        self.state = "closed"
        self._open_until = 0.0
        self._probe_inflight = False
        self._probe_started = 0.0

    def allow(self) -> bool:
        """May a request go now? HALF_OPEN admits one probe at a time; a
        probe whose outcome never lands (shed before any attempt) gives
        its slot up after ``open_s``."""
        with self._lock:
            if self.state == "closed":
                return True
            now = self._clock()
            if self.state == "open":
                if now < self._open_until:
                    return False
                self.state = "half_open"
                self._probe_inflight = False
            if self._probe_inflight \
                    and now - self._probe_started < self.cfg.open_s:
                return False
            self._probe_inflight = True
            self._probe_started = now
            return True

    def retry_after_s(self) -> float:
        with self._lock:
            return round(max(0.05, self._open_until - self._clock()), 3)

    def record_success(self) -> None:
        with self._lock:
            if self.state == "half_open":
                self.state = "closed"
                self._outcomes.clear()
                self._probe_inflight = False
                return
            self._push(False)

    def record_failure(self) -> None:
        with self._lock:
            if self.state == "half_open":
                self._trip()
                return
            self._push(True)
            n = len(self._outcomes)
            if n >= self.cfg.min_volume and (
                    sum(self._outcomes) / n) > self.cfg.failure_frac:
                self._trip()

    def _push(self, failed: bool) -> None:
        self._outcomes.append(failed)
        if len(self._outcomes) > self.cfg.window:
            del self._outcomes[0]

    def _trip(self) -> None:
        self.state = "open"
        self._open_until = self._clock() + self.cfg.open_s
        self._outcomes.clear()
        self._probe_inflight = False

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state,
                    "window_failures": sum(self._outcomes),
                    "window_size": len(self._outcomes)}


# ----------------------------------------------------------- autoscaler


@dataclass
class AutoscaleConfig:
    """The autoscaler's hysteresis. Pressure (queue-wait p95 over
    ``up_queue_p95_ms``, shed rate over ``up_shed_rate_per_s``, or a new
    dispatcher crash) must last ``sustain_up`` ticks to add a replica,
    calm ``sustain_down`` ticks to drain one, and ``cooldown_s`` parts
    two actions. ``down_queue_p95_ms`` sits well below
    ``up_queue_p95_ms`` so that the two never chatter."""

    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 1.0
    up_queue_p95_ms: float = 200.0
    up_shed_rate_per_s: float = 0.5
    down_queue_p95_ms: float = 20.0
    sustain_up: int = 2
    sustain_down: int = 5
    cooldown_s: float = 5.0


class Autoscaler:
    """The decision core (clock injectable): ``tick()`` maps one sample
    of the signals to a new replica target."""

    def __init__(self, cfg: AutoscaleConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg or AutoscaleConfig()
        self._clock = clock
        self._pressure_ticks = 0
        self._calm_ticks = 0
        self._last_action_t = -float("inf")
        self._last_crashes = 0.0

    def tick(self, *, queue_p95_ms: float, shed_rate_per_s: float,
             dispatcher_crashes: float, target: int,
             now: float | None = None) -> int:
        cfg = self.cfg
        now = self._clock() if now is None else now
        crashed = dispatcher_crashes > self._last_crashes
        self._last_crashes = max(self._last_crashes, dispatcher_crashes)
        pressure = (queue_p95_ms > cfg.up_queue_p95_ms
                    or shed_rate_per_s > cfg.up_shed_rate_per_s
                    or crashed)
        calm = (not pressure and shed_rate_per_s == 0.0
                and queue_p95_ms < cfg.down_queue_p95_ms)
        self._pressure_ticks = self._pressure_ticks + 1 if pressure else 0
        self._calm_ticks = self._calm_ticks + 1 if calm else 0
        in_cooldown = now - self._last_action_t < cfg.cooldown_s
        if (pressure and self._pressure_ticks >= cfg.sustain_up
                and target < cfg.max_replicas and not in_cooldown):
            self._last_action_t = now
            self._pressure_ticks = 0
            return target + 1
        if (calm and self._calm_ticks >= cfg.sustain_down
                and target > cfg.min_replicas and not in_cooldown):
            self._last_action_t = now
            self._calm_ticks = 0
            return target - 1
        return target


# ---------------------------------------------------------- fleet router


class _Slot:
    """One supervised replica position in the fleet."""

    __slots__ = ("sid", "replica", "state", "inflight")

    def __init__(self, sid: str, replica, state: str):
        self.sid = sid
        self.replica = replica
        self.state = state
        self.inflight = 0


class _Request:
    """One routed request: a resolve-once future and its context."""

    __slots__ = ("model", "key", "x", "future", "t_submit", "deadline",
                 "trace", "session", "seq", "_resolved", "_lock")

    def __init__(self, model: str | None, x, deadline: float,
                 key: str | None = None, trace: str | None = None,
                 session: str | None = None, seq: int | None = None):
        self.model = model
        self.key = key if key is not None else (model or "_default")
        self.x = x
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.deadline = deadline
        # minted here, at the fleet's front door, unless an upstream
        # surface gave one; every attempt carries it
        self.trace = trace if trace is not None else new_trace_id()
        # a stream frame's session and seq: pinned, strictly in order
        self.session = session
        self.seq = seq
        self._resolved = False
        self._lock = threading.Lock()

    def resolve(self, result=None, error: BaseException | None = None
                ) -> bool:
        """Exactly once: True for the attempt that won, False for every
        late hedge or duplicate."""
        with self._lock:
            if self._resolved:
                return False
            self._resolved = True
        try:
            if error is not None:
                self.future.set_exception(error)
            else:
                self.future.set_result(result)
        except InvalidStateError:  # the client cancelled
            pass
        return True


class _SessionRoute:
    """The router's state of one stream: the pinned slot id, the FIFO of
    its frames, and the window of its last frames that can be replayed to
    a new pin instead of declaring a reset."""

    __slots__ = ("sid", "pin", "queue", "active", "window", "last_used")

    def __init__(self, sid: str, window: int):
        self.sid = sid
        self.pin: str | None = None      # the slot id the stream sticks to
        self.queue: list = []            # [(req, breaker, key)] FIFO
        self.active = False              # a drain task is running
        self.window: deque = deque(maxlen=window)  # [(seq, x)]
        self.last_used = time.monotonic()


class FleetRouter:
    """Route requests across a supervised fleet of replicas.

    ``replica_factory(sid)`` builds, without starting, a fresh replica
    for slot id ``sid``; the router starts it, probes it, and respawns
    through the same factory after a death. ``slo`` maps a model name to
    its p95 deadline budget in seconds: both the model's deadline ceiling
    and its admission budget (``AdmissionController.slo_budget_s``).
    ``session_replay_window``: the frames a stream keeps for a replay
    after its pin dies. ``tenant_quota`` and ``slo_class``: the tenant
    maps of the router's admission gate (``admission``).
    """

    def __init__(
        self,
        replica_factory: Callable[[str], object],
        *,
        replicas: int = 2,
        models: list[str] | None = None,
        slo: dict[str, float] | None = None,
        default_deadline_s: float = 30.0,
        max_queue: int = 256,
        per_model_limit: int | None = None,
        probe_interval_s: float = 0.25,
        max_retries: int = 2,
        hedge_after_s: float | None = None,
        autoscale: AutoscaleConfig | None = None,
        fault_injector=None,
        session_replay_window: int = 32,
        tenant_quota: dict[str, int] | None = None,
        slo_class: dict[str, str] | None = None,
    ):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self._factory = replica_factory
        self._models = list(models or [])
        self._slo = dict(slo or {})
        self._default_deadline_s = default_deadline_s
        self._probe_interval_s = probe_interval_s
        self._max_retries = max_retries
        self._hedge_after_s = hedge_after_s
        self._autoscale_cfg = autoscale
        self.telemetry = RouterTelemetry()
        self._admission = AdmissionController(
            max_queue=max_queue, per_model_limit=per_model_limit,
            slo_budget_s=self._slo or None,
            tenant_quota=tenant_quota, slo_class=slo_class)
        self._injector = fault_injector
        self._lock = threading.Lock()
        self._session_replay_window = max(0, int(session_replay_window))
        self._sessions: dict[str, _SessionRoute] = {}
        self._slots: list[_Slot] = []
        self._gen = 0
        self._breakers: dict[str, CircuitBreaker] = {}
        self._stop = threading.Event()
        self._respawners: list[threading.Thread] = []
        self._backoff = RESTART_BACKOFF_S
        self._target = replicas
        if autoscale is not None:
            self._target = max(autoscale.min_replicas,
                               min(replicas, autoscale.max_replicas))
            self._autoscaler = Autoscaler(autoscale)
        else:
            self._autoscaler = None
        self._last_shed_totals = 0.0
        self._last_signal_t = time.monotonic()
        self._autoscale_due = time.monotonic()
        self._flight_note_due = time.monotonic()
        self._respawn_not_before = 0.0
        # TWO pools: coordinators (one a request in flight) and replica
        # attempts (at most 2 a running coordinator, so 2x workers never
        # starve); one shared pool would deadlock as soon as every worker
        # held a coordinator waiting on a queued attempt
        self._pool = ThreadPoolExecutor(
            max_workers=MAX_WORKERS, thread_name_prefix="router-dispatch")
        self._attempt_pool = ThreadPoolExecutor(
            max_workers=2 * MAX_WORKERS,
            thread_name_prefix="router-attempt")
        self.telemetry.replicas_target.set(self._target)
        self.start()

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        """Start the first fleet (the replicas boot in parallel) and the
        probe thread. Raises if no replica comes up."""
        with self._lock:
            target = self._target
        threads = [self._spawn_slot_async() for _ in range(target)]
        for t in threads:
            t.join()
        if not self._ready_slots():
            self.close()
            raise RuntimeError("no replica became ready at startup")
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True)
        self._probe_thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Graceful: stop probing, let the dispatches in flight finish
        (the replicas stay up until the pools drain), then stop the
        replicas. Idempotent."""
        if self._stop.is_set():
            return
        self._stop.set()
        t = getattr(self, "_probe_thread", None)
        if t is not None:
            t.join(timeout)
        self._pool.shutdown(wait=True)
        self._attempt_pool.shutdown(wait=True)
        with self._lock:
            respawners = list(self._respawners)
        for th in respawners:
            th.join(timeout)
        with self._lock:
            slots = list(self._slots)
        stoppers = []
        for s in slots:
            th = threading.Thread(target=self._stop_replica, args=(s,),
                                  name=f"router-stop-{s.sid}")
            th.start()
            stoppers.append(th)
        for th in stoppers:
            th.join(timeout)

    @staticmethod
    def _stop_replica(slot: _Slot) -> None:
        try:
            slot.replica.stop()
        except Exception:
            pass
        slot.state = STOPPED

    @staticmethod
    def _kill_replica(slot: _Slot) -> None:
        try:
            slot.replica.kill()
        except Exception:
            pass

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client surface --------------------------------------------------
    @property
    def buckets(self) -> tuple[int, ...]:
        """The stdin-JSONL surface's in-flight window hint (the fleet's
        analog of the engine's bucket ladder)."""
        return (64,)

    def submit(self, x, model: str | None = None, *,
               timeout_s: float | None = None,
               trace: str | None = None,
               session: str | None = None,
               seq: int | None = None) -> Future:
        """Route one example; returns a Future resolving to the task's
        result dict. A shed (circuit open, admission) raises at once, the
        engine's :class:`ShedError` contract. ``trace`` carries an
        upstream trace id; without one the router mints one, and every
        attempt sends it over the ``X-DVTPU-Trace`` hop.

        ``session``/``seq`` mark a stream frame: it goes to the stream's
        pinned replica after the stream's earlier frames, and survives
        the pin's death by a re-pin, the survivor's restore from the
        snapshot and a replay of the router's window."""
        if self._stop.is_set():
            raise RuntimeError("router is closed")
        # an anonymous request to a one-model fleet counts as that model
        # for SLO, admission and breaker (the replica still gets
        # model=None and applies its own default)
        key = model
        if key is None:
            key = self._models[0] if len(self._models) == 1 else "_default"
        breaker = self._breaker(key)
        if not breaker.allow():
            self.telemetry.inc("shed_circuit")
            raise RouterShedError(
                f"circuit open for model {key!r} (replicas failing); "
                "shedding fast", breaker.retry_after_s())
        try:
            self._admission.admit(key)
        except ShedError:
            self.telemetry.inc("shed_admission")
            raise
        self.telemetry.inc("requests")
        # the model's SLO budget is a deadline ceiling, also under the
        # CLI's blanket timeout; a tighter client timeout still wins
        bounds = [b for b in (timeout_s, self._slo.get(key))
                  if b is not None]
        budget = min(bounds) if bounds else self._default_deadline_s
        req = _Request(model, x, deadline=time.monotonic() + budget,
                       key=key, trace=trace, session=session,
                       seq=seq if seq is None else int(seq))
        if session is not None:
            self._enqueue_session(req, breaker, key)
        else:
            self._pool.submit(self._dispatch, req, breaker, key)
        return req.future

    # -- request lifecycle -----------------------------------------------
    def _breaker(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker()
            return b

    def _finish(self, req: _Request, key: str, *, result=None,
                error: BaseException | None = None) -> bool:
        """Resolve and account exactly once; whether THIS call won the
        race (late hedges and duplicates get False)."""
        if not req.resolve(result, error):
            return False
        self._admission.release(key)
        if error is None:
            e2e = time.perf_counter() - req.t_submit
            self.telemetry.record_completed(e2e)
        elif isinstance(error, RouterShedError):
            self.telemetry.inc("shed_no_replica")
        elif isinstance(error, ShedError):
            # replica-side backpressure that outlived the retry budget:
            # capacity exists but is saturated
            self.telemetry.inc("shed_replica")
        else:
            self.telemetry.inc("failed")
        return True

    def _pick(self, tried: set[str]) -> _Slot | None:
        """The least-inflight READY slot, preferring one not yet tried
        for this request; a tried one only when nothing else is READY."""
        with self._lock:
            ready = [s for s in self._slots if s.state == READY]
            fresh = [s for s in ready if s.sid not in tried]
            pool = fresh or ready
            if not pool:
                return None
            slot = min(pool, key=lambda s: (s.inflight, s.sid))
            slot.inflight += 1
            return slot

    def _dispatch(self, req: _Request, breaker: CircuitBreaker,
                  key: str) -> None:
        """Coordinate one request's attempts: launch, hedge a slow
        primary, fail over on errors, until an attempt wins, the retry
        budget is spent or the deadline passes."""
        outstanding: dict[Future, _Slot] = {}
        tried: set[str] = set()
        retries_left = self._max_retries
        hedges_left = 1 if self._hedge_after_s is not None else 0
        last_exc: BaseException | None = None
        failed_over = False
        try:
            while True:
                remaining = req.deadline - time.monotonic()
                if remaining <= 0:
                    self._finish(req, key, error=last_exc or TimeoutError(
                        "deadline expired before any replica answered"))
                    return
                if not outstanding:
                    slot = self._pick(tried)
                    if slot is None:
                        self._finish(req, key, error=(
                            last_exc if isinstance(last_exc, ShedError)
                            else RouterShedError(
                                "no replica available (all draining, "
                                "dead, or starting)",
                                round(2 * self._probe_interval_s, 3))))
                        return
                    if failed_over:
                        self.telemetry.inc("failovers")
                        failed_over = False
                    tried.add(slot.sid)
                    outstanding[self._attempt_pool.submit(
                        self._attempt, req, slot, breaker)] = slot
                hedge_ok = (hedges_left > 0 and len(outstanding) == 1
                            and len(tried) < self._slot_count())
                timeout = (min(remaining, self._hedge_after_s)
                           if hedge_ok else remaining)
                done, _pending = futures_wait(
                    set(outstanding), timeout=timeout,
                    return_when=FIRST_COMPLETED)
                if not done:
                    if hedge_ok:
                        slot = self._pick(tried)
                        if slot is not None:
                            hedges_left -= 1
                            self.telemetry.inc("hedges")
                            tried.add(slot.sid)
                            outstanding[self._attempt_pool.submit(
                                self._attempt, req, slot, breaker,
                                hedge=True)] = slot
                        else:
                            hedges_left = 0
                    continue
                for f in done:
                    outstanding.pop(f)
                    ok, payload = f.result()
                    if ok:
                        self._finish(req, key, result=payload)
                        return
                    last_exc = payload
                    if isinstance(payload, ReplicaDeadError):
                        failed_over = True  # counted when a retry launches
                if outstanding:
                    continue  # a hedge is still racing
                if isinstance(last_exc, ValueError) \
                        or retries_left <= 0:
                    # a client error never retries; a spent budget fails
                    self._finish(req, key, error=last_exc)
                    return
                retries_left -= 1
        except Exception as e:  # a coordinator bug: never strand a client
            self._finish(req, key, error=e)

    # -- stateful streams (serve/sessions.py) ----------------------------
    def _enqueue_session(self, req: _Request, breaker, key: str) -> None:
        """Append a frame to its stream's FIFO, with one drain task a
        stream: a stream's frames go in submission order, the streams in
        parallel."""
        with self._lock:
            route = self._sessions.get(req.session)
            if route is None:
                route = self._sessions[req.session] = _SessionRoute(
                    req.session, self._session_replay_window)
            route.last_used = time.monotonic()
            route.queue.append((req, breaker, key))
            if not route.active:
                route.active = True
                self._pool.submit(self._drain_session, route)

    def _drain_session(self, route: _SessionRoute) -> None:
        while True:
            with self._lock:
                if not route.queue:
                    route.active = False
                    return
                req, breaker, key = route.queue.pop(0)
            if self._stop.is_set():
                self._finish(req, key,
                             error=RuntimeError("router is closed"))
                continue
            try:
                self._dispatch_stateful(route, req, breaker, key)
            except Exception as e:  # a drain bug: never strand a client
                self._finish(req, key, error=e)

    def _pin_slot(self, route: _SessionRoute
                  ) -> tuple[_Slot | None, bool]:
        """The stream's pinned slot (its in-flight count raised), a fresh
        pin by hash when it has none, and whether the stream MIGRATED: its
        old pin is no longer routable."""
        with self._lock:
            ready = sorted((s for s in self._slots if s.state == READY),
                           key=lambda s: s.sid)
            if route.pin is not None:
                for s in ready:
                    if s.sid == route.pin:
                        s.inflight += 1
                        return s, False
            if not ready:
                return None, False
            # a stable hash: the same session lands on the same slot id
            # across router restarts (crc32, not PYTHONHASHSEED)
            slot = ready[zlib.crc32(route.sid.encode()) % len(ready)]
            migrated = route.pin is not None
            route.pin = slot.sid
            slot.inflight += 1
            return slot, migrated

    def _replay_window(self, route: _SessionRoute, slot: _Slot,
                       req: _Request, breaker) -> tuple[bool, bool]:
        """Send the window's frames before ``req`` to a new pin, so that
        it rebuilds the state past its newest snapshot (it answers the
        seqs that the snapshot covers as duplicates). -> (ok, whether a
        replayed frame declared a reset), so that the client's frame never
        hides a reset that happened during the recovery."""
        with self._lock:
            frames = [(s, x) for s, x in route.window if s < req.seq]
        reset_seen = False
        for s, x in frames:
            if req.deadline - time.monotonic() <= 0:
                return False, reset_seen
            replay = _Request(req.model, x, deadline=req.deadline,
                              key=req.key, trace=req.trace,
                              session=req.session, seq=s)
            with self._lock:
                # paired with the decrement in _attempt's finally
                slot.inflight += 1
            ok, payload = self._attempt(replay, slot, breaker)
            if not ok:
                return False, reset_seen
            if isinstance(payload, dict) and payload.get("state_reset"):
                reset_seen = True
        return True, reset_seen

    def _dispatch_stateful(self, route: _SessionRoute, req: _Request,
                           breaker, key: str) -> None:
        """Coordinate one stream frame: an attempt on the pin and, when
        the pin dies, a re-pin to a survivor and a replay of the window.
        NEVER hedged: retries are safe by the replica's seq dedupe."""
        retries_left = self._max_retries
        last_exc: BaseException | None = None
        reset_seen = False
        while True:
            remaining = req.deadline - time.monotonic()
            if remaining <= 0:
                self._finish(req, key, error=last_exc or TimeoutError(
                    "deadline expired before any replica answered"))
                return
            slot, migrated = self._pin_slot(route)
            if slot is None:
                self._finish(req, key, error=(
                    last_exc if isinstance(last_exc, ShedError)
                    else RouterShedError(
                        "no replica available for pinned session",
                        round(2 * self._probe_interval_s, 3))))
                return
            if migrated:
                self.telemetry.inc("sessions_migrated")
                with self._lock:
                    n_replay = len(route.window)
                print(f"[router] session {route.sid} re-pinned to "
                      f"{slot.sid} (replaying {n_replay} frame(s))",
                      file=sys.stderr, flush=True)
                ok, rs = self._replay_window(route, slot, req, breaker)
                reset_seen = reset_seen or rs
                if not ok:
                    # the replay's target failed: replayed frames are
                    # idempotent, so re-pin again
                    with self._lock:
                        slot.inflight = max(0, slot.inflight - 1)
                    if retries_left <= 0:
                        self._finish(req, key, error=last_exc
                                     or ReplicaDeadError(
                                         "replay target died"))
                        return
                    retries_left -= 1
                    continue
            ok, payload = self._attempt(req, slot, breaker)
            if ok:
                if isinstance(payload, dict):
                    if reset_seen:
                        payload["state_reset"] = True
                    if payload.get("state_reset"):
                        # a DECLARED reset, never a silent one
                        self.telemetry.inc("session_resets")
                with self._lock:
                    route.window.append((req.seq, req.x))
                    route.last_used = time.monotonic()
                self._finish(req, key, result=payload)
                return
            last_exc = payload
            if isinstance(payload, ReplicaDeadError):
                # the pin died: the next pass re-pins and replays
                self.telemetry.inc("failovers")
                continue
            if isinstance(payload, ValueError) or retries_left <= 0:
                self._finish(req, key, error=payload)
                return
            retries_left -= 1

    def _slot_count(self) -> int:
        with self._lock:
            return len([s for s in self._slots
                        if s.state in (READY, DRAINING)])

    def _attempt(self, req: _Request, slot: _Slot,
                 breaker: CircuitBreaker, hedge: bool = False):
        """One replica round trip -> (ok, result or exception). The
        failure accounting (breaker, dead replica) happens here, so that
        a racing hedge's outcome is never lost."""
        t0 = time.perf_counter()
        try:
            if req.future.done():
                return False, RuntimeError("request already resolved")
            if self._injector is not None:
                delay = self._injector.check_replica_slow()
                if delay:
                    self._stop.wait(delay)
                if self._injector.check_replica_kill():
                    slot.replica.kill()
            remaining = req.deadline - time.monotonic()
            if remaining <= 0:
                return False, TimeoutError("deadline expired")
            # the router's half of the request's timeline, under the
            # trace id the replica receives (a no-op while the tracer is
            # off)
            # a stream frame's session and seq ride to the replica (only
            # when set, so a replica double without them keeps working)
            kw = ({"session": req.session, "seq": req.seq}
                  if req.session is not None else {})
            with span("router_attempt", cat="router",
                      args={"trace": req.trace, "replica": slot.sid,
                            "model": req.key,
                            **({"session": req.session}
                               if req.session is not None else {}),
                            **({"hedge": True} if hedge else {})}):
                result = slot.replica.request(
                    req.model, req.x, timeout_s=remaining,
                    trace=req.trace, **kw)
        except ReplicaDeadError as e:
            breaker.record_failure()
            self._on_replica_dead(slot, str(e))
            return False, e
        except ShedError as e:
            return False, e  # overload is not a breaker failure
        except ValueError as e:
            return False, e  # a client error: no breaker, no retry
        except Exception as e:  # TimeoutError, a failed request
            breaker.record_failure()
            return False, e
        else:
            breaker.record_success()
            dt = time.perf_counter() - t0
            self.telemetry.record_attempt(dt)
            # the admission EWMA wants the per-row SERVICE time (its shed
            # estimate is depth x row_s): the round trip, not the e2e,
            # which already holds the queue wait
            self._admission.observe_batch(dt, 1)
            if hedge and self._finish(req, req.key, result=result):
                # the duplicate beat the primary: first answer wins
                self.telemetry.inc("hedge_wins")
            return True, result
        finally:
            with self._lock:
                slot.inflight = max(0, slot.inflight - 1)

    # -- supervision -----------------------------------------------------
    def _on_replica_dead(self, slot: _Slot, why: str) -> None:
        with self._lock:
            if slot.state in (DEAD, STOPPED):
                return
            slot.state = DEAD
        self.telemetry.inc("replica_deaths")
        print(f"[router] replica {slot.sid} dead: {why}", file=sys.stderr,
              flush=True)

    def _spawn_slot_async(self) -> threading.Thread:
        """Start a fresh replica on a thread of its own (a process
        replica takes seconds to boot: routing never waits on one)."""
        with self._lock:
            self._gen += 1
            sid = f"r{self._gen}"
            slot = _Slot(sid, None, STARTING)
            self._slots.append(slot)

        def boot():
            try:
                replica = self._factory(sid)
                slot.replica = replica
                replica.start()
            except Exception as e:
                print(f"[router] replica {sid} failed to start: {e}",
                      file=sys.stderr, flush=True)
                slot.state = DEAD
                return
            # a boot that finishes during close() is still in _slots, so
            # close()'s stop sweep shuts it down right after
            slot.state = READY

        t = threading.Thread(target=boot, name=f"router-boot-{sid}")
        t.start()
        with self._lock:
            self._respawners.append(t)
        return t

    def _ready_slots(self) -> list[_Slot]:
        with self._lock:
            return [s for s in self._slots if s.state == READY]

    def _probe_loop(self) -> None:
        """Health-gate, supervise and autoscale every probe interval,
        waiting on the stop event so that close() never waits a tick."""
        while not self._stop.wait(self._probe_interval_s):
            self._probe_once()
            self._reap_and_respawn()
            self._publish_signals_and_autoscale()
            self._gc_respawners()

    def _probe_once(self) -> None:
        with self._lock:
            slots = [s for s in self._slots
                     if s.state in (READY, DRAINING, RETIRING)]
        for slot in slots:
            try:
                health = slot.replica.probe()
            except ReplicaDeadError as e:
                self._on_replica_dead(slot, str(e))
                continue
            except Exception as e:
                self._on_replica_dead(slot, f"probe error: {e}")
                continue
            ok = health.get("status") == "ok"
            if slot.state == RETIRING:
                if slot.inflight == 0:
                    self._retire(slot)
            elif ok and slot.state == DRAINING:
                slot.state = READY
                print(f"[router] replica {slot.sid} healthy again; "
                      "undrained", file=sys.stderr, flush=True)
            elif not ok and slot.state == READY:
                slot.state = DRAINING
                print(f"[router] replica {slot.sid} degraded "
                      f"({health.get('status')}); draining",
                      file=sys.stderr, flush=True)

    def _retire(self, slot: _Slot) -> None:
        th = threading.Thread(target=self._stop_replica, args=(slot,),
                              name=f"router-retire-{slot.sid}")
        th.start()
        with self._lock:
            self._respawners.append(th)
            if slot in self._slots:
                self._slots.remove(slot)
        self.telemetry.inc("scale_downs")
        print(f"[router] replica {slot.sid} drained and retired "
              f"(target {self._target})", file=sys.stderr, flush=True)

    def _reap_and_respawn(self) -> None:
        """Respawn toward the target with a capped backoff between waves.
        The backoff is a timestamp gate, never a sleep: the probe loop
        keeps health-gating the survivors while a crash-looping replica
        waits out its window."""
        now = time.monotonic()
        with self._lock:
            dead = [s for s in self._slots if s.state == DEAD]
            for s in dead:
                self._slots.remove(s)
            alive = len([s for s in self._slots
                         if s.state in (READY, DRAINING, STARTING)])
            missing = self._target - alive
        for s in dead:
            # make sure the corpse is dead before forgetting it: a false
            # verdict (a probe timeout under load) on a running child
            # would otherwise leak a process that competes with its own
            # replacement. kill() is idempotent
            t = threading.Thread(target=self._kill_replica, args=(s,),
                                 name=f"router-reap-{s.sid}")
            t.start()
            with self._lock:
                self._respawners.append(t)
        if dead:
            # fresh deaths push the next wave out and escalate
            self._respawn_not_before = max(self._respawn_not_before,
                                           now + self._backoff)
            self._backoff = min(self._backoff * 2, RESTART_BACKOFF_MAX_S)
        if missing <= 0:
            if not dead:
                self._backoff = RESTART_BACKOFF_S  # healthy: reset
            return
        if now < self._respawn_not_before:
            return
        for _ in range(missing):
            self.telemetry.inc("replica_restarts")
            self._spawn_slot_async()

    def _gc_respawners(self) -> None:
        with self._lock:
            self._respawners = [t for t in self._respawners
                                if t.is_alive()]

    # -- signals and autoscaling -----------------------------------------
    def _publish_signals_and_autoscale(self) -> None:
        now = time.monotonic()
        tel = self.telemetry
        with self._lock:
            slots = [s for s in self._slots
                     if s.state in (READY, DRAINING)]
            ready_n = len([s for s in slots if s.state == READY])
        queue_p95 = 0.0
        sheds = float(tel.shed_admission + tel.shed_circuit
                      + tel.shed_no_replica)
        crashes = 0.0
        for slot in slots:
            try:
                st = slot.replica.stats()
            except Exception:
                continue
            t = st.get("telemetry", {})
            queue_p95 = max(queue_p95,
                            t.get("queue_wait", {}).get("p95_ms", 0.0))
            sheds += float(t.get("shed", 0))
            crashes += float(t.get("dispatcher_crashes", 0))
        dt = max(1e-6, now - self._last_signal_t)
        shed_rate = max(0.0, sheds - self._last_shed_totals) / dt
        self._last_shed_totals = sheds
        self._last_signal_t = now
        tel.replicas_ready.set(ready_n)
        tel.replicas_target.set(self._target)
        tel.queue_wait_p95_ms.set(queue_p95)
        tel.shed_rate_per_s.set(shed_rate)
        tel.dispatcher_crashes.set(crashes)
        if now >= self._flight_note_due:
            # the flight recorder's cadence: a note of counter deltas
            # every 2 s makes a crash dump tell what the router did, tick
            # by tick, up to its end
            self._flight_note_due = now + 2.0
            rec = get_flight_recorder()
            if rec is not None:
                rec.note("probe", replicas_ready=ready_n)
        if self._autoscaler is None or now < self._autoscale_due:
            return
        self._autoscale_due = now + self._autoscale_cfg.interval_s
        # the autoscaler reads the published signals BY NAME: the
        # numbers GET /metrics shows
        reg = tel.registry
        new_target = self._autoscaler.tick(
            queue_p95_ms=reg.value_of("router_queue_wait_p95_ms"),
            shed_rate_per_s=reg.value_of("router_shed_rate_per_s"),
            dispatcher_crashes=reg.value_of("router_dispatcher_crashes"),
            target=self._target)
        if new_target > self._target:
            with self._lock:
                self._target = new_target
            tel.inc("scale_ups")
            print(f"[router] autoscale up -> {new_target} "
                  f"(queue_p95={queue_p95:.1f}ms "
                  f"shed_rate={shed_rate:.2f}/s)", file=sys.stderr,
                  flush=True)
            self._spawn_slot_async()
        elif new_target < self._target:
            with self._lock:
                self._target = new_target
                ready = [s for s in self._slots if s.state == READY]
                victim = (min(ready, key=lambda s: (s.inflight, s.sid))
                          if len(ready) > 1 else None)
                if victim is not None:
                    victim.state = RETIRING
                else:
                    self._target = new_target + 1  # nothing drainable
            if victim is not None:
                print(f"[router] autoscale down -> {new_target} "
                      f"(draining {victim.sid})", file=sys.stderr,
                      flush=True)
        tel.replicas_target.set(self._target)

    # -- introspection ---------------------------------------------------
    def metrics_children(self) -> dict[str, dict]:
        """Every live replica's typed registry dump by slot id, scraped
        concurrently (one wedged replica costs one scrape timeout); a
        replica that fails the scrape is left out."""
        with self._lock:
            slots = [s for s in self._slots
                     if s.state in (READY, DRAINING) and
                     s.replica is not None]
        children: dict[str, dict] = {}
        if not slots:
            return children
        with ThreadPoolExecutor(
                max_workers=len(slots),
                thread_name_prefix="router-metrics-scrape") as pool:
            pending = {s.sid: pool.submit(s.replica.metrics_dump)
                       for s in slots}
            for sid, fut in pending.items():
                try:
                    children[sid] = fut.result()
                except Exception:
                    continue
        return children

    def render_metrics(self) -> str:
        """The fleet's one Prometheus surface (``obs/distributed.py``):
        the router's ``router_*`` families and every replica's
        ``serve_*`` families labelled ``{replica="rN"}``, with exact
        counter sums and reservoir-merged quantiles."""
        return render_federated(self.metrics_children(),
                                own=self.telemetry.registry,
                                label="replica", own_label="router")

    def health(self) -> dict:
        """Fleet liveness for ``/healthz``: ok while at least one replica
        is READY; ``recovering`` (503, with a re-probe hint) while the
        whole fleet is down or draining."""
        ready = len(self._ready_slots())
        with self._lock:
            target = self._target
        status = "ok" if ready > 0 else "recovering"
        out = {
            "status": status,
            "replicas_ready": ready,
            "replicas_target": target,
        }
        if status != "ok":
            out["retry_after_s"] = round(2 * self._probe_interval_s, 3)
        return out

    def stats(self) -> dict:
        with self._lock:
            replicas = [{
                "id": s.sid,
                "state": s.state,
                "inflight": s.inflight,
            } for s in self._slots]
            target = self._target
            sessions = {
                "live": len(self._sessions),
                "replay_window": self._session_replay_window,
                "pins": {r.sid: r.pin for r in self._sessions.values()},
            }
        return {
            "models": sorted(self._models),
            "replicas": replicas,
            "target_replicas": target,
            "slo_budgets_s": dict(self._slo),
            "queue": self._admission.stats(),
            "breakers": {k: b.snapshot()
                         for k, b in self._breakers.items()},
            "health": self.health(),
            "sessions": sessions,
            "telemetry": self.telemetry.snapshot(),
        }

    def summary_line(self) -> str:
        return self.telemetry.summary_line()
