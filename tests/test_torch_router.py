"""The port's serving fleet (``deepvision_tpu_torch/serve/router.py``,
``serve/replica.py``, ``obs/distributed.py``) against the JAX package's,
on the CPU.

- The JAX ``FleetRouter`` and the port's, each over the same scripted
  ``FakeReplica``s (the double of ``tests/test_router.py``), run the same
  scenario: failover, health-gated draining and undraining, the
  all-draining shed with its retry hint, and the ``replica_kill`` and
  ``replica_slow`` fault sites. Both must give each request the same
  answer or error class from the same replica, the same telemetry
  counters and the same ``[router]`` summary line.
- The JAX and port ``CircuitBreaker`` and ``Autoscaler`` on injected
  clocks over one seeded sequence of 300 outcomes or signal samples:
  the same states, retry hints and targets at every step.
- ``render_federated`` and ``parse_prometheus`` over the same child
  dumps and parent registry: the same text and the same parse.
- Fleets of the port's ``EngineReplica``s over ``lenet5`` (32x32x1, 10
  classes, seeded weights): exactly-once answers under hedges, the SLO
  budget as the deadline ceiling and as an admission shed, autoscaling
  up under shed pressure and down when calm, a SIGKILL-like kill
  answered by failover, a clean close that leaks no thread, and the
  federated ``/metrics`` of the HTTP front (the twins of
  ``tests/test_router.py:236-632``).
- ``ProcessReplica``'s death verdict and its deadline and trace-id
  forwarding, without a child, against the JAX class.
- The CLI, the twin of ``make router-smoke``: ``--fleet 2 -m lenet5
  --device cpu --faults replica_kill@5`` over 24 stdin requests, every
  one answered with ``load_served``'s classes, the exit line counting
  the failover and the death, the children stopped by SIGTERM with
  their ``[serve]`` lines, and no CUDA initialized in the router.

The scenarios wait on states, not on sleeps; a hedge goes out after
0.5 s and a delayed attempt waits 1.5 s, long against a CPU forward of
``lenet5``. The router (``_finish``) and the engine (``_run_batch``)
resolve a client's future before they count the request, so a test that
reads a counter after ``result()`` first waits for the counts to land
(``counted``), and then holds them exactly.
"""

import contextlib
import io
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deepvision_tpu.obs import distributed as jax_distributed  # noqa: E402
from deepvision_tpu.obs.metrics import Registry as JaxRegistry  # noqa: E402
from deepvision_tpu.resilience import FaultInjector as JaxFaultInjector  # noqa: E402
from deepvision_tpu.serve import replica as jax_replica  # noqa: E402
from deepvision_tpu.serve import router as jax_router  # noqa: E402
from deepvision_tpu_torch.obs import distributed  # noqa: E402
from deepvision_tpu_torch.obs.metrics import (  # noqa: E402
    Registry,
    default_registry,
)
from deepvision_tpu_torch.resilience.faults import FaultInjector  # noqa: E402
from deepvision_tpu_torch.serve import ShedError, load_served  # noqa: E402
from deepvision_tpu_torch.serve import replica, router  # noqa: E402
from deepvision_tpu_torch.serve.replica import EngineReplica  # noqa: E402
from deepvision_tpu_torch.serve.router import (  # noqa: E402
    AutoscaleConfig,
    FleetRouter,
)
from tests.torch_threads import (  # noqa: E402,F401  (autouse)
    share_cores_among_workers,
)

MODEL, SIZE, CLASSES = "lenet5", 32, 10

# (router module, replica module, fault injector) of each side
SIDES = {"jax": (jax_router, jax_replica, JaxFaultInjector),
         "port": (router, replica, FaultInjector)}


def wait_until(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def counted(fleet, n: int) -> None:
    """Wait until the router has counted ``n`` resolved requests: it
    resolves a future before it counts it."""
    tel = fleet.telemetry
    wait_until(lambda: tel.completed + tel.failed >= n,
               msg=f"{n} resolved requests counted")


# ------------------------------------------ scripted replicas, both sides


class FakeReplica:
    """A scripted replica: health, latency and failures on demand (the
    double of ``tests/test_router.py``), raising the given side's
    ``ReplicaDeadError``."""

    def __init__(self, rid: str, dead_error):
        self.replica_id = rid
        self.dead_error = dead_error
        self.status = "ok"
        self.delay_s = 0.0
        self.requests: list = []
        self.dead = False
        self.stopped = False
        self.die_on_request = False

    def start(self):
        pass

    def stop(self):
        self.stopped = True

    def kill(self):
        self.dead = True

    def request(self, model, x, *, timeout_s=None, trace=None):
        if self.dead:
            raise self.dead_error(f"{self.replica_id}: dead")
        self.requests.append((model, np.asarray(x).tolist()))
        if self.die_on_request:
            self.dead = True
            raise self.dead_error(f"{self.replica_id}: died mid-request")
        if self.delay_s:
            time.sleep(self.delay_s)
        return {"echo": np.asarray(x).tolist(), "by": self.replica_id}

    def probe(self):
        if self.dead:
            raise self.dead_error(f"{self.replica_id}: dead")
        return {"status": self.status}

    def stats(self):
        return {"telemetry": {"queue_wait": {"p95_ms": 0.0}, "shed": 0,
                              "dispatcher_crashes": 0}}


def _fake_fleet(side: str, n: int, faults: str | None = None, **kw):
    router_mod, replica_mod, injector = SIDES[side]
    spawned: list[FakeReplica] = []

    def factory(sid):
        r = FakeReplica(sid, replica_mod.ReplicaDeadError)
        spawned.append(r)
        return r

    if faults is not None:
        kw["fault_injector"] = injector(faults)
    fleet = router_mod.FleetRouter(factory, replicas=n, models=["toy"],
                                   probe_interval_s=0.03, **kw)
    return fleet, spawned


def _answer(fut) -> str:
    """Who answered a request, or the class of its error."""
    try:
        return fut.result(timeout=30)["by"]
    except Exception as e:
        return type(e).__name__


def _state(fleet, sid):
    return {r["id"]: r["state"] for r in fleet.stats()["replicas"]}.get(sid)


def _x(i):
    return np.full(3, i, np.float32)


def _failover(fleet, spawned):
    spawned[0].die_on_request = True  # dies with the first request on it
    out = [_answer(fleet.submit(_x(i))) for i in range(3)]
    wait_until(lambda: len(fleet._ready_slots()) == 2, msg="healed")
    return out + [_answer(fleet.submit(_x(i))) for i in range(3, 5)]


def _draining(fleet, spawned):
    spawned[0].status = "recovering"
    wait_until(lambda: _state(fleet, "r1") == "draining", msg="drained")
    out = [_answer(fleet.submit(_x(i))) for i in range(3)]
    spawned[0].status = "ok"
    wait_until(lambda: _state(fleet, "r1") == "ready", msg="undrained")
    return out + [_answer(fleet.submit(_x(i))) for i in range(3, 6)]


def _all_draining(fleet, spawned):
    spawned[0].status = "recovering"
    wait_until(lambda: fleet.health()["status"] == "recovering",
               msg="fleet degraded")
    try:
        fleet.submit(_x(0)).result(timeout=30)
    except Exception as e:  # each side's RouterShedError
        return [type(e).__name__, e.retry_after_s, fleet.health()]
    raise AssertionError("an all-draining fleet answered")


def _kill_site(fleet, spawned):
    out = [_answer(fleet.submit(_x(i))) for i in range(4)]
    wait_until(lambda: len(fleet._ready_slots()) == 2, msg="healed")
    return out + [_answer(fleet.submit(_x(i))) for i in range(4, 6)]


def _slow_site(fleet, spawned):
    out = [_answer(fleet.submit(_x(i))) for i in range(2)]
    # the slow primary still holds r1 until its delay ends
    wait_until(lambda: all(r["inflight"] == 0
                           for r in fleet.stats()["replicas"]),
               msg="the slow attempt ended")
    out.append(_answer(fleet.submit(_x(2))))
    return out + [len(r.requests) for r in spawned]


SCENARIOS = {
    "failover": (2, None, {}, _failover),
    "draining": (2, None, {}, _draining),
    "all_draining": (1, None, {}, _all_draining),
    "replica_kill": (2, "replica_kill@2", {}, _kill_site),
    "replica_slow": (2, "replica_slow@1:1.5", {"hedge_after_s": 0.5},
                     _slow_site),
}


EXPECTED = {
    "failover": ["r2"] * 5,
    "draining": ["r2"] * 3 + ["r1"] * 3,
    "all_draining": ["RouterShedError"],
    "replica_kill": ["r1", "r1", "r2", "r2", "r2", "r2"],
    # the slow primary and request 2 on r1, the winning hedge on r2
    "replica_slow": ["r1", "r2", "r1", 3, 1],
}


def _counters(fleet) -> dict:
    return {k: v for k, v in fleet.telemetry.snapshot().items()
            if not isinstance(v, dict)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_equals_jax(name):
    n, faults, kw, scenario = SCENARIOS[name]
    got = {}
    for side in SIDES:
        fleet, spawned = _fake_fleet(side, n, faults, **kw)
        try:
            answers = scenario(fleet, spawned)
        finally:
            fleet.close()
        got[side] = (answers, _counters(fleet), fleet.summary_line())
    assert got["port"] == got["jax"]
    answers, counters, line = got["port"]
    want = EXPECTED[name]
    assert answers[:len(want)] == want, answers
    if name in ("failover", "replica_kill"):
        assert (counters["failovers"], counters["replica_deaths"],
                counters["replica_restarts"]) == (1, 1, 1), counters
    if name == "replica_slow":
        assert (counters["hedges"], counters["hedge_wins"]) == (1, 1)
    if name == "all_draining":
        assert counters["shed_no_replica"] == 1 and answers[1] > 0
    assert line.startswith("[router] failovers=")


def test_fault_sites_replay_like_jax():
    def trace(inj):
        return [(inj.check_replica_kill(), inj.check_replica_slow())
                for _ in range(8)]

    schedule = "replica_kill@2,replica_slow@4:0.2,rkill@6"
    assert trace(FaultInjector(schedule)) == trace(JaxFaultInjector(schedule))
    assert FaultInjector(schedule).summary() == \
        JaxFaultInjector(schedule).summary()


# ------------------------------------- breaker and autoscaler, stepwise


def test_circuit_breaker_steps_equal_jax():
    rng = np.random.default_rng(0)
    ops = rng.integers(0, 4, size=300)
    dts = rng.uniform(0.0, 1.5, size=300)
    runs = []
    for mod in (jax_router, router):
        t = [0.0]
        cb = mod.CircuitBreaker(
            mod.CircuitConfig(window=8, min_volume=4, failure_frac=0.5,
                              open_s=2.0), clock=lambda t=t: t[0])
        steps = []
        for op, dt in zip(ops, dts):
            if op == 0:
                steps.append(("allow", cb.allow()))
            elif op == 1:
                cb.record_success()
            elif op == 2:
                cb.record_failure()
            else:
                t[0] += float(dt)
            steps.append((cb.state, cb.retry_after_s(), cb.snapshot()))
        runs.append(steps)
    assert runs[0] == runs[1]
    states = {s[0] for s in runs[1] if s[0] != "allow"}
    assert states == {"closed", "open", "half_open"}, states


def test_autoscaler_targets_equal_jax():
    rng = np.random.default_rng(1)
    cfg = dict(min_replicas=1, max_replicas=4, sustain_up=2, sustain_down=3,
               cooldown_s=4.0, up_queue_p95_ms=200.0, down_queue_p95_ms=20.0,
               up_shed_rate_per_s=0.5)
    queue = rng.choice([0.0, 10.0, 100.0, 500.0], size=300)
    shed = rng.choice([0.0, 0.0, 0.2, 2.0], size=300)
    crashes = np.cumsum(rng.random(300) < 0.05).astype(float)
    dts = rng.uniform(0.2, 3.0, size=300)
    runs = []
    for mod in (jax_router, router):
        a = mod.Autoscaler(mod.AutoscaleConfig(**cfg))
        target, now, steps = 1, 0.0, []
        for q, s, c, dt in zip(queue, shed, crashes, dts):
            now += float(dt)
            target = a.tick(queue_p95_ms=float(q), shed_rate_per_s=float(s),
                            dispatcher_crashes=float(c), target=target,
                            now=now)
            steps.append(target)
        runs.append(steps)
    assert runs[0] == runs[1]
    assert set(runs[1]) == {1, 2, 3, 4}, set(runs[1])


# ------------------------------------------------------------ federation


def _fill(reg, scale: float) -> None:
    reg.counter("router_requests").inc(int(7 * scale))
    reg.counter("trace_dropped_spans").inc(2)
    reg.gauge("router_replicas_ready").set(2.0)
    h = reg.histogram("router_e2e_latency")
    for v in np.linspace(0.001, 0.02, 13) * scale:
        h.observe(float(v))


def _child_dump(i: int) -> dict:
    reg = Registry()
    reg.counter("serve_completed").inc(5 + i)
    reg.counter("trace_dropped_spans").inc(i)
    reg.gauge("serve_queue_depth").set(1.5 * i)
    h = reg.histogram("serve_e2e_latency")
    for v in np.linspace(0.002, 0.03, 9 + i):
        h.observe(float(v))
    return reg.dump()


def test_render_federated_equals_jax():
    children = {"r1": _child_dump(1), "r3": _child_dump(3)}
    own_jax, own_port = JaxRegistry(), Registry()
    _fill(own_jax, 1.0)
    _fill(own_port, 1.0)
    want = jax_distributed.render_federated(children, own=own_jax,
                                            label="replica",
                                            own_label="router")
    got = distributed.render_federated(children, own=own_port,
                                       label="replica", own_label="router")
    assert got == want
    parsed = distributed.parse_prometheus(got)
    assert parsed == jax_distributed.parse_prometheus(want)
    assert parsed["serve_completed_total"] == [
        ({"replica": "r1"}, 6.0), ({"replica": "r3"}, 8.0), ({}, 14.0)]
    # a family both sides have folds the parent in as one more child
    assert ({"replica": "router"}, 2.0) in parsed["trace_dropped_spans_total"]
    assert distributed.merge_histograms(
        [children["r1"]["serve_e2e_latency"]]) == \
        jax_distributed.merge_histograms(
            [children["r1"]["serve_e2e_latency"]])
    tid = distributed.new_trace_id()
    assert len(tid) == 16 and int(tid, 16) >= 0
    assert distributed.TRACE_HEADER == jax_distributed.TRACE_HEADER


# ------------------------------------------- in-process engine replicas


def _lenet():
    return load_served(MODEL, seed=0, device="cpu")


@pytest.fixture(scope="module")
def lenet():
    return _lenet()


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, SIZE, SIZE, 1)).astype(np.float32)


def _engine_fleet(lenet, n=2, **kw):
    def factory(sid):
        # the replicas' engines share the eval-mode model, read-only
        return EngineReplica(sid, lambda: [lenet], buckets=(1, 4))

    kw.setdefault("probe_interval_s", 0.05)
    return FleetRouter(factory, replicas=n, models=[MODEL], **kw)


def test_engine_fleet_hedges_resolve_exactly_once(lenet):
    xs = _requests(6, seed=1)
    want = lenet.run(xs)["classes"]
    fleet = _engine_fleet(
        lenet, hedge_after_s=0.5,
        fault_injector=FaultInjector("replica_slow@1:1.5,replica_slow@4:1.5"))
    resolved = []
    try:
        for i, x in enumerate(xs):
            fut = fleet.submit(x, model=MODEL)
            fut.add_done_callback(lambda f, i=i: resolved.append(i))
            assert fut.result(timeout=30)["classes"] == want[i].tolist()
        wait_until(lambda: all(r["inflight"] == 0
                               for r in fleet.stats()["replicas"]),
                   msg="the slow attempts ended")
        counted(fleet, 6)
    finally:
        fleet.close()
    assert resolved == list(range(6))  # one resolution a request
    tel = fleet.telemetry
    assert tel.hedges >= 2 and tel.hedge_wins >= 2, tel.snapshot()
    assert (tel.completed, tel.failed) == (6, 0)


def test_engine_fleet_slo_budget_is_the_deadline_and_sheds(lenet):
    xs = _requests(3, seed=2)
    fleet = _engine_fleet(
        lenet, n=1, slo={MODEL: 0.3}, max_retries=0,
        fault_injector=FaultInjector("replica_slow@0:1.0,replica_slow@1:1.0"))
    try:
        with pytest.raises(TimeoutError):
            # the budget caps the CLI's blanket 30 s timeout: under it the
            # delayed attempt would have answered
            fleet.submit(xs[0], model=MODEL, timeout_s=30.0).result(
                timeout=30)
        for _ in range(50):  # a 1 s a row service time
            fleet._admission.observe_batch(1.0, 1)
        held = fleet.submit(xs[1], model=MODEL)  # depth 1 for 0.3 s
        with pytest.raises(ShedError, match="budget"):
            fleet.submit(xs[2], model=MODEL)
        with pytest.raises(TimeoutError):
            held.result(timeout=30)
        # the backlog gone, the same request is admitted and answered
        got = fleet.submit(xs[2], model=MODEL).result(timeout=30)
        assert got["classes"] == lenet.run(xs[2:])["classes"][0].tolist()
        counted(fleet, 3)
        stats = fleet.stats()
    finally:
        fleet.close()
    assert stats["slo_budgets_s"] == {MODEL: 0.3}
    assert stats["queue"]["slo_budget_s"] == {MODEL: 0.3}
    tel = fleet.telemetry
    assert (tel.shed_admission, tel.failed, tel.completed) == (1, 2, 1)


def test_engine_fleet_autoscales_up_under_sheds_and_down_when_calm(lenet):
    x = _requests(1, seed=3)[0]
    fleet = _engine_fleet(
        lenet, n=1, max_queue=1, probe_interval_s=0.02,
        fault_injector=FaultInjector("replica_slow@0:2.0"),
        autoscale=AutoscaleConfig(
            min_replicas=1, max_replicas=2, interval_s=0.05, sustain_up=2,
            sustain_down=3, cooldown_s=0.2, up_queue_p95_ms=1e9,
            down_queue_p95_ms=1e9, up_shed_rate_per_s=0.5))
    try:
        held = fleet.submit(x, model=MODEL)  # holds the one queue slot
        deadline = time.monotonic() + 20
        while fleet.telemetry.scale_ups == 0:
            assert time.monotonic() < deadline, "no scale-up"
            with pytest.raises(ShedError):
                fleet.submit(x, model=MODEL)
            time.sleep(0.01)
        wait_until(lambda: len(fleet._ready_slots()) == 2, msg="scaled up")
        assert held.result(timeout=30)["classes"] == \
            lenet.run(x[None])["classes"][0].tolist()
        wait_until(lambda: fleet.telemetry.scale_downs == 1
                   and len(fleet._ready_slots()) == 1, msg="scaled down")
        time.sleep(0.3)
        assert len(fleet._ready_slots()) == 1  # held at the minimum
    finally:
        fleet.close()
    assert fleet.telemetry.scale_ups == 1
    assert fleet.telemetry.shed_admission >= 2


def test_engine_fleet_kill_fails_over_and_heals(lenet):
    xs = _requests(12, seed=4)
    want = lenet.run(xs)["classes"]
    fleet = _engine_fleet(lenet,
                          fault_injector=FaultInjector("replica_kill@5"))
    try:
        for i, x in enumerate(xs):
            assert fleet.submit(x, model=MODEL).result(timeout=30)[
                "classes"] == want[i].tolist()
        wait_until(lambda: len(fleet._ready_slots()) == 2, msg="healed")
        counted(fleet, 12)
        ids = sorted(r["id"] for r in fleet.stats()["replicas"])
    finally:
        fleet.close()
    tel = fleet.telemetry
    assert (tel.replica_deaths, tel.failovers, tel.replica_restarts,
            tel.completed, tel.failed) == (1, 1, 1, 12, 0)
    assert ids == ["r2", "r3"]


def test_engine_fleet_close_is_clean_and_leaks_no_threads(lenet):
    before = {t.name for t in threading.enumerate()}
    fleet = _engine_fleet(lenet)
    fleet.submit(_requests(1)[0], model=MODEL).result(timeout=30)
    fleet.close()
    fleet.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        fleet.submit(_requests(1)[0], model=MODEL)
    wait_until(lambda: not {
        t.name for t in threading.enumerate()
        if t.name.startswith(("router-", "serve-"))} - before,
        timeout=5, msg="no leaked thread")


def test_fleet_http_front_federates_metrics(lenet, monkeypatch):
    import argparse
    import http.client

    from deepvision_tpu_torch.obs import profiler
    from deepvision_tpu_torch.serve.http import make_handler, make_server

    def no_device(*a, **kw):
        raise AssertionError("the router sampled device memory")

    monkeypatch.setattr(profiler, "sample_memory_gauges", no_device)
    # a router's process holds no engine: take the serve_* families that
    # an earlier test's in-process engines registered in this worker's
    # process registry (latest wins) out of it for the test, so that the
    # router renders only its own families beside the replicas'
    registry = default_registry()
    stale = {name: registry.get(name) for name in registry.names()
             if name.startswith("serve_")}
    for name in stale:
        registry.unregister(name)
    fleet = _engine_fleet(lenet)
    server = make_server(("127.0.0.1", 0), make_handler(
        fleet, argparse.Namespace(timeout_s=30.0)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        for x in _requests(3, seed=5):
            fleet.submit(x, model=MODEL).result(timeout=30)
        # the router and the engines count a request after they resolve
        # it: wait for the counts, then read /metrics and the replicas'
        # own stats
        counted(fleet, 3)
        wait_until(lambda: sum(
            s.replica.stats()["telemetry"]["completed"]
            for s in fleet._ready_slots()) >= 3,
            msg="the replicas' counts")
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.server_address[1], timeout=30)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        own = {s["id"]: fleet._slots[i].replica.stats()["telemetry"]
               for i, s in enumerate(fleet.stats()["replicas"])}
    finally:
        server.shutdown()
        server.server_close()
        fleet.close()
        for name, metric in stale.items():
            registry.register(name, metric)
    parsed = distributed.parse_prometheus(text)
    assert parsed["router_completed_total"] == [({}, 3.0)]
    by_replica = dict((labels.get("replica"), v) for labels, v
                      in parsed["serve_completed_total"])
    assert by_replica == {**{sid: float(t["completed"])
                             for sid, t in own.items()}, None: 3.0}
    assert health["replicas_ready"] == 2 and health["status"] == "ok"


# ------------------------------------------- process replicas, no child


class _Proc:
    returncode = None
    pid = 1

    def poll(self):
        return self.returncode


class _Conn:
    sock = None
    timeout = None

    def request(self, *a, **kw):
        raise ConnectionResetError("peer reset")

    def close(self):
        pass


def _death_verdicts(mod) -> list[str]:
    """The twin of ``tests/test_router.py``'s death-verdict test: a
    dropped connection to a live child, to an exited one, and an HTTP
    5xx answer."""
    rep = mod.ProcessReplica("r1", argv=["unused"])
    rep._proc = _Proc()
    rep._port = 1  # never dialed: the fake connection raises first
    out = []
    for rc in (None, -9):
        rep._proc.returncode = rc
        rep._conns.conn = _Conn()
        try:
            rep._http("POST", "/v1/predict", "{}")
        except Exception as e:
            out.append(type(e).__name__)
    rep._proc.returncode = None
    rep._http = lambda *a, **kw: (500, {}, b'{"error": "boom"}')
    try:
        rep.request("toy", np.zeros(3, np.float32))
    except Exception as e:
        out.append(type(e).__name__)
    return out


def test_process_replica_death_verdict_equals_jax():
    assert _death_verdicts(replica) == _death_verdicts(jax_replica) == [
        "RuntimeError", "ReplicaDeadError", "RuntimeError"]


def _forwarded(mod) -> list:
    rep = mod.ProcessReplica("r1", argv=["unused"])
    seen = []

    def fake_http(method, path, body, timeout_s, headers=None):
        seen.append((path, json.loads(body), timeout_s, headers))
        return 200, {}, b'{"result": {"classes": [1]}}'

    rep._http = fake_http
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert rep.request("toy", x, timeout_s=0.75, trace="ab12") == {
        "classes": [1]}
    rep.request(None, x)
    return seen


def test_process_replica_forwards_deadline_and_trace_like_jax():
    got, want = _forwarded(replica), _forwarded(jax_replica)
    assert got == want
    (_, payload, timeout_s, headers), (_, bare, _, no_headers) = got
    assert payload["timeout_s"] == 0.75 and timeout_s == 1.75
    assert headers == {"X-DVTPU-Trace": "ab12"} and no_headers is None
    assert "timeout_s" not in bare and "model" not in bare
    assert payload["shape"] == [2, 3] and payload["dtype"] == "float32"


def test_replica_argv_runs_the_ports_cli():
    argv = replica.replica_argv(["lenet5", "yolov3=runs/yolov3"],
                                buckets="1,4", store="aot", device="cpu",
                                extra=["--seed", "0"])
    assert argv == [sys.executable, "-m", "deepvision_tpu_torch.serve",
                    "--http", "0", "-m", "lenet5", "-m", "yolov3=runs/yolov3",
                    "--buckets", "1,4", "--store", "aot", "--device", "cpu",
                    "--seed", "0"]
    assert replica.replica_argv([])[-2:] == ["--device", "cuda"]
    env = replica.replica_env({"PYTHONPATH": "/elsewhere"})
    assert env["PYTHONPATH"].split(":") == [str(REPO), "/elsewhere"]


# ------------------------------------------------------------- the CLI


def test_cli_fleet_fails_over_a_killed_replica(tmp_path, monkeypatch):
    from deepvision_tpu_torch.serve.__main__ import main

    # the replicas' logs land under tmp_path
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    xs = _requests(24, seed=6)

    def paced():
        # a line every 50 ms, as from a client: a burst of the whole file
        # would put most requests in flight on the killed replica, whose
        # failures could open the circuit breaker (a shed, by design)
        for i, x in enumerate(xs):
            time.sleep(0.05)
            yield json.dumps({"id": i, "input": x.tolist()}) + "\n"

    out, err = io.StringIO(), io.StringIO()
    obs = tmp_path / "obs"
    with contextlib.redirect_stderr(err):
        rc = main(["--fleet", "2", "-m", MODEL, "--device", "cpu",
                   "--seed", "0", "--buckets", "1,4",
                   "--faults", "replica_kill@5", "--trace-spool", str(obs)],
                  stdin=paced(), stdout=out)
    assert rc == 0
    assert not torch.cuda.is_initialized()  # the router touched no device
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    assert [r["id"] for r in replies] == list(range(24)), replies
    want = load_served(MODEL, seed=0, device="cpu").run(xs)["classes"]
    for r in replies:
        assert r["result"]["classes"] == want[r["id"]].tolist(), r
    last = err.getvalue().strip().splitlines()[-1]
    assert last.startswith("[router] failovers="), last
    fields = dict(kv.split("=") for kv in last.split()[1:])
    assert int(fields["failovers"]) >= 1 and fields["deaths"] == "1", last
    assert (fields["completed"], fields["failed"]) == ("24", "0"), last
    # every replica still alive at the end was stopped by SIGTERM, and
    # printed its exit line first
    stopped = [s for s in err.getvalue().splitlines() if " stopped: " in s]
    assert stopped and all(s.endswith("exit 143") for s in stopped), stopped
    logs = [p.read_text() for p in tmp_path.glob("dvt-replica-*/replica.log")]
    assert len(logs) >= 2
    assert sum("[serve] completed=" in text for text in logs) == len(stopped)
    # the spools of the router (in this process) and of every replica
    # merge into one trace whose flows cross from the router's row into
    # the replicas'; each replica stopped by SIGTERM left its dump
    from deepvision_tpu_torch.obs.distributed import get_flight_recorder
    from deepvision_tpu_torch.obs.trace import get_tracer
    from deepvision_tpu_torch.obs.trace_merge import main as merge_main

    assert get_flight_recorder() is None and not get_tracer().active
    assert merge_main([str(obs), "--assert-flow", "--assert-spans",
                       "router_attempt,replica_queue,device,postprocess"]) == 0
    dumps = {p.name.split("-")[1] for p in obs.glob("flightrec-*.json")}
    assert dumps == {s.split()[2] for s in stopped}, (dumps, stopped)
