"""The port's serving observability (``deepvision_tpu_torch/obs/trace.py``'s
sinks, labels and retroactive spans, ``obs/distributed.py``'s spools and
flight recorder, ``obs/trace_merge.py``, the engine's and the pipeline's
spans) against the JAX package's, on the CPU.

- Twins of ``tests/test_obs_distributed.py``: a merge of two spools whose
  clocks start 5 s apart beside a torn one, the two-file rotation, the
  recalibration after a re-epoch, a flight recorder's dump on SIGTERM in
  a child process, the bounded ring with its counter-delta notes, and
  the ring's overflow counted.
- Cross-reading: the spool lines of both packages' ``SpanSpool`` are the
  same bytes for the same spans, each ``read_spool`` reads the other's
  spool, and ``tools/trace_merge.py`` and the port's ``trace_merge`` give
  the same merged trace over one directory of both packages' spools,
  flight dumps and a torn spool.
- The engines: the same requests with trace ids through the JAX engine
  and the port's give the same spans (name, arguments, trace ids) on a
  toy model, on the toy ``detpose`` DAG of ``tests/test_torch_pipeline.py``
  (the ``stage:<node>`` spans in DAG order, inside their ``device`` span)
  and on the tracking streams of ``tests/test_torch_sessions.py`` (with
  the sessions); a dispatcher crash dumps the flight recorder in both.
- The trace id's hop: the twins of ``tests/test_obs_distributed.py:52-110``
  over the port's router and ``EngineReplica``s, and of
  ``tests/test_pipeline.py``'s cross-stage flow, merged and held by
  ``trace_merge.main([..., "--assert-flow"])``.

A test that attaches a sink to a process-wide tracer or installs the
process's flight recorder removes it before it ends.
"""

import contextlib
import json
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deepvision_tpu.obs import distributed as jax_distributed  # noqa: E402
from deepvision_tpu.obs import trace as jax_trace  # noqa: E402
from deepvision_tpu_torch.obs import distributed  # noqa: E402
from deepvision_tpu_torch.obs import trace_merge  # noqa: E402
from deepvision_tpu_torch.obs.distributed import (  # noqa: E402
    FlightRecorder,
    SpanSpool,
    read_spool,
    spool_paths,
)
from deepvision_tpu_torch.obs.metrics import Registry  # noqa: E402
from deepvision_tpu_torch.obs.trace import Tracer, get_tracer  # noqa: E402
from deepvision_tpu_torch.serve.models import ServedModel  # noqa: E402
from tests.torch_threads import (  # noqa: E402,F401  (autouse)
    share_cores_among_workers,
)
from tools import trace_merge as jax_trace_merge  # noqa: E402


class _Capture:
    """A sink keeping every span record a tracer emits."""

    def __init__(self):
        self.records: list[dict] = []

    def __call__(self, rec: dict) -> None:
        self.records.append(rec)


@contextlib.contextmanager
def _captured(*tracers):
    """One capture a tracer, attached for the block and removed after."""
    caps = [_Capture() for _ in tracers]
    for t, c in zip(tracers, caps):
        t.add_sink(c)
    try:
        yield caps
    finally:
        for t, c in zip(tracers, caps):
            t.remove_sink(c)


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not met"
        time.sleep(0.01)


# ------------------------------------------------------------ spools


def test_spool_merge_corrects_clock_offset_and_tolerates_torn_tail(
        tmp_path):
    """Twin of ``tests/test_obs_distributed.py:120``: two processes whose
    clocks started 5 s apart merge onto one wall timeline in the true
    order; a torn last line is skipped and the merge goes on."""
    t_router = Tracer()
    t_router.set_labels(role="router")
    t_replica = Tracer()
    t_replica.set_labels(role="r1")
    t_replica.epoch_wall = t_router.epoch_wall - 5.0
    s1 = SpanSpool(tmp_path, tracer=t_router)
    s2 = SpanSpool(tmp_path, tracer=t_replica)
    with t_router.span("router_side", args={"trace": "aa" * 8}):
        pass
    with t_replica.span("replica_side", args={"trace": "aa" * 8}):
        pass
    s1.close()
    s2.close()
    torn = tmp_path / "trace-spool-dead-999.jsonl"
    torn.write_text(json.dumps({"spool": 1, "pid": 999, "role": "dead",
                                "epoch_wall": t_router.epoch_wall})
                    + "\n" + '{"name": "half-writt')

    assert len(spool_paths(tmp_path)) == 3
    assert read_spool(torn)["events"] == []
    merged = trace_merge.merge(trace_merge.collect(tmp_path))
    by = {e["name"]: e for e in merged["traceEvents"] if e.get("ph") == "X"}
    assert by["replica_side"]["ts"] < by["router_side"]["ts"]
    assert by["router_side"]["ts"] == pytest.approx(5e6, rel=0.2)
    assert by["router_side"]["pid"] != by["replica_side"]["pid"]
    assert merged["metadata"]["cross_process_flows"] == 1


def test_spool_rotation_bounds_disk_and_keeps_reading(tmp_path):
    """Twin of ``tests/test_obs_distributed.py:166``."""
    t = Tracer()
    t.set_labels(role="w")
    spool = SpanSpool(tmp_path, tracer=t, max_bytes=2000)
    for i in range(100):
        with t.span(f"s{i}"):
            pass
    spool.close()
    paths = spool_paths(tmp_path)
    assert any(p.name.endswith(".1") for p in paths)
    assert all(p.stat().st_size < 4000 for p in paths)
    events = sorted((e for p in paths for e in read_spool(p)["events"]),
                    key=lambda e: e["wall"])
    assert events and events[-1]["name"] == "s99"
    sources = trace_merge.collect(tmp_path)
    assert len(sources) == 1
    merged = trace_merge.merge(sources)
    xs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert len({e["pid"] for e in xs}) == 1 and len(xs) == len(events)


def test_spool_recalibrates_after_tracer_reepoch(tmp_path):
    """Twin of ``tests/test_obs_distributed.py:191``."""
    t = Tracer()
    spool = SpanSpool(tmp_path, tracer=t, role="w")
    with t.span("before"):
        pass
    t.clear()
    with t.span("after"):
        pass
    spool.close()
    data = read_spool(spool.path)
    assert len(data["headers"]) == 2
    walls = {e["name"]: e["wall"] for e in data["events"]}
    assert walls["before"] <= walls["after"]


def test_spans_reach_a_sink_without_the_ring():
    """A span with a sink and no ring reaches the sink alone; with
    neither the tracer is inactive and ``record_span`` does nothing."""
    t = Tracer()
    assert not t.active
    t.record_span("nothing", 0.0, 1.0)
    with _captured(t) as (cap,):
        assert t.active and not t.enabled
        t0 = time.perf_counter()
        t.record_span("late", t0, t0 + 0.25, cat="serve",
                      args={"trace": "ab"})
        with t.span("live"):
            pass
    assert not t.active and len(t) == 0
    late, live = cap.records
    assert (late["name"], late["cat"], late["args"]) == (
        "late", "serve", {"trace": "ab"})
    assert late["dur"] == pytest.approx(0.25)
    assert "args" not in live and live["depth"] == 0


@pytest.mark.parametrize("labels", [
    {"role": "router"}, {"role": "r1"}, {"host": 0, "generation": 2},
    {"role": "host1", "host": 1, "generation": "gen-000"},
    {"role": "decode-w0", "zone": "a"}, {}])
def test_format_labels_equals_jax(labels):
    from deepvision_tpu_torch.obs.trace import format_labels

    assert format_labels(labels) == jax_trace.format_labels(labels)


# ------------------------------------------------------ flight recorder


def test_flight_recorder_dump_on_signal(tmp_path):
    """Twin of ``tests/test_obs_distributed.py:325``, in a child process
    of the port's modules alone."""
    script = textwrap.dedent(f"""
        import signal, sys, time
        sys.path.insert(0, {str(REPO)!r})
        from deepvision_tpu_torch.obs.distributed import (
            install_flight_recorder)
        from deepvision_tpu_torch.obs.metrics import default_registry
        from deepvision_tpu_torch.obs.trace import get_tracer

        get_tracer().set_labels(role="child")
        rec = install_flight_recorder({str(tmp_path)!r},
                                      meta={{"role": "child"}},
                                      signals=(signal.SIGTERM,))
        default_registry().counter("work_done").inc(7)
        with get_tracer().span("work"):
            pass
        rec.note("tick", step=3)
        print("ready", flush=True)
        time.sleep(60)
    """)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
    (dump,) = tmp_path.glob("flightrec-child-signal-15-*.json")
    body = json.loads(dump.read_text())
    assert body["reason"] == "signal-15"
    kinds = [(e["kind"], e.get("name") or e.get("label"))
             for e in body["events"]]
    assert ("span", "work") in kinds and ("note", "tick") in kinds
    note = [e for e in body["events"] if e["kind"] == "note"][0]
    assert note["step"] == 3 and note["metrics"].get("work_done") == 7
    assert body["snapshot"]["work_done"] == 7
    assert proc.returncode != 0  # the default disposition was chained


def test_flight_recorder_ring_is_bounded_and_notes_delta(tmp_path):
    """Twin of ``tests/test_obs_distributed.py:372``; the same calls on
    the JAX recorder give the same ring."""
    rings = []
    for rec_cls, reg_cls, tracer_cls in (
            (FlightRecorder, Registry, Tracer),
            (jax_distributed.FlightRecorder,
             jax_distributed.Registry, jax_trace.Tracer)):
        reg, tracer = reg_cls(), tracer_cls()
        rec = rec_cls(tmp_path / rec_cls.__module__, capacity=8,
                      registry=reg, tracer=tracer)
        try:
            reg.counter("c").inc(5)
            rec.note("first")
            reg.counter("c").inc(2)
            reg.gauge("g").set(1.5)
            rec.note("second", step=4)
            for i in range(6):
                with tracer.span(f"s{i}"):
                    pass
            body = json.loads(rec.dump("test").read_text())
        finally:
            rec.close()
        assert len(body["events"]) == 8
        rings.append([(e["kind"], e.get("name") or e.get("label"),
                       e.get("metrics"), e.get("step"))
                      for e in body["events"]])
    port, jax_ring = rings
    assert port == jax_ring
    assert port[:2] == [("note", "first", {"c": 5}, None),
                        ("note", "second", {"c": 2, "g": 1.5}, 4)]
    rec = FlightRecorder(tmp_path, capacity=8, registry=Registry(),
                         tracer=Tracer())
    try:
        for i in range(20):
            with rec._tracer.span(f"s{i}"):
                pass
        names = [e["name"] for e in json.loads(
            rec.dump("again").read_text())["events"]]
    finally:
        rec.close()
    assert names == [f"s{i}" for i in range(12, 20)]


def test_tracer_ring_overflow_is_counted_not_silent(tmp_path):
    """Twin of ``tests/test_obs_distributed.py:471``, on the port's
    registry."""
    from deepvision_tpu_torch.obs.metrics import default_registry

    c = default_registry().counter("trace_dropped_spans")
    before = c.value
    t = Tracer(capacity=4)
    t.enable()
    for i in range(7):
        with t.span(f"s{i}"):
            pass
    assert len(t) == 4 and t.dropped_spans == 3
    assert c.value - before == 3
    out = tmp_path / "trace.json"
    t.set_labels(role="w")
    t.export(out)
    body = json.loads(out.read_text())
    assert body["metadata"]["trace_dropped_spans"] == 3
    assert body["metadata"]["complete"] is False
    assert body["metadata"]["labels"] == {"role": "w"}
    assert {"ph": "M", "name": "process_name", "pid": body["metadata"][
        "pid"], "tid": 0, "args": {"name": "w"}} in body["traceEvents"]
    t.clear()
    assert t.dropped_spans == 0
    t.export(out)
    assert json.loads(out.read_text())["metadata"]["complete"] is True


# --------------------------------------------------------- cross-reading


def _twin_spools(tmp_path) -> dict:
    """The same spans through each package's tracer and spool, the
    tracers set to the same epoch and labels: -> {package: spool path}."""
    out = {}
    t0 = time.perf_counter()
    for name, tracer_cls, spool_cls in (
            ("port", Tracer, SpanSpool),
            ("jax", jax_trace.Tracer, jax_distributed.SpanSpool)):
        t = tracer_cls()
        t._epoch = t0
        t.epoch_wall = 1.7e9
        t.set_labels(role="r1")
        spool = spool_cls(tmp_path / name, tracer=t)
        t.record_span("device", t0 + 0.001, t0 + 0.004, cat="serve",
                      args={"model": "toy", "bucket": 4, "rows": 3,
                            "traces": ["aa" * 8, "bb" * 8]})
        t.record_span("replica_queue", t0, t0 + 0.001, cat="serve",
                      args={"trace": "aa" * 8, "model": "toy"})
        t.clear()  # a re-epoch: a second header
        t.epoch_wall = 1.7e9 + 1.0
        t.record_span("postprocess", t._epoch, t._epoch + 0.002,
                      cat="serve",
                      args={"trace": "aa" * 8})
        spool.close()
        out[name] = spool.path
    return out


def test_spool_lines_are_the_same_bytes_and_read_across(tmp_path):
    paths = _twin_spools(tmp_path)
    lines = {k: p.read_text().splitlines() for k, p in paths.items()}
    assert len(lines["port"]) == len(lines["jax"]) == 5
    for a, b in zip(lines["port"], lines["jax"]):
        ra, rb = json.loads(a), json.loads(b)
        if ra.get("spool") == 1:
            # the headers differ only in the time they were written
            ra.pop("time"), rb.pop("time")
            assert ra == rb
        else:
            assert a == b  # a span's line, byte for byte
    for path in paths.values():
        port_read = read_spool(path)
        assert port_read == jax_distributed.read_spool(path)
        assert [e["name"] for e in port_read["events"]] == [
            "device", "replica_queue", "postprocess"]
        assert port_read["events"][-1]["wall"] == pytest.approx(
            1.7e9 + 1.0, abs=0.1)


def test_both_mergers_give_one_trace_over_mixed_sources(tmp_path):
    """``tools/trace_merge.py`` and the port's merger over one directory
    of both packages' spools and flight dumps and a torn spool."""
    _twin_spools(tmp_path)
    for tracer_cls, rec_cls, reg_cls, tag in (
            (Tracer, FlightRecorder, Registry, "portrec"),
            (jax_trace.Tracer, jax_distributed.FlightRecorder,
             jax_distributed.Registry, "jaxrec")):
        t, reg = tracer_cls(), reg_cls()
        t.set_labels(role=tag)
        rec = rec_cls(tmp_path / "dumps", registry=reg, tracer=t)
        reg.counter("served").inc(3)
        with t.span("router_attempt", args={"trace": "aa" * 8}):
            pass
        rec.note("probe", replicas_ready=2)
        assert rec.dump("signal-15") is not None
        rec.close()
    (tmp_path / "trace-spool-dead-7.jsonl").write_text(
        json.dumps({"spool": 1, "pid": 7, "role": "dead",
                    "epoch_wall": 1.7e9}) + "\n" + '{"name": "to')
    port = trace_merge.merge(trace_merge.collect(tmp_path))
    jax_merged = jax_trace_merge.merge(jax_trace_merge.collect(tmp_path))
    assert port["traceEvents"] == jax_merged["traceEvents"]
    assert port["metadata"] == jax_merged["metadata"]
    names = {e["name"] for e in port["traceEvents"]}
    assert {"note:probe", "router_attempt", "device"} <= names
    assert port["metadata"]["cross_process_flows"] >= 1
    assert len(port["metadata"]["sources"]) == 5


# ---------------------------------------------------------- the engines


def _port_toy(name="toy", weight=2.0, dim=3) -> ServedModel:
    """``tests/test_router.py``'s toy (y = w x + 0.5) in the port."""
    class _W(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("w", torch.tensor(weight))

    mod = _W()

    def forward(x):
        return {"y": x * mod.w + 0.5}

    def post(host, i):
        return {"y": np.asarray(host["y"][i]).tolist()}

    return ServedModel(name=name, task="classify", module=mod,
                       input_shape=(dim,), postprocess=post,
                       device=torch.device("cpu"), forward=forward)


def _spans(records, traces: set) -> list:
    """The records that carry one of ``traces``: (name, the arguments but
    the trace ids, the trace ids) in recording order."""
    out = []
    for r in records:
        args = dict(r.get("args") or {})
        ids = ([args.pop("trace")] if "trace" in args
               else args.pop("traces", []))
        if set(ids) & traces:
            out.append((r["name"], json.dumps(args, sort_keys=True),
                        tuple(sorted(ids))))
    return out


def _traced_run(eng, xs, traces, model, n_post, cap, **kw) -> list:
    """Submit ``xs`` while the dispatcher waits, so that both engines
    batch alike, then wait for the answers and for every postprocess
    span."""
    eng.pause()
    futs = [eng.submit(x, model=model, trace=t, **({
        k: v[i] for k, v in kw.items()} if kw else {}))
        for i, (x, t) in enumerate(zip(xs, traces))]
    eng.resume()
    answers = [f.result(timeout=60) for f in futs]
    _wait_for(lambda: sum(r["name"] == "postprocess"
                          for r in cap.records) >= n_post)
    return answers


def test_engine_spans_equal_jax():
    """Five requests with trace ids (a bucket-4 batch and a bucket-1
    one) through the JAX engine and the port's: the same spans, names,
    arguments and trace ids, and the port's ``replica_queue`` ends where
    its batch's ``device`` span starts."""
    from tests.test_router import toy_model

    from deepvision_tpu.core.mesh import create_mesh
    from deepvision_tpu.serve import InferenceEngine as JaxEngine
    from deepvision_tpu_torch.serve import InferenceEngine
    from deepvision_tpu_torch.serve.telemetry import ServeTelemetry

    xs = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    traces = [f"{i:016x}" for i in range(1, 6)]
    eng = InferenceEngine([_port_toy()], buckets=(1, 4),
                          telemetry=ServeTelemetry(Registry()))
    jeng = JaxEngine([toy_model()], mesh=create_mesh(1, 1), buckets=(1, 4))
    with eng, jeng, _captured(get_tracer(), jax_trace.get_tracer()) as (
            cap, jcap):
        got = _traced_run(eng, xs, traces, "toy", 5, cap)
        want = _traced_run(jeng, xs, traces, "toy", 5, jcap)
    assert got == want
    port, jax_spans = (_spans(c.records, set(traces)) for c in (cap, jcap))
    assert sorted(port) == sorted(jax_spans)
    assert [s[0] for s in port].count("device") == 2
    assert ("device", json.dumps({"bucket": 4, "model": "toy", "rows": 4},
                                 sort_keys=True), tuple(traces[:4])) in port
    recs = {(r["name"], (r.get("args") or {}).get("trace")): r
            for r in cap.records}
    device = [r for r in cap.records if r["name"] == "device"
              and traces[0] in r["args"]["traces"]][0]
    queue = recs[("replica_queue", traces[0])]
    assert queue["ts"] + queue["dur"] <= device["ts"] + 1e-9


def test_pipeline_stage_spans_equal_jax_in_dag_order():
    """The toy ``detpose`` DAG at entry buckets 1 and 4 in both engines:
    the same ``device``, ``stage:<node>``, ``replica_queue`` and
    ``postprocess`` spans, the stages in DAG order, each inside its
    batch's ``device`` span, their sum no more than it."""
    from tests.test_torch_pipeline import entry_image, make_engines

    eng, pipe, jeng, _ = make_engines()
    xs = [entry_image(i) for i in range(5)]
    traces = [f"{i:016x}" for i in range(11, 16)]
    with eng, jeng, _captured(get_tracer(), jax_trace.get_tracer()) as (
            cap, jcap):
        got = _traced_run(eng, xs, traces, "detpose", 5, cap)
        _traced_run(jeng, xs, traces, "detpose", 5, jcap)
    assert [len(a["posestage"]) for a in got] == [2] * 5
    port, jax_spans = (_spans(c.records, set(traces)) for c in (cap, jcap))
    assert sorted(port) == sorted(jax_spans)
    nodes = ["detect", "people", "crop", "posestage"]
    for spans in (port, jax_spans):
        stages = [name for name, _, _ in spans if name.startswith("stage:")]
        assert stages == [f"stage:{n}" for n in nodes] * 2
    devices = [r for r in cap.records if r["name"] == "device"
               and set(r["args"].get("traces", ())) & set(traces)]
    stages = [r for r in cap.records if r["name"].startswith("stage:")
              and set(r["args"]["traces"]) & set(traces)]
    for k, dev in enumerate(devices):
        mine = stages[4 * k:4 * k + 4]
        assert [r["args"]["traces"] for r in mine] == [
            dev["args"]["traces"]] * 4
        end = dev["ts"] + dev["dur"]
        last = dev["ts"]
        for r in mine:
            assert last <= r["ts"] and r["ts"] + r["dur"] <= end
            last = r["ts"] + r["dur"]
        assert sum(r["dur"] for r in mine) <= dev["dur"]


def test_take_stage_stamps_places_graph_events_from_the_replay_stamp():
    """The graph path's arithmetic, with stand-in events: each stage at
    the replay's host stamp plus its events' ``elapsed_time`` from the
    first stage's start, in DAG order; the stamps are consumed."""
    from tests.test_torch_pipeline import make_engines

    class _Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, other):
            return other.ms - self.ms

    eng, pipe, jeng, _ = make_engines()
    eng.close()
    jeng.close()
    events = tuple((n, _Event(a), _Event(b)) for n, a, b in (
        ("detect", 2.0, 5.0), ("people", 5.5, 6.0), ("crop", 6.0, 7.5)))
    forward = pipe.program(4).forward
    pipe._last_replay = None
    forward.after_replay(100.0)
    assert pipe._last_replay == (100.0, [])
    pipe._last_replay = (100.0, events)
    got = pipe.take_stage_stamps()
    assert [n for n, _, _ in got] == ["detect", "people", "crop"]
    assert [t for _, a, b in got for t in (a, b)] == pytest.approx(
        [100.0, 100.003, 100.0035, 100.004, 100.004, 100.0055])
    assert pipe.take_stage_stamps() == []


def test_stateful_spans_carry_the_session_like_jax(tmp_path):
    """Two streams of 6 frames with trace ids through the JAX tracking
    engine and the port's: the same ``device`` spans (mode, sessions)
    and the same ``replica_queue`` and ``postprocess`` spans, each with
    its frame's session."""
    from tests.test_torch_sessions import _frames, _tracking_engine

    frames = _frames(12, 3)
    sids = [("s1", "s2")[i % 2] for i in range(12)]
    seqs = [i // 2 for i in range(12)]
    traces = [f"{i:016x}" for i in range(21, 33)]
    eng, _ = _tracking_engine("port", tmp_path / "port")
    jeng, _ = _tracking_engine("jax", tmp_path / "jax")
    try:
        with _captured(get_tracer(), jax_trace.get_tracer()) as (cap, jcap):
            _traced_run(eng, frames, traces, "track", 12, cap,
                        session=sids, seq=seqs)
            _traced_run(jeng, frames, traces, "track", 12, jcap,
                        session=sids, seq=seqs)
    finally:
        eng.close()
        jeng.close()
    port, jax_spans = (_spans(c.records, set(traces)) for c in (cap, jcap))
    assert sorted(port) == sorted(jax_spans)
    for name, args, ids in port:
        args = json.loads(args)
        if name == "device":
            assert args["sessions"] == ["s1", "s2"], args
            assert args["mode"] in ("detect", "interp")
        else:
            assert args["session"] == sids[traces.index(ids[0])]
    assert sum(name == "device" for name, _, _ in port) == 6


def test_dispatcher_crash_dumps_the_flight_recorder_like_jax(tmp_path):
    """A crash of the dispatcher (``crash@0``) dumps the process's flight
    recorder as ``dispatcher_crash`` before the batch fails, in both
    engines."""
    from tests.test_router import toy_model

    from deepvision_tpu.core.mesh import create_mesh
    from deepvision_tpu.resilience import FaultInjector as JaxInjector
    from deepvision_tpu.serve import InferenceEngine as JaxEngine
    from deepvision_tpu_torch.resilience.faults import FaultInjector
    from deepvision_tpu_torch.serve import InferenceEngine

    sides = (
        (distributed, lambda: InferenceEngine(
            [_port_toy()], buckets=(1,), restart_backoff_s=0.01,
            fault_injector=FaultInjector("crash@0"))),
        (jax_distributed, lambda: JaxEngine(
            [toy_model()], mesh=create_mesh(1, 1), buckets=(1,),
            restart_backoff_s=0.01, fault_injector=JaxInjector("crash@0"))))
    for mod, build in sides:
        d = tmp_path / mod.__name__
        mod.install_flight_recorder(d, meta={"role": "crashy"})
        try:
            with build() as eng:
                fut = eng.submit(np.ones(3, np.float32), model="toy",
                                 trace="cd" * 8)
                with pytest.raises(RuntimeError, match="dispatcher crashed"):
                    fut.result(timeout=30)
        finally:
            mod.install_flight_recorder(None)
        # the dump's tag is the process's role label when one is set (an
        # in-process CLI run sets one), else the recorder's own
        (dump,) = d.glob("flightrec-*-dispatcher_crash-*.json")
        body = json.loads(dump.read_text())
        assert body["reason"] == "dispatcher_crash"
        assert body["meta"] == {"role": "crashy"}
        assert "serve_dispatcher_crashes" in body["snapshot"]


# --------------------------------------------------- the trace id's hop


def _port_fleet(n=1):
    from deepvision_tpu_torch.serve import EngineReplica, FleetRouter

    def factory(sid):
        return EngineReplica(sid, lambda: [_port_toy()], buckets=(1, 4))

    return FleetRouter(factory, replicas=n, models=["toy"],
                       probe_interval_s=0.05)


def test_trace_id_propagates_router_to_engine_replica():
    """Twin of ``tests/test_obs_distributed.py:52``: one routed request's
    ``router_attempt`` span and the replica's ``replica_queue``,
    ``device`` and ``postprocess`` spans share one trace id."""
    with _captured(get_tracer()) as (cap,):
        with _port_fleet() as router:
            fut = router.submit(np.ones(3, np.float32), model="toy")
            assert fut.result(timeout=10)["y"] == [2.5] * 3
            _wait_for(lambda: any(r["name"] == "postprocess"
                                  for r in cap.records))
    by_name: dict = {}
    for r in cap.records:
        by_name.setdefault(r["name"], []).append(r)
    tid = by_name["router_attempt"][0]["args"]["trace"]
    assert len(tid) == 16
    assert by_name["replica_queue"][0]["args"]["trace"] == tid
    assert tid in by_name["device"][0]["args"]["traces"]
    assert by_name["postprocess"][0]["args"]["trace"] == tid


def test_explicit_trace_id_wins_over_minted():
    """Twin of ``tests/test_obs_distributed.py:90``."""
    with _captured(get_tracer()) as (cap,):
        with _port_fleet() as router:
            router.submit(np.ones(3, np.float32), model="toy",
                          trace="cafecafecafecafe").result(timeout=10)
            _wait_for(lambda: any(r["name"] == "postprocess"
                                  for r in cap.records))
    attempts = [r for r in cap.records if r["name"] == "router_attempt"]
    assert attempts[0]["args"]["trace"] == "cafecafecafecafe"
    assert [r["args"]["trace"] for r in cap.records
            if r["name"] == "replica_queue"] == ["cafecafecafecafe"]


def test_router_probe_notes_reach_the_flight_recorder(tmp_path):
    """The router's probe tick notes ``probe`` with ``replicas_ready``
    into the process's flight recorder, as the JAX router does."""
    distributed.install_flight_recorder(tmp_path, meta={"role": "router"})
    try:
        with _port_fleet(n=2):
            rec = distributed.get_flight_recorder()
            _wait_for(lambda: any(
                e.get("label") == "probe" for e in rec._ring))
            path = rec.dump("test")
    finally:
        distributed.install_flight_recorder(None)
    notes = [e for e in json.loads(path.read_text())["events"]
             if e["kind"] == "note"]
    assert notes[0]["label"] == "probe" and notes[0]["replicas_ready"] == 2


def test_cross_stage_trace_flow_assert_flow(tmp_path):
    """Twin of ``tests/test_pipeline.py:462``: a router's spool and the
    live engine's merge into one timeline whose flow crosses from the
    router's row into the engine's, every ``stage:<node>`` span on it,
    and the port's ``trace_merge --assert-flow`` passes."""
    from tests.test_torch_pipeline import entry_image, make_engines

    tid = "ab12" * 8
    router_tracer = Tracer()
    router_tracer.set_labels(role="router")
    rspool = SpanSpool(tmp_path, role="router", tracer=router_tracer)
    eng, _, jeng, _ = make_engines()  # warm before spooling
    jeng.close()
    gspool = SpanSpool(tmp_path, role="r1", tracer=get_tracer())
    try:
        with eng:
            t0 = time.perf_counter()
            res = eng.submit(entry_image(), model="detpose",
                             trace=tid).result(timeout=60)
            router_tracer.record_span(
                "router_attempt", t0, time.perf_counter(), cat="router",
                args={"trace": tid, "replica": "r1"})
            _wait_for(lambda: "postprocess" in gspool.path.read_text())
        assert len(res["posestage"]) == 2
    finally:
        gspool.close()
        rspool.close()
    merged = trace_merge.merge(trace_merge.collect(tmp_path))
    names = {e["name"] for e in merged["traceEvents"] if e.get("ph") == "X"}
    for stage in ("detect", "people", "crop", "posestage"):
        assert f"stage:{stage}" in names
    assert {"router_attempt", "replica_queue", "device"} <= names
    assert trace_merge.cross_process_requests(merged) >= 1
    assert trace_merge.main([
        str(tmp_path), "--assert-flow", "--assert-spans",
        "router_attempt,device,stage:detect,stage:posestage"]) == 0
    assert trace_merge.main([str(tmp_path / "empty")]) == 1
