"""The port's runner cache, supervisor and HTTP front against the JAX
serving stack, on the CPU.

``lenet5`` at 32x32x1 (10 classes) is served by the JAX
``InferenceEngine`` and by the port's on the same weights, carried
across by ``convert.from_flax``, on the ladder (1, 4). The tests hold
the port to its twin:

- (a) both ``CompileCache``s, driven with one key sequence, report the
  same ``stats()`` at every step (eviction, ``install`` on a frozen
  cache, the miss that a frozen cache refuses);
- (b) after the warm-up, mixed batch sizes move neither engine's
  ``misses``, and a frozen cache refuses a cold bucket in both;
- (c) under one ``crash@1`` schedule the same request fails with
  ``RuntimeError`` in both, both count one crash and one restart, and
  both report ``recovering`` and then ``ok``;
- (d) ``serve.make_handler`` and the port's ``make_handler`` on
  ephemeral ports answer the same ``/v1/predict`` requests with the same
  classes and probabilities within 1e-5 (the float32 tolerance of
  ``tests/test_torch_serve.py``), and the 400, 404, 429, 500, 503 and
  504 paths alike, with ``Retry-After`` where the JAX front sends it;
- (e) the port's CLI with ``--http 0 --port-file F --faults crash@1``
  as a process: 200, the crashed batch 500, ``/healthz`` 503 then 200,
  ``/stats`` with one crash and one restart and frozen misses,
  ``/metrics``, and exit 0 on SIGINT.

Besides: the CPU's bucket runner pads a short batch as the engine does;
``ops.credit_launches`` adds kernel launches (what a CUDA graph's replay
does on the card, where ``chip_smoke.py`` holds the graphs to the eager
forward and finds each replay's kernels in a profiler trace) and refuses
to take any back; ``ops.note_captured`` keeps a capture's wrapper calls
apart from launches, by thread.

The supervisor's backoff is 0.5 s where a test watches ``recovering``
(long enough for a poll to see it), 1 s for the CLI process (whose
``/healthz`` is read once after the crashed batch's 500).
"""

import argparse
import base64
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import serve as jax_serve_cli  # noqa: E402
from deepvision_tpu.core.mesh import create_mesh  # noqa: E402
from deepvision_tpu.resilience import FaultInjector as JaxFaultInjector  # noqa: E402
from deepvision_tpu.serve import CompileCache as JaxCompileCache  # noqa: E402
from deepvision_tpu.serve import InferenceEngine as JaxEngine  # noqa: E402
from deepvision_tpu.serve.models import load_served as jax_load_served  # noqa: E402
from deepvision_tpu_torch.obs.distributed import read_spool  # noqa: E402
from deepvision_tpu_torch.resilience.faults import FaultInjector  # noqa: E402
from deepvision_tpu_torch.serve import (  # noqa: E402
    CompileCache,
    InferenceEngine,
    load_served,
)
from deepvision_tpu_torch.serve.http import make_handler, make_server  # noqa: E402
from tests.torch_threads import (  # noqa: E402,F401  (autouse)
    share_cores_among_workers,
)

MODEL, SIZE, CLASSES = "lenet5", 32, 10
BUCKETS = (1, 4)
PROB_TOL = 1e-5


def _requests(n, seed=0):
    return (np.random.default_rng(seed).uniform(0, 1, (n, SIZE, SIZE, 1))
            .astype(np.float32))


@pytest.fixture(scope="module")
def jax_served():
    return jax_load_served(MODEL, input_size=SIZE, num_classes=CLASSES)


@pytest.fixture(scope="module")
def served(jax_served):
    variables = jax.tree_util.tree_map(np.asarray, jax_served.variables)
    return load_served(MODEL, variables=variables, device="cpu",
                       input_size=SIZE, num_classes=CLASSES)


def _jax_engine(jax_served, **kw):
    return JaxEngine([jax_served], mesh=create_mesh(1, 1), buckets=BUCKETS,
                     **kw)


def _port_engine(served, **kw):
    return InferenceEngine([served], buckets=BUCKETS, **kw)


def _same_answer(got: dict, want: dict) -> None:
    assert got["classes"] == want["classes"], (got, want)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=PROB_TOL)


# ------------------------------------------------------------- (a) cache


def _drive(cache) -> list:
    """One key sequence through ``cache``: each step's stats, or the
    error it raised."""
    def build(key):
        return lambda: (lambda x: (key, x))

    steps = []

    def step(fn):
        try:
            fn()
            steps.append(cache.stats())
        except RuntimeError as e:
            steps.append(("raised", "frozen" in str(e), cache.stats()))

    for key in ("a", "b", "a", "c", "b", "d", "c"):  # hits, misses, evictions
        step(lambda key=key: cache.get_or_build(key, build(key)))
    step(lambda: cache.install("e", lambda x: x))
    step(lambda: cache.drop_where(lambda k: k == "c"))
    step(cache.freeze)
    step(lambda: cache.get_or_build("d", build("d")))  # a frozen hit
    step(lambda: cache.get_or_build("z", build("z")))  # a frozen miss
    step(lambda: cache.install("f", lambda x: x))      # install still works
    steps.append((cache.contains("f"), cache.contains("a"), len(cache)))
    return steps


def test_compile_cache_stats_equal_jax_at_every_step():
    mine, theirs = _drive(CompileCache(3)), _drive(JaxCompileCache(3))
    assert mine == theirs
    assert ("raised", True, mine[-3][2]) == mine[-3]  # the frozen miss
    with pytest.raises(ValueError):
        CompileCache(0)


# --------------------------------------------------- (b) warm-up, misses


def _serve_sizes(eng, xs, sizes) -> list:
    answers, i = [], 0
    for n in sizes:
        eng.pause()
        futs = [eng.submit(x) for x in xs[i:i + n]]
        eng.resume()
        answers += [f.result(timeout=60) for f in futs]
        i += n
    return answers


def test_traffic_after_warm_moves_no_misses_in_either_engine(jax_served,
                                                             served):
    sizes = (1, 3, 4, 2, 1)
    xs = _requests(sum(sizes), seed=1)
    got = {}
    for label, make in (("jax", _jax_engine), ("port", _port_engine)):
        with make(jax_served if label == "jax" else served,
                  freeze_cache=True) as eng:
            warm = eng.stats()["cache"]
            answers = _serve_sizes(eng, xs, sizes)
            after = eng.stats()["cache"]
            with pytest.raises(RuntimeError, match="frozen"):
                eng._bucket_runner(eng._models[MODEL], 8)  # off the ladder
        got[label] = (warm, after, answers)
    (jwarm, jafter, jans), (pwarm, pafter, pans) = got["jax"], got["port"]
    assert pwarm == jwarm and pafter == jafter
    assert pwarm["misses"] == pafter["misses"] == len(BUCKETS)
    assert pafter["hits"] >= len(sizes) and pafter["frozen"]
    for p, j in zip(pans, jans):
        _same_answer(p, j)


def test_runner_stats_on_the_cpu(served):
    with _port_engine(served) as eng:
        runners = eng.stats()["runners"]
        key = eng._model_key(served, 1)
    assert runners[MODEL]["kind"] == "eager"
    assert runners[MODEL]["pool_bytes"] == 0
    assert set(runners[MODEL]["buckets"]) == {"1", "4"}
    assert key == (MODEL, 1, "float32", served.weights_fingerprint())
    assert len(key[3]) == 16
    assert eng.stats()["runners"] == {}  # close() dropped them


def test_cpu_runner_pads_a_short_batch_and_refuses_a_long_one(served):
    runner = served.compile_for(4)
    x = _requests(3, seed=5)
    padded = np.zeros((4, SIZE, SIZE, 1), np.float32)
    padded[:3] = x
    got, want = runner(x), served.run(padded)
    assert runner.kind == "eager" and runner.launches == {}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="runner of"):
        runner(_requests(5))


def test_credit_launches_adds_and_takes_back():
    from deepvision_tpu_torch.ops import credit_launches, kernel_launches

    before = kernel_launches()
    credit_launches({"lrn_forward_f32": 2, "nms_sweep": 1})
    after = kernel_launches()
    assert after["lrn_forward_f32"] == before["lrn_forward_f32"] + 2
    assert after["nms_sweep"] == before["nms_sweep"] + 1
    # a count changes only where a kernel launches: none is taken back
    with pytest.raises(ValueError, match="-1 times"):
        credit_launches({"lrn_forward_f32": -1})
    with pytest.raises(ValueError, match="ycc_to_rgb"):
        credit_launches({"ycc_to_rgb": 1})
    assert kernel_launches() == after
    _restore_launches(before)


def _restore_launches(counts: dict) -> None:
    from deepvision_tpu_torch.ops.lrn_cuda import local_response_norm_cuda
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    for name in ("lrn_forward_f32", "lrn_forward_bf16"):
        local_response_norm_cuda.launches_by_kernel[name] = counts[name]
    local_response_norm_cuda.launches = sum(
        local_response_norm_cuda.launches_by_kernel.values())
    nms_sweep_cuda.launches = counts["nms_sweep"]


def test_captured_calls_are_not_launches_and_stay_in_their_thread():
    import threading

    from deepvision_tpu_torch.ops import (
        captured_launches,
        kernel_launches,
        note_captured,
    )

    launched, mine = kernel_launches(), captured_launches()
    note_captured("lrn_forward_f32")
    note_captured("nms_sweep")
    note_captured("nms_sweep")
    other = {}
    thread = threading.Thread(target=lambda: (
        note_captured("lrn_forward_f32"),
        other.update(captured_launches())))
    thread.start()
    thread.join()
    got = captured_launches()
    assert got["lrn_forward_f32"] == mine.get("lrn_forward_f32", 0) + 1
    assert got["nms_sweep"] == mine.get("nms_sweep", 0) + 2
    assert other == {"lrn_forward_f32": 1}
    assert kernel_launches() == launched


# ---------------------------------------------------- (c) the supervisor


def _await_status(eng, want: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while eng.health()["status"] != want:
        assert time.monotonic() < deadline, (want, eng.health())
        time.sleep(0.002)


def _await_counted(eng, n: int, timeout: float = 10.0) -> None:
    """Wait until ``eng`` has counted ``n`` resolved requests: an engine
    resolves a future before it counts the request."""
    deadline = time.monotonic() + timeout
    while True:
        tel = eng.stats()["telemetry"]
        if tel["completed"] + tel["failed"] >= n:
            return
        assert time.monotonic() < deadline, tel
        time.sleep(0.002)


def _crash_drill(eng) -> dict:
    """crash@1: the first batch answers, the second fails; the engine
    goes recovering, then ok, and answers again."""
    x = _requests(3, seed=2)
    first = eng.submit(x[0]).result(timeout=60)
    with pytest.raises(RuntimeError, match="dispatcher crashed"):
        eng.submit(x[1]).result(timeout=60)
    _await_status(eng, "recovering")
    health = eng.health()
    _await_status(eng, "ok")
    third = eng.submit(x[2]).result(timeout=60)
    _await_counted(eng, 3)
    tel = eng.stats()["telemetry"]
    return {"answers": (first, third), "health": health,
            "counts": (tel["dispatcher_crashes"],
                       tel["dispatcher_restarts"], tel["failed"],
                       tel["completed"]),
            "ok": eng.health()}


def test_crash_fails_the_batch_and_recovers_like_jax(jax_served, served):
    with _jax_engine(jax_served, fault_injector=JaxFaultInjector("crash@1"),
                     restart_backoff_s=0.5) as eng:
        theirs = _crash_drill(eng)
    with _port_engine(served, fault_injector=FaultInjector("crash@1"),
                      restart_backoff_s=0.5) as eng:
        mine = _crash_drill(eng)
    assert mine["counts"] == theirs["counts"] == (1, 1, 1, 2)
    for p, j in zip(mine["answers"], theirs["answers"]):
        _same_answer(p, j)
    for h in (mine["health"], theirs["health"]):
        assert h["status"] == "recovering" and 0 < h["retry_after_s"] <= 0.5
        assert h["dispatcher_crashes"] == 1
    assert mine["ok"] == theirs["ok"] == {
        "status": "ok", "dispatcher_crashes": 1, "dispatcher_restarts": 1}


def test_close_during_backoff_is_prompt_and_fails_the_backlog(served):
    eng = _port_engine(served, fault_injector=FaultInjector("crash@0"),
                       restart_backoff_s=30.0)
    with pytest.raises(RuntimeError, match="dispatcher crashed"):
        eng.submit(_requests(1)[0]).result(timeout=60)
    late = eng.submit(_requests(1)[0])  # queued while the loop is down
    t0 = time.monotonic()
    eng.close()
    assert time.monotonic() - t0 < 5.0
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="engine closed"):
        late.result(timeout=10)


# --------------------------------------------------------- (d) HTTP front


class _Front:
    """A handler on an ephemeral-port server, served from a thread."""

    def __init__(self, handler):
        self.server = make_server(("127.0.0.1", 0), handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.conn = http.client.HTTPConnection(
            "127.0.0.1", self.server.server_address[1], timeout=60)

    def call(self, method, path, body=None):
        self.conn.request(method, path,
                          None if body is None else json.dumps(body))
        resp = self.conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type", "")
        payload = json.loads(data) if "json" in ctype else data.decode()
        return resp.status, resp.getheader("Retry-After"), payload

    def close(self):
        self.conn.close()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def _both(jax_handler, port_handler):
    return _Front(jax_handler), _Front(port_handler)


def _b64(x):
    return {"input_b64": base64.b64encode(x.tobytes()).decode(),
            "shape": list(x.shape)}


def test_http_fronts_answer_alike(jax_served, served):
    args = argparse.Namespace(timeout_s=10.0)
    xs = _requests(3, seed=3)
    jeng = _jax_engine(jax_served, max_queue=1)
    peng = _port_engine(served, max_queue=1)
    fronts = _both(jax_serve_cli.make_handler(jeng, args),
                   make_handler(peng, args))
    try:
        out = {}
        for label, front, eng in (("jax", fronts[0], jeng),
                                  ("port", fronts[1], peng)):
            r = {}
            r["json"] = front.call("POST", "/v1/predict",
                                   {"model": MODEL,
                                    "input": xs[0].tolist()})
            r["b64"] = front.call("POST", "/predict",
                                  {"model": MODEL, **_b64(xs[1])})
            r["deadline_ok"] = front.call(
                "POST", "/v1/predict",
                {"input": xs[2].tolist(), "timeout_s": 5.0})
            _await_counted(eng, 3)
            r["healthz"] = front.call("GET", "/healthz")
            r["stats"] = front.call("GET", "/stats")
            r["metrics"] = front.call("GET", "/metrics")
            r["bad_input"] = front.call("POST", "/v1/predict",
                                        {"model": MODEL, "input": "bad"})
            r["not_object"] = front.call("POST", "/v1/predict", [1, 2])
            r["bad_deadline"] = front.call(
                "POST", "/v1/predict",
                {"input": xs[0].tolist(), "timeout_s": 0})
            r["bad_shape"] = front.call("POST", "/v1/predict",
                                        {"input": [1.0, 2.0]})
            r["bad_model"] = front.call("POST", "/v1/predict",
                                        {"model": "nope",
                                         "input": xs[0].tolist()})
            r["get_404"] = front.call("GET", "/nope")
            eng.pause()
            try:
                r["deadline"] = front.call(
                    "POST", "/v1/predict",
                    {"input": xs[0].tolist(), "timeout_s": 0.3})
                # the paused engine still holds that request in its one
                # queue slot, so the next one is shed
                r["shed"] = front.call("POST", "/v1/predict",
                                       {"input": xs[2].tolist()})
            finally:
                eng.resume()
            # last: neither front reads the body of a POST it refuses
            r["post_404"] = front.call("POST", "/v1/nope", {})
            out[label] = r
    finally:
        for f in fronts:
            f.close()
        jeng.close()
        peng.close()
    mine, theirs = out["port"], out["jax"]
    for key in ("json", "b64", "deadline_ok"):
        assert mine[key][0] == theirs[key][0] == 200, key
        _same_answer(mine[key][2]["result"], theirs[key][2]["result"])
    assert mine["healthz"] == theirs["healthz"]
    assert mine["healthz"][0] == 200 and mine["healthz"][2]["models"] == [
        MODEL]
    assert mine["stats"][0] == theirs["stats"][0] == 200
    assert mine["stats"][2]["cache"] == theirs["stats"][2]["cache"]
    assert mine["metrics"][0] == theirs["metrics"][0] == 200
    assert "serve_completed_total 3" in mine["metrics"][2]
    for key, code in (("bad_input", 400), ("not_object", 400),
                      ("bad_deadline", 400), ("bad_shape", 400),
                      ("bad_model", 400), ("get_404", 404),
                      ("post_404", 404), ("deadline", 504),
                      ("shed", 429)):
        assert mine[key][0] == theirs[key][0] == code, (key, mine[key],
                                                        theirs[key])
    assert mine["get_404"] == theirs["get_404"]
    assert mine["shed"][1] is not None and theirs["shed"][1] is not None
    assert float(mine["shed"][1]) > 0
    assert mine["shed"][2]["retry_after"] > 0


class _StubEngine:
    """An engine whose health and submit say what a test needs: the
    recovering window and the crashed dispatcher, without a timing
    window."""

    def __init__(self, status: str):
        self._status = status

    def health(self):
        out = {"status": self._status, "dispatcher_crashes": 1,
               "dispatcher_restarts": 0}
        if self._status == "recovering":
            out["retry_after_s"] = 1.3
        return out

    def stats(self):
        return {"models": [MODEL]}

    def submit(self, *a, **kw):
        raise RuntimeError("dispatcher crashed: InjectedCrash: injected")


@pytest.mark.parametrize("status,code", [("ok", 200), ("recovering", 503)])
def test_http_healthz_and_crash_codes_equal_jax(status, code):
    args = argparse.Namespace(timeout_s=1.0)
    eng = _StubEngine(status)
    fronts = _both(jax_serve_cli.make_handler(eng, args),
                   make_handler(eng, args))
    try:
        got = [(f.call("GET", "/healthz"),
                f.call("POST", "/v1/predict", {"input": [1.0]}))
               for f in fronts]
    finally:
        for f in fronts:
            f.close()
    assert got[0] == got[1]
    (status_code, retry_after, body), crashed = got[1]
    assert status_code == code and body["status"] == status
    assert retry_after == ("2" if code == 503 else None)
    assert crashed[0] == 500 and "dispatcher crashed" in crashed[2]["error"]


# ------------------------------------------------- (e) the CLI process


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/predict", json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def test_cli_http_process_survives_a_crash(tmp_path):
    port_file = tmp_path / "port"
    log = tmp_path / "serve.log"
    cmd = [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m", MODEL,
           "--device", "cpu", "--seed", "0", "--buckets", "1,4", "--http",
           "0", "--port-file", str(port_file), "--faults", "crash@1",
           "--restart-backoff-s", "1.0"]
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=REPO, stderr=err,
                                stdout=subprocess.DEVNULL,
                                env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists():
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.05)
        port = int(port_file.read_text())
        xs = _requests(3, seed=4)
        want = load_served(MODEL, seed=0, device="cpu").run(xs)
        first = _post(port, {"input": xs[0].tolist()})
        crashed = _post(port, _b64(xs[1]))
        recovering = _get(port, "/healthz")  # set before the 500 was sent
        deadline = time.monotonic() + 30
        while _get(port, "/healthz")[0] != 200:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        third = _post(port, _b64(xs[2]))
        stats = json.loads(_get(port, "/stats")[2])
        metrics = _get(port, "/metrics")
    finally:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(60)
    text = log.read_text()
    assert rc == 0, text
    assert first[0] == 200 and third[0] == 200
    assert first[1]["result"]["classes"] == want["classes"][0].tolist()
    assert third[1]["result"]["classes"] == want["classes"][2].tolist()
    assert crashed[0] == 500 and "dispatcher crashed" in crashed[1]["error"]
    assert recovering[0] == 503 and recovering[1] == "1"
    assert json.loads(recovering[2])["status"] == "recovering"
    tel, cache = stats["telemetry"], stats["cache"]
    assert (tel["dispatcher_crashes"], tel["dispatcher_restarts"]) == (1, 1)
    assert cache["misses"] == cache["entries"] == 2 and cache["frozen"]
    assert metrics[0] == 200
    assert b"serve_dispatcher_crashes_total 1" in metrics[2]
    last = text.strip().splitlines()[-1]
    assert "dispatcher_crashes=1 dispatcher_restarts=1" in last, last
    assert "kernel launches {" in last, last


def test_cli_http_process_exits_143_on_sigterm_with_its_last_line(tmp_path):
    """SIGTERM (what a fleet router sends a replica it stops) dumps the
    flight recorder, closes the engine and prints the ``[serve]`` line
    before the process exits with 143, as ``serve.py`` turns it into
    ``SystemExit(143)``; with ``--trace-spool`` the request's spans are in
    the spool and the dump (``flightrec-replica-signal-15-*.json``) lies
    beside it."""
    port_file = tmp_path / "port"
    log = tmp_path / "serve.log"
    obs = tmp_path / "obs"
    cmd = [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m", MODEL,
           "--device", "cpu", "--seed", "0", "--buckets", "1", "--http",
           "0", "--port-file", str(port_file), "--trace-spool", str(obs)]
    with open(log, "w") as err:
        proc = subprocess.Popen(cmd, cwd=REPO, stderr=err,
                                stdout=subprocess.DEVNULL,
                                env={**os.environ, "PYTHONPATH": str(REPO)})
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists():
            assert proc.poll() is None, log.read_text()
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.05)
        port = int(port_file.read_text())
        answered = _post(port, _b64(_requests(1, seed=5)[0]))
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    text = log.read_text()
    assert answered[0] == 200
    assert rc == 143, text
    last = text.strip().splitlines()[-1]
    assert last.startswith("[serve] completed=1 batches=1 failed=0"), last
    assert "kernel launches {" in last, last
    (dump,) = obs.glob("flightrec-replica-signal-15-*.json")
    body = json.loads(dump.read_text())
    assert body["labels"] == {"role": "replica"}
    assert "device" in {e.get("name") for e in body["events"]}
    assert body["snapshot"]["serve_completed"] == 1
    (spool,) = obs.glob("trace-spool-replica-*.jsonl")
    assert "device" in {e["name"] for e in read_spool(spool)["events"]}
