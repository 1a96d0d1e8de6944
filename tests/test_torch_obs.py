"""The port's observability (``deepvision_tpu_torch/obs``) and the
resilient training CLI's flags, on the CPU.

Held against ``deepvision_tpu/obs``: the Prometheus text and the JSON
snapshot of the registry after the same operations, the registry's
refusals, ``summarize_chrome``'s summary of one trace file (written by
the port's tracer), the profiler window's spec refusals; and against
``train.py``: the defaults of every flag the port's CLI took over.
Port-only: the ring buffer's dropped-span count, the tracer's no-op
while disabled and ``device_sync`` on the CPU, the ``torch.profiler``
window's trace file, the memory gauges' ``{}`` on the CPU, a traced
training run's spans (``fetch``, ``step``, ``eval``, ``checkpoint``, by
count; their share of the epochs is a timing, held on the card by
``chip_smoke.py``), the trace summary's CLI, an SDC drill
rolled back by the sentinel and exiting 76 without ``--recover``, and
the CLI's refusals.
"""

import importlib.util
import json
import re
import shutil
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from deepvision_tpu.obs import metrics as jax_metrics
from deepvision_tpu.obs import profiler as jax_profiler
from deepvision_tpu.obs import trace as jax_trace
from deepvision_tpu_torch.obs import metrics, profiler
from deepvision_tpu_torch.obs import trace as port_trace
from deepvision_tpu_torch.obs.__main__ import main as summary_main
from deepvision_tpu_torch.obs.trace import Tracer, summarize_chrome
from deepvision_tpu_torch.train.__main__ import main as train_main
from deepvision_tpu_torch.train.__main__ import parse_args
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

REPO = Path(__file__).resolve().parents[1]


def _exercise(reg):
    """One sequence of registry operations."""
    reg.counter("serve_completed").inc(3)
    reg.counter("recovery_rollbacks").inc()
    reg.gauge("mem_bytes_in_use_dev0").set(1.5e9)
    reg.gauge("input_queue_depth").inc(2.0)
    h = reg.histogram("input_h2d_wait", maxlen=16)
    for i in range(40):  # past the reservoir
        h.observe(0.001 * (i % 7) + 0.0005 * i)
    reg.histogram("serve_e2e_latency")  # empty
    reg.register("trace_dropped_spans", type(reg.counter("x"))())
    reg.unregister("x")
    return reg


def test_prometheus_text_and_snapshot_equal_jax():
    mine = _exercise(metrics.Registry())
    theirs = _exercise(jax_metrics.Registry())
    assert mine.render_prometheus() == theirs.render_prometheus()
    assert mine.snapshot() == theirs.snapshot()
    assert mine.dump() == theirs.dump()
    assert mine.names() == theirs.names()
    assert "input_h2d_wait_count 40" in mine.render_prometheus()


@pytest.mark.parametrize("op", [
    lambda r: r.register("bad name", r.counter("a")),
    lambda r: r.register("ok", object()),
    lambda r: (r.counter("a"), r.gauge("a")),
])
def test_registry_refusals_equal_jax(op):
    with pytest.raises((ValueError, TypeError)) as mine:
        op(metrics.Registry())
    with pytest.raises((ValueError, TypeError)) as theirs:
        op(jax_metrics.Registry())
    assert type(mine.value) is type(theirs.value)
    # (an object's repr carries its address)
    assert str(mine.value).split(" at 0x")[0] == \
        str(theirs.value).split(" at 0x")[0]


def test_default_registry_is_one_per_process():
    assert metrics.default_registry() is metrics.default_registry()
    c = metrics.default_registry().counter("test_obs_counter")
    c.inc(2)
    assert metrics.default_registry().value_of("test_obs_counter") >= 2


def _traced(tmp_path) -> Path:
    """A trace written by the port's tracer: nested epoch/step/drain
    spans on the main thread, a producer thread's spans."""
    tracer = Tracer()
    tracer.enable()

    def producer():
        for _ in range(3):
            with tracer.span("host_next", cat="feed"):
                time.sleep(0.002)

    for epoch in range(2):
        with tracer.span("epoch", cat="train", args={"epoch": epoch}):
            t = threading.Thread(target=producer, name="device-prefetch")
            t.start()
            for _ in range(3):
                with tracer.span("fetch", cat="feed"):
                    time.sleep(0.001)
                with tracer.span("step", cat="train"):
                    time.sleep(0.003)
                    with tracer.span("drain", cat="train"):
                        time.sleep(0.001)
            t.join()
        with tracer.span("eval", cat="train"):
            time.sleep(0.002)
        with tracer.span("checkpoint", cat="train"):
            time.sleep(0.001)
    path = tmp_path / "trace.json"
    assert tracer.export(path) == 2 * (1 + 3 * 4 + 1) + 2
    return path


@pytest.mark.parametrize("wall", ["epoch", "nothing"])
def test_summarize_chrome_equals_jax(tmp_path, wall):
    trace = json.loads(_traced(tmp_path).read_text())
    mine = summarize_chrome(trace, wall_span=wall)
    assert mine == jax_trace.summarize_chrome(trace, wall_span=wall)
    assert mine == summarize_chrome(trace["traceEvents"], wall_span=wall)
    assert set(mine["spans"]) == {"epoch", "fetch", "step", "drain",
                                  "host_next", "eval", "checkpoint"}
    assert 0.0 < mine["coverage"] <= 1.0
    assert trace["metadata"]["complete"] is True


def test_trace_summary_cli_prints_the_summary(tmp_path, capsys):
    path = _traced(tmp_path)
    assert summary_main([str(path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == summarize_chrome(json.loads(path.read_text()))


def test_the_ring_counts_what_it_drops(tmp_path):
    tracer = Tracer(capacity=4)
    tracer.enable()
    before = metrics.default_registry().value_of("trace_dropped_spans")
    for _ in range(10):
        with tracer.span("s"):
            pass
    assert len(tracer) == 4 and tracer.dropped_spans == 6
    assert metrics.default_registry().value_of("trace_dropped_spans") \
        == before + 6
    tracer.export(tmp_path / "t.json")
    meta = json.loads((tmp_path / "t.json").read_text())["metadata"]
    assert meta["trace_dropped_spans"] == 6 and not meta["complete"]
    tracer.clear()
    assert len(tracer) == 0 and tracer.dropped_spans == 0


def test_disabled_tracer_hands_out_one_noop_and_device_sync_passes():
    tracer = Tracer()
    assert tracer.span("a") is tracer.span("b")
    x = torch.ones(3)
    with tracer.span("a") as sp:
        assert sp.device_sync(x) is x
    assert len(tracer) == 0
    tracer.enable()
    with tracer.span("step", device_sync={"m": x}) as sp:
        sp.device_sync([x, (x,)])  # CPU tensors: nothing to wait for
    assert len(tracer) == 1
    assert port_trace._cuda_tensors({"m": [x, (x,)]}) == []


def test_profile_window_writes_its_trace_on_the_cpu(tmp_path, capsys):
    window = profiler.ProfileWindow("1:2", tmp_path / "prof")
    for step in range(5):
        window.on_step(step)
        torch.ones(64, 64) @ torch.ones(64, 64)
    window.close()
    assert window.done and not window.active
    trace = json.loads(window.trace_path.read_text())
    assert trace["traceEvents"]
    out = capsys.readouterr().out
    assert "[obs] profiling steps 1..2 ->" in out
    assert "[obs] profile window closed ->" in out


@pytest.mark.parametrize("spec", ["3", "a:b", "2:1", "-1:2"])
def test_profile_window_refusals_equal_jax(spec, tmp_path):
    with pytest.raises(ValueError) as mine:
        profiler.ProfileWindow(spec, tmp_path)
    with pytest.raises(ValueError) as theirs:
        jax_profiler.ProfileWindow(spec, tmp_path)
    assert str(mine.value) == str(theirs.value)


def test_memory_gauges_are_empty_on_the_cpu():
    assert profiler.device_memory_stats() == {}
    assert profiler.sample_memory_gauges() == {}
    with profiler.profile_session(None) as live:
        assert live is False


# -------------------------------------------------------- the CLI


def test_traced_run_covers_its_epochs_and_writes_the_profile(tmp_path,
                                                            capsys):
    trace = tmp_path / "trace.json"
    assert train_main(["-m", "lenet5", "--device", "cpu", "--epochs", "2",
                       "--synthetic-size", "160", "--batch-size", "16",
                       "--trace", str(trace), "--profile-steps", "2:3",
                       "--async-checkpoint", "--keep-best",
                       "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"[obs] wrote" in out and "spans to" in out
    summary = summarize_chrome(json.loads(trace.read_text()))
    spans = summary["spans"]
    for name in ("fetch", "step", "eval", "checkpoint", "drain",
                 "host_next", "shard", "profiler"):
        assert name in spans, (name, spans.keys())
    # 2 epochs of 9 steps (160 digits, 16 held out, batch 16); validation
    # before training and after each epoch; a checkpoint an epoch. (The
    # spans' share of the epochs is a timing: the card's run holds it to
    # 95% at full width, chip_smoke.py's phase_resilience.)
    assert spans["epoch"]["count"] == 2 and spans["step"]["count"] == 18
    assert spans["profiler"]["count"] == 18
    assert spans["eval"]["count"] == 3 and spans["checkpoint"]["count"] == 2
    assert spans["fetch"]["count"] >= 18
    assert 0.0 < summary["coverage"] <= 1.0
    assert (tmp_path / "lenet5" / "profile" / "steps_2_3.pt.trace.json"
            ).is_file()
    events = list((tmp_path / "lenet5" / "tb" / "train").iterdir())
    assert events and events[0].name.startswith("events.out.tfevents.")
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_sdc_drill_trips_the_sentinel(tmp_path, capsys):
    """A loud ``sdc_grad`` trips the sentinel's z-score: rolled back with
    ``--recover``, exit 76 without it."""
    common = ["-m", "lenet5", "--device", "cpu", "--epochs", "2",
              "--synthetic-size", "400", "--batch-size", "16", "--sentinel",
              "--sentinel-warmup", "4", "--faults", "sdc_grad@14:8",
              "--workdir"]
    assert train_main([*common, str(tmp_path / "a"), "--recover"]) == 0
    out = capsys.readouterr().out
    assert "[fault] sdc_grad corrupted local state at run step 14" in out
    rollback = re.search(r"^\[rollback\] sentinel (\S+)=.* tripped "
                         r"\(\|z\|=.*\) at epoch 0 step (\d+): restored "
                         r"initial state", out, re.M)
    assert rollback and int(rollback.group(2)) >= 13, out[-3000:]
    assert "[recovery] rollbacks=1 " in out
    with pytest.raises(SystemExit) as exit_:
        train_main([*common, str(tmp_path / "b")])
    assert exit_.value.code == 76
    assert "[sentinel] FATAL: sentinel" in capsys.readouterr().out
    shutil.rmtree(tmp_path, ignore_errors=True)


def _train_py_args(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location("train_py",
                                                  REPO / "train.py")
    train_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_py)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    return train_py.parse_args()


RESILIENCE_FLAGS = (
    "output_bucket", "output_dir", "check_numerics", "async_checkpoint",
    "keep_best", "stall_timeout", "stall_abort", "rss_limit_gb", "recover",
    "max_rollbacks", "lr_rewarm", "faults", "fault_seed", "sentinel",
    "audit_every", "sentinel_z", "sentinel_warmup", "no_ckpt_integrity",
    "data_echo", "trace", "profile_steps", "profile_dir", "loader_workers",
    "max_worker_restarts")


def test_flags_and_defaults_equal_train_py(monkeypatch):
    want = vars(_train_py_args(monkeypatch, ["-m", "alexnet1"]))
    got = vars(parse_args(["-m", "alexnet1"]))
    for flag in RESILIENCE_FLAGS:
        assert got[flag] == want[flag], flag
    argv = ["-m", "resnet50", "--recover", "--max-rollbacks", "5",
            "--lr-rewarm", "0.5", "--faults", "nan@3", "--fault-seed", "2",
            "--sentinel", "--audit-every", "8", "--sentinel-z", "6",
            "--sentinel-warmup", "5", "--async-checkpoint", "--keep-best",
            "--stall-timeout", "30", "--stall-abort", "--rss-limit-gb", "40",
            "--no-ckpt-integrity", "--data-echo", "2", "--trace", "t.json",
            "--profile-steps", "3:5", "--profile-dir", "p",
            "--loader-workers", "4", "--max-worker-restarts", "1",
            "--check-numerics", "--output-bucket", "b", "--output-dir", "d"]
    want = vars(_train_py_args(monkeypatch, argv))
    got = vars(parse_args(argv))
    for flag in RESILIENCE_FLAGS:
        assert got[flag] == want[flag], flag


@pytest.mark.parametrize("flags,message", [
    (["-m", "alexnet1", "--lr-rewarm", "0.5"], "only applies with --recover"),
    (["-m", "alexnet1", "--stall-timeout", "-1"], "--stall-timeout must be"),
    (["-m", "dcgan", "--recover"], "the GAN fit_gan path has no hook"),
    (["-m", "dcgan", "--sentinel"], "the GAN fit_gan path has no hook"),
    (["-m", "cyclegan", "--faults", "nan@1"], "the GAN fit_gan path"),
    (["-m", "dcgan", "--profile-steps", "1:2"], "has no profiler hook"),
])
def test_cli_refusals_equal_train_py(flags, message, tmp_path):
    with pytest.raises(SystemExit, match=message):
        train_main([*flags, "--device", "cpu", "--workdir", str(tmp_path)])


# the resilience slice's modules, which the port's no-JAX guards
# (tests/test_torch_serve.py) must scan; the spawned loader worker's
# entry point (data/loader._worker_main) is among them
RESILIENCE_MODULES = (
    "obs/__init__.py", "obs/__main__.py", "obs/metrics.py", "obs/trace.py",
    "obs/profiler.py", "resilience/__init__.py", "resilience/faults.py",
    "resilience/recovery.py", "resilience/sentinel.py", "data/loader.py",
    "train/publish.py")


def test_the_no_jax_guards_scan_the_resilience_slice():
    from tests.test_torch_serve import _port_files

    package = REPO / "deepvision_tpu_torch"
    scanned = {p.relative_to(package).as_posix() for p in _port_files()
               if package in p.parents}
    assert set(RESILIENCE_MODULES) <= scanned
    from deepvision_tpu_torch.data import loader

    assert loader._worker_main.__module__ == "deepvision_tpu_torch.data.loader"
