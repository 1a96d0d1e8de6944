"""The port's serving slice on the CPU, against the JAX serving path.

A port ``InferenceEngine`` on ``device="cpu"`` answers requests with the
weights of the JAX ``load_served("alexnet1")`` carried across; classes
must be identical and probabilities within 1e-5. The rest pins the
engine's contracts (padding, deadlines, shedding, failure containment,
close), the CLI's JSONL wire, and the port's guards: no JAX import, and
no quiet CPU run when no device is named.
"""

import ast
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deepvision_tpu.serve.models import load_served as jax_load_served
from deepvision_tpu_torch import device as port_device
from deepvision_tpu_torch.serve import (
    InferenceEngine,
    ServedModel,
    ShedError,
    load_served,
)
from deepvision_tpu_torch.serve.__main__ import main as serve_main
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

REPO = Path(__file__).resolve().parents[1]
SIZE, CLASSES = 64, 10


def _requests(n, seed=0):
    return (np.random.default_rng(seed).normal(0, 1, (n, SIZE, SIZE, 3))
            .astype(np.float32))


@pytest.fixture(scope="module")
def jax_served():
    return jax_load_served("alexnet1", input_size=SIZE, num_classes=CLASSES)


@pytest.fixture(scope="module")
def served(jax_served):
    variables = jax.tree_util.tree_map(np.asarray, jax_served.variables)
    return load_served("alexnet1", variables=variables, device="cpu",
                       input_size=SIZE, num_classes=CLASSES)


def wait_until(cond, timeout=30.0, msg="condition"):
    """The engine resolves a future before it counts the request: a test
    that reads a counter after ``result()`` waits for it to land."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def test_engine_matches_jax_serving_path(jax_served, served):
    x = _requests(5)
    want = jax_served.run(x)
    with InferenceEngine([served], buckets=(1, 4)) as eng:
        got = [f.result(timeout=60) for f in
               [eng.submit(xi) for xi in x]]
        wait_until(lambda: eng.telemetry.completed
                   + eng.telemetry.failed >= 5, msg="5 requests counted")
        stats = eng.stats()
    for i, r in enumerate(got):
        assert r["classes"] == np.asarray(want["classes"][i]).tolist()
        np.testing.assert_allclose(r["probs"], want["probs"][i], atol=1e-5)
    tel = stats["telemetry"]
    assert tel["completed"] == 5 and tel["failed"] == 0
    # 5 rows on a (1, 4) ladder: batches of at most 4, padded to a bucket
    assert tel["rows"] == 5 and tel["batches"] >= 2
    assert stats["precision"] == {"cudnn_allow_tf32": False,
                                  "matmul_allow_tf32": False}


def test_padding_never_leaks_into_answers(served):
    x = _requests(3, seed=1)
    direct = served.run(x)  # one batch of exactly 3, no padding
    with InferenceEngine([served], buckets=(4,)) as eng:
        eng.pause()
        futs = [eng.submit(xi) for xi in x]
        eng.resume()
        got = [f.result(timeout=60) for f in futs]
        assert eng.telemetry.padded_rows == 1
    for i, r in enumerate(got):
        assert r["classes"] == direct["classes"][i].tolist()
        np.testing.assert_allclose(r["probs"], direct["probs"][i],
                                   atol=1e-6)


def test_submit_checks_shape_and_model(served):
    with InferenceEngine([served], buckets=(1,)) as eng:
        with pytest.raises(ValueError, match="expects input shape"):
            eng.submit(np.zeros((SIZE, SIZE, 1), np.float32))
        with pytest.raises(ValueError, match="unknown model"):
            eng.submit(_requests(1)[0], model="alexnet9")
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_requests(1)[0])


def test_deadline_expiry_and_shed(served):
    with InferenceEngine([served], buckets=(1,), max_queue=2) as eng:
        eng.pause()
        late = eng.submit(_requests(1)[0], timeout_s=0.0)
        eng.submit(_requests(1)[0])
        with pytest.raises(ShedError) as shed:
            eng.submit(_requests(1)[0])
        assert shed.value.retry_after_s > 0
        eng.resume()
        with pytest.raises(TimeoutError, match="deadline"):
            late.result(timeout=60)
        t = eng.telemetry
        wait_until(lambda: t.timed_out >= 1, msg="the timeout counted")
    assert (t.timed_out, t.shed) == (1, 1)


class _Failing(ServedModel):
    """Fails every batch that holds a request; warm-up's zeros pass."""

    def run(self, batch):
        if batch.any():
            raise RuntimeError("device fault")
        return super().run(batch)


def test_batch_failure_fails_only_that_batch(served):
    bad = _Failing(**{**vars(served), "name": "bad"})
    with InferenceEngine([served, bad], buckets=(1,)) as eng:
        f_bad = eng.submit(_requests(1)[0], model="bad")
        f_ok = eng.submit(_requests(1)[0], model="alexnet1")
        with pytest.raises(RuntimeError, match="device fault"):
            f_bad.result(timeout=60)
        assert len(f_ok.result(timeout=60)["classes"]) == 5
        wait_until(lambda: eng.telemetry.failed >= 1,
                   msg="the failure counted")
        assert eng.telemetry.failed == 1


def test_close_fails_pending_futures(served):
    eng = InferenceEngine([served], buckets=(1,))
    eng.pause()
    fut = eng.submit(_requests(1)[0])
    eng.close()
    with pytest.raises(RuntimeError, match="engine closed"):
        fut.result(timeout=10)
    assert not eng._thread.is_alive()


def test_cli_jsonl_round_trip(served):
    x = _requests(3, seed=2)
    lines = [json.dumps({"id": i, "model": "alexnet1",
                         "input": x[i].tolist()}) for i in range(3)]
    lines.insert(1, "not json")
    out = io.StringIO()
    serve_main(["-m", "alexnet1", "--device", "cpu", "--input-size",
                str(SIZE), "--num-classes", str(CLASSES), "--buckets",
                "1,4", "--seed", "3"],
               stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    assert "bad request" in replies[0]["error"]
    answers = [r for r in replies if "id" in r]
    assert [r["id"] for r in answers] == [0, 1, 2]
    want = load_served("alexnet1", seed=3, device="cpu", input_size=SIZE,
                       num_classes=CLASSES).run(x)
    for r in answers:
        assert r["result"]["classes"] == want["classes"][r["id"]].tolist()
        assert r["ms"] >= 0


def test_load_served_refuses_checkpoint_restore(tmp_path):
    """A workdir without a verified port checkpoint is refused, never
    served with fresh weights (tests/test_torch_trainer.py serves from
    real ones)."""
    with pytest.raises(FileNotFoundError, match="no verified checkpoint"):
        load_served("alexnet1", str(tmp_path / "alexnet1"), device="cpu")


# ------------------------------------------------------------ guards


def _port_files():
    return sorted((REPO / "deepvision_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "lrn_ab.py"]


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "deepvision_tpu")
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"


def test_importing_every_port_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / "deepvision_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'deepvision_tpu'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# the detection slice's modules, each of which the two scans above
# must reach
DETECTION_MODULES = (
    "ops/iou.py", "ops/yolo_decode.py", "ops/yolo_encode.py", "ops/nms.py",
    "ops/nms_cuda.py", "ops/yolo_postprocess.py", "losses/yolo.py",
    "models/yolo.py", "data/detection.py", "eval/__init__.py",
    "eval/detection.py", "eval/__main__.py")
# the CenterNet and pose slice's modules, likewise
HOURGLASS_MODULES = (
    "ops/centernet_encode.py", "ops/centernet_decode.py", "ops/heatmap.py",
    "losses/centernet.py", "losses/pose.py", "models/centernet.py",
    "models/hourglass.py", "data/pose.py", "eval/pose.py")
# the GAN slice's modules, likewise
GAN_MODULES = (
    "models/gan.py", "models/lenet.py", "train/gan.py", "data/gan.py",
    "data/mnist.py", "eval/gan.py")
# the serving fleet's modules, likewise
FLEET_MODULES = ("serve/router.py", "serve/replica.py", "obs/distributed.py")
# the pipeline serving tier's modules, likewise
PIPELINE_MODULES = ("ops/crop_resize.py", "serve/pipeline.py")


def test_the_scans_reach_every_module_and_native_binding():
    """Both scans walk every ``.py`` under the package (the detection,
    CenterNet, pose, GAN, fleet and pipeline modules among them), and
    every native source under ``csrc/`` is loaded by a scanned module's
    ``load_library`` call, so its binding is scanned too."""
    package = REPO / "deepvision_tpu_torch"
    scanned = {p.relative_to(package).as_posix() for p in _port_files()
               if package in p.parents}
    assert (set(DETECTION_MODULES) | set(HOURGLASS_MODULES)
            | set(GAN_MODULES) | set(FLEET_MODULES)
            | set(PIPELINE_MODULES)) <= scanned
    loaded = set()
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "load_library"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                loaded.add(node.args[0].value)
    sources = {p.stem for p in (package / "csrc").iterdir()
               if p.suffix in (".cu", ".cpp")}
    assert "nms" in sources and sources <= loaded, sources - loaded


@pytest.mark.parametrize("name,task", [
    ("alexnet1", "classify"), ("resnet50", "classify"), ("yolov3", "detect"),
    ("centernet", "detect"), ("hourglass104", "pose"), ("dcgan", "gan"),
    ("dcgan_generator", "gan"), ("lenet5", "classify")])
def test_served_task_table(name, task):
    """Each model serves the JAX package's task for it, with the JAX
    package's input pixel convention."""
    from deepvision_tpu.serve.models import input_scale as jax_input_scale
    from deepvision_tpu.serve.models import task_for as jax_task_for
    from deepvision_tpu_torch.serve.models import input_scale, task_for

    assert task_for(name) == jax_task_for(name) == task
    assert input_scale(name) == jax_input_scale(name)


def test_no_quiet_cpu_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_served("alexnet1")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


# serve.py's flags that the port's serving CLI does not have yet (none
# since serving observability was ported), and the port's own flags
SERVE_FLAGS_TO_PORT: set[str] = set()
PORT_ONLY_SERVE_FLAGS = {"--device", "--seed", "--input-size", "--iou",
                         "--restart-backoff-s"}


def _cli_flags(path: Path) -> set[str]:
    """The long flags of every ``add_argument`` call in ``path``."""
    flags = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Call) \
                and getattr(node.func, "attr", None) == "add_argument":
            flags |= {a.value for a in node.args
                      if isinstance(a, ast.Constant)
                      and str(a.value).startswith("--")}
    return flags


def test_serving_cli_flags_are_serve_py_s_but_the_listed_ones():
    """The serving CLI's flag set is ``serve.py``'s, less the flags still
    to port and plus the port's own, so that what is missing stays
    explicit."""
    jax_flags = _cli_flags(REPO / "serve.py")
    port_flags = _cli_flags(REPO / "deepvision_tpu_torch" / "serve"
                            / "__main__.py")
    assert SERVE_FLAGS_TO_PORT <= jax_flags
    assert not PORT_ONLY_SERVE_FLAGS & jax_flags
    assert port_flags == (jax_flags - SERVE_FLAGS_TO_PORT) \
        | PORT_ONLY_SERVE_FLAGS, (sorted(port_flags ^ jax_flags))
