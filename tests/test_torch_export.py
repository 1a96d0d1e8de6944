"""The port's model export on the CPU, against the JAX package's.

``deepvision_tpu_torch/export.py`` serializes ``torch.export`` programs
where ``deepvision_tpu/export.py`` serializes StableHLO. The same inputs,
made with numpy from a seed, go through both: LeNet-5's artifact with the
weights of a JAX train state carried across, and a toy program's
signature metadata. The rest pins what the card relies on: the LRN and
NMS kernels stay ``deepvision::`` custom-op nodes of an exported graph
(2 in ``alexnet1``, 1 in ``yolov3``'s request program, and neither the
plain window sum nor the unrolled greedy loop in their place), a loaded
request program answers bit for bit as the eager ``ServedModel.run``, an
artifact serves at its exported batch with its only cache misses at the
warm-up, ``predict export`` then ``serve --artifact`` answers as ``-m``,
and the op's float64 gradient is the plain backward's.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from deepvision_tpu_torch import export as port_export
from deepvision_tpu_torch.ops.lrn import (
    local_response_norm_backward_reference,
    local_response_norm_reference,
)
from deepvision_tpu_torch.serve import InferenceEngine, load_served
from deepvision_tpu_torch.serve.__main__ import main as serve_main
from deepvision_tpu_torch.serve.models import from_exported
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

SIZE, CLASSES = 64, 10  # alexnet1 as tests/test_torch_serve.py serves it
YOLO_SIZE, YOLO_CLASSES = 64, 3


@pytest.fixture(scope="module")
def lenet_state():
    """A JAX LeNet-5 train state (10 classes, 32x32x1) and a seeded
    sample, as ``tests/test_predict.py``'s export round trip makes
    them."""
    import optax

    from deepvision_tpu.models import get_model
    from deepvision_tpu.train.state import create_train_state

    sample = np.random.default_rng(0).normal(
        size=(1, 32, 32, 1)).astype(np.float32)
    model = get_model("lenet5", num_classes=10)
    state = create_train_state(model, optax.sgd(0.1), sample)
    return state, sample


def _port_lenet(state):
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})
    return load_served("lenet5", variables=variables, device="cpu",
                       num_classes=10, input_size=32)


def test_export_roundtrip_matches_jax(lenet_state, tmp_path):
    """Twin of ``tests/test_predict.py::test_export_roundtrip``: the
    port's loaded artifact answers as the JAX loaded artifact of the same
    weights, to 1e-5."""
    from deepvision_tpu.export import export_forward, load_exported

    state, sample = lenet_state
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    jax_fn = load_exported(port_export.save_exported(
        tmp_path / "lenet5.stablehlo",
        export_forward(state.apply_fn, variables, sample)))
    served = _port_lenet(state)
    path = port_export.save_exported(
        tmp_path / "lenet5.pt2",
        port_export.export_forward(served.module, sample))
    fn = port_export.load_exported(path)
    got = fn(torch.from_numpy(sample)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fn(sample)), atol=1e-5)
    assert fn.device == torch.device("cpu")
    assert served.module.training is False  # the mode is restored


def test_export_out_avals_round_trip(tmp_path):
    """Twin of ``tests/test_pipeline.py::
    test_export_out_avals_stablehlo_round_trip``: the reloaded artifact
    carries the input and output signature that JAX's carries, and
    computes the same numbers."""
    import jax.numpy as jnp

    from deepvision_tpu import export as jax_export

    def apply_fn(v, x):
        return {"y": x * v["w"], "s": jnp.sum(x, axis=1)}

    sample = np.linspace(0, 1, 10, dtype=np.float32).reshape(2, 5)
    jax_call = jax_export.load_exported(jax_export.save_exported(
        tmp_path / "m.shlo", jax_export.export_forward(
            apply_fn, {"w": np.float32(3.0)}, sample, train_kwarg=False)))
    w = torch.tensor(3.0)

    def fn(x):
        return {"y": x * w, "s": torch.sum(x, dim=1)}

    call = port_export.load_exported(port_export.save_exported(
        tmp_path / "m.pt2", port_export.export_callable(
            fn, [((2, 5), torch.float32)], device="cpu")))

    def signature(avals, name):
        return sorted((tuple(a.shape), name(a.dtype)) for a in avals)

    def torch_name(dtype):
        return str(dtype).removeprefix("torch.")

    assert [tuple(a.shape) for a in call.in_avals] == [
        tuple(a.shape) for a in jax_call.in_avals] == [(2, 5)]
    assert signature(call.out_avals, torch_name) == signature(
        jax_call.out_avals, lambda d: np.dtype(d).name)
    got, want = call(torch.from_numpy(sample)), jax_call(sample)
    for key in ("y", "s"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6)


def test_alexnet_graph_holds_the_lrn_op_twice(tmp_path):
    """``alexnet1``'s exported forward keeps both LRNs as
    ``deepvision::lrn_forward`` nodes, not the plain window sum
    (``unfold``, ``pow``), and the loaded program's logits are the eager
    module's bit for bit (the same ATen kernels on the CPU)."""
    served = load_served("alexnet1", device="cpu", input_size=SIZE,
                         num_classes=CLASSES)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    fn = port_export.deserialize_exported(
        port_export.export_forward(served.module, x))
    ops = port_export.graph_ops(fn)
    assert ops["deepvision.lrn_forward.default"] == 2, ops
    assert not [op for op in ops if "unfold" in op or "pow" in op], ops
    with torch.inference_mode():
        assert torch.equal(fn(x), served.module(x))


def test_yolov3_request_program_holds_the_nms_op_once():
    """``yolov3``'s whole request program (forward, decode, NMS and the
    detect head; ``ServedModel.export_bytes``) keeps the greedy sweep as
    one ``deepvision::nms_sweep`` node, not the K-step loop of
    ``bitwise_and``s, and the loaded program answers bit for bit as the
    eager ``ServedModel.run``. The export runs first on an empty anchor
    cache: a fake tensor traced under ``torch.export`` must never reach
    the cache that the eager forward reads."""
    from deepvision_tpu_torch.ops import yolo_decode

    served = load_served("yolov3", device="cpu", input_size=YOLO_SIZE,
                         num_classes=YOLO_CLASSES)
    yolo_decode._anchor_tensor.cache_clear()
    fn = port_export.deserialize_exported(served.export_bytes(2))
    ops = port_export.graph_ops(fn)
    assert ops["deepvision.nms_sweep.default"] == 1, ops
    assert not [op for op in ops if "bitwise_and" in op], ops
    assert [tuple(a.shape) for a in fn.in_avals] == [
        (2, YOLO_SIZE, YOLO_SIZE, 3)]
    # fresh weights saturate on full-contrast inputs: low contrast keeps
    # the scores apart
    x = (np.random.default_rng(2).uniform(-1, 1, (2, YOLO_SIZE, YOLO_SIZE, 3))
         * 0.003).astype(np.float32)
    want = served.run(x)
    got = served.with_program(fn).run(x)
    assert sorted(got) == sorted(want) == ["boxes", "classes", "scores",
                                           "valid"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_artifact_serves_at_its_batch_with_misses_only_at_warmup(
        lenet_state, tmp_path):
    """Twin of ``tests/test_serve.py::
    test_stablehlo_artifact_serves_with_zero_compiles``: the artifact's
    ladder is its exported batch, one runner, whose only miss is the
    warm-up's; the answers are the argmax of the JAX forward's logits."""
    state, _ = lenet_state
    sample = np.random.default_rng(0).normal(
        size=(4, 32, 32, 1)).astype(np.float32)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = np.asarray(state.apply_fn(variables, sample, train=False))
    path = port_export.save_exported(
        tmp_path / "lenet5.pt2",
        port_export.export_forward(_port_lenet(state).module, sample))
    fn = port_export.load_exported(path)
    assert fn.in_avals[0].shape == (4, 32, 32, 1)
    np.testing.assert_allclose(fn(torch.from_numpy(sample)).numpy(), want,
                               atol=1e-5)

    served = from_exported(path, name="lenet5_pt2", top_k=3, device="cpu")
    assert served.buckets == (4,)  # pinned to the exported batch
    assert served.name == "lenet5_pt2" and served.exported
    with InferenceEngine([served], buckets=(1, 16)) as eng:
        assert eng.stats()["cache"]["misses"] == 1
        eng.pause()
        futs = [eng.submit(sample[i]) for i in range(3)]
        eng.resume()
        for i, f in enumerate(futs):
            res = f.result(timeout=60)
            assert res["classes"][0] == int(np.argmax(want[i]))
            assert len(res["probs"]) == 3
        stats = eng.stats()
    assert stats["cache"]["entries"] == stats["cache"]["misses"] == 1
    assert list(stats["runners"]["lenet5_pt2"]["buckets"]) == ["4"]
    assert stats["telemetry"]["padded_rows"] == 1


def test_artifact_refuses_another_device(lenet_state, tmp_path,
                                        monkeypatch):
    """``from_exported`` defaults to the card, which raises here; a
    program runs on the device it was exported on, so one exported on
    the CPU is never served on the card."""
    from deepvision_tpu_torch.serve import models

    state, sample = lenet_state
    path = port_export.save_exported(
        tmp_path / "lenet5.pt2",
        port_export.export_forward(_port_lenet(state).module, sample))
    with pytest.raises(RuntimeError, match="none is available"):
        from_exported(path)
    with pytest.raises(ValueError, match="classify heads only"):
        from_exported(path, task="detect", device="cpu")
    monkeypatch.setattr(models, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="exported on cpu"):
        from_exported(path)


def test_predict_export_then_serve_artifact_answers_as_m(tmp_path, capsys):
    """Twin of ``tests/test_predict.py::test_predict_export_cli``, then the
    artifact through ``serve --artifact`` over stdin: its answers are
    those of ``-m`` on the same seeded weights, bit for bit (both at
    batch 1 on the CPU's ATen kernels)."""
    from deepvision_tpu_torch import predict

    out = tmp_path / "lenet5.pt2"
    assert predict.main(["export", "-m", "lenet5", "-o", str(out),
                         "--num-classes", "10", "--device", "cpu"]) == 0
    assert out.exists() and out.stat().st_size > 0
    printed = capsys.readouterr().out
    assert f"MB torch.export artifact to {out}" in printed
    x = np.random.default_rng(3).normal(size=(3, 32, 32, 1))
    lines = [json.dumps({"id": f"{m}/{i}", "model": m,
                         "input": x[i].tolist()})
             for m in ("lenet5", "art") for i in range(3)]
    replies = io.StringIO()
    serve_main(["-m", "lenet5", "--num-classes", "10", "--artifact",
                f"art={out}", "--device", "cpu", "--buckets", "1"],
               stdin=io.StringIO("\n".join(lines) + "\n"), stdout=replies)
    got = {r["id"]: r["result"] for r in
           map(json.loads, replies.getvalue().splitlines())}
    assert len(got) == 6
    for i in range(3):
        assert got[f"art/{i}"] == got[f"lenet5/{i}"]
    err = capsys.readouterr().err
    assert '"art": {"kind": "eager"' in err and "(2 runners)" in err


def test_serve_needs_a_model_or_an_artifact():
    with pytest.raises(SystemExit, match="no models"):
        serve_main(["--device", "cpu"], stdin=io.StringIO(""),
                   stdout=io.StringIO())


@pytest.mark.parametrize("size,c", [(5, 13), (64, 64)])
def test_lrn_op_gradient_is_the_plain_backward_float64(size, c):
    """``deepvision::lrn_forward``'s registered gradient against finite
    differences of the op (``gradcheck``), and equal to the plain
    backward, at an odd channel count and at Inception's n = 64; alpha
    large enough that the window term stands far above the noise of the
    finite differences."""
    rng = np.random.default_rng(size)
    x = torch.from_numpy(rng.normal(0, 3, (2, 2, 2, c))).requires_grad_()
    g = torch.from_numpy(rng.normal(0, 1, (2, 2, 2, c)))

    def op(a):
        return torch.ops.deepvision.lrn_forward(a, size, 0.5, 0.75, 1.0)

    assert torch.autograd.gradcheck(op, (x,))
    (got,) = torch.autograd.grad(op(x), x, g)
    torch.testing.assert_close(
        got, local_response_norm_backward_reference(x.detach(), g, size,
                                                    0.5, 0.75, 1.0),
        rtol=0, atol=0)
    (plain,) = torch.autograd.grad(
        local_response_norm_reference(x, size, 0.5, 0.75, 1.0), x, g)
    torch.testing.assert_close(got, plain, atol=1e-12, rtol=1e-10)


def test_kernel_ops_fake_implementations_give_shape_and_dtype():
    """The ops' fake implementations, which ``torch.export`` traces, give
    a meta tensor of the output's shape and dtype."""
    x = torch.zeros(1, 2, 2, 8, device="meta")
    y = torch.ops.deepvision.lrn_forward(x, 5, 1e-4, 0.75, 2.0)
    assert y.device.type == "meta" and y.shape == x.shape
    alive = torch.ones(1, 4, dtype=torch.bool, device="meta")
    out = torch.ops.deepvision.nms_sweep(torch.zeros(1, 4, 4, device="meta"),
                                         alive, 0.5)
    assert out.dtype == torch.bool and out.shape == alive.shape
