"""The port's pipeline serving tier against the JAX package's, on the CPU.

``deepvision_tpu_torch/ops/crop_resize.py`` and
``deepvision_tpu_torch/serve/pipeline.py`` against their JAX twins, with
the engine, CLI, HTTP and fleet halves that serve a pipeline:

- the glue ops: ``crop_and_resize`` and ``resize_bilinear`` against
  JAX's on seeded inputs to abs 1e-5 (degenerate zero boxes, +/-inf
  corners, a shrink, an enlarge), and the reader's tf-style resize
  (``data/jpeg.resize_bilinear``, no antialias) shown to differ at a
  shrink; ``top_k_boxes`` picks JAX's slots under tied scores, a class
  filter and ``min_score``; ``chunk_plan`` equals JAX's over a grid;
- the specs: every ``PipelineError`` of ``tests/test_pipeline.py``
  raised by the same spec in both packages, with a forward that counts
  its real calls showing that validation ran none (shape propagation on
  fake tensors), and ``load_pipeline_specs``' three file forms;
- the ``out_avals`` seam: ``ServedModel.as_stage``, ``in_avals`` and
  ``out_avals`` equal JAX's for the same toy model; an artifact's output
  avals come from its program's metadata without running it, and its
  pinned batch refuses another stage bucket;
- the engine, beside the JAX engine, with the same toy detector and toy
  pose written in both frameworks (``tests/test_pipeline.py``'s): chunk
  plans and frozen counters, answers equal to JAX's (boxes and joints to
  abs 1e-5), parity with the sequential client (detect rtol 5e-3, pose
  rtol 1e-4: the JAX test's tolerances), a deadline that expires
  mid-DAG failing its request exactly once, and a clean shutdown;
- the slice as a whole: ``yolov3`` (64 px, 5 classes, score 0) and
  ``hourglass104`` (64 px, 4 heatmaps) with the same weights (carried
  from flax by ``convert.from_flax``) through the ``detpose`` DAG in
  both engines: detections to 1e-4 (relative, and absolute to the
  largest value: fresh weights blow boxes up), pose argmax joints equal,
  the pose stage's confidences on the DAG's own crops to 1e-4 relative
  and the whole DAG's to 1e-3 (its crops are 2e-7 apart, which fresh BN
  statistics amplify);
- ``serve --pipelines`` (``lenet5`` behind the Makefile's ``lenetpipe``
  spec, a resize from 64 to 32 px): ``{"pipeline": ...}`` on stdin,
  ``POST /v1/pipeline/NAME`` on both HTTP fronts (classes equal,
  probabilities to abs 1e-5), 404 for an empty name, the ``[pipeline]``
  exit line, and a fleet that routes the name to a replica.
"""

import contextlib
import http.client
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import serve as jax_serve_cli  # noqa: E402
from deepvision_tpu.core.mesh import create_mesh  # noqa: E402
from deepvision_tpu.ops import crop_resize as jax_crop  # noqa: E402
from deepvision_tpu.serve import InferenceEngine as JaxEngine  # noqa: E402
from deepvision_tpu.serve import ServedModel as JaxServedModel  # noqa: E402
from deepvision_tpu.serve import models as jax_models  # noqa: E402
from deepvision_tpu.serve import pipeline as jax_pipeline  # noqa: E402
from deepvision_tpu_torch.data.jpeg import (  # noqa: E402
    resize_bilinear as reader_resize,
)
from deepvision_tpu_torch.export import TensorSpec  # noqa: E402
from deepvision_tpu_torch.obs.metrics import Registry  # noqa: E402
from deepvision_tpu_torch.ops import crop_resize  # noqa: E402
from deepvision_tpu_torch.serve import (  # noqa: E402
    InferenceEngine,
    Pipeline,
    PipelineError,
    PipelineSpec,
    ServedModel,
    load_pipeline_specs,
    load_served,
)
from deepvision_tpu_torch.serve import models as port_models  # noqa: E402
from deepvision_tpu_torch.serve import pipeline as port_pipeline  # noqa: E402
from deepvision_tpu_torch.serve.http import make_handler, make_server  # noqa: E402
from deepvision_tpu_torch.serve.telemetry import ServeTelemetry  # noqa: E402
from tests.torch_threads import (  # noqa: E402,F401  (autouse)
    share_cores_among_workers,
)

OP_TOL = 1e-5  # the glue ops against JAX's, abs
TOY_TOL = 1e-5  # the toy DAG's answers against the JAX engine's, abs
SLICE_TOL = 1e-4  # the real models' stages against JAX's, relative
# the pose confidences of the whole DAG against JAX's DAG, relative: the
# detectors' boxes are about 1e-6 apart, the crops cut from them 2e-7
# (of 4e-3), and fresh BN statistics amplify that to about 2e-4 in
# confidences of 1e6-1e8 (the pose stage alone, on the same crops, agrees
# to SLICE_TOL)
DAG_POSE_RTOL = 1e-3
DETECT_RTOL, POSE_RTOL = 5e-3, 1e-4  # DAG against the sequential client
PROB_TOL = 1e-5  # lenet5's probabilities, both fronts


def _engine(models, **kw):
    """A port engine whose telemetry has a registry of its own: the
    process's registry is what a fleet router's ``/metrics`` federates
    (``tests/test_torch_router.py``), and this file leaves it as it was."""
    return InferenceEngine(models, telemetry=ServeTelemetry(Registry()), **kw)


# ------------------------------------------------------------ glue ops


def _images(seed, b, h, w, c=3):
    return np.random.default_rng(seed).normal(
        size=(b, h, w, c)).astype(np.float32)


def _boxes(seed, b, k):
    boxes = np.random.default_rng(seed).uniform(
        -0.2, 1.2, (b, k, 4)).astype(np.float32)
    boxes[0, 0] = 0.0  # NMS's zero padding row: a degenerate box
    boxes[-1, 1] = [-np.inf, -np.inf, np.inf, np.inf]  # saturated corners
    boxes[-1, 2] = [np.inf, 0.2, -np.inf, 0.8]
    return boxes


@pytest.mark.parametrize("h,w,size", [(40, 48, 12), (24, 20, 64),
                                      (32, 32, 32)],
                         ids=["shrink", "enlarge", "same"])
def test_crop_and_resize_equals_jax(h, w, size):
    images, boxes = _images(0, 2, h, w), _boxes(1, 2, 5)
    want = np.asarray(jax_crop.crop_and_resize(images, boxes, size))
    got = crop_resize.crop_and_resize(torch.from_numpy(images),
                                      torch.from_numpy(boxes), size).numpy()
    assert got.shape == want.shape == (2, 5, size, size, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)
    # a degenerate box samples one clipped point: a constant patch
    np.testing.assert_array_equal(got[0, 0], np.broadcast_to(
        got[0, 0, 0, 0], (size, size, 3)))


@pytest.mark.parametrize("src,size", [(64, 32), (64, 27), (32, 64),
                                      (48, 48)])
def test_resize_bilinear_equals_jax_antialias(src, size):
    images = _images(2, 2, src, src)
    want = np.asarray(jax_crop.resize_bilinear(images, size))
    got = crop_resize.resize_bilinear(torch.from_numpy(images), size).numpy()
    assert got.shape == want.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)


def test_reader_resize_without_antialias_differs_at_a_shrink():
    """The trap: ``jax.image.resize`` antialiases when it shrinks, tf's
    resize (the reader's) does not; the glue must not reuse the
    reader's."""
    image = _images(3, 1, 64, 64)
    want = np.asarray(jax_crop.resize_bilinear(image, 27))[0]
    tf_style = reader_resize(torch.from_numpy(image[0]), 27, 27).numpy()
    assert np.abs(tf_style - want).max() > 0.1
    glue = crop_resize.resize_bilinear(torch.from_numpy(image), 27)[0]
    np.testing.assert_allclose(glue.numpy(), want, rtol=0, atol=OP_TOL)


def _detections(b=3, n=6):
    scores = np.array([[0.9, 0.6, 0.9, 0.2, 0.6, 0.0],
                       [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                       [0.1, 0.8, 0.3, 0.8, 0.05, 0.7]], np.float32)[:b, :n]
    rng = np.random.default_rng(4)
    return {"boxes": rng.uniform(0, 1, (b, n, 4)).astype(np.float32),
            "scores": scores,
            "classes": np.array([[1, 2, 1, 1, 2, 1], [2, 2, 1, 2, 2, 2],
                                 [1, 1, 2, 1, 1, 2]], np.int32)[:b, :n],
            "valid": np.array([[1, 1, 1, 1, 0, 1], [1, 1, 1, 1, 1, 0],
                               [1, 1, 1, 1, 1, 1]], bool)[:b, :n]}


@pytest.mark.parametrize("params", [
    {"k": 3}, {"k": 6}, {"k": 4, "class_id": 2},
    {"k": 3, "class_id": 1, "min_score": 0.5}, {"k": 2, "min_score": 0.85}],
    ids=["ties", "all", "class", "class-min-score", "min-score"])
def test_top_k_boxes_takes_jax_slots(params):
    det = _detections()
    jax_avals = [{k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                  for k, v in det.items()}]
    port_avals = [{k: TensorSpec(v.shape, torch.from_numpy(v).dtype)
                   for k, v in det.items()}]
    jfn, jf = jax_pipeline._GLUE["top_k_boxes"](params, jax_avals)
    pfn, pf = port_pipeline._GLUE["top_k_boxes"](params, port_avals)
    assert jf == pf == 1
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jfn)(det))
    got = pfn({k: torch.from_numpy(v) for k, v in det.items()})
    for key in ("boxes", "scores", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_crop_resize_glue_flattens_like_jax():
    images, boxes = _images(5, 2, 20, 24), _boxes(6, 2, 3)
    valid = np.array([[True, False, True], [False, True, True]])
    sel = {"boxes": boxes, "valid": valid}
    jax_avals = [jax.ShapeDtypeStruct(images.shape, images.dtype),
                 {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                  for k, v in sel.items()}]
    port_avals = [TensorSpec(images.shape, torch.float32),
                  {"boxes": TensorSpec(boxes.shape, torch.float32),
                   "valid": TensorSpec(valid.shape, torch.bool)}]
    jfn, jf = jax_pipeline._GLUE["crop_resize"]({"size": 10}, jax_avals)
    pfn, pf = port_pipeline._GLUE["crop_resize"]({"size": 10}, port_avals)
    assert jf == pf == 3
    want = jax.jit(jfn)(images, sel)
    got = pfn(torch.from_numpy(images),
              {k: torch.from_numpy(v) for k, v in sel.items()})
    assert tuple(got["crops"].shape) == (6, 10, 10, 3)
    np.testing.assert_allclose(got["crops"].numpy(),
                               np.asarray(want["crops"]), atol=OP_TOL)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 16, 20, 33, 64])
@pytest.mark.parametrize("ladder", [(1, 4, 16), (16,), (4, 8), (2, 8, 32)],
                         ids=str)
def test_chunk_plan_equals_jax(n, ladder):
    assert port_pipeline.chunk_plan(n, ladder) == \
        jax_pipeline.chunk_plan(n, ladder)


@pytest.mark.parametrize("bad", [(0, (1, 4)), (4, ())])
def test_chunk_plan_refuses_like_jax(bad):
    with pytest.raises(jax_pipeline.PipelineError):
        jax_pipeline.chunk_plan(*bad)
    with pytest.raises(PipelineError):
        port_pipeline.chunk_plan(*bad)


# ----------------------------------------------------- toy models, twice


class _Weights(torch.nn.Module):
    def __init__(self, w: float):
        super().__init__()
        self.register_buffer("w", torch.tensor(w, dtype=torch.float32))


_TOY_BOXES = [[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.9],
              [0.0, 0.0, 1.0, 1.0]]


def toy_detector(name="det", weight=1.0, calls=None):
    """``tests/test_pipeline.py``'s detect toy in torch: 3 fixed boxes an
    image scored 0.9/0.6/0.1 with a small input-dependent wobble.
    ``calls`` (a list) counts the forward's calls on real tensors."""
    from torch._subclasses.fake_tensor import FakeTensor

    mod = _Weights(weight)

    def forward(x):
        if calls is not None and not isinstance(x, FakeTensor):
            calls.append(len(x))
        b = x.shape[0]
        base = torch.tanh(torch.mean(x, dim=(1, 2, 3))) * 1e-3
        boxes = torch.tensor(_TOY_BOXES, device=x.device).expand(b, 3, 4)
        scores = torch.stack([base + 0.9, base + 0.6, base + 0.1], dim=1)
        return {"boxes": boxes * mod.w, "scores": scores,
                "classes": torch.zeros((b, 3), dtype=torch.int32,
                                       device=x.device),
                "valid": scores > 0.5}

    return ServedModel(name=name, task="detect", module=mod,
                       input_shape=(16, 16, 3),
                       postprocess=port_models._detect_post,
                       device=torch.device("cpu"), forward=forward)


def toy_pose(name="pose", calls=None):
    """The pose toy over 8x8 crops: joints from the crop's mean."""
    from torch._subclasses.fake_tensor import FakeTensor

    def forward(x):
        if calls is not None and not isinstance(x, FakeTensor):
            calls.append(len(x))
        m = torch.mean(x, dim=(1, 2, 3))
        kx = torch.stack([m, m * 2], dim=1)
        return {"x": kx, "y": kx + 1, "conf": kx * 0 + 0.8}

    return ServedModel(name=name, task="pose", module=_Weights(1.0),
                       input_shape=(8, 8, 3),
                       postprocess=port_models._pose_post,
                       device=torch.device("cpu"), forward=forward)


def jax_toy_detector(name="det", weight=1.0):
    def forward(variables, x):
        b = x.shape[0]
        base = jnp.tanh(jnp.mean(x, axis=(1, 2, 3))) * 1e-3
        boxes = jnp.tile(jnp.array(_TOY_BOXES, jnp.float32), (b, 1, 1))
        scores = jnp.stack([base + 0.9, base + 0.6, base + 0.1], axis=1)
        return {"boxes": boxes * variables["w"], "scores": scores,
                "classes": jnp.zeros((b, 3), jnp.int32),
                "valid": scores > 0.5}

    return JaxServedModel(
        name=name, task="detect", forward=forward,
        variables={"w": np.float32(weight)}, input_shape=(16, 16, 3),
        postprocess=jax_models._detect_post)


def jax_toy_pose(name="pose"):
    def forward(variables, x):
        m = jnp.mean(x, axis=(1, 2, 3))
        kx = jnp.stack([m, m * 2], axis=1)
        return {"x": kx, "y": kx + 1, "conf": kx * 0 + 0.8}

    return JaxServedModel(
        name=name, task="pose", forward=forward,
        variables={"w": np.float32(1.0)}, input_shape=(8, 8, 3),
        postprocess=jax_models._pose_post)


def detpose_json(k=2, size=8, pose_buckets=(1, 2, 8)):
    return {
        "name": "detpose",
        "buckets": [1, 4],
        "nodes": [
            {"name": "detect", "model": "det"},
            {"name": "people", "glue": "top_k_boxes",
             "inputs": ["detect"], "params": {"k": k}},
            {"name": "crop", "glue": "crop_resize",
             "inputs": ["input", "people"], "params": {"size": size}},
            {"name": "posestage", "model": "pose",
             "inputs": ["crop.crops"], "buckets": list(pose_buckets)},
        ],
        "outputs": [{"node": "detect"},
                    {"node": "posestage", "mask": "crop.valid"}],
    }


def _both(body, models=("det", "pose"), calls=None):
    """``body`` built in each package: -> (the JAX error or pipeline,
    the port's)."""
    jax_m = {"det": jax_toy_detector(), "pose": jax_toy_pose()}
    port_m = {"det": toy_detector(calls=calls), "pose": toy_pose(calls=calls)}
    out = []
    for pipe, spec, ms in ((jax_pipeline.Pipeline, jax_pipeline.PipelineSpec,
                            jax_m),
                           (Pipeline, PipelineSpec, port_m)):
        try:
            out.append(pipe(spec.from_json(body),
                            {k: ms[k] for k in models}))
        except ValueError as e:
            out.append(e)
    return out


def _spec_case(name):
    body = detpose_json()
    models = ("det", "pose")
    if name == "cycle":
        body = {"name": "loop", "input": {"shape": [8, 8, 3]},
                "nodes": [{"name": "a", "glue": "resize", "inputs": ["b"],
                           "params": {"size": 8}},
                          {"name": "b", "glue": "resize", "inputs": ["a"],
                           "params": {"size": 8}}],
                "outputs": ["a"]}
        models = ()
    elif name == "duplicate":
        body["nodes"][1]["name"] = "detect"
    elif name == "reserved":
        body["nodes"][0]["name"] = "input"
    elif name == "unknown model":
        body["nodes"][0]["model"] = "nope"
    elif name == "unknown glue":
        body["nodes"][1]["glue"] = "nope"
    elif name == "unknown node":
        body["nodes"][1]["inputs"] = ["ghost"]
    elif name == "unknown output":
        body["outputs"] = [{"node": "ghost"}]
    elif name == "aval mismatch":
        body = {"name": "bad", "input": {"shape": [16, 16, 3]},
                "nodes": [{"name": "p", "model": "pose"}], "outputs": ["p"]}
    elif name == "array input":
        body = {"name": "bad2",
                "nodes": [{"name": "detect", "model": "det"},
                          {"name": "p2", "model": "det",
                           "inputs": ["detect"]}],
                "outputs": ["p2"]}
    elif name == "exceeds":
        body = detpose_json(k=5)  # the toy detector emits 3 candidates
    elif name == "fan-out":
        body["outputs"] = [{"node": "detect", "mask": "crop.valid"}]
    elif name == "explicit input":
        body = {"name": "rp",
                "nodes": [{"name": "shrink", "glue": "resize",
                           "params": {"size": 8}},
                          {"name": "p", "model": "pose",
                           "inputs": ["shrink"]}],
                "outputs": ["p"]}
    return body, models


_SPEC_ERRORS = {
    "cycle": "cycle", "duplicate": "duplicate", "reserved": "reserved",
    "unknown model": "unknown model", "unknown glue": "unknown glue",
    "unknown node": "unknown node", "unknown output": "unknown node",
    "aval mismatch": "aval mismatch", "array input": "array input",
    "exceeds": "exceeds", "fan-out": "fan-out",
    "explicit input": "explicit input"}


@pytest.mark.parametrize("case", sorted(_SPEC_ERRORS))
def test_spec_errors_equal_jax_and_run_no_forward(case):
    calls = []
    body, models = _spec_case(case)
    jax_err, port_err = _both(body, models, calls)
    assert isinstance(jax_err, jax_pipeline.PipelineError), jax_err
    assert isinstance(port_err, PipelineError), port_err
    assert _SPEC_ERRORS[case] in str(jax_err)
    assert _SPEC_ERRORS[case] in str(port_err)
    assert calls == []


def test_valid_spec_validates_without_a_forward():
    calls = []
    jax_pipe, port_pipe = _both(detpose_json(), calls=calls)
    assert isinstance(port_pipe, Pipeline), port_pipe
    assert calls == []  # shape propagation only: fake tensors
    assert port_pipe.input_shape == jax_pipe.input_shape == (16, 16, 3)
    assert port_pipe.dtype_str == jax_pipe.dtype_str == "float32"
    assert port_pipe._factors == jax_pipe._factors
    # a glue-fronted DAG with an explicit entry geometry
    body, models = _spec_case("explicit input")
    body["input"] = {"shape": [32, 32, 3]}
    jax_pipe, port_pipe = _both(body, models)
    assert port_pipe.input_shape == jax_pipe.input_shape == (32, 32, 3)


def test_load_pipeline_specs_accepts_all_forms(tmp_path):
    body = detpose_json()
    files = {"one.json": body, "list.json": [body, dict(body, name="b")],
             "wrapped.json": {"pipelines": [body, dict(body, name="c")]}}
    for name, content in files.items():
        (tmp_path / name).write_text(json.dumps(content))
        port = load_pipeline_specs(tmp_path / name)
        want = jax_pipeline.load_pipeline_specs(tmp_path / name)
        assert [s.name for s in port] == [s.name for s in want]
        for p, j in zip(port, want, strict=True):
            assert (p.buckets, p.input_shape, p.input_dtype) == (
                j.buckets, j.input_shape, j.input_dtype)
            assert [(n.name, n.model, n.glue, n.inputs, n.params, n.buckets)
                    for n in p.nodes] == [
                (n.name, n.model, n.glue, n.inputs, n.params, n.buckets)
                for n in j.nodes]
            assert [(o.node, o.mask) for o in p.outputs] == [
                (o.node, o.mask) for o in j.outputs]


# ------------------------------------------------------- the avals seam


def test_shape_walk_keeps_fake_tensors_out_of_the_anchor_cache():
    """``yolo_decode.anchor_tensor`` keeps one tensor a device; a shape
    walk calls it with fake tensors, and what it makes there must not be
    what the next real forward finds."""
    from torch._subclasses.fake_tensor import FakeTensor

    from deepvision_tpu_torch.ops.yolo_decode import anchor_tensor

    anchors = np.array([[0.0625, 0.125], [0.25, 0.5]], np.float32)
    spec = port_pipeline.shape_eval(
        lambda x: anchor_tensor(anchors, x), [TensorSpec((2,),
                                                         torch.float32)],
        "cpu")
    assert spec == TensorSpec((2, 2), torch.float32)
    real = anchor_tensor(anchors, torch.zeros(2))
    assert not isinstance(real, FakeTensor)
    np.testing.assert_array_equal(real.numpy(), anchors)


def _signature(tree, name):
    return {k: (tuple(v.shape), name(v.dtype)) for k, v in tree.items()}


def test_as_stage_avals_equal_jax():
    det, jdet = toy_detector(), jax_toy_detector()
    stage, jstage = det.as_stage(), jdet.as_stage()
    (x,), (jx,) = stage.in_avals(4), jstage.in_avals(4)
    assert tuple(x.shape) == tuple(jx.shape) == (4, 16, 16, 3)
    assert x.dtype == torch.float32
    got = _signature(det.out_avals(4),
                     lambda d: str(d).removeprefix("torch."))
    want = _signature(jdet.out_avals(4), lambda d: np.dtype(d).name)
    assert got == want
    assert stage.runner(4) is det.forward  # no pinned batch


def test_artifact_avals_come_from_its_metadata(tmp_path):
    """A model served from an artifact takes its output avals from the
    loaded program's output nodes without running it, at any batch; its
    stage refuses any bucket but the exported one, and so does an engine
    whose pipeline would chunk it at another."""
    from deepvision_tpu_torch.export import export_forward, save_exported
    from deepvision_tpu_torch.serve.models import from_exported

    lenet = load_served("lenet5", device="cpu", num_classes=10)
    sample = np.random.default_rng(0).uniform(
        0, 1, (4, 32, 32, 1)).astype(np.float32)
    path = save_exported(tmp_path / "l.pt2",
                         export_forward(lenet.module, sample))
    served = from_exported(path, name="art", top_k=3, device="cpu")
    ran = []
    program = served.module
    served.module.register_forward_hook(lambda *a: ran.append(1))
    want = served.forward(torch.from_numpy(sample))
    ran.clear()
    for bucket in (4, 1):
        avals = served.out_avals(bucket)
        assert {k: (tuple(v.shape), v.dtype) for k, v in avals.items()} == {
            "probs": ((bucket, 3), torch.float32),
            "classes": ((bucket, 3), torch.int32)}
    assert ran == []
    assert {k: v.dtype for k, v in want.items()} == {
        "probs": torch.float32, "classes": torch.int32}
    stage = served.as_stage()
    assert stage.runner(4) is served.forward
    with pytest.raises(ValueError, match="pinned to batch"):
        stage.runner(1)
    spec = PipelineSpec.from_json({
        "name": "artpipe", "input": {"shape": [64, 64, 1]},
        "nodes": [{"name": "shrink", "glue": "resize",
                   "params": {"size": 32}},
                  {"name": "cls", "model": "art", "inputs": ["shrink"],
                   "buckets": [1]}],
        "outputs": ["cls"]})
    pipe = Pipeline(spec, {"art": served})
    with pytest.raises(ValueError, match="pinned to batch"):
        _engine([served], buckets=(1,), pipelines=[pipe])
    assert program is served.module


# ------------------------------------------------- engine-served DAGs


def make_engines(**kw):
    """The detpose DAG over the toys, in a port engine and a JAX one."""
    det, pose = toy_detector(), toy_pose()
    pipe = Pipeline(PipelineSpec.from_json(detpose_json()),
                    {"det": det, "pose": pose})
    jdet, jpose = jax_toy_detector(), jax_toy_pose()
    jpipe = jax_pipeline.Pipeline(
        jax_pipeline.PipelineSpec.from_json(detpose_json()),
        {"det": jdet, "pose": jpose})
    kw.setdefault("buckets", (1, 4))
    kw.setdefault("freeze_cache", True)
    eng = _engine([det, pose], pipelines=[pipe], **kw)
    jeng = JaxEngine([jdet, jpose], mesh=create_mesh(1, 1), pipelines=[jpipe],
                     **kw)
    return eng, pipe, jeng, jpipe


def entry_image(seed=0):
    return np.random.RandomState(seed).rand(16, 16, 3).astype(np.float32)


def _same_dag_answer(got, want, tol):
    assert got.keys() == want.keys()
    det, jdet = got["detect"], want["detect"]
    assert det["classes"] == jdet["classes"]
    np.testing.assert_allclose(det["boxes"], jdet["boxes"], atol=tol)
    np.testing.assert_allclose(det["scores"], jdet["scores"], atol=tol)
    assert len(got["posestage"]) == len(want["posestage"])
    for a, b in zip(got["posestage"], want["posestage"]):
        np.testing.assert_allclose(a["joints"], b["joints"], atol=tol)


def _queued(eng, xs, model):
    eng.pause()
    futs = [eng.submit(x, model=model) for x in xs]
    eng.resume()
    return [f.result(timeout=60) for f in futs]


def test_chunk_accounting_frozen_counters_and_answers_equal_jax():
    """One image fans out to K=2 crops (pose chunk [(0,2,2)]); an
    entry-bucket-4 batch to 8 (one bucket-8 chunk), in both engines. The
    frozen caches' misses stay at the warm-up's while hits grow, and
    every answer equals the JAX engine's."""
    eng, pipe, jeng, jpipe = make_engines()
    with eng, jeng:
        warm = eng.stats()["cache"]
        assert warm["frozen"] is True
        # the models' runners and one a pipeline entry bucket
        assert warm["misses"] == warm["entries"] == 2 + 2 + 2
        for bucket in (1, 4):
            pipe.compile_for(bucket)
            jpipe.compile_for(bucket, jeng._mesh)
            assert pipe.last_chunk_plans == jpipe.last_chunk_plans
        assert pipe.last_chunk_plans == {"detect": [(0, 4, 4)],
                                         "posestage": [(0, 8, 8)]}
        xs = [entry_image(i) for i in range(4)]
        got = [eng.submit(xs[0], model="detpose").result(timeout=60)]
        got += _queued(eng, xs[1:], "detpose")
        want = [jeng.submit(xs[0], model="detpose").result(timeout=60)]
        want += _queued(jeng, xs[1:], "detpose")
        assert len(got[0]["posestage"]) == 2  # both crops valid
        for g, w in zip(got, want, strict=True):
            _same_dag_answer(g, w, TOY_TOL)
        live = eng.stats()
        assert live["cache"]["misses"] == warm["misses"]
        assert live["cache"]["hits"] > warm["hits"]
        assert live["pipelines"] == jeng.stats()["pipelines"] == {
            "detpose": 4}
        assert live["models"] == ["det", "detpose", "pose"]
        assert live["runners"]["detpose"]["kind"] == "eager"


def test_pipeline_name_colliding_with_a_model_is_refused():
    det, pose = toy_detector(), toy_pose()
    body = detpose_json()
    body["name"] = "det"
    pipe = Pipeline(PipelineSpec.from_json(body), {"det": det, "pose": pose})
    with pytest.raises(ValueError, match="collides"):
        _engine([det, pose], pipelines=[pipe])


def test_pipeline_parity_vs_sequential_client():
    """detect -> crop -> pose through the DAG decides what the sequential
    client decides: the detect call, the top-2 boxes by a stable sort
    cropped on the host by the plain ``crop_and_resize``, one pose call a
    crop (detect rtol 5e-3, pose rtol 1e-4)."""
    eng, _, jeng, _ = make_engines()
    jeng.close()
    with eng:
        x = entry_image(7)
        piped = eng.submit(x, model="detpose").result(timeout=60)
        seq_det = eng.submit(x, model="det").result(timeout=60)
        assert piped["detect"]["classes"] == seq_det["classes"]
        np.testing.assert_allclose(piped["detect"]["boxes"],
                                   seq_det["boxes"], rtol=DETECT_RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(piped["detect"]["scores"],
                                   seq_det["scores"], rtol=DETECT_RTOL,
                                   atol=1e-6)
        scores = np.asarray(seq_det["scores"], np.float32)
        order = np.argsort(-scores, kind="stable")[:2]
        boxes = np.asarray(seq_det["boxes"], np.float32)[order]
        crops = crop_resize.crop_and_resize(
            torch.from_numpy(x[None]), torch.from_numpy(boxes[None]),
            8)[0].numpy()
        assert len(piped["posestage"]) == 2
        for j in range(2):
            seq_pose = eng.submit(crops[j], model="pose").result(timeout=60)
            np.testing.assert_allclose(
                np.asarray(piped["posestage"][j]["joints"]),
                np.asarray(seq_pose["joints"]), rtol=POSE_RTOL, atol=1e-6)


def test_deadline_expiry_mid_dag_fails_exactly_once():
    """A request whose deadline passes while the DAG runs gets
    TimeoutError (never a late answer), counted once, with its admission
    slot released so that the next request proceeds; the JAX engine does
    the same under the same hook."""
    eng, pipe, jeng, jpipe = make_engines()
    with eng, jeng:
        for e, p, err in ((eng, pipe, TimeoutError),
                          (jeng, jpipe, TimeoutError)):
            before = e.telemetry.snapshot()
            p.stage_hook = lambda name: time.sleep(0.2)
            try:
                fut = e.submit(entry_image(), model="detpose", timeout_s=0.5)
                with pytest.raises(err, match="mid-pipeline"):
                    fut.result(timeout=60)
            finally:
                p.stage_hook = None
            # the engine resolves the future before it counts the timeout
            deadline = time.monotonic() + 10.0
            while e.telemetry.snapshot()["timed_out"] == before["timed_out"]:
                assert time.monotonic() < deadline, "the timeout uncounted"
                time.sleep(0.002)
            after = e.telemetry.snapshot()
            assert after["timed_out"] - before["timed_out"] == 1
            assert after["completed"] == before["completed"]
            assert p.requests_served == 1  # it WAS dispatched
            ok = e.submit(entry_image(), model="detpose").result(timeout=60)
            assert len(ok["posestage"]) == 2
            assert e.telemetry.snapshot()["timed_out"] == after["timed_out"]
            assert e.stats()["queue"]["depth"] == 0


def test_clean_shutdown_no_leaked_threads():
    base = set(threading.enumerate())
    eng, _, jeng, _ = make_engines()
    jeng.close()
    futs = [eng.submit(entry_image(i), model="detpose") for i in range(3)]
    for f in futs:
        f.result(timeout=60)
    eng.close()
    deadline = time.time() + 10
    while time.time() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t not in base and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"threads leaked past close(): {leaked}"
    eng.close()  # idempotent


# ---------------------------------------------- the slice as a whole


K, SIZE = 2, 64


def _detpose_real():
    return {
        "name": "detpose", "buckets": [1],
        "nodes": [
            {"name": "det", "model": "yolov3"},
            {"name": "people", "glue": "top_k_boxes", "inputs": ["det"],
             "params": {"k": K}},
            {"name": "crop", "glue": "crop_resize",
             "inputs": ["input", "people"], "params": {"size": SIZE}},
            {"name": "posestage", "model": "hourglass104",
             "inputs": ["crop.crops"], "buckets": [K, 4 * K]}],
        "outputs": [{"node": "det"},
                    {"node": "posestage", "mask": "crop.valid"}]}


@pytest.fixture(scope="module")
def real_engines():
    """``yolov3`` and ``hourglass104`` at 64 px, as
    ``tools/pipeline_smoke.py`` builds them, the port's with the JAX
    weights; the detpose DAG in both engines (entry bucket 1)."""
    jdet = jax_models.load_served("yolov3", None, task="detect",
                                  input_size=SIZE, num_classes=5,
                                  score_thresh=0.0)
    jpose = jax_models.load_served("hourglass104", None, task="pose",
                                   input_size=SIZE, num_heatmaps=4)

    def host(v):
        return jax.tree_util.tree_map(np.asarray, v)

    det = load_served("yolov3", variables=host(jdet.variables),
                      device="cpu", input_size=SIZE, num_classes=5,
                      score_thresh=0.0)
    pose = load_served("hourglass104", variables=host(jpose.variables),
                       device="cpu", input_size=SIZE, num_heatmaps=4)
    jpipe = jax_pipeline.Pipeline(
        jax_pipeline.PipelineSpec.from_json(_detpose_real()),
        {"yolov3": jdet, "hourglass104": jpose})
    pipe = Pipeline(PipelineSpec.from_json(_detpose_real()),
                    {"yolov3": det, "hourglass104": pose})
    # the DAG's stages are all that the test reads: the JAX engine's
    # front door holds the toy alone, which compiles at once (it compiles
    # every front-door model, and a stage again under its pipeline key)
    jeng = JaxEngine([jax_toy_pose()], mesh=create_mesh(1, 1), buckets=(1,),
                     pipelines=[jpipe], freeze_cache=True)
    eng = _engine([det], buckets=(1,), pipelines=[pipe],
                          freeze_cache=True)
    with eng, jeng:
        yield eng, jeng, jpose


def test_detpose_slice_equals_jax(real_engines):
    eng, jeng, jpose = real_engines
    rng = np.random.default_rng(0)
    for _ in range(2):
        # small amplitude: fresh detector weights saturate on full-scale
        # noise (every score 1.0), which makes top-K degenerate
        x = (0.003 * rng.normal(size=(SIZE, SIZE, 3))).astype(np.float32)
        got = eng.submit(x, model="detpose").result(timeout=300)
        want = jeng.submit(x, model="detpose").result(timeout=300)
        assert got["det"]["classes"] == want["det"]["classes"]
        for key in ("boxes", "scores"):
            # fresh weights blow some boxes up to about 1e7: relative, to
            # the largest value, as the grids of test_torch_yolo.py
            w = np.asarray(want["det"][key], np.float32)
            np.testing.assert_allclose(
                np.asarray(got["det"][key], np.float32), w, rtol=SLICE_TOL,
                atol=SLICE_TOL * np.abs(w).max())
        assert len(got["posestage"]) == len(want["posestage"]) == K
        # the pose stage on the DAG's own crops (the top-K boxes by a
        # stable sort, cut by the plain crop_and_resize) in JAX
        scores = np.asarray(got["det"]["scores"], np.float32)
        boxes = np.asarray(got["det"]["boxes"], np.float32)[
            np.argsort(-scores, kind="stable")[:K]]
        crops = crop_resize.crop_and_resize(
            torch.from_numpy(x[None]), torch.from_numpy(boxes[None]),
            SIZE)[0].numpy()
        stage = jpose.run(crops)
        for j, (a, b) in enumerate(zip(got["posestage"],
                                       want["posestage"])):
            a, b = np.asarray(a["joints"]), np.asarray(b["joints"])
            np.testing.assert_array_equal(a[:, :2], b[:, :2])
            np.testing.assert_allclose(a[:, 2], b[:, 2],
                                       rtol=DAG_POSE_RTOL)
            np.testing.assert_allclose(
                a[:, 2], np.asarray(stage["conf"][j]), rtol=SLICE_TOL)
    assert eng.stats()["pipelines"] == jeng.stats()["pipelines"] == {
        "detpose": 2}


# ----------------------------------------------- the CLI, HTTP, fleet


LENET_SPEC = {"name": "lenetpipe", "input": {"shape": [64, 64, 1]},
              "buckets": [1, 4],
              "nodes": [{"name": "shrink", "glue": "resize",
                         "params": {"size": 32}},
                        {"name": "cls", "model": "lenet5",
                         "inputs": ["shrink"]}],
              "outputs": ["cls"]}


def _lenet_inputs(n, seed=0):
    return (np.random.default_rng(seed).uniform(0, 1, (n, 64, 64, 1))
            .astype(np.float32))


@pytest.fixture(scope="module")
def lenet():
    return load_served("lenet5", seed=0, device="cpu")


def _lenet_engine(lenet):
    pipe = Pipeline(PipelineSpec.from_json(LENET_SPEC), {"lenet5": lenet})
    return _engine([lenet], buckets=(1, 4), pipelines=[pipe],
                           freeze_cache=True)


def _same_classify(got, want):
    assert got["classes"] == want["classes"], (got, want)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                               atol=PROB_TOL)


def test_cli_serves_pipeline_lines_and_prints_the_exit_line(lenet, tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(LENET_SPEC))
    xs = _lenet_inputs(3)
    lines = [json.dumps({"id": i, "pipeline": "lenetpipe",
                         "input": x.tolist()}) + "\n"
             for i, x in enumerate(xs)]
    lines.append(json.dumps({"id": 10, "model": "lenet5",
                             "input": xs[0][::2, ::2].tolist()}) + "\n")
    # a process of its own, as a user starts it (in this one its engine
    # would register into the process's metrics registry)
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m", "lenet5",
         "--device", "cpu", "--seed", "0", "--buckets", "1,4",
         "--pipelines", str(spec)], input="".join(lines), cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    replies = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["id"] for r in replies] == [0, 1, 2, 10], replies
    with _lenet_engine(lenet) as eng:
        for r, x in zip(replies[:3], xs):
            want = eng.submit(x, model="lenetpipe").result(timeout=60)
            _same_classify(r["result"]["cls"], want["cls"])
    text = proc.stderr
    line = [s for s in text.splitlines()
            if s.startswith("[pipeline] served ")]
    assert len(line) == 1, text
    assert line[0].startswith("[pipeline] served lenetpipe=3 frozen=True "
                              "misses=4 "), line
    assert "pipelines ['lenetpipe']" in text
    # the DAG's runners with their calls: each bucket's zero batch at the
    # warm-up, then the requests' batches
    (runners,) = [json.loads(s.split(" ", 2)[2]) for s in text.splitlines()
                  if s.startswith("[pipeline] runners ")]
    calls = [b["calls"] for b in runners["lenetpipe"]["buckets"].values()]
    assert 2 + 1 <= sum(calls) <= 2 + 3, runners
    assert text.strip().splitlines()[-1].startswith("[serve] completed=")


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _serving(handler):
    srv = make_server(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def test_http_pipeline_route_answers_like_jax(lenet):
    """``POST /v1/pipeline/lenetpipe`` on the port's front and on
    ``serve.make_handler`` over the same weights: 200 with the same
    classes, probabilities to 1e-5; an empty name 404 on both."""
    import argparse

    jlenet = jax_models.load_served("lenet5", input_size=32, num_classes=10)
    variables = jax.tree_util.tree_map(np.asarray, jlenet.variables)
    port = load_served("lenet5", variables=variables, device="cpu",
                       input_size=32, num_classes=10)
    pipe = Pipeline(PipelineSpec.from_json(LENET_SPEC), {"lenet5": port})
    jpipe = jax_pipeline.Pipeline(
        jax_pipeline.PipelineSpec.from_json(LENET_SPEC), {"lenet5": jlenet})
    args = argparse.Namespace(timeout_s=30.0)
    xs = _lenet_inputs(2, seed=3)
    with _engine([port], buckets=(1, 4), pipelines=[pipe]) as eng, \
            JaxEngine([jlenet], mesh=create_mesh(1, 1), buckets=(1, 4),
                      pipelines=[jpipe]) as jeng:
        servers = [_serving(make_handler(eng, args)),
                   _serving(jax_serve_cli.make_handler(jeng, args))]
        try:
            (p, j) = [s.server_address[1] for s in servers]
            for x in xs:
                got = _post(p, "/v1/pipeline/lenetpipe",
                            {"input": x.tolist()})
                want = _post(j, "/v1/pipeline/lenetpipe",
                             {"input": x.tolist()})
                assert got[0] == want[0] == 200, (got, want)
                _same_classify(got[1]["result"]["cls"],
                               want[1]["result"]["cls"])
            assert _post(p, "/v1/pipeline/", {"input": []})[0] == \
                _post(j, "/v1/pipeline/", {"input": []})[0] == 404
            assert eng.stats()["pipelines"] == {"lenetpipe": 2}
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()


def test_replica_argv_forwards_the_pipelines():
    from deepvision_tpu_torch.serve import replica

    argv = replica.replica_argv(["lenet5"], device="cpu",
                                pipelines=["a.json", "b.json"])
    assert argv[-6:] == ["--pipelines", "a.json", "--pipelines", "b.json",
                         "--device", "cpu"]


def test_fleet_routes_the_pipeline_name_to_a_replica(lenet, tmp_path,
                                                     monkeypatch):
    from deepvision_tpu_torch.serve.__main__ import main

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(LENET_SPEC))
    xs = _lenet_inputs(2, seed=5)
    lines = [json.dumps({"id": i, "pipeline": "lenetpipe",
                         "input": x.tolist()}) + "\n"
             for i, x in enumerate(xs)]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["--fleet", "1", "-m", "lenet5", "--device", "cpu",
                   "--seed", "0", "--buckets", "1,4", "--pipelines",
                   str(spec)], stdin=iter(lines), stdout=out)
    assert rc == 0, err.getvalue()
    assert not torch.cuda.is_initialized()  # the router touched no device
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    assert [r["id"] for r in replies] == [0, 1], replies
    with _lenet_engine(lenet) as eng:
        for r, x in zip(replies, xs):
            want = eng.submit(x, model="lenetpipe").result(timeout=60)
            _same_classify(r["result"]["cls"], want["cls"])
    (log,) = tmp_path.glob("dvt-replica-*/replica.log")
    text = log.read_text()
    assert "[pipeline] served lenetpipe=2 frozen=True" in text, text
