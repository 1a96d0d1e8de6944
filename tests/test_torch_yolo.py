"""The port's YOLO v3 path against the JAX package's, on the CPU.

Ops, loss and NMS take the same seeded numpy inputs on both sides:
float32 values to atol 1e-5 and rtol 1e-5 (NaN and inf where the JAX
function gives them: a planted ``exp`` overflow), indices, classes and
masks exactly. The grid encoder is held bit for bit, with two boxes
planted on one (cell, anchor) slot (trap C16: XLA's scatter keeps the
last in index order). NMS keeps identical indices, with planted equal
scores (trap C17) and pairs whose IoU lies within ulps of the threshold
(trap C18). The JAX NMS runs op by op there (``jax.disable_jit``):
jitted, XLA:CPU contracts ``area_a``'s product into the sum with
``area_b`` (a fused multiply-add), which moves some of those pairs
across the threshold; op by op, each float32 operation rounds on its
own, as ``broadcast_iou`` writes them and as the port and its CUDA
kernel compute them.

``yolov3`` runs at full depth and width (Darknet-53 and the three heads)
with 3 classes on weights carried from flax (``convert.from_flax``): the
eval grids to 1e-4, ``darknet53``'s logits, and three float32 Adam
steps, whose loss, components, parameters, both moments and BN
statistics are held leaf by leaf to 1e-5 plus three times the float32
floor that two reordered JAX runs give (PR 5/6's rule: leaky ReLUs flip
near 0, and under Adam a gradient near 0 that flips sign moves its
parameter by the learning rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.losses import yolo as jax_loss
from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.ops import iou as jax_iou
from deepvision_tpu.ops import nms as jax_nms
from deepvision_tpu.ops import yolo_decode as jax_decode
from deepvision_tpu.ops import yolo_encode as jax_encode
from deepvision_tpu.ops import yolo_postprocess as jax_post
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.state import TrainState as JaxTrainState
from deepvision_tpu.train.steps import yolo_eval_step as jax_eval_step
from deepvision_tpu.train.steps import yolo_train_step as jax_train_step
from deepvision_tpu_torch.convert.from_flax import (
    flax_param_tree_to_torch,
    flax_to_torch,
)
from deepvision_tpu_torch.losses import yolo as port_loss
from deepvision_tpu_torch.models import create_model, get_model, layers
from deepvision_tpu_torch.ops import iou, nms, yolo_decode, yolo_encode
from deepvision_tpu_torch.ops.yolo_postprocess import yolo_postprocess
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer, set_lr_scale
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import yolo_eval_step, yolo_train_step
from tests.test_torch_inception import _draw
from tests.test_torch_train import _find, _leaf_gap
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
TOL = {"atol": 1e-5, "rtol": 1e-5}
CLASSES = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _boxes(rng, b, m, max_real=4):
    """Padded xywh boxes ``(b, m, 4)`` and labels ``(b, m)``: 1 to
    ``max_real`` real rows an image, zero rows and -1 after."""
    boxes = np.zeros((b, m, 4), np.float32)
    labels = np.full((b, m), -1, np.int32)
    for i in range(b):
        for j in range(int(rng.integers(1, max_real + 1))):
            w, h = rng.uniform(0.02, 0.8, 2)
            boxes[i, j] = [rng.uniform(w / 2, 1 - w / 2),
                           rng.uniform(h / 2, 1 - h / 2), w, h]
            labels[i, j] = rng.integers(0, CLASSES)
    return boxes, labels


# ------------------------------------------------------ iou and decode


def test_iou_conversions_and_bce_match_jax():
    rng = np.random.default_rng(0)
    xywh = rng.uniform(0, 1, (3, 7, 4)).astype(np.float32)
    xywh[0, 0, 2:] = [np.inf, 0.0]  # an overflowed box: inf, NaN out
    corners = jax_iou.xywh_to_corners(xywh)
    _close(iou.xywh_to_corners(_t(xywh)), corners)
    _close(iou.corners_to_xywh(_t(np.asarray(corners))),
           jax_iou.corners_to_xywh(corners))
    a = np.asarray(corners)
    b = rng.uniform(0, 1, (3, 5, 4)).astype(np.float32)
    b[..., 2:] += b[..., :2]
    want = np.asarray(jax.jit(jax_iou.broadcast_iou)(a, b))
    assert np.isnan(want).any()
    _close(iou.broadcast_iou(_t(a), _t(b)), want)
    p = rng.uniform(-0.1, 1.1, (4, 9)).astype(np.float32)
    y = (rng.uniform(0, 1, (4, 9)) < 0.3).astype(np.float32)
    p[0, 0] = np.nan
    _close(iou.binary_cross_entropy(_t(p), _t(y)),
           jax.jit(jax_iou.binary_cross_entropy)(p, y))


def _grid(rng, b, s, overflow=False):
    g = rng.normal(0, 1.5, (b, s, s, 3, 5 + CLASSES)).astype(np.float32)
    if overflow:  # exp(t_wh) overflows float32 on a few cells
        g[0, 1, 1, 0, 2:4] = 100.0
        g[-1, 0, 0, 2, 3] = 95.0
    return g


@pytest.mark.parametrize("overflow", [False, True])
def test_decode_and_encode_relative_match_jax(overflow):
    rng = np.random.default_rng(1)
    anchors = jax_encode.ANCHORS_WH[3:6]
    g = _grid(rng, 2, 6, overflow)
    want = jax.jit(lambda y: jax_decode.decode_absolute(y, anchors,
                                                        CLASSES))(g)
    got = yolo_decode.decode_absolute(_t(g), anchors, CLASSES)
    for w, o in zip(want, got):
        _close(o, w)
    assert np.isinf(np.asarray(want[0])).any() == overflow
    true = np.abs(rng.normal(0, 0.3, (2, 6, 6, 3, 4))).astype(np.float32)
    true[:, ::2, :, :, 2:] = 0.0  # empty cells: zeros, not log(0)
    _close(yolo_decode.encode_relative(_t(true), anchors),
           jax.jit(lambda t: jax_decode.encode_relative(t, anchors))(true))


# ------------------------------------------------------- label grids


def _collided(rng, b=3, m=12):
    """Seeded boxes with three planted on one (cell, anchor) slot of the
    26² grid (centres near 0.5, wh about 0.1), in image 1."""
    boxes, labels = _boxes(rng, b, m)
    boxes[1, :3] = [[0.5, 0.5, 0.1, 0.1], [0.501, 0.502, 0.1, 0.1],
                    [0.503, 0.51, 0.1, 0.1]]
    labels[1, :3] = [0, 1, 2]
    return boxes, labels


def test_encode_labels_matches_jax_with_colliding_boxes():
    """Every grid bit for bit, the planted collision included: the last
    of the three boxes owns the slot (trap C16)."""
    rng = np.random.default_rng(2)
    boxes, labels = _collided(rng)
    sizes = (52, 26, 13)
    want = jax.jit(lambda b, lab: jax_encode.encode_labels(
        b, lab, CLASSES, grid_sizes=sizes))(boxes, labels)
    got = yolo_encode.encode_labels(_t(boxes), _t(labels), CLASSES,
                                    grid_sizes=sizes)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    anchor = int(jax_encode.best_anchor(jnp.asarray(boxes[1, :3, 2:]))[0])
    assert anchor // 3 == 1  # the 26² grid
    cell = got[1][1, 13, 13, anchor % 3]
    np.testing.assert_array_equal(cell[:4].numpy(), boxes[1, 2])
    assert cell[5 + 2] == 1.0 and cell[4] == 1.0
    assert int((got[1][1, 13, 13, :, 4] > 0).sum()) == 1
    # on padding rows nothing is written
    assert sum(int((g[..., 4] > 0).sum()) for g in got) <= int(
        (labels >= 0).sum())


def test_best_anchor_matches_jax():
    wh = np.random.default_rng(3).uniform(0, 1, (50, 2)).astype(np.float32)
    wh[:3] = jax_encode.ANCHORS_WH[[0, 4, 8]]  # exact anchors
    np.testing.assert_array_equal(
        yolo_encode.best_anchor(_t(wh)).numpy(),
        np.asarray(jax_encode.best_anchor(jnp.asarray(wh))))


# --------------------------------------------------------------- loss


@pytest.mark.parametrize("overflow", [False, True])
def test_yolo_loss_components_match_jax(overflow):
    """Per-image components over three scales, against the true boxes
    and without them (the grid's own cells), with a planted overflow."""
    rng = np.random.default_rng(4)
    boxes, labels = _collided(rng, b=2)
    sizes = (8, 4, 2)
    y_true = jax_encode.encode_labels(boxes, labels, CLASSES,
                                      grid_sizes=sizes)
    y_pred = [_grid(rng, 2, s, overflow) for s in sizes]
    for true_boxes in (boxes, None):
        want = jax.jit(lambda t, p, bx: jax_loss.yolo_loss(
            t, p, CLASSES, bx))(y_true, y_pred, true_boxes)
        got = port_loss.yolo_loss(
            [_t(t) for t in y_true], [_t(p) for p in y_pred], CLASSES,
            None if true_boxes is None else _t(true_boxes))
        assert set(got) == set(want) == {"loss", "xy", "wh", "class", "obj"}
        for k in want:
            assert got[k].shape == (2,)
            _close(got[k], want[k], atol=1e-5, rtol=1e-5)
    one = jax_loss.yolo_scale_loss(y_true[0], y_pred[0],
                                   jax_encode.ANCHORS_WH[:3], CLASSES, boxes)
    mine = port_loss.yolo_scale_loss(_t(y_true[0]), _t(y_pred[0]),
                                     jax_encode.ANCHORS_WH[:3], CLASSES,
                                     _t(boxes))
    for k in one:
        _close(mine[k], one[k])


# ---------------------------------------------------------------- NMS


def _near_pairs(rng, n):
    """``2n`` corner boxes: pairs of equal boxes shifted by a third of
    their width, whose IoU is 1/2 up to float32 rounding, jittered by a
    few ulps."""
    w = rng.uniform(0.05, 0.3, n).astype(np.float32)
    h = rng.uniform(0.05, 0.3, n).astype(np.float32)
    x = rng.uniform(0, 0.6, n).astype(np.float32)
    y = rng.uniform(0, 0.6, n).astype(np.float32)
    d = (w / np.float32(3)).astype(np.float32)
    d = np.nextafter(d, np.where(rng.random(n) < 0.5, 0, 1).astype(
        np.float32)) if n else d
    a = np.stack([x, y, x + w, y + h], -1)
    b = np.stack([x + d, y, x + d + w, y + h], -1)
    return np.concatenate([a, b]).astype(np.float32)


def _fma_iou(a, b):
    """IoU with ``area_a + area_b`` contracted (``area_a``'s product
    fused into the sum, rounded once), the other operations as
    ``broadcast_iou``: what jitted XLA:CPU computes."""
    f, d = np.float32, np.float64
    lo = np.maximum(a[:, :2], b[:, :2])
    hi = np.minimum(a[:, 2:], b[:, 2:])
    iw = np.maximum(hi - lo, f(0))
    inter = iw[:, 0] * iw[:, 1]
    aw, ah = np.maximum(a[:, 2] - a[:, 0], f(0)), np.maximum(
        a[:, 3] - a[:, 1], f(0))
    area_b = np.maximum(b[:, 2] - b[:, 0], f(0)) * np.maximum(
        b[:, 3] - b[:, 1], f(0))
    s = (d(aw) * d(ah) + d(area_b)).astype(f)
    return inter / np.maximum(s - inter, f(1e-9))


def _nms_batch(seed, b, n, ties=False, near=0):
    """Seeded corners, scores and classes: ``ties`` sets a third of the
    scores to exactly 1.0 and others to a few repeated values (trap C17);
    ``near`` plants that many near-threshold pairs, both boxes scored
    above every other box (trap C18)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 1, (b, n, 2))
    wh = rng.uniform(0.02, 0.3, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if ties:
        scores[rng.uniform(0, 1, (b, n)) < 0.33] = 1.0
        rep = rng.uniform(0, 1, (b, n)) < 0.2
        scores[rep] = np.float32(0.75)
    if near:
        for i in range(b):
            boxes[i, :2 * near] = _near_pairs(rng, near)
            order = np.arange(2 * near).reshape(2, near).T.ravel()
            boxes[i, :2 * near] = boxes[i, order]  # a, b of a pair adjacent
            scores[i, :2 * near] = np.linspace(1.0, 0.99, 2 * near)
    classes = rng.integers(0, 20, (b, n)).astype(np.int32)
    return boxes, scores, classes


NMS_CASES = {
    "random": dict(seed=0, b=2, n=700),
    "ties": dict(seed=1, b=1, n=700, ties=True),
    "near_threshold": dict(seed=2, b=1, n=600, near=120),
    "fewer_than_k": dict(seed=3, b=1, n=300, ties=True),
    "fewer_than_max_out": dict(seed=4, b=2, n=40),
}


@pytest.mark.parametrize("case,score_thresh", [
    ("random", 0.5), ("random", 0.05), ("ties", 0.5), ("ties", 0.05),
    ("near_threshold", 0.5), ("fewer_than_k", 0.05),
    ("fewer_than_max_out", 0.5)])
def test_batched_nms_keeps_the_jax_indices(case, score_thresh):
    boxes, scores, classes = _nms_batch(**NMS_CASES[case])
    with jax.disable_jit():
        want = jax_nms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(classes),
                                   score_thresh=score_thresh)
        # one image through nms_indices too: its indices, dead slots'
        # included
        want_idx = jax_nms.nms_indices(jnp.asarray(boxes[0]),
                                       jnp.asarray(scores[0]),
                                       score_thresh=score_thresh)
    got = nms.batched_nms(_t(boxes), _t(scores), _t(classes),
                          score_thresh=score_thresh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mine = nms.nms_indices(_t(boxes[0]), _t(scores[0]),
                           score_thresh=score_thresh)
    for g, x in zip(mine, want_idx):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    n_cand = got[-1].numpy()
    assert (n_cand == (scores >= score_thresh).sum(-1)).all()
    if case == "random" and score_thresh == 0.05:
        assert n_cand.min() > nms.NMS_CANDIDATE_CAP  # the tripwire


def test_planted_pairs_straddle_the_threshold_under_a_contraction():
    """The near-threshold pairs are ones where the arithmetic decides:
    a contracted multiply-add moves some across 0.5 against the
    operation-by-operation IoU, which the port (and jax op by op) give,
    and the plain sweep keeps exactly jax's survivors."""
    rng = np.random.default_rng(5)
    pairs = _near_pairs(rng, 2000)
    a, b = pairs[:2000], pairs[2000:]
    strict = iou.broadcast_iou(_t(a)[:, None], _t(b)[:, None])[:, 0, 0]
    with jax.disable_jit():
        eager = np.asarray(jax.vmap(lambda p, q: jax_iou.broadcast_iou(
            p[None], q[None])[0, 0])(a, b))
    np.testing.assert_array_equal(strict.numpy(), eager)
    contracted = _fma_iou(a, b)
    flips = (contracted > 0.5) != (strict.numpy() > 0.5)
    assert flips.sum() > 0 and (strict.numpy() > 0.5).sum() > 0
    boxes, _, _ = _nms_batch(seed=6, b=1, n=300, near=100)
    alive = nms.nms_sweep_reference(
        _t(boxes), torch.ones(1, 300, dtype=torch.bool), 0.5)
    with jax.disable_jit():
        idx, _, valid, _ = jax_nms.nms_indices(
            jnp.asarray(boxes[0]), jnp.ones(300), score_thresh=0.0,
            candidate_cap=300, max_out=300)
    kept = np.sort(np.asarray(idx)[np.asarray(valid)])
    np.testing.assert_array_equal(torch.nonzero(alive[0])[:, 0].numpy(),
                                  kept)
    assert 0 < len(kept) < 300


def test_nms_sweep_takes_the_plain_version_only_on_the_cpu():
    boxes = torch.zeros(1, 4, 4)
    alive = torch.ones(1, 4, dtype=torch.bool)
    np.testing.assert_array_equal(nms.nms_sweep(boxes, alive, 0.5).numpy(),
                                  [[True] * 4])
    with pytest.raises(ValueError, match="no NMS sweep"):
        nms.nms_sweep(boxes.to("meta"), alive.to("meta"), 0.5)


def test_yolo_postprocess_matches_jax_on_planted_boxes():
    """Raw grids of a 64 px input (8², 4², 2²) with a few cells planted
    confident: boxes and scores (sigmoids, an ulp apart) to 1e-5,
    classes, valid and the candidate counts exactly."""
    rng = np.random.default_rng(7)
    grids = [_grid(rng, 2, s) for s in (8, 4, 2)]
    for g in grids:
        g[..., 4] -= 3.0  # most cells unconfident
    grids[0][0, 3, 4, 1, 4] = grids[1][0, 1, 1, 0, 4] = 8.0
    grids[2][1, 0, 1, 2, 4] = grids[0][1, 5, 5, 0, 4] = 6.0
    grids[0][1, 5, 6, 0, 4] = 6.0  # overlaps its neighbour
    for thresh in (0.5, 0.05):
        with jax.disable_jit():
            want = jax_post.yolo_postprocess(grids, CLASSES,
                                             score_thresh=thresh)
        got = yolo_postprocess([_t(g) for g in grids], CLASSES,
                               score_thresh=thresh)
        _close(got[0], want[0])
        _close(got[1], want[1])
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].sum() > 0


# -------------------------------------------------------------- model


def flax_variables(name, size, seed=0, gain=2.0, classes=CLASSES):
    model = flax_get_model(name, num_classes=classes)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=True), jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng, gain), shapes)


def port_module(name, variables, size, classes=CLASSES):
    kw = {"num_classes": classes, "input_size": size}
    module = get_model(name, **kw)
    module.load_state_dict(flax_to_torch(name, variables, **kw))
    return module.to(memory_format=torch.channels_last)


def _images(n, size, seed=1):
    return (np.random.default_rng(seed).normal(0, 1, (n, size, size, 3))
            .astype(np.float32))


@pytest.mark.parametrize("size", [64, 96])
def test_yolov3_eval_grids_match_flax(size):
    model, variables = flax_variables("yolov3", size)
    x = _images(2, size)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = port_module("yolov3", variables, size)(torch.from_numpy(x))
    for g, w, s in zip(got, want, (8, 16, 32)):
        assert g.shape == (2, size // s, size // s, 3, 5 + CLASSES)
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_darknet53_logits_match_flax():
    model, variables = flax_variables("darknet53", 64, classes=10)
    x = _images(2, 64, seed=2)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port_module("darknet53", variables, 64,
                          classes=10)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_geometry_parameter_count_and_stride_2_pads():
    """61.6 M parameters at 20 classes, as flax counts them; every
    stride-2 3x3 down convolution pads (0, 1) at 416 and at the test
    sizes, as XLA's SAME does (trap C2)."""
    _, variables = flax_variables("yolov3", 64, classes=20)
    module = get_model("yolov3", num_classes=20)
    want = sum(np.size(v) for v in
               jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in module.parameters()) == want
    assert 61.5e6 < want < 61.7e6
    for size in (416, 64, 96):
        side = size
        for stage in range(5):
            down = getattr(module.backbone, f"down{stage}")
            x = torch.zeros(1, side, side, 1)
            assert layers.conv_padding(x, down.conv, down.padding) == [
                (0, 1), (0, 1)], (size, stage)
            side //= 2
    with torch.device("meta"):
        out = module.to("meta")(torch.zeros(1, 416, 416, 3, device="meta"))
    assert [tuple(o.shape[1:3]) for o in out] == [(52, 52), (26, 26),
                                                  (13, 13)]


def test_fresh_init_follows_the_jax_initializers():
    """ConvBN kernels ``he_normal`` (fan out), ``out`` and ``head`` flax's
    default ``lecun_normal`` (fan in) with zero biases."""
    module = create_model("yolov3", device=CPU, seed=0, num_classes=20)
    module.requires_grad_(False)
    w = module.head_large.out.weight  # (75, 1024, 1, 1)
    assert float(w.std()) == pytest.approx(np.sqrt(1 / 1024), rel=0.05)
    assert not module.head_large.out.bias.any()
    k = module.backbone.stage3_block0.expand.conv.weight  # (512, 256, 3, 3)
    assert float(k.std()) == pytest.approx(np.sqrt(2 / (512 * 9)),
                                           rel=0.05)
    clf = create_model("darknet53", device=CPU, seed=0, num_classes=10)
    assert float(clf.head.weight.detach().std()) == pytest.approx(
        np.sqrt(1 / 1024), rel=0.15)


# --------------------------------------------------------- train step


# 128 px: at 64 px the stride-32 BatchNorms see 16 values a channel, and
# float32 rounding moves their gradients by tens of percent on either
# side
STEP_SIZE, STEP_BATCH = 128, 4
# the plateau's LR scale of the runs: 1e-4 for Adam's 0.01, which keeps
# three steps from drawn weights well inside float32's reach
LR_SCALE = 0.01


def _step_batch(seed):
    rng = np.random.default_rng(seed)
    boxes, labels = _boxes(rng, STEP_BATCH, 100)
    return {"image": _images(STEP_BATCH, STEP_SIZE, seed=seed + 50),
            "boxes": boxes, "label": labels}


def _jax_state(variables):
    cfg = jax_get_config("yolov3")
    model = flax_get_model("yolov3", num_classes=CLASSES)
    tx, _ = jax_optimizers.make_optimizer(cfg, 1)
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax_optimizers.set_lr_scale(tx.init(params), LR_SCALE),
        apply_fn=model.apply, tx=tx)


def _port_state(variables, b1=None):
    module = port_module("yolov3", variables, STEP_SIZE)
    cfg = get_config("yolov3")
    if b1 is not None:
        cfg["optimizer_params"]["beta1"] = b1
    opt, plateau = make_optimizer(cfg, module.parameters())
    assert isinstance(opt, torch.optim.Adam) and plateau is not None
    set_lr_scale(opt, LR_SCALE)
    return TrainState(module, opt)


def _leaves(jstate):
    """The JAX state's model leaves and Adam moments in the port's
    names."""
    host = jax.tree.map(np.asarray, jstate)
    kw = {"num_classes": CLASSES, "input_size": STEP_SIZE}
    adam = _find(host.opt_state, optax.ScaleByAdamState)
    out = flax_to_torch("yolov3", {"params": host.params,
                                   "batch_stats": host.batch_stats}, **kw)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        out.update({f"{n}:{key}": t for n, t in
                    flax_param_tree_to_torch("yolov3", tree, **kw).items()})
    return out


def _port_leaves(state):
    out = {k: v.detach().clone() for k, v in
           state.module.state_dict().items()}
    for name, p in state.module.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{name}:{key}"] = state.optimizer.state[p][key].clone()
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# the reorderings whose JAX runs give each leaf its float32 floor
ORDERS = (lambda a: a[::-1].copy(), lambda a: np.roll(a, 1, axis=0),
          lambda a: np.roll(a, 2, axis=0), lambda a: np.roll(a, 3, axis=0))
STEPS = 3


def _hold(got, want, tol, max_flip):
    """Each leaf within ``tol[leaf]`` of ``want``, but for at most 0.1%
    of its elements (at least one), each within ``max_flip``: Adam's
    first updates are ``±lr`` for any gradient above its eps, so a
    gradient that float32 rounding moves across 0 turns its parameter's
    update around (2·lr a step), and the reordered JAX runs need not hit
    the same element."""
    for key, tensor in got.items():
        gap = (tensor - want[key]).abs()
        over = gap > tol[key]
        assert int(over.sum()) <= max(1, gap.numel() // 1000), (
            key, int(over.sum()), float(gap.max()), tol[key])
        assert float(gap.max()) <= tol[key] + max_flip, (key, float(gap.max()))


def test_yolov3_f32_adam_steps_match_jax():
    """Three f32 steps of the config's Adam (plateau scale 0.01, so lr
    1e-4) on carried weights at 128 px, batch 4. Four more JAX runs, on
    each batch reversed and rolled by 1, 2 and 3, give the float32
    floors: each step's loss and components within 1e-4 plus four times
    theirs, then every parameter, BN statistic and Adam moment within
    1e-5 plus three times its own (``_hold``: a few elements of a leaf
    may differ by an update turned around). The state before the steps,
    and the steps without Adam's first moment (b1 = 0), each fail that
    on most leaves."""
    _, variables = flax_variables("yolov3", STEP_SIZE, seed=3, gain=1.0)
    jstep = jax.jit(jax_train_step)
    jstate = _jax_state(variables)
    reordered = [jstate] * len(ORDERS)
    state, twin = _port_state(variables), _port_state(variables, b1=0.0)
    for i in range(STEPS):
        batch = _step_batch(i)
        jstate, jm = jstep(jstate, batch, jax.random.key(i))
        floors = dict.fromkeys(jm, 0.0)
        for j, order in enumerate(ORDERS):
            reordered[j], fm = jstep(
                reordered[j], {k: order(v) for k, v in batch.items()},
                jax.random.key(i))
            for k in floors:
                floors[k] = max(floors[k], abs(float(fm[k]) - float(jm[k])))
        m = yolo_train_step(state, _torch(batch), None)
        yolo_train_step(twin, _torch(batch), None)
        assert set(m) == {"loss", "xy", "wh", "class", "obj"}
        for k in m:
            assert abs(float(m[k]) - float(jm[k])) <= (
                1e-4 * abs(float(jm[k])) + 4 * floors[k]), (i, k, floors)
    assert state.step == STEPS
    want = _leaves(jstate)
    floors = [_leaves(s) for s in reordered]
    tol = {k: 1e-5 + 3 * max(_leaf_gap(f[k], want[k]) for f in floors)
           for k in want}
    got = _port_leaves(state)
    assert set(got) == set(want)
    lr = state.optimizer.param_groups[0]["lr"]
    _hold(got, want, tol, max_flip=2 * lr * STEPS)
    start = {**_port_state(variables).module.state_dict(),
             **{k: torch.zeros_like(v) for k, v in want.items() if ":" in k}}
    for wrong in (start, _port_leaves(twin)):
        beyond = [k for k in want if _leaf_gap(wrong[k], want[k]) > tol[k]]
        assert len(beyond) > len(want) // 2, (len(beyond), len(want))


def test_yolo_eval_step_sums_match_jax_with_a_padded_tail():
    _, variables = flax_variables("yolov3", STEP_SIZE, seed=4, gain=1.0)
    batch = _step_batch(7)
    batch["mask"] = np.array([1, 1, 1, 0], np.float32)
    want = jax.jit(jax_eval_step)(_jax_state(variables), batch)
    got = yolo_eval_step(_port_state(variables), _torch(batch))
    assert float(got["count"]) == float(want["count"]) == 3.0
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-4)
    unmasked = yolo_eval_step(_port_state(variables),
                              _torch({**batch, "mask": np.ones(4,
                                                               np.float32)}))
    assert float(unmasked["loss_sum"]) > float(got["loss_sum"])
