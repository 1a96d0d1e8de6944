"""The port's CenterNet path against the JAX package's, on the CPU.

The encoder, the peak decode and the losses take the same seeded numpy
inputs on both sides. The encoder's ``wh``, ``offset`` and ``mask`` are
held bit for bit, with boxes planted on one centre cell and padding rows
that must not write cell (0, 0) (trap C19: XLA's scatter keeps the last
box in index order and drops the padding). Its radius and heatmap pass
through ``sqrt`` and ``exp``, which XLA:CPU does not round as ATen does:
the radius within two float32 ulps of ``h + w`` (each case subtracts a
square root of that size from that size), the heatmap within 1e-6, its
support cell for cell. The decode keeps identical indices and
classes with planted equal scores, a saturated head and fewer peaks than
K (trap C20: ``lax.top_k`` breaks ties toward the lower index); scores
and boxes to 1e-6. Losses to rtol 1e-5.

``CenterNet`` runs at full width (the order-5 large hourglass) on
weights carried from flax (``convert.from_flax``) at 128 px, batch 2,
with one and two stacks (the re-injection): the eval outputs, and the
train-mode outputs (at 256 px) with the BN statistics they leave, to 1e-4 of each
output's scale. The stem pads (2, 3) at 256 and 128, as XLA's SAME does
(trap C2). Three float32 Adam steps of one stack at 256 px and batch 4
are held leaf by leaf to 1e-5 plus three times the float32 floor that
four reordered JAX runs give (the YOLO v3 steps' rule); one bf16 step is held to the
JAX bf16 step. Train-mode BatchNorm at the recursion's bottom sees
``(size / 128)² · batch`` values a channel, too few for float32 at 128 px
and batch 2, so the train-mode checks and the steps run at 256 px. The served detect head equals the JAX
``_centernet_forward``; the CLI trains, resumes, serves and evaluates.
"""

import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.losses import centernet as jax_loss
from deepvision_tpu.models.centernet import CenterNet as FlaxCenterNet
from deepvision_tpu.ops import centernet_decode as jax_decode
from deepvision_tpu.ops import centernet_encode as jax_encode
from deepvision_tpu.serve.models import (
    _centernet_forward as jax_centernet_forward,
)
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.state import TrainState as JaxTrainState
from deepvision_tpu.train.steps import centernet_eval_step as jax_eval_step
from deepvision_tpu.train.steps import centernet_train_step as jax_train_step
from deepvision_tpu_torch.convert.from_flax import (
    flax_param_tree_to_torch,
    flax_to_torch,
)
from deepvision_tpu_torch.losses import centernet as port_loss
from deepvision_tpu_torch.models import create_model, get_model, layers
from deepvision_tpu_torch.models.centernet import BN_MOMENTUM, CenterNet
from deepvision_tpu_torch.ops import centernet_decode, centernet_encode
from deepvision_tpu_torch.serve.__main__ import main as serve_main
from deepvision_tpu_torch.serve.models import load_served
from deepvision_tpu_torch.train.__main__ import main as train_main
from deepvision_tpu_torch.eval.__main__ import main as eval_main
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer, set_lr_scale
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import (
    centernet_eval_step,
    centernet_train_step,
)
from tests.test_torch_inception import _draw
from tests.test_torch_train import _find, _leaf_gap
from tests.test_torch_yolo import _boxes, _hold, _torch
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
CLASSES = 3
SIZE = 128  # the order-5 recursion needs a 32² stem output
# train-mode BatchNorm at the recursion's bottom sees (SIZE / 128)² · B
# values a channel: at 128 px and batch 2, two nearly equal ones, whose
# normalized difference float32 rounding flips; the train-mode checks
# and the steps run at 256 px, where it sees 4 · B
TRAIN_SIZE = 256


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- encode


def test_gaussian_radius_matches_jax():
    """Within two float32 ulps of ``h + w``: each case subtracts a
    square root of about ``h + w`` from about ``h + w``, and XLA:CPU's
    square root is not ATen's correctly rounded one."""
    rng = np.random.default_rng(0)
    h = rng.uniform(0, 40, 4000).astype(np.float32)
    w = rng.uniform(0, 40, 4000).astype(np.float32)
    h[:5] = [0, 0, 1, 2.5, 40]
    w[:5] = [0, 3, 1, 0, 40]
    want = np.asarray(jax.jit(jax_encode.gaussian_radius)(h, w))
    got = centernet_encode.gaussian_radius(_t(h), _t(w)).numpy()
    bound = 2 * np.finfo(np.float32).eps * (h + w)
    assert (np.abs(got - want) <= bound).all()


def _planted(rng, b=3, m=12, g=32):
    """Padded boxes with three planted collisions on centre cells (two
    in image 0, the later of them a smaller box; three in image 1) and
    padding rows after them (zero boxes, label -1) that a dropped write
    keeps out of cell (0, 0)."""
    boxes, labels = _boxes(rng, b, m, max_real=6)
    cell = (np.float32(10.25) / g, np.float32(7.5) / g)
    boxes[0, 0] = [cell[0], cell[1], 0.3, 0.2]
    boxes[0, 1] = [cell[0] + 0.1 / g, cell[1] + 0.2 / g, 0.1, 0.05]
    labels[0, :2] = [1, 2]
    for j in range(3):
        boxes[1, j] = [0.5 + 0.3 * j / g, 0.5, 0.1 + 0.1 * j, 0.2]
        labels[1, j] = j % CLASSES
    return boxes, labels


def test_encode_centernet_matches_jax_with_colliding_centres():
    """Trap C19: ``wh``, ``offset`` and ``mask`` bit for bit (the later
    box owns a shared centre; padding never writes cell (0, 0)); the
    heatmap within 1e-6 on the same support."""
    rng = np.random.default_rng(1)
    boxes, labels = _planted(rng)
    enc = jax.jit(jax_encode.encode_centernet, static_argnums=(2, 3))
    want = {k: np.asarray(v) for k, v in
            enc(boxes, labels, CLASSES, 32).items()}
    got = {k: v.numpy() for k, v in centernet_encode.encode_centernet(
        _t(boxes), _t(labels), CLASSES, 32).items()}
    for k in ("wh", "offset", "mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["heatmap"] > 0, want["heatmap"] > 0)
    np.testing.assert_allclose(got["heatmap"], want["heatmap"], atol=1e-6)
    # the planted owners: the last box in index order
    assert got["mask"][0, 7, 10] == 1.0 and got["mask"][0, 0, 0] == 0.0
    np.testing.assert_array_equal(got["wh"][0, 7, 10],
                                  boxes[0, 1, 2:] * np.float32(32))
    ix = int(np.float32(0.5 + 0.6 / 32) * 32)
    np.testing.assert_array_equal(got["wh"][1, 16, ix],
                                  boxes[1, 2, 2:] * np.float32(32))
    assert got["mask"].sum() < (labels >= 0).sum()  # the collisions
    assert got["heatmap"].max() == 1.0


# ------------------------------------------------------------- decode


def _decode_case(kind, rng, b=2, g=16, c=CLASSES):
    heat = rng.normal(-3, 2, (b, g, g, c)).astype(np.float32)
    if kind == "equal":  # plateaus of equal peaks: every cell ties
        heat[0, ::4, ::4, 1] = 2.0
        heat[1, 2:6, 2:6, 0] = 1.5
    elif kind == "saturated":  # sigmoid 1.0 ties across the map
        heat[0] = 40.0
        heat[1, :, :8] = 30.0
    elif kind == "few_peaks":  # one peak a channel: 0.0 ties after them
        yy, xx = np.mgrid[:g, :g]
        for i in range(b):
            for ch in range(c):
                py, px = rng.integers(0, g, 2)
                heat[i, ..., ch] = 2.0 - np.hypot(yy - py, xx - px)
    wh = rng.uniform(0, 8, (b, g, g, 2)).astype(np.float32)
    off = rng.uniform(0, 1, (b, g, g, 2)).astype(np.float32)
    return heat, wh, off


@pytest.mark.parametrize("kind", ["random", "equal", "saturated",
                                  "few_peaks"])
def test_decode_centernet_keeps_the_jax_order(kind):
    """Trap C20: indices (through the boxes' cells) and classes
    identical to ``lax.top_k``'s, equal scores in index order."""
    heat, wh, off = _decode_case(kind, np.random.default_rng(2))
    c = heat.shape[-1]
    want = jax.jit(jax_decode.decode_centernet)(heat, wh, off)
    got = centernet_decode.decode_centernet(_t(heat), _t(wh), _t(off))
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), atol=1e-6)
    if kind == "few_peaks":
        assert (got["scores"].numpy()[:, :c] > 0).all()
        assert (got["scores"].numpy()[:, c:] == 0).all()


# -------------------------------------------------------------- losses


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    boxes, labels = _planted(rng)
    targets = jax.jit(jax_encode.encode_centernet, static_argnums=(2, 3))(
        boxes, labels, CLASSES, 32)
    outputs = [tuple(rng.normal(m, 2, (3, 32, 32, c)).astype(np.float32)
                     for m, c in ((-2, CLASSES), (3, 2), (0.5, 2)))
               for _ in range(2)]
    t_targets = {k: _t(v) for k, v in targets.items()}
    t_outputs = [tuple(_t(o) for o in s) for s in outputs]
    tol = {"rtol": 1e-5, "atol": 1e-6}
    for per_sample in (False, True):
        want = jax_loss.centernet_loss(targets, outputs,
                                       per_sample=per_sample)
        got = port_loss.centernet_loss(t_targets, t_outputs,
                                       per_sample=per_sample)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **tol, err_msg=k)
    heat = outputs[0][0]
    np.testing.assert_allclose(
        port_loss.centernet_focal_loss(_t(heat), t_targets["heatmap"],
                                       per_sample=True).numpy(),
        np.asarray(jax_loss.centernet_focal_loss(
            heat, targets["heatmap"], per_sample=True)), **tol)
    np.testing.assert_allclose(
        port_loss.masked_l1(_t(outputs[0][1]), t_targets["wh"],
                            t_targets["mask"]).numpy(),
        np.asarray(jax_loss._masked_l1(outputs[0][1], targets["wh"],
                                       targets["mask"])), **tol)


# -------------------------------------------------------------- model


def flax_variables(num_stacks, size=SIZE, seed=0, gain=1.0):
    model = FlaxCenterNet(num_classes=CLASSES, num_stacks=num_stacks)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=True), jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng, gain), shapes)


def port_module(variables, num_stacks):
    kw = {"num_classes": CLASSES, "num_stacks": num_stacks}
    module = get_model("centernet", **kw)
    module.load_state_dict(flax_to_torch("centernet", variables, **kw))
    return module.to(memory_format=torch.channels_last)


def _images(n, size=SIZE, seed=1):
    return (np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3))
            .astype(np.float32))


def _close_outputs(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("num_stacks", [1, 2])
def test_centernet_outputs_and_bn_statistics_match_flax(num_stacks):
    """Eval outputs at 128 px, then train-mode outputs and the BN
    statistics they leave (flax's momentum 0.99) at 256 px, on carried
    weights: to rtol 1e-4 plus three times float32's floor, the gap
    between two JAX runs on the batch and on it reversed (the second
    stack's recursion amplifies rounding to about 1e-3 of the scale)."""
    model, variables = flax_variables(num_stacks, seed=num_stacks)
    x = _images(2)
    module = port_module(variables, num_stacks)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert len(got) == num_stacks
    assert got[0][0].shape == (2, SIZE // 4, SIZE // 4, CLASSES)
    _close_outputs(got, want)
    # train mode at 256 px: float32's floor from a JAX run on the batch
    # reversed (reversed back)
    x = _images(2, size=TRAIN_SIZE)
    run = jax.jit(lambda v, x: model.apply(v, x, train=True,
                                           mutable=["batch_stats"]))
    want, mutated = run(variables, jnp.asarray(x))
    rev, rev_mutated = run(variables, jnp.asarray(x[::-1].copy()))
    with torch.no_grad():
        got = module(torch.from_numpy(x), train=True)
    for g, w, r in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want),
                       jax.tree_util.tree_leaves(rev)):
        w, r = np.asarray(w), np.asarray(r)[::-1]
        floor = np.abs(w - r).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=(
            1e-4 * np.abs(w).max() + 3 * floor))

    def stats_of(m):
        return flax_to_torch("centernet", {
            "params": variables["params"],
            "batch_stats": jax.tree.map(np.asarray, m["batch_stats"])},
            num_classes=CLASSES, num_stacks=num_stacks)

    stats, rev_stats = stats_of(mutated), stats_of(rev_mutated)
    before = flax_to_torch("centernet", variables, num_classes=CLASSES,
                           num_stacks=num_stacks)
    state = module.state_dict()
    names = [k for k in stats if k.endswith((".mean", ".var"))]
    for k in names:
        floor = _leaf_gap(stats[k], rev_stats[k])
        np.testing.assert_allclose(state[k].numpy(), stats[k].numpy(),
                                   rtol=1e-5, atol=1e-6 + 3 * floor,
                                   err_msg=k)
        assert not torch.equal(state[k], before[k]), k


def test_geometry_init_and_stem_pads():
    """110 M parameters at 80 classes and two stacks, as flax counts
    them; the 7x7/2 stem pads (2, 3) on an even side (trap C2) and the
    output grid is a quarter of the input; ``he_normal`` kernels (fan
    out), flax's default ``lecun_normal`` for ``remap_*``, the heat
    branches' bias -2.19, BN momentum 0.99."""
    model = FlaxCenterNet(num_classes=80)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=False), jax.random.PRNGKey(0),
        jnp.zeros((1, 128, 128, 3), jnp.float32))
    want = sum(int(np.prod(v.shape)) for v in
               jax.tree_util.tree_leaves(shapes["params"]))
    module = create_model("centernet", device=CPU, seed=0, num_classes=80)
    assert sum(p.numel() for p in module.parameters()) == want
    assert 109e6 < want < 111e6
    for size in (256, 128):
        x = torch.zeros(1, size, size, 3)
        assert layers.conv_padding(x, module.stem_conv, "SAME") == [
            (2, 3), (2, 3)]
    with torch.device("meta"):
        out = module.to("meta")(torch.zeros(1, 256, 256, 3, device="meta"))
    assert [tuple(o.shape) for o in out[-1]] == [
        (1, 64, 64, 80), (1, 64, 64, 2), (1, 64, 64, 2)]
    module = create_model("centernet", device=CPU, seed=0, num_classes=80)
    module.requires_grad_(False)
    k = module.hg0.inner4.inner3.inner2.inner1.bottom_0.conv2.weight
    assert k.shape == (512, 512, 3, 3)
    assert float(k.std()) == pytest.approx(np.sqrt(2 / (512 * 9)), rel=0.05)
    r = module.remap_prev0.weight  # (256, 256, 1, 1)
    assert float(r.std()) == pytest.approx(np.sqrt(1 / 256), rel=0.05)
    assert (module.head1_heat.out.bias == -2.19).all()
    assert not module.head1_wh.out.bias.any()
    assert not module.post0_conv.bias.any()
    assert module.stem_bn.momentum == BN_MOMENTUM == 0.99


# --------------------------------------------------------- train step


# the plateau's LR scale of the runs: 1e-4 for Adam's 1e-3
LR_SCALE = 0.1
STEP_BATCH, STEPS = 4, 3
ORDERS = (lambda a: a[::-1].copy(), lambda a: np.roll(a, 1, axis=0),
          lambda a: np.roll(a, 2, axis=0), lambda a: np.roll(a, 3, axis=0))


def _step_batch(seed):
    rng = np.random.default_rng(seed)
    boxes, labels = _boxes(rng, STEP_BATCH, 100)
    return {"image": _images(STEP_BATCH, TRAIN_SIZE, seed=seed + 50),
            "boxes": boxes, "label": labels}


def _jax_state(variables, model):
    tx, _ = jax_optimizers.make_optimizer(jax_get_config("centernet"), 1)
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax_optimizers.set_lr_scale(tx.init(params), LR_SCALE),
        apply_fn=model.apply, tx=tx)


def _port_state(variables, dtype=torch.float32, b1=None):
    kw = {"num_classes": CLASSES, "num_stacks": 1}
    module = get_model("centernet", dtype=dtype, **kw)
    module.load_state_dict(flax_to_torch("centernet", variables, **kw))
    cfg = get_config("centernet")
    if b1 is not None:
        cfg["optimizer_params"]["beta1"] = b1
    opt, plateau = make_optimizer(cfg, module.parameters())
    assert isinstance(opt, torch.optim.Adam) and plateau is not None
    set_lr_scale(opt, LR_SCALE)
    return TrainState(module, opt)


def _leaves(jstate):
    host = jax.tree.map(np.asarray, jstate)
    kw = {"num_classes": CLASSES, "num_stacks": 1}
    adam = _find(host.opt_state, optax.ScaleByAdamState)
    out = flax_to_torch("centernet", {"params": host.params,
                                      "batch_stats": host.batch_stats}, **kw)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        out.update({f"{n}:{key}": t for n, t in
                    flax_param_tree_to_torch("centernet", tree,
                                             **kw).items()})
    return out


def _port_leaves(state):
    out = {k: v.detach().clone() for k, v in
           state.module.state_dict().items()}
    for name, p in state.module.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{name}:{key}"] = state.optimizer.state[p][key].clone()
    return out


@pytest.fixture(scope="module")
def one_stack():
    return flax_variables(1, TRAIN_SIZE, seed=5)


def test_centernet_f32_adam_steps_match_jax(one_stack):
    """Three f32 steps of the config's Adam (plateau scale 0.1, lr 1e-4)
    on carried weights, one stack at 256 px, batch 4: each step's loss
    and parts within 1e-4 plus four times their floor (four more JAX runs
    on the batch reversed and rolled by 1, 2 and 3), then every
    parameter, BN statistic
    and Adam moment within 1e-5 plus three times its own (a few elements
    of a leaf may differ by an update turned around). The state before
    the steps, and the steps without Adam's first moment, fail that on
    over a quarter of the leaves (the deep leaves' floors are wide: the
    recursion's bottom BatchNorms see 16 values a channel)."""
    model, variables = one_stack
    jstep = jax.jit(jax_train_step)
    jstate = _jax_state(variables, model)
    reordered = [jstate] * len(ORDERS)
    state, twin = _port_state(variables), _port_state(variables, b1=0.0)
    for i in range(STEPS):
        batch = _step_batch(i)
        jstate, jm = jstep(jstate, batch, jax.random.key(i))
        floors = dict.fromkeys(("loss", "heatmap_loss", "wh_loss",
                                "offset_loss"), 0.0)
        for j, order in enumerate(ORDERS):
            reordered[j], fm = jstep(
                reordered[j], {k: order(v) for k, v in batch.items()},
                jax.random.key(i))
            for k in floors:
                floors[k] = max(floors[k], abs(float(fm[k]) - float(jm[k])))
        m = centernet_train_step(state, _torch(batch), None)
        centernet_train_step(twin, _torch(batch), None)
        assert set(m) == set(floors)
        for k in floors:
            assert abs(float(m[k]) - float(jm[k])) <= (
                1e-4 * abs(float(jm[k])) + 4 * floors[k]), (i, k, floors)
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
        assert len(beyond) > len(want) // 4, (len(beyond), len(want))


def test_centernet_bf16_step_twin_of_jax(one_stack):
    """One bf16 step on both sides (one stack), as the ResNet bf16 twin
    is held: the loss within 2%, the stem BN's statistics within 1e-3
    (rtol 1e-2). Deeper statistics drift by bf16 rounding compounded
    through the recursion (XLA:CPU also keeps the mixed BN's bf16
    product in float32 where ATen rounds it)."""
    model, variables = one_stack
    bf16 = FlaxCenterNet(num_classes=CLASSES, num_stacks=1,
                         dtype=jnp.bfloat16)
    batch = _step_batch(9)
    jstate, jm = jax.jit(jax_train_step)(_jax_state(variables, bf16), batch,
                                         jax.random.key(0))
    state = _port_state(variables, dtype=torch.bfloat16)
    m = centernet_train_step(state, _torch(batch), None)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=0.02)
    stem = jstate.batch_stats["stem_bn"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(state.module.stem_bn, k).numpy(),
                                   np.asarray(stem[k]), atol=1e-3, rtol=1e-2)


def test_centernet_eval_step_sums_match_jax_with_a_padded_tail(one_stack):
    model, variables = one_stack
    batch = _step_batch(7)
    batch["mask"] = np.array([1, 1, 1, 0], np.float32)
    want = jax.jit(jax_eval_step)(_jax_state(variables, model), batch)
    got = centernet_eval_step(_port_state(variables), _torch(batch))
    assert float(got["count"]) == float(want["count"]) == 3.0
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-4)


# ------------------------------------------------------------ serving


def test_served_detect_head_matches_jax(one_stack):
    """``load_served`` on carried weights answers the JAX
    ``_centernet_forward``'s corner boxes, scores and classes (the last
    stack's 100 best peaks) and their ``valid`` at the threshold."""
    model, variables = one_stack
    x = _images(2, seed=11) * 0.05
    want = jax.jit(jax_centernet_forward(model.apply, 0.3))(
        variables, jnp.asarray(x))
    served = CenterNet(num_classes=CLASSES, num_stacks=1)
    served.load_state_dict(flax_to_torch("centernet", variables,
                                         num_classes=CLASSES, num_stacks=1))
    from deepvision_tpu_torch.serve.models import _centernet_forward

    with torch.inference_mode():
        got = _centernet_forward(served.eval(), 0.3)(torch.from_numpy(x))
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


# --------------------------------------------------------------- CLIs


def test_cli_trains_centernet_resumes_serves_and_evaluates(tmp_path, capsys):
    """Synthetic at 128 px, batch 4: one epoch, then the second on
    ``--resume``; the serving CLI answers like ``load_served`` from the
    newest checkpoint; ``eval detection -m centernet`` prints mAP with
    null NMS fields."""
    common = ["-m", "centernet", "--device", "cpu", "--input-size", "128",
              "--num-classes", str(CLASSES), "--batch-size", "4",
              "--synthetic-size", "12", "--steps-per-epoch", "1",
              "--workdir", str(tmp_path)]
    assert train_main([*common, "--epochs", "1"]) == 0
    out = capsys.readouterr()
    assert "[epoch 0]" in out.out and "train_heatmap_loss" in out.out
    assert train_main([*common, "--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr()
    assert "resumed at epoch 1" in out.out and "[epoch 1]" in out.out
    assert "checkpoints [0, 1]" in out.err
    workdir = str(tmp_path / "centernet")

    x = (np.random.default_rng(0).uniform(-1, 1, (2, 128, 128, 3))
         .astype(np.float32))
    lines = "".join(json.dumps({"id": i, "input": x[i].tolist()}) + "\n"
                    for i in range(2))
    stdout = io.StringIO()
    serve_main(["-m", f"centernet={workdir}", "--device", "cpu",
                "--buckets", "2", "--score", "0.0"],
               stdin=io.StringIO(lines), stdout=stdout)
    replies = [json.loads(s) for s in stdout.getvalue().splitlines()]
    served = load_served("centernet", workdir, device="cpu",
                         score_thresh=0.0)
    assert served.task == "detect" and served.input_shape == (128, 128, 3)
    host = served.run(x)
    for r in replies:
        want = served.postprocess(host, r["id"])
        assert set(r["result"]) == {"boxes", "scores", "classes"}
        assert r["result"]["classes"] == want["classes"]
        np.testing.assert_allclose(np.array(r["result"]["scores"]),
                                   want["scores"], atol=1e-6)
    capsys.readouterr()
    assert eval_main(["detection", "-m", "centernet", "--workdir", workdir,
                      "--num-classes", str(CLASSES), "--size", "128",
                      "--batch-size", "16", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "mAP" and line["images"] == 64
    assert 0.0 <= line["value"] <= 1.0
    assert line["nms_candidates_max"] is None and line["nms_exact"] is None
    # two 1.3 GB checkpoints (110 M parameters and both Adam moments)
    shutil.rmtree(workdir)
