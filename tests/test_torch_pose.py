"""The port's pose path (the stacked hourglass) against the JAX package's,
on the CPU.

The heatmap rasterizer and its decode, the loss, the keypoint twins of
the device augmentation, PCK and the argmax decode take the same seeded
numpy inputs on both sides: positions, indices and visibility exactly
(keypoints on half cells round half to even on both sides), float32
values to 1e-6 (``exp`` is XLA:CPU's on one side and ATen's on the
other). The reader is held against the JAX ``tf.data`` reader on records
the test writes: the crop window and the renormalized keypoints exactly,
the pixels within the JPEG decoders' bound (tf's fast IDCT against PIL's
accurate one, trap C14) and the resize to tf's to 1e-4 (trap C9).

``StackedHourglass`` runs narrow (``features=32``, 2 stacks) and
``hourglass104`` at full width, both at 64 px on weights carried from
flax: float32 outputs to 1e-4 of their scale, train-mode outputs and BN
statistics; ``hourglass104`` in bf16 to four bf16 steps of each output's
scale, with every BatchNorm's output in bf16 as flax's (trap C21: the
block's ``bn1`` reads the float32 carrier). The 7x7/2 stem pads (2, 3)
(trap C2). Three float32 Adam steps and one ``bf16_scaled`` step are held
to the JAX steps; the ``"stack"`` remat step equals the plain one bit
for bit, and without the recompute guard the statistics move (trap
C11). (JAX's loss-scaled step takes minutes to compile on XLA:CPU, so
the port's ``bf16_scaled`` step is held to JAX's bf16 step.) The served
pose head equals the JAX ``_pose_forward``; the CLI
trains from records with ``--device-aug``, resumes, serves and
evaluates PCK.
"""

import contextlib
import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorflow as tf
import torch

from deepvision_tpu.core.precision import get_policy as jax_get_policy
from deepvision_tpu.data import device_aug as jax_aug
from deepvision_tpu.data import pose as jax_pose
from deepvision_tpu.eval import pose as jax_eval_pose
from deepvision_tpu.losses import pose as jax_loss
from deepvision_tpu.models.hourglass import StackedHourglass as FlaxHourglass
from deepvision_tpu.ops import heatmap as jax_heatmap
from deepvision_tpu.serve.models import _pose_forward as jax_pose_forward
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.state import TrainState as JaxTrainState
from deepvision_tpu.train.steps import pose_eval_step as jax_eval_step
from deepvision_tpu.train.steps import pose_train_step as jax_train_step
from deepvision_tpu_torch.convert.from_flax import (
    flax_param_tree_to_torch,
    flax_to_torch,
)
from deepvision_tpu_torch.core.precision import get_policy
from deepvision_tpu_torch.data import device_aug, pose
from deepvision_tpu_torch.data.synthetic_records import write_synthetic_pose
from deepvision_tpu_torch.data.tfrecord import read_records
from deepvision_tpu_torch.eval import pose as port_eval_pose
from deepvision_tpu_torch.eval.__main__ import main as eval_main
from deepvision_tpu_torch.losses import pose as port_loss
from deepvision_tpu_torch.models import create_model, get_model, layers
from deepvision_tpu_torch.models.hourglass import StackedHourglass
from deepvision_tpu_torch.ops import heatmap
from deepvision_tpu_torch.serve.__main__ import main as serve_main
from deepvision_tpu_torch.serve.models import _pose_forward, load_served
from deepvision_tpu_torch.train.__main__ import main as train_main
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer, set_lr_scale
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import pose_eval_step, pose_train_step
from tests.test_torch_inception import _draw
from tests.test_torch_train import _find, _leaf_gap
from tests.test_torch_yolo import _hold, _torch
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
SIZE = 64  # 16² heatmaps: the order-4 recursion reaches 1²
JOINTS = 16
STEPS_U8 = 255 / 2  # uint8 steps per unit of [-1, 1]
BF16_STEP = 2 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


def _keypoints(rng, b=3, k=JOINTS):
    kx = rng.uniform(-0.1, 1.1, (b, k)).astype(np.float32)
    ky = rng.uniform(-0.1, 1.1, (b, k)).astype(np.float32)
    v = (rng.uniform(size=(b, k)) > 0.25).astype(np.int32)
    kx[0, :4] = np.float32([2.5, 3.5, 10.5, 0.5]) / 16  # half cells
    ky[0, :4] = np.float32([4.5, 7.5, 0.5, 15.5]) / 16
    v[0, :4] = 1
    return kx, ky, v


# ------------------------------------------------------ heatmap ops


def test_gaussian_heatmaps_match_jax_with_half_cells():
    """Round half to even on both sides: the peaks on the same cells,
    the values to 1e-6."""
    kx, ky, v = _keypoints(np.random.default_rng(0))
    want = np.asarray(jax.jit(lambda a, b, c: jax_heatmap.gaussian_heatmaps(
        a, b, c, height=16, width=16))(kx, ky, v))
    got = heatmap.gaussian_heatmaps(_t(kx), _t(ky), _t(v), height=16,
                                    width=16).numpy()
    assert got.shape == (3, 16, 16, JOINTS)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_array_equal(got == 1.0, want == 1.0)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # 2.5 -> 2 and 3.5 -> 4: half to even
    assert got[0, 4, 2, 0] == 1.0 and got[0, 8, 4, 1] == 1.0
    assert not got.transpose(0, 3, 1, 2)[v == 0].any()


def test_decode_heatmaps_matches_jax_with_ties():
    rng = np.random.default_rng(1)
    heat = rng.normal(0, 1, (2, 16, 16, JOINTS)).astype(np.float32)
    heat[0, 3:6, 2:9, 0] = 9.0  # a plateau: the first cell wins
    heat[1, :, :, 5] = 0.25
    want = jax.jit(jax_heatmap.decode_heatmaps)(heat)
    got = heatmap.decode_heatmaps(_t(heat))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0][0, 0]) == 2 / 16 and float(got[1][0, 0]) == 3 / 16


def test_weighted_heatmap_mse_matches_jax():
    rng = np.random.default_rng(2)
    kx, ky, v = _keypoints(rng)
    targets = np.asarray(jax_heatmap.gaussian_heatmaps(kx, ky, v, height=16,
                                                       width=16))
    outputs = [rng.normal(0, 0.3, targets.shape).astype(np.float32)
               for _ in range(4)]
    for per_sample in (False, True):
        want = jax_loss.weighted_heatmap_mse(targets, outputs,
                                             per_sample=per_sample)
        got = port_loss.weighted_heatmap_mse(
            _t(targets), [_t(o) for o in outputs], per_sample=per_sample)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    one = port_loss.weighted_heatmap_mse(_t(targets), _t(outputs[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(
        jax_loss.weighted_heatmap_mse(targets, outputs[0])), rtol=1e-6)


def test_keypoint_twins_of_the_device_augmentation_match_jax():
    kx, ky, v = _keypoints(np.random.default_rng(3), b=4)
    flips = np.array([True, False, True, True])
    for perm in (None, jax_aug.MPII_FLIP_PERM):
        want = jax_aug.flip_keypoints(kx, ky, v, flips, perm)
        got = device_aug.flip_keypoints(_t(kx), _t(ky), _t(v), _t(flips),
                                        perm)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert device_aug.MPII_FLIP_PERM == jax_aug.MPII_FLIP_PERM
    tops, lefts = np.array([0, 5, 17, 32]), np.array([3, 0, 32, 11])
    want = jax_aug.crop_keypoints(kx, ky, v, tops, lefts, 96, 96, 64)
    got = device_aug.crop_keypoints(_t(kx), _t(ky), _t(v), _t(tops),
                                    _t(lefts), 96, 96, 64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].sum() < v.sum()  # some joints left the window


def test_pose_family_flips_images_and_keypoints_together():
    images = torch.zeros(8, 16, 16, 3, dtype=torch.uint8)
    images[:, :, :4] = 255  # a bright left edge
    kx = torch.full((8, JOINTS), 0.125)
    kx[:, 5] = 0.5
    ky = torch.arange(JOINTS).float().expand(8, JOINTS) / JOINTS
    v = torch.ones(8, JOINTS, dtype=torch.int32)
    aug = device_aug.DeviceAugment("pose", flip=True,
                                   flip_pairs=device_aug.MPII_FLIP_PERM)
    out = aug({"image": images, "kx": kx, "ky": ky, "v": v}, seed=3)
    flipped = out["image"][:, 0, -1, 0] == 255
    assert 0 < int(flipped.sum()) < 8
    # joint 0 (the right ankle) takes the left ankle's (5) place
    torch.testing.assert_close(out["kx"][:, 0],
                               torch.where(flipped, 0.5, 0.125))
    torch.testing.assert_close(out["ky"][:, 0],
                               torch.where(flipped, 5 / JOINTS, 0.0))
    with pytest.raises(ValueError, match="classification-only"):
        device_aug.DeviceAugment("pose", mixup=0.2)


def test_pck_and_argmax_keypoints_match_jax():
    rng = np.random.default_rng(4)
    heat = rng.normal(0, 1, (5, 16, 16, JOINTS)).astype(np.float32)
    np.testing.assert_array_equal(
        port_eval_pose.heatmap_argmax_keypoints(heat),
        jax_eval_pose.heatmap_argmax_keypoints(heat))
    pred = rng.uniform(0, 1, (5, JOINTS, 2))
    true = pred + rng.normal(0, 0.05, pred.shape)
    vis = (rng.uniform(size=(5, JOINTS)) > 0.3).astype(np.int32)
    vis[:, 3] = 0  # a joint never visible: NaN on both sides
    norm = rng.uniform(0.05, 0.2, 5)
    want = jax_eval_pose.pck(pred, true, vis, norm, threshold=0.5)
    got = port_eval_pose.pck(pred, true, vis, norm, threshold=0.5)
    assert got["pck"] == want["pck"]
    np.testing.assert_array_equal(got["per_joint"], want["per_joint"])
    np.testing.assert_array_equal(got["count"], want["count"])


# ------------------------------------------------------------ reader


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("pose")
    write_synthetic_pose(d, train=8, val=5, shards=2, device="cpu")
    return d


def _records(d, prefix):
    return [r for p in sorted(d.glob(f"{prefix}-*"))
            for r in read_records(p)]


@pytest.mark.parametrize("margin", [0.1, 0.2, 0.2871])
def test_person_crop_matches_the_jax_crop(records, margin):
    """The window and the renormalized keypoints exactly (the same
    float32 arithmetic and truncating casts); one record with no visible
    joint keeps the whole frame."""
    recs = _records(records, "train") + _records(records, "val")
    for i, rec in enumerate(recs):
        image, kx, ky, v, scale = jax_pose.parse_pose_example(
            tf.constant(rec))
        blob, pkx, pky, pv, pscale = pose.parse_pose_record(rec)
        np.testing.assert_array_equal(pkx, kx.numpy())
        np.testing.assert_array_equal(pv, v.numpy())
        assert pscale == scale.numpy()
        if i == 0:  # nothing visible
            v = tf.zeros_like(v)
            pv = np.zeros_like(pv)
        crop, nkx, nky = jax_pose.crop_person_roi(
            image, kx, ky, v, scale, tf.constant(np.float32(margin)))
        h, w = pose.jpeg_size(blob)
        window, gx, gy = pose.crop_person_roi(h, w, pkx, pky, pv, pscale,
                                              margin)
        top, left, th, tw = window
        np.testing.assert_array_equal(
            image.numpy()[top:top + th, left:left + tw], crop.numpy())
        np.testing.assert_array_equal(gx, nkx.numpy())
        np.testing.assert_array_equal(gy, nky.numpy())
        if i == 0:
            assert window == (0, 0, h, w)


def test_eval_batches_match_the_jax_reader(records):
    """Both readers over the validation shards at 64 px: keypoints and
    visibility exactly, pixels within the decoders' bound (at most 4
    uint8 steps, 1.5 on average; the resize itself agrees to 1e-4), the
    short tail padded and masked. tf.data interleaves the shards, so
    rows are matched by their keypoints."""
    ds = jax_pose.make_pose_dataset(str(records / "val-*"), 8, SIZE,
                                    is_training=False)
    want_img, want_kx, want_ky, want_v = next(ds.as_numpy_iterator())
    batches = list(pose.eval_batches(sorted(records.glob("val-*")), 4,
                                     SIZE))
    got = [b.decode("cpu") for b in batches]
    cat = {k: torch.cat([g[k] for g in got]).numpy() for k in got[0]}
    assert cat["mask"].tolist() == [1] * 5 + [0] * 3
    mine = {tuple(k): i for i, k in enumerate(cat["kx"][:5])}
    order = [mine[tuple(k)] for k in want_kx]
    cat = {k: v[order] for k, v in cat.items()}
    np.testing.assert_array_equal(cat["kx"], want_kx)
    np.testing.assert_array_equal(cat["ky"], want_ky)
    np.testing.assert_array_equal(cat["v"], want_v)
    gap = np.abs(cat["image"] - want_img) * STEPS_U8
    assert gap.max() <= 4.0 and gap.mean() <= 1.5, (gap.max(), gap.mean())
    # the resize alone, from tf's own pixels
    rec = _records(records, "val")[1]
    image, kx, ky, v, scale = jax_pose.parse_pose_example(tf.constant(rec))
    crop, nkx, nky = jax_pose.crop_person_roi(image, kx, ky, v, scale,
                                              tf.constant(0.2))
    want = jax_pose.to_model_inputs(crop, nkx, nky, v, SIZE)
    mine = pose.to_model_inputs(torch.from_numpy(crop.numpy()), nkx.numpy(),
                                nky.numpy(), v.numpy(), SIZE)
    np.testing.assert_allclose(mine[0].numpy(), want[0].numpy(), atol=1e-4,
                               rtol=0)
    for m, w in zip(mine[1:], want[1:]):
        np.testing.assert_array_equal(m, w.numpy())


def test_train_batches_are_seeded_by_the_epoch(records):
    files = sorted(records.glob("train-*"))

    def run(epoch, aug=False):
        return list(pose.train_batches(files, 4, SIZE, seed=epoch, steps=2,
                                       device_aug=aug))

    a, b, c = run(0), run(0), run(1)
    assert len(a) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["kx"], y["kx"])
        assert x.plan.windows == y.plan.windows
    assert any(x.plan.windows != y.plan.windows for x, y in zip(a, c))
    for batch in a:
        vis = batch["v"] > 0
        assert (batch["kx"][vis] >= 0).all() and (batch["kx"][vis] <= 1).all()
        out = batch.decode("cpu")
        assert out["image"].shape == (4, SIZE, SIZE, 3)
    assert run(0, aug=True)[0].decode("cpu")["image"].dtype == torch.uint8


def test_synthetic_pose_matches_jax():
    want = jax_pose.synthetic_pose(12, size=32, num_joints=5)
    got = pose.synthetic_pose(12, size=32, num_joints=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    mine = list(pose.synthetic_pose_batches(*got, 5, drop_remainder=False))
    theirs = list(jax_pose.synthetic_pose_batches(*want, 5,
                                                  drop_remainder=False))
    for m, t in zip(mine, theirs):
        for k in t:
            np.testing.assert_array_equal(m[k], t[k])


# ------------------------------------------------------------- model


def flax_variables(model, size=SIZE, seed=0, gain=1.0):
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=True), jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng, gain), shapes)


NARROW = {"num_stacks": 2, "num_residual": 1, "num_heatmaps": JOINTS,
          "features": 32}
HG104 = {"num_stacks": 4, "num_residual": 1, "num_heatmaps": JOINTS,
         "features": 256}


def _load(module, variables):
    """Carried weights by the converter's name mapping, for any module of
    the hourglass family."""
    from deepvision_tpu_torch.convert.from_flax import _flatten, _LEAF

    leaves = _flatten(variables)
    buffers = {n for n, _ in module.named_buffers()}
    state = {}
    for name, ref in module.state_dict().items():
        *mods, leaf = name.split(".")
        col = "batch_stats" if name in buffers else "params"
        a = np.asarray(leaves.pop((col, *mods, _LEAF.get(leaf, leaf))))
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        state[name] = torch.tensor(a)
    assert not leaves, sorted(leaves)[:5]
    module.load_state_dict(state)
    return module.to(memory_format=torch.channels_last)


def _images(n, size=SIZE, seed=1):
    return (np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3))
            .astype(np.float32))


def _hold_outputs(got, want, rel=1e-4, floors=None):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float32)
        atol = rel * np.abs(w).max() + (0 if floors is None else
                                        3 * floors[i])
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=rel,
                                   atol=atol)


def _bn_stats(module):
    return {k: v for k, v in module.state_dict().items()
            if k.endswith((".mean", ".var"))}


def _flax_stats(module, variables, mutated):
    return _bn_stats(_load(module, {"params": variables["params"],
                                    "batch_stats": mutated["batch_stats"]}))


@pytest.mark.parametrize("name", ["narrow", "hourglass104"])
def test_hourglass_outputs_and_bn_statistics_match_flax(name):
    """Eval outputs to 1e-4 of their scale; train-mode outputs and the
    BN statistics (momentum 0.9) to 1e-4 plus three times float32's
    floor (JAX on the batch reversed)."""
    if name == "narrow":
        model, build = FlaxHourglass(**NARROW), lambda: StackedHourglass(
            **NARROW)
    else:
        model = FlaxHourglass(num_stacks=4, num_heatmaps=JOINTS)
        build = lambda: get_model("hourglass104", num_heatmaps=JOINTS)  # noqa
    variables = flax_variables(model, seed=2)
    module = _load(build(), variables)
    x = _images(2)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert len(got) == len(want)
    assert got[-1].shape == (2, SIZE // 4, SIZE // 4, JOINTS)
    _hold_outputs(got, want)
    run = jax.jit(lambda v, x: model.apply(v, x, train=True,
                                           mutable=["batch_stats"]))
    x = _images(4, seed=3)
    want, mutated = run(variables, jnp.asarray(x))
    rev, rev_mutated = run(variables, jnp.asarray(x[::-1].copy()))
    floors = [float(np.abs(np.asarray(w) - np.asarray(r)[::-1]).max())
              for w, r in zip(want, rev)]
    with torch.no_grad():
        got = module(torch.from_numpy(x), train=True)
    _hold_outputs(got, want, floors=floors)
    stats = _flax_stats(build(), variables, mutated)
    rev_stats = _flax_stats(build(), variables, rev_mutated)
    mine = _bn_stats(module)
    for k, v in stats.items():
        torch.testing.assert_close(mine[k], v, rtol=1e-5, atol=(
            1e-6 + 3 * _leaf_gap(v, rev_stats[k])))


def test_hourglass104_bf16_matches_flax_with_bn_in_bf16():
    """Trap C21: in bf16 every BatchNorm returns bf16, as flax's
    ``MixedBatchNorm`` under its own bf16 dtype (the block's ``bn1``
    reads the float32 carrier and must cast it, not take the float32
    path); the heads (float32) within four bf16 steps of their scale
    plus 1e-4, but for at most 0.1% of their elements, each within 16
    (bf16 rounding compounds over four stacks of the recursion)."""
    model = FlaxHourglass(num_stacks=4, num_heatmaps=JOINTS,
                          dtype=jnp.bfloat16)
    variables = flax_variables(model, seed=4)
    module = _load(get_model("hourglass104", num_heatmaps=JOINTS,
                             dtype=torch.bfloat16), variables)
    dtypes = {}
    for name, m in module.named_modules():
        if isinstance(m, layers.MixedBatchNorm):
            m.register_forward_hook(
                lambda m, i, o, name=name: dtypes.__setitem__(name, o.dtype))
    x = _images(2, seed=5)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    assert len(dtypes) == sum(isinstance(m, layers.MixedBatchNorm)
                              for m in module.modules()) == 230
    bad = sorted(n for n, d in dtypes.items() if d != torch.bfloat16)
    assert not bad, bad[:5]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        gap = np.abs(g.numpy() - w) - 4 * BF16_STEP * np.abs(w)
        assert (gap > 4 * BF16_STEP * scale + 1e-4).mean() <= 1e-3
        assert gap.max() <= 16 * BF16_STEP * scale


def test_stem_pads_and_geometry():
    """16.3 M parameters, as flax counts them; the 7x7/2 stem pads (2, 3)
    at 256 and at 64 (trap C2), 256 px gives 64² heatmaps; ``he_normal``
    kernels, flax's default ``lecun_normal`` for ``remap_*``, zero
    biases, BN momentum 0.9; ``"stack"`` is the registry's remat."""
    model = FlaxHourglass(num_stacks=4, num_heatmaps=JOINTS)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=False), jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    want = sum(int(np.prod(v.shape)) for v in
               jax.tree_util.tree_leaves(shapes["params"]))
    module = create_model("hourglass104", device=CPU, seed=0,
                          num_heatmaps=JOINTS)
    assert sum(p.numel() for p in module.parameters()) == want
    assert 16e6 < want < 16.6e6
    for size in (256, SIZE):
        assert layers.conv_padding(torch.zeros(1, size, size, 3),
                                   module.stem_conv, "SAME") == [(2, 3),
                                                                 (2, 3)]
    with torch.device("meta"):
        out = module.to("meta")(torch.zeros(1, 256, 256, 3, device="meta"))
    assert [tuple(o.shape) for o in out] == [(1, 64, 64, JOINTS)] * 4
    module = create_model("hourglass104", device=CPU, seed=0,
                          num_heatmaps=JOINTS)
    module.requires_grad_(False)
    k = module.hg0.inner3.low1_0.conv2.weight  # (128, 128, 3, 3)
    assert float(k.std()) == pytest.approx(np.sqrt(2 / (128 * 9)), rel=0.05)
    r = module.remap_feat0.weight  # (256, 256, 1, 1)
    assert float(r.std()) == pytest.approx(np.sqrt(1 / 256), rel=0.05)
    assert not module.head3.bias.any() and module.stem_bn.momentum == 0.9
    assert get_config("hourglass104")["model_kwargs"] == {"remat": "stack"}
    with pytest.raises(ValueError, match="remat"):
        StackedHourglass(remat="block")


# ------------------------------------------------------------- steps


# Adam's 1e-4 at the plateau's scale 1; 128 px, where the recursion's
# bottom BatchNorms see 2² · 4 values a channel (at 64 px, 4: float32
# rounding there moves most gradients as far as the steps do)
STEP_SIZE, STEP_BATCH, STEPS = 128, 4, 3
ORDERS = (lambda a: a[::-1].copy(), lambda a: np.roll(a, 1, axis=0),
          lambda a: np.roll(a, 2, axis=0), lambda a: np.roll(a, 3, axis=0))


def _step_batch(seed, n=STEP_BATCH):
    rng = np.random.default_rng(seed)
    kx, ky, v = _keypoints(rng, b=n)
    return {"image": _images(n, STEP_SIZE, seed=seed + 50), "kx": kx,
            "ky": ky, "v": v}


@pytest.fixture(scope="module")
def hg_variables():
    model = FlaxHourglass(num_stacks=4, num_heatmaps=JOINTS)
    return flax_variables(model, seed=6)


def _jax_state(variables, dtype=jnp.float32, policy=None, arch=HG104):
    model = FlaxHourglass(**arch, dtype=dtype)
    tx, _ = jax_optimizers.make_optimizer(jax_get_config("hourglass104"), 1)
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx,
        loss_scale=(None if policy is None
                    else jax_get_policy(policy).make_loss_scale()))


def _port_state(variables, dtype=torch.float32, b1=None, policy=None,
                remat=None, arch=HG104):
    module = _load(StackedHourglass(**arch, dtype=dtype, remat=remat),
                   variables)
    cfg = get_config("hourglass104")
    if b1 is not None:
        cfg["optimizer_params"]["beta1"] = b1
    opt, plateau = make_optimizer(cfg, module.parameters())
    assert isinstance(opt, torch.optim.Adam) and plateau is not None
    set_lr_scale(opt, 1.0)
    return TrainState(module, opt, loss_scale=(
        None if policy is None
        else get_policy(policy).make_loss_scale(device="cpu")))


def _leaves(jstate):
    host = jax.tree.map(np.asarray, jstate)
    adam = _find(host.opt_state, optax.ScaleByAdamState)
    out = flax_to_torch("hourglass104", {"params": host.params,
                                         "batch_stats": host.batch_stats},
                        num_heatmaps=JOINTS)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        out.update({f"{n}:{key}": t for n, t in flax_param_tree_to_torch(
            "hourglass104", tree, num_heatmaps=JOINTS).items()})
    return out


def _port_leaves(state):
    out = {k: v.detach().clone() for k, v in
           state.module.state_dict().items()}
    for name, p in state.module.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            out[f"{name}:{key}"] = state.optimizer.state[p][key].clone()
    return out


def test_hourglass104_f32_adam_steps_match_jax(hg_variables):
    """Three f32 steps of the config's Adam (1e-4) on carried weights at
    128 px, batch 4: each step's loss within 1e-4 plus four times its
    floor (JAX on the batch reversed and rolled by 1, 2 and 3), every
    parameter, BN statistic and Adam moment within 1e-5 plus three times
    its own (a few elements may differ by an update turned around). The
    state before the steps fails that on over 90% of the BN statistics,
    the steps without Adam's first moment on over half of the first
    moments. (The weights' floors are as wide as three steps move them:
    under Adam an element whose gradient rounding turns across 0 moves
    by 2·lr, and reordering the batch turns some in every leaf.)"""
    variables = hg_variables
    jstep = jax.jit(jax_train_step)
    jstate = _jax_state(variables)
    reordered = [jstate] * len(ORDERS)
    state, twin = _port_state(variables), _port_state(variables, b1=0.0)
    for i in range(STEPS):
        batch = _step_batch(i)
        jstate, jm = jstep(jstate, batch, jax.random.key(i))
        floor = 0.0
        for j, order in enumerate(ORDERS):
            reordered[j], fm = jstep(
                reordered[j], {k: order(v) for k, v in batch.items()},
                jax.random.key(i))
            floor = max(floor, abs(float(fm["loss"]) - float(jm["loss"])))
        m = pose_train_step(state, _torch(batch), None)
        pose_train_step(twin, _torch(batch), None)
        assert set(m) == {"loss"}
        assert abs(float(m["loss"]) - float(jm["loss"])) <= (
            1e-4 * abs(float(jm["loss"])) + 4 * floor), (i, floor)
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

    def beyond(wrong, suffixes):
        keys = [k for k in want if k.endswith(suffixes)]
        return sum(_leaf_gap(wrong[k], want[k]) > tol[k]
                   for k in keys) / len(keys)

    assert beyond(start, (".mean", ".var")) > 0.9
    assert beyond(_port_leaves(twin), ":exp_avg") > 0.5


@pytest.fixture(scope="module")
def narrow_variables():
    return flax_variables(FlaxHourglass(**NARROW), seed=8)


def test_bf16_scaled_step_twin_of_jax(narrow_variables):
    """One step of the port's ``bf16_scaled`` (the narrow hourglass)
    against JAX's bf16 step: the loss within 2%, the stem BN's
    statistics within 1e-3 (rtol 1e-2); the step is finite and the scale
    stays at 2^15 with one good step. At a power-of-two scale the scaled
    update is the unscaled one but for gradients the scale keeps from
    flushing to zero; JAX's own loss-scaled step takes minutes to
    compile on XLA:CPU, its bf16 step seconds (the scale's growth and
    back-off are held to JAX's in ``tests/test_torch_train.py``)."""
    variables = narrow_variables
    batch = _step_batch(20)
    jstate, jm = jax.jit(jax_train_step)(
        _jax_state(variables, jnp.bfloat16, arch=NARROW), batch,
        jax.random.key(0))
    state = _port_state(variables, torch.bfloat16, policy="bf16_scaled",
                        arch=NARROW)
    m = pose_train_step(state, _torch(batch), None)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=0.02)
    assert float(m["mp_grads_finite"]) == 1.0
    assert float(m["mp_loss_scale"]) == 2.0 ** 15
    assert int(state.loss_scale.good_steps) == 1
    stem = jstate.batch_stats["stem_bn"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(state.module.stem_bn, k).numpy(),
                                   np.asarray(stem[k]), atol=1e-3, rtol=1e-2)


def _remat_step(variables, remat):
    state = _port_state(variables, remat=remat)
    pose_train_step(state, _torch(_step_batch(30, n=2)), None)
    return ({k: v.clone() for k, v in state.module.state_dict().items()},
            {n: p.grad.clone() for n, p in
             state.module.named_parameters()})


@pytest.fixture(scope="module")
def plain_step(hg_variables):
    return _remat_step(hg_variables, None)


def test_stack_remat_step_equals_the_plain_step(hg_variables, plain_step):
    """Trap C11 at ``"stack"``: parameters, gradients and BN running
    statistics bit for bit."""
    state, grads = _remat_step(hg_variables, "stack")
    want_state, want_grads = plain_step
    for k, v in want_state.items():
        assert torch.equal(state[k], v), k
    for k, v in want_grads.items():
        assert torch.equal(grads[k], v), k


def test_a_second_running_update_in_the_stack_recompute_fails(
        hg_variables, plain_step, monkeypatch):
    """Without the recompute guard every BN inside the four hourglass
    modules takes the momentum twice; the stem's and the heads' stay."""
    monkeypatch.setattr(layers, "recomputing", contextlib.nullcontext)
    state, _ = _remat_step(hg_variables, "stack")
    want, _ = plain_step
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    moved = [k for k in stats if not torch.equal(state[k], want[k])]
    assert set(moved) == {k for k in stats if k.startswith("hg")}, (
        len(moved))
    assert len(moved) == 4 * 17 * 3 * 2  # 17 blocks a module


def test_pose_eval_step_sums_match_jax_with_a_padded_tail(hg_variables):
    batch = _step_batch(7)
    batch["mask"] = np.array([1, 1, 1, 0], np.float32)
    want = jax.jit(jax_eval_step)(_jax_state(hg_variables), batch)
    got = pose_eval_step(_port_state(hg_variables), _torch(batch))
    assert float(got["count"]) == float(want["count"]) == 3.0
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-4)


def test_served_pose_head_matches_jax(hg_variables):
    model = FlaxHourglass(num_stacks=4, num_heatmaps=JOINTS)
    x = _images(3, seed=12)
    want = jax.jit(jax_pose_forward(model.apply))(hg_variables,
                                                  jnp.asarray(x))
    module = _load(get_model("hourglass104", num_heatmaps=JOINTS),
                   hg_variables).eval()
    with torch.inference_mode():
        got = _pose_forward(module)(torch.from_numpy(x))
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["conf"].numpy(), np.asarray(want["conf"]),
                               rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------- CLIs


def test_cli_trains_from_records_resumes_serves_and_evaluates(
        records, tmp_path, capsys):
    """``--data-dir`` over the records with ``--device-aug`` (the flip
    and the MPII joint swap in the step), the config's ``bf16_scaled``
    and ``"stack"`` remat: one epoch, then the second on ``--resume``;
    the serving CLI answers each joint as ``load_served`` does; ``eval
    pose`` over the ``val-*`` shards prints PCK."""
    common = ["-m", "hourglass104", "--device", "cpu", "--input-size",
              str(SIZE), "--batch-size", "4", "--data-dir", str(records),
              "--device-aug", "--steps-per-epoch", "2", "--workdir",
              str(tmp_path)]
    assert train_main([*common, "--epochs", "1"]) == 0
    out = capsys.readouterr()
    assert "DeviceAugment(pose, flip)" in out.out
    assert "wire jpeg" in out.out and "16 joints" in out.out
    assert "precision bf16_scaled" in out.out and "'stack'" in out.out
    assert train_main([*common, "--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr()
    assert "resumed at epoch 1" in out.out and "[epoch 1]" in out.out
    assert "checkpoints [0, 1]" in out.err
    workdir = str(tmp_path / "hourglass104")

    x = _images(3, seed=9)
    lines = "".join(json.dumps({"id": i, "input": x[i].tolist()}) + "\n"
                    for i in range(3))
    stdout = io.StringIO()
    serve_main(["-m", f"hourglass104={workdir}", "--device", "cpu",
                "--buckets", "1,4"], stdin=io.StringIO(lines), stdout=stdout)
    replies = [json.loads(s) for s in stdout.getvalue().splitlines()]
    served = load_served("hourglass104", workdir, device="cpu")
    assert served.task == "pose" and served.input_shape == (SIZE, SIZE, 3)
    host = served.run(x)
    for r in replies:
        want = served.postprocess(host, r["id"])["joints"]
        got = r["result"]["joints"]
        assert len(got) == JOINTS
        # the engine's batches of 1 and 4 against one batch of 3: ATen's
        # CPU convolutions block them differently
        np.testing.assert_array_equal(np.array(got)[:, :2],
                                      np.array(want)[:, :2])
        conf = np.array(want)[:, 2]
        np.testing.assert_allclose(np.array(got)[:, 2], conf, rtol=1e-4,
                                   atol=1e-6 * np.abs(conf).max())
    capsys.readouterr()
    assert eval_main(["pose", "--workdir", workdir, "--data-dir",
                      str(records), "--size", str(SIZE), "--batch-size",
                      "4", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "PCK@0.5" and 0.0 <= line["value"] <= 1.0
    assert len(line["per_joint"]) == JOINTS
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_trains_on_the_synthetic_set_with_few_joints(tmp_path, capsys):
    """Without a data directory: the synthetic set at 3 joints, whose
    checkpoint serves 3 joints; ``eval pose`` on the synthetic set."""
    assert train_main(["-m", "hourglass104", "--device", "cpu",
                       "--input-size", str(SIZE), "--num-joints", "3",
                       "--batch-size", "4", "--synthetic-size", "12",
                       "--epochs", "1", "--precision", "f32",
                       "--workdir", str(tmp_path)]) == 0
    out = capsys.readouterr()
    assert "3 joints" in out.out and "2 steps an epoch" in out.out
    served = load_served("hourglass104", str(tmp_path / "hourglass104"),
                         device="cpu")
    assert len(served.postprocess(served.run(_images(1)), 0)["joints"]) == 3
    assert eval_main(["pose", "--workdir", str(tmp_path / "hourglass104"),
                      "--num-joints", "3", "--size", str(SIZE),
                      "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(line["per_joint"]) == 3
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``eval pose``, ``write_synthetic_pose`` and the pose and CenterNet
    ``load_served`` raise without a card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        eval_main(["pose"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        write_synthetic_pose(tmp_path, train=1, val=1)
    for name in ("hourglass104", "centernet"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            load_served(name)
