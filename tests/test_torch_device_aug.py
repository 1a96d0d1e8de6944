"""The port's device augmentation against ``deepvision_tpu/data/device_aug.py``
on the CPU, on the same explicit decisions (trap C6: the two packages'
random streams never agree, so decisions are drawn once with numpy and
handed to both).

``crop``, ``flip`` and ``mixup`` match exactly on uint8 (mixup computes
``lam·x + (1-lam)·x[perm]`` in float32 on both sides and rounds half to
even: no LSB allowance was needed). ``color_jitter`` matches to 1 LSB,
the bound ``tests/test_device_aug.py`` pins for the JAX twins (a float32
sum taken in another order can land on the other side of a .5).
``DeviceAugment`` is reproducible from its seed and keeps one stream a
slot; ``augment_step`` leaves the step's dropout stream as it was. The
mixup train step (``label_b``, ``lam``) matches the JAX step's convex-pair
loss from the same carried state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.data import device_aug as jax_aug
from deepvision_tpu_torch.core.prng import KeySeq
from deepvision_tpu_torch.data import device_aug
from deepvision_tpu_torch.train.steps import classification_train_step
from tests.test_torch_train import (  # noqa: F401  (mid_training: fixture)
    _batch,
    _carry,
    _params_close,
    mid_training,
)
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


def _images(n=6, h=40, w=52, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_crop_matches_jax_exactly():
    imgs = _images()
    rng = np.random.default_rng(1)
    tops = rng.integers(0, 40 - 24 + 1, 6).astype(np.int32)
    lefts = rng.integers(0, 52 - 24 + 1, 6).astype(np.int32)
    want = np.asarray(jax_aug.crop(jnp.asarray(imgs), jnp.asarray(tops),
                                   jnp.asarray(lefts), 24))
    got = device_aug.crop(_t(imgs), _t(tops), _t(lefts), 24)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_flip_matches_jax_exactly():
    imgs = _images()
    flips = np.array([True, False, True, True, False, False])
    want = np.asarray(jax_aug.flip(jnp.asarray(imgs), jnp.asarray(flips)))
    got = device_aug.flip(_t(imgs), _t(flips))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lam", [0.5, 0.3141, 0.9])
def test_mixup_matches_jax_exactly(lam):
    imgs = _images(seed=2)
    perm = np.random.default_rng(3).permutation(6).astype(np.int32)
    want = np.asarray(jax_aug.mixup(jnp.asarray(imgs), jnp.asarray(perm),
                                    jnp.float32(lam)))
    got = device_aug.mixup(_t(imgs), _t(perm),
                           torch.tensor(lam, dtype=torch.float32))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_color_jitter_matches_jax_to_one_lsb(dtype):
    imgs = _images(seed=4).astype(dtype)
    rng = np.random.default_rng(5)
    fb, fc, fs = (rng.uniform(0.8, 1.2, 6).astype(np.float32)
                  for _ in range(3))
    want = np.asarray(jax_aug.color_jitter(jnp.asarray(imgs), *map(
        jnp.asarray, (fb, fc, fs)))).astype(np.float64)
    got = device_aug.color_jitter(_t(imgs), _t(fb), _t(fc), _t(fs))
    assert got.dtype == torch.from_numpy(imgs).dtype
    gap = np.abs(got.numpy().astype(np.float64) - want)
    if dtype == np.uint8:
        assert gap.max() <= 1
    else:  # float32: the same sums in another order, relative 1e-6
        assert gap.max() <= 1e-6 * 255 * 2


def test_device_augment_is_reproducible_and_its_slots_independent():
    imgs = _t(_images(n=8, seed=6))
    labels = torch.arange(8, dtype=torch.int32)
    batch = {"image": imgs, "label": labels}
    full = device_aug.DeviceAugment(crop=24, flip=True, jitter=0.2,
                                    mixup=0.2)
    a, b = full(batch, 1234), full(batch, 1234)
    for k in ("image", "label_b", "lam"):
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(full(batch, 99)["image"], a["image"])
    assert a["image"].shape == (8, 24, 24, 3)
    assert a["image"].dtype == torch.uint8
    assert sorted(a["label_b"].tolist()) == list(range(8))

    # switching jitter on does not re-deal the crops or the flip coins:
    # with it, the output is the jitter of the crop-and-flip without it
    seed = 77
    plain = device_aug.DeviceAugment(crop=24, flip=True)(batch, seed)
    jittered = device_aug.DeviceAugment(crop=24, flip=True, jitter=0.2)(
        batch, seed)
    seeds = device_aug.DeviceAugment().seeds(seed)
    gen = torch.Generator().manual_seed(seeds["jitter"])
    want = device_aug.color_jitter(plain["image"], *device_aug.jitter_params(
        gen, 8, 0.2, 0.2, 0.2))
    assert torch.equal(jittered["image"], want)
    assert not torch.equal(jittered["image"], plain["image"])


def test_mixup_params_reproducible_from_the_seed():
    perm, lam = device_aug.mixup_params(5, 16, 0.2, torch.device("cpu"))
    perm2, lam2 = device_aug.mixup_params(5, 16, 0.2, torch.device("cpu"))
    assert torch.equal(perm, perm2) and float(lam) == float(lam2)
    assert lam.dtype == torch.float32 and lam.ndim == 0
    assert float(lam) == pytest.approx(
        np.random.default_rng(5).beta(0.2, 0.2), rel=1e-6)
    with pytest.raises(ValueError, match="classification-only"):
        device_aug.DeviceAugment("gan", mixup=0.2)
    with pytest.raises(ValueError, match="mixup"):
        device_aug.DeviceAugment(mixup=-0.1)


def test_augment_step_leaves_the_dropout_stream_alone():
    """The wrapped step's generator gives the draws the unwrapped step's
    does, and the augmentation follows the generator's seed."""
    seen = []

    def step(state, batch, generator):
        seen.append((batch, torch.rand(4, generator=generator)))
        return {}

    batch = {"image": _t(_images(n=4, seed=7)),
             "label": torch.arange(4, dtype=torch.int32)}
    aug = device_aug.DeviceAugment(flip=True, jitter=0.2)
    wrapped = device_aug.augment_step(step, aug)
    wrapped(None, batch, next(KeySeq(1, 0)))
    step(None, batch, next(KeySeq(1, 0)))
    wrapped(None, batch, next(KeySeq(1, 0)))
    (aug_a, draws_a), (plain, draws_p), (aug_b, draws_b) = seen
    assert torch.equal(draws_a, draws_p) and torch.equal(draws_a, draws_b)
    assert plain["image"] is batch["image"]
    assert torch.equal(aug_a["image"], aug_b["image"])
    assert not torch.equal(aug_a["image"], batch["image"])


def test_mixup_loss_matches_the_jax_convex_pair(mid_training):
    """A step on ``label_b`` and ``lam`` from the same carried state: the
    loss ``lam·CE(y) + (1-lam)·CE(y_b)`` and the parameters after it, as
    the JAX step computes them (float32, dropout off)."""
    jstate, jstep = mid_training
    state = _carry(jstate)
    batch = _batch(11)
    rng = np.random.default_rng(12)
    batch["label_b"] = batch["label"][rng.permutation(len(batch["label"]))]
    lam = np.float32(0.37)
    jstate, jm = jstep(jstate, {**batch, "lam": jnp.float32(lam)},
                       jax.random.key(0))
    m = classification_train_step(
        state, {**{k: _t(v) for k, v in batch.items()},
                "lam": torch.tensor(lam)}, next(KeySeq(1, 0)),
        normalize_kind="torch")
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    plain = classification_train_step(
        _carry(mid_training[0]), {k: _t(v) for k, v in batch.items()
                                  if k != "label_b"},
        next(KeySeq(1, 0)), normalize_kind="torch")
    assert abs(float(plain["loss"]) - float(m["loss"])) > 1e-3
    _params_close(state, jstate, atol=1e-5)
