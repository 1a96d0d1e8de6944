"""The port's GANs against the JAX package's, on the CPU.

Every comparison takes the same seeded numpy inputs on both sides, with
flax's weights carried by ``convert.from_flax``:

- flax's SAME ``ConvTranspose`` (trap C2 at the GAN sites) at (k5, s1),
  (k5, s2) and (k3, s2) to 1e-6; an unflipped kernel, and torch's own
  symmetric ``padding``/``output_padding``, are shown to miss by far
  more. ``InstanceNorm`` to 1e-6, and an eps of torch's 1e-5 misses on a
  low-variance input.
- DCGAN's and CycleGAN's nets (``n_blocks=1``, 32 px, both norms) in
  evaluation and training mode, with the BN statistics they leave, to
  1e-5 of each output's scale; bf16 twins within four bf16 steps of the
  output's scale, every BatchNorm flax's stock one with float32 output
  (trap C8).
- ``pool_query`` bit for bit, with JAX's coins and indices reproduced
  from the key by the same ``jax.random`` calls, through the fill phase,
  a batch that crosses ``count == size`` and the mature phase.
- The DCGAN and CycleGAN steps from a carried mid-training JAX state
  (Adam's later updates are continuous in the gradient, where its first,
  ``±lr``, turns around on a gradient that rounding moves across 0):
  DCGAN's every parameter, BN statistic and Adam moment to 1e-5, its
  losses to 1e-5 of their scale; CycleGAN's to 1e-5 plus three times the
  float32 floor of JAX runs on the batch nudged by N(0, 1e-6) (its L1
  losses' kinks make the step chaotic at that noise); counts exactly. DCGAN's dropout masks are
  recorded from flax's ``nn.Dropout`` with ``intercept_methods``; masks
  drawn anew for the critic tape's fake pass miss, and ``label_smooth``
  moves only the critic's real term.
- The joint loss-scale skip, the scheduled Adam against optax's
  ``adam(linear_decay, b1=0.5)`` across the decay start with a skipped
  step, the carried state, checkpoint and resume against an
  uninterrupted run, the data sets bit for bit, the record reader and
  the ``"gan"`` augmentation family, and the CLIs with ``--device cpu``.
"""

import gzip
import io
import json
import shutil
import struct

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.data import device_aug as jax_aug
from deepvision_tpu.data import gan as jax_gan_data
from deepvision_tpu.data import mnist as jax_mnist
from deepvision_tpu.models import get_model as jax_get_model
from deepvision_tpu.train import gan as jax_gan
from deepvision_tpu.train import schedules as jax_schedules
from deepvision_tpu_torch.convert.from_flax import (
    flax_gan_state_to_torch,
    flax_to_torch,
    load_flax_gan_state,
)
from deepvision_tpu_torch.core.precision import get_policy
from deepvision_tpu_torch.data import device_aug, gan as gan_data, mnist
from deepvision_tpu_torch.data.synthetic_records import write_synthetic_gan
from deepvision_tpu_torch.eval.__main__ import main as eval_main
from deepvision_tpu_torch.models import create_model, layers
from deepvision_tpu_torch.models import gan as gan_models
from deepvision_tpu_torch.serve.__main__ import main as serve_main
from deepvision_tpu_torch.serve.models import load_served
from deepvision_tpu_torch.train import gan
from deepvision_tpu_torch.train.__main__ import main as train_main
from deepvision_tpu_torch.train.optimizers import (
    ScheduledAdam,
    make_optimizer,
)
from deepvision_tpu_torch.train.schedules import linear_decay
from deepvision_tpu_torch.train.state import guarded_step
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
DCGAN_NETS = {"generator": "dcgan_generator",
              "discriminator": "dcgan_discriminator"}
CYC_NETS = {"gen_a2b": "cyclegan_generator", "gen_b2a": "cyclegan_generator",
            "dis_a": "cyclegan_discriminator",
            "dis_b": "cyclegan_discriminator"}
CYC_KW = {"n_blocks": 1}
CYC_SIZE, CYC_BATCH, CYC_POOL = 32, 2, 2
BF16_STEP = 2.0 ** -7


def _np(tree):
    """A JAX tree as writable numpy arrays."""
    return jax.tree_util.tree_map(np.array, tree)


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# -------------------------------------------------- transposed conv


def _flax_conv_transpose(k, s, cin=4, cout=3, h=7, seed=0):
    m = nn.ConvTranspose(cout, (k, k), strides=(s, s), padding="SAME")
    x = _rand((2, h, h, cin), seed)
    v = _np(m.init(jax.random.key(seed), x))
    v["params"]["bias"] = _rand((cout,), seed + 1)
    return x, v, np.asarray(m.apply(v, x))


@pytest.mark.parametrize("k,s,pads", [(5, 1, (2, 2)), (5, 2, (3, 2)),
                                      (3, 2, (2, 1))])
def test_conv_transpose_same_matches_flax(k, s, pads):
    """flax's SAME transposed convolution is a convolution of the
    UNFLIPPED kernel over the stride-dilated input between ``lax``'s
    (before, after) pads; the port flips the kernel for torch's
    transposed convolution and crops the trailing rows. Held to 1e-6;
    the unflipped kernel misses by more than 0.1, and so does torch's
    symmetric padding (output_padding s - 1, which gives the same size)
    wherever the pads are not symmetric: under stride 2."""
    assert layers.conv_transpose_padding(k, s) == pads
    x, v, want = _flax_conv_transpose(k, s)
    conv = layers.ConvTranspose(4, 3, (k, k), (s, s))
    conv.load_state_dict(flax_to_torch_conv(v))
    got = layers.conv_transpose_same(torch.from_numpy(x), conv)
    assert got.shape == want.shape == (2, 7 * s, 7 * s, 3)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = conv.weight.detach()
    unflipped = torch.nn.functional.conv_transpose2d(
        xt, w.transpose(0, 1), conv.bias, s, padding=k - 1 - pads[0],
        output_padding=0)[:, :, :7 * s, :7 * s]
    symmetric = torch.nn.functional.conv_transpose2d(
        xt, w.transpose(0, 1).flip(2, 3), conv.bias, s, padding=k // 2,
        output_padding=s - 1)
    assert symmetric.shape[2:] == (7 * s, 7 * s)
    for wrong in (unflipped, symmetric)[:1 + (pads[0] != pads[1])]:
        gap = np.abs(wrong.permute(0, 2, 3, 1).detach().numpy() - want)
        assert gap.max() > 0.1, gap.max()


def flax_to_torch_conv(v):
    """A lone flax (transposed) conv's variables in the port's layout."""
    return {"weight": torch.from_numpy(
        v["params"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "bias": torch.from_numpy(v["params"]["bias"])}


def test_instance_norm_matches_flax_and_its_eps():
    """flax's eps is 1e-6: on channels of variance ~1e-6 torch's 1e-5
    moves the output by tens of percent."""
    rng = np.random.default_rng(0)
    # centred channels: E[x²] - E[x]² is exact enough in float32 there
    x = (rng.normal(0, 1, (2, 6, 6, 4))
         * np.array([1.0, 1e-3, 3e-3, 0.1])).astype(np.float32)
    m = nn.InstanceNorm(dtype=jnp.float32)
    v = _np(m.init(jax.random.key(0), x))
    v["params"]["scale"] = _rand((4,), 1, 0.5, 1.5)
    v["params"]["bias"] = _rand((4,), 2)
    want = np.asarray(m.apply(v, x))
    norm = layers.InstanceNorm(4)
    norm.load_state_dict({k: torch.from_numpy(a)
                          for k, a in v["params"].items()})
    got = norm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    norm.eps = 1e-5
    wrong = norm(torch.from_numpy(x)).detach().numpy()
    assert np.abs(wrong - want).max() > 0.1


# ------------------------------------------------------------ models


def _variables(name, x, seed=1, **kw):
    m = jax_get_model(name, **kw)
    v = _np(m.init({"params": jax.random.key(seed),
                    "dropout": jax.random.key(seed)}, x, train=False))
    # non-trivial norm affines and statistics
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(v)[0]
    for path, leaf in flat:
        key = getattr(path[-1], "key", "")
        if key in ("scale", "var"):
            leaf[...] = rng.uniform(0.5, 1.5, leaf.shape)
        elif key in ("mean",) or (key == "bias" and leaf.ndim == 1):
            leaf[...] = rng.uniform(-0.2, 0.2, leaf.shape)
    return m, v


def _port(name, v, dtype=torch.float32, **kw):
    t = create_model(name, device=CPU, dtype=dtype, **kw)
    t.load_state_dict(flax_to_torch(name, v, **kw))
    return t


MODEL_CASES = [
    ("dcgan_generator", (4, 100), {}),
    ("dcgan_discriminator", (4, 28, 28, 1), {}),
    ("cyclegan_generator", (2, 32, 32, 3), {"n_blocks": 1, "norm": "batch"}),
    ("cyclegan_generator", (2, 32, 32, 3),
     {"n_blocks": 1, "norm": "instance"}),
    ("cyclegan_discriminator", (2, 32, 32, 3), {"norm": "batch"}),
    ("cyclegan_discriminator", (2, 32, 32, 3), {"norm": "instance"}),
]


def _record_dropout(fn):
    """``fn()`` under an interceptor that records each ``nn.Dropout``'s
    keep mask (its output's nonzeros) -> (fn's value, masks)."""
    masks = []

    def rec(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, nn.Dropout)
                and context.method_name == "__call__"):
            masks.append(torch.from_numpy(np.asarray(out) != 0))
        return out

    with nn.intercept_methods(rec):
        value = fn()
    return value, tuple(masks)


@pytest.mark.parametrize("name,shape,kw", MODEL_CASES)
def test_gan_models_match_flax(name, shape, kw):
    """Evaluation and training forwards to 1e-5 of the output's scale,
    the BN statistics a training forward leaves to 1e-6 (flax's momentum
    0.99); the discriminator's dropout with flax's masks."""
    x = _rand(shape, 3)
    m, v = _variables(name, x, **kw)
    t = _port(name, v, **kw)
    want = np.asarray(m.apply(v, x, train=False))
    got = t(torch.from_numpy(x)).detach().numpy()
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol)
    if name == "dcgan_discriminator":
        want, masks = _record_dropout(lambda: m.apply(
            v, x, train=True, rngs={"dropout": jax.random.key(9)}))
        got = t(torch.from_numpy(x), train=True, masks=masks)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=tol)
        return
    want, mut = m.apply(v, x, train=True, mutable=["batch_stats"])
    got = t(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=tol)
    if kw.get("norm") == "instance":
        assert not list(t.buffers())
        return
    stats = flax_to_torch(name, {**v, "batch_stats": _np(
        mut["batch_stats"])}, **kw)
    for key, value in t.state_dict().items():
        if key.endswith(("mean", "var")):
            np.testing.assert_allclose(value.numpy(), stats[key].numpy(),
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name,shape,kw", [MODEL_CASES[0], MODEL_CASES[2]])
def test_gan_models_bf16_twins_and_float32_norms(name, shape, kw):
    """In bf16 every BatchNorm is flax's stock one (float32 statistics
    and output, momentum 0.99; trap C8), so the generators' residual
    stream stays float32: the output within four bf16 steps of its
    scale of the flax model run in bf16, in training mode."""
    x = _rand(shape, 4)
    m, v = _variables(name, x, **kw)
    t = _port(name, v, dtype=torch.bfloat16, **kw)
    norms = [mod for mod in t.modules()
             if isinstance(mod, layers._BatchNorm)]
    assert norms and all(type(n) is layers.BatchNorm
                         and n.dtype == torch.float32
                         and n.momentum == 0.99 for n in norms)
    outs = []
    for n in norms:
        n.register_forward_hook(lambda mod, i, o: outs.append(o.dtype))
    want, _ = jax_get_model(name, dtype=jnp.bfloat16, **kw).apply(
        v, x, train=True, mutable=["batch_stats"])
    got = t(torch.from_numpy(x), train=True).float().detach().numpy()
    assert set(outs) == {torch.float32}
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=4 * BF16_STEP * scale)


def test_batchnorm_takes_the_flat_dcgan_input():
    """``bn0`` normalizes DCGAN's ``(B, 12544)`` vector over the batch
    axis alone, as flax reduces every axis but the last."""
    x = _rand((6, 12544), 5) * 3.0
    bn = layers.BatchNorm(12544, momentum=0.99, dtype=torch.float32)
    y = bn(torch.from_numpy(x), train=True).detach().numpy()
    mean, var = x.mean(0), x.var(0)
    np.testing.assert_allclose(y, (x - mean) / np.sqrt(var + 1e-5),
                               atol=1e-4)
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * mean, atol=1e-6)


# --------------------------------------------------------------- pool


def _jax_pool_draws(key, n, size):
    """JAX's coins and indices of ``pool_query(pool, images, key)``,
    drawn by the same ``jax.random`` calls."""
    coins, index = [], []
    for k in jax.random.split(key, n):
        kp, ki = jax.random.split(k)
        coins.append(float(jax.random.uniform(kp)))
        index.append(int(jax.random.randint(ki, (), 0, size)))
    return (torch.tensor(coins, dtype=torch.float32),
            torch.tensor(index, dtype=torch.int64))


def test_pool_query_matches_jax():
    """Pool of 3, batches of 2: the first fills two slots, the second
    crosses ``count == size`` (one fill, one coin), the rest are mature;
    every output and the pool bit for bit, with at least one swap and
    one pass-through in the mature phase."""
    size, shape = 3, (4, 4, 3)
    jpool = jax_gan.create_pool(size, shape)
    pool = gan.create_pool(size, shape, CPU)
    swaps = passes = 0
    for i in range(6):
        images = _rand((2, *shape), 10 + i)
        key = jax.random.key(20 + i)
        want, jpool = jax_gan.pool_query(jpool, jnp.asarray(images), key)
        coins, index = _jax_pool_draws(key, 2, size)
        got, pool = gan.pool_query(pool, torch.from_numpy(images), coins,
                                   index)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(pool["images"].numpy(),
                                      np.asarray(jpool["images"]))
        assert int(pool["count"]) == int(jpool["count"]) == min(
            2 * (i + 1), size)
        if i >= 2:
            swaps += int((coins > 0.5).sum())
            passes += int((coins <= 0.5).sum())
    assert swaps and passes


# ---------------------------------------------------------- the steps


def _carry(state, js, nets, roles, model_kw=None):
    load_flax_gan_state(state, flax_gan_state_to_torch(
        nets, roles, params=_np(js.params), batch_stats=_np(js.batch_stats),
        opt_state=_np(js.opt_state), step=int(js.step),
        pools=_np(js.extra_vars) or None,
        loss_scale=(None if js.loss_scale is None
                    else _np({"scale": js.loss_scale.scale,
                              "good_steps": js.loss_scale.good_steps})),
        model_kw=model_kw))


def _leaves_of(converted, roles):
    out = {f"{net}.{k}": v for net, sd in converted["modules"].items()
           for k, v in sd.items()}
    for opt, names in roles.items():
        c = converted["adam"][opt]
        for key in ("exp_avg", "exp_avg_sq"):
            for net in names:
                out.update({f"{opt}:{key}:{net}.{k}": v
                            for k, v in c[key][net].items()})
        out[f"{opt}:step"] = torch.tensor(float(c["step"]))
        if c["count"] is not None:
            out[f"{opt}:count"] = torch.tensor(float(c["count"]))
    for name, pool in converted["pools"].items():
        out.update({f"{name}:{k}": v for k, v in pool.items()})
    return out


def _jax_leaves(js, nets, roles, model_kw=None):
    return _leaves_of(flax_gan_state_to_torch(
        nets, roles, params=_np(js.params), batch_stats=_np(js.batch_stats),
        opt_state=_np(js.opt_state), step=int(js.step),
        pools=_np(js.extra_vars) or None, model_kw=model_kw), roles)


def _port_leaves(state):
    out = {f"{net}.{k}": v.detach().clone()
           for net, m in state.modules.items()
           for k, v in m.state_dict().items()}
    for opt, names in state.roles.items():
        optimizer = state.optimizers[opt]
        for net in names:
            for k, p in state.modules[net].named_parameters():
                st = optimizer.state[p]
                for key in ("exp_avg", "exp_avg_sq"):
                    out[f"{opt}:{key}:{net}.{k}"] = st[key].clone()
                out[f"{opt}:step"] = st["step"].clone().float()
        if hasattr(optimizer, "count"):
            out[f"{opt}:count"] = optimizer.count.clone()
    for name, pool in state.pools.items():
        out.update({f"{name}:{k}": v.clone() for k, v in pool.items()})
    return out


def _hold(got, want, atol):
    assert set(got) == set(want)
    bad = {k: float((got[k].double() - want[k].double()).abs().max())
           for k in want}
    bad = {k: v for k, v in bad.items() if v > atol}
    assert not bad, sorted(bad.items(), key=lambda kv: -kv[1])[:5]


def _dcgan_batch(i, n=8):
    return _rand((n, 28, 28, 1), 100 + i)


def _dcgan_draws(js, real, key):
    """JAX's z and dropout masks of ``dcgan_train_step(state, real,
    key)``: z from ``jax.random.split(key, 3)``, each pass's masks
    recorded around ``nn.Dropout`` from a critic apply with that pass's
    key (a mask depends on the key and the shape alone)."""
    kz, kfake, kreal = jax.random.split(key, 3)
    z = jax.random.normal(kz, (real.shape[0], js.noise_dim))
    dp = {"params": js.params["discriminator"]}

    def masks(k):
        return _record_dropout(lambda: js.d_apply(
            dp, jnp.asarray(real), train=True, rngs={"dropout": k}))[1]

    return {"z": torch.from_numpy(np.array(z)), "masks_fake": masks(kfake),
            "masks_real": masks(kreal)}


@pytest.fixture(scope="module")
def dcgan_carried():
    """A JAX DCGAN state one step into training (so that Adam's updates
    are continuous in the gradient) and the next two steps' batches,
    keys and JAX states."""
    js = jax_gan.create_dcgan_state(jax_get_model("dcgan_generator"),
                                    jax_get_model("dcgan_discriminator"),
                                    rng=0)
    step = jax.jit(jax_gan.dcgan_train_step, static_argnums=3)
    js, _ = step(js, {"image": _dcgan_batch(0)}, jax.random.key(0), 0.0)
    start, runs = js, []
    for i in (1, 2):
        key = jax.random.key(i)
        js, m = step(js, {"image": _dcgan_batch(i)}, key, 0.0)
        runs.append((_dcgan_batch(i), key, js, m))
    return start, runs, step


def _port_dcgan(js):
    state = gan.create_dcgan_state(device=CPU)
    _carry(state, js, DCGAN_NETS, gan.DCGAN_ROLES)
    return state


def test_dcgan_train_step_matches_jax(dcgan_carried):
    """Two steps from the carried state with JAX's z and masks: both
    losses to 1e-5 of their scale, every leaf to 1e-5, Adam's counts
    exactly. A critic tape whose fake pass draws its own masks (not the
    generator tape's) misses on the critic's leaves."""
    start, runs, _ = dcgan_carried
    state = _port_dcgan(start)
    for real, key, js, jm in runs:
        m = gan.dcgan_train_step(state, {"image": torch.from_numpy(real)},
                                 _dcgan_draws(start, real, key))
        for k in ("g_loss", "d_loss"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(
                1.0, abs(float(jm[k]))), k
    assert state.step == int(js.step) == 3
    want = _jax_leaves(js, DCGAN_NETS, gan.DCGAN_ROLES)
    _hold(_port_leaves(state), want, 1e-5)

    # the mutation: fresh masks for the critic tape's fake pass
    twin = _port_dcgan(start)
    dis = twin.modules["discriminator"]
    forward, calls = dis.forward, []

    def redrawn(x, train=False, masks=None):
        calls.append(1)
        if len(calls) % 3 == 0:  # the critic tape's fake pass
            masks = tuple(torch.rand(mk.shape) < 0.7 for mk in masks)
        return forward(x, train=train, masks=masks)

    dis.forward = redrawn
    for real, key, _, _ in runs:
        gan.dcgan_train_step(twin, {"image": torch.from_numpy(real)},
                             _dcgan_draws(start, real, key))
    got = _port_leaves(twin)
    missed = [k for k in want if k.startswith(("discriminator",
                                               "discriminator:"))
              and float((got[k] - want[k]).abs().max()) > 1e-5]
    assert len(missed) >= 4, missed


def test_dcgan_label_smooth_moves_only_the_real_term(dcgan_carried):
    """``label_smooth=0.1`` against JAX's step with it; against the
    unsmoothed port step the generator tape is untouched (its loss and
    every generator leaf equal) and the critic's loss moves by exactly
    its real term's change."""
    start, runs, jstep = dcgan_carried
    real, key, _, _ = runs[0]
    draws = _dcgan_draws(start, real, key)
    plain, smooth = _port_dcgan(start), _port_dcgan(start)
    dis = plain.modules["discriminator"]
    with torch.no_grad():
        logits = dis(torch.from_numpy(real), train=True,
                     masks=draws["masks_real"])
    term = (gan._bce(logits, True, 0.1) - gan._bce(logits, True)).item()
    m0 = gan.dcgan_train_step(plain, {"image": torch.from_numpy(real)},
                              draws)
    m1 = gan.dcgan_train_step(smooth, {"image": torch.from_numpy(real)},
                              draws, label_smooth=0.1)
    assert float(m1["g_loss"]) == float(m0["g_loss"])
    assert float(m1["d_loss"]) - float(m0["d_loss"]) == pytest.approx(
        term, abs=1e-6)
    js, jm = jstep(start, {"image": real}, key, 0.1)
    assert float(m1["d_loss"]) == pytest.approx(float(jm["d_loss"]),
                                                abs=1e-5)
    a, b = _port_leaves(plain), _port_leaves(smooth)
    assert all(torch.equal(a[k], b[k]) for k in a
               if k.startswith("generator"))
    assert not torch.equal(a["discriminator.fc.weight"],
                           b["discriminator.fc.weight"])
    _hold(b, _jax_leaves(js, DCGAN_NETS, gan.DCGAN_ROLES), 1e-5)


def _cyc_batch(i):
    return {"a": _rand((CYC_BATCH, CYC_SIZE, CYC_SIZE, 3), 200 + i),
            "b": _rand((CYC_BATCH, CYC_SIZE, CYC_SIZE, 3), 300 + i)}


def _cyc_draws(key):
    ka, kb = jax.random.split(key)
    return {"pool_a2b": _jax_pool_draws(ka, CYC_BATCH, CYC_POOL),
            "pool_b2a": _jax_pool_draws(kb, CYC_BATCH, CYC_POOL)}


CYC_MODEL_KW = {"gen_a2b": CYC_KW, "gen_b2a": CYC_KW}


def test_cyclegan_train_step_matches_jax():
    """``n_blocks=1``, 32 px, batch 2, pools of 2, Adam under
    ``linear_decay(2e-4, 4, 1)``: two JAX steps fill the pools, then one
    step from that carried state (the pools mature, with JAX's coins and
    indices; the schedule past its decay start). The L1 losses' and the
    ReLUs' kinks make JAX's own step chaotic at float32's noise: three
    JAX runs on the batch plus N(0, 1e-6) noise give each leaf its floor,
    and every parameter, BN statistic, Adam moment and pool is held to
    1e-5 plus three times it, every metric to 1e-5 of its scale plus four
    times its own; Adam's and the schedule's counts exactly."""
    sched = (2e-4, 4, 1)
    js = jax_gan.create_cyclegan_state(
        jax_get_model("cyclegan_generator", **CYC_KW),
        jax_get_model("cyclegan_discriminator"), image_size=CYC_SIZE,
        lr_schedule=jax_schedules.linear_decay(*sched), pool_size=CYC_POOL,
        rng=0)
    step = jax.jit(jax_gan.cyclegan_train_step)
    for i in range(2):
        js, _ = step(js, _cyc_batch(i), jax.random.key(50 + i))
    assert int(js.extra_vars["pool_a2b"]["count"]) == CYC_POOL
    state = gan.create_cyclegan_state(
        image_size=CYC_SIZE, lr_schedule=linear_decay(*sched),
        pool_size=CYC_POOL, device=CPU, **CYC_KW)
    _carry(state, js, CYC_NETS, gan.CYCLEGAN_ROLES, CYC_MODEL_KW)
    key, batch = jax.random.key(52), _cyc_batch(2)
    nudged = [step(js, {k: v + np.random.default_rng(r).normal(
        0, 1e-6, v.shape).astype(np.float32) for k, v in batch.items()},
        key) for r in range(3)]
    js, jm = step(js, batch, key)
    m = gan.cyclegan_train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        _cyc_draws(key))
    assert set(m) == set(jm)
    for k in m:
        floor = max(abs(float(n[1][k]) - float(jm[k])) for n in nudged)
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))) + 4 * floor, k
    got = _port_leaves(state)
    want = _jax_leaves(js, CYC_NETS, gan.CYCLEGAN_ROLES, CYC_MODEL_KW)
    floors = [_jax_leaves(n[0], CYC_NETS, gan.CYCLEGAN_ROLES, CYC_MODEL_KW)
              for n in nudged]
    assert float(got["generator:count"]) == 3.0 == float(
        want["generator:count"])
    assert set(got) == set(want)
    over = {}
    for k in want:
        floor = max(float((f[k].double() - want[k].double()).abs().max())
                    for f in floors)
        gap = float((got[k].double() - want[k].double()).abs().max())
        if gap > 1e-5 + 3 * floor:
            over[k] = (gap, floor)
    assert not over, sorted(over.items())[:5]


def test_joint_skip_keeps_both_nets_and_backs_off():
    """A loss-scaled DCGAN step whose real images hold an inf: only the
    critic's tape sees them, yet neither net moves. Every parameter,
    both Adams' moments and counts and every BN statistic keep their
    values and the scale halves; the next clean step updates both."""
    state = gan.create_dcgan_state(policy=get_policy("bf16_scaled"),
                                   device=CPU)
    gen = torch.Generator().manual_seed(0)
    real = torch.from_numpy(_dcgan_batch(0))
    gan.dcgan_train_step(state, {"image": real}, gen)
    before = _port_leaves(state)
    scale = float(state.loss_scale.scale)
    bad = real.clone()
    bad[0, 3, 3, 0] = float("inf")
    m = gan.dcgan_train_step(state, {"image": bad}, gen)
    assert float(m["mp_grads_finite"]) == 0.0
    assert float(state.loss_scale.scale) == scale / 2
    after = _port_leaves(state)
    assert all(torch.equal(before[k], after[k]) for k in before)
    gan.dcgan_train_step(state, {"image": real}, gen)
    moved = _port_leaves(state)
    assert not torch.equal(moved["generator.fc.weight"],
                           before["generator.fc.weight"])
    assert not torch.equal(moved["discriminator.fc.weight"],
                           before["discriminator.fc.weight"])


def test_scheduled_adam_matches_optax_across_the_decay_start():
    """``optax.adam(linear_decay(1e-2, 6, 2), b1=0.5)`` over five
    gradients, the third skipped (the JAX state's select keeps it, the
    port's ``guarded_step``): parameters to 1e-6, and the skipped step
    advances neither Adam's count nor the schedule's."""
    rng = np.random.default_rng(0)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in p0]
             for _ in range(5)]
    tx = optax.adam(jax_schedules.linear_decay(1e-2, 6, 2), b1=0.5)
    jp = [jnp.asarray(p) for p in p0]
    js = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, plateau = make_optimizer(
        {"optimizer": "adam", "optimizer_params": {"lr": 1e-2, "beta1": 0.5},
         "scheduler": "linear_decay",
         "scheduler_params": {"total_steps": 6, "decay_start": 2}}, tp)
    assert isinstance(opt, ScheduledAdam) and plateau is None
    for i, g in enumerate(grads):
        finite = i != 2
        if finite:
            up, js = tx.update([jnp.asarray(x) for x in g], js, jp)
            jp = optax.apply_updates(jp, up)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        guarded_step(opt, tp, torch.tensor(finite))
    for p, j in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=1e-6)
    assert float(opt.count) == 4.0 == int(js[1].count)
    assert all(float(opt.state[p]["step"]) == 4.0 for p in tp)


def test_gan_state_carried_from_jax():
    """The converter carries a loss-scaled CycleGAN state one step in:
    every leaf bit for bit, the pools, Adam's and the schedule's counts,
    the step and the scale."""
    from deepvision_tpu.core.precision import get_policy as jax_policy

    js = jax_gan.create_cyclegan_state(
        jax_get_model("cyclegan_generator", **CYC_KW),
        jax_get_model("cyclegan_discriminator"), image_size=16,
        lr_schedule=jax_schedules.linear_decay(2e-4, 4, 1), pool_size=3,
        rng=1, policy=jax_policy("bf16_scaled"))
    js, _ = jax.jit(jax_gan.cyclegan_train_step)(
        js, {"a": _rand((2, 16, 16, 3), 1), "b": _rand((2, 16, 16, 3), 2)},
        jax.random.key(0))
    state = gan.create_cyclegan_state(
        image_size=16, lr_schedule=linear_decay(2e-4, 4, 1), pool_size=3,
        device=CPU, policy=get_policy("bf16_scaled"), **CYC_KW)
    _carry(state, js, CYC_NETS, gan.CYCLEGAN_ROLES, CYC_MODEL_KW)
    want = _jax_leaves(js, CYC_NETS, gan.CYCLEGAN_ROLES, CYC_MODEL_KW)
    _hold(_port_leaves(state), want, 0.0)
    assert state.step == 1 and float(state.optimizers["generator"].count) == 1
    assert int(state.pools["pool_b2a"]["count"]) == 2
    assert float(state.loss_scale.scale) == float(js.loss_scale.scale)


# ---------------------------------------------------- checkpoint/resume


@pytest.mark.parametrize("kind", ["dcgan", "cyclegan"])
def test_checkpoint_and_resume_equal_an_uninterrupted_run(tmp_path, kind):
    """``fit_gan`` for two epochs, and for one then a resume to two in a
    fresh state: every leaf (pools and counts included) bit for bit; the
    checkpoint verifies and serves its generator."""
    if kind == "dcgan":
        imgs = _rand((24, 28, 28, 1), 7)

        def data(epoch):
            return gan_data_batches({"image": imgs}, 8, epoch)

        def fresh():
            return gan.create_dcgan_state(device=CPU)

        step = gan.dcgan_train_step
    else:
        a, b = gan_data.synthetic_unpaired(4, size=16)

        def data(epoch):
            return gan_data_batches({"a": a, "b": b}, 2, epoch)

        def fresh():
            return gan.create_cyclegan_state(
                image_size=16, lr_schedule=linear_decay(2e-4, 4, 1),
                pool_size=3, device=CPU, **CYC_KW)

        step = gan.cyclegan_train_step
    whole, part = fresh(), fresh()
    gan.fit_gan(whole, step, data, epochs=2, workdir=tmp_path / "a",
                save_every=1, log_every=0)
    gan.fit_gan(part, step, data, epochs=1, workdir=tmp_path / "b",
                save_every=1, log_every=0)
    resumed = fresh()
    gan.fit_gan(resumed, step, data, epochs=2, workdir=tmp_path / "b",
                save_every=1, log_every=0, resume=True)
    assert resumed.step == whole.step
    want = _port_leaves(whole)
    _hold(_port_leaves(resumed), want, 0.0)
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager

    net = "generator" if kind == "dcgan" else "gen_a2b"
    weights, _ = CheckpointManager(tmp_path / "b" / "ckpt").restore_model(
        device=CPU, net=net)
    assert torch.equal(weights["head.weight" if kind == "cyclegan"
                               else "fc.weight"],
                       want[f"{net}.{'head' if kind == 'cyclegan' else 'fc'}"
                            ".weight"])
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def gan_data_batches(arrays, bs, epoch):
    from deepvision_tpu_torch.data.padding import iter_array_batches

    return iter_array_batches(arrays, bs, rng=np.random.default_rng(epoch))


# --------------------------------------------------------------- data


def test_synthetic_sets_and_the_idx_reader_match_jax(tmp_path):
    for got, want in ((mnist.synthetic_mnist(40, seed=3),
                       jax_mnist.synthetic_mnist(40, seed=3)),
                      (gan_data.synthetic_unpaired(6, size=32, seed=113),
                       jax_gan_data.synthetic_unpaired(6, size=32,
                                                       seed=113))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    paths = {}
    for name, arr in (("img", images), ("lbl", labels)):
        raw = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
            f">{arr.ndim}I", *arr.shape) + arr.tobytes()
        paths[name] = tmp_path / f"{name}.gz"
        paths[name].write_bytes(gzip.compress(raw))
    for pad in (True, False):
        got = mnist.load_mnist_idx(paths["img"], paths["lbl"], pad_to_32=pad)
        want = jax_mnist.load_mnist_idx(paths["img"], paths["lbl"],
                                        pad_to_32=pad)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="magic"):
        mnist.load_mnist_idx(bad, bad)


def test_gan_records_read_as_the_jax_reader_decodes_them(tmp_path):
    """Shards of the port's ``--gan`` writer (PIL's JPEGs) through the
    port's reader with ``device_aug`` (the uint8 canvas of size + 30)
    and through the JAX tf.data reader: each domain's canvases match one
    to one by content, within 8 uint8 steps at worst and 1.5 on average
    (tf decodes with libjpeg's fast IDCT, PIL with the accurate one).
    Without ``device_aug`` the host's flip and crop are those of the
    plan, on the same canvas, in [-1, 1]."""
    size, n = 16, 4
    write_synthetic_gan(tmp_path, train=n, val=1, shards=2, sizes=(40, 60),
                        device="cpu")
    port = next(gan_data.make_cyclegan_data(
        str(tmp_path), n, size, steps_per_epoch=1, device_aug=True)(0))
    canvases = port.decode(CPU)
    ds = jax_gan_data.make_cyclegan_dataset(
        str(tmp_path / "trainA-*"), str(tmp_path / "trainB-*"), n, size,
        device_aug=True)
    ja, jb = next(iter(ds.as_numpy_iterator()))
    for dom, want in (("a", ja), ("b", jb)):
        got = canvases[dom].numpy().astype(np.float32)
        assert got.shape == want.shape == (n, size + 30, size + 30, 3)
        assert canvases[dom].dtype == torch.uint8
        dist = np.abs(got[:, None] - want[None].astype(np.float32)).mean(
            axis=(2, 3, 4))
        match = dist.argmin(1)
        assert sorted(match) == list(range(n)), dist
        gaps = np.abs(got - want[match].astype(np.float32))
        assert gaps.max() <= 8 and gaps.mean() <= 1.5, (gaps.max(),
                                                        gaps.mean())
    plain = next(gan_data.train_batches(
        sorted(tmp_path.glob("trainA-*")), sorted(tmp_path.glob("trainB-*")),
        n, size, seed=0, steps=1))
    out = plain.decode(CPU)
    for d in "ab":
        assert out[d].shape == (n, size, size, 3) and out[d].abs().max() <= 1
        for i in range(n):
            top, left = plain.plan.offsets[d][i]
            img = _canvas(plain_blob(plain, d, i), size,
                          plain.plan.flips[d][i])
            want = img[top:top + size, left:left + size] / 127.5 - 1.0
            torch.testing.assert_close(out[d][i], want, rtol=0, atol=1e-6)


def plain_blob(batch, d, i):
    off = batch[f"offsets_{d}"]
    return bytes(batch[f"jpeg_{d}"][off[i]:off[i + 1]])


def _canvas(blob, size, flipped):
    from deepvision_tpu_torch.data.jpeg import decode_images, pack, \
        resize_bilinear

    img = decode_images(*pack([blob]), CPU)[0]
    if flipped:
        img = img.flip(1)
    canvas = size + gan_data.CANVAS_MARGIN
    return resize_bilinear(img, canvas, canvas)


def test_gan_augment_family_matches_jax_on_its_decisions():
    """JAX's ``"gan"`` family crops and flips each domain under
    ``fold_in(key, i)``; the port's cores on JAX's decisions give its
    output exactly (trap C6: the decisions, not the streams, cross). The
    port's family draws each domain's decisions from ``derive_seed(seed,
    i)``: its output is the cores on those, and the two domains differ."""
    batch = {d: np.random.default_rng(i).integers(
        0, 256, (4, 22, 22, 3), dtype=np.uint8) for i, d in enumerate("ab")}
    key = jax.random.key(3)
    jaug = jax_aug.DeviceAugment("gan", crop=16, flip=True, normalize="tanh")
    want = jaug({k: jnp.asarray(v) for k, v in batch.items()}, key)
    for i, d in enumerate("ab"):
        keys = jaug._keys(jax.random.fold_in(key, i))
        tops, lefts = jax_aug.crop_params(keys["crop"], 4, 22, 22, 16)
        flips = jax_aug.flip_params(keys["flip"], 4)
        x = device_aug.crop(torch.from_numpy(batch[d]),
                            torch.from_numpy(np.asarray(tops)).long(),
                            torch.from_numpy(np.asarray(lefts)).long(), 16)
        x = device_aug.flip(x, torch.from_numpy(np.asarray(flips)))
        got = device_aug.maybe_normalize(x, "tanh")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[d]))
    aug = device_aug.DeviceAugment("gan", crop=16, flip=True,
                                   normalize="tanh")
    out = aug({k: torch.from_numpy(v) for k, v in batch.items()}, seed=5)
    for i, d in enumerate("ab"):
        seeds = aug.seeds(device_aug.derive_seed(5, i))
        g = torch.Generator().manual_seed(seeds["crop"])
        x = device_aug.crop(torch.from_numpy(batch[d]),
                            *device_aug.crop_params(g, 4, 22, 22, 16), 16)
        g = torch.Generator().manual_seed(seeds["flip"])
        x = device_aug.flip(x, device_aug.flip_params(g, 4))
        assert torch.equal(out[d], device_aug.maybe_normalize(x, "tanh"))
    assert out["a"].dtype == torch.float32
    with pytest.raises(ValueError, match="classification-only"):
        device_aug.DeviceAugment("gan", mixup=0.2)


# --------------------------------------------------------------- CLIs


def test_dcgan_and_lenet5_clis(tmp_path, capsys):
    """``train -m dcgan`` (bf16, 2 steps an epoch, label smoothing) for
    one epoch, then ``--resume`` to two; ``serve`` of its generator
    answers a noise vector with a 28x28x1 image in [-1, 1]; ``eval gan -m
    dcgan`` prints its scores; ``lenet5`` trains and serves; the flags
    ``train.py`` refuses stay refused; no LRN kernel runs."""
    wd = str(tmp_path)
    base = ["-m", "dcgan", "--device", "cpu", "--batch-size", "16",
            "--synthetic-size", "32", "--workdir", wd, "--label-smooth",
            "0.1"]
    assert train_main(base + ["--epochs", "1"]) == 0
    assert train_main(base + ["--epochs", "2", "--resume"]) == 0
    err = capsys.readouterr()
    assert "resumed at epoch 1" in err.out
    assert "'lrn_forward_f32': 0" in err.err
    z = np.random.default_rng(0).normal(size=100).tolist()
    out = io.StringIO()
    serve_main(["-m", f"dcgan={wd}/dcgan", "--device", "cpu"],
               stdin=io.StringIO(json.dumps({"id": 1, "input": z}) + "\n"),
               stdout=out)
    image = np.asarray(json.loads(out.getvalue())["result"]["image"])
    assert image.shape == (28, 28, 1) and np.abs(image).max() <= 1.0
    served = load_served("dcgan", f"{wd}/dcgan", device="cpu")
    assert served.task == "gan" and served.scale == "tanh"
    with pytest.raises(FileNotFoundError, match="epoch"):
        load_served("dcgan", epoch=1, device="cpu")
    capsys.readouterr()
    eval_main(["gan", "-m", "dcgan", "--workdir", f"{wd}/dcgan", "--device",
               "cpu", "--n", "32"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["epoch"] == 1 and line["judge_holdout_acc"] > 0.9
    assert np.isfinite(line["score"])
    assert train_main(["-m", "lenet5", "--device", "cpu", "--batch-size",
                       "16", "--synthetic-size", "80", "--epochs", "1",
                       "--workdir", wd]) == 0
    assert load_served("lenet5", f"{wd}/lenet5", device="cpu").scale == \
        "unit"
    for refused in (["-m", "lenet5", "--label-smooth", "0.1"],
                    ["-m", "dcgan", "--label-smooth", "1.0"],
                    ["-m", "dcgan", "--device-aug"]):
        with pytest.raises(SystemExit):
            train_main(refused + ["--device", "cpu", "--workdir", wd])


def test_cyclegan_cli_from_records_with_device_aug(tmp_path, capsys):
    """``synthetic_records --gan`` shards, ``train -m cyclegan --data-dir
    --device-aug`` at 16 px for 2 steps (``bf16_scaled``: one loss scale
    over both tapes), a resume, and ``eval gan -m cyclegan``."""
    from deepvision_tpu_torch.data.synthetic_records import main as rec_main

    rec = tmp_path / "rec"
    rec_main([str(rec), "--gan", "--train", "4", "--val", "1", "--device",
              "cpu"])
    args = ["-m", "cyclegan", "--device", "cpu", "--data-dir", str(rec),
            "--device-aug", "--input-size", "16", "--batch-size", "2",
            "--steps-per-epoch", "2", "--precision", "bf16_scaled",
            "--workdir", str(tmp_path)]
    assert train_main(args + ["--epochs", "1"]) == 0
    assert train_main(args + ["--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr()
    assert "DeviceAugment(gan, crop=16, flip, normalize=tanh)" in out.out
    assert "wire jpeg" in out.out and "resumed at epoch 1" in out.out
    assert "mp_loss_scale" in out.out
    eval_main(["gan", "-m", "cyclegan", "--workdir",
               str(tmp_path / "cyclegan"), "--device", "cpu", "--size",
               "16", "--n", "4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["epoch"] == 1 and line["n"] == 4
    assert np.isfinite(line["score"]) and line["mse_baseline"] > 0
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_gan_registry_and_fresh_init():
    """The four registry names; fresh weights follow flax's defaults:
    lecun_normal kernels (a transposed kernel's fan-in I·KH·KW), zero
    biases, norms at scale 1 and bias 0."""
    g = create_model("cyclegan_generator", device=CPU, seed=0)
    assert isinstance(g, gan_models.CycleGANGenerator) and g.n_blocks == 9
    std = float(g.res0.conv1.weight.detach().std())
    assert std == pytest.approx((1 / (256 * 9)) ** 0.5, rel=0.05)
    assert float(g.up1.weight.detach().std()) == pytest.approx(
        (1 / (256 * 9)) ** 0.5, rel=0.05)
    assert not g.head.bias.any() and torch.equal(
        g.up1_norm.norm.scale, torch.ones(128))
    d = create_model("dcgan_discriminator", device=CPU, seed=0)
    assert d.fc.weight.shape == (1, 7 * 7 * 128)
    with pytest.raises(ValueError, match="masks"):
        d(torch.zeros(1, 28, 28, 1), train=True)
    assert create_model("dcgan_generator", device=CPU)(
        torch.zeros(2, 100)).shape == (2, 28, 28, 1)
