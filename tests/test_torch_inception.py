"""The port's Inception V1 against the JAX package's, on the CPU.

Both variants, ``inception1_ref`` (BN-free, the two stem LRNs, which on
the CPU take the plain versions on the port's side and the jnp path on
the JAX side) and ``inception1`` (ConvBN with ``MixedBatchNorm``), run
the same seeded numpy input on weights carried from flax by
``convert.from_flax``. The flax tree comes from the flax model's own
``init`` shapes with values drawn by numpy (nonzero biases, BN
statistics away from 0 and 1), so that every leaf is carried and
checked. 96 px is where the aux heads' 5x5/3 pool still has input
(96 -> 48 -> 24 -> 12 -> 6). float32 to 1e-4 on logits and 1e-5 on BN
outputs and statistics (sums taken in another order by XLA:CPU and
ATen).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.models import layers as jax_layers
from deepvision_tpu.serve.models import load_served as jax_load_served
from deepvision_tpu.train import state as jax_state
from deepvision_tpu.train.state import TrainState as JaxTrainState
from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.models import create_model, get_model, layers
from deepvision_tpu_torch.serve import load_served
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer
from deepvision_tpu_torch.train.state import TrainState
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
SIZE, CLASSES = 96, 10
VARIANTS = ("inception1_ref", "inception1")


def _draw(path, leaf, rng, gain=2.0):
    """A value for one flax leaf: BN statistics, scales and biases near
    their fresh values but away from them, small nonzero conv and Dense
    biases, kernels of variance ``gain``/fan_in.

    Each conv filter sums to zero, so that a BN input's mean is small
    beside its spread: the batch variance E[x²] - E[x]² then loses no
    digits, and XLA:CPU's float32 sums (about 1e-6 relative, ten times
    ATen's pairwise sums) do not become 1e-4 of the variance."""
    name = path[-1].key
    if name == "mean":
        return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    if name == "var":
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
    if name == "scale":
        return rng.uniform(0.5, 1.0, leaf.shape).astype(np.float32)
    if name == "bias" and path[-2].key == "bn":
        return rng.uniform(0.0, 0.5, leaf.shape).astype(np.float32)
    if len(leaf.shape) == 1:
        return rng.normal(0, 0.01, leaf.shape).astype(np.float32)
    fan_in = int(np.prod(leaf.shape[:-1]))
    w = rng.normal(0, np.sqrt(gain / fan_in), leaf.shape)
    if len(leaf.shape) == 4:
        w -= w.mean(axis=(0, 1, 2))
    return w.astype(np.float32)


def flax_variables(name, size=SIZE, classes=CLASSES, seed=0, gain=2.0):
    """The flax model and numpy variables of its tree (aux heads
    included: flax creates them in training-mode init)."""
    model = flax_get_model(name, num_classes=classes)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=True), jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng, gain), shapes)


def port_module(name, variables, size=SIZE, classes=CLASSES):
    kw = {"num_classes": classes, "input_size": size}
    module = get_model(name, **kw)
    module.load_state_dict(flax_to_torch(name, variables, **kw))
    return module.to(memory_format=torch.channels_last)


def _images(n, size=SIZE, seed=1):
    return (np.random.default_rng(seed).normal(0, 1, (n, size, size, 3))
            .astype(np.float32))


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("name,size,batch", [
    ("inception1_ref", SIZE, 2),
    ("inception1", SIZE, 2),
    ("inception1_ref", 224, 1),
])
def test_eval_logits_match_flax(name, size, batch):
    model, variables = flax_variables(name, size)
    x = _images(batch, size)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    module = port_module(name, variables, size)
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_geometry_and_parameter_count_224():
    """fc1 of each aux head sized from the input: 224 -> 14 at i4a -> 4
    after the 5x5/3 pool, 4*4*128 = 2048; the flax trees' sizes."""
    ref = get_model("inception1_ref")
    bn = get_model("inception1")
    assert ref.aux1.fc1.in_features == bn.aux2.fc1.in_features == 2048
    assert sum(p.numel() for p in ref.parameters()) == 13_378_280
    assert sum(p.numel() for p in bn.parameters()) == 13_385_816
    assert sum(b.numel() for b in bn.buffers()) == 2 * 7_536
    assert not list(ref.buffers())
    assert not hasattr(get_model("inception1", aux_heads=False), "aux1")


def test_train_mode_returns_aux_logits_and_eval_only_main():
    module = create_model("inception1", device=CPU, num_classes=CLASSES,
                          input_size=SIZE)
    x = torch.from_numpy(_images(2))
    gen = torch.Generator().manual_seed(0)
    out = module(x, train=True, generator=gen)
    assert isinstance(out, tuple) and len(out) == 3
    assert all(o.shape == (2, CLASSES) and o.dtype == torch.float32
               for o in out)
    assert module(x).shape == (2, CLASSES)


# ------------------------------------------------- BatchNorm, trap C1


def _flax_convbn(dtype):
    return jax_layers.ConvBN(6, (3, 3), dtype=dtype)


def _convbn_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2.0, (3, 7, 9, 5)).astype(np.float32)
    block = _flax_convbn(jnp.float32)
    shapes = jax.eval_shape(lambda k, v: block.init(k, v, True),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng), shapes)
    return x, variables


def _port_convbn(variables, dtype):
    p, s = variables["params"], variables["batch_stats"]
    block = layers.ConvBN(5, 6, (3, 3), dtype=dtype)
    block.load_state_dict({
        "conv.weight": torch.from_numpy(
            np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()),
        "bn.scale": torch.from_numpy(np.asarray(p["bn"]["scale"])),
        "bn.bias": torch.from_numpy(np.asarray(p["bn"]["bias"])),
        "bn.mean": torch.from_numpy(np.asarray(s["bn"]["mean"])),
        "bn.var": torch.from_numpy(np.asarray(s["bn"]["var"]))})
    return block


# bf16: the convolution and the apply run in bf16 on both sides (one bf16
# step, 2^-8 relative, of the activations' scale); the statistics are
# moments of bf16 tensors taken with float32 accumulators, whose squares
# round in bf16, so they agree to a few bf16 steps of their own size
@pytest.mark.parametrize("dtype,out_tol,stat_tol", [
    ("float32", dict(atol=1e-5, rtol=1e-5), dict(atol=1e-5, rtol=1e-5)),
    ("bfloat16", dict(atol=0.05, rtol=2 ** -6), dict(atol=1e-3, rtol=2e-2)),
])
def test_train_mode_batchnorm_matches_flax(dtype, out_tol, stat_tol):
    """One train-mode ConvBN forward: outputs and the updated running
    statistics against flax's ``batch_stats`` (biased variance, momentum
    0.9); then the eval forward on them. A stock ``nn.BatchNorm2d``
    (unbiased running variance) misses the statistics (trap C1)."""
    x, variables = _convbn_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    block = _flax_convbn(jdt)
    want, mutated = block.apply(variables, jnp.asarray(x), True,
                                mutable=["batch_stats"])
    port = _port_convbn(variables, tdt)
    got = port(torch.from_numpy(x).to(tdt), train=True)
    assert got.dtype == tdt and port.bn.mean.dtype == torch.float32
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **out_tol)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(port.bn.mean.numpy(), stats["mean"],
                               **stat_tol)
    np.testing.assert_allclose(port.bn.var.numpy(), stats["var"], **stat_tol)

    evaluated = block.apply({**variables, **mutated}, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt), train=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(evaluated, np.float32), **out_tol)

    if dtype == "float32":  # trap C1: the stock layer drifts the var
        stock = torch.nn.BatchNorm2d(6, momentum=0.1)
        stock.running_mean.copy_(torch.from_numpy(
            np.asarray(variables["batch_stats"]["bn"]["mean"])))
        stock.running_var.copy_(torch.from_numpy(
            np.asarray(variables["batch_stats"]["bn"]["var"])))
        conv = layers.conv2d(torch.from_numpy(x), port.conv,
                             layers.conv_padding(torch.from_numpy(x),
                                                 port.conv, "SAME"))
        stock.train()(conv.permute(0, 3, 1, 2))
        assert not np.allclose(stock.running_var.detach().numpy(),
                               stats["var"], **stat_tol)


def test_batchnorm_gradients_match_flax():
    """The train-mode backward through the batch statistics."""
    x, variables = _convbn_case(3)
    block = _flax_convbn(jnp.float32)

    def loss(params, x):
        y, _ = block.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, x,
                           True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.arange(6, dtype=jnp.float32))

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                            jnp.asarray(x))
    port = _port_convbn(variables, torch.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt, train=True) * torch.arange(6.0)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(port.bn.scale.grad.numpy(),
                               np.asarray(gp["bn"]["scale"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        port.conv.weight.grad.numpy(),
        np.asarray(gp["conv"]["kernel"]).transpose(3, 2, 0, 1), atol=1e-3,
        rtol=1e-4)


# --------------------------------------------- SAME padding, trap C2


@pytest.mark.parametrize("size", [224, 112, 15, 7, 6])
def test_same_pools_and_stride2_stem_match_flax(size):
    """XLA's SAME under stride 2 pads asymmetrically ((0, 1) at even
    sizes for a 3x3 pool, (2, 3) at 224 for the 7x7 stem): the port's
    pads and results against flax at even and odd sizes."""
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size, 3)).astype(np.float32) - 2.0
    xt = torch.from_numpy(x)
    pads = layers.same_padding(x.shape[1:3], (3, 3), (2, 2))
    got = layers.max_pool(xt, (3, 3), (2, 2), pads).numpy()
    want = np.asarray(flax_nn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                       "SAME"))
    np.testing.assert_array_equal(got, want)  # -inf pads never win
    got = layers.max_pool(xt, (3, 3), (1, 1), [(1, 1), (1, 1)]).numpy()
    want = np.asarray(flax_nn.max_pool(jnp.asarray(x), (3, 3), (1, 1),
                                       "SAME"))
    np.testing.assert_array_equal(got, want)

    conv = flax_nn.Conv(4, (7, 7), (2, 2), padding="SAME", use_bias=False)
    kernel = rng.normal(0, 0.1, (7, 7, 3, 4)).astype(np.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}},
                                 jnp.asarray(x)))
    port = layers.make_conv(3, 4, (7, 7), (2, 2), "SAME", bias=False)
    port.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    got = layers.conv2d(xt, port, layers.conv_padding(xt, port, "SAME"))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    if size == 224:
        assert layers.conv_padding(xt, port, "SAME") == [(2, 3), (2, 3)]
        assert pads == [(0, 1), (0, 1)]


@pytest.mark.parametrize("name,pads", [("inception1_ref", 4),
                                       ("inception1", 5)])
def test_forward_pads_only_what_xla_pads_asymmetrically(name, pads,
                                                        monkeypatch):
    """A training forward copies a tensor into a padded one only where
    XLA's SAME pads asymmetrically: the four stride-2 pools and, in the
    BN variant, the 7x7/2 stem. The 1x1 convolutions' SAME pads of zero
    and every symmetric pad cost no copy."""
    calls = []
    pad = torch.nn.functional.pad

    def counting_pad(x, widths, *args, **kw):
        calls.append(tuple(widths))
        return pad(x, widths, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "pad", counting_pad)
    module = get_model(name, num_classes=CLASSES, input_size=SIZE)
    module.lrn = lambda x, *args: x  # the plain LRN pads its channels
    module(torch.from_numpy(_images(2)), train=True,
           generator=torch.Generator().manual_seed(0))
    assert len(calls) == pads and all(any(w) for w in calls), calls


# ------------------------------------------------- init, trap C6


def test_he_normal_variance_matches_flax():
    """ConvBN kernels are flax's he_normal (variance 2/fan_out, cut at
    two standard deviations); the BasicConvs and Dense layers keep
    lecun_normal. Statistics only, never sampled streams: each against
    the flax initializer the JAX layer names, drawn at the same shape."""
    module = create_model("inception1", device=CPU, seed=0,
                          num_classes=CLASSES, input_size=SIZE)
    key = jax.random.PRNGKey(0)
    w = module.i4e.b3.conv.weight.detach()  # 320 x 160 x 3 x 3
    kernel = np.asarray(jax_layers.he_normal(key, (3, 3, 160, 320)))
    want = np.sqrt(2.0 / (320 * 9))
    assert abs(w.std().item() / want - 1) < 0.03
    assert abs(w.std().item() / kernel.std() - 1) < 0.03
    assert w.abs().max().item() <= 2 * want / 0.87962566103423978 * (
        1 + 1e-6)
    assert abs(w.abs().max().item() / np.abs(kernel).max() - 1) < 0.01
    fc1 = module.aux1.fc1.weight.detach()  # lecun_normal, fan_in 128
    lecun = np.asarray(flax_nn.initializers.lecun_normal()(key,
                                                           (128, 1024)))
    assert abs(fc1.std().item() * np.sqrt(128) - 1) < 0.03
    assert abs(fc1.std().item() / lecun.std() - 1) < 0.03
    bn = module.i4e.b3.bn
    assert torch.equal(bn.scale, torch.ones(320))
    assert not bn.bias.any() and not bn.mean.any()
    assert torch.equal(bn.var, torch.ones(320))
    ref = create_model("inception1_ref", device=CPU, seed=0,
                       num_classes=CLASSES, input_size=SIZE)
    w = ref.i4e.b3.conv.weight.detach()  # lecun_normal, fan_in 160*9
    assert abs(w.std().item() * np.sqrt(160 * 9) - 1) < 0.03
    assert not ref.i4e.b3.conv.bias.any()


# ------------------------------------------ converter, checkpoints


def test_converter_carries_batch_stats_through_a_checkpoint(tmp_path):
    """flax params and batch_stats -> the port's module -> a verified
    port checkpoint -> the served weights, bit for bit; a tree without
    its batch_stats, or with a stray one, is refused."""
    _, variables = flax_variables("inception1")
    kw = {"num_classes": CLASSES, "input_size": SIZE}
    module = create_model("inception1", device=CPU, **kw)
    module.load_state_dict(flax_to_torch("inception1", variables, **kw))
    assert torch.equal(
        module.i3a.b1.bn.mean,
        torch.from_numpy(variables["batch_stats"]["i3a"]["b1"]["bn"]["mean"]))
    cfg = {**get_config("inception1"), **kw}
    opt, _ = make_optimizer(cfg, module.parameters(), steps_per_epoch=4)
    CheckpointManager(tmp_path / "inception1" / "ckpt").save(
        0, TrainState(module, opt), config=cfg)
    served = load_served("inception1", str(tmp_path / "inception1"),
                         device="cpu")
    for name, tensor in module.state_dict().items():
        assert torch.equal(served.module.state_dict()[name], tensor), name

    no_stats = {"params": variables["params"]}
    with pytest.raises(ValueError, match="lack batch_stats/stem1/bn/mean"):
        flax_to_torch("inception1", no_stats, **kw)
    _, ref = flax_variables("inception1_ref")
    ref["batch_stats"] = {"stem1": {"bn": {"mean": np.zeros(64, np.float32)}}}
    with pytest.raises(ValueError, match="does not use.*stem1/bn/mean"):
        flax_to_torch("inception1_ref", ref, **kw)


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("name", VARIANTS)
def test_load_served_matches_jax_load_served(name, monkeypatch):
    """CPU serving of each variant on carried variables against the JAX
    ``load_served`` serving the same ones (its train state built on
    them, in place of a fresh init): the same classes, probabilities
    within 1e-5; eval drops the aux heads on both sides."""
    _, variables = flax_variables(name, seed=5)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def carried_state(model, tx, sample, **kw):
        return JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(
                jnp.asarray, variables.get("batch_stats", {})),
            opt_state=tx.init(params), apply_fn=model.apply, tx=tx)

    monkeypatch.setattr(jax_state, "create_train_state", carried_state)
    theirs = jax_load_served(name, input_size=SIZE, num_classes=CLASSES)
    ours = load_served(name, variables=variables, device="cpu",
                       input_size=SIZE, num_classes=CLASSES)
    x = _images(3, seed=4)
    want, got = theirs.run(x), ours.run(x)
    np.testing.assert_array_equal(got["classes"], np.asarray(want["classes"]))
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
