"""The port's VGG-16/19, MobileNet V1, ShuffleNet V1 and Inception V3
against the JAX package's, on the CPU.

The same seeded numpy input runs through each flax model and its port
on weights carried by ``convert.from_flax``; the flax trees come from
the flax models' own ``init`` shapes with values drawn by numpy
(``tests.test_torch_inception._draw``: nonzero biases, BN statistics
away from 0 and 1). float32 to 1e-4 on logits (atol and rtol) and 1e-5
on BN statistics, as the Inception V1 tests hold theirs.

Sizes: VGG at 32 px; MobileNet and ShuffleNet at 64 and 57, where XLA's
SAME pads of a stride-2 layer differ ((0, 1) at an even size, (1, 1) at
an odd one); Inception V3 at 299, the least size at which its aux head
has a 17x17 grid to read, and at 107 without the aux head (whose own
test runs on a (2, 17, 17, 768) input).
"""

import io
import json
import shutil

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.models import layers as jax_layers
from deepvision_tpu.models import mobilenet as jax_mobilenet
from deepvision_tpu.models import shufflenet as jax_shufflenet
from deepvision_tpu.serve.models import load_served as jax_load_served
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train import state as jax_state
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.state import TrainState as JaxTrainState
from deepvision_tpu.train.steps import (
    classification_train_step as jax_train_step,
)
from deepvision_tpu_torch.convert.from_flax import (
    flax_param_tree_to_torch,
    flax_to_torch,
    flax_train_state_to_torch,
    load_flax_train_state,
    rmsprop_parts,
)
from deepvision_tpu_torch.core.prng import KeySeq
from deepvision_tpu_torch.models import create_model, get_model, layers
from deepvision_tpu_torch.models import mobilenet, shufflenet
from deepvision_tpu_torch.serve import load_served
from deepvision_tpu_torch.serve.__main__ import main as serve_main
from deepvision_tpu_torch.train.__main__ import main as train_main
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import (
    ScheduledRMSprop,
    ScheduledSGD,
    make_optimizer,
)
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import classification_train_step
from tests.test_torch_inception import _draw
from tests.test_torch_train import _find, _flax_dropout_off, _leaf_gap
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
CLASSES = 10
MODELS = ("vgg16", "vgg19", "mobilenet1", "shufflenet1", "inception3")
# the eval-logit cases: (model, size, batch, flax model keywords)
EVAL_CASES = [
    ("vgg16", 32, 2, {}), ("vgg19", 32, 2, {}),
    ("mobilenet1", 64, 2, {}), ("mobilenet1", 57, 2, {}),
    ("shufflenet1", 64, 2, {}), ("shufflenet1", 57, 2, {}),
    ("inception3", 299, 1, {}),
]
INC3_SMALL = 107  # 107 -> 53 -> 51 -> 25 -> 23 -> 11 -> 5 -> 2
STEPS_PER_EPOCH = 2
STEP_LR_SCALE = 0.01  # the f32 step comparisons' LR, times the config's


def flax_variables(name, size, classes=CLASSES, seed=0, gain=2.0, **kw):
    """The flax model and numpy variables of its tree, from a
    training-mode init (aux heads included where the size has them)."""
    model = flax_get_model(name, num_classes=classes, **kw)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda x: model.init({"params": key, "dropout": key}, x, train=True),
        jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng, gain), shapes)


def port_module(name, variables, size, classes=CLASSES, **kw):
    kw = {"num_classes": classes, "input_size": size, **kw}
    module = get_model(name, **kw)
    module.load_state_dict(flax_to_torch(name, variables, **kw))
    return module.to(memory_format=torch.channels_last)


def _images(n, size, seed=1):
    return (np.random.default_rng(seed).normal(0, 1, (n, size, size, 3))
            .astype(np.float32))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = np.asarray(v)
    return out


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("name,size,batch,kw", EVAL_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in EVAL_CASES])
def test_eval_logits_match_flax(name, size, batch, kw):
    model, variables = flax_variables(name, size, **kw)
    x = _images(batch, size)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    module = port_module(name, variables, size)
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,size", [
    ("vgg16", 32), ("mobilenet1", 64), ("shufflenet1", 57),
    ("inception3", INC3_SMALL)])
def test_train_mode_forward_and_bn_statistics_match_flax(name, size):
    """Training mode with dropout off on both sides (trap C6: the two
    random streams never agree): the logits to 1e-4, and every BN
    statistic the forward writes to 1e-5 of flax's ``batch_stats``.
    Inception V3 runs without its aux head at this size."""
    kw = {"aux_heads": False} if name == "inception3" else {}
    with _flax_dropout_off():
        model, variables = flax_variables(name, size, **kw)
        x = _images(4, size, seed=3)
        want, updates = model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    module = port_module(name, variables, size, **kw)
    if hasattr(module, "dropout_rate"):
        module.dropout_rate = 0.0
    got = module(torch.from_numpy(x), train=True,
                 generator=torch.Generator()).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    stats = updates.get("batch_stats", {})
    assert bool(stats) == (name != "vgg16")
    if stats:
        new = flax_to_torch(name, {**variables, "batch_stats": stats},
                            num_classes=CLASSES, input_size=size)
        buffers = dict(module.named_buffers())
        for k, v in buffers.items():
            np.testing.assert_allclose(v.numpy(), new[k].numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)


class _FlaxAux(flax_nn.Module):
    """The JAX Inception V3's aux head (``inception.py:289-295``) on the
    17x17 grid."""

    @flax_nn.compact
    def __call__(self, x, train=False):
        a = jax_layers.avg_pool(x, (5, 5), (3, 3))
        a = jax_layers.ConvBN(128, (1, 1), name="aux_proj")(a, train)
        a = jax_layers.ConvBN(768, (5, 5), padding="VALID",
                              name="aux_conv")(a, train)
        return flax_nn.Dense(CLASSES, name="aux_fc")(
            a.reshape((a.shape[0], -1)))


def test_inception3_aux_head_matches_flax_on_the_17x17_grid():
    """The aux head alone on a (2, 17, 17, 768) input, in training (its
    BN on the batch) and in evaluation: logits to 1e-4, BN statistics to
    1e-5. At 299 the main path returns ``(main, aux)`` in training and
    ``main`` otherwise; below 299 the module builds no aux head and
    refuses to train one."""
    aux = _FlaxAux()
    x = np.random.default_rng(4).normal(0, 1, (2, 17, 17, 768)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda v: aux.init(jax.random.PRNGKey(0), v),
                            jnp.asarray(x))
    rng = np.random.default_rng(6)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng), shapes)
    module = create_model("inception3", device=CPU, num_classes=CLASSES)
    carried = {}
    for path, value in _flat(variables["params"]).items():
        carried[".".join(path).replace("kernel", "weight")] = (
            torch.from_numpy(value.transpose(3, 2, 0, 1) if value.ndim == 4
                             else value.T if value.ndim == 2 else value))
    for path, value in _flat(variables["batch_stats"]).items():
        carried[".".join(path)] = torch.from_numpy(value)
    assert not module.load_state_dict(carried, strict=False).unexpected_keys
    xt = torch.from_numpy(x)
    for train in (False, True):  # evaluation first: training moves BN
        want, upd = aux.apply(variables, jnp.asarray(x), train=train,
                              mutable=["batch_stats"])
        got = module.aux_head(xt, train).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    for path, value in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(
            module.get_buffer(".".join(path)).numpy(), value, atol=1e-5)
    x299 = torch.from_numpy(_images(1, 299))
    module.dropout_rate = 0.0
    with torch.no_grad():
        out = module(x299, train=True, generator=torch.Generator())
        assert isinstance(out, tuple) and len(out) == 2
        assert all(o.shape == (1, CLASSES) for o in out)
        assert module.eval()(x299).shape == (1, CLASSES)
    small = get_model("inception3", num_classes=CLASSES,
                      input_size=INC3_SMALL)
    assert not hasattr(small, "aux_fc")
    with pytest.raises(ValueError, match="at least 299"):
        small(torch.zeros(1, INC3_SMALL, INC3_SMALL, 3), train=True,
              generator=torch.Generator())


@pytest.mark.parametrize("name", MODELS)
def test_parameter_counts_equal_jax(name):
    """Each model built on the ``meta`` device (no storage allocated) at
    its config's geometry counts the parameters of its JAX twin's tree
    (``jax.eval_shape`` of a training-mode init: aux heads included);
    ``mobilenet1`` has 4,231,976."""
    size = get_config(name)["input_size"]
    with torch.device("meta"):
        module = get_model(name, input_size=size)
    assert all(p.is_meta for p in module.parameters())
    ours = sum(p.numel() for p in module.parameters())
    model = flax_get_model(name)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda x: model.init({"params": key, "dropout": key}, x, train=True),
        jnp.zeros((1, size, size, 3), jnp.float32))
    theirs = sum(int(np.prod(a.shape))
                 for a in jax.tree.leaves(shapes["params"]))
    assert ours == theirs
    buffers = sum(b.numel() for b in module.buffers())
    assert buffers == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        shapes.get("batch_stats", {})))
    if name == "mobilenet1":
        assert ours == 4_231_976


# --------------------------------------------- pads, trap C2, shuffle


def _apply_piece(flax_module, port, x, **kw):
    """A flax piece on numpy ``x`` and its port on the same carried
    weights, in evaluation mode."""
    shapes = jax.eval_shape(lambda v: flax_module.init(
        jax.random.PRNGKey(0), v, **kw), jnp.asarray(x))
    rng = np.random.default_rng(8)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng), shapes)
    want = np.asarray(flax_module.apply(variables, jnp.asarray(x), **kw))
    state = {}
    for path, value in _flat(variables.get("params", {})).items():
        state[".".join(path).replace("kernel", "weight")] = torch.from_numpy(
            value.transpose(3, 2, 0, 1) if value.ndim == 4 else value)
    for path, value in _flat(variables.get("batch_stats", {})).items():
        state[".".join(path)] = torch.from_numpy(value)
    port.load_state_dict(state)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    return got, want


class _Wrap(flax_nn.Module):
    """A flax piece named as its port's attribute."""

    piece: flax_nn.Module

    @flax_nn.compact
    def __call__(self, x):
        return self.piece(x)


class _PortWrap(torch.nn.Module):
    def __init__(self, **pieces):
        super().__init__()
        for k, v in pieces.items():
            self.add_module(k, v)

    def forward(self, x):
        return next(iter(self.children()))(x)


@pytest.mark.parametrize("size", [64, 57])
@pytest.mark.parametrize("site", ["stem", "max_pool", "unit", "avg_pool"])
def test_shufflenet_same_sites_match_flax(site, size):
    """ShuffleNet's four stride-2 SAME sites (trap C2) at an even and an
    odd size, each against flax: the stem ConvBN (3x3/2), the 3x3/2 max
    pool (-inf pads), a first unit (its depthwise 3x3/2 and its shortcut,
    ``[shortcut, y]`` then ReLU) and the shortcut's 3x3/2 average pool,
    whose zero pads count in every window's divisor of 9."""
    rng = np.random.default_rng(size)
    cin = 3 if site == "stem" else 24
    x = rng.normal(0, 1, (2, size, size, cin)).astype(np.float32)
    if site in ("max_pool", "avg_pool"):
        pool = {"max_pool": (jax_layers.max_pool, layers.max_pool),
                "avg_pool": (jax_layers.avg_pool, layers.avg_pool)}[site]
        want = np.asarray(pool[0](jnp.asarray(x), (3, 3), (2, 2), "SAME"))
        got = shufflenet._same_pool(pool[1], torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, -(-size // 2),
                                           -(-size // 2), cin)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        if site == "avg_pool":  # the last row's windows count a zero row
            ones = np.ones((1, 4, 4, 1), np.float32)
            np.testing.assert_allclose(
                shufflenet._same_pool(layers.avg_pool,
                                      torch.from_numpy(ones))[0, ..., 0],
                [[1.0, 2 / 3], [2 / 3, 4 / 9]], rtol=1e-6)
        return
    if site == "stem":
        flax_piece = _Wrap(jax_layers.ConvBN(24, (3, 3), (2, 2)),
                           name=None)
        port = _PortWrap(piece=layers.ConvBN(3, 24, (3, 3), (2, 2)))
    else:
        flax_piece = _Wrap(jax_shufflenet.ShuffleUnit(
            240, strides=2, first_group=False))
        port = _PortWrap(piece=shufflenet.ShuffleUnit(24, 240, strides=2,
                                                      first_group=False))
    got, want = _apply_piece(flax_piece, port, x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [64, 57])
def test_mobilenet_explicit_pads_match_flax_and_same_does_not(size):
    """MobileNet's 3x3/2 layers pad (1, 1) explicitly, as the JAX model
    does: the stem ConvBN and a stride-2 depthwise-separable block equal
    flax's at an even and an odd size. The same weights under XLA's
    ``"SAME"`` pad the stem (0, 1) at 64 and miss the flax stem there; at
    57 SAME's pads are (1, 1) too, and the two agree."""
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (2, size, size, 3)).astype(np.float32)
    pad1 = ((1, 1), (1, 1))
    got, want = _apply_piece(
        _Wrap(jax_layers.ConvBN(32, (3, 3), (2, 2), padding=pad1)),
        _PortWrap(piece=layers.ConvBN(3, 32, (3, 3), (2, 2), mobilenet._PAD1)),
        x)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    same = _PortWrap(piece=layers.ConvBN(3, 32, (3, 3), (2, 2), "SAME"))
    wrong, _ = _apply_piece(
        _Wrap(jax_layers.ConvBN(32, (3, 3), (2, 2), padding=pad1)), same, x)
    if size % 2:
        np.testing.assert_allclose(wrong, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(wrong - want).max() > 0.1
    x32 = rng.normal(0, 1, (2, size, size, 32)).astype(np.float32)
    got, want = _apply_piece(
        _Wrap(jax_mobilenet.DepthwiseSeparableConv(64, strides=2)),
        _PortWrap(piece=mobilenet.DepthwiseSeparableConv(32, 64, 2)), x32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_channel_shuffle_matches_jax():
    x = np.arange(2 * 3 * 2 * 12, dtype=np.float32).reshape(2, 3, 2, 12)
    for g in (3, 4):
        np.testing.assert_array_equal(
            shufflenet.channel_shuffle(torch.from_numpy(x), g).numpy(),
            np.asarray(jax_shufflenet.channel_shuffle(jnp.asarray(x), g)))


# ------------------------------------------------------- initializers


@pytest.mark.parametrize("init,shape", [
    ("he", (512, 1, 3, 3)),        # MobileNet's depthwise 3x3 on 512
    ("he", (240, 40, 1, 1)),       # ShuffleNet's grouped 1x1, g=3
    ("xavier", (512, 1, 3, 3)),
    ("xavier", (240, 40, 1, 1)),
    ("xavier", (256, 128, 3, 3)),  # a VGG conv
    ("normal", (1000, 1024)),      # VGG's Dense layers, N(0, 0.01)
])
def test_initializers_match_flax_variance(init, shape):
    """Each port initializer on a torch-layout kernel against flax's on
    the flax layout (``(KH, KW, I/g, O)`` or ``(in, out)``): standard
    deviations within 3% (about three times the sampling error of 4,608
    values or more), and a uniform draw inside flax's limit."""
    port = {"he": layers.he_normal_, "xavier": layers.xavier_uniform_,
            "normal": layers.normal_(0.01)}[init]
    flax_init = {"he": jax_layers.he_normal,
                 "xavier": jax_layers.xavier_uniform,
                 "normal": flax_nn.initializers.normal(0.01)}[init]
    w = torch.empty(shape)
    port(w, torch.Generator().manual_seed(0))
    flax_shape = (*shape[2:], shape[1], shape[0]) if len(shape) == 4 \
        else shape[::-1]
    theirs = np.asarray(flax_init(jax.random.PRNGKey(0), flax_shape))
    assert abs(w.std().item() / theirs.std() - 1) < 0.03
    assert abs(w.mean().item()) < 3 * theirs.std() / np.sqrt(w.numel())
    if init == "xavier":
        receptive = int(np.prod(flax_shape[:-2]))
        fan_avg = receptive * (flax_shape[-2] + flax_shape[-1]) / 2
        limit = np.sqrt(3 / fan_avg)
        assert w.abs().max().item() <= limit
        assert np.abs(theirs).max() <= limit * (1 + 1e-6)


def test_fresh_vgg_init_is_xavier_convs_and_normal_dense():
    module = create_model("vgg16", device=CPU, num_classes=CLASSES,
                          input_size=32)
    conv = module.conv3_1.weight
    fan_avg = 9 * (128 + 256) / 2
    assert conv.abs().max().item() <= np.sqrt(3 / fan_avg)
    assert abs(conv.std().item() / np.sqrt(1 / fan_avg) - 1) < 0.03
    for fc in (module.fc1, module.fc2):
        assert abs(fc.weight.std().item() / 0.01 - 1) < 0.03
        assert not fc.bias.any()
    assert not module.conv1_1.bias.any()


# -------------------------------------------- f32 steps against JAX


def _jax_step():
    return jax.jit(lambda s, b, k: jax_train_step(s, b, k,
                                                  normalize_kind="torch"))


def _batch(seed, n, size):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0, 1, (n, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, n).astype(np.int32)}


def _opt_leaves(name, opt_state, size):
    """The optimizer state a parameter, in the port's layout: RMSprop's
    ``nu`` or SGD's momentum trace."""
    host = jax.tree.map(np.asarray, opt_state)
    tree = (rmsprop_parts(host)[0] if name == "mobilenet1"
            else _find(host, optax.TraceState).trace)
    return flax_param_tree_to_torch(name, tree, num_classes=CLASSES,
                                    input_size=size)


@pytest.mark.parametrize("name,size,n", [("mobilenet1", 64, 8),
                                         ("shufflenet1", 64, 8)])
def test_f32_train_steps_match_jax(name, size, n):
    """Three f32 steps from a carried JAX state one step into training
    (``mobilenet1``: RMSprop and its step schedule over 2-step epochs;
    ``shufflenet1``: SGD with momentum and L2), 8 images at 64 px, where
    the last stage's BN normalizes 32 values a channel. Both sides take
    the config's optimizer at 0.01 times its LR, as the ResNet step test
    does at lr 0.1: at the full LR a step moves drawn weights so far
    (``mobilenet1``'s first moves the loss from 2.5 to 4.6) that the
    float32 noise below compounds into the whole update within three
    steps, and no comparison could see a fault.

    As in the Inception V1 test, float32 flips a few ReLUs whose inputs
    lie within rounding of 0, every gradient below a flip moves, and
    three steps compound that. Two more runs on each side, on every batch
    reversed and rolled by 3, measure that noise: each leaf's floor is
    the largest gap between a side's run and its reordered runs, on
    either side (as ``chip_smoke.py`` holds the card to the CPU). Every
    parameter and BN statistic is held within 1e-5 plus three times its
    floor, each optimizer-state leaf (``nu``, the momentum) within 1e-4
    of its largest magnitude plus three times its floor, the loss at each
    step within 1e-4 plus four times the step's floor, and the update
    count exactly. The state before the steps fails that on most
    parameters and BN statistics."""
    cfg = jax_get_config(name)
    cfg["optimizer_params"]["lr"] *= STEP_LR_SCALE
    ours = {**get_config(name), "optimizer_params": cfg["optimizer_params"]}
    tx, _ = jax_optimizers.make_optimizer(cfg, STEPS_PER_EPOCH)
    model, variables = flax_variables(name, size, seed=2, gain=1.0)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx,
        loss_scale=None)
    jstep = _jax_step()
    jstate, _ = jstep(jstate, _batch(100, n, size), jax.random.key(0))
    host = jax.tree.map(np.asarray, jstate)
    count = int(_find(host.opt_state, optax.ScaleByScheduleState).count)
    slot = ({"nu": rmsprop_parts(host.opt_state)[0]} if name == "mobilenet1"
            else {"trace": _find(host.opt_state, optax.TraceState).trace})
    carried = flax_train_state_to_torch(
        name, params=host.params, batch_stats=host.batch_stats,
        step=int(host.step), count=count, num_classes=CLASSES,
        input_size=size, **slot)
    key = "nu" if name == "mobilenet1" else "momentum_buffer"
    batches = [_batch(i, n, size) for i in range(3)]
    orders = (lambda a: a, lambda a: a[::-1].copy(),
              lambda a: np.roll(a, 3, axis=0))

    def port_leaves(module, opt):
        return {**{k: v.clone() for k, v in module.state_dict().items()},
                **{f"opt:{k}": opt.state[p][key].clone()
                   for k, p in module.named_parameters()}}

    def port_run(order):
        module = create_model(name, device=CPU, num_classes=CLASSES,
                              input_size=size)
        opt, _ = make_optimizer(ours, module.parameters(), STEPS_PER_EPOCH)
        assert isinstance(opt, ScheduledRMSprop if name == "mobilenet1"
                          else ScheduledSGD)
        state = TrainState(module, opt)
        load_flax_train_state(state, carried)
        start = port_leaves(module, opt)
        gen = KeySeq(1, 0)
        losses = [float(classification_train_step(
            state, {k: torch.from_numpy(order(v)) for k, v in b.items()},
            next(gen), normalize_kind="torch")["loss"]) for b in batches]
        assert state.step == 4 and float(opt.count) == 4
        return losses, port_leaves(module, opt), start

    def jax_run(order):
        s, losses = jstate, []
        for i, b in enumerate(batches):
            s, m = jstep(s, {k: order(v) for k, v in b.items()},
                         jax.random.key(i))
            losses.append(float(m["loss"]))
        assert int(_find(s.opt_state, optax.ScaleByScheduleState).count) == 4
        h = jax.tree.map(np.asarray, s)
        leaves = flax_to_torch(
            name, {"params": h.params, "batch_stats": h.batch_stats},
            num_classes=CLASSES, input_size=size)
        opt_leaves = _opt_leaves(name, s.opt_state, size)
        return losses, {**leaves,
                        **{f"opt:{k}": v for k, v in opt_leaves.items()}}

    port = [port_run(o) for o in orders]
    jax_runs = [jax_run(o) for o in orders]
    (got_losses, got, start), (want_losses, want) = port[0], jax_runs[0]
    for i in range(3):
        floor = max(abs(r[0][i] - runs[0][0][i]) for runs in (port, jax_runs)
                    for r in runs[1:])
        assert abs(got_losses[i] - want_losses[i]) <= (
            1e-4 * abs(want_losses[i]) + 4 * floor), (i, floor)
    tol = {}
    for k, w in want.items():
        floor = max(_leaf_gap(r[1][k], runs[0][1][k])
                    for runs in (port, jax_runs) for r in runs[1:])
        base = 1e-4 * float(w.abs().max()) if k.startswith("opt:") else 1e-5
        tol[k] = base + 3 * floor
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=tol[k], err_msg=k)
    model_keys = [k for k in want if not k.startswith("opt:")]
    beyond = [k for k in model_keys
              if _leaf_gap(start[k], want[k]) > tol[k]]
    assert len(beyond) > len(model_keys) // 2, (len(beyond), len(model_keys))


# ------------------------------------------ converter, checkpoints


def test_converter_carries_grouped_kernels_and_nu_through_a_checkpoint(
        tmp_path):
    """flax variables of ``mobilenet1`` (depthwise kernels ``(3, 3, 1,
    C)``) and ``shufflenet1`` (grouped 1x1 ``(1, 1, I/3, O)``) carried to
    the port's ``(O, I/g, KH, KW)``; ``mobilenet1``'s RMSprop ``nu`` and
    update count carried from an optax state into the train state, then
    through a verified checkpoint and back into a fresh state, bit for
    bit; the served weights equal the module's."""
    _, sv = flax_variables("shufflenet1", 64)
    kw = {"num_classes": CLASSES, "input_size": 64}
    got = flax_to_torch("shufflenet1", sv, **kw)
    flax_k = sv["params"]["stage3_unit2"]["gconv2"]["conv"]["kernel"]
    assert flax_k.shape == (1, 1, 40, 480)
    np.testing.assert_array_equal(
        got["stage3_unit2.gconv2.conv.weight"].numpy(),
        flax_k.transpose(3, 2, 0, 1))

    _, variables = flax_variables("mobilenet1", 64)
    dw = variables["params"]["ds2"]["dw"]["conv"]["kernel"]
    assert dw.shape == (3, 3, 1, 64)
    tx, _ = jax_optimizers.make_optimizer(jax_get_config("mobilenet1"),
                                          STEPS_PER_EPOCH)
    opt_state = tx.init(variables["params"])
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32),
        variables["params"])
    for _ in range(3):
        _, opt_state = tx.update(grads, opt_state, variables["params"])
    nu, count = rmsprop_parts(jax.tree.map(np.asarray, opt_state))
    assert count == 3
    carried = flax_train_state_to_torch(
        "mobilenet1", params=variables["params"],
        batch_stats=variables["batch_stats"], nu=nu, step=3, count=count,
        **kw)
    module = create_model("mobilenet1", device=CPU, **kw)
    cfg = {**get_config("mobilenet1"), **kw}
    opt, _ = make_optimizer(cfg, module.parameters(), STEPS_PER_EPOCH)
    state = TrainState(module, opt)
    load_flax_train_state(state, carried)
    np.testing.assert_array_equal(module.ds2.dw.conv.weight.detach().numpy(),
                                  dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        opt.state[module.ds2.dw.conv.weight]["nu"].numpy(),
        np.asarray(nu["ds2"]["dw"]["conv"]["kernel"]).transpose(3, 2, 0, 1))
    ckpt = CheckpointManager(tmp_path / "mobilenet1" / "ckpt")
    ckpt.save(0, state, config=cfg)
    fresh = create_model("mobilenet1", device=CPU, seed=1, **kw)
    fresh_opt, _ = make_optimizer(cfg, fresh.parameters(), STEPS_PER_EPOCH)
    ckpt.restore(TrainState(fresh, fresh_opt), 0)
    assert float(fresh_opt.count) == 3.0
    for (name, p), q in zip(module.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(opt.state[p]["nu"], fresh_opt.state[q]["nu"])
    served = load_served("mobilenet1", str(tmp_path / "mobilenet1"),
                         device="cpu")
    for name, tensor in module.state_dict().items():
        assert torch.equal(served.module.state_dict()[name], tensor), name
    with pytest.raises(ValueError, match="one of trace"):
        flax_train_state_to_torch("mobilenet1", params=variables["params"],
                                  step=0, **kw)


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("name,size,scale", [
    ("vgg16", 32, "torch"), ("vgg19", 32, "torch"),
    ("mobilenet1", 64, "torch"), ("shufflenet1", 57, "torch"),
    ("inception3", INC3_SMALL, "imagenet")])
def test_load_served_matches_jax_load_served(name, size, scale,
                                             monkeypatch):
    """CPU serving of each model on carried variables against the JAX
    ``load_served`` serving the same ones (its train state built on
    them, in place of a fresh init): the same top-5 classes,
    probabilities within 1e-5, and the same input scale (``"torch"`` for
    the four ``augment: "pt"`` configs, ``"imagenet"`` for
    ``inception3``). Inception V3 below 299 px has no aux head on either
    side."""
    kw = {"aux_heads": False} if name == "inception3" else {}
    _, variables = flax_variables(name, size, seed=5, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def carried_state(model, tx, sample, **kw):
        return JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(
                jnp.asarray, variables.get("batch_stats", {})),
            opt_state=tx.init(params), apply_fn=model.apply, tx=tx)

    monkeypatch.setattr(jax_state, "create_train_state", carried_state)
    theirs = jax_load_served(name, input_size=size, num_classes=CLASSES,
                             **kw)
    ours = load_served(name, variables=variables, device="cpu",
                       input_size=size, num_classes=CLASSES)
    assert ours.scale == theirs.scale == scale
    assert ours.input_shape == (size, size, 3)
    x = _images(3, size, seed=4)
    want, got = theirs.run(x), ours.run(x)
    np.testing.assert_array_equal(got["classes"], np.asarray(want["classes"]))
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)


# ---------------------------------------------------------------- CLI


def test_cli_trains_mobilenet1_resumes_and_serves(tmp_path, capsys):
    """``python -m deepvision_tpu_torch.train -m mobilenet1 --device
    cpu`` (RMSprop and the step schedule, 32 px, batch 4): one epoch,
    then the second on ``--resume`` with the update count carried; the
    serving CLI answers like ``load_served`` from the newest checkpoint.
    Without ``--device cpu`` and without a card it raises. The workdir
    is deleted at the end."""
    common = ["-m", "mobilenet1", "--device", "cpu", "--input-size", "32",
              "--num-classes", "5", "--batch-size", "4",
              "--synthetic-size", "16", "--steps-per-epoch", "2",
              "--workdir", str(tmp_path)]
    try:
        assert train_main([*common, "--epochs", "1"]) == 0
        out = capsys.readouterr()
        assert "[epoch 0]" in out.out and "precision bf16" in out.out
        assert train_main([*common, "--epochs", "2", "--resume"]) == 0
        out = capsys.readouterr()
        assert "resumed at epoch 1" in out.out and "[epoch 1]" in out.out
        assert "checkpoints [0, 1]" in out.err
        workdir = str(tmp_path / "mobilenet1")
        module = create_model("mobilenet1", device=CPU, num_classes=5,
                              input_size=32, dtype=torch.bfloat16)
        opt, _ = make_optimizer(get_config("mobilenet1"),
                                module.parameters(), 2)
        CheckpointManager(tmp_path / "mobilenet1" / "ckpt").restore(
            TrainState(module, opt), 1)
        assert float(opt.count) == 4.0  # two epochs of two updates
        assert all(opt.state[p]["nu"].any() for p in module.parameters())

        x = _images(2, 32, seed=6)
        lines = "".join(json.dumps({"id": i, "input": x[i].tolist()}) + "\n"
                        for i in range(2))
        stdout = io.StringIO()
        serve_main(["-m", f"mobilenet1={workdir}", "--device", "cpu",
                    "--buckets", "2"], stdin=io.StringIO(lines),
                   stdout=stdout)
        replies = [json.loads(s) for s in stdout.getvalue().splitlines()]
        served = load_served("mobilenet1", workdir, device="cpu")
        assert served.input_shape == (32, 32, 3) and served.scale == "torch"
        host = served.run(x)
        assert [r["id"] for r in replies] == [0, 1]
        for r in replies:
            want = served.postprocess(host, r["id"])
            assert r["result"]["classes"] == want["classes"]
            np.testing.assert_allclose(r["result"]["probs"], want["probs"],
                                       atol=1e-6)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="none is available"):
                train_main([a for a in common if a not in ("--device",
                                                           "cpu")])
    finally:
        shutil.rmtree(tmp_path / "mobilenet1", ignore_errors=True)
