"""The port's ResNets against the JAX package's, on the CPU.

``resnet34``, ``resnet50`` (also under the training config's
``s2d_stem``, the JAX space-to-depth stem) and ``resnet50v2`` run the
same seeded numpy input on weights carried from flax by
``convert.from_flax``. The flax trees come from each flax model's own
``init`` shapes with values drawn by numpy (``test_torch_inception``'s
draw: BN statistics away from 0 and 1, zero-mean conv filters), so that
every leaf is carried and checked. float32 to 1e-4 on logits and 1e-5
on BN statistics; bf16 to one bf16 step (2^-7 relative) where both
sides round the same float32 value once. The train steps start from a
carried mid-training JAX state and hold each leaf to 1e-5 plus three
times its float32 floor (``test_torch_train``'s method).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.models import layers as jax_layers
from deepvision_tpu.models import resnet as jax_resnet
from deepvision_tpu.serve.models import load_served as jax_load_served
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train import state as jax_state
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.state import TrainState as JaxTrainState
from deepvision_tpu.train.steps import (
    classification_train_step as jax_train_step,
)
from deepvision_tpu_torch.convert.from_flax import (
    flax_to_torch,
    flax_train_state_to_torch,
    load_flax_train_state,
)
from deepvision_tpu_torch.core.prng import KeySeq
from deepvision_tpu_torch.models import create_model, get_model, layers
from deepvision_tpu_torch.models import resnet
from deepvision_tpu_torch.serve import load_served
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import classification_train_step
from tests.test_torch_inception import _draw
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)
from tests.test_torch_train import (
    CLS_LOSS_RTOL,
    _find_trace,
    _hold_leaves,
    _leaf_gap,
    _steps_against_jax,
    _torch_batch,
)

CPU = torch.device("cpu")
SIZE, CLASSES = 64, 10
NAMES = ("resnet34", "resnet50", "resnet50v2")
BF16_STEP = 2 ** -7  # one bf16 step, relative
S2D = {"s2d_stem": True}


def flax_variables(name, size=SIZE, seed=0, gain=2.0, **model_kw):
    """The flax model and numpy variables of its tree."""
    model = flax_get_model(name, num_classes=CLASSES, **model_kw)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=True), jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 3), jnp.float32))
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng, gain), shapes)


def port_module(name, variables, size=SIZE, dtype=torch.float32,
                **model_kw):
    kw = {"num_classes": CLASSES, "input_size": size}
    module = get_model(name, dtype=dtype, **model_kw, **kw)
    module.load_state_dict(flax_to_torch(name, variables, **kw))
    return module.to(memory_format=torch.channels_last)


def _images(n, size=SIZE, seed=1):
    return (np.random.default_rng(seed).normal(0, 1, (n, size, size, 3))
            .astype(np.float32))


def _bn_state(variables, path=("bn",)):
    """One BN's flax leaves as the port's state dict."""
    p, s = variables["params"], variables["batch_stats"]
    for key in path:
        p, s = p[key], s[key]
    return {k: torch.from_numpy(np.asarray(v))
            for k, v in (("scale", p["scale"]), ("bias", p["bias"]),
                         ("mean", s["mean"]), ("var", s["var"]))}


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("name,size,batch,jax_kw", [
    ("resnet34", SIZE, 2, {}),
    ("resnet50", SIZE, 2, {}),
    ("resnet50v2", SIZE, 2, {}),
    ("resnet50", 224, 1, {}),
    ("resnet50", SIZE, 2, S2D),
])
def test_eval_logits_match_flax(name, size, batch, jax_kw):
    """float32 eval logits; the last case runs the JAX space-to-depth
    stem against the port's plain stem on the same kernel."""
    model, variables = flax_variables(name, size, **jax_kw)
    x = _images(batch, size)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    module = port_module(name, variables, size)
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_geometry_and_parameter_count():
    """resnet50: 25,557,032 parameters and 53,120 BN statistics in 106
    tensors; every model's counts are its flax tree's, with and without
    ``s2d_stem``, under the same names."""
    m = get_model("resnet50")
    assert sum(p.numel() for p in m.parameters()) == 25_557_032
    stats = list(m.buffers())
    assert len(stats) == 106 and sum(b.numel() for b in stats) == 53_120
    for name in NAMES:
        for kw in ({}, S2D) if name != "resnet50v2" else ({},):
            model = flax_get_model(name, **kw)
            shapes = jax.eval_shape(
                lambda k, x, model=model: model.init(k, x, train=True),
                jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
            sizes = {c: sum(int(np.prod(a.shape)) for a in
                            jax.tree_util.tree_leaves(shapes[c]))
                     for c in ("params", "batch_stats")}
            port = get_model(name, **kw)
            assert sum(p.numel() for p in port.parameters()) == sizes[
                "params"], (name, kw)
            assert sum(b.numel() for b in port.buffers()) == sizes[
                "batch_stats"], (name, kw)
    plain, s2d = get_model("resnet50"), get_model("resnet50", **S2D)
    assert list(plain.state_dict()) == list(s2d.state_dict())
    assert type(s2d.stem.bn) is layers.BatchNorm
    assert type(plain.stem.bn) is layers.MixedBatchNorm
    assert plain.stage1_block1.proj is not None  # stride 1, projected
    assert plain.stage1_block2.proj is None
    r34 = get_model("resnet34")
    assert r34.stage1_block1.proj is not None  # always_project
    assert get_model("resnet34", always_project=False
                     ).stage1_block1.proj is None


def test_s2d_stem_refuses_odd_sizes_and_remat_names_trap_c11():
    module = get_model("resnet50", num_classes=CLASSES, **S2D)
    with pytest.raises(ValueError, match="even H/W"):
        module(torch.zeros(1, 63, 64, 3))
    jax_model = flax_get_model("resnet50", num_classes=CLASSES, **S2D)
    with pytest.raises(ValueError, match="even H/W"):
        jax.eval_shape(lambda k, x: jax_model.init(k, x),
                       jax.random.PRNGKey(0), jnp.zeros((1, 63, 64, 3)))
    # remat is ported with trap C11's guard (tests/test_torch_remat.py);
    # a policy the ResNet does not have is refused
    assert get_model("resnet50", remat="block").remat == "block"
    with pytest.raises(ValueError, match="unknown remat 'stack'"):
        get_model("resnet50", remat="stack")


# ----------------------------------------- BatchNorm, traps C1 and C8


def _bn_input(dtype, seed=0):
    """NHWC activations whose channel means are large beside their
    spread (post-ReLU and image-like), where a bf16 apply of the folded
    affine cancels digits that a float32 apply keeps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, 6, 5, 7)) + rng.uniform(2, 6, 7)
    return jnp.asarray(x, getattr(jnp, dtype))


def _flax_bn(kind, dtype, eps):
    cls = jax_layers.MixedBatchNorm if kind == "mixed" else flax_nn.BatchNorm
    return cls(momentum=0.9, epsilon=eps, dtype=dtype)


def _port_bn(kind, dtype, eps, state):
    bn = (layers.MixedBatchNorm(7, 0.9, eps) if kind == "mixed"
          else layers.BatchNorm(7, 0.9, eps, dtype=dtype))
    bn.load_state_dict(state)
    return bn


# (layer, input dtype, the layer's dtype, eps): the zoo's BN sites — the
# ConvBNs' MixedBatchNorm, the S2D stem's stock BN in the compute dtype,
# V2's stock BN in float32 at eps 1.001e-5 on a bf16 input
BN_CASES = [
    ("mixed", "float32", "float32", 1e-5),
    ("mixed", "bfloat16", "bfloat16", 1e-5),
    ("stock", "float32", "float32", 1e-5),
    ("stock", "bfloat16", "bfloat16", 1e-5),
    ("stock", "bfloat16", "float32", 1.001e-5),
]


@pytest.mark.parametrize("kind,in_dtype,dtype,eps", BN_CASES)
def test_train_mode_batchnorm_matches_flax(kind, in_dtype, dtype, eps):
    """One train-mode forward: the output (its dtype by flax's rule), the
    updated running statistics against flax's ``batch_stats``, then the
    eval forward on them. In bf16, ``MixedBatchNorm`` in the stock
    layer's place misses flax's stock output (trap C8)."""
    x = _bn_input(in_dtype)
    flax_bn = _flax_bn(kind, getattr(jnp, dtype), eps)
    shapes = jax.eval_shape(lambda k, v: flax_bn.init(k, v, True),
                            jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(1)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng), shapes)
    want, mutated = flax_bn.apply(variables, x, False,
                                  mutable=["batch_stats"])
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in (
        ("scale", variables["params"]["scale"]),
        ("bias", variables["params"]["bias"]),
        ("mean", variables["batch_stats"]["mean"]),
        ("var", variables["batch_stats"]["var"]))}
    port = _port_bn(kind, getattr(torch, dtype), eps, state)
    xt = torch.tensor(np.asarray(x, np.float32)).to(getattr(torch,
                                                            in_dtype))
    got = port(xt, train=True)
    assert got.dtype == getattr(torch, str(want.dtype))
    # float32: sums in another order. Stock bf16: both sides round the
    # same float32 value once, one bf16 step. Mixed bf16: the bf16
    # multiply-add rounds at the activations' scale (XLA:CPU keeps the
    # product in float32, ATen rounds it), one bf16 step of max |x|
    if want.dtype == jnp.float32:
        tol = dict(atol=1e-5, rtol=1e-5)
    elif kind == "stock":
        tol = dict(atol=1e-5, rtol=BF16_STEP)
    else:
        tol = dict(atol=BF16_STEP * float(jnp.abs(x).max()), rtol=BF16_STEP)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)
    stats = mutated["batch_stats"]
    stat_tol = (dict(atol=1e-5, rtol=1e-5) if kind == "stock"
                or in_dtype == "float32" else dict(atol=1e-3, rtol=2e-2))
    np.testing.assert_allclose(port.mean.numpy(), stats["mean"], **stat_tol)
    np.testing.assert_allclose(port.var.numpy(), stats["var"], **stat_tol)
    evaluated = flax_bn.apply({**variables, **mutated}, x, True)
    with torch.no_grad():
        got = port(xt, train=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(evaluated, np.float32), **tol)

    if kind == "stock" and dtype == "bfloat16":  # trap C8
        mixed = _port_bn("mixed", torch.bfloat16, eps, state)
        miss = mixed(xt, train=True).detach().float().numpy()
        assert not np.allclose(miss, np.asarray(want, np.float32), **tol)


def test_stock_batchnorm_in_the_s2d_stem_matches_flax_bf16():
    """The S2D stem in bf16, trained: on the JAX stem's own bf16 conv
    output, the port's stock BN and ReLU give the JAX stem's output to
    one bf16 step and its statistics to 1e-5; ``MixedBatchNorm`` in the
    stock BN's place misses the output (trap C8)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(0, 1, (2, 32, 32, 3)), jnp.float32)
    stem = jax_resnet.S2DStem(16, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda k, v: stem.init(k, v, True),
                            jax.random.PRNGKey(0), x)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng), shapes)
    kernel = variables["params"]["conv"]["kernel"]
    # filters with a nonzero mean, as a stem's on pixels in [0, 1]
    variables["params"]["conv"]["kernel"] = kernel + 0.05
    want, mutated = stem.apply(variables, x, True, mutable=["batch_stats"])
    conv = jax_resnet._Conv7S2D(16, dtype=jnp.bfloat16).apply(
        {"params": variables["params"]["conv"]}, x)
    assert conv.dtype == want.dtype == jnp.bfloat16
    conv_t = torch.from_numpy(np.asarray(conv, np.float32)).bfloat16()
    tol = dict(atol=1e-5, rtol=BF16_STEP)
    state = _bn_state(variables)
    for kind, matches in (("stock", True), ("mixed", False)):
        bn = (layers.BatchNorm(16, dtype=torch.bfloat16) if kind == "stock"
              else layers.MixedBatchNorm(16))
        bn.load_state_dict(state)
        got = torch.relu(bn(conv_t, train=True)).detach().float().numpy()
        close = np.allclose(got, np.asarray(want, np.float32), **tol)
        assert close == matches, kind
        if matches:
            stats = mutated["batch_stats"]["bn"]
            np.testing.assert_allclose(bn.mean.numpy(), stats["mean"],
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(bn.var.numpy(), stats["var"],
                                       atol=1e-5, rtol=1e-5)
    port = resnet.S2DStem(16, dtype=torch.bfloat16)
    port.load_state_dict({
        "conv.weight": torch.from_numpy(np.asarray(
            variables["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1)
            .copy()),
        **{f"bn.{k}": v for k, v in state.items()}})
    out = port(torch.tensor(np.asarray(x)), train=True)
    assert out.dtype == torch.bfloat16 and type(port.bn) is layers.BatchNorm


# ------------------------------------------- stride placement, trap C3


def test_bottleneck_stride_sits_on_conv1():
    """A strided, projecting bottleneck against the JAX block: the port
    puts the stride on the 1x1 ``conv1`` and matches; the same weights
    with the stride moved to the 3x3 ``conv2`` (torchvision's V1.5, and
    the JAX docstring's claim) give the same shape and miss."""
    block = jax_resnet.BottleneckBlock(8, strides=2, project=True)
    x = _images(2, 14, seed=6)[..., :1].repeat(16, axis=-1)
    x = x + np.random.default_rng(7).normal(0, 1, x.shape).astype(np.float32)
    shapes = jax.eval_shape(lambda k, v: block.init(k, v, True),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(8)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, leaf: _draw(p, leaf, rng), shapes)
    want = np.asarray(block.apply(variables, jnp.asarray(x), False))
    flat = {}
    for name in ("conv1", "conv2", "conv3", "proj"):
        flat[f"{name}.conv.weight"] = torch.from_numpy(np.asarray(
            variables["params"][name]["conv"]["kernel"])
            .transpose(3, 2, 0, 1).copy())
        flat.update({f"{name}.bn.{k}": v for k, v in
                     _bn_state(variables, (name, "bn")).items()})
    port = resnet.BottleneckBlock(16, 8, strides=2, project=True)
    port.load_state_dict(flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        assert port.conv1.conv.stride == (2, 2)
        assert port.conv2.conv.stride == (1, 1)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        port.conv1.conv.stride, port.conv2.conv.stride = (1, 1), (2, 2)
        moved = port(torch.from_numpy(x)).numpy()
    assert moved.shape == want.shape == (2, 7, 7, 32)
    assert not np.allclose(moved, want, atol=1e-3, rtol=1e-3)


# ------------------------------------------------------- train steps


STEP_SIZE, STEP_BATCH, STEPS_PER_EPOCH = 64, 8, 2
# the plateau's LR scale of the carried state: two drops of 0.1, which
# keeps three steps of batch 8 on random labels from diverging at the
# config's LR of 0.1
LR_SCALE = 0.01


def _step_batch(seed, n=STEP_BATCH, size=STEP_SIZE):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0, 1, (n, size, size, 3)).astype(np.float32),
            "label": rng.integers(0, CLASSES, n).astype(np.int32)}


def _jax_resnet_state(name, dtype=jnp.float32):
    """A JAX train state for ``name`` under its config (SGD 0.1 / 0.9 /
    1e-4, plateau at :data:`LR_SCALE`, ``model_kwargs``) one step into
    training, on drawn variables, and its jitted step."""
    cfg = jax_get_config(name)
    kw = cfg.get("model_kwargs", {})
    model = flax_get_model(name, num_classes=CLASSES, dtype=dtype, **kw)
    _, variables = flax_variables(name, STEP_SIZE, seed=2, gain=1.0, **kw)
    tx, _ = jax_optimizers.make_optimizer(cfg, STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = jax_optimizers.set_lr_scale(tx.init(params), LR_SCALE)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=opt_state, apply_fn=model.apply, tx=tx)
    step = jax.jit(lambda s, b, k: jax_train_step(s, b, k,
                                                  normalize_kind="torch"))
    state, _ = step(state, _step_batch(100), jax.random.key(0))
    return state, step


def _carry(name, jstate, dtype=torch.float32):
    """The JAX state in the port, the model built with the config's
    ``model_kwargs``: module, BN statistics, momentum, step, LR scale."""
    host = jax.tree.map(np.asarray, jstate)
    carried = flax_train_state_to_torch(
        name, params=host.params, batch_stats=host.batch_stats,
        trace=_find_trace(host.opt_state), step=int(host.step),
        lr_scale=float(host.opt_state.hyperparams["lr_scale"]),
        num_classes=CLASSES, input_size=STEP_SIZE)
    cfg = get_config(name)
    module = create_model(name, device=CPU, num_classes=CLASSES,
                          input_size=STEP_SIZE, dtype=dtype,
                          **cfg.get("model_kwargs", {}))
    opt, _ = make_optimizer(cfg, module.parameters(), STEPS_PER_EPOCH)
    state = TrainState(module, opt)
    load_flax_train_state(state, carried)
    return state


def _state_dict_of(name, jstate):
    host = jax.tree.map(np.asarray, jstate)
    return flax_to_torch(name, {"params": host.params,
                                "batch_stats": host.batch_stats},
                         num_classes=CLASSES, input_size=STEP_SIZE)


def test_resnet50_f32_train_steps_match_jax():
    """Three f32 steps of ``resnet50`` under its config's ``s2d_stem``
    (the stock stem BN on both sides, the JAX stem in its space-to-depth
    form) from a carried mid-training JAX state at 64 px, batch 8. As
    with ``inception1``, float32 cannot hold a deep BN model to a flat
    1e-5 (ReLUs whose inputs lie within rounding of 0 flip between
    runs), so two more JAX runs, on each batch reversed and rolled by 3,
    give each leaf its floor: every parameter and BN statistic within
    1e-5 plus three times it, the loss within 1e-4 plus four times the
    step's. The state before the steps and the steps without momentum
    fail that on most leaves."""
    orders = (lambda a: a[::-1].copy(), lambda a: np.roll(a, 3, axis=0))
    jstate, jstep = _jax_resnet_state("resnet50")
    state, jstate, start, no_momentum, reordered = _steps_against_jax(
        lambda: _carry("resnet50", jstate), jstate, jstep,
        [_step_batch(i) for i in range(3)], orders)
    assert state.step == 4
    assert type(state.module.stem.bn) is layers.BatchNorm
    want = _state_dict_of("resnet50", jstate)
    floors = [_state_dict_of("resnet50", s) for s in reordered]
    tol = {k: 1e-5 + 3 * max(_leaf_gap(f[k], want[k]) for f in floors)
           for k in want}
    _hold_leaves(state.module.state_dict(), want, tol, start, no_momentum)


def test_resnet50_bf16_train_step_twin_of_jax_bf16():
    """One bf16 step under the config's ``s2d_stem`` against JAX bf16
    from the same carried state: the loss within the bf16-twin band, the
    stem's BN statistics (stock, taken on float32 casts) within 1e-3."""
    jstate, jstep = _jax_resnet_state("resnet50", jnp.bfloat16)
    state = _carry("resnet50", jstate, torch.bfloat16)
    batch = _step_batch(10)
    jstate, jm = jstep(jstate, batch, jax.random.key(0))
    m = classification_train_step(state, _torch_batch(batch),
                                  next(KeySeq(1, 0)), normalize_kind="torch")
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=CLS_LOSS_RTOL)
    stem = jstate.batch_stats["stem"]["bn"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(state.module.stem.bn, k).numpy(),
                                   np.asarray(stem[k]), atol=1e-3, rtol=1e-2)


# ------------------------------------------ converter, checkpoints


def test_checkpoint_trained_under_s2d_stem_serves_without_it(tmp_path):
    """flax params and batch_stats -> the port's ``resnet50`` built with
    ``s2d_stem`` -> a verified port checkpoint -> ``load_served``, which
    builds the plain stem: the same weights bit for bit and, in float32,
    the same logits."""
    _, variables = flax_variables("resnet50", **S2D)
    kw = {"num_classes": CLASSES, "input_size": SIZE}
    module = create_model("resnet50", device=CPU, **kw, **S2D)
    module.load_state_dict(flax_to_torch("resnet50", variables, **kw))
    cfg = {**get_config("resnet50"), **kw}
    opt, _ = make_optimizer(cfg, module.parameters(), steps_per_epoch=4)
    CheckpointManager(tmp_path / "resnet50" / "ckpt").save(
        0, TrainState(module, opt), config=cfg)
    served = load_served("resnet50", str(tmp_path / "resnet50"),
                         device="cpu")
    assert type(served.module.stem.bn) is layers.MixedBatchNorm
    for name, tensor in module.state_dict().items():
        assert torch.equal(served.module.state_dict()[name], tensor), name
    x = torch.from_numpy(_images(2))
    module.eval()
    with torch.inference_mode():
        torch.testing.assert_close(served.module(x), module(x), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ serving


@pytest.mark.parametrize("name", NAMES)
def test_load_served_matches_jax_load_served(name, monkeypatch):
    """CPU serving on carried variables against the JAX ``load_served``
    serving the same ones (its train state built on them): the same
    classes, probabilities within 1e-5. Both build the model without the
    config's ``model_kwargs``."""
    _, variables = flax_variables(name, seed=5)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])

    def carried_state(model, tx, sample, **kw):
        return JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                               variables["batch_stats"]),
            opt_state=tx.init(params), apply_fn=model.apply, tx=tx)

    monkeypatch.setattr(jax_state, "create_train_state", carried_state)
    theirs = jax_load_served(name, input_size=SIZE, num_classes=CLASSES)
    ours = load_served(name, variables=variables, device="cpu",
                       input_size=SIZE, num_classes=CLASSES)
    x = _images(3, seed=4)
    want, got = theirs.run(x), ours.run(x)
    np.testing.assert_array_equal(got["classes"], np.asarray(want["classes"]))
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
