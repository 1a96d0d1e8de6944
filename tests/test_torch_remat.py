"""Rematerialization in the port's ResNet, on the CPU (trap C11).

A small ResNet V1 (stages (1, 1, 2, 1) of bottlenecks, 64 px, batch 4)
takes one float32 SGD step of its training config under ``remat="block"``
and ``"conv"``; its parameters, gradients and BN running statistics must
equal the un-rematerialized step's exactly (the CPU runs the same float32
ops in the same order; tolerance 0). A variant that runs the BN running
update again in the recompute fails that. The ``"conv"`` policy's
backward recomputes no convolution, ``"block"``'s does. The
rematerialized ``resnet50`` step is held to the JAX ResNet's under
``remat="block"`` on the same carried weights, at PR 6's ResNet
tolerance (each leaf within 1e-5 plus three times its reordered-JAX
floor). ``resnet152`` takes ``remat="block"`` from its registry entry
through ``get_config``, and ``from_flax`` maps a JAX ``resnet152`` tree
whole, remat or not.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.core.prng import KeySeq
from deepvision_tpu_torch.models import get_model, layers
from deepvision_tpu_torch.models.registry import model_remat
from deepvision_tpu_torch.models.resnet import BottleneckBlock, ResNet
from deepvision_tpu_torch.train.configs import TRAINABLE, get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import classification_train_step
from tests.test_torch_resnet import (
    STEP_SIZE,
    _jax_resnet_state,
    _state_dict_of,
    _step_batch,
    flax_variables,
)
from tests.test_torch_train import (
    _find_trace,
    _hold_leaves,
    _leaf_gap,
    _steps_against_jax,
)
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
CLASSES = 10
STAGES = (1, 1, 2, 1)


def _small(remat, seed=0):
    module = ResNet(STAGES, BottleneckBlock, num_classes=CLASSES,
                    remat=remat)
    layers.init_weights(module, torch.Generator().manual_seed(seed))
    return module


def _one_step(module):
    """One float32 step of the resnet50 config (SGD 0.1 / 0.9 / 1e-4) on
    a seeded batch; -> (state dict, gradients)."""
    rng = np.random.default_rng(3)
    batch = {"image": torch.from_numpy(
        rng.normal(0, 1, (4, 64, 64, 3)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, CLASSES, 4).astype(
            np.int32))}
    opt, _ = make_optimizer(get_config("resnet50"), module.parameters())
    state = TrainState(module, opt)
    classification_train_step(state, batch, next(KeySeq(1, 0)))
    return ({k: v.clone() for k, v in module.state_dict().items()},
            {n: p.grad.clone() for n, p in module.named_parameters()})


@pytest.fixture(scope="module")
def plain_step():
    return _one_step(_small(None))


@pytest.mark.parametrize("policy", ["block", "conv"])
def test_remat_step_equals_the_plain_step(policy, plain_step):
    """Parameters, gradients and BN running statistics bit for bit."""
    state, grads = _one_step(_small(policy))
    want_state, want_grads = plain_step
    stats = [k for k in want_state if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 20  # 19 ConvBNs in the blocks, the stem's
    for k, v in want_state.items():
        assert torch.equal(state[k], v), k
    for k, v in want_grads.items():
        assert torch.equal(grads[k], v), k


def test_a_second_running_update_in_the_recompute_fails(plain_step,
                                                        monkeypatch):
    """Trap C11: without the recompute guard the BN statistics of every
    rematerialized block take the momentum twice."""
    monkeypatch.setattr(layers, "recomputing", contextlib.nullcontext)
    state, _ = _one_step(_small("block"))
    want, _ = plain_step
    moved = [k for k in want if k.startswith("stage")
             and k.endswith((".mean", ".var"))
             and not torch.equal(state[k], want[k])]
    assert len(moved) == 2 * 19, moved
    assert torch.equal(state["stem.bn.mean"], want["stem.bn.mean"])


class _CountConvolutions(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is layers.CONV_OUT:
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,recomputed", [
    (None, 0), ("block", 19), ("conv", 0)])
def test_conv_policy_saves_the_convolution_outputs(policy, recomputed):
    """The backward of ``"block"`` runs the blocks' 19 convolutions
    again; ``"conv"`` saves their outputs (the JAX ``conv_out``) and runs
    none; without remat none either."""
    module = _small(policy)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    loss = module(x, train=True).sum()
    with _CountConvolutions() as counter:
        loss.backward()
    assert counter.count == recomputed


def test_remat_is_only_in_training():
    """Eval and no-grad forwards run the blocks plainly and equal the
    plain model's."""
    plain, remat = _small(None), _small("block")
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(plain(x), remat(x))
        assert torch.equal(plain(x, train=True), remat(x, train=True))
    with pytest.raises(ValueError, match="remat"):
        ResNet(STAGES, BottleneckBlock, remat="stack")


# ------------------------------------------------------- against JAX


def _carry_remat(jstate, policy):
    """The JAX state in a port ``resnet50`` built with ``policy``."""
    from deepvision_tpu_torch.convert.from_flax import (
        flax_train_state_to_torch,
        load_flax_train_state,
    )
    from deepvision_tpu_torch.models import create_model

    host = jax.tree.map(np.asarray, jstate)
    carried = flax_train_state_to_torch(
        "resnet50", params=host.params, batch_stats=host.batch_stats,
        trace=_find_trace(host.opt_state), step=int(host.step),
        lr_scale=float(host.opt_state.hyperparams["lr_scale"]),
        num_classes=CLASSES, input_size=STEP_SIZE)
    cfg = get_config("resnet50")
    module = create_model("resnet50", device=CPU, num_classes=CLASSES,
                          input_size=STEP_SIZE, remat=policy,
                          **cfg["model_kwargs"])
    opt, _ = make_optimizer(cfg, module.parameters(), 2)
    state = TrainState(module, opt)
    load_flax_train_state(state, carried)
    return state


def test_remat_block_step_matches_the_jax_remat_step(monkeypatch):
    """One f32 ``resnet50`` step under ``remat="block"`` on both sides,
    from a carried mid-training JAX state (the config's ``s2d_stem``),
    each leaf within 1e-5 plus three times its floor (two JAX runs on the
    batch reordered); the state before the step and the step without
    momentum fail that on most leaves."""
    real = flax_get_model

    def with_remat(name, **kw):
        return real(name, remat="block", **kw)

    monkeypatch.setattr("tests.test_torch_resnet.flax_get_model", with_remat)
    jstate, jstep = _jax_resnet_state("resnet50")
    orders = (lambda a: a[::-1].copy(), lambda a: np.roll(a, 3, axis=0))
    state, jstate, start, no_momentum, reordered = _steps_against_jax(
        lambda: _carry_remat(jstate, "block"), jstate, jstep,
        [_step_batch(0)], orders)
    assert state.module.remat == "block"
    want = _state_dict_of("resnet50", jstate)
    floors = [_state_dict_of("resnet50", s) for s in reordered]
    tol = {k: 1e-5 + 3 * max(_leaf_gap(f[k], want[k]) for f in floors)
           for k in want}
    _hold_leaves(state.module.state_dict(), want, tol, start, no_momentum)


# --------------------------------------------------- resnet152, config


def test_resnet152_takes_block_remat_from_its_registry_entry():
    assert model_remat("resnet152") == "block"
    assert model_remat("resnet50") is None
    assert "resnet152" in TRAINABLE
    ours, theirs = get_config("resnet152"), jax_get_config("resnet152")
    assert ours["model_kwargs"] == {"s2d_stem": True, "remat": "block"}
    for key in ("precision", "augment", "batch_size", "input_size",
                "optimizer", "optimizer_params", "scheduler",
                "scheduler_params", "total_epochs", "model_kwargs", "remat"):
        assert ours[key] == theirs[key], key
    assert get_config("resnet50")["remat"] is None
    module = get_model("resnet152", **ours["model_kwargs"])
    assert module.remat == "block"
    blocks = [n for n in module.blocks]
    assert len(blocks) == 3 + 8 + 36 + 3


def test_from_flax_maps_a_resnet152_tree_whole():
    """flax's ``nn.remat`` keeps the module names and so does the port:
    the JAX tree of ``resnet152`` under ``remat="block"`` is the plain
    one, and the converter carries every leaf of it into the port's
    rematerialized module (it raises on any leaf left over or missing)."""
    _, variables = flax_variables("resnet152", size=32, remat="block")
    _, plain = flax_variables("resnet152", size=32)
    assert (jax.tree_util.tree_structure(variables)
            == jax.tree_util.tree_structure(plain))
    state = flax_to_torch("resnet152", variables, num_classes=CLASSES)
    module = get_model("resnet152", num_classes=CLASSES, remat="block",
                       s2d_stem=True)
    assert set(state) == set(module.state_dict())
    module.load_state_dict(state)
    want = np.asarray(variables["params"]["stage3_block36"]["conv2"]["conv"]
                      ["kernel"])
    got = module.stage3_block36.conv2.conv.weight.detach().numpy()
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))
    stats = [k for k in state if k.endswith((".mean", ".var"))]
    assert len(stats) == 2 * 155
