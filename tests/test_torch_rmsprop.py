"""The port's RMSprop against optax's, on the CPU.

``make_optimizer`` builds a :class:`ScheduledRMSprop` for the
``rmsprop`` configs (``mobilenet1``, ``inception3``): optax's
``rmsprop(lr, decay, eps)``, whose ``scale_by_rms`` divides by
``sqrt(nu + eps)``. ``torch.optim.RMSprop`` divides by ``sqrt(nu) +
eps``, and at the configs' eps=1.0 the two differ in the leading term
(trap C7). Updates are held to optax's within 1e-6 over 20 updates; a
step that loss scaling skips keeps ``nu``, the update count and the
parameters bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu_torch.convert.from_flax import rmsprop_parts
from deepvision_tpu_torch.core.precision import get_policy
from deepvision_tpu_torch.models import create_model
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import (
    ScheduledRMSprop,
    make_optimizer,
    set_lr_scale,
)
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import classification_train_step
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

STEPS_PER_EPOCH = 2  # the step schedule's 2-epoch drops every 4 updates
UPDATES = 20


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
            "b": rng.normal(0, 1, (4,)).astype(np.float32)}


def _grads(rng, params):
    return {k: rng.normal(0, 2, v.shape).astype(np.float32)
            for k, v in params.items()}


@pytest.mark.parametrize("scheduler,weight_decay", [
    ("step", 0.0), ("plateau", 4e-5)])
def test_rmsprop_matches_optax_over_20_updates(scheduler, weight_decay):
    """``mobilenet1``'s RMSprop (lr 0.045, alpha 0.9, eps 1.0) under its
    step schedule, and under a plateau with L2 decay added before the RMS
    (the LR scale dropped to 0.1 at update 10): every parameter and
    ``nu`` within 1e-6 of optax's, the update count exactly."""
    cfg = jax_get_config("mobilenet1")
    cfg["scheduler"] = scheduler
    cfg["optimizer_params"]["weight_decay"] = weight_decay
    tx, _ = jax_optimizers.make_optimizer(cfg, STEPS_PER_EPOCH)
    params = _params()
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    ours = {**get_config("mobilenet1"), "scheduler": scheduler,
            "optimizer_params": cfg["optimizer_params"]}
    opt, plateau = make_optimizer(ours, list(tp.values()), STEPS_PER_EPOCH)
    assert isinstance(opt, ScheduledRMSprop)
    assert (plateau is not None) == (scheduler == "plateau")
    rng = np.random.default_rng(1)
    update = jax.jit(tx.update)
    for i in range(UPDATES):
        if i == 10 and plateau is not None:
            opt_state = jax_optimizers.set_lr_scale(opt_state, 0.1)
            set_lr_scale(opt, 0.1)
        g = _grads(rng, params)
        updates, opt_state = update(jax.tree.map(jnp.asarray, g), opt_state,
                                    jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    nu, count = rmsprop_parts(opt_state)
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(opt.state[p]["nu"].numpy(),
                                   np.asarray(nu[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert float(opt.count) == UPDATES
    if scheduler == "step":
        assert count == UPDATES
    # the parameters moved by far more than the tolerance
    assert max(np.abs(np.asarray(jp[k]) - params[k]).max()
               for k in params) > 0.1


def test_torch_rmsprop_differs_at_eps_1():
    """Trap C7: one update of lr 1 from ``nu`` = 0 on a gradient of 1 is
    ``1 / sqrt(0.1 + 1)`` (0.9535) for optax and ``ScheduledRMSprop``,
    ``1 / (sqrt(0.1) + 1)`` (0.7597) for ``torch.optim.RMSprop``."""
    cfg = {"optimizer": "rmsprop", "scheduler": None,
           "optimizer_params": {"lr": 1.0, "alpha": 0.9, "eps": 1.0}}
    ours = torch.nn.Parameter(torch.zeros(3))
    theirs = torch.nn.Parameter(torch.zeros(3))
    opt, _ = make_optimizer(cfg, [ours])
    stock = torch.optim.RMSprop([theirs], lr=1.0, alpha=0.9, eps=1.0)
    tx = optax.rmsprop(1.0, decay=0.9, eps=1.0)
    updates, _ = tx.update(jnp.ones(3), tx.init(jnp.zeros(3)))
    for p, o in ((ours, opt), (theirs, stock)):
        p.grad = torch.ones(3)
        o.step()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(updates),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(ours.detach().numpy(), -1 / np.sqrt(1.1),
                               rtol=1e-6)
    np.testing.assert_allclose(theirs.detach().numpy(),
                               -1 / (np.sqrt(0.1) + 1), rtol=1e-6)
    assert float((ours - theirs).detach().abs().min()) > 0.19


def test_skipped_step_keeps_nu_count_and_parameters():
    """``mobilenet1`` (alpha 0.25, 32 px) under ``bf16_scaled`` with its
    RMSprop: one clean step, then one whose images hold an inf. The
    second is skipped: every parameter, BN statistic, ``nu`` and the
    update count keep their values bit for bit, the step is counted and
    the scale halves; a finite step then moves them again."""
    policy = get_policy("bf16_scaled")
    module = create_model("mobilenet1", device=torch.device("cpu"),
                          num_classes=5, alpha=0.25,
                          dtype=policy.compute_dtype)
    opt, _ = make_optimizer(get_config("mobilenet1"), module.parameters(),
                            STEPS_PER_EPOCH)
    state = TrainState(module, opt,
                       loss_scale=policy.make_loss_scale(device="cpu"))
    rng = np.random.default_rng(0)

    def batch(bad=False):
        b = {"image": torch.from_numpy(
                 rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 5, 4).astype(
                 np.int32))}
        if bad:
            b["image"][1, 3, 3, 0] = float("inf")
        return b

    def snapshot():
        return {**{k: v.clone() for k, v in module.state_dict().items()},
                **{f"nu:{n}": opt.state[p]["nu"].clone()
                   for n, p in module.named_parameters()},
                "count": opt.count.clone()}

    gen = torch.Generator()
    m = classification_train_step(state, batch(), gen, "torch")
    assert float(m["mp_grads_finite"]) == 1.0
    before, scale = snapshot(), float(state.loss_scale.scale)
    assert float(before["count"]) == 1.0
    m = classification_train_step(state, batch(bad=True), gen, "torch")
    assert float(m["mp_grads_finite"]) == 0.0
    after = snapshot()
    for k, v in before.items():
        torch.testing.assert_close(after[k], v, rtol=0, atol=0, msg=k)
    assert state.step == 2
    assert float(state.loss_scale.scale) == scale / 2
    classification_train_step(state, batch(), gen, "torch")
    moved = snapshot()
    assert float(moved["count"]) == 2.0
    assert not torch.equal(moved["fc.weight"], before["fc.weight"])
    assert not torch.equal(moved["nu:fc.weight"], before["nu:fc.weight"])
