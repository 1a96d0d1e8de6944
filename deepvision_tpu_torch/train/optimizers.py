"""Optimizer factory: a ``training_config`` entry -> a torch optimizer.

The twin of ``deepvision_tpu/train/optimizers.py`` for ``sgd`` and
``adam``. The JAX chain ``add_decayed_weights(wd) -> sgd(lr, momentum)``
adds the L2 term to every gradient before the momentum trace, which is
``torch.optim.SGD(weight_decay=wd, momentum=m, dampening=0)``.

A plateau-scheduled config gets a :class:`PlateauController` whose scale
:func:`set_lr_scale` writes into the param groups (``lr = base_lr ·
lr_scale``) without rebuilding the optimizer, as the JAX package writes
``lr_scale`` into ``inject_hyperparams``. A step-count schedule
(``step``, ``inception_poly``; ``train/schedules.py``) gets a
:class:`ScheduledSGD`, which evaluates the schedule on the device at
each update from an update count that a skipped step does not advance,
as optax's count inside the optimizer state. ``linear_decay`` comes with
CycleGAN, whose config also needs Adam.

``adam`` is optax's ``adam(lr, b1, b2, eps)`` (no weight decay), which
``torch.optim.Adam`` computes alike: both divide the bias-corrected first
moment by the square root of the bias-corrected second plus eps. It is
built with its step count on the parameters' device (``capturable`` on
the card, trap C10), so that the train state's select of the optimizer
state never mixes a host tensor with a device one, and it follows a
plateau through :func:`set_lr_scale` as SGD does.

``rmsprop`` raises (trap C7): optax's ``scale_by_rms`` adds eps inside
the square root, torch's ``RMSprop`` outside it, and with the eps=1.0 of
MobileNet's and Inception V3's configs the two differ.
"""

from __future__ import annotations

from typing import Iterable

import torch

from deepvision_tpu_torch.train import schedules

__all__ = ["make_optimizer", "set_lr_scale", "set_update_count",
           "ScheduledSGD"]


class ScheduledSGD(torch.optim.SGD):
    """``torch.optim.SGD`` (L2 before momentum, no dampening) whose
    learning rate at each update is ``schedule(count) · lr_scale``, with
    ``count`` the updates made before it (optax's
    ``ScaleByScheduleState.count``). The count is one float32 tensor on
    the parameters' device, ``self.count`` (exact to 2^24 updates): the
    train state's select keeps it on a skipped step, as it keeps the
    momentum, and ``state_dict`` carries it. The learning rate stays a
    device tensor: no update waits for the host."""

    def __init__(self, params, schedule: schedules.Schedule, *, lr: float,
                 momentum: float, weight_decay: float):
        super().__init__(params, lr=lr, momentum=momentum, dampening=0.0,
                         weight_decay=weight_decay)
        self.schedule = schedule
        self.count = torch.zeros(
            (), dtype=torch.float32,
            device=self.param_groups[0]["params"][0].device)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduledSGD.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            lr = self.schedule(self.count) * group["lr_scale"]
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            momentum = group["momentum"]
            if momentum:
                bufs = [st.get("momentum_buffer") for st in states]
                if any(b is None for b in bufs):
                    for i, (g, st) in enumerate(zip(grads, states)):
                        if bufs[i] is None:
                            bufs[i] = st["momentum_buffer"] = g.clone()
                        else:
                            bufs[i].mul_(momentum).add_(g)
                else:
                    torch._foreach_mul_(bufs, momentum)
                    torch._foreach_add_(bufs, grads)
                grads = bufs
            torch._foreach_sub_(params, torch._foreach_mul(grads, lr))
        self.count.add_(1.0)
        return None

    def state_dict(self) -> dict:
        return {**super().state_dict(), "count": self.count.clone()}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = state_dict.pop("count")
        super().load_state_dict(state_dict)
        self.count.copy_(count)


def make_optimizer(cfg: dict, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int | None = None):
    """-> ``(optimizer, plateau_controller | None)`` from a
    training-config entry; a step-count schedule needs
    ``steps_per_epoch``."""
    opt = cfg["optimizer"]
    p = dict(cfg.get("optimizer_params", {}))
    base_lr = p.pop("lr")
    if opt not in ("sgd", "adam"):
        raise NotImplementedError(
            f"optimizer {opt!r} is not ported: sgd and adam are. rmsprop "
            "waits on trap C7 (optax's scale_by_rms puts eps inside the "
            "square root, torch's RMSprop outside; with eps=1.0 they "
            "differ)")
    sched_name = cfg.get("scheduler")
    sched_p = cfg.get("scheduler_params", {})
    if opt == "adam":
        if sched_name not in (None, "constant", "plateau"):
            raise NotImplementedError(
                f"scheduler {sched_name!r} with adam is not wired into the "
                "port's optimizer yet: plateau and constant are")
        params = list(params)
        optimizer = torch.optim.Adam(
            params, lr=base_lr, betas=(p.get("beta1", 0.9),
                                       p.get("beta2", 0.999)),
            eps=p.get("eps", 1e-8), capturable=params[0].is_cuda)
        return _with_plateau(optimizer, base_lr, sched_name, sched_p)
    sgd = {"lr": base_lr, "momentum": p.get("momentum", 0.0),
           "weight_decay": p.get("weight_decay", 0.0)}
    if sched_name in ("step", "inception_poly"):
        if not steps_per_epoch:
            raise ValueError(
                f"scheduler {sched_name!r} counts epochs in steps: pass "
                "steps_per_epoch")
        if sched_name == "step":
            schedule = schedules.step_decay(
                base_lr, steps_per_epoch, sched_p["step_size"],
                sched_p["gamma"])
        else:
            schedule = schedules.inception_poly(base_lr, steps_per_epoch)
        optimizer = ScheduledSGD(params, schedule, **sgd)
    elif sched_name in (None, "constant", "plateau"):
        optimizer = torch.optim.SGD(params, dampening=0.0, **sgd)
    else:
        raise NotImplementedError(
            f"scheduler {sched_name!r} is not wired into the port's optimizer "
            "yet: plateau, constant, step and inception_poly are")
    return _with_plateau(optimizer, base_lr, sched_name, sched_p)


def _with_plateau(optimizer, base_lr: float, sched_name, sched_p: dict):
    """``(optimizer, PlateauController | None)``, the param groups
    carrying ``base_lr`` and an LR scale of 1."""
    for group in optimizer.param_groups:
        group["base_lr"] = base_lr
        group["lr_scale"] = 1.0
    if sched_name == "plateau":
        return optimizer, schedules.PlateauController(
            mode=sched_p.get("mode", "max"),
            factor=sched_p.get("factor", 0.1),
            patience=sched_p.get("patience", 10))
    return optimizer, None


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    """Write the PlateauController's scale into every param group."""
    for group in optimizer.param_groups:
        group["lr_scale"] = float(scale)
        group["lr"] = group["base_lr"] * group["lr_scale"]


@torch.no_grad()
def set_update_count(optimizer: ScheduledSGD, count: int) -> None:
    """Set a :class:`ScheduledSGD`'s update count (a carried JAX state's
    schedule count)."""
    if not isinstance(optimizer, ScheduledSGD):
        raise TypeError(
            f"only a ScheduledSGD keeps an update count, not "
            f"{type(optimizer).__name__}")
    optimizer.count.fill_(float(count))
