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
as optax's count inside the optimizer state.

``adam`` is optax's ``adam(lr, b1, b2, eps)`` (no weight decay), which
``torch.optim.Adam`` computes alike: both divide the bias-corrected first
moment by the square root of the bias-corrected second plus eps. It is
built with its step count on the parameters' device (``capturable`` on
the card, trap C10), so that the train state's select of the optimizer
state never mixes a host tensor with a device one, and it follows a
plateau through :func:`set_lr_scale` as SGD does. Under a step-count
schedule (``linear_decay``, CycleGAN's; ``step``; ``inception_poly``)
it is a :class:`ScheduledAdam`: optax's ``adam(schedule, b1, b2, eps)``
term for term, the learning rate evaluated on the device from an update
count that a skipped step does not advance.

``rmsprop`` is optax's ``rmsprop(lr, decay, eps)`` (after
``add_decayed_weights`` where the config sets ``weight_decay``), a
:class:`ScheduledRMSprop` under every scheduler. It is not
``torch.optim.RMSprop`` (trap C7): optax's ``scale_by_rms`` adds eps
inside the square root, ``g / sqrt(nu + eps)``, torch's outside it,
``g / (sqrt(nu) + eps)``, and with the eps=1.0 of MobileNet's and
Inception V3's configs the two differ in the leading term.
"""

from __future__ import annotations

from typing import Iterable

import torch

from deepvision_tpu_torch.train import schedules

__all__ = ["make_optimizer", "set_lr_scale", "set_update_count",
           "ScheduledSGD", "ScheduledAdam", "ScheduledRMSprop",
           "make_schedule"]


class _Counted:
    """An optimizer's update count, ``self.count`` (one float32 tensor on
    the parameters' device, exact to 2^24 updates), carried by
    ``state_dict`` under ``"count"``."""

    count: torch.Tensor

    def state_dict(self) -> dict:
        return {**super().state_dict(), "count": self.count.clone()}

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        count = state_dict.pop("count")
        super().load_state_dict(state_dict)
        self.count.copy_(count)


class ScheduledSGD(_Counted, torch.optim.SGD):
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


class ScheduledAdam(_Counted, torch.optim.Adam):
    """optax's ``adam(schedule, b1, b2, eps)``, ``scale_by_adam`` then
    ``scale_by_learning_rate``, as its update computes it: ``mu = (1 -
    b1)·g + b1·mu``, ``nu = (1 - b2)·g² + b2·nu``, the update ``mu / (1 -
    b1^t) / (sqrt(nu / (1 - b2^t)) + eps)`` at the t-th update, times
    ``-schedule(count) · lr_scale`` with ``count`` the updates made before
    (``ScaleByScheduleState.count``). State: ``exp_avg`` (mu),
    ``exp_avg_sq`` (nu) and ``step`` (t, float32) a parameter, as
    ``torch.optim.Adam`` names them, and ``self.count``, one float32
    tensor on the parameters' device that ``state_dict`` carries. Every
    tensor lives on the device, so no update waits for the host
    (capturable, trap C10), and the train state's select keeps them all
    on a skipped step."""

    def __init__(self, params, schedule: schedules.Schedule, *, lr: float,
                 betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        params = list(params)
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         capturable=params[0].is_cuda)
        self.schedule = schedule
        self.count = torch.zeros((), dtype=torch.float32,
                                 device=params[0].device)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduledAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            steps = [st["step"] for st in states]
            torch._foreach_add_(steps, 1.0)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - b2))
            # the bias corrections 1 - b^t, one 0-d tensor a parameter
            bc1 = torch._foreach_neg(torch._foreach_pow(b1, steps))
            torch._foreach_add_(bc1, 1.0)
            bc2 = torch._foreach_neg(torch._foreach_pow(b2, steps))
            torch._foreach_add_(bc2, 1.0)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            lr = self.schedule(self.count) * group["lr_scale"]
            torch._foreach_sub_(params, torch._foreach_mul(updates, lr))
        self.count.add_(1.0)
        return None


class ScheduledRMSprop(_Counted, torch.optim.Optimizer):
    """optax's ``rmsprop(schedule, decay=alpha, eps)``, ``scale_by_rms``
    then ``scale_by_learning_rate``, with optax's
    ``add_decayed_weights(weight_decay)`` before it where the decay is
    nonzero: ``g = grad + weight_decay·p``, ``nu = (1 - alpha)·g² +
    alpha·nu`` (``nu`` from 0, optax's ``initial_scale``), and the update
    ``g · rsqrt(nu + eps)`` times ``-schedule(count) · lr_scale``, with
    ``count`` the updates made before (``ScaleByScheduleState.count``).
    eps sits inside the square root, where ``torch.optim.RMSprop`` adds
    it outside (trap C7). State: ``nu`` a parameter and ``self.count``,
    all on the parameters' device, so that no update waits for the host
    and the train state's select keeps them on a skipped step."""

    def __init__(self, params, schedule: schedules.Schedule, *, lr: float,
                 alpha: float = 0.9, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        params = list(params)
        super().__init__(params, {"lr": lr, "alpha": alpha, "eps": eps,
                                  "weight_decay": weight_decay})
        self.schedule = schedule
        self.count = torch.zeros((), dtype=torch.float32,
                                 device=params[0].device)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScheduledRMSprop.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            nus = [self.state[p]["nu"] for p in params]
            decay = group["alpha"]
            torch._foreach_mul_(nus, decay)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - decay))
            scaling = torch._foreach_rsqrt(torch._foreach_add(
                nus, group["eps"]))
            updates = torch._foreach_mul(scaling, grads)
            lr = self.schedule(self.count) * group["lr_scale"]
            torch._foreach_sub_(params, torch._foreach_mul(updates, lr))
        self.count.add_(1.0)
        return None


def make_schedule(name: str, base_lr: float, sched_p: dict,
                  steps_per_epoch: int | None) -> schedules.Schedule:
    """The step-count schedule ``name`` (``step``, ``inception_poly``,
    ``linear_decay``) of a config; the first two count epochs in
    ``steps_per_epoch`` updates, ``linear_decay`` takes ``total_steps``
    and ``decay_start`` from ``sched_p``, as the JAX factory does."""
    if name == "linear_decay":
        return schedules.linear_decay(base_lr, sched_p["total_steps"],
                                      sched_p["decay_start"])
    if not steps_per_epoch:
        raise ValueError(
            f"scheduler {name!r} counts epochs in steps: pass "
            "steps_per_epoch")
    if name == "step":
        return schedules.step_decay(base_lr, steps_per_epoch,
                                    sched_p["step_size"], sched_p["gamma"])
    return schedules.inception_poly(base_lr, steps_per_epoch)


_COUNTED = ("step", "inception_poly", "linear_decay")


def make_optimizer(cfg: dict, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: int | None = None):
    """-> ``(optimizer, plateau_controller | None)`` from a
    training-config entry; a step-count schedule needs
    ``steps_per_epoch``."""
    opt = cfg["optimizer"]
    p = dict(cfg.get("optimizer_params", {}))
    base_lr = p.pop("lr")
    if opt not in ("sgd", "adam", "rmsprop"):
        raise ValueError(f"unknown optimizer {opt!r}")
    sched_name = cfg.get("scheduler")
    sched_p = cfg.get("scheduler_params", {})
    if sched_name not in (*_COUNTED, None, "constant", "plateau"):
        raise NotImplementedError(
            f"scheduler {sched_name!r} is not wired into the port's "
            f"optimizer yet: plateau, constant and {_COUNTED} are")
    if opt == "rmsprop":
        schedule = (make_schedule(sched_name, base_lr, sched_p,
                                  steps_per_epoch)
                    if sched_name in _COUNTED else lambda count: base_lr)
        optimizer = ScheduledRMSprop(
            params, schedule, lr=base_lr, alpha=p.get("alpha", 0.9),
            eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0))
        return _with_plateau(optimizer, base_lr, sched_name, sched_p)
    if opt == "adam":
        betas = (p.get("beta1", 0.9), p.get("beta2", 0.999))
        params = list(params)
        if sched_name in _COUNTED:
            optimizer = ScheduledAdam(
                params, make_schedule(sched_name, base_lr, sched_p,
                                      steps_per_epoch),
                lr=base_lr, betas=betas, eps=p.get("eps", 1e-8))
        else:
            optimizer = torch.optim.Adam(
                params, lr=base_lr, betas=betas, eps=p.get("eps", 1e-8),
                capturable=params[0].is_cuda)
        return _with_plateau(optimizer, base_lr, sched_name, sched_p)
    sgd = {"lr": base_lr, "momentum": p.get("momentum", 0.0),
           "weight_decay": p.get("weight_decay", 0.0)}
    if sched_name in _COUNTED:
        optimizer = ScheduledSGD(params, make_schedule(
            sched_name, base_lr, sched_p, steps_per_epoch), **sgd)
    else:
        optimizer = torch.optim.SGD(params, dampening=0.0, **sgd)
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
def set_update_count(optimizer: _Counted, count: int) -> None:
    """Set a scheduled optimizer's update count (a carried JAX state's
    schedule count)."""
    if not isinstance(optimizer, _Counted):
        raise TypeError(
            f"only a scheduled optimizer keeps an update count, not "
            f"{type(optimizer).__name__}")
    optimizer.count.fill_(float(count))
