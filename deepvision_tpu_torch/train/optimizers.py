"""Optimizer factory: a ``training_config`` entry -> a torch optimizer.

The twin of ``deepvision_tpu/train/optimizers.py`` for ``sgd``. The JAX
chain ``add_decayed_weights(wd) -> sgd(lr, momentum)`` adds the L2 term
to every gradient before the momentum trace, which is
``torch.optim.SGD(weight_decay=wd, momentum=m, dampening=0)``.

A plateau-scheduled config gets a :class:`PlateauController` whose scale
:func:`set_lr_scale` writes into the param groups (``lr = base_lr ·
lr_scale``) without rebuilding the optimizer, as the JAX package writes
``lr_scale`` into ``inject_hyperparams``. The step-count schedules
(``train/schedules.py``) come with the configs that use them (VGG,
Inception, CycleGAN) and raise here until then.

``rmsprop`` and ``adam`` raise (trap C7): optax's ``scale_by_rms`` adds
eps inside the square root, torch's ``RMSprop`` outside it, and with the
eps=1.0 of MobileNet's and Inception V3's configs the two differ.
"""

from __future__ import annotations

from typing import Iterable

import torch

from deepvision_tpu_torch.train import schedules

__all__ = ["make_optimizer", "set_lr_scale"]


def make_optimizer(cfg: dict, params: Iterable[torch.nn.Parameter]):
    """-> ``(optimizer, plateau_controller | None)`` from a
    training-config entry."""
    opt = cfg["optimizer"]
    p = dict(cfg.get("optimizer_params", {}))
    base_lr = p.pop("lr")
    if opt != "sgd":
        raise NotImplementedError(
            f"optimizer {opt!r} is not ported: only sgd is. rmsprop waits "
            "on trap C7 (optax's scale_by_rms puts eps inside the square "
            "root, torch's RMSprop outside; with eps=1.0 they differ), and "
            "adam comes with it")
    optimizer = torch.optim.SGD(
        params, lr=base_lr, momentum=p.get("momentum", 0.0),
        dampening=0.0, weight_decay=p.get("weight_decay", 0.0))
    for group in optimizer.param_groups:
        group["base_lr"] = base_lr
        group["lr_scale"] = 1.0

    sched_name = cfg.get("scheduler")
    sched_p = cfg.get("scheduler_params", {})
    if sched_name == "plateau":
        return optimizer, schedules.PlateauController(
            mode=sched_p.get("mode", "max"),
            factor=sched_p.get("factor", 0.1),
            patience=sched_p.get("patience", 10))
    if sched_name in (None, "constant"):
        return optimizer, None
    raise NotImplementedError(
        f"scheduler {sched_name!r} is not wired into the port's optimizer "
        "yet: only plateau and constant are")


def set_lr_scale(optimizer: torch.optim.Optimizer, scale: float) -> None:
    """Write the PlateauController's scale into every param group."""
    for group in optimizer.param_groups:
        group["lr_scale"] = float(scale)
        group["lr"] = group["base_lr"] * group["lr_scale"]
