"""The train state: module, optimizer, step count and loss scale.

The twin of ``deepvision_tpu/train/state.py``. PyTorch updates in place,
so the state is one mutable object rather than a pytree returned anew:
the module's parameters are the float32 masters and its buffers the BN
running statistics (flax's ``batch_stats``), the optimizer holds the
momentum buffers (and, under a step-count schedule, the update count
the learning rate follows, ``optimizer.count``), ``step`` counts updates
on the host (non-finite steps included, as the JAX state counts them),
and ``loss_scale`` is the policy's :class:`DynamicLossScale` or None.

:meth:`TrainState.apply_gradients` with loss scaling runs the JAX
state's sequence: unscale -> one ``all_finite`` -> zero the non-finite
gradients -> update -> select. The select keeps the pre-step parameters,
optimizer state and BN statistics where the step was not finite; it is
a ``torch.where`` on the device, so the step never waits for the host.
The forward has already written the BN statistics by then, so the train
step takes their pre-step copies first
(:meth:`TrainState.copy_batch_stats`) and hands them to the select.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.core.precision import DynamicLossScale, all_finite

__all__ = ["TrainState", "guarded_step"]


@torch.no_grad()
def guarded_step(optimizer: torch.optim.Optimizer,
                 params: list[torch.Tensor], finite: torch.Tensor) -> None:
    """``optimizer.step()``, then where ``finite`` (a 0-d bool tensor on
    the device) is false the pre-step values back in place: ``params``
    (those with a gradient), every tensor of their optimizer state, and a
    step-count schedule's update count (``optimizer.count``). A
    ``torch.where`` on the device: no host sync."""
    before_p = [p.detach().clone() for p in params]
    before_s = [{k: v.clone() for k, v in optimizer.state[p].items()
                 if torch.is_tensor(v)} for p in params]
    # a step-count schedule's update count (ScheduledSGD, ScheduledAdam)
    count = getattr(optimizer, "count", None)
    before_count = None if count is None else count.clone()
    optimizer.step()
    for p, old, old_state in zip(params, before_p, before_s):
        p.copy_(torch.where(finite, p, old))
        for key, value in optimizer.state[p].items():
            if torch.is_tensor(value):
                # a buffer the step created holds zeros before it
                prev = old_state.get(key, torch.zeros_like(value))
                value.copy_(torch.where(finite, value, prev))
    if count is not None:
        count.copy_(torch.where(finite, count, before_count))


class TrainState:
    def __init__(self, module: nn.Module, optimizer: torch.optim.Optimizer,
                 *, loss_scale: DynamicLossScale | None = None):
        self.module = module
        self.optimizer = optimizer
        self.loss_scale = loss_scale
        self.step = 0

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss the backward runs on (the raw loss without a
        scaler)."""
        if self.loss_scale is None:
            return loss
        return self.loss_scale.scale_loss(loss)

    @torch.no_grad()
    def copy_batch_stats(self) -> list[torch.Tensor] | None:
        """Copies of the module's buffers (the BN running statistics)
        before a forward that updates them, for :meth:`apply_gradients`
        to restore on a non-finite step; None without loss scaling,
        where every step keeps its update."""
        if self.loss_scale is None:
            return None
        return [b.clone() for b in self.module.buffers()]

    @torch.no_grad()
    def apply_gradients(self, batch_stats: list[torch.Tensor] | None = None
                        ) -> None:
        """One update from the parameters' ``.grad`` (scaled by the loss
        scale, if any). ``batch_stats``: the buffers as they were before
        this step's forward (:meth:`copy_batch_stats`), restored where the
        step is not finite."""
        self.step += 1
        ls = self.loss_scale
        if ls is None:
            self.optimizer.step()
            return
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        ls.unscale_(grads)
        finite = all_finite(grads).to(ls.scale.device)
        ls.adjust(finite)
        # zeroed first, so that the update math cannot turn the optimizer
        # state into NaN before the select (inf * 0)
        for g in grads:
            g.masked_fill_(~finite, 0.0)
        guarded_step(self.optimizer, params, finite)
        for b, old in zip(self.module.buffers(), batch_stats or ()):
            b.copy_(torch.where(finite, b, old))

    def state_dict(self) -> dict:
        return {"model": self.module.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "loss_scale": (None if self.loss_scale is None
                               else self.loss_scale.state_dict())}

    def load_state_dict(self, d: dict) -> None:
        self.module.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.step = int(d["step"])
        if (d["loss_scale"] is None) != (self.loss_scale is None):
            raise ValueError(
                "checkpoint and train state disagree on loss scaling "
                f"(checkpoint: {d['loss_scale'] is not None}, state: "
                f"{self.loss_scale is not None})")
        if self.loss_scale is not None:
            self.loss_scale.load_state_dict(d["loss_scale"])
