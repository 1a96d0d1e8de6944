"""The train state: module, optimizer, step count and loss scale.

The twin of ``deepvision_tpu/train/state.py``. PyTorch updates in place,
so the state is one mutable object rather than a pytree returned anew:
the module's parameters are the float32 masters, the optimizer holds the
momentum buffers, ``step`` counts updates on the host (non-finite steps
included, as the JAX state counts them), and ``loss_scale`` is the
policy's :class:`DynamicLossScale` or None.

:meth:`TrainState.apply_gradients` with loss scaling runs the JAX
state's sequence: unscale -> one ``all_finite`` -> zero the non-finite
gradients -> update -> select. The select keeps the pre-step parameters
and optimizer state where the step was not finite; it is a
``torch.where`` on the device, so the step never waits for the host.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.core.precision import DynamicLossScale, all_finite

__all__ = ["TrainState"]


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
    def apply_gradients(self) -> None:
        """One update from the parameters' ``.grad`` (scaled by the loss
        scale, if any)."""
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
        before_p = [p.detach().clone() for p in params]
        before_s = [{k: v.clone() for k, v in self.optimizer.state[p].items()
                     if torch.is_tensor(v)} for p in params]
        self.optimizer.step()
        for p, old, old_state in zip(params, before_p, before_s):
            p.copy_(torch.where(finite, p, old))
            for key, value in self.optimizer.state[p].items():
                if torch.is_tensor(value):
                    # a buffer the step created holds zeros before it
                    prev = old_state.get(key, torch.zeros_like(value))
                    value.copy_(torch.where(finite, value, prev))

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
