"""The numerics policy: compute dtype, float32 masters, dynamic loss scaling.

The twin of ``deepvision_tpu/core/precision.py``:

- **float32 master weights**: parameters and optimizer state are
  float32; the models cast parameters to the compute dtype at use
  (``models/layers.py``), so gradients reach the masters as float32.
  No module is ever cast as a whole: BN's running statistics and affine
  stay float32 too, and ``MixedBatchNorm`` casts its folded channel
  affine to the compute dtype at use;
- **bf16 activations**: the model's ``dtype`` is the policy's
  ``compute_dtype``; losses and softmax stay float32;
- **dynamic loss scaling** (:class:`DynamicLossScale`): the loss is
  multiplied by the scale before the backward and the gradients divided
  by it before the update; a step with a non-finite gradient leaves the
  masters and the optimizer state untouched and halves the scale
  (``train/state.py``). The scale's state lives on the device, so that
  the decision costs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

from deepvision_tpu_torch.device import resolve_device

__all__ = ["MixedPolicy", "DynamicLossScale", "all_finite", "get_policy",
           "precision_metrics", "PRECISION_NAMES"]

GROWTH_FACTOR = 2.0
BACKOFF_FACTOR = 0.5


class DynamicLossScale:
    """The loss-scale state: ``scale`` (float32), ``good_steps`` (int32,
    the finite-gradient streak) and ``last_finite`` (1.0/0.0, the verdict
    of the last :meth:`adjust`), all 0-d tensors on ``device``: the card
    unless the caller asks for the CPU (``resolve_device``).

    ``adjust(finite)``: ``growth_interval`` consecutive finite steps
    double the scale (capped at ``max_scale``); a non-finite one halves
    it (floored at ``min_scale``) and resets the streak."""

    def __init__(self, scale: float = float(2 ** 15), *,
                 device: torch.device | str | None = None,
                 growth_interval: int = 200, min_scale: float = 1.0,
                 max_scale: float = float(2 ** 24)):
        device = resolve_device(device)
        self.scale = torch.tensor(scale, dtype=torch.float32, device=device)
        self.good_steps = torch.zeros((), dtype=torch.int32, device=device)
        self.last_finite = torch.ones((), dtype=torch.float32, device=device)
        self.growth_interval = growth_interval
        self.min_scale = min_scale
        self.max_scale = max_scale

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale.to(loss.dtype)

    @torch.no_grad()
    def unscale_(self, grads: Iterable[torch.Tensor]) -> None:
        """Divide the scale back out of float32 gradients, in place."""
        inv = 1.0 / self.scale
        for g in grads:
            g.mul_(inv)

    @torch.no_grad()
    def adjust(self, finite: torch.Tensor) -> None:
        grew = self.good_steps + 1 >= self.growth_interval
        grown = torch.where(
            grew, torch.clamp(self.scale * GROWTH_FACTOR,
                              max=self.max_scale), self.scale)
        backed = torch.clamp(self.scale * BACKOFF_FACTOR,
                             min=self.min_scale)
        self.scale = torch.where(finite, grown, backed)
        self.good_steps = torch.where(finite & ~grew, self.good_steps + 1,
                                      torch.zeros_like(self.good_steps))
        self.last_finite = finite.to(torch.float32)

    def state_dict(self) -> dict:
        return {"scale": self.scale, "good_steps": self.good_steps,
                "last_finite": self.last_finite}

    def load_state_dict(self, d: dict) -> None:
        dev = self.scale.device
        self.scale = d["scale"].to(dev, torch.float32)
        self.good_steps = d["good_steps"].to(dev, torch.int32)
        self.last_finite = d["last_finite"].to(dev, torch.float32)


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-d bool tensor: every value of every floating tensor is finite.
    True for none."""
    checks = [t.isfinite().all() for t in tensors if t.is_floating_point()]
    if not checks:
        return torch.tensor(True)
    return torch.stack(checks).all()


@dataclasses.dataclass(frozen=True)
class MixedPolicy:
    """The compute dtype (masters and reductions are always float32) and
    whether the loss is scaled; build one with :func:`get_policy`."""

    compute_dtype: torch.dtype = torch.bfloat16
    loss_scaling: bool = False

    @property
    def name(self) -> str:
        if self.compute_dtype == torch.float32:
            return "f32"
        return "bf16_scaled" if self.loss_scaling else "bf16"

    def make_loss_scale(self, device: torch.device | str | None = None
                        ) -> DynamicLossScale | None:
        """A fresh :class:`DynamicLossScale` (2^15, doubling after 200
        clean steps) on ``device`` (the card unless the caller asks for
        the CPU), or None without scaling."""
        if not self.loss_scaling:
            return None
        return DynamicLossScale(device=device)


_F32 = MixedPolicy(compute_dtype=torch.float32)
_BF16 = MixedPolicy()
_BF16_SCALED = MixedPolicy(loss_scaling=True)

_ALIASES = {
    "bf16": _BF16, "bfloat16": _BF16, "mixed": _BF16,
    "f32": _F32, "float32": _F32, "full": _F32,
    "bf16_scaled": _BF16_SCALED, "bfloat16_scaled": _BF16_SCALED,
    "mixed_scaled": _BF16_SCALED,
}

PRECISION_NAMES = ("bf16", "bf16_scaled", "f32")


def get_policy(name: str = "bf16") -> MixedPolicy:
    """``bf16``, ``bf16_scaled`` (bf16 + dynamic loss scaling) or
    ``f32``; aliases as the JAX package's."""
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {name!r} "
            f"(known: {sorted(set(_ALIASES))})") from None


def precision_metrics(state) -> dict:
    """The ``mp_*`` step metrics (device tensors) when ``state`` scales
    its loss, ``{}`` otherwise."""
    ls = getattr(state, "loss_scale", None)
    if ls is None:
        return {}
    return {"mp_loss_scale": ls.scale, "mp_grads_finite": ls.last_finite}
