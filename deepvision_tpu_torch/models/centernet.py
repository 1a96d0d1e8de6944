"""CenterNet (objects as points) on the large hourglass, the twin of
``deepvision_tpu/models/centernet.py``.

- :class:`ResidualBlock`: a 1x1 ``conv1`` (carrying the stride), ``bn1``,
  ReLU, a 3x3 ``conv2``, ``bn2``, plus the input (through a 1x1 ``proj``
  and ``proj_bn`` where the width or the stride changes), then ReLU.
- :class:`LargeHourglass`: the order-``order`` module with the per-order
  widths :data:`ORDER_FILTERS` and depths :data:`ORDER_RESIDUAL`: the
  ``up{i}`` blocks at this resolution, and below a stride-2 ``down``
  block, ``low1_{i}``, the inner hourglass (or the ``bottom_{i}`` blocks
  at order 1), ``low3_{i}`` and ``low3_out``, upsampled 2x (nearest) and
  added.
- :class:`DetectionBranch`: a 3x3 ``conv1`` (256) with ReLU, then
  ``out``, a 3x3 convolution in float32 on the float32 cast of its input.
- :class:`CenterNet` (``centernet``): the stem (a 7x7/2 ``stem_conv``
  to 128, ``stem_bn``, ReLU, ``stem_res`` to 256 at stride 2), then per
  stack ``hg{s}``, ``post{s}_conv`` and ``post{s}_bn`` with ReLU, and
  the ``head{s}_heat``, ``head{s}_wh`` and ``head{s}_off`` branches;
  between stacks the 1x1 ``remap_feat{s}`` and ``remap_prev{s}`` with
  their BNs, summed, ReLU, and ``remap_res{s}``. It returns one
  ``(heatmap logits, wh, offset)`` a stack, at a quarter of the input.

Under a bf16 compute dtype the skip sums and the cross-stack carrier stay
float32 (the JAX model's promoted ``hd``), and every convolution takes
its input cast to the compute dtype, as flax's ``nn.Conv`` casts it. The
BatchNorms are :class:`~layers.MixedBatchNorm` with flax's default
momentum 0.99 (the JAX model gives none). XLA's SAME pads the stem's
7x7/2 window (2, 3) on an even side (trap C2); every convolution pads as
:func:`~layers.same_padding` says. Fresh weights follow the JAX
initializers: ``he_normal`` kernels, but flax's default ``lecun_normal``
for the ``remap_*`` convolutions, zero biases but -2.19 for the heat
branches' ``out`` (a prior probability near 0.1). Parameter names are
the flax module paths (``hg0.inner4.down.conv1.weight``).
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.layers import (
    MixedBatchNorm,
    make_conv,
    same_conv,
    upsample2x,
)
from deepvision_tpu_torch.models.registry import register

__all__ = ["ORDER_FILTERS", "ORDER_RESIDUAL", "BN_MOMENTUM",
           "ResidualBlock", "LargeHourglass", "DetectionBranch", "CenterNet"]

# per order: (width at this order, width one level down) and (blocks at
# this order, blocks one level down), the JAX model's tables
ORDER_FILTERS = {5: (256, 256), 4: (256, 384), 3: (384, 384),
                 2: (384, 384), 1: (384, 512)}
ORDER_RESIDUAL = {5: (2, 2), 4: (2, 2), 3: (2, 2), 2: (2, 2), 1: (2, 4)}
HEAT_BIAS = -2.19
BN_MOMENTUM = 0.99  # flax's nn.BatchNorm default


def _bn(features: int) -> MixedBatchNorm:
    return MixedBatchNorm(features, momentum=BN_MOMENTUM)


def _lecun(conv: nn.Conv2d) -> nn.Conv2d:
    """``conv`` with flax's default kernel init (``init_weights`` reads
    the layer's own ``kernel_init``)."""
    conv.kernel_init = layers.lecun_normal_
    return conv


class ResidualBlock(nn.Module):
    """The post-activation residual; returns the float32 carrier."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = (strides, strides)
        self.dtype = dtype
        if in_features != features or strides > 1:
            self.proj = make_conv(in_features, features, (1, 1), s,
                                  bias=False)
            self.proj_bn = _bn(features)
        self.conv1 = make_conv(in_features, features, (1, 1), s, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = make_conv(features, features, (3, 3), bias=False)
        self.bn2 = _bn(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.dtype
        identity = x
        if hasattr(self, "proj"):
            identity = self.proj_bn(same_conv(x, self.proj, d), train)
        y = torch.relu(self.bn1(same_conv(x, self.conv1, d), train))
        y = self.bn2(same_conv(y, self.conv2, d), train)
        return torch.relu(identity.float() + y.float())


class LargeHourglass(nn.Module):
    """The order-``order`` hourglass; its input and output have
    ``ORDER_FILTERS[order][0]`` channels."""

    def __init__(self, order: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.order = order
        curr_f, next_f = ORDER_FILTERS[order]
        curr_r, next_r = ORDER_RESIDUAL[order]
        self.curr_r, self.next_r = curr_r, next_r
        for i in range(curr_r):
            setattr(self, f"up{i}", ResidualBlock(curr_f, curr_f,
                                                  dtype=dtype))
        self.down = ResidualBlock(curr_f, next_f, strides=2, dtype=dtype)
        for i in range(curr_r - 1):
            setattr(self, f"low1_{i}", ResidualBlock(next_f, next_f,
                                                     dtype=dtype))
        if order > 1:
            setattr(self, f"inner{order - 1}",
                    LargeHourglass(order - 1, dtype=dtype))
        else:
            for i in range(next_r):
                setattr(self, f"bottom_{i}", ResidualBlock(next_f, next_f,
                                                           dtype=dtype))
        for i in range(curr_r - 1):
            setattr(self, f"low3_{i}", ResidualBlock(next_f, next_f,
                                                     dtype=dtype))
        self.low3_out = ResidualBlock(next_f, curr_f, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        up = x
        for i in range(self.curr_r):
            up = getattr(self, f"up{i}")(up, train)
        low = self.down(x, train)
        for i in range(self.curr_r - 1):
            low = getattr(self, f"low1_{i}")(low, train)
        if self.order > 1:
            low = getattr(self, f"inner{self.order - 1}")(low, train)
        else:
            for i in range(self.next_r):
                low = getattr(self, f"bottom_{i}")(low, train)
        for i in range(self.curr_r - 1):
            low = getattr(self, f"low3_{i}")(low, train)
        return up + upsample2x(self.low3_out(low, train))


class DetectionBranch(nn.Module):
    """3x3 ``conv1`` (256) + ReLU, then ``out`` in float32; no BN."""

    def __init__(self, out_features: int, bias_init: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = make_conv(256, 256, (3, 3))
        self.out = make_conv(256, out_features, (3, 3))
        self.out.bias_init = bias_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(same_conv(x, self.conv1, self.dtype))
        return same_conv(y, self.out)


class CenterNet(nn.Module):
    """``num_stacks`` large hourglasses; per stack ``(heatmap logits (B,
    H/4, W/4, C), wh (B, H/4, W/4, 2), offset (B, H/4, W/4, 2))``, all
    float32."""

    kernel_init = staticmethod(layers.he_normal_)

    def __init__(self, num_classes: int = 80, num_stacks: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stacks = num_stacks
        self.dtype = dtype
        self.stem_conv = make_conv(3, 128, (7, 7), (2, 2), bias=False)
        self.stem_bn = _bn(128)
        self.stem_res = ResidualBlock(128, 256, strides=2, dtype=dtype)
        for s in range(num_stacks):
            setattr(self, f"hg{s}", LargeHourglass(5, dtype=dtype))
            setattr(self, f"post{s}_conv", make_conv(256, 256, (3, 3)))
            setattr(self, f"post{s}_bn", _bn(256))
            setattr(self, f"head{s}_heat", DetectionBranch(
                num_classes, HEAT_BIAS, dtype=dtype))
            setattr(self, f"head{s}_wh", DetectionBranch(2, dtype=dtype))
            setattr(self, f"head{s}_off", DetectionBranch(2, dtype=dtype))
            if s < num_stacks - 1:
                for name in (f"remap_feat{s}", f"remap_prev{s}"):
                    setattr(self, name, _lecun(make_conv(256, 256, (1, 1))))
                    setattr(self, f"{name}_bn", _bn(256))
                setattr(self, f"remap_res{s}", ResidualBlock(
                    256, 256, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        del generator  # no dropout
        d = self.dtype
        x = torch.relu(self.stem_bn(same_conv(x, self.stem_conv, d), train))
        inter = self.stem_res(x, train)
        outputs = []
        for s in range(self.num_stacks):
            y = getattr(self, f"hg{s}")(inter, train)
            y = same_conv(y, getattr(self, f"post{s}_conv"), d)
            y = torch.relu(getattr(self, f"post{s}_bn")(y, train))
            outputs.append(tuple(getattr(self, f"head{s}_{k}")(y)
                                 for k in ("heat", "wh", "off")))
            if s < self.num_stacks - 1:
                x1 = getattr(self, f"remap_feat{s}_bn")(
                    same_conv(y, getattr(self, f"remap_feat{s}"), d), train)
                x2 = getattr(self, f"remap_prev{s}_bn")(
                    same_conv(inter, getattr(self, f"remap_prev{s}"), d),
                    train)
                inter = torch.relu(x1.float() + x2.float())
                inter = getattr(self, f"remap_res{s}")(inter, train)
        return tuple(outputs)


@register("centernet")
def _centernet(num_classes: int = 80, dtype=torch.float32, num_stacks=2,
               **_):
    return CenterNet(num_classes=num_classes, num_stacks=num_stacks,
                     dtype=dtype)
