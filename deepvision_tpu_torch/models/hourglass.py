"""The stacked hourglass for pose, the twin of
``deepvision_tpu/models/hourglass.py``.

- :class:`PreActBottleneck`: ``bn1``, ReLU, a 1x1 ``conv1`` to half the
  width, ``bn2``, ReLU, a 3x3 ``conv2``, ``bn3``, ReLU, a 1x1 ``conv3``
  back, plus the input (through a linear 1x1 ``proj`` where the width
  changes).
- :class:`HourglassModule`: the order-``order`` recursion: ``up0`` and
  ``up{i}`` at this resolution; below, a 2x2 max pool, ``low1_{i}``, the
  inner module (or ``bottom_{i}`` at order 1), ``low3_{i}``, upsampled 2x
  (nearest) and added.
- :class:`StackedHourglass` (``hourglass104``: 4 stacks, 1 residual, 16
  joints): the stem (a 7x7/2 ``stem_conv`` to 64, ``stem_bn``, ReLU,
  ``stem_res1`` to 128 projected, a 2x2 max pool, ``stem_res2``,
  ``stem_res3`` to the width projected: 256 px to 64), then per stack
  ``hg{s}``, ``post{s}_{i}``, the linear ``linear{s}_conv`` and
  ``linear{s}_bn`` with ReLU, and ``head{s}``, a 1x1 convolution to the
  joints in float32 on the float32 cast of its input; between stacks
  ``remap_feat{s}`` and ``remap_pred{s}`` (1x1) are added to the stack's
  input. It returns one ``(B, H/4, W/4, K)`` heatmap a stack.

Under a bf16 compute dtype the block internals run in bf16 while the
skip sums and the stack carrier stay float32. The JAX ``MixedBatchNorm``
takes its mixed path whenever its own ``dtype`` is not float32, so the
block's ``bn1``, which reads the float32 carrier, computes its statistics
on the carrier cast to bf16 and returns bf16. The port's layer picks its
path by its input's dtype, so the block casts the carrier to the compute
dtype before ``bn1`` (trap C21); the skip keeps the float32 carrier.
Every convolution takes its input cast to the compute dtype, as flax's
``nn.Conv`` does. The BatchNorms are :class:`~layers.MixedBatchNorm` at
momentum 0.9.

``remat="stack"`` rematerializes each :class:`HourglassModule` in
training, flax's ``nn.remat`` over it: the stack saves its input and
recomputes the recursion in the backward, and the recompute does not
update the BN running statistics again (trap C11, ``layers.remat``). The
JAX module's ``guard_thin_h`` acts only under a spatial mesh, which the
port does not have, and has no twin here. XLA's SAME pads the stem's
7x7/2 window (2, 3) on an even side (trap C2). Fresh weights follow the
JAX initializers: ``he_normal`` kernels, flax's default ``lecun_normal``
for the ``remap_*`` convolutions, zero biases. Parameter names are the
flax module paths (``hg0.inner3.low1_0.conv2.weight``).
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

__all__ = ["PreActBottleneck", "HourglassModule", "StackedHourglass"]


class PreActBottleneck(nn.Module):
    """The pre-activation bottleneck; returns the float32 carrier."""

    def __init__(self, in_features: int, features: int,
                 project: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = features
        self.dtype = dtype
        if project:
            self.proj = make_conv(in_features, f, (1, 1))
        self.bn1 = MixedBatchNorm(in_features)
        self.conv1 = make_conv(in_features, f // 2, (1, 1))
        self.bn2 = MixedBatchNorm(f // 2)
        self.conv2 = make_conv(f // 2, f // 2, (3, 3))
        self.bn3 = MixedBatchNorm(f // 2)
        self.conv3 = make_conv(f // 2, f, (1, 1))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.dtype
        identity = x
        if hasattr(self, "proj"):
            identity = same_conv(x, self.proj, d)
        # the JAX BN's mixed path by its own dtype (trap C21)
        y = torch.relu(self.bn1(x.to(d), train))
        y = torch.relu(self.bn2(same_conv(y, self.conv1, d), train))
        y = torch.relu(self.bn3(same_conv(y, self.conv2, d), train))
        y = same_conv(y, self.conv3, d)
        return identity.float() + y.float()


class HourglassModule(nn.Module):
    """The order-``order`` recursive hourglass at width ``features``."""

    def __init__(self, order: int, features: int = 256,
                 num_residual: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        f, r = features, num_residual
        self.order, self.num_residual = order, r

        def block():
            return PreActBottleneck(f, f, dtype=dtype)

        self.up0 = block()
        for i in range(r):
            setattr(self, f"up{i + 1}", block())
        for i in range(r):
            setattr(self, f"low1_{i}", block())
        if order > 1:
            setattr(self, f"inner{order - 1}",
                    HourglassModule(order - 1, f, r, dtype))
        else:
            for i in range(r):
                setattr(self, f"bottom_{i}", block())
        for i in range(r):
            setattr(self, f"low3_{i}", block())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        r = self.num_residual
        up = self.up0(x, train)
        for i in range(r):
            up = getattr(self, f"up{i + 1}")(up, train)
        low = layers.max_pool(x)
        for i in range(r):
            low = getattr(self, f"low1_{i}")(low, train)
        if self.order > 1:
            low = getattr(self, f"inner{self.order - 1}")(low, train)
        else:
            for i in range(r):
                low = getattr(self, f"bottom_{i}")(low, train)
        for i in range(r):
            low = getattr(self, f"low3_{i}")(low, train)
        return up + upsample2x(low)


class StackedHourglass(nn.Module):
    """``num_stacks`` hourglasses; one float32 heatmap ``(B, H/4, W/4,
    num_heatmaps)`` a stack (all supervised in training; serving reads
    the last). ``remat``: None or ``"stack"``."""

    kernel_init = staticmethod(layers.he_normal_)

    def __init__(self, num_stacks: int = 4, num_residual: int = 1,
                 num_heatmaps: int = 16, features: int = 256,
                 remat: str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if remat not in (None, "stack"):
            raise ValueError(f"unknown hourglass remat policy {remat!r} "
                             "(None or 'stack')")
        f = features
        self.num_stacks, self.num_residual = num_stacks, num_residual
        self.remat = remat
        self.dtype = dtype
        self.stem_conv = make_conv(3, 64, (7, 7), (2, 2))
        self.stem_bn = MixedBatchNorm(64)
        self.stem_res1 = PreActBottleneck(64, 128, project=True, dtype=dtype)
        self.stem_res2 = PreActBottleneck(128, 128, dtype=dtype)
        self.stem_res3 = PreActBottleneck(128, f, project=True, dtype=dtype)
        for s in range(num_stacks):
            setattr(self, f"hg{s}", HourglassModule(4, f, num_residual,
                                                    dtype))
            for i in range(num_residual):
                setattr(self, f"post{s}_{i}", PreActBottleneck(f, f,
                                                               dtype=dtype))
            setattr(self, f"linear{s}_conv", make_conv(f, f, (1, 1)))
            setattr(self, f"linear{s}_bn", MixedBatchNorm(f))
            setattr(self, f"head{s}", make_conv(f, num_heatmaps, (1, 1)))
            if s < num_stacks - 1:
                for name, width in ((f"remap_feat{s}", f),
                                    (f"remap_pred{s}", num_heatmaps)):
                    conv = make_conv(width, f, (1, 1))
                    conv.kernel_init = layers.lecun_normal_  # flax default
                    setattr(self, name, conv)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        del generator  # no dropout
        d = self.dtype
        x = torch.relu(self.stem_bn(same_conv(x, self.stem_conv, d), train))
        x = self.stem_res1(x, train)
        x = layers.max_pool(x)
        x = self.stem_res2(x, train)
        x = self.stem_res3(x, train)
        remat = self.remat if train and torch.is_grad_enabled() else None
        outputs = []
        for s in range(self.num_stacks):
            hg = getattr(self, f"hg{s}")
            y = (hg(x, train) if remat is None
                 else layers.remat(hg, x, train, policy=remat))
            for i in range(self.num_residual):
                y = getattr(self, f"post{s}_{i}")(y, train)
            y = same_conv(y, getattr(self, f"linear{s}_conv"), d)
            y = torch.relu(getattr(self, f"linear{s}_bn")(y, train))
            heat = same_conv(y, getattr(self, f"head{s}"))
            outputs.append(heat)
            if s < self.num_stacks - 1:
                re_x = same_conv(y, getattr(self, f"remap_feat{s}"), d)
                re_y = same_conv(heat, getattr(self, f"remap_pred{s}"), d)
                x = x + re_x + re_y
        return tuple(outputs)


@register("hourglass104", remat="stack")
def _hourglass104(num_heatmaps: int = 16, dtype=torch.float32,
                  remat: str | None = None, **_):
    """The MPII configuration: 4 stacks, 1 residual, 16 joints."""
    return StackedHourglass(num_stacks=4, num_residual=1,
                            num_heatmaps=num_heatmaps, remat=remat,
                            dtype=dtype)
