"""The ResNet family, the twins of ``deepvision_tpu/models/resnet.py``.

- ``resnet34`` (:class:`BasicBlock`, stages (3, 4, 6, 3)) and
  ``resnet50`` (:class:`BottleneckBlock`, the same stages), V1. Every
  convolution is a :class:`~layers.ConvBN` (``he_normal`` kernels,
  ``MixedBatchNorm``); the last of a block (``conv2`` of a basic block,
  ``conv3`` of a bottleneck) and the projection ``proj`` have no ReLU,
  which follows the residual sum. A bottleneck puts its stride on the
  1x1 ``conv1``, as the JAX code does (trap C3; its docstring's "stride
  on the 3x3" is wrong). The first block of every stage projects its
  residual: always for a bottleneck, and for a basic block under
  ``always_project`` (the default, the reference's quirk).
- ``resnet50v2`` (:class:`PreActBottleneck`, :class:`ResNetV2`), the
  pre-activation variant: a biased stem convolution without BN, flax's
  stock float32 BatchNorm at eps 1.001e-5 before each convolution
  (trap C8), unbiased ``conv1`` and ``conv2``, biased ``conv3`` and
  ``proj``, strides on the last block of stages 1-3 (a strided block
  without a projection takes a 1x1 max pool of its input as its
  residual), and ``post_bn`` and ReLU before the head.

The stem is the 7x7/2 convolution with pads (3, 3), then the 3x3/2 max
pool with pads (1, 1): both symmetric, so both are the op's own padding.
``s2d_stem`` (the training config's ``model_kwargs``) names the JAX
package's space-to-depth rewrite of that convolution, which computes
the same numbers over the same ``[7, 7, 3, 64]`` kernel; here it keeps
the plain convolution, puts flax's stock :class:`~layers.BatchNorm` in
the compute dtype on the stem, as the JAX ``S2DStem`` does, and refuses
an odd height or width, as the JAX rewrite must. The state dict is the
same with and without it. The head is a global average pool accumulated
in float32 and ``fc`` in float32.

Conventions as in ``inception.py``: NHWC activations; float32
parameters cast to ``dtype`` at use; parameter names are flax's module
paths (``stem.conv.weight``, ``stage2_block1.proj.bn.scale``,
``stage1_block1.preact_bn.mean``, ``fc``).

``remat`` (V1) rematerializes every block in training, as flax's
``nn.remat`` over the JAX block: ``"block"`` saves nothing inside a
block, ``"conv"`` only its convolutions' outputs
(:func:`~layers.remat`); BatchNorm's running statistics are updated
once, in the forward (trap C11). Parameter names do not change.
``resnet152`` declares ``"block"`` in the registry, which its training
config folds into ``model_kwargs``.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.layers import ConvBN
from deepvision_tpu_torch.models.registry import register

__all__ = ["S2DStem", "BasicBlock", "BottleneckBlock", "ResNet",
           "PreActBottleneck", "ResNetV2"]

_PAD1 = [(1, 1), (1, 1)]
# the JAX ResNet's remat policies (layers.REMAT_POLICIES' "stack" is the
# hourglass's)
RESNET_REMAT = ("block", "conv")


class S2DStem(nn.Module):
    """The JAX ``S2DStem``'s numbers under its names: the 7x7/2
    convolution (``conv``, no bias, pads (3, 3)), flax's stock
    :class:`~layers.BatchNorm` (``bn``) with its output in the compute
    dtype, ReLU. Even heights and widths only, as the space-to-depth
    rewrite needs."""

    kernel_init = staticmethod(layers.he_normal_)

    def __init__(self, features: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = layers.make_conv(3, features, (7, 7), (2, 2),
                                     [(3, 3), (3, 3)], bias=False)
        self.bn = layers.BatchNorm(features, 0.9, 1e-5, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            raise ValueError(f"s2d stem needs even H/W, got {(h, w)}")
        x = layers.conv2d(x.to(self.dtype), self.conv, dtype=self.dtype)
        return torch.relu(self.bn(x, train))


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34); the stride on ``conv1``."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 project: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = (strides, strides)
        self.conv1 = ConvBN(in_features, features, (3, 3), s, _PAD1,
                            dtype=dtype)
        self.conv2 = ConvBN(features, features, (3, 3), act=None,
                            dtype=dtype)
        self.proj = (ConvBN(in_features, features, (1, 1), s, act=None,
                            dtype=dtype) if project else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv2(self.conv1(x, train), train)
        residual = x if self.proj is None else self.proj(x, train)
        return torch.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 -> 1x1 expand (x4); the stride on the 1x1
    ``conv1`` (trap C3)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 project: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = (strides, strides)
        out = features * self.expansion
        self.conv1 = ConvBN(in_features, features, (1, 1), s, dtype=dtype)
        self.conv2 = ConvBN(features, features, (3, 3), padding=_PAD1,
                            dtype=dtype)
        self.conv3 = ConvBN(features, out, (1, 1), act=None, dtype=dtype)
        self.proj = (ConvBN(in_features, out, (1, 1), s, act=None,
                            dtype=dtype) if project else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x, train), train), train)
        residual = x if self.proj is None else self.proj(x, train)
        return torch.relu(y + residual)


class ResNet(nn.Module):
    """ResNet V1: stem, max pool, ``stage{i}_block{j}`` blocks, GAP,
    ``fc``. ``remat``: None, ``"block"`` or ``"conv"`` (each block
    rematerialized in training, :func:`~layers.remat`)."""

    # he_normal for fc too; every ConvBN declares it as well
    kernel_init = staticmethod(layers.he_normal_)

    def __init__(self, stage_sizes, block: type = BottleneckBlock,
                 num_classes: int = 1000, always_project: bool = True,
                 s2d_stem: bool = False,
                 remat: str | None = None,
                 dtype: torch.dtype = torch.float32,
                 input_size: int | None = None):
        super().__init__()
        del input_size  # any size: the head pools globally
        if remat is not None and remat not in RESNET_REMAT:
            raise ValueError(f"unknown remat {remat!r} for ResNet; None or "
                             f"one of {RESNET_REMAT}")
        self.remat = remat
        self.dtype = dtype
        if s2d_stem:
            self.stem = S2DStem(64, dtype=dtype)
        else:
            self.stem = ConvBN(3, 64, (7, 7), (2, 2), [(3, 3), (3, 3)],
                               dtype=dtype)
        in_features = 64
        for i, n_blocks in enumerate(stage_sizes):
            feats = 64 * 2 ** i
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                project = j == 0 and (always_project or strides != 1
                                      or block is BottleneckBlock)
                self.add_module(f"stage{i + 1}_block{j + 1}", block(
                    in_features, feats, strides, project, dtype))
                in_features = feats * block.expansion
        self.blocks = [n for n, _ in self.named_children()
                       if n.startswith("stage")]
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC images ``(B, H, W, 3)`` -> float32 logits ``(B,
        num_classes)``. ``train`` normalizes BN by the batch and updates
        its running statistics; ``generator`` is unused (no dropout)."""
        del generator
        x = self.stem(x.to(self.dtype), train)
        x = layers.max_pool(x, (3, 3), (2, 2), _PAD1)
        remat = self.remat if train and torch.is_grad_enabled() else None
        for name in self.blocks:
            block = getattr(self, name)
            if remat is None:
                x = block(x, train)
            else:
                x = layers.remat(block, x, train, policy=remat)
        x = layers.global_avg_pool(x)
        return layers.dense(x.float(), self.fc)


class PreActBottleneck(nn.Module):
    """The V2 pre-activation bottleneck: stock float32 BN and ReLU
    before each convolution, the stride on ``conv2``. Each convolution
    casts its float32 input to the compute dtype, as flax's ``nn.Conv``
    does."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 project: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()

        def bn(n):
            return layers.BatchNorm(n, 0.9, 1.001e-5, dtype=torch.float32)

        out = features * 4
        self.strides = strides
        self.dtype = dtype
        self.preact_bn = bn(in_features)
        self.proj = (layers.make_conv(in_features, out, (1, 1),
                                      (strides, strides)) if project else None)
        self.conv1 = layers.make_conv(in_features, features, (1, 1),
                                      bias=False)
        self.bn1 = bn(features)
        self.conv2 = layers.make_conv(features, features, (3, 3),
                                      (strides, strides), _PAD1, bias=False)
        self.bn2 = bn(features)
        self.conv3 = layers.make_conv(features, out, (1, 1))

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return layers.conv2d(x.to(self.dtype), conv, dtype=self.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        pre = torch.relu(self.preact_bn(x, train))
        if self.proj is not None:
            residual = self._conv(self.proj, pre)
        elif self.strides > 1:
            residual = layers.max_pool(x, (1, 1), (self.strides,) * 2)
        else:
            residual = x
        y = torch.relu(self.bn1(self._conv(self.conv1, pre), train))
        y = torch.relu(self.bn2(self._conv(self.conv2, y), train))
        return self._conv(self.conv3, y) + residual


class ResNetV2(nn.Module):
    """Pre-activation ResNet (the keras-applications layout): biased
    stem convolution, max pool, ``stage{i}_block{j}`` blocks with the
    stride on the last block of each stage but the last, ``post_bn``,
    ReLU, GAP, ``fc``."""

    kernel_init = staticmethod(layers.he_normal_)

    def __init__(self, stage_sizes, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32,
                 input_size: int | None = None):
        super().__init__()
        del input_size  # any size: the head pools globally
        self.dtype = dtype
        self.stem = layers.make_conv(3, 64, (7, 7), (2, 2), [(3, 3), (3, 3)])
        in_features = 64
        for i, n_blocks in enumerate(stage_sizes):
            feats = 64 * 2 ** i
            for j in range(n_blocks):
                last = j == n_blocks - 1
                strides = 2 if last and i < len(stage_sizes) - 1 else 1
                self.add_module(f"stage{i + 1}_block{j + 1}", PreActBottleneck(
                    in_features, feats, strides, j == 0, dtype))
                in_features = feats * 4
        self.blocks = [n for n, _ in self.named_children()
                       if n.startswith("stage")]
        self.post_bn = layers.BatchNorm(in_features, 0.9, 1.001e-5,
                                        dtype=torch.float32)
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """As :meth:`ResNet.forward`."""
        del generator
        x = layers.conv2d(x.to(self.dtype), self.stem, dtype=self.dtype)
        x = layers.max_pool(x, (3, 3), (2, 2), _PAD1)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = torch.relu(self.post_bn(x, train))
        x = layers.global_avg_pool(x)
        return layers.dense(x.float(), self.fc)


@register("resnet34")
def _resnet34(**kw):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BasicBlock, **kw)


@register("resnet50")
def _resnet50(**kw):
    return ResNet(stage_sizes=(3, 4, 6, 3), block=BottleneckBlock, **kw)


@register("resnet152", remat="block")
def _resnet152(**kw):
    # the registry's default remat: at 36 stage-3 blocks the saved
    # activations dominate the step's memory
    return ResNet(stage_sizes=(3, 8, 36, 3), block=BottleneckBlock, **kw)


@register("resnet50v2")
def _resnet50v2(**kw):
    return ResNetV2(stage_sizes=(3, 4, 6, 3), **kw)
