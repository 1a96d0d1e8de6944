"""Inception V1 (GoogLeNet), the twin of ``InceptionV1`` in
``deepvision_tpu/models/inception.py``.

- ``inception1`` (``bn=True``, the registry's default): the BN-modernized
  variant. Every convolution is a :class:`~layers.ConvBN` (``he_normal``
  kernels, ``MixedBatchNorm``, ReLU), and the 7x7/2 stem pads by XLA's
  ``"SAME"``: (2, 3) at 224.
- ``inception1_ref`` (``bn=False``): the reference's architecture.
  Convolutions are :class:`BasicConv` (conv + bias + ReLU), the stem pads
  (3, 3) as torch does, and two LRNs follow pool1 (n=64 on 64 channels)
  and ``stem3`` (n=192 on 192 channels), alpha 1e-4, beta 0.75, k=1. A
  CUDA tensor runs them on the hand-written kernels (``ops/lrn.py``).

Both have nine inception modules (1x1 | 1x1->3x3 | 1x1->5x5 | 3x3/1 max
pool->1x1, concatenated on channels) and four stride-2 3x3 max pools
padded by XLA's ``"SAME"`` with -inf, (0, 1) at 112, 56, 28 and 14
(trap C2). Two auxiliary classifiers run only in training with
``aux_heads``; the forward then returns ``(main, aux1, aux2)``, and the
train step weights the aux losses 0.3. The head is a global average
pool, dropout 0.4 and ``fc`` in float32.

Conventions as in ``alexnet.py``: NHWC activations; float32 parameters
cast to ``dtype`` at use; an NHWC flatten before each aux head's ``fc1``
(trap C5), sized from ``input_size`` (2048 at 224); dropout masks from
the generator the train step passes (``dropout_rate`` on the model and
on each aux head, 0 turns it off); the ``lrn`` attribute, which an
instance may set to the plain version. Parameter names are flax's module
paths (``stem1.conv``, ``i3a.b3r.bn.scale``, ``aux1.fc1``, ``fc``), and
BN statistics its ``batch_stats`` (``i3a.b1.bn.mean``).

Inception V3 is not ported: its config trains with RMSprop (trap C7).
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.registry import register
from deepvision_tpu_torch.ops.lrn import local_response_norm

__all__ = ["BasicConv", "InceptionModule", "AuxiliaryClassifier",
           "InceptionV1"]


class BasicConv(nn.Module):
    """The reference's ``BasicConv2d``: conv with bias, then ReLU, no BN.
    Its child is named ``conv``, as :class:`~layers.ConvBN`'s."""

    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int] = (1, 1),
                 strides: tuple[int, int] = (1, 1),
                 padding: layers.Padding = "SAME",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = layers.make_conv(in_features, features, kernel, strides,
                                     padding)
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train
        pads = layers.conv_padding(x, self.conv, self.padding)
        return torch.relu(layers.conv2d(x, self.conv, pads, self.dtype))


def _block(bn: bool):
    return layers.ConvBN if bn else BasicConv


class InceptionModule(nn.Module):
    """1x1 | 1x1->3x3 | 1x1->5x5 | 3x3/1 max pool->1x1, concatenated."""

    def __init__(self, in_features: int, c1: int, c3r: int, c3: int,
                 c5r: int, c5: int, cp: int, dtype: torch.dtype, bn: bool):
        super().__init__()
        conv = _block(bn)
        self.b1 = conv(in_features, c1, (1, 1), dtype=dtype)
        self.b3r = conv(in_features, c3r, (1, 1), dtype=dtype)
        self.b3 = conv(c3r, c3, (3, 3), dtype=dtype)
        self.b5r = conv(in_features, c5r, (1, 1), dtype=dtype)
        self.b5 = conv(c5r, c5, (5, 5), dtype=dtype)
        self.bp = conv(in_features, cp, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b1 = self.b1(x, train)
        b3 = self.b3(self.b3r(x, train), train)
        b5 = self.b5(self.b5r(x, train), train)
        bp = layers.max_pool(x, (3, 3), (1, 1), [(1, 1), (1, 1)])
        return torch.cat([b1, b3, b5, self.bp(bp, train)], dim=-1)


class AuxiliaryClassifier(nn.Module):
    """avg pool 5/3 VALID -> 1x1 to 128 (``proj``) -> NHWC flatten ->
    ``fc1`` 1024 + ReLU -> dropout 0.7 -> ``fc2`` in float32."""

    def __init__(self, in_features: int, side: int, num_classes: int,
                 dtype: torch.dtype, bn: bool):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = 0.7
        self.proj = _block(bn)(in_features, 128, (1, 1), dtype=dtype)
        self.fc1 = nn.Linear(side * side * 128, 1024)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, train: bool,
                generator: torch.Generator | None) -> torch.Tensor:
        x = layers.avg_pool(x, (5, 5), (3, 3))
        x = self.proj(x, train)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        x = torch.relu(layers.dense(x, self.fc1, self.dtype))
        x = layers.dropout(x, self.dropout_rate, train, generator)
        return layers.dense(x.float(), self.fc2)


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool, XLA's SAME pads."""
    return layers.max_pool(x, (3, 3), (2, 2),
                           layers.same_padding(x.shape[1:3], (3, 3), (2, 2)))


class InceptionV1(nn.Module):
    # the LRN the forward calls; an instance may set the plain version
    # here to run the same weights without the kernel
    lrn = staticmethod(local_response_norm)
    # flax's default kernel init, for the BasicConvs and Dense layers;
    # ConvBN declares its own
    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, num_classes: int = 1000, input_size: int = 224,
                 aux_heads: bool = True, bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.aux_heads = aux_heads
        self.bn = bn
        self.dtype = dtype
        self.dropout_rate = 0.4
        conv = _block(bn)
        # torch pads the 7x7/2 stem (3, 3); XLA's SAME pads (2, 3) at 224
        self.stem1 = conv(3, 64, (7, 7), (2, 2),
                          "SAME" if bn else [(3, 3), (3, 3)], dtype=dtype)
        self.stem2 = conv(64, 64, (1, 1), dtype=dtype)
        self.stem3 = conv(64, 192, (3, 3), dtype=dtype)

        def mod(in_features, *widths):
            return InceptionModule(in_features, *widths, dtype=dtype, bn=bn)

        self.i3a = mod(192, 64, 96, 128, 16, 32, 32)
        self.i3b = mod(256, 128, 128, 192, 32, 96, 64)
        self.i4a = mod(480, 192, 96, 208, 16, 48, 64)
        self.i4b = mod(512, 160, 112, 224, 24, 64, 64)
        self.i4c = mod(512, 128, 128, 256, 24, 64, 64)
        self.i4d = mod(512, 112, 144, 288, 32, 64, 64)
        self.i4e = mod(528, 256, 160, 320, 32, 128, 128)
        self.i5a = mod(832, 256, 160, 320, 32, 128, 128)
        self.i5b = mod(832, 384, 192, 384, 48, 128, 128)
        if aux_heads:
            # the stem and three pools each take ceil(side / 2)
            side = -(-input_size // 16)
            side = (side - 5) // 3 + 1  # the aux heads' 5x5/3 VALID pool
            self.aux1 = AuxiliaryClassifier(512, side, num_classes, dtype, bn)
            self.aux2 = AuxiliaryClassifier(528, side, num_classes, dtype, bn)
        self.fc = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        """NHWC images ``(B, H, W, 3)`` -> float32 logits ``(B,
        num_classes)``; in training with ``aux_heads``, ``(main, aux1,
        aux2)``. ``train`` normalizes BN by the batch (updating its
        running statistics) and turns dropout on, with masks from
        ``generator``."""
        aux = self.aux_heads and train
        x = self.stem1(x.to(self.dtype), train)
        x = _pool2(x)
        if not self.bn:
            x = self.lrn(x, 64, 1e-4, 0.75, 1.0)
        x = self.stem2(x, train)
        x = self.stem3(x, train)
        if not self.bn:
            x = self.lrn(x, 192, 1e-4, 0.75, 1.0)
        x = _pool2(x)
        x = self.i3b(self.i3a(x, train), train)
        x = self.i4a(_pool2(x), train)
        aux1 = self.aux1(x, train, generator) if aux else None
        x = self.i4d(self.i4c(self.i4b(x, train), train), train)
        aux2 = self.aux2(x, train, generator) if aux else None
        x = _pool2(self.i4e(x, train))
        x = self.i5b(self.i5a(x, train), train)
        x = layers.global_avg_pool(x)
        x = layers.dropout(x, self.dropout_rate, train, generator)
        main = layers.dense(x.float(), self.fc)
        if aux:
            return main, aux1, aux2
        return main


@register("inception1")
def _inception_v1(**kw):
    return InceptionV1(**kw)


@register("inception1_ref")
def _inception_v1_ref(**kw):
    """The reference's BN-free architecture, with the stem LRNs."""
    kw.setdefault("bn", False)
    return InceptionV1(**kw)
