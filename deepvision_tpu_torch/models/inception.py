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

Inception V3 (``inception3``, :class:`InceptionV3`), at 299 px: a
five-ConvBN stem with two 3x3/2 VALID max pools, three A blocks (35x35),
the B reduction to 17x17, four C blocks (the factorized 7x7: ``(1, 7)``
and ``(7, 1)`` convolutions padding themselves symmetrically), the D
reduction to 8x8, two E blocks (expanded filter banks, concatenated in
the JAX order, nested concats included), a global average pool, dropout
0.5 and ``fc`` in float32. Every convolution is a ConvBN; the blocks'
pool branches are 3x3/1 average pools whose zero pads count in the
divisor, as flax's. The auxiliary head (``aux_proj``, ``aux_conv``,
``aux_fc``) reads the 17x17 grid after ``c4`` through a 5x5/3 VALID
average pool and a 5x5 VALID ConvBN, which need that grid to be 17 or
more, so at least 299 px of input: it runs only in training with
``aux_heads``, and the forward then returns ``(main, aux)``. Below 299
px the module builds no aux head, and training with ``aux_heads``
raises, as the JAX model fails there.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.registry import register
from deepvision_tpu_torch.ops.lrn import local_response_norm

__all__ = ["BasicConv", "InceptionModule", "AuxiliaryClassifier",
           "InceptionV1", "InceptionV3"]


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


# ---------------------------------------------------------- Inception V3

_SAME3 = [(1, 1), (1, 1)]


def _avg3(x: torch.Tensor) -> torch.Tensor:
    """3x3/1 average pool, XLA's SAME pads counted as zeros."""
    return layers.avg_pool(x, (3, 3), (1, 1), _SAME3)


def _pool_valid(x: torch.Tensor) -> torch.Tensor:
    return layers.max_pool(x, (3, 3), (2, 2))


class _Branches(nn.Module):
    """A block of ConvBNs (``name: (in, out, kernel[, strides, padding])``
    in flax's names), every one in the compute ``dtype``."""

    def __init__(self, convs: dict, dtype: torch.dtype):
        super().__init__()
        for name, (cin, cout, kernel, *rest) in convs.items():
            strides, padding = rest if rest else ((1, 1), "SAME")
            self.add_module(name, layers.ConvBN(cin, cout, kernel, strides,
                                                padding, dtype=dtype))


_S2 = ((2, 2), "VALID")


class _InceptionA(_Branches):
    def __init__(self, cin: int, pool_features: int, dtype: torch.dtype):
        super().__init__({
            "b1": (cin, 64, (1, 1)), "b5r": (cin, 48, (1, 1)),
            "b5": (48, 64, (5, 5)), "b3r": (cin, 64, (1, 1)),
            "b3a": (64, 96, (3, 3)), "b3b": (96, 96, (3, 3)),
            "bp": (cin, pool_features, (1, 1))}, dtype)

    def forward(self, x, train=False):
        b5 = self.b5(self.b5r(x, train), train)
        b3 = self.b3b(self.b3a(self.b3r(x, train), train), train)
        return torch.cat([self.b1(x, train), b5, b3,
                          self.bp(_avg3(x), train)], dim=-1)


class _InceptionB(_Branches):  # grid reduction 35 -> 17
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__({
            "b3": (cin, 384, (3, 3), *_S2), "bdr": (cin, 64, (1, 1)),
            "bda": (64, 96, (3, 3)), "bdb": (96, 96, (3, 3), *_S2)}, dtype)

    def forward(self, x, train=False):
        bd = self.bdb(self.bda(self.bdr(x, train), train), train)
        return torch.cat([self.b3(x, train), bd, _pool_valid(x)], dim=-1)


class _InceptionC(_Branches):  # factorized 7x7
    def __init__(self, cin: int, c7: int, dtype: torch.dtype):
        super().__init__({
            "b1": (cin, 192, (1, 1)), "b7r": (cin, c7, (1, 1)),
            "b7a": (c7, c7, (1, 7)), "b7b": (c7, 192, (7, 1)),
            "bbr": (cin, c7, (1, 1)), "bba": (c7, c7, (7, 1)),
            "bbb": (c7, c7, (1, 7)), "bbc": (c7, c7, (7, 1)),
            "bbd": (c7, 192, (1, 7)), "bp": (cin, 192, (1, 1))}, dtype)

    def forward(self, x, train=False):
        b7 = self.b7b(self.b7a(self.b7r(x, train), train), train)
        bb = self.bbr(x, train)
        for name in ("bba", "bbb", "bbc", "bbd"):
            bb = getattr(self, name)(bb, train)
        return torch.cat([self.b1(x, train), b7, bb,
                          self.bp(_avg3(x), train)], dim=-1)


class _InceptionD(_Branches):  # grid reduction 17 -> 8
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__({
            "b3r": (cin, 192, (1, 1)), "b3": (192, 320, (3, 3), *_S2),
            "b7r": (cin, 192, (1, 1)), "b7a": (192, 192, (1, 7)),
            "b7b": (192, 192, (7, 1)), "b7c": (192, 192, (3, 3), *_S2)},
            dtype)

    def forward(self, x, train=False):
        b3 = self.b3(self.b3r(x, train), train)
        b7 = self.b7r(x, train)
        for name in ("b7a", "b7b", "b7c"):
            b7 = getattr(self, name)(b7, train)
        return torch.cat([b3, b7, _pool_valid(x)], dim=-1)


class _InceptionE(_Branches):  # expanded filter banks
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__({
            "b1": (cin, 320, (1, 1)), "b3r": (cin, 384, (1, 1)),
            "b3a": (384, 384, (1, 3)), "b3b": (384, 384, (3, 1)),
            "bdr": (cin, 448, (1, 1)), "bda": (448, 384, (3, 3)),
            "bdb": (384, 384, (1, 3)), "bdc": (384, 384, (3, 1)),
            "bp": (cin, 192, (1, 1))}, dtype)

    def forward(self, x, train=False):
        b3 = self.b3r(x, train)
        bd = self.bda(self.bdr(x, train), train)
        return torch.cat([self.b1(x, train), self.b3a(b3, train),
                          self.b3b(b3, train), self.bdb(bd, train),
                          self.bdc(bd, train), self.bp(_avg3(x), train)],
                         dim=-1)


def _v3_grid(n: int) -> int:
    """The side of Inception V3's 17x17 grid (after ``b``) for an input
    of side ``n``: three 3x3 VALID convolutions (the first stride 2) and
    three 3x3/2 VALID reductions."""
    n = (n - 3) // 2 + 1   # stem1
    n -= 2                 # stem2
    n = (n - 3) // 2 + 1   # pool
    n -= 2                 # stem5
    n = (n - 3) // 2 + 1   # pool
    return (n - 3) // 2 + 1  # b


class InceptionV3(nn.Module):
    # flax's default kernel init, for the Dense layers; ConvBN declares
    # its own
    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, num_classes: int = 1000, input_size: int = 299,
                 aux_heads: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.aux_heads = aux_heads
        self.dtype = dtype
        self.dropout_rate = 0.5
        c = layers.ConvBN
        self.stem1 = c(3, 32, (3, 3), (2, 2), "VALID", dtype=dtype)
        self.stem2 = c(32, 32, (3, 3), padding="VALID", dtype=dtype)
        self.stem3 = c(32, 64, (3, 3), dtype=dtype)
        self.stem4 = c(64, 80, (1, 1), padding="VALID", dtype=dtype)
        self.stem5 = c(80, 192, (3, 3), padding="VALID", dtype=dtype)
        self.a1 = _InceptionA(192, 32, dtype)
        self.a2 = _InceptionA(256, 64, dtype)
        self.a3 = _InceptionA(288, 64, dtype)
        self.b = _InceptionB(288, dtype)
        self.c1 = _InceptionC(768, 128, dtype)
        self.c2 = _InceptionC(768, 160, dtype)
        self.c3 = _InceptionC(768, 160, dtype)
        self.c4 = _InceptionC(768, 192, dtype)
        # the 5x5/3 VALID pool, then the 5x5 VALID conv
        side = (_v3_grid(input_size) - 5) // 3 + 1 - 4
        if aux_heads and side >= 1:
            self.aux_proj = c(768, 128, (1, 1), dtype=dtype)
            self.aux_conv = c(128, 768, (5, 5), padding="VALID", dtype=dtype)
            self.aux_fc = nn.Linear(side * side * 768, num_classes)
        self.dd = _InceptionD(768, dtype)
        self.e1 = _InceptionE(1280, dtype)
        self.e2 = _InceptionE(2048, dtype)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        """NHWC images ``(B, H, W, 3)`` -> float32 logits ``(B,
        num_classes)``; in training with ``aux_heads``, ``(main, aux)``.
        ``train`` normalizes BN by the batch (updating its running
        statistics) and turns dropout on, with masks from
        ``generator``."""
        x = self.stem1(x.to(self.dtype), train)
        x = self.stem3(self.stem2(x, train), train)
        x = _pool_valid(x)
        x = self.stem5(self.stem4(x, train), train)
        x = _pool_valid(x)
        for name in ("a1", "a2", "a3", "b", "c1", "c2", "c3", "c4"):
            x = getattr(self, name)(x, train)
        aux = self.aux_head(x, train) if self.aux_heads and train else None
        for name in ("dd", "e1", "e2"):
            x = getattr(self, name)(x, train)
        x = layers.global_avg_pool(x)
        x = layers.dropout(x, self.dropout_rate, train, generator)
        main = layers.dense(x.float(), self.fc)
        return main if aux is None else (main, aux)

    def aux_head(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The auxiliary logits (float32) from the 17x17 grid after
        ``c4``: 5x5/3 VALID average pool, ``aux_proj`` (1x1 to 128),
        ``aux_conv`` (5x5 VALID to 768), an NHWC flatten, ``aux_fc``."""
        if not hasattr(self, "aux_fc"):
            raise ValueError(
                "Inception V3's aux head needs an input of at least 299 px "
                "(a 17x17 grid under its 5x5/3 pool and 5x5 VALID conv); "
                "build the model at that size or with aux_heads=False")
        a = layers.avg_pool(x, (5, 5), (3, 3))
        a = self.aux_conv(self.aux_proj(a, train), train)
        return layers.dense(a.reshape(a.shape[0], -1).float(), self.aux_fc)


@register("inception1")
def _inception_v1(**kw):
    return InceptionV1(**kw)


@register("inception1_ref")
def _inception_v1_ref(**kw):
    """The reference's BN-free architecture, with the stem LRNs."""
    kw.setdefault("bn", False)
    return InceptionV1(**kw)


@register("inception3")
def _inception_v3(**kw):
    return InceptionV3(**kw)
