"""MobileNet V1, the twin of ``deepvision_tpu/models/mobilenet.py``.

A 3x3/2 ConvBN stem, then thirteen depthwise-separable blocks
(:class:`DepthwiseSeparableConv`: a depthwise 3x3 ConvBN, ``groups``
equal to its input channels, then a pointwise 1x1 ConvBN), a global
average pool and ``fc`` in float32. ``alpha`` scales every width,
rounded down and at least 8 (:func:`_scale`).

Every 3x3 pads (1, 1) explicitly, as the JAX model does for parity with
torch checkpoints, and not XLA's ``"SAME"``, which pads a stride-2 layer
(0, 1): giving these layers SAME would shift every stride-2 output by
one pixel.

Conventions as in ``alexnet.py``: NHWC activations; float32 parameters
cast to ``dtype`` at use; ``fc`` in float32 on the float32-cast pool, as
flax promotes the bf16 input of a float32 Dense. Parameter names are
flax's module paths (``stem.conv``, ``ds1.dw.bn.scale``, ``fc``).
Fresh kernels: ``he_normal`` in each ConvBN, flax's default
``lecun_normal`` for ``fc``.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.layers import ConvBN
from deepvision_tpu_torch.models.registry import register

__all__ = ["DepthwiseSeparableConv", "MobileNetV1"]

_PAD1 = [(1, 1), (1, 1)]
# (features, stride) of the thirteen blocks, the paper's Table 1
_BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1))


def _scale(ch: int, alpha: float) -> int:
    return max(8, int(ch * alpha))


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3x3 ConvBN + ReLU (``dw``), then pointwise 1x1 ConvBN +
    ReLU (``pw``)."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw = ConvBN(in_features, in_features, (3, 3),
                         (strides, strides), _PAD1, groups=in_features,
                         dtype=dtype)
        self.pw = ConvBN(in_features, features, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.pw(self.dw(x, train), train)


class MobileNetV1(nn.Module):
    # flax's default kernel init, for ``fc``; ConvBN declares its own
    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, num_classes: int = 1000, alpha: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 input_size: int | None = None):
        super().__init__()
        del input_size  # any size: the head pools globally
        self.dtype = dtype
        width = _scale(32, alpha)
        self.stem = ConvBN(3, width, (3, 3), (2, 2), _PAD1, dtype=dtype)
        for i, (f, s) in enumerate(_BLOCKS):
            features = _scale(f, alpha)
            self.add_module(f"ds{i + 1}", DepthwiseSeparableConv(
                width, features, s, dtype))
            width = features
        self.fc = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC images ``(B, H, W, 3)`` -> float32 logits ``(B,
        num_classes)``; ``train`` normalizes BN by the batch (updating
        its running statistics). MobileNet draws no random numbers."""
        del generator
        x = self.stem(x.to(self.dtype), train)
        for i in range(len(_BLOCKS)):
            x = getattr(self, f"ds{i + 1}")(x, train)
        return layers.dense(layers.global_avg_pool(x).float(), self.fc)


@register("mobilenet1")
def _mobilenet_v1(**kw):
    return MobileNetV1(**kw)
