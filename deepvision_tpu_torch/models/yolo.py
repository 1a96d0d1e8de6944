"""Darknet-53 and the YOLO v3 detector, the twins of
``deepvision_tpu/models/yolo.py``.

- :class:`Darknet53`: the 3x3 ``stem`` (32), then five stages, each a
  stride-2 3x3 ``down{i}`` and ``stage{i}_block{b}`` residual blocks
  (1, 2, 8, 8, 4 of them; :class:`DarknetBlock`, a 1x1 ``squeeze`` to
  half the width and a 3x3 ``expand`` back), returning the maps of
  stages 2-4 (strides 8, 16, 32; 256, 512 and 1024 channels). Every
  convolution is a :class:`~layers.ConvBN` with leaky ReLU 0.1.
- :class:`DarknetClassifier` (``darknet53``): the backbone, a global
  average pool accumulated in float32 and ``head``, a float32 Dense.
- :class:`YoloV3` (``yolov3``): ``head_large`` on the stride-32 map,
  ``lateral_medium`` (1x1, 256), a nearest 2x upsample concatenated with
  the stride-16 map, ``head_medium``, ``lateral_small`` (1x1, 128), the
  same with the stride-8 map, ``head_small``. A head (:class:`HeadBlock`,
  the JAX ``_HeadBlock``) is five alternating 1x1 and 3x3 ConvBNs whose
  third 1x1 output is the branch to the next scale, a 3x3 ConvBN and
  ``out``, a 1x1 convolution with bias to ``3 · (5 + C)`` channels, in
  float32 on the float32 cast of its input. The grids come back ordered
  (stride 8, 16, 32), each ``(B, S, S, 3, 5 + C)``.

XLA's SAME padding pads a stride-2 3x3 window (0, 1) on an even side
(trap C2): :func:`~layers.same_padding` spells it out, at 416 as at the
test sizes. The JAX model's ``guard_thin_h`` only acts under a spatial
mesh and has no twin here. Fresh weights follow the JAX initializers:
``he_normal`` in every ConvBN, flax's default ``lecun_normal`` and zero
biases for ``out`` and ``head``. Parameter names are the flax module
paths (``backbone.down0.conv.weight``, ``head_large.out.bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.layers import ConvBN, upsample2x
from deepvision_tpu_torch.models.registry import register

__all__ = ["leaky", "DarknetBlock", "Darknet53", "DarknetClassifier",
           "HeadBlock", "YoloV3"]

STAGE_BLOCKS = (1, 2, 8, 8, 4)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class DarknetBlock(nn.Module):
    """1x1 ``squeeze`` to half the width, 3x3 ``expand`` back, plus the
    input."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.squeeze = ConvBN(features, features // 2, (1, 1), act=leaky,
                              dtype=dtype)
        self.expand = ConvBN(features // 2, features, (3, 3), act=leaky,
                             dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return x + self.expand(self.squeeze(x, train), train)


class Darknet53(nn.Module):
    """The backbone: the maps at strides 8, 16 and 32."""

    def __init__(self, stage_blocks=STAGE_BLOCKS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_blocks = tuple(stage_blocks)
        self.dtype = dtype
        self.stem = ConvBN(3, 32, (3, 3), act=leaky, dtype=dtype)
        features = 32
        for stage, blocks in enumerate(self.stage_blocks):
            setattr(self, f"down{stage}", ConvBN(
                features, 2 * features, (3, 3), (2, 2), act=leaky,
                dtype=dtype))
            features *= 2
            for b in range(blocks):
                setattr(self, f"stage{stage}_block{b}",
                        DarknetBlock(features, dtype))

    def forward(self, x: torch.Tensor, train: bool = False):
        x = self.stem(x.to(self.dtype), train)
        outputs = []
        for stage, blocks in enumerate(self.stage_blocks):
            x = getattr(self, f"down{stage}")(x, train)
            for b in range(blocks):
                x = getattr(self, f"stage{stage}_block{b}")(x, train)
            if stage >= 2:
                outputs.append(x)
        return tuple(outputs)


class DarknetClassifier(nn.Module):
    """Darknet-53 as a classifier: the backbone, a global average pool,
    and ``head`` (float32 Dense)."""

    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = Darknet53(dtype=dtype)
        self.head = nn.Linear(1024, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator  # no dropout
        x = layers.global_avg_pool(self.backbone(x, train)[-1])
        return layers.dense(x.float(), self.head)


class HeadBlock(nn.Module):
    """Five alternating ConvBNs (1x1 to ``features``, 3x3 to twice that),
    a 3x3 ConvBN and ``out``; returns (the branch after the third 1x1,
    the raw grid)."""

    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, in_features: int, features: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = features
        for i in range(3):
            setattr(self, f"conv1x1_{i}", ConvBN(
                in_features if i == 0 else 2 * f, f, (1, 1), act=leaky,
                dtype=dtype))
            if i < 2:
                setattr(self, f"conv3x3_{i}", ConvBN(
                    f, 2 * f, (3, 3), act=leaky, dtype=dtype))
        self.conv3x3_2 = ConvBN(f, 2 * f, (3, 3), act=leaky, dtype=dtype)
        self.out = nn.Conv2d(2 * f, out_channels, 1)

    def forward(self, x: torch.Tensor, train: bool = False):
        for i in range(3):
            x = getattr(self, f"conv1x1_{i}")(x, train)
            if i < 2:
                x = getattr(self, f"conv3x3_{i}")(x, train)
        branch = x
        x = self.conv3x3_2(x, train)
        return branch, layers.conv2d(x.float(), self.out)


class YoloV3(nn.Module):
    """The three-scale detector: raw grids ``(B, S, S, 3, 5 + C)`` at
    strides 8, 16 and 32."""

    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, num_classes: int = 20,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        out_ch = 3 * (5 + num_classes)
        self.backbone = Darknet53(dtype=dtype)
        self.head_large = HeadBlock(1024, 512, out_ch, dtype)
        self.lateral_medium = ConvBN(512, 256, (1, 1), act=leaky, dtype=dtype)
        self.head_medium = HeadBlock(256 + 512, 256, out_ch, dtype)
        self.lateral_small = ConvBN(256, 128, (1, 1), act=leaky, dtype=dtype)
        self.head_small = HeadBlock(128 + 256, 128, out_ch, dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        del generator  # no dropout
        feat_s, feat_m, feat_l = self.backbone(x, train)
        branch, y_large = self.head_large(feat_l, train)
        x = self.lateral_medium(branch, train)
        x = torch.cat([upsample2x(x), feat_m], dim=-1)
        branch, y_medium = self.head_medium(x, train)
        x = self.lateral_small(branch, train)
        x = torch.cat([upsample2x(x), feat_s], dim=-1)
        _, y_small = self.head_small(x, train)

        def split_anchors(y):
            b, h, w, _ = y.shape
            return y.reshape(b, h, w, 3, 5 + self.num_classes)

        return split_anchors(y_small), split_anchors(y_medium), \
            split_anchors(y_large)


@register("darknet53")
def _darknet53(num_classes: int = 1000, dtype=torch.float32, **_):
    return DarknetClassifier(num_classes=num_classes, dtype=dtype)


@register("yolov3")
def _yolov3(num_classes: int = 20, dtype=torch.float32, **_):
    return YoloV3(num_classes=num_classes, dtype=dtype)
