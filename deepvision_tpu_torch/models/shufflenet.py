"""ShuffleNet V1, the twin of ``deepvision_tpu/models/shufflenet.py``.

A 3x3/2 ConvBN stem of 24 channels and a 3x3/2 max pool, three stages
of 4, 8 and 4 :class:`ShuffleUnit`s (``groups`` = 3: 240, 480 and 960
channels), a global average pool and ``fc`` in float32.

A unit: a grouped 1x1 ConvBN + ReLU to ``mid`` = a quarter of the unit's
nominal width (no groups on the first unit's, ``first_group``), the
channel shuffle (:func:`channel_shuffle`), a depthwise 3x3 ConvBN
(``groups`` = ``mid``, stride 2 in each stage's first unit) and a
grouped 1x1 ConvBN, both without activation. A stride-1 unit adds its
input and applies ReLU; a stride-2 unit widens by concatenating
``[shortcut, y]``, the shortcut a 3x3/2 average pool of its input, with
ReLU after the concat, so its branch outputs ``features - in``
channels.

XLA's ``"SAME"`` under stride 2 pads asymmetrically (trap C2), and four
sites here meet it: the stem convolution, the max pool (-inf pads), each
first unit's depthwise convolution, and the shortcut's average pool,
whose zero pads count in the divisor of every window (flax's
``count_include_pad=True``: each window divides by 9). Each takes its
pads from ``same_padding`` at its input's size.

Conventions as in ``alexnet.py``: NHWC activations; float32 parameters
cast to ``dtype`` at use; ``fc`` in float32 on the float32-cast pool.
Parameter names are flax's module paths (``stem.conv``,
``stage2_unit1.gconv1.conv``, ``fc``). Fresh kernels: ``he_normal`` in
each ConvBN, flax's default ``lecun_normal`` for ``fc``.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.layers import ConvBN
from deepvision_tpu_torch.models.registry import register

__all__ = ["channel_shuffle", "ShuffleUnit", "ShuffleNetV1"]

_STAGE_CHANNELS = {1: 144, 2: 200, 3: 240, 4: 272, 8: 384}
_STAGE_BLOCKS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The NHWC channel shuffle: channel ``g·n + i`` of ``groups`` groups
    of ``n`` moves to ``i·groups + g`` (reshape, swap, reshape)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, groups, c // groups).transpose(3, 4)
    return x.reshape(b, h, w, c)


def _same_pool(pool, x: torch.Tensor) -> torch.Tensor:
    """A 3x3/2 pool with XLA's SAME pads at ``x``'s size."""
    return pool(x, (3, 3), (2, 2),
                layers.same_padding(x.shape[1:3], (3, 3), (2, 2)))


class ShuffleUnit(nn.Module):
    def __init__(self, in_features: int, features: int, groups: int = 3,
                 strides: int = 1, first_group: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.groups = groups
        self.strides = strides
        out = features - (in_features if strides == 2 else 0)
        # a quarter of the NOMINAL width, not of ``out``
        mid = features // 4
        self.gconv1 = ConvBN(in_features, mid, (1, 1),
                             groups=groups if first_group else 1,
                             dtype=dtype)
        self.dwconv = ConvBN(mid, mid, (3, 3), (strides, strides),
                             groups=mid, act=None, dtype=dtype)
        self.gconv2 = ConvBN(mid, out, (1, 1), groups=groups, act=None,
                             dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = channel_shuffle(self.gconv1(x, train), self.groups)
        y = self.gconv2(self.dwconv(y, train), train)
        if self.strides == 2:
            shortcut = _same_pool(layers.avg_pool, x)
            return torch.relu(torch.cat([shortcut, y], dim=-1))
        return torch.relu(x + y)


class ShuffleNetV1(nn.Module):
    # flax's default kernel init, for ``fc``; ConvBN declares its own
    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, num_classes: int = 1000, groups: int = 3,
                 dtype: torch.dtype = torch.float32,
                 input_size: int | None = None):
        super().__init__()
        del input_size  # any size: the head pools globally
        self.dtype = dtype
        self.stem = ConvBN(3, 24, (3, 3), (2, 2), dtype=dtype)  # SAME
        base = _STAGE_CHANNELS[groups]
        width = 24
        self.units = []
        for stage, n_blocks in enumerate(_STAGE_BLOCKS):
            features = base * 2 ** stage
            for j in range(n_blocks):
                name = f"stage{stage + 2}_unit{j + 1}"
                self.add_module(name, ShuffleUnit(
                    width, features, groups, strides=2 if j == 0 else 1,
                    first_group=not (stage == 0 and j == 0), dtype=dtype))
                self.units.append(name)
                width = features
        self.fc = nn.Linear(width, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC images ``(B, H, W, 3)`` -> float32 logits ``(B,
        num_classes)``; ``train`` normalizes BN by the batch (updating
        its running statistics). ShuffleNet draws no random numbers."""
        del generator
        x = self.stem(x.to(self.dtype), train)
        x = _same_pool(layers.max_pool, x)
        for name in self.units:
            x = getattr(self, name)(x, train)
        return layers.dense(layers.global_avg_pool(x).float(), self.fc)


@register("shufflenet1")
def _shufflenet_v1(**kw):
    return ShuffleNetV1(**kw)
