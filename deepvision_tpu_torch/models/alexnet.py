"""AlexNet V1 and V2, the twins of ``deepvision_tpu/models/alexnet.py``.

- V1: one tower with the paper's per-tower channel counts doubled, LRN
  after conv1 and conv2, overlapping 3x3/2 max pools, dropout(0.5) on
  both hidden FC layers.
- V2: the single-column 64/192/384/384/256 variant, without LRN;
  ``use_lrn=True`` (registered as ``alexnet2_tf``) keeps the TF twin's
  LRN.

Input and activations are NHWC (``layers.py``). The flatten before
``fc6`` is in NHWC order, as flax's, so a flax ``fc6`` kernel carries
across with a plain transpose and no row permutation. Parameter names
follow the flax module names (``conv1`` ... ``fc8``).

``dtype`` is flax's compute dtype: the input is cast to it, the float32
parameters are cast to it at use, and the activations (the LRN's input
included) are in it; ``fc8`` computes in float32 on a float32 input, as
the flax ``fc8`` does. Fresh kernels are flax's default ``lecun_normal``
(``kernel_init``). Dropout draws its mask from the generator the train
step passes to ``forward``; ``dropout_rate = 0`` turns it off.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.registry import register
from deepvision_tpu_torch.ops.lrn import local_response_norm

__all__ = ["AlexNetV1", "AlexNetV2"]


def _pool_out(n: int) -> int:
    return (n - 3) // 2 + 1  # 3x3/2 VALID


class _AlexNet(nn.Module):
    # the LRN the forward calls; an instance may set the plain version
    # here to run the same weights without the kernel
    lrn = staticmethod(local_response_norm)
    # flax's default kernel init (nn.Conv / nn.Dense without kernel_init)
    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, widths: tuple[int, int, int, int, int],
                 conv1_pad: tuple[int, int], use_lrn: bool,
                 num_classes: int, input_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, c2, c3, c4, c5 = widths
        self.conv1_pad = [conv1_pad, conv1_pad]
        self.use_lrn = use_lrn
        self.dtype = dtype
        self.dropout_rate = 0.5
        self.conv1 = nn.Conv2d(3, c1, 11, stride=4)
        self.conv2 = nn.Conv2d(c1, c2, 5, padding=2)   # SAME, stride 1
        self.conv3 = nn.Conv2d(c2, c3, 3, padding=1)
        self.conv4 = nn.Conv2d(c3, c4, 3, padding=1)
        self.conv5 = nn.Conv2d(c4, c5, 3, padding=1)
        side = (input_size + sum(conv1_pad) - 11) // 4 + 1
        side = _pool_out(_pool_out(_pool_out(side)))
        self.fc6 = nn.Linear(side * side * c5, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC images ``(B, H, W, 3)`` -> float32 logits
        ``(B, num_classes)``; ``train`` turns dropout on, with masks from
        ``generator``."""
        relu, dt = torch.relu, self.dtype

        def drop(v):
            return layers.dropout(v, self.dropout_rate, train, generator)

        x = x.to(dt)
        x = relu(layers.conv2d(x, self.conv1, self.conv1_pad, dt))
        if self.use_lrn:
            x = self.lrn(x)
        x = layers.max_pool(x, (3, 3), (2, 2))
        x = relu(layers.conv2d(x, self.conv2, dtype=dt))
        if self.use_lrn:
            x = self.lrn(x)
        x = layers.max_pool(x, (3, 3), (2, 2))
        x = relu(layers.conv2d(x, self.conv3, dtype=dt))
        x = relu(layers.conv2d(x, self.conv4, dtype=dt))
        x = relu(layers.conv2d(x, self.conv5, dtype=dt))
        x = layers.max_pool(x, (3, 3), (2, 2))
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        x = relu(layers.dense(drop(x), self.fc6, dt))
        x = relu(layers.dense(drop(x), self.fc7, dt))
        return layers.dense(x.float(), self.fc8)


class AlexNetV1(_AlexNet):
    def __init__(self, num_classes: int = 1000, input_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        # asymmetric (1, 2) padding makes 224 behave as the paper's 227:
        # 224 -> 55 -> 27 -> 13 -> 6, the 6x6x256 flatten of the FC stack
        super().__init__((96, 256, 384, 384, 256), (1, 2), True,
                         num_classes, input_size, dtype)


class AlexNetV2(_AlexNet):
    def __init__(self, num_classes: int = 1000, input_size: int = 224,
                 use_lrn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__((64, 192, 384, 384, 256), (2, 2), use_lrn,
                         num_classes, input_size, dtype)


@register("alexnet1")
def _alexnet_v1(**kw):
    return AlexNetV1(**kw)


@register("alexnet2")
def _alexnet_v2(**kw):
    return AlexNetV2(**kw)


@register("alexnet2_tf")
def _alexnet_v2_tf(**kw):
    kw.setdefault("use_lrn", True)
    return AlexNetV2(**kw)
