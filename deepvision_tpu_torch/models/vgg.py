"""VGG-16 (config D) and VGG-19 (config E), the twins of
``deepvision_tpu/models/vgg.py``.

Five stages of 3x3 convolutions with bias and ReLU (64, 128, 256, 512,
512 channels; two, two, three, three, three of them for VGG-16, two,
two, four, four, four for VGG-19), each stage ended by a 2x2/2 max pool;
then an NHWC flatten (7·7·512 at 224, trap C5: a flax ``fc1`` kernel
carries across with a plain transpose), ``fc1`` and ``fc2`` of 4096 with
ReLU and dropout 0.5, and ``fc3`` in float32 on the float32-cast input,
as flax promotes the bf16 input of a float32 Dense.

The initializers are the JAX model's, not the zoo's default: convs
``xavier_uniform`` (``kernel_init``), the three Dense layers N(0, 0.01)
(each declares its own), biases 0.

Conventions as in ``alexnet.py``: NHWC activations; float32 parameters
cast to ``dtype`` at use; dropout masks from the generator the train
step passes (``dropout_rate``, 0 turns it off). Parameter names are
flax's (``conv1_1`` ... ``conv5_3``, ``fc1`` ... ``fc3``); ``fc1`` is
sized from ``input_size``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.registry import register

__all__ = ["VGG"]

_STAGES = {"vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}
_FILTERS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    kernel_init = staticmethod(layers.xavier_uniform_)

    def __init__(self, stage_convs: Sequence[int], num_classes: int = 1000,
                 input_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = 0.5
        self.convs = []
        in_features = 3
        for i, (n, f) in enumerate(zip(stage_convs, _FILTERS)):
            stage = []
            for j in range(n):
                name = f"conv{i + 1}_{j + 1}"
                self.add_module(name, nn.Conv2d(in_features, f, 3,
                                                padding=1))  # SAME, stride 1
                stage.append(name)
                in_features = f
            self.convs.append(stage)
        side = input_size >> len(stage_convs)  # five 2x2/2 VALID pools
        self.fc1 = nn.Linear(side * side * _FILTERS[-1], 4096)
        self.fc2 = nn.Linear(4096, 4096)
        self.fc3 = nn.Linear(4096, num_classes)
        for fc in (self.fc1, self.fc2, self.fc3):
            fc.kernel_init = layers.normal_(0.01)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC images ``(B, H, W, 3)`` -> float32 logits ``(B,
        num_classes)``; ``train`` turns dropout on, with masks from
        ``generator``."""
        relu, dt = torch.relu, self.dtype
        x = x.to(dt)
        for stage in self.convs:
            for name in stage:
                x = relu(layers.conv2d(x, getattr(self, name), dtype=dt))
            x = layers.max_pool(x)
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        for fc in (self.fc1, self.fc2):
            x = relu(layers.dense(x, fc, dt))
            x = layers.dropout(x, self.dropout_rate, train, generator)
        return layers.dense(x.float(), self.fc3)


@register("vgg16")
def _vgg16(**kw):
    return VGG(_STAGES["vgg16"], **kw)


@register("vgg19")
def _vgg19(**kw):
    return VGG(_STAGES["vgg19"], **kw)
