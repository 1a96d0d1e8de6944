"""LeNet-5, the twin of ``deepvision_tpu/models/lenet.py``.

A 32x32x1 image (MNIST's 28x28 padded to 32, ``data/mnist.py``) through
``c1`` (5x5 VALID, 6), a 2x2 average pool, ``c3`` (5x5, 16), a pool,
``c5`` (5x5, 120, down to 1x1), ``f6`` (Dense 84) and ``output``, a
float32 Dense to the class logits; tanh between (``lenet5``) or sigmoid
(``lenet5_tf``). It is the judge classifier of ``eval gan -m dcgan``
and trains on MNIST through the training CLI. Fresh weights are flax's
defaults: ``lecun_normal`` kernels and zero biases.
"""

from __future__ import annotations

import torch
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.registry import register

__all__ = ["LeNet5"]

_ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid}


class LeNet5(nn.Module):
    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, num_classes: int = 10, activation: str = "tanh",
                 dtype: torch.dtype = torch.float32,
                 input_size: int | None = None):
        super().__init__()
        del input_size  # 32x32 by construction
        self.act = _ACTIVATIONS[activation]
        self.dtype = dtype
        self.c1 = layers.make_conv(1, 6, (5, 5), padding="VALID")
        self.c3 = layers.make_conv(6, 16, (5, 5), padding="VALID")
        self.c5 = layers.make_conv(16, 120, (5, 5), padding="VALID")
        self.f6 = nn.Linear(120, 84)
        self.output = nn.Linear(84, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del train, generator  # no dropout, no BatchNorm
        d = self.dtype
        x = x.to(d)
        x = layers.avg_pool(self.act(layers.conv2d(x, self.c1, dtype=d)))
        x = layers.avg_pool(self.act(layers.conv2d(x, self.c3, dtype=d)))
        x = self.act(layers.conv2d(x, self.c5, dtype=d))
        x = self.act(layers.dense(x.reshape(x.shape[0], -1), self.f6, d))
        return layers.dense(x.float(), self.output)


@register("lenet5")
def _lenet5(**kw) -> LeNet5:
    return LeNet5(**kw)


@register("lenet5_tf")
def _lenet5_tf(**kw) -> LeNet5:
    kw.setdefault("activation", "sigmoid")
    return LeNet5(**kw)
