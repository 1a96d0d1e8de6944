"""Layer helpers of the port, on NHWC tensors like their JAX twins.

Activations stay contiguous NHWC between layers. A convolution or a
pool runs on the NCHW view ``x.permute(0, 3, 1, 2)``, which has
``torch.channels_last`` memory, so the view costs no copy and cuDNN
writes its output in the same layout; permuting back gives a contiguous
NHWC tensor again.

Mixed precision follows flax's ``dtype`` convention: parameters stay
float32 masters and are cast to the compute ``dtype`` at use, inside the
forward (:func:`conv2d`, :func:`dense`), so their gradients flow back
through the cast as float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["conv2d", "dense", "dropout", "max_pool", "lecun_normal_",
           "init_weights"]

Padding = str | Sequence[tuple[int, int]]


def _explicit_pads(padding: Padding) -> tuple[int, ...] | None:
    """``"VALID"`` -> None; ``[(top, bottom), (left, right)]`` -> the
    ``F.pad`` tuple for the H and W axes of an NHWC tensor."""
    if isinstance(padding, str):
        if padding.upper() != "VALID":
            raise ValueError(
                f"padding must be 'VALID' or explicit (lo, hi) pairs, got "
                f"{padding!r}")
        return None
    (top, bottom), (left, right) = padding
    return (0, 0, left, right, top, bottom)


def _cast(p: torch.Tensor | None, dtype: torch.dtype | None):
    return p if p is None or dtype is None else p.to(dtype)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, padding: Padding = "VALID",
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """``conv`` over an NHWC tensor; ``padding`` is applied explicitly
    (zeros) before a convolution whose own padding does the rest. With
    ``dtype`` the weights are cast to it at use (the input must already
    be in it)."""
    pads = _explicit_pads(padding)
    if pads is not None:
        x = F.pad(x, pads)
    y = F.conv2d(x.permute(0, 3, 1, 2), _cast(conv.weight, dtype),
                 _cast(conv.bias, dtype), conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, linear: nn.Linear,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """``linear`` with its weights cast to ``dtype`` at use."""
    return F.linear(x, _cast(linear.weight, dtype), _cast(linear.bias, dtype))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``nn.Dropout``: identity unless training with ``rate`` > 0;
    then each value is kept with probability ``1 - rate`` (the mask drawn
    from ``generator``, which the train step passes in) and scaled by
    ``1 / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit generator")
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def max_pool(x: torch.Tensor, window: tuple[int, int] = (2, 2),
             strides: tuple[int, int] | None = None,
             padding: Padding = "VALID") -> torch.Tensor:
    """Max pool over H and W of an NHWC tensor. Explicit padding pads
    with -inf, so a padded cell never wins (XLA's SAME pads a stride-2
    pool asymmetrically; callers spell those pads out)."""
    pads = _explicit_pads(padding)
    if pads is not None:
        x = F.pad(x, pads, value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides or window)
    return y.permute(0, 2, 3, 1)


# stddev of a standard normal truncated to (-2, 2), which flax's
# variance_scaling divides out so that the truncated draw keeps the
# asked-for variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` (its default kernel init): variance
    1/fan_in, truncated to two standard deviations. fan_in is the
    product of every axis but the output one, as flax counts it for a
    conv ``(KH, KW, I, O)`` or a Dense ``(in, out)`` kernel."""
    std = math.sqrt(1.0 / weight[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights from ``generator`` by the model's own kernel init:
    ``module.kernel_init(weight, generator)`` for every Conv2d and
    Linear, as the model's JAX twin declares it (the AlexNets keep flax's
    default, :func:`lecun_normal_`), and zero biases. Works on a module
    whose storage is uninitialised (``to_empty``)."""
    kernel_init = module.kernel_init
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            kernel_init(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
