"""Layer helpers of the port, on NHWC tensors like their JAX twins.

Activations stay contiguous NHWC between layers. A convolution or a
pool runs on the NCHW view ``x.permute(0, 3, 1, 2)``, which has
``torch.channels_last`` memory, so the view costs no copy and cuDNN
writes its output in the same layout; permuting back gives a contiguous
NHWC tensor again.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["conv2d", "max_pool", "init_weights"]

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


def conv2d(x: torch.Tensor, conv: nn.Conv2d,
           padding: Padding = "VALID") -> torch.Tensor:
    """``conv`` over an NHWC tensor; ``padding`` is applied explicitly
    (zeros) before a convolution whose own padding does the rest."""
    pads = _explicit_pads(padding)
    if pads is not None:
        x = F.pad(x, pads)
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


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


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fresh weights from ``generator``: He-normal (fan-in) kernels for
    every Conv2d and Linear, zero biases. Works on a module whose
    storage is uninitialised (``to_empty``)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                             generator=generator)
            if m.bias is not None:
                m.bias.zero_()
