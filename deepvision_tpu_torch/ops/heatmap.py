"""Gaussian keypoint heatmaps and their argmax decode: the twins of
``deepvision_tpu/ops/heatmap.py``.

:func:`gaussian_heatmaps` rasterizes the pose targets inside the train
step: one Gaussian a joint (sigma 1, peak 1) centred on the joint's
rounded cell (round half to even, as ``jnp.round`` and ``torch.round``
both round), cut to the (6·sigma + 1)² patch, and all zero for a joint
that is not visible. :func:`decode_heatmaps` is the serving head: each
joint's argmax cell (the first on a tie) as normalized coordinates, and
its value.
"""

from __future__ import annotations

import torch

__all__ = ["gaussian_heatmaps", "decode_heatmaps"]


def gaussian_heatmaps(kx: torch.Tensor, ky: torch.Tensor,
                      visible: torch.Tensor, *, height: int = 64,
                      width: int = 64, sigma: float = 1.0,
                      peak: float = 1.0) -> torch.Tensor:
    """``(..., K)`` normalized keypoints (fractions of the width and the
    height) and visibility (0: absent) -> ``(..., H, W, K)`` float32
    heatmaps."""
    kx, ky = kx.float(), ky.float()
    dev = kx.device
    x0 = torch.round(kx * width)
    y0 = torch.round(ky * height)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    dx = xs[:, None] - x0[..., None, :]  # (..., W, K)
    dy = ys[:, None] - y0[..., None, :]  # (..., H, K)
    ddx, ddy = dx[..., None, :, :], dy[..., :, None, :]
    d2 = ddx * ddx + ddy * ddy
    g = peak * torch.exp(-d2 / (2.0 * sigma * sigma))
    radius = 3.0 * sigma
    inside = (ddx.abs() <= radius) & (ddy.abs() <= radius)
    vis = (visible > 0)[..., None, None, :]
    return torch.where(inside & vis, g, torch.zeros((), device=dev))


def decode_heatmaps(heatmaps: torch.Tensor):
    """``(..., H, W, K)`` heatmaps -> ``(kx, ky, conf)``, each ``(...,
    K)``: each joint's argmax cell (the first in row-major order on a
    tie) as fractions of the width and the height, and its value."""
    heatmaps = heatmaps.float()
    h, w, k = heatmaps.shape[-3:]
    flat = heatmaps.reshape(*heatmaps.shape[:-3], h * w, k)
    conf, idx = flat.amax(dim=-2), flat.argmax(dim=-2)
    ky = (idx // w).float() / h
    kx = (idx % w).float() / w
    return kx, ky, conf
