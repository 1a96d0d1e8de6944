"""Pose PCK, the port's copy of ``deepvision_tpu/eval/pose.py`` (host
numpy, as there).

PCK@tau: a predicted keypoint is correct when its distance to the truth
is under tau times a per-sample normalization length; only visible
joints count. :func:`heatmap_argmax_keypoints` is the decode the eval
path uses: each joint's argmax cell of a heatmap.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pck", "heatmap_argmax_keypoints"]


def pck(pred_xy: np.ndarray, true_xy: np.ndarray, visible: np.ndarray,
        norm_length: np.ndarray, *, threshold: float = 0.5) -> dict:
    """``(B, K, 2)`` predicted and true coordinates (any one unit),
    ``(B, K)`` visibility, ``(B,)`` normalization lengths -> ``{"pck":
    float, "per_joint": (K,) (NaN for a joint never visible), "count":
    (K,)}`` over the visible joints."""
    pred_xy = np.asarray(pred_xy, np.float64)
    true_xy = np.asarray(true_xy, np.float64)
    vis = np.asarray(visible) > 0
    norm = np.asarray(norm_length, np.float64)[:, None]
    dist = np.linalg.norm(pred_xy - true_xy, axis=-1)  # (B, K)
    correct = (dist < threshold * np.maximum(norm, 1e-12)) & vis
    count = vis.sum(axis=0)
    per_joint = np.where(
        count > 0, correct.sum(axis=0) / np.maximum(count, 1), np.nan)
    total_vis = vis.sum()
    return {"pck": float(correct.sum() / total_vis) if total_vis else 0.0,
            "per_joint": per_joint, "count": count}


def heatmap_argmax_keypoints(heatmaps: np.ndarray) -> np.ndarray:
    """``(B, H, W, K)`` heatmaps -> ``(B, K, 2)`` (x, y) argmax cells,
    float64."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, k).argmax(axis=1)  # (B, K)
    ys, xs = np.divmod(flat, w)
    return np.stack([xs, ys], axis=-1).astype(np.float64)
