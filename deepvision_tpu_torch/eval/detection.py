"""Detection mAP, the port's copy of ``deepvision_tpu/eval/detection.py``
(host numpy, as there).

PASCAL VOC evaluation: per class, the detections of the whole set are
sorted by score and matched greedily to the ground truth at IoU at least
``iou_thresh`` (each true box matches once; a duplicate is a false
positive), and the precision/recall curve becomes AP by the VOC2007
11-point rule or the area under the curve (VOC2010+). A non-finite box
(an untrained head's exp overflow) overlaps nothing.

:func:`class_names` reads the port's own copies of the VOC (20) and
MSCOCO (80) name lists (``data/assets/``).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

__all__ = ["average_precision", "evaluate_map", "class_names"]

ASSETS = Path(__file__).resolve().parents[1] / "data" / "assets"


@lru_cache(maxsize=None)
def class_names(dataset: str) -> list[str]:
    """Detection class names: ``voc`` (20) or ``mscoco`` (80)."""
    path = ASSETS / f"{'voc' if dataset == 'voc' else 'mscoco'}_names.txt"
    return path.read_text().splitlines()


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``(N, 4)`` x ``(M, 4)`` corners -> ``(N, M)`` IoU; non-finite
    coordinates count as 0."""
    a = np.where(np.isfinite(a), a, 0.0)
    b = np.where(np.isfinite(b), b, 0.0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def average_precision(recall: np.ndarray, precision: np.ndarray, *,
                      method: str = "area") -> float:
    """A PR curve's AP: ``"area"`` (VOC2010+) or ``"11point"``
    (VOC2007)."""
    if method == "11point":
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    if method != "area":
        raise ValueError(f"unknown AP method {method!r}")
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def evaluate_map(detections: list[dict], ground_truths: list[dict],
                 num_classes: int, *, iou_thresh: float = 0.5,
                 method: str = "area") -> dict:
    """Corpus mAP. ``detections[i]``: ``boxes`` ``(N, 4)`` corners,
    ``scores`` ``(N,)``, ``classes`` ``(N,)``; ``ground_truths[i]``:
    ``boxes`` ``(M, 4)``, ``classes`` ``(M,)``. -> ``{"map", "ap" (C,),
    "num_gt" (C,)}``; a class without ground truth has AP nan and stays
    out of the mean."""
    if len(detections) != len(ground_truths):
        raise ValueError("detections and ground_truths length mismatch")
    aps = np.full(num_classes, np.nan)
    num_gt = np.zeros(num_classes, np.int64)
    for c in range(num_classes):
        records = []  # (score, is_tp)
        total_gt = 0
        for det, gt in zip(detections, ground_truths):
            gt_boxes = np.asarray(gt["boxes"], np.float64)[
                np.asarray(gt["classes"]) == c]
            total_gt += len(gt_boxes)
            det_mask = np.asarray(det["classes"]) == c
            boxes = np.asarray(det["boxes"], np.float64)[det_mask]
            scores = np.asarray(det["scores"], np.float64)[det_mask]
            matched = np.zeros(len(gt_boxes), bool)
            ious = _box_iou(boxes, gt_boxes) if len(gt_boxes) else None
            for d in np.argsort(-scores):
                if ious is None:
                    records.append((scores[d], False))
                    continue
                j = int(np.argmax(ious[d]))
                hit = ious[d, j] >= iou_thresh and not matched[j]
                if hit:
                    matched[j] = True
                records.append((scores[d], hit))
        num_gt[c] = total_gt
        if total_gt == 0:
            continue
        if not records:
            aps[c] = 0.0
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.cumsum([r[1] for r in records])
        fp = np.cumsum([not r[1] for r in records])
        recall = tp / total_gt
        precision = tp / np.maximum(tp + fp, 1)
        aps[c] = average_precision(recall, precision, method=method)
    return {"map": float(np.nanmean(aps)) if np.isfinite(aps).any() else 0.0,
            "ap": aps, "num_gt": num_gt}
