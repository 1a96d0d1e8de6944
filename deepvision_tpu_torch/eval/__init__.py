"""Offline evaluation of the port: detection mAP (``python -m
deepvision_tpu_torch.eval detection``)."""

from deepvision_tpu_torch.eval.detection import (
    average_precision,
    class_names,
    evaluate_map,
)

__all__ = ["average_precision", "class_names", "evaluate_map"]
