"""Offline evaluation of the port: detection mAP and pose PCK (``python
-m deepvision_tpu_torch.eval detection`` and ``... pose``)."""

from deepvision_tpu_torch.eval.detection import (
    average_precision,
    class_names,
    evaluate_map,
)
from deepvision_tpu_torch.eval.pose import heatmap_argmax_keypoints, pck

__all__ = ["average_precision", "class_names", "evaluate_map",
           "heatmap_argmax_keypoints", "pck"]
