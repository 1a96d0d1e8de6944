"""Offline TFRecord builders, the twins of
``deepvision_tpu/data/builders/``: ImageNet (JPEG shards, bounding-box
CSV, raw-crop shards), VOC and COCO detection, MPII pose and the
CycleGAN folders, over the port's own record codec
(``data/tfrecord.py``) and image repair (``data/image_io.py``), with no
TensorFlow or PIL on the card's path. ``python -m
deepvision_tpu_torch.data.builders`` runs them from the command line.
"""

from deepvision_tpu_torch.data.builders.shard_writer import write_sharded

__all__ = ["write_sharded"]
