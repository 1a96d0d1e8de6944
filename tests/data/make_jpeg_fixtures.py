"""Write the JPEG fixtures of ``tests/data/`` and their reference decode.

    JAX_PLATFORMS=cpu python tests/data/make_jpeg_fixtures.py

Four small JPEGs (PIL, quality 90, 4:2:0) of smooth seeded images at odd
sizes, ``jpeg_<i>.jpg``, and ``jpeg_reference.npz``: for each, the
pixels ``tf.io.decode_jpeg`` gives (``pixels_<i>``, its default fast
integer IDCT, which the JAX reader uses; ``pixels_accurate_<i>``, with
``dct_method="INTEGER_ACCURATE"``, libjpeg's accurate IDCT, which PIL
uses too) and the JAX reader's evaluation output,
``parse_and_preprocess(..., size=EVAL_SIZE, is_training=False,
augment="pt")`` in float32 (``eval_<i>``). The port's
tests and ``chip_smoke.py`` hold its decoders (PIL on the CPU, nvJPEG on
the card) and its decode stage to them. Needs TensorFlow and PIL.
"""

import io
from pathlib import Path

import numpy as np
import tensorflow as tf
from PIL import Image

from deepvision_tpu.data.imagenet import parse_and_preprocess
from deepvision_tpu.data.tfrecord import encode_example

HERE = Path(__file__).resolve().parent
SIZES = [(32, 48), (56, 40), (48, 48), (29, 67)]
EVAL_SIZE = 24


def image(rng, h, w):
    """A smooth field (a 4x4 grid, bilinear) with mild noise, uint8."""
    low = rng.uniform(0, 255, (4, 4, 3)).astype(np.float32)
    up = tf.image.resize(low, [h, w]).numpy()
    noise = rng.normal(0, 2, (h, w, 3))
    return np.clip(np.round(up + noise), 0, 255).astype(np.uint8)


def main():
    rng = np.random.default_rng(0)
    ref = {"eval_size": np.int32(EVAL_SIZE)}
    for i, (h, w) in enumerate(SIZES):
        buf = io.BytesIO()
        Image.fromarray(image(rng, h, w)).save(buf, "JPEG", quality=90)
        blob = buf.getvalue()
        (HERE / f"jpeg_{i}.jpg").write_bytes(blob)
        ref[f"pixels_{i}"] = tf.io.decode_jpeg(blob, channels=3).numpy()
        ref[f"pixels_accurate_{i}"] = tf.io.decode_jpeg(
            blob, channels=3, dct_method="INTEGER_ACCURATE").numpy()
        record = encode_example({"image/encoded": [blob],
                                 "image/class/label": [i + 1]})
        img, label = parse_and_preprocess(tf.constant(record), EVAL_SIZE,
                                          is_training=False, augment="pt")
        assert int(label) == i
        ref[f"eval_{i}"] = img.numpy().astype(np.float32)
    np.savez_compressed(HERE / "jpeg_reference.npz", **ref)


if __name__ == "__main__":
    main()
