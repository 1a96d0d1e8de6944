"""The port's ImageNet reader against ``deepvision_tpu/data/imagenet.py``,
on the CPU, over records written here (``encode_example``; JPEGs by PIL).

- The raw-crop evaluation crop equals the JAX ``make_raw_dataset(...,
  is_training=False)``'s bit for bit (records matched by label: tf.data
  interleaves the two files).
- Every raw training crop is a window of its stored frame; the same epoch
  gives the same order and another epoch another; two ranks read
  disjoint files that together cover all of them.
- The JPEG evaluation batch against the JAX ``make_dataset(...,
  is_training=False, augment="pt")``, in the normalized units the batch
  holds: from tf's own decoded pixels the resize, crop and normalization
  alone within 1e-4; with the port's decoder (PIL, libjpeg's accurate
  IDCT, against tf's default fast one, traps C9 and C14) within 4 uint8
  steps at most and 1.5 on average, bounds set from the committed
  fixtures (``tests/data/``: PIL at most 2.99 steps off, about 1 on
  average).
- The host jitter on explicit factors against the JAX
  ``imagenet.color_jitter`` to 1 LSB; the ``use_raw`` contract.
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import tensorflow as tf
import torch
from PIL import Image

from deepvision_tpu.data import imagenet as jax_imagenet
from deepvision_tpu_torch.data import imagenet, jpeg
from deepvision_tpu_torch.data.tfrecord import encode_example, write_records
from deepvision_tpu_torch.ops.normalize import TORCH_CHANNEL_STDS
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

STORED, SIZE = 48, 32
N_RAW, N_JPEG, N_VAL = 12, 10, 7
STEPS = 255.0 * np.asarray(TORCH_CHANNEL_STDS, np.float32)  # 1 step, normalized


def _image(rng, h, w):
    """A smooth seeded uint8 image (a 4x4 field upsampled, mild noise)."""
    low = rng.uniform(0, 255, (4, 4, 3)).astype(np.float32)
    up = tf.image.resize(low, [h, w]).numpy()
    return np.clip(np.round(up + rng.normal(0, 2, (h, w, 3))), 0,
                   255).astype(np.uint8)


def _jpeg(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _write(d: Path, raw_meta=None, with_raw=True):
    """raw-train (2 files), train (2 files) and validation (1 file)
    records under ``d``; labels 1-indexed and unique per record."""
    rng = np.random.default_rng(0)
    d.mkdir(parents=True, exist_ok=True)
    frames = {}
    if with_raw:
        recs = []
        for i in range(N_RAW):
            long = int(rng.integers(STORED, 2 * STORED + 1))
            h, w = (STORED, long) if i % 2 else (long, STORED)
            frames[i] = _image(rng, h, w)
            recs.append(encode_example({
                "image/raw": [frames[i].tobytes()],
                "image/class/label": [i + 1], "image/height": [h],
                "image/width": [w]}))
        write_records(d / "raw-train-00000-of-00002", recs[0::2])
        write_records(d / "raw-train-00001-of-00002", recs[1::2])
        meta = raw_meta if raw_meta is not None else {
            "stored": STORED, "count": N_RAW, "full_frame": True}
        (d / "raw-train.meta.json").write_text(json.dumps(meta))
    blobs = []
    for name, n, files in (("train", N_JPEG, 2), ("validation", N_VAL, 1)):
        recs = []
        for i in range(n):
            blob = _jpeg(_image(rng, int(rng.integers(30, 90)),
                                int(rng.integers(30, 90))))
            blobs.append(blob)
            recs.append(encode_example({"image/encoded": [blob],
                                        "image/class/label": [i + 1]}))
        for f in range(files):
            write_records(d / f"{name}-{f:05d}-of-{files:05d}",
                          recs[f::files])
    return frames, blobs[N_JPEG:]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("imagenet")
    frames, val_blobs = _write(d)
    return d, frames, val_blobs


# ---------------------------------------------------------- raw crops


def test_raw_eval_crop_matches_jax_bit_for_bit(records):
    d, frames, _ = records
    want = {}
    ds = jax_imagenet.make_raw_dataset(str(d / "raw-train-*"), 5, SIZE,
                                       is_training=False, stored=STORED)
    for img, lbl in ds.as_numpy_iterator():
        want.update(zip(lbl.tolist(), img))
    got = {}
    for batch in imagenet.raw_eval_batches(sorted(d.glob("raw-train-*")), 5,
                                           SIZE):
        real = batch["mask"] > 0
        got.update(zip(batch["label"][real].tolist(), batch["image"][real]))
    assert sorted(got) == sorted(want) == list(range(N_RAW))
    for label, img in want.items():
        assert img.dtype == got[label].dtype == np.uint8
        np.testing.assert_array_equal(got[label], img, err_msg=str(label))


def test_every_raw_train_crop_is_a_window_of_its_frame(records):
    d, frames, _ = records
    seen = set()
    for batch in imagenet.raw_train_batches(
            sorted(d.glob("raw-train-*")), 4, SIZE, seed=3, steps=6,
            device_aug=True):
        assert batch["image"].shape == (4, SIZE, SIZE, 3)
        assert batch["image"].dtype == np.uint8
        for img, label in zip(batch["image"], batch["label"]):
            frame = frames[int(label)]
            h, w = frame.shape[:2]
            assert any(np.array_equal(frame[t:t + SIZE, l:l + SIZE], img)
                       for t in range(h - SIZE + 1)
                       for l in range(w - SIZE + 1)), int(label)
            seen.add(int(label))
    assert seen == set(range(N_RAW))  # 24 draws over two passes


def _order(d, epoch, **kw):
    _, stream = imagenet.shuffled_records(sorted(d.glob("raw-train-*")),
                                          seed=epoch, repeat=False, **kw)
    return [imagenet.parse_raw_crop(r)[1] for r in stream]


def test_the_epoch_seeds_the_order(records):
    d, _, _ = records
    first = _order(d, 0, shuffle_buffer=4)
    assert first == _order(d, 0, shuffle_buffer=4)
    assert sorted(first) == list(range(N_RAW))
    assert _order(d, 1, shuffle_buffer=4) != first


def test_two_ranks_read_disjoint_files_covering_all(records, tmp_path):
    d, _, _ = records
    # four files, so that each rank has two
    recs = [r for f in sorted(d.glob("raw-train-*"))
            for r in imagenet.read_records(f)]
    for i in range(4):
        write_records(tmp_path / f"raw-train-{i:05d}-of-00004", recs[i::4])
    files = sorted(tmp_path.glob("raw-train-*"))
    for epoch in (0, 1):
        ranks = []
        for rank in (0, 1):
            _, stream = imagenet.shuffled_records(files, seed=epoch,
                                                  rank=rank, world=2,
                                                  repeat=False)
            ranks.append({imagenet.parse_raw_crop(r)[1] for r in stream})
        assert not ranks[0] & ranks[1]
        assert ranks[0] | ranks[1] == set(range(N_RAW))
        assert len(ranks[0]) == len(ranks[1]) == N_RAW // 2


def test_host_jitter_matches_jax_color_jitter(records):
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (5, SIZE, SIZE, 3), dtype=np.uint8)
    factors = rng.uniform(0.8, 1.2, (5, 3)).astype(np.float32)
    flips = np.array([True, False, True, False, False])
    got = imagenet.host_augment(images, flips, factors)
    assert got.dtype == np.uint8
    for i in range(5):
        src = images[i, :, ::-1] if flips[i] else images[i]
        want = jax_imagenet.color_jitter(tf.cast(src, tf.float32),
                                         *map(float, factors[i]))
        want = tf.clip_by_value(tf.round(want), 0.0, 255.0).numpy()
        assert np.abs(got[i].astype(np.float64) - want).max() <= 1
    np.testing.assert_array_equal(
        imagenet.host_augment(images, flips, None),
        np.where(flips[:, None, None, None], images[:, :, ::-1], images))


# ---------------------------------------------------------------- JPEG


def _jax_eval(d, n):
    ds = jax_imagenet.make_dataset(str(d / "validation-*"), n, SIZE,
                                   is_training=False, augment="pt")
    return next(ds.as_numpy_iterator())


def test_jpeg_eval_batch_matches_jax(records):
    d, _, blobs = records
    want_img, want_lbl = _jax_eval(d, N_VAL)
    batches = list(imagenet.val_batches(sorted(d.glob("validation-*")), 4,
                                        SIZE, augment="pt"))
    assert len(batches) == 2
    got = [b.decode("cpu") for b in batches]
    image = torch.cat([g["image"] for g in got]).numpy()
    mask = torch.cat([g["mask"] for g in got]).numpy()
    label = torch.cat([g["label"] for g in got]).numpy()
    assert mask.tolist() == [1] * N_VAL + [0]
    assert image.dtype == np.float32 and image.shape == (8, SIZE, SIZE, 3)
    np.testing.assert_array_equal(label[:N_VAL], want_lbl)
    assert not image[N_VAL:].any()
    gap = np.abs(image[:N_VAL] - want_img) * STEPS  # in uint8 steps
    assert gap.max() <= 4.0 and gap.mean() <= 1.5, (gap.max(), gap.mean())

    # the resize, crop and normalization alone, from tf's own pixels
    pixels = tf.io.decode_jpeg(blobs[0], channels=3).numpy()
    h, w = jpeg.resize_dims(*pixels.shape[:2], jpeg.resize_min_for(SIZE))
    x = jpeg.resize_bilinear(torch.from_numpy(pixels), h, w)
    top, left = (h - SIZE) // 2, (w - SIZE) // 2
    x = jpeg._normalize_f32(x[top:top + SIZE, left:left + SIZE][None],
                            "torch")[0].numpy()
    assert np.abs(x - want_img[0]).max() <= 1e-4


def test_resize_dims_are_tf_float32_ceil():
    """tf's float32 target, also where float64 rounds the other way
    ((75, 60): 321 rows in float32, 320 in float64)."""
    disagree = 0
    for h, w in [(37, 91), (333, 500), (500, 333), (81, 57), (256, 256),
                 (299, 1000), (7, 13), (75, 60), (90, 60), (60, 165)]:
        hf, wf = tf.cast(h, tf.float32), tf.cast(w, tf.float32)
        scale = 256 / tf.minimum(hf, wf)
        want = (int(tf.math.ceil(hf * scale)), int(tf.math.ceil(wf * scale)))
        assert jpeg.resize_dims(h, w, 256) == want, (h, w)
        exact = (-(-h * 256 // min(h, w)), -(-w * 256 // min(h, w)))
        disagree += exact != want
    assert disagree == 3


def test_jpeg_train_batches_decode_to_uint8_crops(records):
    d, _, _ = records
    for device_aug in (True, False):
        batches = list(imagenet.jpeg_train_batches(
            sorted(d.glob("train-*")), 4, SIZE, seed=0, steps=2,
            augment="pt", device_aug=device_aug))
        assert len(batches) == 2
        plan = batches[0].plan
        assert (plan.flips is None) == device_aug
        assert (plan.jitter is None) == device_aug
        out = batches[0].decode("cpu")
        assert out["image"].dtype == torch.uint8
        assert out["image"].shape == (4, SIZE, SIZE, 3)
        assert set(out["label"].tolist()) <= set(range(N_JPEG))


def test_feed_decodes_packed_batches_and_counts_their_jpeg_bytes(records):
    """A packed JPEG batch crosses the device feed as it is, is decoded by
    its own ``decode`` (PIL on the CPU) and counted as JPEG bytes."""
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher

    d, _, _ = records
    batches = list(imagenet.jpeg_train_batches(
        sorted(d.glob("train-*")), 4, SIZE, seed=0, steps=2, augment="pt",
        device_aug=True))
    with DevicePrefetcher(iter(batches), "cpu") as feed:
        out = list(feed)
    for packed, got in zip(batches, out):
        want = packed.decode("cpu")
        assert torch.equal(got["image"], want["image"])
        assert torch.equal(got["label"], want["label"])
    summary = feed.telemetry.summary()
    jpeg_bytes = sum(b.image_bytes for b in batches)
    assert summary["wire_dtype"] == "jpeg"
    assert summary["image_bytes_per_image"] == round(jpeg_bytes / 8, 1)
    assert jpeg_bytes == sum(len(b["jpeg"]) for b in batches)


def test_synthetic_records_cli_writes_a_directory_the_reader_reads(
        tmp_path, monkeypatch):
    """``python -m deepvision_tpu_torch.data.synthetic_records`` on the
    CPU when asked: the reader takes its raw-crop and JPEG shards, labels
    0-indexed. By default it runs on the card, and raises without one."""
    from deepvision_tpu_torch.data import synthetic_records

    d = tmp_path / "rec"
    args = [str(d), "--train", "4", "--val", "3", "--raw", "4",
            "--classes", "3"]
    assert synthetic_records.main([*args, "--device", "cpu"]) == 0
    train, val, _ = imagenet.make_imagenet_data(str(d), 2, 64, use_raw=True,
                                                steps_per_epoch=2)
    for batch in train(0):
        assert batch["image"].dtype == np.uint8
        assert batch["image"].shape == (2, 64, 64, 3)
        assert set(batch["label"].tolist()) <= {0, 1, 2}
    rows = [b.decode("cpu") for b in val()]
    assert sum(int(r["mask"].sum()) for r in rows) == 3
    assert all(set(r["label"].tolist()) <= {0, 1, 2} for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        synthetic_records.main([str(tmp_path / "card"), "--train", "1"])
    assert not (tmp_path / "card").exists()


# ---------------------------------------------------- use_raw contract


def _reads_raw(d, size, **kw):
    """Whether the reader's training batches come from the raw-crop
    shards (uint8 arrays) rather than the JPEG ones (packed batches)."""
    train, _, _ = imagenet.make_imagenet_data(str(d), 4, size,
                                              steps_per_epoch=1, **kw)
    batch = next(iter(train(0)))
    return not isinstance(batch, jpeg.PackedJpegBatch)


def test_use_raw_contract(tmp_path, capsys):
    usable = tmp_path / "usable"
    _write(usable)
    train, _, steps = imagenet.make_imagenet_data(
        str(usable), 4, SIZE, use_raw=None, steps_per_epoch=2)
    assert steps == 2
    assert "raw-frame fast path ENABLED" in capsys.readouterr().out
    batch = next(iter(train(0)))
    assert batch["image"].dtype == np.uint8
    assert batch["image"].shape == (4, SIZE, SIZE, 3)
    assert _reads_raw(usable, SIZE, use_raw=True)
    assert not _reads_raw(usable, SIZE, use_raw=False)
    # a crop as large as the stored frame takes the JPEG records
    assert not _reads_raw(usable, STORED)
    with pytest.raises(FileNotFoundError, match="use_raw=True"):
        imagenet.make_imagenet_data(str(usable), 4, STORED, use_raw=True)

    legacy = tmp_path / "legacy"
    _write(legacy, raw_meta={"stored": STORED, "count": N_RAW})
    capsys.readouterr()
    assert not _reads_raw(legacy, SIZE)
    assert "legacy center-square" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="legacy center-square"):
        imagenet.make_imagenet_data(str(legacy), 4, SIZE, use_raw=True)

    jpeg_only = tmp_path / "jpeg_only"
    _write(jpeg_only, with_raw=False)
    assert not _reads_raw(jpeg_only, SIZE)
    with pytest.raises(FileNotFoundError, match="use_raw=True"):
        imagenet.make_imagenet_data(str(jpeg_only), 4, SIZE, use_raw=True)


def test_process_shard_splits_the_global_batch(tmp_path, monkeypatch):
    _write(tmp_path)
    monkeypatch.setattr(imagenet, "process_shard", lambda: (1, 2))
    train, val, _ = imagenet.make_imagenet_data(str(tmp_path), 4, SIZE,
                                                steps_per_epoch=1)
    assert next(iter(train(0)))["image"].shape[0] == 2
    rows = [b.decode("cpu") for b in val()]
    # rank 1's rows of the global batches of 4: 2 and 1 of 7, padded to 2
    assert [r["mask"].tolist() for r in rows] == [[1, 1], [1, 0]]
    with pytest.raises(ValueError, match="not divisible"):
        imagenet.make_imagenet_data(str(tmp_path), 5, SIZE)


# ------------------------------------------- the card's colour stage


def _libjpeg_h2v2(c, rows, cols):
    """jdsample.c's h2v2_fancy_upsample, its loops transcribed."""
    c = c.astype(np.int64)
    out = np.zeros((2 * c.shape[0], 2 * c.shape[1]), np.int64)
    for r in range(2 * c.shape[0]):
        near = c[r // 2]
        far = c[max(r // 2 - 1, 0)] if r % 2 == 0 \
            else c[min(r // 2 + 1, c.shape[0] - 1)]
        this = near[0] * 3 + far[0]
        nxt = near[1] * 3 + far[1]
        o = [(this * 4 + 8) >> 4, (this * 3 + nxt + 7) >> 4]
        last, this = this, nxt
        for k in range(2, c.shape[1]):
            nxt = near[k] * 3 + far[k]
            o += [(this * 3 + last + 8) >> 4, (this * 3 + nxt + 7) >> 4]
            last, this = this, nxt
        o += [(this * 3 + last + 8) >> 4, (this * 4 + 7) >> 4]
        out[r] = o
    return out[:rows, :cols]


def _libjpeg_h2v1(c, rows, cols):
    """jdsample.c's h2v1_fancy_upsample, its loops transcribed."""
    c = c.astype(np.int64)
    out = np.zeros((c.shape[0], 2 * c.shape[1]), np.int64)
    for r in range(c.shape[0]):
        x = c[r]
        o = [x[0], (x[0] * 3 + x[1] + 2) >> 2]
        for k in range(1, len(x) - 1):
            o += [(x[k] * 3 + x[k - 1] + 1) >> 2, (x[k] * 3 + x[k + 1] + 2) >> 2]
        o += [(x[-1] * 3 + x[-2] + 1) >> 2, x[-1]]
        out[r] = o
    return out[:rows, :cols]


def _libjpeg_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert with its fixed-point tables."""
    def fix(v):
        return int(v * 65536 + 0.5)
    y, u, v = (a.astype(np.int64) for a in (y, cb - 128, cr - 128))
    r = y + ((fix(1.402) * v + 32768) >> 16)
    g = y + ((-fix(0.34414) * u + 32768 - fix(0.71414) * v) >> 16)
    b = y + ((fix(1.772) * u + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255)


@pytest.mark.parametrize("factors,h,w", [
    ((2, 2), 9, 13), ((2, 2), 8, 8), ((2, 1), 7, 11), ((1, 1), 5, 6),
    (None, 4, 7)])
def test_colour_stage_plain_version_is_libjpegs_arithmetic(factors, h, w):
    """``ycc_to_rgb_reference``, the plain twin of the card's
    ``ycc_to_rgb`` kernel, against libjpeg's loops transcribed, on random
    planes: 4:2:0 at odd and even sizes, 4:2:2, 4:4:4, gray."""
    rng = np.random.default_rng(h * w)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    if factors is None:
        got = jpeg.ycc_to_rgb_reference(torch.from_numpy(y), None, None, None)
        np.testing.assert_array_equal(got.numpy(), np.repeat(y[..., None], 3, -1))
        return
    hs, vs = factors
    ch, cw = -(-h // vs), -(-w // hs)
    cb, cr = (rng.integers(0, 256, (ch, cw), dtype=np.uint8) for _ in range(2))
    up = {(2, 2): _libjpeg_h2v2, (2, 1): _libjpeg_h2v1,
          (1, 1): lambda c, rows, cols: c.astype(np.int64)}[factors]
    want = _libjpeg_rgb(y, up(cb, h, w), up(cr, h, w))
    got = jpeg.ycc_to_rgb_reference(*map(torch.from_numpy, (y, cb, cr)),
                                    factors)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
