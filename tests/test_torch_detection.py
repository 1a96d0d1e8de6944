"""The port's detection data, augmentation, Adam, CLIs and mAP against the
JAX package's, on the CPU.

Records are written inside the tests by the port's writer
(``data/synthetic_records.write_synthetic_detection``, PIL on the CPU)
and read by both readers: boxes and labels exactly, pixels within the
JPEG decoders' bound (tf's default IDCT is libjpeg's fast one, PIL's the
accurate one: at most 4 uint8 steps, 1.5 on average, trap C14). The crop
window is held against the JAX ``random_crop`` on the same draws (its
``tf.random.uniform`` replaced by planted values), the resize to tf's to
1e-4 in normalized units (trap C9), the box twins of the device
augmentation op for op, Adam against optax, and ``evaluate_map`` against
the JAX function for both AP methods. The CLIs run ``yolov3`` at full
width on the CPU: training (synthetic, then resumed; from records with
``--device-aug``), serving from the checkpoint, and ``eval detection``.
"""

import io
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorflow as tf
import torch

from deepvision_tpu.data import detection as jax_det
from deepvision_tpu.data import device_aug as jax_aug
from deepvision_tpu.eval import detection as jax_eval
from deepvision_tpu.train import optimizers as jax_optimizers
from deepvision_tpu_torch.data import detection, device_aug
from deepvision_tpu_torch.data.synthetic_records import (
    write_synthetic_detection,
)
from deepvision_tpu_torch.data.tfrecord import read_records
from deepvision_tpu_torch.eval import evaluate_map
from deepvision_tpu_torch.eval.__main__ import main as eval_main
from deepvision_tpu_torch.serve.__main__ import main as serve_main
from deepvision_tpu_torch.serve.models import load_served
from deepvision_tpu_torch.train.__main__ import main as train_main
from deepvision_tpu_torch.train.optimizers import (
    ScheduledRMSprop,
    make_optimizer,
    set_lr_scale,
)
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CLASSES = 3
STEPS = 255 / 2  # uint8 steps per unit of [-1, 1]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("det")
    write_synthetic_detection(d, train=8, val=5, classes=CLASSES, shards=2,
                              device="cpu")
    return d


def _records(d, prefix):
    return [r for p in sorted(d.glob(f"{prefix}-*"))
            for r in read_records(p)]


# ---------------------------------------------------------- records


def test_record_parse_matches_the_jax_parser(records):
    for rec in _records(records, "train") + _records(records, "val"):
        image, boxes, labels = jax_det.parse_detection_example(
            tf.constant(rec))
        blob, corners, lbl = detection.parse_detection_record(rec)
        np.testing.assert_array_equal(corners, boxes.numpy())
        np.testing.assert_array_equal(lbl, labels.numpy())
        assert lbl.dtype == np.int32 and lbl.min() >= 0
        assert detection.jpeg_size(blob) == tuple(image.shape[:2])
        assert 300 <= min(image.shape[:2]) and max(image.shape[:2]) <= 500


class _Planted:
    """``tf.random.uniform`` returning planted draws in order, with tf's
    own ``u · (maxval - minval) + minval`` in float32."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape, minval=0.0, maxval=None, seed=None, **_):
        u = tf.constant(np.float32(self.draws.pop(0)))
        if maxval is None:
            return u
        return u * (maxval - minval) + minval


CROP_DRAWS = [
    [0.2, 0.5, 0.5, 0.5, 0.5],
    [0.4, 0.999, 0.001, 0.7, 0.999],
    [0.0, 0.0, 0.0, 0.0, 0.0],
    [0.3, 0.123, 0.877, 0.333, 0.25],
    [0.6, 0.5, 0.5, 0.5, 0.5],  # the coin says no crop
]


@pytest.mark.parametrize("draws", CROP_DRAWS)
def test_crop_window_and_boxes_match_jax_random_crop(records, draws,
                                                     monkeypatch):
    """The window's pixels and the renormalized boxes on the same draws,
    on every record."""
    for rec in _records(records, "train")[:4]:
        image, boxes, _ = jax_det.parse_detection_example(tf.constant(rec))
        monkeypatch.setattr(tf.random, "uniform", _Planted(draws))
        want_img, want_boxes = jax_det.random_crop(image, boxes)
        blob, corners, _ = detection.parse_detection_record(rec)
        h, w = detection.jpeg_size(blob)
        window = detection.crop_window(corners, h, w, draws)
        if draws[0] >= 0.5:
            assert window is None
            np.testing.assert_array_equal(want_boxes.numpy(), corners)
            continue
        top, left, th, tw = window
        pixels = image.numpy()
        np.testing.assert_array_equal(
            want_img.numpy(), pixels[top:top + th, left:left + tw])
        np.testing.assert_array_equal(
            detection.crop_corners(corners, window, h, w),
            want_boxes.numpy())
    assert detection.crop_window(np.zeros((0, 4), np.float32), 300, 400,
                                 CROP_DRAWS[0]) is None


def test_flip_matches_jax_random_flip(records, monkeypatch):
    rec = _records(records, "val")[0]
    image, boxes, _ = jax_det.parse_detection_example(tf.constant(rec))
    monkeypatch.setattr(tf.random, "uniform", _Planted([0.1]))
    want_img, want_boxes = jax_det.random_flip(image, boxes)
    _, corners, _ = detection.parse_detection_record(rec)
    np.testing.assert_array_equal(detection.flip_corners(corners),
                                  want_boxes.numpy())
    np.testing.assert_array_equal(
        torch.from_numpy(image.numpy()).flip(1).numpy(), want_img.numpy())


@pytest.mark.parametrize("as_uint8", [False, True])
def test_to_model_inputs_matches_jax(records, as_uint8):
    """From tf's own pixels: the resize to 1e-4 in normalized units (the
    uint8 wire within one step, where the two sums round either side of
    a half), boxes and padded labels exactly."""
    for rec in _records(records, "val")[:3]:
        image, boxes, labels = jax_det.parse_detection_example(
            tf.constant(rec))
        want = jax_det.to_model_inputs(image, boxes, labels, 64, as_uint8)
        got = detection.to_model_inputs(torch.from_numpy(image.numpy()),
                                        boxes.numpy(), labels.numpy(), 64,
                                        as_uint8)
        if as_uint8:
            assert got[0].dtype == torch.uint8
            gap = np.abs(got[0].numpy().astype(int) - want[0].numpy())
            assert gap.max() <= 1 and (gap > 0).mean() < 0.01
        else:
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                       atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[1], want[1].numpy())
        np.testing.assert_array_equal(got[2], want[2].numpy())
        assert got[1].shape == (detection.MAX_BOXES, 4)


def test_eval_batches_match_the_jax_reader(records):
    """Both readers over the same shards: boxes and labels exactly, the
    pixels within the decoders' bound; the last batch padded and masked.
    tf.data interleaves the shards' records (parallel reads) where the
    port reads them file by file, so rows are matched by their boxes."""
    ds = jax_det.make_detection_dataset(str(records / "val-*"), 8, 64,
                                        is_training=False)
    want_img, want_boxes, want_lbl = next(ds.as_numpy_iterator())
    batches = list(detection.eval_batches(sorted(records.glob("val-*")), 4,
                                          64))
    assert len(batches) == 2
    got = [b.decode("cpu") for b in batches]
    cat = {k: torch.cat([g[k] for g in got]).numpy() for k in got[0]}
    assert cat["mask"].tolist() == [1] * 5 + [0] * 3
    mine = {tuple(b[0]): i for i, b in enumerate(cat["boxes"][:5])}
    order = [mine[tuple(b[0])] for b in want_boxes]
    assert sorted(order) == list(range(5))
    cat = {k: v[order + [5, 6, 7]] for k, v in cat.items()}
    np.testing.assert_array_equal(cat["boxes"][:5], want_boxes)
    np.testing.assert_array_equal(cat["label"][:5], want_lbl)
    assert not cat["image"][5:].any() and not cat["boxes"][5:].any()
    gap = np.abs(cat["image"][:5] - want_img) * STEPS
    assert gap.max() <= 4.0 and gap.mean() <= 1.5, (gap.max(), gap.mean())


def test_train_batches_are_seeded_by_the_epoch(records):
    """The host's decisions come from the epoch's generator: one epoch
    twice gives the same batches, another epoch others; every real box
    stays inside the image after the flip and the crop, and the decoded
    images are uint8 under ``device_aug``."""
    files = sorted(records.glob("train-*"))

    def run(epoch, aug=False):
        return list(detection.train_batches(files, 4, 64, seed=epoch,
                                            steps=2, device_aug=aug))

    a, b, c = run(0), run(0), run(1)
    assert len(a) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["boxes"], y["boxes"])
        np.testing.assert_array_equal(x.plan.flips, y.plan.flips)
        assert x.plan.windows == y.plan.windows
    assert any(not np.array_equal(x["boxes"], y["boxes"])
               for x, y in zip(a, c))
    for batch in a:
        real = batch["label"] >= 0
        xywh = batch["boxes"][real]
        assert (xywh[:, :2] - xywh[:, 2:] / 2 >= -1e-6).all()
        assert (xywh[:, :2] + xywh[:, 2:] / 2 <= 1 + 1e-6).all()
        out = batch.decode("cpu")
        assert out["image"].dtype == torch.float32
        assert out["image"].shape == (4, 64, 64, 3)
    aug = run(0, aug=True)
    assert not any(p.plan.flips.any() for p in aug)
    assert aug[0].decode("cpu")["image"].dtype == torch.uint8


# ------------------------------------------------ device augmentation


def test_box_twins_of_the_device_augmentation_match_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0.1, 0.6, (4, 10, 4)).astype(np.float32)
    labels = rng.integers(-1, 3, (4, 10)).astype(np.int32)
    boxes[labels < 0] = 0.0
    flips = np.array([True, False, True, False])
    np.testing.assert_array_equal(
        device_aug.flip_boxes(torch.from_numpy(boxes),
                              torch.from_numpy(labels),
                              torch.from_numpy(flips)).numpy(),
        np.asarray(jax_aug.flip_boxes(boxes, labels, flips)))
    tops = np.array([0, 5, 17, 32])
    lefts = np.array([3, 0, 32, 11])
    want = jax_aug.crop_boxes(boxes, labels, tops, lefts, 96, 96, 64)
    got = device_aug.crop_boxes(torch.from_numpy(boxes),
                                torch.from_numpy(labels),
                                torch.from_numpy(tops),
                                torch.from_numpy(lefts), 96, 96, 64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy() < 0).sum() > (labels < 0).sum()  # some dropped


def test_detection_family_flips_images_and_boxes_together():
    """``DeviceAugment("detection")``: a sample whose image is flipped
    has its real boxes mirrored, the others keep theirs."""
    images = torch.zeros(8, 16, 16, 3, dtype=torch.uint8)
    images[:, :, :4] = 255  # a bright left edge
    boxes = torch.zeros(8, 5, 4)
    boxes[:, 0] = torch.tensor([0.125, 0.5, 0.25, 1.0])
    labels = torch.full((8, 5), -1, dtype=torch.int32)
    labels[:, 0] = 1
    aug = device_aug.DeviceAugment("detection", flip=True)
    out = aug({"image": images, "boxes": boxes, "label": labels}, seed=3)
    flipped = out["image"][:, 0, -1, 0] == 255
    assert 0 < int(flipped.sum()) < 8
    cx = out["boxes"][:, 0, 0]
    torch.testing.assert_close(cx, torch.where(flipped, 0.875, 0.125))
    assert not out["boxes"][:, 1:].any()
    with pytest.raises(ValueError, match="unknown device augmentation"):
        device_aug.DeviceAugment("segmentation")


def test_synthetic_detection_matches_jax():
    want = jax_det.synthetic_detection(12, size=32, num_classes=CLASSES)
    got = detection.synthetic_detection(12, size=32, num_classes=CLASSES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    mine = list(detection.synthetic_batches(
        *got, 4, rng=np.random.default_rng(5), augment=True))
    theirs = list(jax_det.synthetic_batches(
        *want, 4, rng=np.random.default_rng(5), augment=True))
    for m, t in zip(mine, theirs):
        for k in t:
            np.testing.assert_array_equal(m[k], t[k])
    tail = list(detection.synthetic_batches(*got, 5, drop_remainder=False))
    assert tail[-1]["mask"].tolist() == [1, 1, 0, 0, 0]


# -------------------------------------------------------------- Adam


def test_adam_matches_optax_under_the_plateau_scale():
    """``yolov3``'s Adam (0.01) against optax's ``adam`` inside
    ``inject_hyperparams`` over the LR scale, 4 steps with the scale
    cut to 0.1 after two; rmsprop builds optax's RMSprop, not
    ``torch.optim.RMSprop`` (trap C7)."""
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1e-3 * (i + 1), s).astype(np.float32)
              for s in shapes] for i in range(4)]
    cfg = {"optimizer": "adam", "optimizer_params": {"lr": 0.01},
           "scheduler": "plateau", "scheduler_params": {"mode": "max"}}
    tx, _ = jax_optimizers.make_optimizer(cfg, 1)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, plateau = make_optimizer(cfg, tp)
    assert isinstance(opt, torch.optim.Adam) and plateau is not None
    assert not opt.param_groups[0]["capturable"]  # the CPU's tensors
    for i, g in enumerate(grads):
        if i == 2:
            state = jax_optimizers.set_lr_scale(state, 0.1)
            set_lr_scale(opt, 0.1)
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for p, j in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   atol=1e-6, rtol=1e-6)
    rms, _ = make_optimizer({"optimizer": "rmsprop",
                             "optimizer_params": {"lr": 0.1}}, tp)
    assert isinstance(rms, ScheduledRMSprop)
    assert not isinstance(rms, torch.optim.RMSprop)


# --------------------------------------------------------------- mAP


def _detections(seed, n_images=24):
    rng = np.random.default_rng(seed)
    dets, gts = [], []
    for _ in range(n_images):
        m = int(rng.integers(0, 4))
        g = rng.uniform(0, 0.6, (m, 2))
        gb = np.concatenate([g, g + rng.uniform(0.1, 0.4, (m, 2))], -1)
        gts.append({"boxes": gb, "classes": rng.integers(0, CLASSES, m)})
        k = int(rng.integers(0, 6))
        pick = rng.integers(0, max(m, 1), k)
        db = (gb[pick] if m else rng.uniform(0, 1, (k, 4))) + rng.normal(
            0, 0.03, (k, 4))
        cls = (gts[-1]["classes"][pick] if m
               else rng.integers(0, CLASSES, k))
        flip = rng.random(k) < 0.2
        cls = np.where(flip, (cls + 1) % CLASSES, cls)
        dets.append({"boxes": db.astype(np.float32),
                     "scores": rng.uniform(0, 1, k).astype(np.float32),
                     "classes": cls})
    dets[0]["boxes"][:1] = np.inf  # an untrained head's overflow
    return dets, gts


@pytest.mark.parametrize("method", ["area", "11point"])
def test_evaluate_map_matches_jax(method):
    dets, gts = _detections(0)
    for iou in (0.5, 0.75):
        want = jax_eval.evaluate_map(dets, gts, CLASSES, iou_thresh=iou,
                                     method=method)
        got = evaluate_map(dets, gts, CLASSES, iou_thresh=iou,
                           method=method)
        assert got["map"] == want["map"] and 0 < got["map"] < 1
        np.testing.assert_array_equal(got["ap"], want["ap"])
        np.testing.assert_array_equal(got["num_gt"], want["num_gt"])


# -------------------------------------------------------------- CLIs


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_cli_trains_yolov3_resumes_serves_and_evaluates(tmp_path, capsys):
    """Synthetic: one epoch, then the second on ``--resume``; the served
    answers of the newest checkpoint equal ``load_served``'s; ``eval
    detection`` prints its JSON line."""
    common = ["-m", "yolov3", "--device", "cpu", "--input-size", "64",
              "--num-classes", str(CLASSES), "--batch-size", "4",
              "--synthetic-size", "24", "--steps-per-epoch", "2",
              "--workdir", str(tmp_path)]
    assert train_main([*common, "--epochs", "1"]) == 0
    out = capsys.readouterr()
    assert "[epoch 0]" in out.out and "val_loss" in out.out
    assert "'nms_sweep': 0" in out.err
    assert train_main([*common, "--epochs", "2", "--resume"]) == 0
    out = capsys.readouterr()
    assert "resumed at epoch 1" in out.out and "[epoch 1]" in out.out
    assert "checkpoints [0, 1]" in out.err
    workdir = str(tmp_path / "yolov3")

    x = (np.random.default_rng(0).uniform(-1, 1, (3, 64, 64, 3))
         .astype(np.float32))
    lines = "".join(json.dumps({"id": i, "input": x[i].tolist()}) + "\n"
                    for i in range(3))
    stdout = io.StringIO()
    serve_main(["-m", f"yolov3={workdir}", "--device", "cpu", "--buckets",
                "1,4", "--score", "0.05"], stdin=io.StringIO(lines),
               stdout=stdout)
    replies = [json.loads(s) for s in stdout.getvalue().splitlines()]
    served = load_served("yolov3", workdir, device="cpu",
                         score_thresh=0.05)
    assert served.task == "detect" and served.input_shape == (64, 64, 3)
    host = served.run(x)
    for r in replies:
        want = served.postprocess(host, r["id"])
        assert set(r["result"]) == {"boxes", "scores", "classes"}
        assert r["result"]["classes"] == want["classes"]
        np.testing.assert_allclose(np.array(r["result"]["scores"]),
                                   want["scores"], atol=1e-6)
    capsys.readouterr()

    assert eval_main(["detection", "--workdir", workdir, "--num-classes",
                      str(CLASSES), "--size", "64", "--batch-size", "8",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr()
    line = _last_json(out.out)
    assert line["metric"] == "mAP" and line["images"] == 64
    assert 0.0 <= line["value"] <= 1.0
    assert isinstance(line["nms_candidates_max"], int)
    assert line["nms_exact"] == (line["nms_candidates_max"] <= 512)
    assert "'nms_sweep': 0" in out.err
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_trains_yolov3_from_records_with_device_aug(records, tmp_path,
                                                        capsys):
    """``--data-dir`` over the records, ``--device-aug`` (the flip in
    the step, uint8 over the wire), then ``eval detection`` over their
    ``val-*`` shards; ``--mixup`` and ``--raw`` stay refused."""
    common = ["-m", "yolov3", "--device", "cpu", "--input-size", "64",
              "--num-classes", str(CLASSES), "--batch-size", "4",
              "--data-dir", str(records), "--workdir", str(tmp_path)]
    assert train_main([*common, "--device-aug", "--steps-per-epoch", "2",
                       "--epochs", "1"]) == 0
    out = capsys.readouterr()
    assert "DeviceAugment(detection, flip)" in out.out
    assert "wire jpeg" in out.out
    epoch = [s for s in out.out.splitlines() if s.startswith("[epoch 0]")]
    loss = float(epoch[0].split("train_loss=")[1].split()[0])
    assert np.isfinite(loss)
    for bad in (["--mixup", "0.2", "--device-aug"], ["--raw"]):
        with pytest.raises(SystemExit):
            train_main([*common, *bad, "--epochs", "1"])
    capsys.readouterr()
    assert eval_main(["detection", "--workdir", str(tmp_path / "yolov3"),
                      "--data-dir", str(records), "--num-classes",
                      str(CLASSES), "--size", "64", "--batch-size", "4",
                      "--device", "cpu"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert line["images"] == 5 and set(line["per_class"]) <= {
        "aeroplane", "bicycle", "bird"}
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_new_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``eval detection`` and ``write_synthetic_detection`` raise without
    a card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        eval_main(["detection", "--num-classes", str(CLASSES)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        write_synthetic_detection(tmp_path, train=1, val=1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_served("yolov3")
