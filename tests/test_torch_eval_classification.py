"""``python -m deepvision_tpu_torch.eval classification`` against
``evaluate.py classification``, on the CPU.

Both CLIs score the same weights: ``evaluate.py`` runs its fresh flax
weights (no workdir; the test catches the state ``predict.load_state``
hands it), carried into a port checkpoint by ``convert/from_flax.py``.
The JSON lines must agree: the image count exactly, top-1 and top-5 to
their 4 printed decimals, the loss within 1e-4. The three branches:

- the synthetic set: ``resnet50`` (BN, the ``"pt"`` lineage) at 32 px on
  the held-out slice of ``--synthetic-size 40`` at ``--train-batch-size
  6``, which must be JAX's split (6 images, not 40 / 10);
- ImageNet records: ``validation-*`` shards written by the port's
  builder, decoded by PIL on the port's side; on the JAX side tf's decode
  is switched to its accurate IDCT, whose pixels equal PIL's (its default
  fast IDCT is a few steps off, trap C14), so that only the resize and
  the normalization differ; the last batch is padded and masked;
- MNIST idx files written here, ``lenet5``.
"""

import json
import shutil
from functools import partial

import numpy as np
import pytest
from PIL import Image

import evaluate as jax_evaluate
import predict as jax_predict
from deepvision_tpu_torch.convert.__main__ import save_as_checkpoint
from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.data.builders.imagenet import (
    build_imagenet_tfrecords,
)
from deepvision_tpu_torch.eval.__main__ import main as eval_main
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)


@pytest.fixture(autouse=True)
def _delete_what_the_test_wrote(tmp_path):
    """The shards, checkpoints and images a test writes go with it (the
    suite's workers share one temp disk)."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)

TOL = 1e-4


def _lines(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(tmp_path, capsys, monkeypatch, model, args, geometry):
    """evaluate.py's line, then the port's on the same weights."""
    states = []
    load = jax_predict.load_state

    def catch(*a, **kw):
        states.append(load(*a, **kw))
        return states[-1]

    monkeypatch.setattr(jax_predict, "load_state", catch)
    jax_evaluate.main(["classification", "-m", model, *args])
    want = _lines(capsys)
    state = states[0]
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    sd = flax_to_torch(model, variables, **geometry)
    save_as_checkpoint(sd, model, str(tmp_path / "wd"), device="cpu",
                       **geometry)
    eval_main(["classification", "-m", model, "--workdir",
               str(tmp_path / "wd" / model), "--device", "cpu", *args])
    got = _lines(capsys)
    return got, want


def _assert_same_line(got, want):
    assert got["metric"] == want["metric"] == "classification_eval"
    assert got["images"] == want["images"]
    for k in ("val_top1", "val_top5"):
        assert got[k] == want[k], (k, got, want)
    assert abs(got["val_loss"] - want["val_loss"]) <= TOL + 1e-9


def test_synthetic_held_out_split_equals_evaluate_py(tmp_path, capsys,
                                                     monkeypatch):
    args = ["--num-classes", "5", "--input-size", "32", "--batch-size", "8",
            "--synthetic-size", "40", "--train-batch-size", "6"]
    got, want = _both(tmp_path, capsys, monkeypatch, "resnet50", args,
                      {"num_classes": 5, "input_size": 32})
    assert got["images"] == 6
    _assert_same_line(got, want)


def test_imagenet_records_equal_evaluate_py(tmp_path, capsys, monkeypatch):
    import tensorflow as tf

    rng = np.random.default_rng(0)
    images = tmp_path / "images"
    images.mkdir()
    wnids = ["n01440764", "n01443537", "n01484850"]
    for i in range(7):
        low = Image.fromarray(rng.integers(0, 256, (4, 4, 3), np.uint8))
        low.resize((40 + 5 * i, 48), Image.BILINEAR).save(
            images / f"{wnids[i % 3]}_{i}.JPEG", "JPEG", quality=90)
    (tmp_path / "synsets.txt").write_text("\n".join(wnids) + "\n")
    build_imagenet_tfrecords(images, tmp_path / "synsets.txt",
                             tmp_path / "rec", "validation", num_shards=2,
                             num_workers=1, device="cpu")
    monkeypatch.setattr(tf.io, "decode_jpeg", partial(
        tf.io.decode_jpeg, dct_method="INTEGER_ACCURATE"))
    args = ["--data-dir", str(tmp_path / "rec"), "--num-classes", "3",
            "--input-size", "32", "--batch-size", "8"]
    got, want = _both(tmp_path, capsys, monkeypatch, "resnet50", args,
                      {"num_classes": 3, "input_size": 32})
    assert got["images"] == 7
    _assert_same_line(got, want)


def _idx(path, array: np.ndarray) -> None:
    dims = b"".join(int(d).to_bytes(4, "big") for d in array.shape)
    code = 0x08  # unsigned bytes
    path.write_bytes(bytes([0, 0, code, array.ndim]) + dims
                     + array.astype(np.uint8).tobytes())


def test_mnist_idx_equals_evaluate_py(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (37, 28, 28)).astype(np.uint8)
    _idx(tmp_path / "t10k-images-idx3-ubyte", images)
    _idx(tmp_path / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 37))
    args = ["--data-dir", str(tmp_path), "--batch-size", "16"]
    got, want = _both(tmp_path, capsys, monkeypatch, "lenet5", args,
                      {"num_classes": 10, "input_size": 32})
    assert got["images"] == 37
    _assert_same_line(got, want)


def test_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_main(["classification", "-m", "lenet5"])
