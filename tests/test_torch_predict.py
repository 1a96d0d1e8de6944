"""``python -m deepvision_tpu_torch.predict`` against ``predict.py``, on
the CPU.

Each subcommand runs on both sides on the same weights: ``predict.py``
runs its fresh flax weights (no workdir), which the test catches as the
CLI uses them (its ``load_served``, or the GAN state its sampling and
translation receive), carries into the port by ``convert/from_flax.py``
and saves as a port checkpoint that the port's CLI restores. The images
are PNGs made with numpy from a seed (lossless, so both decoders give the
same pixels and only the resize differs); a JPEG's pixels stay within
the decode bounds of ``tests/test_torch_imagenet.py`` (tf's fast IDCT
against PIL's accurate one). Held to 1e-4: the loaded images, the top-k
(classes equal), boxes, joints (and 1e-4 relative on the confidences)
and GAN pixels. DCGAN samples from an
explicit ``z`` on both sides (trap C6: threefry and Philox never agree).
The PNG writer's pixels equal ``tf.io.encode_png``'s; ``curves`` plots a
checkpoint's history and without matplotlib says so; the default device
raises without a card.
"""

import io
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import predict as jax_predict
from deepvision_tpu.serve import models as jax_models
from deepvision_tpu.train import gan as jax_gan
from deepvision_tpu_torch import predict
from deepvision_tpu_torch.convert.__main__ import save_as_checkpoint
from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.serve import models as port_models
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
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


def _photo(rng, h, w):
    """A smooth seeded uint8 RGB image (a 5x5 field upsampled, noise)."""
    low = Image.fromarray(rng.integers(0, 256, (5, 5, 3), dtype=np.uint8))
    up = np.asarray(low.resize((w, h), Image.BILINEAR), np.float32)
    return np.clip(np.round(up + rng.normal(0, 3, (h, w, 3))), 0,
                   255).astype(np.uint8)


def _write(path, pixels, fmt="PNG"):
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, fmt, **({"quality": 90}
                                              if fmt == "JPEG" else {}))
    path.write_bytes(buf.getvalue())
    return str(path)


@pytest.fixture
def captured(monkeypatch):
    """What both CLIs hand on: each side's ``load_served`` (its served
    model and every result it post-processes) and ``save_image``."""
    out = {"jax": {"results": [], "images": []},
           "port": {"results": [], "images": []}}

    def wrap_load(side, original):
        def load(*args, **kwargs):
            served = original(*args, **kwargs)
            out[side]["served"] = served
            post = served.postprocess

            def postprocess(host, i):
                res = post(host, i)
                out[side]["results"].append(res)
                return res

            served.postprocess = postprocess
            return served
        return load

    def wrap_save(side, original):
        def save(path, img):
            out[side]["images"].append(np.array(img))
            return original(path, img)
        return save

    monkeypatch.setattr(jax_models, "load_served",
                        wrap_load("jax", jax_models.load_served))
    monkeypatch.setattr(port_models, "load_served",
                        wrap_load("port", port_models.load_served))
    monkeypatch.setattr(jax_predict, "save_image",
                        wrap_save("jax", jax_predict.save_image))
    monkeypatch.setattr(predict, "save_image",
                        wrap_save("port", predict.save_image))
    return out


def _carry(name, variables, workdir, **geometry):
    """The flax variables as a port checkpoint under ``workdir/name``."""
    variables = {k: v for k, v in variables.items() if v}
    sd = flax_to_torch(name, variables, **geometry)
    save_as_checkpoint(sd, name, str(workdir), device="cpu", **geometry)
    return str(workdir / name)


@pytest.mark.parametrize("scale", ["imagenet", "torch", "unit", "tanh"])
def test_load_image_equals_predict_py(tmp_path, scale):
    rng = np.random.default_rng(0)
    png = _write(tmp_path / "a.png", _photo(rng, 41, 57))
    gray = tmp_path / "g.png"
    Image.fromarray(_photo(rng, 30, 30)).convert("LA").save(gray)
    for path in (png, str(gray)):
        got = predict.load_image(path, 32, scale=scale, device="cpu")
        want = jax_predict.load_image(path, 32, scale=scale)
        assert got.shape == want.shape == (1, 32, 32, 3)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    jpg = _write(tmp_path / "a.jpg", _photo(rng, 64, 48), "JPEG")
    gap = np.abs(predict.load_image(jpg, 64, scale="unit", device="cpu")
                 - jax_predict.load_image(jpg, 64, scale="unit")) * 255
    assert gap.max() <= 4 and gap.mean() <= 1.5, (gap.max(), gap.mean())


def test_png_writer_equals_tf_encode_png(tmp_path):
    import tensorflow as tf

    rng = np.random.default_rng(1)
    for shape in ((17, 23, 3), (9, 5, 1), (6, 7, 4)):
        pixels = rng.integers(0, 256, shape, dtype=np.uint8)
        from deepvision_tpu_torch.data.image_io import encode_png

        ours = tf.io.decode_png(encode_png(pixels),
                                channels=shape[-1]).numpy()
        theirs = tf.io.decode_png(tf.io.encode_png(pixels),
                                  channels=shape[-1]).numpy()
        np.testing.assert_array_equal(ours, theirs)
        np.testing.assert_array_equal(ours, pixels)
    img = rng.uniform(-1, 1, (8, 8, 1)).astype(np.float32)
    written = predict.save_image(str(tmp_path / "s.png"), img)
    jax_predict.save_image(str(tmp_path / "t.png"), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "s.png")),
        np.asarray(Image.open(tmp_path / "t.png")))
    assert written.shape == (8, 8, 3)


@pytest.mark.parametrize("model", ["lenet5", "alexnet1"])
def test_classify_equals_predict_py(tmp_path, captured, model):
    """``lenet5`` (grayscale, unit scale) and ``alexnet1`` (its LRNs on
    the plain version here): the same top-5 classes, probabilities within
    1e-4."""
    rng = np.random.default_rng(2)
    imgs = [_write(tmp_path / f"{i}.png", _photo(rng, 50 + 9 * i, 70))
            for i in range(2)]
    jax_predict.main(["classify", "-m", model, *imgs,
                      "--num-classes", "10"])
    served = captured["jax"]["served"]
    wd = _carry(model, served.variables, tmp_path / "wd", num_classes=10,
                input_size=served.input_shape[0])
    predict.main(["classify", "-m", model, "--workdir", wd, *imgs,
                  "--num-classes", "10", "--device", "cpu"])
    got, want = captured["port"]["results"], captured["jax"]["results"]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a["classes"] == list(b["classes"])
        np.testing.assert_allclose(a["probs"], b["probs"], atol=TOL)


def test_detect_equals_predict_py(tmp_path, captured):
    """``yolov3`` at 64 px: the boxes kept at score 0.7, their scores and
    classes, and the drawn canvas. Fresh ``yolov3`` weights saturate on a
    full-contrast image (every score 1.0, boxes at inf, on both sides), so
    the image is low-contrast noise (127 or 128, about 0.004 in the tanh
    scale), on which the scores spread out."""
    px = 127 + np.random.default_rng(3).integers(0, 2, (80, 96, 3))
    img = _write(tmp_path / "d.png", px.astype(np.uint8))
    args = ["detect", img, "--size", "64", "--score", "0.7"]
    jax_predict.main([*args, "-o", str(tmp_path / "j.png")])
    wd = _carry("yolov3", captured["jax"]["served"].variables,
                tmp_path / "wd", num_classes=20, input_size=64)
    predict.main([*args, "-o", str(tmp_path / "p.png"), "--workdir", wd,
                  "--device", "cpu"])
    (a,), (b,) = captured["port"]["results"], captured["jax"]["results"]
    assert len(a["boxes"]) == len(b["boxes"]) > 0
    assert a["classes"] == list(b["classes"])
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=TOL)
    np.testing.assert_allclose(a["scores"], b["scores"], atol=TOL)
    (pa,), (pb,) = captured["port"]["images"], captured["jax"]["images"]
    np.testing.assert_array_equal(pa, pb)


def test_pose_equals_predict_py(tmp_path, captured):
    """``hourglass104`` at 64 px: 16 joints, each (x, y, conf)."""
    img = _write(tmp_path / "p.png", _photo(np.random.default_rng(4), 70, 60))
    args = ["pose", img, "--size", "64"]
    jax_predict.main([*args, "-o", str(tmp_path / "j.png")])
    wd = _carry("hourglass104", captured["jax"]["served"].variables,
                tmp_path / "wd", num_classes=1000, input_size=64)
    predict.main([*args, "-o", str(tmp_path / "q.png"), "--workdir", wd,
                  "--device", "cpu"])
    (a,), (b,) = captured["port"]["results"], captured["jax"]["results"]
    assert len(a["joints"]) == 16
    # fresh BN statistics blow the heatmaps up to about 1e9: relative
    np.testing.assert_allclose(a["joints"], b["joints"], atol=TOL, rtol=TOL)


def test_dcgan_grid_equals_predict_py_on_the_same_z(tmp_path, captured,
                                                    monkeypatch):
    from deepvision_tpu_torch.train.gan import create_dcgan_state

    z = np.random.default_rng(5).normal(size=(5, 100)).astype(np.float32)
    states = []

    def sample(state, key, n):  # predict.py's sampler on the explicit z
        states.append(state)
        return state.g_apply({"params": state.params["generator"],
                              "batch_stats": state.batch_stats["generator"]},
                             z[:n], train=False)

    monkeypatch.setattr(jax_gan, "dcgan_sample", sample)
    monkeypatch.setattr(predict, "sample_noise",
                        lambda n, dim, seed, device: z[:n])
    jax_predict.main(["dcgan", "-n", "5", "-o", str(tmp_path / "j.png")])
    (state,) = states
    port = create_dcgan_state(device="cpu")
    port.modules["generator"].load_state_dict(flax_to_torch(
        "dcgan_generator", {"params": state.params["generator"],
                            "batch_stats": state.batch_stats["generator"]}))
    CheckpointManager(tmp_path / "wd" / "ckpt").save(
        0, port, config={"name": "dcgan", "noise_dim": 100})
    predict.main(["dcgan", "-n", "5", "--workdir", str(tmp_path / "wd"),
                  "-o", str(tmp_path / "p.png"), "--device", "cpu"])
    (got,), (want,) = captured["port"]["images"], captured["jax"]["images"]
    assert got.shape == want.shape == (84, 84, 1)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_cyclegan_equals_predict_py(tmp_path, captured, monkeypatch):
    from deepvision_tpu_torch.train.gan import create_cyclegan_state

    img = _write(tmp_path / "c.png", _photo(np.random.default_rng(6), 40, 36))
    states = []
    translate = jax_gan.cyclegan_translate

    def catch(state, images, direction="a2b"):
        states.append(state)
        return translate(state, images, direction)

    monkeypatch.setattr(jax_gan, "cyclegan_translate", catch)
    args = ["cyclegan", img, "--size", "32", "--direction", "b2a"]
    jax_predict.main([*args, "-o", str(tmp_path / "j.png")])
    (state,) = states
    port = create_cyclegan_state(lr_schedule=lambda count: 2e-4,
                                 image_size=32, device="cpu")
    for net in ("gen_a2b", "gen_b2a"):
        port.modules[net].load_state_dict(flax_to_torch(
            "cyclegan_generator", {"params": state.params[net],
                                   "batch_stats": state.batch_stats[net]}))
    CheckpointManager(tmp_path / "wd" / "ckpt").save(
        0, port, config={"name": "cyclegan", "input_size": 32})
    predict.main([*args, "-o", str(tmp_path / "p.png"), "--workdir",
                  str(tmp_path / "wd"), "--device", "cpu"])
    (got,), (want,) = captured["port"]["images"], captured["jax"]["images"]
    assert got.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_curves_and_the_default_device(tmp_path, capsys, monkeypatch):
    from deepvision_tpu_torch.train.loggers import Loggers

    module = port_models.restore_state("lenet5", device="cpu",
                                       num_classes=10)[0]
    save = save_as_checkpoint(module.state_dict(), "lenet5", str(tmp_path),
                              num_classes=10, input_size=32, device="cpu")
    mgr = CheckpointManager(save)
    loggers = Loggers()
    for e in range(3):
        loggers.log_metrics(e, {"train_loss": 2.0 - e / 2,
                                "val_top1": 0.3 + e / 5})
    from deepvision_tpu_torch.train.state import TrainState

    mgr.save(2, TrainState(module, torch.optim.SGD(module.parameters(),
                                                   lr=0.1)),
             loggers=loggers)
    wd = str(tmp_path / "lenet5")
    predict.main(["curves", "--workdir", wd, "-o", str(tmp_path / "c.png")])
    assert "2 curves" in capsys.readouterr().out
    assert (tmp_path / "c.png").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="needs matplotlib"):
        predict.main(["curves", "--workdir", wd])
    img = _write(tmp_path / "x.png", _photo(np.random.default_rng(7), 8, 8))
    for argv in (["classify", "-m", "lenet5", img], ["detect", img],
                 ["pose", img], ["dcgan"], ["cyclegan", img]):
        with pytest.raises(RuntimeError, match="CUDA"):
            predict.main(argv)
