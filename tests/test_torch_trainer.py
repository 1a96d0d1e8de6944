"""The port's training loop on the CPU, against the JAX Trainer.

The device feed (order, exceptions, shutdown), checkpoints (round trip
under a verified manifest, a tampered file refused), resume (bit for bit
with the uninterrupted run), the training CLI driven in-process, serving
from a port checkpoint, and the whole slice: the port's ``Trainer``
against the JAX ``Trainer`` over one epoch of 3 steps from the same
weights, dropout off on both sides, float32, validation to 1e-4.
"""

import shutil
import threading
from functools import partial

import jax
import numpy as np
import pytest
import torch

from deepvision_tpu.data.mnist import batches as jax_batches
from deepvision_tpu.data.synthetic import (
    synthetic_classification as jax_synthetic,
)
from deepvision_tpu.models import get_model as flax_get_model
from deepvision_tpu.train.configs import get_config as jax_get_config
from deepvision_tpu.train.steps import (
    classification_eval_step as jax_eval_step,
    classification_train_step as jax_train_step,
)
from deepvision_tpu.train.trainer import Trainer as JaxTrainer
from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.data.mnist import batches
from deepvision_tpu_torch.data.prefetch import DevicePrefetcher, FeedTelemetry
from deepvision_tpu_torch.data.synthetic import synthetic_classification
from deepvision_tpu_torch import models
from deepvision_tpu_torch.models import create_model, layers
from deepvision_tpu_torch.serve import load_served
from deepvision_tpu_torch.train import manifest
from deepvision_tpu_torch.train.__main__ import main as train_main
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import (
    classification_eval_step,
    classification_train_step,
)
from deepvision_tpu_torch.train.trainer import Trainer
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

CPU = torch.device("cpu")
SIZE, CLASSES, BATCH = 64, 5, 4


def _cfg(precision="f32"):
    cfg = get_config("alexnet1")
    cfg.update(batch_size=BATCH, input_size=SIZE, num_classes=CLASSES,
               precision=precision)
    return cfg


def _data(n=16):
    imgs, labels, split = synthetic_classification(n, SIZE, 3, CLASSES,
                                                   BATCH)
    return (lambda e: batches(imgs[split:], labels[split:], BATCH,
                              rng=np.random.default_rng(e)),
            lambda: batches(imgs[:split], labels[:split], BATCH,
                            drop_remainder=False))


def _trainer(workdir, module=None, precision="f32", **kw):
    if module is None:
        module = create_model("alexnet1", device=CPU, seed=0,
                              num_classes=CLASSES, input_size=SIZE)
    train, val = _data()
    return Trainer(module, _cfg(precision), train, val, device="cpu",
                   workdir=workdir, log_every=0,
                   train_step=partial(classification_train_step,
                                      normalize_kind="torch"),
                   eval_step=partial(classification_eval_step,
                                     normalize_kind="torch"), **kw)


# ----------------------------------------------------------- the feed


def test_prefetcher_keeps_order_and_counts_the_wire():
    src = [{"image": np.full((2, 3, 3, 1), i, np.float32),
            "label": np.full((2,), i, np.int32)} for i in range(7)]
    tel = FeedTelemetry()
    with DevicePrefetcher(iter(src), CPU, depth=2, telemetry=tel) as feed:
        got = [int(b["label"][0]) for b in feed]
    assert got == list(range(7))
    summary = tel.summary()
    assert summary["batches"] == 7 and summary["wire_dtype"] == "float32"
    assert summary["h2d_bytes_per_image"] == (9 * 4 * 2 + 2 * 4) / 2


def test_prefetcher_reraises_producer_errors_at_the_batch():
    def src():
        yield {"image": np.zeros((1, 1, 1, 1), np.float32)}
        raise OSError("disk gone")

    feed = DevicePrefetcher(src(), CPU, depth=1)
    next(feed)
    with pytest.raises(OSError, match="disk gone"):
        next(feed)
    feed.close()
    with pytest.raises(StopIteration):
        next(feed)


def test_prefetcher_close_joins_its_thread():
    before = {t.ident for t in threading.enumerate()}
    src = ({"image": np.zeros((1, 2, 2, 1), np.float32)} for _ in range(100))
    feed = DevicePrefetcher(src, CPU, depth=2)
    next(feed)  # the producer now blocks on a full queue
    feed.close()
    assert not feed._thread.is_alive()
    leaked = [t for t in threading.enumerate()
              if t.ident not in before and t.name == "device-prefetch"]
    assert not leaked
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(iter(()), CPU, depth=0)


# ------------------------------------------------ checkpoint, resume


def test_checkpoint_round_trip_with_verified_manifest(tmp_path):
    t = _trainer(tmp_path, precision="bf16_scaled")
    t.fit(1)
    ckpt = t.ckpt
    assert ckpt.saved_epochs() == [0]
    assert manifest.verify_manifest(ckpt.directory, 0) == (True, "ok")
    fresh = _trainer(tmp_path, module=create_model(
        "alexnet1", device=CPU, seed=5, num_classes=CLASSES,
        input_size=SIZE), precision="bf16_scaled")
    meta = fresh.ckpt.restore(fresh.state)
    assert meta["epoch"] == 0 and meta["model"]["num_classes"] == CLASSES
    assert fresh.state.step == t.state.step == 3
    for a, b in zip(fresh.state.module.parameters(),
                    t.state.module.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for pa, pb in zip(fresh.state.module.parameters(),
                      t.state.module.parameters()):
        torch.testing.assert_close(
            fresh.state.optimizer.state[pa]["momentum_buffer"],
            t.state.optimizer.state[pb]["momentum_buffer"], rtol=0, atol=0)
    assert float(fresh.state.loss_scale.scale) == float(
        t.state.loss_scale.scale)
    assert (meta["loggers"].data["val_loss"]
            == t.loggers.data["val_loss"])


def test_checkpoint_keeps_three_and_refuses_a_tampered_file(tmp_path):
    t = _trainer(tmp_path)
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=3)
    for epoch in range(5):
        mgr.save(epoch, t.state)
    assert mgr.saved_epochs() == [2, 3, 4]
    assert not manifest.manifest_path(mgr.directory, 1).exists()
    state_file = mgr.directory / "4" / "state.pt"
    data = bytearray(state_file.read_bytes())
    data[len(data) // 2] ^= 0xFF
    state_file.write_bytes(bytes(data))
    assert not mgr.verify_epoch(4)[0]
    with pytest.raises(RuntimeError, match="integrity"):
        mgr.restore(t.state)
    mgr.restore(t.state, 3)  # an intact epoch still restores
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "none").restore(t.state)
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_restore_model_takes_the_newest_verified_epoch(tmp_path):
    t = _trainer(tmp_path)
    mgr = CheckpointManager(tmp_path / "ck")
    for epoch in range(2):
        with torch.no_grad():
            t.state.module.fc8.bias.fill_(epoch)
        mgr.save(epoch, t.state, config=t.config)
    state_file = mgr.directory / "1" / "state.pt"
    state_file.write_bytes(state_file.read_bytes()[:-1])
    weights, model = mgr.restore_model()  # epoch 1 fails, epoch 0 serves
    assert model == {"name": "alexnet1", "input_size": SIZE,
                     "num_classes": CLASSES}
    assert torch.equal(weights["fc8.bias"], torch.zeros(CLASSES))
    with pytest.raises(RuntimeError, match="integrity"):
        mgr.restore_model(1)
    with pytest.raises(FileNotFoundError, match="no verified checkpoint"):
        CheckpointManager(tmp_path / "none").restore_model()


def test_resume_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    straight = _trainer(tmp_path / "a")
    straight.fit(2)
    want = {k: straight.loggers.data[k]["value"][-1]
            for k in ("train_loss", "val_loss", "val_top1")}

    first = _trainer(tmp_path / "b")
    first.fit(1)
    resumed = _trainer(tmp_path / "b", module=create_model(
        "alexnet1", device=CPU, seed=9, num_classes=CLASSES,
        input_size=SIZE))
    resumed.resume()
    assert resumed.start_epoch == 1
    resumed.fit(2)
    got = {k: resumed.loggers.data[k]["value"][-1] for k in want}
    assert got == want
    for a, b in zip(resumed.state.module.parameters(),
                    straight.state.module.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the history carried over: the pre-train and both epochs
    assert resumed.loggers.data["val_loss"]["epochs"] == [-1, 0, 1]
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------------ CLI, serving


def test_cli_trains_resumes_and_serves_from_its_checkpoint(tmp_path,
                                                           capsys):
    common = ["-m", "alexnet1", "--device", "cpu", "--input-size",
              str(SIZE), "--num-classes", str(CLASSES), "--batch-size", "8",
              "--synthetic-size", "64", "--workdir", str(tmp_path)]
    assert train_main([*common, "--epochs", "2"]) == 0
    out = capsys.readouterr()
    assert "[pre-train]" in out.out and "[epoch 1]" in out.out
    assert "checkpoints [0, 1]" in out.err
    assert train_main([*common, "--epochs", "3", "--resume"]) == 0
    out = capsys.readouterr()
    assert "resumed at epoch 2" in out.out
    assert "[epoch 2]" in out.out and "[epoch 1]" not in out.out

    served = load_served("alexnet1", str(tmp_path / "alexnet1"),
                         device="cpu")
    assert served.input_shape == (SIZE, SIZE, 3)
    state = torch.load(tmp_path / "alexnet1" / "ckpt" / "2" / "state.pt",
                       weights_only=True)
    module = create_model("alexnet1", device=CPU, num_classes=CLASSES,
                          input_size=SIZE)
    module.load_state_dict(state["model"])
    x = np.random.default_rng(0).normal(0, 1, (3, SIZE, SIZE, 3)).astype(
        np.float32)
    with torch.inference_mode():
        want = torch.softmax(module(torch.from_numpy(x)), -1)
    got = served.run(x)
    np.testing.assert_allclose(got["probs"][:, 0],
                               want.max(-1).values.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(got["classes"][:, 0],
                                  want.argmax(-1).numpy())
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_served_logits_equal_the_trainers_module(tmp_path):
    t = _trainer(tmp_path)
    t.fit(1)
    served = load_served("alexnet1", str(tmp_path / "alexnet1"),
                         device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(served.module(x), t.state.module(x),
                                   rtol=0, atol=0)
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_trains_inception1_ref_and_resumes_mid_schedule(tmp_path,
                                                             capsys):
    """``-m inception1_ref``: 2 steps of the inception_poly schedule (one
    an epoch), then a resume that goes on at update 3 from the count the
    checkpoint carried."""
    common = ["-m", "inception1_ref", "--device", "cpu", "--input-size",
              "96", "--num-classes", str(CLASSES), "--batch-size", "2",
              "--synthetic-size", "12", "--steps-per-epoch", "1",
              "--workdir", str(tmp_path)]
    assert train_main([*common, "--epochs", "2"]) == 0
    out = capsys.readouterr()
    assert "model: inception1_ref 96x96x3" in out.out
    assert "checkpoints [0, 1]" in out.err
    assert train_main([*common, "--epochs", "3", "--resume"]) == 0
    assert "resumed at epoch 2" in capsys.readouterr().out
    state = torch.load(tmp_path / "inception1_ref" / "ckpt" / "2" /
                       "state.pt", weights_only=True)
    assert state["step"] == 3
    assert float(state["optimizer"]["count"]) == 3.0
    served = load_served("inception1_ref", str(tmp_path / "inception1_ref"),
                         device="cpu")
    assert served.run(np.zeros((1, 96, 96, 3), np.float32))[
        "classes"].shape == (1, 5)


def test_checkpoint_round_trips_bn_statistics_and_the_update_count(
        tmp_path):
    """inception1's BN running statistics move in training, and a resume
    restores them and the schedule's update count bit for bit."""
    def trainer(seed):
        cfg = get_config("inception1")
        cfg.update(batch_size=2, input_size=96, num_classes=CLASSES,
                   precision="f32")
        imgs, labels, split = synthetic_classification(8, 96, 3, CLASSES, 2)
        module = create_model("inception1", device=CPU, seed=seed,
                              num_classes=CLASSES, input_size=96)
        return Trainer(
            module, cfg,
            lambda e: batches(imgs[split:], labels[split:], 2,
                              rng=np.random.default_rng(e)),
            lambda: batches(imgs[:split], labels[:split], 2,
                            drop_remainder=False),
            device="cpu", workdir=tmp_path, log_every=0, steps_per_epoch=3,
            train_step=partial(classification_train_step,
                               normalize_kind="torch"),
            eval_step=partial(classification_eval_step,
                              normalize_kind="torch"))

    t = trainer(0)
    t.fit(1)
    mean = t.state.module.stem1.bn.mean
    assert mean.any() and not torch.equal(t.state.module.i5b.b1.bn.var,
                                          torch.ones(384))
    fresh = trainer(1)
    fresh.resume()
    for (name, a), b in zip(fresh.state.module.state_dict().items(),
                            t.state.module.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert float(fresh.state.optimizer.count) == 3.0
    assert fresh.state.step == 3


def test_cli_trains_resnet50_under_its_model_kwargs(tmp_path, capsys,
                                                    monkeypatch):
    """``-m resnet50`` at 64 px in the config's bf16: the config's
    ``model_kwargs`` reach the model (flax's stock BN on the S2D stem),
    2 epochs of 2 steps, a resume to 3, then ``load_served`` from the
    newest checkpoint, which builds the plain stem on the same weights.
    All 106 BN statistic tensors moved, and a restore gives them back
    bit for bit."""
    built = []
    create = models.create_model

    def recording(*args, **kw):
        built.append(create(*args, **kw))
        return built[-1]

    monkeypatch.setattr(models, "create_model", recording)
    common = ["-m", "resnet50", "--device", "cpu", "--input-size", "64",
              "--num-classes", str(CLASSES), "--batch-size", "4",
              "--synthetic-size", "16", "--steps-per-epoch", "2",
              "--workdir", str(tmp_path)]
    assert train_main([*common, "--epochs", "2"]) == 0
    out = capsys.readouterr()
    assert "model: resnet50 64x64x3" in out.out
    assert "model_kwargs {'s2d_stem': True}" in out.out
    assert type(built[0].stem.bn) is layers.BatchNorm
    assert "checkpoints [0, 1]" in out.err
    assert train_main([*common, "--epochs", "3", "--resume"]) == 0
    assert "resumed at epoch 2" in capsys.readouterr().out
    monkeypatch.undo()

    workdir = tmp_path / "resnet50"
    state = torch.load(workdir / "ckpt" / "2" / "state.pt",
                       weights_only=True)
    assert state["step"] == 6
    served = load_served("resnet50", str(workdir), device="cpu")
    assert type(served.module.stem.bn) is layers.MixedBatchNorm
    assert served.input_shape == (64, 64, 3)
    for name, tensor in state["model"].items():
        assert torch.equal(served.module.state_dict()[name], tensor), name
    stats = {k: v for k, v in state["model"].items()
             if k.endswith((".mean", ".var"))}
    assert len(stats) == 106
    assert all(v.any() if k.endswith(".mean")
               else not torch.equal(v, torch.ones_like(v))
               for k, v in stats.items())
    fresh = create_model("resnet50", device=CPU, seed=1,
                         num_classes=CLASSES, input_size=64, s2d_stem=True)
    opt, _ = make_optimizer(get_config("resnet50"), fresh.parameters())
    CheckpointManager(workdir / "ckpt").restore(TrainState(fresh, opt), 2)
    for name, tensor in fresh.state_dict().items():
        assert torch.equal(tensor, state["model"][name]), name
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        train_main(["-m", "alexnet1", "--workdir", str(tmp_path)])
    with pytest.raises(SystemExit):
        train_main(["-m", "alexnet2_tf"])  # serving-only: not a choice


# ------------------------------------------------ the whole slice


def test_trainer_matches_the_jax_trainer(tmp_path, mesh1):
    """Pre-train and epoch-0 validation of the port's Trainer and the
    JAX Trainer, 3 steps of f32 from the same weights, dropout off."""
    jcfg = jax_get_config("alexnet1")
    jcfg.update(batch_size=BATCH, input_size=SIZE, num_classes=CLASSES,
                precision="f32")
    imgs, labels, split = jax_synthetic(16, SIZE, 3, CLASSES, BATCH)
    model = flax_get_model("alexnet1", num_classes=CLASSES)

    def no_dropout(variables, x, train=True, **kw):
        kw.pop("rngs", None)
        return model.apply(variables, x, train=False, **kw)

    def step(state, batch, key):
        s = state.replace(apply_fn=no_dropout)
        new, metrics = jax_train_step(s, batch, key, normalize_kind="torch")
        return new.replace(apply_fn=state.apply_fn), metrics

    jt = JaxTrainer(
        model, jcfg, mesh1,
        lambda e: jax_batches(imgs[split:], labels[split:], BATCH,
                              rng=np.random.default_rng(e)),
        lambda: jax_batches(imgs[:split], labels[:split], BATCH,
                            drop_remainder=False),
        workdir=tmp_path / "jax", steps_per_epoch=3, log_every=0,
        train_step=step,
        eval_step=partial(jax_eval_step, normalize_kind="torch"))
    variables = {"params": jax.tree.map(np.asarray, jt.state.params)}
    module = create_model("alexnet1", device=CPU, num_classes=CLASSES,
                          input_size=SIZE)
    module.load_state_dict(flax_to_torch("alexnet1", variables,
                                         num_classes=CLASSES,
                                         input_size=SIZE))
    module.dropout_rate = 0.0
    pt = _trainer(tmp_path / "port", module=module)
    want = jt.fit(1)
    jt.ckpt.close()
    got = pt.fit(1)
    assert got.data["train_loss"]["epochs"] == [0]
    for key in ("val_loss", "val_top1"):
        assert want.data[key]["epochs"] == got.data[key]["epochs"] == [-1, 0]
        np.testing.assert_allclose(got.data[key]["value"],
                                   want.data[key]["value"], rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(got.data["train_loss"]["value"],
                               want.data["train_loss"]["value"], rtol=1e-4)
    # its checkpoints (pytest keeps the temp directories of its last
    # three runs)
    shutil.rmtree(tmp_path, ignore_errors=True)
