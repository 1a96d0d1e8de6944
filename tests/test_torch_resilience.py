"""The port's resilience layer on the CPU, against the JAX package.

Held against ``deepvision_tpu``: the fault grammar and the seeded
``kind~p`` firing sequences, the recovery policy's backoff and the
counters' line, the EWMA detector's z-scores (1e-12), the sentinel
scalars after one float32 ``lenet5`` step on converted weights (rtol
1e-5), ``tree_fingerprint``'s digest of converted ``resnet50`` weights
(equal, trap C28) before and after ``apply_sdc``'s ``sdc_param``, and the
chaos drill of ``make chaos-smoke``: the port's CLI prints ``train.py``'s
``[rollback]`` positions and ``[recovery]`` line on the same schedule.

Port-only: a SIGTERM mid-epoch and a resume equal the uninterrupted run
bit for bit (float32, with and without ``--data-echo 2``) and another
echo is refused; the async save's host snapshot (trap C27); ``keep_best``
retention; quarantine and fallback (checksum and fingerprint); the NaN
tripwire under ``float32`` and ``bf16_scaled`` (trap C26, with the JAX
checked step's own behaviour under ``bf16_scaled``); the stall watchdog
on a ``stall`` fault; the RSS limit through ``DVTPU_FAKE_RSS``;
``publish_to_gcs`` against a stub client; TensorBoard events with the JAX
writer's tags; ``fit_gan``'s preemption and async save on ``dcgan``.
"""

import dataclasses
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.resilience import faults as jax_faults
from deepvision_tpu.resilience import recovery as jax_recovery
from deepvision_tpu.resilience import sentinel as jax_sentinel
from deepvision_tpu.obs.metrics import Registry as JaxRegistry
from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.data.mnist import batches, synthetic_mnist
from deepvision_tpu_torch.data.synthetic import synthetic_classification
from deepvision_tpu_torch.data.tfrecord import read_records
from deepvision_tpu_torch.models import create_model, get_model
from deepvision_tpu_torch.obs.metrics import Registry
from deepvision_tpu_torch.resilience import (
    FaultInjector,
    RecoveryCounters,
    RecoveryPolicy,
    format_spec,
    parse_schedule,
    split_schedule,
)
from deepvision_tpu_torch.resilience import sentinel
from deepvision_tpu_torch.train import checkpoint as ckpt_mod
from deepvision_tpu_torch.train import manifest
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.configs import get_config
from deepvision_tpu_torch.train.optimizers import make_optimizer
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import (
    classification_eval_step,
    classification_train_step,
)
from deepvision_tpu_torch.train.trainer import (
    Trainer,
    make_rss_limit_flag,
)
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SIZE, CLASSES, BATCH = 64, 5, 4

SCHEDULES = [
    "nan@14,ckpt@1,io@8x2",
    "io~0.3,stall@2x3:0.25,wkill@5",
    "sdc_grad@20:host1,sdcp@7,rkill@3x2,rslow~0.5:1.5",
    "nan~0.2,crash@4,preempt@9,hstall@1:3,sesskill~0.1,snapcorrupt@2",
]


# ------------------------------------------------ faults and recovery


@pytest.mark.parametrize("spec", SCHEDULES)
def test_schedule_grammar_equals_jax(spec):
    mine, theirs = parse_schedule(spec), jax_faults.parse_schedule(spec)
    assert [dataclasses.asdict(s) for s in mine] == \
        [dataclasses.asdict(s) for s in theirs]
    assert [format_spec(s) for s in mine] == \
        [jax_faults.format_spec(s) for s in theirs]
    assert split_schedule(spec, ("host_preempt", "host_stall")) == \
        jax_faults.split_schedule(spec, ("host_preempt", "host_stall"))


@pytest.mark.parametrize("bad", ["nan", "bogus@1", "nan@x", "io~2",
                                 "nan@1x0", "io@1:host2", "sdc~0.5"])
def test_schedule_refusals_equal_jax(bad):
    with pytest.raises(ValueError) as mine:
        parse_schedule(bad)
    with pytest.raises(ValueError) as theirs:
        jax_faults.parse_schedule(bad)
    assert str(mine.value) == str(theirs.value)


def _consult(injector, n=40):
    """Every site hook ``n`` times, in one fixed interleaving (stalls
    sleep nothing); the firing record."""
    for _ in range(n):
        injector.poison_nan({"image": np.zeros((1, 2), np.float32)})
        for hook in (injector.check_io, injector.check_dispatch):
            try:
                hook()
            except (OSError, RuntimeError):
                pass
        injector.maybe_stall(sleep=lambda s: None)
        for hook in (injector.check_replica_kill, injector.check_replica_slow,
                     injector.check_host_preempt, injector.check_host_stall,
                     injector.check_worker_kill, injector.check_session_kill):
            hook()
    for step in range(30):
        injector.check_sdc(step)
    return injector.fired, injector.summary()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("spec", SCHEDULES)
def test_seeded_firing_sequence_equals_jax(spec, seed):
    mine = _consult(FaultInjector(spec, seed=seed, host=1))
    theirs = _consult(jax_faults.FaultInjector(spec, seed=seed, host=1))
    assert mine == theirs
    assert mine[0]  # something fired


def test_poison_batch_equals_jax():
    batch = {"image": np.arange(12, dtype=np.uint8).reshape(1, 2, 2, 3),
             "label": np.array([3], np.int32)}
    mine = FaultInjector("nan@0").poison_nan(batch)
    theirs = jax_faults.FaultInjector("nan@0").poison_nan(batch)
    assert mine[1] and theirs[1]
    for k in batch:
        np.testing.assert_array_equal(mine[0][k], theirs[0][k])
        assert mine[0][k].dtype == theirs[0][k].dtype
    assert batch["image"].dtype == np.uint8  # the source is untouched


@pytest.mark.parametrize("kw", [{}, {"backoff_s": 0.3, "backoff_mult": 3.0,
                                     "max_backoff_s": 5.0}])
def test_backoff_and_counter_line_equal_jax(kw):
    mine, theirs = RecoveryPolicy(**kw), jax_recovery.RecoveryPolicy(**kw)
    assert [mine.backoff(a) for a in range(8)] == \
        [theirs.backoff(a) for a in range(8)]
    a = RecoveryCounters(registry=Registry())
    b = jax_recovery.RecoveryCounters(registry=JaxRegistry())
    for c in (a, b):
        c.inc("rollbacks")
        c.inc("data_retries", 2)
        c.inc("ckpt_fallbacks")
    assert a.format() == b.format() == \
        "rollbacks=1 ckpt_fallbacks=1 data_retries=2 lr_rewarms=0"


@pytest.mark.parametrize("kw", [{"max_rollbacks": 0}, {"skip_batches": 0},
                                {"lr_rewarm": 1.5}, {"max_data_retries": -1}])
def test_policy_refusals_equal_jax(kw):
    with pytest.raises(ValueError) as mine:
        RecoveryPolicy(**kw)
    with pytest.raises(ValueError) as theirs:
        jax_recovery.RecoveryPolicy(**kw)
    assert str(mine.value) == str(theirs.value)


# --------------------------------------------------------- the sentinel


@pytest.mark.parametrize("warmup,alpha", [(16, 0.2), (4, 0.5)])
def test_ewma_z_scores_equal_jax(warmup, alpha):
    rng = np.random.default_rng(3)
    series = np.concatenate([1.0 + 0.01 * rng.normal(size=60),
                             [1.5, 1.0, float("nan")],
                             0.9 + 0.02 * rng.normal(size=20)])
    mine = sentinel.EwmaDetector(warmup=warmup, alpha=alpha, z_threshold=3)
    theirs = jax_sentinel.EwmaDetector(warmup=warmup, alpha=alpha,
                                       z_threshold=3)
    got = [mine.observe("loss", v) for v in series]
    want = [theirs.observe("loss", v) for v in series]
    assert [g is None for g in got] == [w is None for w in want]
    assert any(g is not None for g in got)
    for g, w in zip(got, want):
        if g is not None:
            assert g == w or abs(g - w) <= 1e-12 * abs(w)
    assert mine._stats == pytest.approx(theirs._stats, rel=1e-12)


def test_sentinel_scalars_after_a_lenet5_step_equal_jax():
    """One float32 step of ``lenet5`` under SGD with momentum (the config's
    Adam divides each gradient by its own magnitude plus 1e-8 on the
    first step, so the update of a gradient within rounding of 0 is
    rounding noise on either side, and so is its share of the norm)."""
    from deepvision_tpu.models import get_model as flax_get_model
    from deepvision_tpu.train import optimizers as jax_optimizers
    from deepvision_tpu.train.configs import get_config as jax_get_config
    from deepvision_tpu.train.state import create_train_state
    from deepvision_tpu.train.steps import (
        classification_train_step as jax_train_step,
    )

    model = flax_get_model("lenet5", num_classes=10)
    jcfg, cfg = jax_get_config("lenet5"), get_config("lenet5")
    for c in (jcfg, cfg):
        c.update(optimizer="sgd", optimizer_params={"lr": 0.01,
                                                    "momentum": 0.9})
    tx, _ = jax_optimizers.make_optimizer(jcfg, 10)
    jstate = create_train_state(model, tx, np.zeros((1, 32, 32, 1),
                                                    np.float32), rng=0)
    imgs, labels = synthetic_mnist(16)
    batch = {"image": imgs[:16], "label": labels[:16]}
    _, want = jax.jit(jax_sentinel.sentinel_step(jax_train_step))(
        jstate, batch, jax.random.key(0))

    module = get_model("lenet5", num_classes=10)
    module.load_state_dict(flax_to_torch(
        "lenet5", jax.tree.map(np.asarray, {"params": jstate.params}),
        num_classes=10))
    opt, _ = make_optimizer(cfg, module.parameters(), 10)
    got = sentinel.sentinel_step(classification_train_step)(
        TrainState(module, opt),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0))
    for key in sentinel.SENTINEL_KEYS + ("loss",):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def resnet50_weights():
    """Converted ``resnet50`` weights (64 px, 5 classes) drawn from a
    seed, as the flax tree and the port module."""
    from deepvision_tpu.models import get_model as flax_get_model

    model = flax_get_model("resnet50", num_classes=CLASSES)
    shapes = jax.eval_shape(
        lambda k, x: model.init(k, x, train=True), jax.random.PRNGKey(0),
        jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda s: rng.normal(0, 0.05, s.shape).astype(np.float32), shapes)
    variables = {k: variables[k] for k in ("params", "batch_stats")}
    module = get_model("resnet50", num_classes=CLASSES, input_size=SIZE)
    module.load_state_dict(flax_to_torch("resnet50", variables,
                                         num_classes=CLASSES,
                                         input_size=SIZE))
    return variables, module


@dataclasses.dataclass
class _JaxState:
    params: dict
    batch_stats: dict

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def test_fingerprint_digest_equals_jax_before_and_after_sdc(
        resnet50_weights):
    variables, module = resnet50_weights
    want = jax_sentinel.tree_fingerprint(variables)
    got = sentinel.tree_fingerprint(sentinel.state_tree(module))
    assert got["digest"] == want["digest"]
    assert got["proj"] == want["proj"]
    monitor = sentinel.SentinelMonitor(registry=Registry())
    state = types.SimpleNamespace(module=module)
    assert monitor.fingerprint_state(state) == got

    spec = parse_schedule("sdc_param@1")[0]
    jstate = jax_sentinel.apply_sdc(
        _JaxState(variables["params"], variables["batch_stats"]),
        jax_faults.parse_schedule("sdc_param@1")[0])
    want_sdc = jax_sentinel.tree_fingerprint(
        {"params": jax.tree.map(np.asarray, jstate.params),
         "batch_stats": variables["batch_stats"]})
    snapshot = {k: v.clone() for k, v in module.state_dict().items()}
    try:
        sentinel.apply_sdc(state, spec)
        got_sdc = monitor.fingerprint_state(state)
        changed = [k for k, v in module.state_dict().items()
                   if not torch.equal(v, snapshot[k])]
    finally:
        module.load_state_dict(snapshot)
    assert want_sdc["digest"] != want["digest"]
    assert got_sdc["digest"] != got["digest"]
    assert got_sdc["digest"] == want_sdc["digest"]
    assert len(changed) == 1  # one element of the largest kernel
    assert not sentinel.fingerprints_agree(got, got_sdc)
    assert 0 < sentinel.fingerprint_deviation(got, got_sdc) < 1e-6


# ------------------------------------------------------ the chaos drill

CHAOS = ["-m", "lenet5", "--epochs", "3", "--synthetic-size", "512",
         "--batch-size", "64", "--steps-per-epoch", "6", "--recover",
         "--faults", "nan@14,ckpt@1,io@8x2"]
_ROLLBACK = re.compile(r"^\[rollback\] NaN/Inf detected at epoch (\d+) step "
                       r"(\d+): .*: restored (.+?); resuming epoch (\d+) at "
                       r"step (\d+) \((\d+/\d+) consecutive\)$", re.M)


def _drill_lines(out: str) -> dict:
    return {
        "rollback": _ROLLBACK.findall(out),
        "recovery": re.findall(r"^\[recovery\] (rollbacks.*)$", out, re.M),
        "faults": re.findall(r"^\[faults\] fired: (.*)$", out, re.M),
        "retries": re.findall(r"^\[data-retry\] .*occurrence (\d+)", out,
                              re.M),
        "fallback": re.findall(r"^\[ckpt-integrity\] epoch (\d+): ", out,
                               re.M),
        "epochs": re.findall(r"^\[epoch (\d+)\] ", out, re.M),
    }


def test_chaos_drill_matches_train_py(tmp_path):
    """The port's CLI and ``train.py`` on ``make chaos-smoke``'s schedule,
    run at once: the same rollback (epoch 2 step 2, back to the epoch-0
    checkpoint, resumed at step 3), fallback, retries and counters."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.Popen(
        [sys.executable, "train.py", *CHAOS, "--platform", "cpu",
         "--workdir", str(tmp_path / "jax")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.train", *CHAOS,
         "--device", "cpu", "--workdir", str(tmp_path / "port")], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    jax_out, _ = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, jax_out[-3000:]
    assert port.returncode == 0, port.stdout[-3000:] + port.stderr[-3000:]
    got, want = _drill_lines(port.stdout), _drill_lines(jax_out)
    assert got == want
    assert got["rollback"] == [("2", "2", "epoch-0 checkpoint", "2", "3",
                                "1/3")]
    assert got["recovery"] == [
        "rollbacks=1 ckpt_fallbacks=1 data_retries=2 lr_rewarms=0"]
    quarantined = tmp_path / "port" / "lenet5" / "ckpt" / "quarantine" / "1"
    assert quarantined.is_dir()
    shutil.rmtree(tmp_path, ignore_errors=True)


# ------------------------------------------------- preemption, resume


def _cfg(precision="f32"):
    cfg = get_config("alexnet1")
    cfg.update(batch_size=BATCH, input_size=SIZE, num_classes=CLASSES,
               precision=precision)
    return cfg


def _trainer(workdir, *, sigterm_at=None, data_echo=1, precision="f32",
             module_seed=0, n=12, **kw):
    """An f32 AlexNet V1 Trainer at 64 px; ``sigterm_at`` (epoch, batch)
    sends this process a SIGTERM while the feed yields that batch."""
    imgs, labels, split = synthetic_classification(n, SIZE, 3, CLASSES,
                                                   BATCH)

    def train_data(epoch):
        for j, b in enumerate(batches(imgs[split:], labels[split:], BATCH,
                                      rng=np.random.default_rng(epoch))):
            if sigterm_at == (epoch, j):
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    module = create_model("alexnet1", device=CPU, seed=module_seed,
                          num_classes=CLASSES, input_size=SIZE)
    return Trainer(module, _cfg(precision), train_data,
                   lambda: batches(imgs[:split], labels[:split], BATCH,
                                   drop_remainder=False),
                   device="cpu", workdir=workdir, log_every=0,
                   steps_per_epoch=2, data_echo=data_echo,
                   train_step=partial(classification_train_step,
                                      normalize_kind="torch"),
                   eval_step=partial(classification_eval_step,
                                     normalize_kind="torch"), **kw)


@pytest.fixture()
def sigterm_restored():
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("echo", [1, 2])
def test_sigterm_mid_epoch_resume_is_bit_identical(tmp_path, echo,
                                                   sigterm_restored):
    straight = _trainer(tmp_path / "a", data_echo=echo)
    straight.fit(2)
    want = {k: straight.loggers.data[k]["value"][-1]
            for k in ("train_loss", "val_loss", "val_top1")}

    cut = _trainer(tmp_path / "b", data_echo=echo, sigterm_at=(1, 1))
    cut.install_preemption_handler()
    cut.fit(2)
    assert cut.preempted
    preempt_dir = tmp_path / "b" / "alexnet1" / "ckpt_preempt"
    assert preempt_dir.is_dir()

    with pytest.raises(ValueError, match="--data-echo"):
        _trainer(tmp_path / "b", data_echo=3 - echo).resume()

    resumed = _trainer(tmp_path / "b", data_echo=echo, module_seed=9)
    resumed.resume()
    assert resumed.start_epoch == 1 and 0 < resumed.start_step < 2
    resumed.fit(2)
    assert not resumed.preempted
    assert not preempt_dir.exists()  # the epoch save superseded it
    got = {k: resumed.loggers.data[k]["value"][-1] for k in want}
    assert got["val_loss"] == want["val_loss"]
    assert got["val_top1"] == want["val_top1"]
    for a, b in zip(resumed.state.module.state_dict().values(),
                    straight.state.module.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert resumed.state.step == straight.state.step == 4 * echo
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_rss_limit_preempts_through_the_fake_rss(tmp_path, monkeypatch):
    monkeypatch.setenv("DVTPU_FAKE_RSS", str(int(2e15)))
    t = _trainer(tmp_path, rss_limit_gb=1e5)
    t.fit(1)
    assert t.preempted and t._rss_preempted
    assert (tmp_path / "alexnet1" / "ckpt_preempt").is_dir()
    flag = make_rss_limit_flag(1e5)
    assert flag() and flag()  # latched
    monkeypatch.setenv("DVTPU_FAKE_RSS", "1")
    assert flag()
    with pytest.raises(ValueError, match="at/below the current"):
        _trainer(tmp_path, rss_limit_gb=1e-6)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_stall_fault_trips_the_watchdog(tmp_path, capsys):
    t = _trainer(tmp_path, stall_timeout=0.5, n=20,
                 fault_injector=FaultInjector("stall@2:3"))
    t.fit(1)
    assert t._watchdog.fired
    out = capsys.readouterr().out
    assert "[stall] no heartbeat in" in out
    assert "[faults] fired: stall@2" in out
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("precision", ["f32", "bf16_scaled"])
def test_nan_tripwire_rolls_back_under_both_policies(tmp_path, precision,
                                                     capsys):
    """Trap C26: the poisoned batch trips the port's finite flag under
    ``float32`` and under ``bf16_scaled`` (its loss is NaN), is rolled
    back to the initial state and the epoch resumes past it."""
    t = _trainer(tmp_path, precision=precision,
                 recovery=RecoveryPolicy(backoff_s=0.0),
                 fault_injector=FaultInjector("nan@1"))
    t.fit(1)
    out = capsys.readouterr().out
    assert ("[rollback] NaN/Inf detected at epoch 0 step 1: non-finite "
            "loss or gradients: restored initial state") in out
    assert "resuming epoch 0 at step 2 (1/3 consecutive)" in out
    assert t.rec_counters.get("rollbacks") == 1
    for p in t.state.module.parameters():
        assert torch.isfinite(p).all()
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_jax_checked_step_raises_on_a_poisoned_batch_under_bf16_scaled(
        mesh1):
    """What trap C26 matches: JAX's checkify step raises on the poisoned
    batch under ``bf16_scaled`` too (the loss scale's skip never gets to
    act), so the rollback runs under both policies on both sides."""
    from deepvision_tpu.core.precision import get_policy as jax_policy
    from deepvision_tpu.core.step import (
        checkify_error_cls,
        compile_checked_train_step,
    )
    from deepvision_tpu.models import get_model as flax_get_model
    from deepvision_tpu.train import optimizers as jax_optimizers
    from deepvision_tpu.train.configs import get_config as jax_get_config
    from deepvision_tpu.train.state import create_train_state
    from deepvision_tpu.train.steps import (
        classification_train_step as jax_train_step,
    )

    policy = jax_policy("bf16_scaled")
    model = flax_get_model("lenet5", num_classes=10,
                           dtype=policy.compute_dtype)
    tx, _ = jax_optimizers.make_optimizer(jax_get_config("lenet5"), 10)
    state = create_train_state(model, tx, np.zeros((1, 32, 32, 1),
                                                   np.float32), rng=0,
                               policy=policy)
    imgs, labels = synthetic_mnist(8)
    batch, fired = jax_faults.FaultInjector("nan@0").poison_nan(
        {"image": imgs[:8], "label": labels[:8]})
    assert fired
    step = compile_checked_train_step(jax_train_step, mesh1)
    with pytest.raises(checkify_error_cls()):
        step(state, batch, jax.random.key(0))


# ---------------------------------------------------------- checkpoints


def _state(seed=0):
    module = get_model("lenet5", num_classes=10)
    torch.manual_seed(seed)
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.1)
    opt, _ = make_optimizer(get_config("lenet5"), module.parameters(), 10)
    return TrainState(module, opt)


def _step(state, seed):
    imgs, labels = synthetic_mnist(8)
    rng = np.random.default_rng(seed)
    batch = {"image": torch.from_numpy(
        imgs[:8] + rng.normal(0, 0.1, imgs[:8].shape).astype(np.float32)),
        "label": torch.from_numpy(labels[:8])}
    classification_train_step(state, batch, torch.Generator())


def test_async_save_writes_the_state_at_save_time(tmp_path, monkeypatch):
    """Trap C27: the async save's file holds the state as ``save`` saw
    it, bit for bit, though the optimizer went on writing the parameters
    in place before the background write ran."""
    state = _state()
    _step(state, 1)
    at_save = {k: v.clone() for k, v in state.state_dict()["model"].items()}
    gate, writing = threading.Event(), threading.Event()
    real_save = torch.save

    def held_save(obj, path):
        writing.set()
        assert gate.wait(30)
        real_save(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", held_save)
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(0, state)
    assert writing.wait(30)  # the write is under way in the background
    for seed in (2, 3):
        _step(state, seed)
    assert not all(torch.equal(v, at_save[k])
                   for k, v in state.module.state_dict().items())
    gate.set()
    mgr.wait_until_finished()
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    assert manifest.verify_manifest(tmp_path, 0) == (True, "ok")
    saved = torch.load(tmp_path / "0" / "state.pt", weights_only=True)
    for k, v in at_save.items():
        assert torch.equal(saved["model"][k], v), k
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_async_save_raises_its_error_at_the_wait(tmp_path, monkeypatch):
    def failing_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", failing_save)
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(0, _state())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()


def test_keep_best_keeps_the_highest_metrics(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_best_of="plateau_metric")
    state = _state()
    for epoch, metric in enumerate([0.1, 0.5, 0.3, 0.2, 0.4, 0.5]):
        mgr.save(epoch, state, metrics={"plateau_metric": metric})
    assert mgr.saved_epochs() == [1, 4, 5]
    assert sorted(p.name for p in tmp_path.glob("manifest-*.json")) == [
        "manifest-1.json", "manifest-4.json", "manifest-5.json"]
    recent = CheckpointManager(tmp_path / "recent")
    for epoch in range(5):
        recent.save(epoch, state)
    assert recent.saved_epochs() == [2, 3, 4]
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_quarantine_and_fallback(tmp_path, capsys):
    """A corrupt newest epoch and one whose restored state has another
    fingerprint than its manifest's are quarantined, counted, and the
    newest good epoch restored."""
    monitor = sentinel.SentinelMonitor(registry=Registry())
    inj = FaultInjector("ckpt@2")
    mgr = CheckpointManager(tmp_path, max_to_keep=5, fault_injector=inj)
    states = [_state(seed) for seed in range(3)]
    for epoch, s in enumerate(states):
        fp = monitor.fingerprint_state(s)
        if epoch == 1:  # the state went bad before it was serialized
            fp = {**fp, "digest": "0" * 16}
        mgr.save(epoch, s, state_fingerprint=fp)
    assert inj.fired == [("ckpt_corrupt", 2)]
    counters = RecoveryCounters(registry=Registry())
    target = _state(7)
    meta = mgr.restore_verified(target, counters=counters,
                                fingerprint_fn=monitor.fingerprint_state)
    assert meta["epoch"] == 0
    assert counters.get("ckpt_fallbacks") == 2
    assert sorted(p.name for p in (tmp_path / "quarantine").iterdir()) == [
        "1", "1.manifest.json", "2", "2.manifest.json"]
    for a, b in zip(target.module.parameters(), states[0].module.parameters()):
        assert torch.equal(a, b)
    out = capsys.readouterr().out
    assert "epoch 2: size mismatch state.pt" in out
    assert "epoch 1: state fingerprint mismatch" in out
    with pytest.raises(FileNotFoundError, match="no verifiable"):
        CheckpointManager(tmp_path / "none").restore_verified(target)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_no_integrity_writes_no_manifest(tmp_path):
    mgr = CheckpointManager(tmp_path, integrity=False)
    mgr.save(0, _state())
    assert not manifest.manifest_path(tmp_path, 0).exists()
    assert mgr.verify_epoch(0) == (True,
                                   "no manifest (pre-integrity checkpoint)")


# --------------------------------------------- publish and TensorBoard


def test_publish_to_gcs_through_a_stub_client(tmp_path, monkeypatch):
    from deepvision_tpu_torch.train.publish import publish_to_gcs

    uploads = []

    class Blob:
        def __init__(self, name):
            self.name = name

        def upload_from_filename(self, path):
            uploads.append((self.name, Path(path).stat().st_size))

    class Client:
        def bucket(self, name):
            assert name == "my-bucket"
            return types.SimpleNamespace(blob=Blob)

    storage = types.ModuleType("google.cloud.storage")
    storage.Client = Client
    cloud = types.ModuleType("google.cloud")
    cloud.storage = storage
    google = types.ModuleType("google")
    google.cloud = cloud
    for name, mod in (("google", google), ("google.cloud", cloud),
                      ("google.cloud.storage", storage)):
        monkeypatch.setitem(sys.modules, name, mod)
    ckpt = tmp_path / "ckpt" / "3"
    ckpt.mkdir(parents=True)
    (ckpt / "state.pt").write_bytes(b"x" * 100)
    handoff = tmp_path / "output.txt"
    uri = publish_to_gcs(ckpt, "my-bucket", "runs/a", handoff_file=handoff)
    assert uri == "gs://my-bucket/runs/a/3.tar.gz"
    assert uploads[0][0] == "runs/a/3.tar.gz" and uploads[0][1] > 0
    assert handoff.read_text() == uri + "\n"


def test_publish_without_the_client_is_a_no_op(monkeypatch, capsys):
    from deepvision_tpu_torch.train.publish import publish_to_gcs

    monkeypatch.setitem(sys.modules, "google.cloud", None)
    assert publish_to_gcs("x", "b", "d") is None
    assert "google-cloud-storage not installed" in capsys.readouterr().out


def test_tensorboard_events_hold_the_jax_writers_tags(tmp_path):
    from tensorboard.compat.proto.event_pb2 import Event

    from deepvision_tpu.train.loggers import (
        TensorBoardWriter as JaxWriter,
    )
    from deepvision_tpu_torch.train.loggers import TensorBoardWriter

    calls = []

    class FakeTf:  # records what the JAX writer asks of tf.summary
        class summary:
            @staticmethod
            def create_file_writer(logdir):
                split = Path(logdir).name
                return types.SimpleNamespace(
                    as_default=lambda: _Ctx(split), flush=lambda: None)

            @staticmethod
            def scalar(tag, value, step):
                calls.append((_Ctx.split, tag, float(value), step))

    class _Ctx:
        split = None

        def __init__(self, split):
            self._split = split

        def __enter__(self):
            _Ctx.split = self._split

        def __exit__(self, *exc):
            _Ctx.split = None

    scalars = [("train_loss", 1.25, 0, "train"), ("lr_scale", 1.0, 0,
                                                  "train"),
               ("val_top1", 0.5, 0, "val"), ("train_loss", 0.75, 1, "train")]
    jax_writer = JaxWriter(tmp_path / "jax", enabled=False)
    jax_writer._tf = FakeTf
    writer = TensorBoardWriter(tmp_path / "port")
    for tag, value, step, split in scalars:
        jax_writer.scalar(tag, value, step, split)
        writer.scalar(tag, value, step, split)
    writer.close()
    got = []
    for split in ("train", "val"):
        (path,) = (tmp_path / "port" / split).glob("events.out.tfevents.*")
        events = [Event.FromString(r) for r in read_records(path)]
        assert events[0].file_version == "brain.Event:2"
        got += [(split, v.tag, v.simple_value, e.step)
                for e in events[1:] for v in e.summary.value]
    assert got == [(split, tag, float(value), step)
                   for split in ("train", "val")
                   for _, tag, value, step in
                   [c for c in calls if c[0] == split]]
    assert sorted(got) == sorted(calls)
    shutil.rmtree(tmp_path, ignore_errors=True)


# ----------------------------------------------------------- fit_gan


def test_fit_gan_preempts_with_an_async_save_and_resumes(tmp_path, capsys):
    from deepvision_tpu_torch.core.precision import get_policy
    from deepvision_tpu_torch.data.padding import iter_array_batches
    from deepvision_tpu_torch.train import gan
    from deepvision_tpu_torch.train.trainer import StallWatchdog

    imgs, _ = synthetic_mnist(48)
    imgs = (imgs[:, 2:30, 2:30, :] * 2.0 - 1.0).astype(np.float32)

    def data(epoch):
        return iter_array_batches({"image": imgs}, 16,
                                  rng=np.random.default_rng(epoch))

    def state():
        return gan.create_dcgan_state(noise_dim=100, lr=1e-4,
                                      policy=get_policy("f32"),
                                      dtype=torch.float32, device=CPU)

    polls = []

    def preempt():
        polls.append(1)
        return True

    watchdog = StallWatchdog(60.0)
    loggers = gan.fit_gan(state(), gan.dcgan_train_step, data, epochs=3,
                          workdir=tmp_path, save_every=2, log_every=0,
                          async_checkpoint=True, preempt=preempt,
                          watchdog=watchdog, config=get_config("dcgan"))
    assert polls == [1] and list(loggers.data["g_loss"]["epochs"]) == [0]
    assert not watchdog._thread.is_alive()  # stopped on exit
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.saved_epochs() == [0]  # saved off the cadence, committed
    assert mgr.verify_epoch(0) == (True, "ok")
    assert "[preempted] after completed epoch 0" in capsys.readouterr().out
    loggers = gan.fit_gan(state(), gan.dcgan_train_step, data, epochs=2,
                          workdir=tmp_path, resume=True, log_every=0,
                          async_checkpoint=True, check_numerics=True)
    assert "resumed at epoch 1" in capsys.readouterr().out
    assert loggers.data["g_loss"]["epochs"] == [0, 1]
    assert CheckpointManager(tmp_path / "ckpt").saved_epochs() == [0, 1]
    shutil.rmtree(tmp_path, ignore_errors=True)


# --------------------------------------------------- the data layer's hooks


class _FlakySource:
    """An iterator whose pull ``fail_at`` raises a transient OSError once
    (its ``__next__`` is retryable, unlike a generator's)."""

    def __init__(self, n, fail_at):
        self.i, self.n, self.fail_at = 0, n, set(fail_at)

    def __iter__(self):
        return self

    def __next__(self):
        if self.i in self.fail_at:
            self.fail_at.discard(self.i)
            raise OSError(f"blip at {self.i}")
        if self.i >= self.n:
            raise StopIteration
        self.i += 1
        return {"image": np.full((1, 2, 2, 1), self.i, np.float32)}


@pytest.mark.parametrize("faults,fail_at,retries", [
    ("io@1x2", (), 2), (None, (2,), 1), ("io@0", (3,), 2)])
def test_feed_retries_transient_reads_in_order(faults, fail_at, retries):
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher

    counters = RecoveryCounters(registry=Registry())
    feed = DevicePrefetcher(
        _FlakySource(5, fail_at), CPU,
        fault_injector=FaultInjector(faults) if faults else None,
        retry_policy=RecoveryPolicy(backoff_s=0.0), retry_counters=counters)
    got = [int(b["image"][0, 0, 0, 0]) for b in feed]
    feed.close()
    assert got == [1, 2, 3, 4, 5]
    assert counters.get("data_retries") == retries


def test_feed_raises_past_the_retry_budget_and_a_closed_generator():
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher

    feed = DevicePrefetcher(_FlakySource(5, ()), CPU,
                            fault_injector=FaultInjector("io@0x5"),
                            retry_policy=RecoveryPolicy(max_data_retries=3,
                                                        backoff_s=0.0))
    with pytest.raises(OSError, match="injected transient"):
        list(feed)
    feed.close()

    def gen():  # a generator that raised is closed: no silent short epoch
        yield {"image": np.zeros((1, 2, 2, 1), np.float32)}
        raise OSError("disk gone")

    feed = DevicePrefetcher(gen(), CPU,
                            retry_policy=RecoveryPolicy(backoff_s=0.0))
    with pytest.raises(OSError, match="disk gone"):
        list(feed)
    feed.close()


def test_record_reads_consult_the_data_io_site(tmp_path):
    from deepvision_tpu_torch.data.tfrecord import write_records

    path = tmp_path / "r.tfrecord"
    write_records(path, [b"a", b"bb", b"ccc"])
    assert list(read_records(path, fault_injector=FaultInjector(None))) == \
        [b"a", b"bb", b"ccc"]
    got = []
    with pytest.raises(OSError, match=r"record read .*occurrence 1"):
        for rec in read_records(path, fault_injector=FaultInjector("io@1")):
            got.append(rec)
    assert got == [b"a"]
