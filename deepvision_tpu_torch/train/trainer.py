"""The training loop: validation, epochs, plateau LR, checkpoints, resume,
recovery, preemption and the watchdogs.

The twin of ``deepvision_tpu/train/trainer.py`` for one device. Kept from
the JAX Trainer:

- validation before training, logged at epoch -1;
- ``train_epoch(epoch, start_step)`` over the device feed
  (``data/prefetch.py``), one dropout generator a step from the epoch's
  stream ``KeySeq(seed + 1, epoch)`` (``skip(start_step · data_echo)``
  on a mid-epoch resume), metrics fetched on a drain cadence (every
  ``log_every`` steps, every 32 at most under the stall watchdog, and
  at the epoch's end), never per step;
- data echo: ``data_echo`` optimizer steps a transferred batch, each
  with its own generator; throughput counts the images the optimizer
  processed;
- masked validation (exact over the whole held-out set), through the
  device feed too;
- the plateau controller on ``val_top1`` (else the negated loss); a
  step-count schedule follows the optimizer's own update count, which
  checkpoints carry;
- a checkpoint every epoch (``async_checkpoint``: written in the
  background from a host copy, ``train/checkpoint.py``; ``keep_best``:
  retention by the plateau metric; ``ckpt_integrity``: the SHA-256
  manifest), and :meth:`Trainer.resume`;
- recovery (``recovery``, a ``RecoveryPolicy``): the NaN tripwire rolls
  back to the newest verified checkpoint (or the initial state), skips
  the batch window, optionally re-warms the LR, within a budget of
  consecutive rollbacks; transient reads retry in the feed; resume
  quarantines a corrupt epoch and falls back (``[rollback]``,
  ``[ckpt-integrity]`` and ``[recovery]`` lines as the JAX Trainer's);
- the tripwire (trap C26): the JAX step raises from ``checkify`` inside
  the compiled step. The port reads a per-step finite flag on the device
  (the loss finite, and without a loss scale every gradient finite)
  after each step, where the JAX loop would have raised: every step
  under ``check_numerics`` (which ``recovery`` turns on), and not at all
  otherwise. A poisoned batch trips it under ``float32`` and under
  ``bf16_scaled`` alike (its loss is NaN), as it trips checkify on both;
  a scaled step whose gradients overflow is the loss scale's skip, not
  a trip;
- fault injection (``fault_injector``): the ``nan_step`` and ``stall``
  sites per yielded batch, ``data_io`` in the feed, ``ckpt_corrupt`` per
  save, ``sdc_grad``/``sdc_param`` per run step (``epoch ·
  steps_per_epoch + step``);
- the sentinel (``sentinel``, a ``SentinelMonitor``): its scalars
  computed in the step, z-scored on the drain cadence, a trip rolled
  back like a NaN (or raised without ``recovery``); the save-time
  fingerprint rides every manifest;
- preemption: SIGTERM (:meth:`install_preemption_handler`) or the RSS
  limit saves a mid-epoch checkpoint into ``ckpt_preempt/`` under the
  cross-process :class:`PreemptLock`, and ``fit`` returns with
  ``preempted`` set; :meth:`resume` continues at the next step of that
  epoch, refusing another ``data_echo``;
- :class:`StallWatchdog` (armed by the first completed step, so the
  first step's kernel builds and cuDNN's autotuning cannot trip it);
- ``profile_steps``: a ``torch.profiler`` window over global steps A..B;
- the spans ``epoch``, ``step``, ``drain``, ``profiler``, ``eval`` and
  ``checkpoint`` (``obs/trace.py``);
- images per second, the feed's waits and the ``mem_*`` gauges.

Left for later slices: the cluster (multi-host coordination, the
cross-host audit) and ZeRO-1.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import signal
import threading
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn

from deepvision_tpu_torch.core.precision import all_finite, get_policy
from deepvision_tpu_torch.core.prng import KeySeq
from deepvision_tpu_torch.data.prefetch import DevicePrefetcher, FeedTelemetry
from deepvision_tpu_torch.device import resolve_device
from deepvision_tpu_torch.obs.metrics import default_registry
from deepvision_tpu_torch.obs.profiler import (
    ProfileWindow,
    sample_memory_gauges,
)
from deepvision_tpu_torch.obs.trace import span
from deepvision_tpu_torch.resilience.recovery import (
    NumericDivergence,
    RecoveryCounters,
    RecoveryError,
)
from deepvision_tpu_torch.train.checkpoint import CheckpointManager, host_copy
from deepvision_tpu_torch.train.loggers import (
    Loggers,
    TensorBoardWriter,
    input_wait_metrics,
    recovery_metrics,
)
from deepvision_tpu_torch.train.optimizers import make_optimizer, set_lr_scale
from deepvision_tpu_torch.train.state import TrainState
from deepvision_tpu_torch.train.steps import (
    aggregate_eval_parts,
    classification_eval_step,
    classification_train_step,
)

__all__ = ["PreemptLock", "StallWatchdog", "Trainer", "make_preempt_flag",
           "make_rss_limit_flag"]


def _fmt(d: dict) -> str:
    return " ".join(f"{k}={v:.4g}" for k, v in d.items())


def _loader_paths() -> dict[str, int]:
    """Batches the multi-process loaders of this process moved, by path
    (``data/loader.py``)."""
    reg = default_registry()
    return {"shm": int(reg.value_of("loader_shm_batches")),
            "pickled": int(reg.value_of("loader_pickle_batches"))}


class PreemptLock:
    """Advisory cross-process mutex (``fcntl.flock``) serializing the
    preemption checkpoint: the dying process's save, a relaunched
    process's resume (inspect, restore, stale-clear) and the clear after
    the next epoch's save. Acquisition is bounded: a waiter that times
    out goes on WITHOUT touching the preemption directory (a save then
    writes ``ckpt_preempt_unlocked/``; a resume only reads)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fd: int | None = None

    def acquire(self, timeout: float | None = None) -> bool:
        """True once the exclusive lock is held; False on timeout, or at
        once on a filesystem that cannot flock."""
        import errno

        contention = {errno.EWOULDBLOCK, errno.EAGAIN, errno.EACCES,
                      errno.EINTR}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                self._fd = fd
                return True
            except OSError as e:
                if e.errno not in contention:
                    os.close(fd)
                    print(f"[preempt-lock] {self.path}: flock unsupported "
                          f"({e}); proceeding without cross-process "
                          "locking", flush=True)
                    return False
                if deadline is not None and time.monotonic() >= deadline:
                    os.close(fd)
                    return False
                time.sleep(0.05)

    def release(self) -> None:
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None


class Trainer:
    def __init__(
        self,
        module: nn.Module,
        config: dict,
        train_data: Callable[[int], Iterable[dict]],
        val_data: Callable[[], Iterable[dict]],
        *,
        device: str | torch.device | None = None,
        workdir: str | Path = "runs",
        train_step=classification_train_step,
        eval_step=classification_eval_step,
        log_every: int = 10,
        seed: int = 0,
        prefetch_depth: int = 2,
        steps_per_epoch: int | None = None,
        check_numerics: bool = False,
        async_checkpoint: bool = False,
        keep_best: bool = False,
        data_echo: int = 1,
        stall_timeout: float | None = None,
        stall_abort: bool = False,
        rss_limit_gb: float | None = None,
        recovery=None,
        fault_injector=None,
        sentinel=None,
        ckpt_integrity: bool = True,
        profile_steps: str | None = None,
        profile_dir: str | Path | None = None,
    ):
        """``module`` holds the starting weights, on ``device`` (default
        ``"cuda"``), with the policy's compute dtype; ``train_data(epoch)``
        and ``val_data()`` yield host batches (dicts of numpy arrays).
        ``steps_per_epoch`` sets the epoch of a step-count schedule
        (1000 when not given, as the JAX Trainer counts) and anchors the
        run steps of the SDC sites."""
        self.device = resolve_device(device)
        self.config = config
        self.train_data = train_data
        self.val_data = val_data
        self.workdir = Path(workdir) / config.get("name", "run")
        self.log_every = log_every
        self.seed = seed
        if prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self.prefetch_depth = int(prefetch_depth)
        # data echoing (Choi et al. 2019): data_echo optimizer steps a
        # transferred batch; a step-count schedule sees optimizer steps
        self.data_echo = max(1, int(data_echo))
        self.policy = get_policy(config.get("precision", "bf16"))
        optimizer, self.plateau = make_optimizer(
            config, module.parameters(),
            (steps_per_epoch or 1000) * self.data_echo)
        self.state = TrainState(
            module, optimizer,
            loss_scale=self.policy.make_loss_scale(self.device))
        self.steps_per_epoch = steps_per_epoch
        self.recovery = recovery
        self.injector = fault_injector
        self.rec_counters = RecoveryCounters()
        self._consecutive_rollbacks = 0
        self.sentinel = sentinel
        if sentinel is not None:
            from deepvision_tpu_torch.resilience.sentinel import sentinel_step

            train_step = sentinel_step(train_step)
        if recovery is not None:
            if not check_numerics:
                # rollback needs the tripwire
                print("[recovery] enabling --check-numerics (the NaN/Inf "
                      "tripwire recovery rolls back from)", flush=True)
                check_numerics = True
            # the rollback target of last resort: a host copy of the
            # initial state
            self._init_state = host_copy(self.state.state_dict())
        self.check_numerics = check_numerics
        self._train_step = train_step
        self._eval_step = eval_step
        self.loggers = Loggers()
        self.tb = TensorBoardWriter(self.workdir / "tb")
        self.ckpt = CheckpointManager(
            self.workdir / "ckpt", async_save=async_checkpoint,
            keep_best_of="plateau_metric" if keep_best else None,
            integrity=ckpt_integrity, fault_injector=fault_injector)
        self.start_epoch = 0
        self.start_step = 0  # mid-epoch resume point (preemption)
        self.best_metric = -float("inf")
        # a signal flips _preempt; the step loop saves a mid-epoch
        # checkpoint into ckpt_preempt/ and fit() returns with preempted
        self._preempt = False
        self.preempted = False
        # the lock file lives beside the directory, so that clearing the
        # directory cannot delete it
        self._plock = PreemptLock(self.workdir / "ckpt_preempt.lock")
        self.preempt_lock_timeout = 300.0
        self._watchdog = (StallWatchdog(stall_timeout, abort=stall_abort)
                          if stall_timeout else None)
        self.rss_limit_bytes = (int(rss_limit_gb * 1e9) if rss_limit_gb
                                else None)
        if self.rss_limit_bytes is not None:
            _check_rss_limit_sane(self.rss_limit_bytes)
        self._rss_preempted = False
        self._profiler = (
            ProfileWindow(profile_steps,
                          Path(profile_dir) if profile_dir
                          else self.workdir / "profile")
            if profile_steps else None)
        self._global_step = 0  # transferred batches, for the profiler

    # -- preemption ------------------------------------------------------
    @property
    def _preempt_dir(self) -> Path:
        return self.workdir / "ckpt_preempt"

    @property
    def _preempt_unlocked_dir(self) -> Path:
        # where a save whose lock timed out writes, so that it can never
        # delete what the lock holder is writing
        return self.workdir / "ckpt_preempt_unlocked"

    def request_preempt(self, signum=None, frame=None) -> None:
        """Async-signal-safe: only flips a flag; the step loop saves at
        the next step boundary."""
        self._preempt = True

    def install_preemption_handler(self, signals=(signal.SIGTERM,)) -> None:
        """Route SIGTERM (the preemption grace signal) into
        :meth:`request_preempt`. Called by the CLI, not the constructor."""
        for s in signals:
            signal.signal(s, self.request_preempt)

    def _save_preempt(self, epoch: int, step_in_epoch: int) -> None:
        # its own synchronous manager and directory, under the
        # cross-process lock; a timed-out lock saves into the unlocked
        # directory instead. No manifest: the grace window is short, and
        # the next epoch's save supersedes it
        target = self._preempt_dir
        got = self._plock.acquire(timeout=self.preempt_lock_timeout)
        if not got:
            target = self._preempt_unlocked_dir
            print("[preempted] WARNING: preemption lock not acquired in "
                  f"{self.preempt_lock_timeout:.0f}s; saving unlocked to "
                  f"{target}", flush=True)
        try:
            shutil.rmtree(target, ignore_errors=True)
            CheckpointManager(target, max_to_keep=1, integrity=False).save(
                epoch, self.state, loggers=self.loggers,
                extra={"step_in_epoch": int(step_in_epoch),
                       "data_echo": self.data_echo,
                       **({"plateau": self.plateau.state_dict()}
                          if self.plateau else {})},
                best_metric=self.best_metric, config=self.config)
        finally:
            if got:
                self._plock.release()
        self.ckpt.wait_until_finished()  # commit an in-flight save too
        print(f"[preempted] saved epoch {epoch} step {step_in_epoch} "
              f"to {target}", flush=True)

    def _clear_preempt_ckpt(self) -> None:
        if self._preempt_dir.exists():
            shutil.rmtree(self._preempt_dir, ignore_errors=True)

    # -- resume ----------------------------------------------------------
    def resume(self, epoch: int | None = None) -> None:
        """Restore the newest (or the given) checkpoint: the train state,
        the metric history, the plateau controller and the best metric.

        A preemption checkpoint newer than the newest epoch checkpoint
        wins and resumes MID-epoch at its recorded step. The inspection,
        restore and stale-clear run under the :class:`PreemptLock`; a
        lock that cannot be had degrades to a read-only scan. Under
        ``recovery`` the epoch restore is verified: a corrupt newest
        epoch is quarantined and an older one restored (an explicitly
        given epoch must verify, or the resume fails)."""
        if epoch is None:
            got = self._plock.acquire(timeout=self.preempt_lock_timeout)
            if got:
                try:
                    if self._resume_from_preempt():
                        return
                finally:
                    self._plock.release()
            else:
                print("[resume] WARNING: preemption lock not acquired in "
                      f"{self.preempt_lock_timeout:.0f}s; read-only "
                      "preemption scan, nothing will be cleared",
                      flush=True)
                if self._resume_from_preempt(allow_clear=False):
                    return
                if self.ckpt.latest_epoch() is None:
                    raise RuntimeError(
                        "resume blocked: the preemption lock "
                        f"{self._plock.path} is held (a dying process "
                        "may still be saving), no finalized preemption "
                        "checkpoint is visible yet, and no epoch "
                        "checkpoint exists to fall back to; retry once "
                        "the in-flight save lands")
        if self.recovery is not None and epoch is None:
            meta = self.ckpt.restore_verified(
                self.state, counters=self.rec_counters,
                fingerprint_fn=self._fingerprint_fn())
        else:
            if self.recovery is not None:
                ok, why = self.ckpt.verify_epoch(epoch)
                if not ok:
                    raise RuntimeError(
                        f"--recover resume: pinned epoch {epoch} failed "
                        f"integrity verification ({why}); pick another "
                        "epoch, or drop the pin to fall back to the "
                        "newest verified epoch automatically")
            meta = self.ckpt.restore(self.state, epoch)
        self._apply_meta(meta)
        self.start_epoch = meta["epoch"] + 1
        self.start_step = 0

    def _fingerprint_fn(self):
        """The state fingerprint a verified restore checks against the
        manifest's (with the sentinel on)."""
        return None if self.sentinel is None \
            else self.sentinel.fingerprint_state

    def _resume_from_preempt(self, allow_clear: bool = True) -> bool:
        """Restore the furthest mid-epoch preemption checkpoint (of
        ``ckpt_preempt/`` and the unlocked directory) if it is newer than
        the newest epoch checkpoint (True), else False; with
        ``allow_clear`` stale directories are removed."""
        latest = self.ckpt.latest_epoch()
        best = None  # (epoch, step_in_epoch, dir)
        for d in (self._preempt_dir, self._preempt_unlocked_dir):
            if not d.exists():
                continue
            pmgr = CheckpointManager(d, max_to_keep=1)
            p_epoch = pmgr.latest_epoch()
            if p_epoch is None or (latest is not None and p_epoch <= latest):
                # superseded by an epoch save, or no finished save; an
                # unlocked directory without one may be a save in flight
                if allow_clear and not (d == self._preempt_unlocked_dir
                                        and p_epoch is None):
                    shutil.rmtree(d, ignore_errors=True)
                continue
            meta = pmgr.restore_meta(p_epoch)
            cand = (p_epoch, int(meta["extra"].get("step_in_epoch", 0)), d)
            if best is None or cand[:2] > best[:2]:
                best = cand
        if best is None:
            return False
        p_epoch, _, d = best
        meta = CheckpointManager(d, max_to_keep=1).restore(self.state,
                                                            p_epoch)
        saved_echo = meta["extra"].get("data_echo", 1)
        if saved_echo != self.data_echo:
            # the step index and the generator replay are in units of the
            # saved echo: another one would silently diverge
            raise ValueError(
                f"preemption checkpoint was written with --data-echo "
                f"{saved_echo}; resume with the same value (got "
                f"{self.data_echo})")
        self._apply_meta(meta)
        self.start_epoch = meta["epoch"]  # redo this epoch...
        self.start_step = meta["extra"]["step_in_epoch"]  # ...from here
        return True

    def _apply_meta(self, meta: dict) -> None:
        if meta.get("loggers"):
            self.loggers = meta["loggers"]
        extra = meta.get("extra", {})
        if self.plateau is not None and "plateau" in extra:
            self.plateau.load_state_dict(extra["plateau"])
            set_lr_scale(self.state.optimizer, self.plateau.scale)
        if meta.get("best_metric") is not None:
            self.best_metric = meta["best_metric"]

    # -- loops -----------------------------------------------------------
    def _run_step(self, epoch: int, step_in_epoch: int) -> int:
        """The epoch-anchored run step, the same for the uninterrupted
        run and a resumed one (the SDC sites key on it)."""
        if self.steps_per_epoch:
            return epoch * self.steps_per_epoch + step_in_epoch
        return self._global_step

    def _finite(self, metrics: dict) -> bool:
        """The step's finite flag, read on the host: the loss finite and,
        without a loss scale (whose skip handles an overflow), every
        gradient finite."""
        ok = torch.isfinite(metrics["loss"]).all()
        if self.state.loss_scale is None:
            grads = [p.grad for p in self.state.module.parameters()
                     if p.grad is not None]
            if grads:
                ok = ok & all_finite(grads).to(ok.device)
        return bool(ok)

    def train_epoch(self, epoch: int, start_step: int = 0) -> dict | None:
        """One epoch; ``start_step`` > 0 resumes mid-epoch (the batches
        before it are skipped on the host and the generators replayed),
        so that the remaining steps equal the uninterrupted run's.
        Returns None when preempted mid-epoch."""
        keys = KeySeq(self.seed + 1, epoch, device=self.device)
        keys.skip(start_step * self.data_echo)
        counts: list[int] = []
        # device metrics not yet fetched, with their step in the epoch
        pending: list[tuple[int, dict]] = []
        fetched: list[dict] = []

        def drain():
            if not pending:
                return
            with span("drain", cat="train"):
                # one device-to-host copy for every pending metric
                names = list(pending[0][1])
                values = torch.stack([
                    torch.stack([m[k].float() for k in names])
                    for _, m in pending]).tolist()
                steps = [i for i, _ in pending]
                pending.clear()
                for step_idx, row in zip(steps, values):
                    host = dict(zip(names, row))
                    fetched.append(host)
                    if self._watchdog:
                        self._watchdog.beat()
                    if self.sentinel is not None:
                        # raises SentinelTrip into the rollback loop
                        self.sentinel.observe(epoch, step_idx, host)

        def counted():
            for j, batch in enumerate(self.train_data(epoch)):
                if j < start_step:  # the host-side skip keeps the order
                    continue
                if self.injector is not None:
                    # after the resume skip, so that a rollback never
                    # replays a consumed fault occurrence
                    batch, fired = self.injector.poison_nan(batch)
                    if fired:
                        print(f"[fault] NaN-poisoned epoch {epoch} "
                              f"batch {j}", flush=True)
                    self.injector.maybe_stall()
                # a packed batch's image count, else its rows
                counts.append(getattr(batch, "n_images", None)
                              or len(batch["image"]))
                yield batch

        tel = FeedTelemetry()
        loader_before = _loader_paths()
        t0 = time.perf_counter()
        with span("epoch", cat="train", args={"epoch": int(epoch)}):
            feed = DevicePrefetcher(counted(), self.device,
                                    depth=self.prefetch_depth,
                                    telemetry=tel,
                                    fault_injector=self.injector,
                                    retry_policy=self.recovery,
                                    retry_counters=self.rec_counters)
            try:
                for i, batch in enumerate(feed):
                    if self._profiler:  # its start and stop cost time
                        with span("profiler", cat="train"):
                            self._profiler.on_step(self._global_step)
                    self._global_step += 1
                    step_in_epoch = start_step + i
                    with span("step", cat="train"):
                        for _ in range(self.data_echo):
                            metrics = self._train_step(self.state, batch,
                                                       next(keys))
                            if self.check_numerics \
                                    and not self._finite(metrics):
                                raise NumericDivergence(
                                    epoch, step_in_epoch,
                                    "non-finite loss or gradients")
                            pending.append((step_in_epoch, metrics))
                    run_step = self._run_step(epoch, step_in_epoch + 1)
                    if self.injector is not None:
                        sdc = self.injector.check_sdc(run_step)
                        if sdc is not None:
                            from deepvision_tpu_torch.resilience.sentinel \
                                import apply_sdc

                            apply_sdc(self.state, sdc)
                            print(f"[fault] {sdc.kind} corrupted local "
                                  f"state at run step {run_step}",
                                  flush=True)
                    # heartbeats land in drain(), per COMPLETED step; the
                    # watchdog forces a drain every 32 steps at most
                    if self._watchdog and i % min(32, self.log_every
                                                  or 32) == 0:
                        drain()
                    if (self.rss_limit_bytes
                            and i % (self.log_every or 32) == 0):
                        rss = _process_rss()
                        if rss > self.rss_limit_bytes:
                            print(
                                f"[rss-limit] host RSS {rss/1e9:.2f}GB > "
                                f"{self.rss_limit_bytes/1e9:.2f}GB — "
                                "self-preempting (mid-epoch save; "
                                "relaunch with --resume to continue in "
                                "a fresh process)", flush=True)
                            self._rss_preempted = True
                            self.request_preempt()
                    if self._preempt:
                        drain()  # the pending steps first
                        self._save_preempt(epoch, step_in_epoch + 1)
                        self.preempted = True
                        return None
                    if self.log_every and i % self.log_every == 0:
                        drain()
                        running = np.mean([m["loss"] for m in fetched])
                        print(f"[epoch {epoch} batch {i}] "
                              f"loss={fetched[-1]['loss']:.4f} "
                              f"running={running:.4f}", flush=True)
            finally:
                feed.close()
            drain()  # waits for the epoch's last step
        dt = time.perf_counter() - t0
        summary = tel.summary()
        loader = {k: v - loader_before[k]
                  for k, v in _loader_paths().items()}
        print(f"[feed] epoch {epoch}: wire {summary['wire_dtype']}, "
              f"{summary['h2d_bytes_per_image']} bytes an image crossed "
              f"({summary['image_bytes_per_image']} of them image bytes), "
              f"h2d_wait {summary['h2d_wait_ms']} ms and host_wait "
              f"{summary['host_wait_ms']} ms a batch, wait_frac "
              f"{summary['wait_frac']}"
              + (f"; loader workers moved {loader['shm']} batches through "
                 f"shared memory and {loader['pickled']} pickled"
                 if any(loader.values()) else ""), flush=True)
        # optimizer-processed images: each transferred image data_echo
        # times
        n_images = sum(counts) * self.data_echo
        w = np.repeat(np.asarray(counts, np.float64), self.data_echo)
        out = {f"train_{k}": float(np.average([m[k] for m in fetched],
                                               weights=w))
               for k in (fetched[0] if fetched else {})}
        if self.data_echo > 1:
            out["data_echo"] = float(self.data_echo)
        out.update(input_wait_metrics(summary))
        out.update(examples_per_sec=n_images / dt,
                   lr_scale=self.plateau.scale if self.plateau else 1.0)
        return out

    def validate(self) -> dict:
        feed = DevicePrefetcher(self.val_data(), self.device,
                                depth=self.prefetch_depth)

        def parts():
            for b in feed:
                out = self._eval_step(self.state, b)
                if self._watchdog:
                    self._watchdog.beat()
                yield out

        try:
            metrics, _ = aggregate_eval_parts(parts())
        finally:
            feed.close()
        return metrics

    def fit(self, epochs: int | None = None) -> Loggers:
        if self._watchdog:
            self._watchdog.start()
        try:
            return self._fit(epochs)
        finally:
            if self._watchdog:
                self._watchdog.stop()
            if self._profiler:  # the run ended inside A:B
                self._profiler.close()
            self.tb.close()
            # on every exit path (the chaos drills read these lines)
            if self.injector is not None:
                print(f"[faults] fired: {self.injector.summary()}",
                      flush=True)
            if self.recovery is not None:
                print(f"[recovery] {self.rec_counters.format()}",
                      flush=True)

    def _rollback(self, nd: NumericDivergence) -> int:
        """Restore the newest VERIFIED checkpoint (quarantining corrupt
        ones, counted as ``ckpt_fallbacks``), else the initial state,
        optionally re-warm the LR, and return the step to resume the
        epoch at (past the batch window). Aborts with
        :class:`RecoveryError` after ``max_rollbacks`` consecutive
        rollbacks."""
        pol = self.recovery
        if self._consecutive_rollbacks >= pol.max_rollbacks:
            raise RecoveryError(
                f"aborting after {self._consecutive_rollbacks} "
                f"consecutive rollbacks (max_rollbacks="
                f"{pol.max_rollbacks}): the divergence is persistent, "
                "not transient — inspect the data/LR before retrying"
            ) from nd
        self._consecutive_rollbacks += 1
        self.rec_counters.inc("rollbacks")
        if self.sentinel is not None:
            self.sentinel.reset()  # every series jumps back
        try:
            meta = self.ckpt.restore_verified(
                self.state, counters=self.rec_counters,
                fingerprint_fn=self._fingerprint_fn())
            source = f"epoch-{meta['epoch']} checkpoint"
        except FileNotFoundError:
            self.state.load_state_dict(self._init_state)
            source = "initial state (no verifiable checkpoint yet)"
        if pol.lr_rewarm is not None:
            scale = (self.state.optimizer.param_groups[0]["lr_scale"]
                     * pol.lr_rewarm)
            set_lr_scale(self.state.optimizer, scale)
            if self.plateau is not None:
                self.plateau.scale = scale  # keep the controller in step
            self.rec_counters.inc("lr_rewarms")
        resume_step = nd.step_in_epoch + pol.skip_batches
        print(f"[rollback] {nd}: restored {source}; resuming epoch "
              f"{nd.epoch} at step {resume_step} "
              f"({self._consecutive_rollbacks}/{pol.max_rollbacks} "
              "consecutive)", flush=True)
        time.sleep(pol.backoff(self._consecutive_rollbacks - 1))
        return resume_step

    def _fit(self, epochs: int | None = None) -> Loggers:
        total = epochs or self.config.get("total_epochs", 1)
        if self.start_epoch == 0 and self.start_step == 0:
            with span("eval", cat="train"):
                val = self.validate()  # pre-train validation
            if val:
                self.loggers.log_metrics(-1, val)
                print(f"[pre-train] {_fmt(val)}", flush=True)
        for epoch in range(self.start_epoch, total):
            start_step = self.start_step if epoch == self.start_epoch else 0
            while True:
                try:
                    tr = self.train_epoch(epoch, start_step=start_step)
                except NumericDivergence as nd:
                    if self.recovery is None:
                        raise  # fail fast
                    start_step = self._rollback(nd)
                    continue
                break
            self._consecutive_rollbacks = 0  # a completed epoch resets
            if tr is None:  # preempted mid-epoch; already saved
                return self.loggers
            if self.recovery is not None:
                tr.update(recovery_metrics(self.rec_counters))
            tr.update(sample_memory_gauges())  # {} on the CPU
            if start_step:
                # this epoch's train aggregates cover only its tail
                tr["train_from_step"] = float(start_step)
            with span("eval", cat="train"):
                val = self.validate()
            epoch_metrics = {**tr, **val}
            self.loggers.log_metrics(epoch, epoch_metrics)
            for k, v in tr.items():
                self.tb.scalar(k, v, epoch, "train")
            for k, v in val.items():
                self.tb.scalar(k, v, epoch, "val")
            self.tb.flush()
            print(f"[epoch {epoch}] {_fmt(epoch_metrics)}", flush=True)
            # plateau metric: accuracy when there is one, else the
            # negated loss; a resumed epoch without validation has only
            # its tail's train loss, which would steer the controller off
            # the uninterrupted run, so it is skipped
            metric = val.get(
                "val_top1",
                -val["val_loss"] if "val_loss" in val
                else (-tr["train_loss"] if not start_step else None))
            if metric is not None:
                if self.plateau is not None:
                    set_lr_scale(self.state.optimizer,
                                 self.plateau.update(metric))
                self.best_metric = max(self.best_metric, metric)
            with span("checkpoint", cat="train"):
                self.ckpt.save(
                    epoch, self.state, loggers=self.loggers,
                    extra=({"plateau": self.plateau.state_dict()}
                           if self.plateau else {}),
                    best_metric=self.best_metric, config=self.config,
                    # a metric-less epoch ranks at the current best
                    metrics={"plateau_metric": float(
                        metric if metric is not None
                        else self.best_metric)},
                    state_fingerprint=(
                        self.sentinel.fingerprint_state(self.state)
                        if self.sentinel is not None else None))
            # the epoch save supersedes a preemption save, once durable
            if self._preempt_dir.exists():
                self.ckpt.wait_until_finished()
                if self._plock.acquire(timeout=60.0):
                    try:
                        self._clear_preempt_ckpt()
                    finally:
                        self._plock.release()
            if self._preempt:  # the signal came during validate/save
                self.preempted = True
                self.ckpt.wait_until_finished()
                print(f"[preempted] after completed epoch {epoch}",
                      flush=True)
                return self.loggers
        self.ckpt.wait_until_finished()  # commit an in-flight save
        return self.loggers


class StallWatchdog:
    """Detection of a silent hang: a daemon thread watches a heartbeat
    the loop touches after every completed step; if none lands within
    ``timeout_s`` it prints a diagnosis, and with ``abort`` exits the
    process with code 75 (EX_TEMPFAIL) for a supervised restart into
    ``--resume``. Armed only after the first beat: the first step builds
    the kernels (``nvcc``) and autotunes cuDNN, legitimately for long."""

    def __init__(self, timeout_s: float, *, abort: bool = False,
                 _exit=os._exit):
        if timeout_s <= 0:
            raise ValueError(f"stall timeout must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.abort = abort
        self._exit = _exit  # injectable for tests
        self._last: float | None = None
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        """Idempotent while running; re-entrant after stop()."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._last = None
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def _run(self):
        poll = min(self.timeout_s / 4.0, 5.0)
        while not self._stop.wait(poll):
            if self._last is None:
                continue  # not armed until the first step lands
            stalled = time.monotonic() - self._last
            if stalled > self.timeout_s:
                self._fired.set()
                print(
                    f"[stall] no heartbeat in {stalled:.0f}s "
                    f"(timeout {self.timeout_s:.0f}s) — likely a wedged "
                    "device/runtime call; the process "
                    + ("will exit 75 for a supervised restart + --resume"
                       if self.abort else
                       "is left running (use --stall-abort to exit 75)"),
                    flush=True)
                if self.abort:
                    self._exit(75)
                self._last = time.monotonic()  # warn again, don't spam


def _process_rss(*, honor_fake: bool = True) -> int:
    """The process's resident set size in bytes, from ``/proc`` (0 where
    it cannot be read). ``DVTPU_FAKE_RSS`` (bytes) stands in for it in
    the loop's check, for tests; the constructor's sanity check ignores
    it (``honor_fake=False``)."""
    fake = os.environ.get("DVTPU_FAKE_RSS")
    if honor_fake and fake:
        try:
            return int(fake)
        except ValueError:
            pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def _check_rss_limit_sane(limit_bytes: int) -> None:
    """A limit at or below the current RSS would preempt every relaunch
    after one batch: refuse it at construction."""
    now = _process_rss(honor_fake=False)
    if now and limit_bytes <= now:
        raise ValueError(
            f"rss limit {limit_bytes/1e9:.2f}GB is at/below the current "
            f"process RSS {now/1e9:.2f}GB — every relaunch would "
            "immediately re-preempt after one batch; raise the limit "
            "above the steady-state baseline")


def make_rss_limit_flag(limit_gb: float) -> Callable[[], bool]:
    """A zero-argument RSS-limit poll for loops that take a ``preempt``
    callable (``fit_gan``): True, and latched True, once the RSS crosses
    ``limit_gb``."""
    limit = int(limit_gb * 1e9)
    _check_rss_limit_sane(limit)
    fired = {"rss": False}

    def exceeded() -> bool:
        if fired["rss"]:
            return True
        rss = _process_rss()
        if rss > limit:
            fired["rss"] = True
            print(f"[rss-limit] host RSS {rss/1e9:.2f}GB > "
                  f"{limit/1e9:.2f}GB — stopping for a supervised "
                  "relaunch (--resume)", flush=True)
            return True
        return False

    return exceeded


def make_preempt_flag(signals=(signal.SIGTERM,)) -> Callable[[], bool]:
    """Install handlers for ``signals`` and return a zero-argument
    callable saying whether one arrived: the preemption hook of loops
    that are functions (``fit_gan``)."""
    fired = {"stop": False}

    def handler(signum=None, frame=None):
        fired["stop"] = True

    for s in signals:
        signal.signal(s, handler)
    return lambda: fired["stop"]
