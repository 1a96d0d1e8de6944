"""Epoch checkpoints: ``torch.save`` under SHA-256 manifests.

The twin of ``deepvision_tpu/train/checkpoint.py`` with ``torch.save`` in
place of Orbax. Epoch ``e`` lives in ``{directory}/{e}/``:

- ``state.pt``: the train state (model, optimizer with its momentum
  buffers, step, loss scale; ``TrainState.state_dict``), or a GAN's
  (every net, both optimizers, the pools, step, loss scale;
  ``train/gan.GANState.state_dict``);
- ``meta.json``: the epoch, the metric history, the best metric, the
  model's name and geometry (``model``: ``name``, ``input_size``,
  ``num_classes``, a pose model's ``num_heatmaps`` and a GAN's
  ``noise_dim``) and the
  ``extra`` dict (the plateau controller's
  state).

A save writes a temporary directory and renames it into place with
``os.replace``, then writes the epoch's manifest (``train/manifest.py``;
``integrity=False`` skips it), then keeps the newest ``max_to_keep``
epochs, or with ``keep_best_of`` the ``max_to_keep`` with the highest
value of that metric (the ``metrics`` a save passes, kept in
``meta.json``). :meth:`CheckpointManager.restore` verifies the manifest
first and raises on a mismatch; :meth:`CheckpointManager.restore_verified`
walks back from the newest epoch, moves each that fails (a checksum, or
the save-time state fingerprint the manifest carries) into
``quarantine/``, counts it in ``ckpt_fallbacks`` and restores the newest
that passes; :meth:`CheckpointManager.restore_model` gives serving the
newest verified epoch's weights and geometry, of one net (``net``) of a
GAN's checkpoint. ``fault_injector``'s ``ckpt_corrupt`` site garbles the
largest file of an epoch just committed (after its manifest).

``async_save`` (trap C27): torch's optimizers write the parameters in
place, where the JAX state is immutable, so a save that serialized the
live tensors in the background would race the next step. ``save``
therefore copies the whole state to host memory before it returns (a
synchronous device-to-host copy, after which the caller may step), and
a background thread writes, renames, hashes and prunes; one save is in
flight at a time, and :meth:`CheckpointManager.wait_until_finished`
waits for it and raises its error.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import torch

from deepvision_tpu_torch.train import manifest
from deepvision_tpu_torch.train.loggers import Loggers
from deepvision_tpu_torch.train.state import TrainState

__all__ = ["CheckpointManager", "host_copy"]

STATE_FILE = "state.pt"
META_FILE = "meta.json"
# the config keys a checkpoint keeps to rebuild its model, and a pose
# model's joint count where its config has one
MODEL_KEYS = ("name", "input_size", "num_classes")
POSE_KEYS = ("num_heatmaps",)
# a GAN's noise width where its config has one
GAN_KEYS = ("noise_dim",)


def _model_meta(config: dict) -> dict:
    return {**{k: config.get(k) for k in MODEL_KEYS},
            **{k: config[k] for k in POSE_KEYS + GAN_KEYS if k in config}}


def host_copy(obj):
    """``obj`` with every tensor copied to host memory (a synchronous
    device-to-host copy, or a clone of a host tensor)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def _load_state_file(path: Path, device: torch.device | str) -> dict:
    """A ``state.pt`` as saved (tensors on ``device``)."""
    return torch.load(path, map_location=device, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, max_to_keep: int = 3,
                 async_save: bool = False, keep_best_of: str | None = None,
                 integrity: bool = True, fault_injector=None):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.keep_best_of = keep_best_of
        self.integrity = integrity
        self._injector = fault_injector
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, epoch: int, state: TrainState, *,
             loggers: Loggers | None = None, extra: dict | None = None,
             best_metric: float | None = None,
             config: dict | None = None, metrics: dict | None = None,
             state_fingerprint: dict | None = None) -> Path:
        """Save ``state`` as epoch ``epoch``; ``config`` gives the model's
        name and geometry (``MODEL_KEYS``, and ``POSE_KEYS`` where it
        has them), ``metrics`` the values ``keep_best_of`` ranks by, and
        ``state_fingerprint`` rides the manifest. With ``async_save`` the
        state is on the host when this returns and the write goes on in
        the background."""
        self.wait_until_finished()  # one save in flight
        payload = host_copy(state.state_dict())
        meta = {"epoch": int(epoch),
                "loggers": loggers.to_json() if loggers else None,
                "best_metric": best_metric,
                "model": _model_meta(config or {}),
                "extra": extra or {},
                "metrics": metrics or {}}
        final = manifest.step_dir(self.directory, epoch)
        if not self.async_save:
            self._write(epoch, payload, meta, state_fingerprint)
            return final

        def run():
            try:
                self._write(epoch, payload, meta, state_fingerprint)
            except BaseException as e:  # raised at the next wait
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True,
                                        name=f"ckpt-save-{epoch}")
        self._thread.start()
        return final

    def _write(self, epoch: int, payload: dict, meta: dict,
               fingerprint: dict | None) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        final = manifest.step_dir(self.directory, epoch)
        tmp = self.directory / f".{epoch}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        (tmp / META_FILE).write_text(json.dumps(meta))
        if final.exists():  # a re-save of the same epoch replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.integrity:
            manifest.write_manifest(
                self.directory, epoch,
                extra={"state_fingerprint": fingerprint} if fingerprint
                else None)
        else:  # no stale sidecar may vouch for the new files
            manifest.manifest_path(self.directory, epoch).unlink(
                missing_ok=True)
        self._prune()
        if self._injector is not None and final.exists():
            self._injector.corrupt_checkpoint(final)

    def _prune(self) -> None:
        """Retention: the newest ``max_to_keep`` epochs, or the
        ``max_to_keep`` best by ``keep_best_of`` (the newer first among
        equals)."""
        epochs = self.saved_epochs()
        if self.keep_best_of is None:
            drop = epochs[:-self.max_to_keep]
        else:
            def rank(e):
                meta = json.loads(
                    (manifest.step_dir(self.directory, e) / META_FILE)
                    .read_text())
                value = meta.get("metrics", {}).get(self.keep_best_of)
                return (value is not None,
                        float(value) if value is not None else 0.0, e)

            keep = set(sorted(epochs, key=rank)[-self.max_to_keep:])
            drop = [e for e in epochs if e not in keep]
        for old in drop:
            shutil.rmtree(manifest.step_dir(self.directory, old))
            manifest.manifest_path(self.directory, old).unlink(
                missing_ok=True)

    def wait_until_finished(self) -> None:
        """Wait for an in-flight async save; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def saved_epochs(self) -> list[int]:
        """Epochs on disk; an in-flight async save is not one yet."""
        return manifest.fs_epochs(self.directory)

    def latest_epoch(self) -> int | None:
        epochs = self.saved_epochs()
        return epochs[-1] if epochs else None

    def verify_epoch(self, epoch: int) -> tuple[bool, str]:
        return manifest.verify_manifest(self.directory, epoch)

    def _resolve(self, epoch: int | None) -> int:
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(
                    f"no checkpoint under {self.directory}")
        ok, why = self.verify_epoch(epoch)
        if not ok:
            raise RuntimeError(
                f"checkpoint {self.directory}/{epoch} failed integrity "
                f"verification: {why}")
        return epoch

    def restore_meta(self, epoch: int | None = None) -> dict:
        """The verified epoch's ``meta.json``, with ``loggers`` rebuilt."""
        epoch = self._resolve(epoch)
        meta = json.loads(
            (manifest.step_dir(self.directory, epoch) / META_FILE)
            .read_text())
        if meta.get("loggers"):
            meta["loggers"] = Loggers.from_json(meta["loggers"])
        return meta

    def restore(self, state: TrainState, epoch: int | None = None) -> dict:
        """Load the newest (or the given) verified epoch into ``state`` (a
        ``TrainState`` or a ``GANState``); returns its meta. Raises if the
        manifest does not verify."""
        self.wait_until_finished()
        epoch = self._resolve(epoch)
        device = (state.device if hasattr(state, "device")
                  else next(state.module.parameters()).device)
        state.load_state_dict(_load_state_file(
            manifest.step_dir(self.directory, epoch) / STATE_FILE, device))
        return self.restore_meta(epoch)

    def quarantine_epoch(self, epoch: int) -> Path:
        """Move a failed epoch (and its manifest) into ``quarantine/``,
        kept for a post-mortem."""
        qroot = self.directory / "quarantine"
        qroot.mkdir(exist_ok=True)
        target = qroot / str(epoch)
        n = 0
        while target.exists():  # the same epoch quarantined again
            n += 1
            target = qroot / f"{epoch}.{n}"
        shutil.move(str(manifest.step_dir(self.directory, epoch)),
                    str(target))
        mp = manifest.manifest_path(self.directory, epoch)
        if mp.exists():
            shutil.move(str(mp), str(target) + ".manifest.json")
        return target

    def restore_verified(self, state, *, counters=None, log=print,
                         fingerprint_fn=None) -> dict:
        """Restore the newest epoch that verifies into ``state`` and
        return its meta: each newer epoch that fails its manifest, fails
        to load, or (with ``fingerprint_fn(state) -> {"digest": ...}``)
        restores to another fingerprint than the manifest's save-time
        one, is quarantined and counted in ``counters``'
        ``ckpt_fallbacks``. Raises ``FileNotFoundError`` when none is
        left. A load that fails on an epoch whose manifest verified is a
        systematic error (a state of another shape), not corruption: it
        is raised, not quarantined."""
        self.wait_until_finished()
        for epoch in reversed(self.saved_epochs()):
            ok, why = self.verify_epoch(epoch)
            if ok:
                try:
                    meta = self.restore(state, epoch)
                    why = self._check_fingerprint(epoch, state,
                                                  fingerprint_fn)
                    if why is None:
                        return meta
                except Exception as e:
                    if manifest.manifest_path(self.directory,
                                              epoch).exists():
                        raise
                    why = f"restore failed: {type(e).__name__}: {e}"
            log(f"[ckpt-integrity] epoch {epoch}: {why}; quarantining "
                "and falling back to an older epoch", flush=True)
            self.quarantine_epoch(epoch)
            if counters is not None:
                counters.inc("ckpt_fallbacks")
        raise FileNotFoundError(
            f"no verifiable checkpoints left in {self.directory} "
            "(corrupt epochs moved to quarantine/)")

    def _check_fingerprint(self, epoch: int, state,
                           fingerprint_fn) -> str | None:
        """None when the restored state's fingerprint is the manifest's
        save-time one (or either is absent); else the reason."""
        if fingerprint_fn is None:
            return None
        want = (manifest.read_manifest(self.directory, epoch) or {}).get(
            "state_fingerprint")
        if not isinstance(want, dict) or "digest" not in want:
            return None
        got = fingerprint_fn(state)
        if got["digest"] == want["digest"]:
            return None
        return (f"state fingerprint mismatch (restored {got['digest']} != "
                f"saved {want['digest']}): the bytes round-tripped but the "
                "state was corrupt before serialization")

    def restore_model(self, epoch: int | None = None,
                      device: torch.device | str = "cpu",
                      net: str | None = None) -> tuple[dict, dict]:
        """The model's state dict (on ``device``) and its ``model`` meta
        (``MODEL_KEYS``) from the given epoch, which must verify, or else
        from the newest epoch that verifies. A GAN's checkpoint holds
        several nets: ``net`` names the one (``"generator"``,
        ``"gen_a2b"``, ...)."""
        if epoch is None:
            epoch = manifest.newest_verified_epoch(self.directory)
            if epoch is None:
                raise FileNotFoundError(
                    f"no verified checkpoint under {self.directory}")
        else:
            epoch = self._resolve(epoch)
        sdir = manifest.step_dir(self.directory, epoch)
        meta = json.loads((sdir / META_FILE).read_text())
        saved = _load_state_file(sdir / STATE_FILE, device)
        if "modules" in saved:
            if net not in saved["modules"]:
                raise KeyError(f"{sdir} holds the nets "
                               f"{sorted(saved['modules'])}; name one of "
                               f"them (net={net!r})")
            return saved["modules"][net], meta["model"]
        if net is not None:
            raise KeyError(f"{sdir} holds one model, not nets ({net!r})")
        return saved["model"], meta["model"]
