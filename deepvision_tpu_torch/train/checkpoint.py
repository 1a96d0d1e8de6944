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
``os.replace``, then writes the epoch's manifest
(``train/manifest.py``), then keeps the newest ``max_to_keep`` epochs.
:meth:`CheckpointManager.restore` verifies the manifest first and raises
on a mismatch; :meth:`CheckpointManager.restore_model` gives serving the
newest verified epoch's weights and geometry, of one net (``net``) of a
GAN's checkpoint. (Quarantine with fallback
to an older epoch comes with the resilience slice.)
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

from deepvision_tpu_torch.train import manifest
from deepvision_tpu_torch.train.loggers import Loggers
from deepvision_tpu_torch.train.state import TrainState

__all__ = ["CheckpointManager"]

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


def _load_state_file(path: Path, device: torch.device | str) -> dict:
    """A ``state.pt`` as saved (tensors on ``device``)."""
    return torch.load(path, map_location=device, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, max_to_keep: int = 3):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep

    def save(self, epoch: int, state: TrainState, *,
             loggers: Loggers | None = None, extra: dict | None = None,
             best_metric: float | None = None,
             config: dict | None = None) -> Path:
        """Save ``state`` as epoch ``epoch``; ``config`` gives the model's
        name and geometry (``MODEL_KEYS``, and ``POSE_KEYS`` where it
        has them)."""
        self.directory.mkdir(parents=True, exist_ok=True)
        final = manifest.step_dir(self.directory, epoch)
        tmp = self.directory / f".{epoch}.tmp.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state.state_dict(), tmp / STATE_FILE)
        meta = {"epoch": int(epoch),
                "loggers": loggers.to_json() if loggers else None,
                "best_metric": best_metric,
                "model": _model_meta(config or {}),
                "extra": extra or {}}
        (tmp / META_FILE).write_text(json.dumps(meta))
        if final.exists():  # a re-save of the same epoch replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        manifest.write_manifest(self.directory, epoch)
        for old in self.saved_epochs()[:-self.max_to_keep]:
            shutil.rmtree(manifest.step_dir(self.directory, old))
            manifest.manifest_path(self.directory, old).unlink(
                missing_ok=True)
        return final

    def saved_epochs(self) -> list[int]:
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
        epoch = self._resolve(epoch)
        device = (state.device if hasattr(state, "device")
                  else next(state.module.parameters()).device)
        state.load_state_dict(_load_state_file(
            manifest.step_dir(self.directory, epoch) / STATE_FILE, device))
        return self.restore_meta(epoch)

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
