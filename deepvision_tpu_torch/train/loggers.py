"""Metric history, the feed's and recovery's metric names, and the
TensorBoard writer: the twin of ``deepvision_tpu/train/loggers.py``.

:class:`Loggers` keeps ``{metric: {"epochs": [...], "value": [...]}}``,
JSON-serializable so that it rides inside the checkpoint.
:func:`input_wait_metrics` and :func:`recovery_metrics` name the per-epoch
``input_*`` and ``recovery_*`` metrics. :class:`TensorBoardWriter` writes
split ``train/`` and ``val/`` scalars per epoch, as the JAX writer does
through ``tf.summary``: here through ``torch.utils.tensorboard`` when the
``tensorboard`` package imports (without TensorFlow: its stub stands in),
else it prints one line and does nothing.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

__all__ = ["Loggers", "TensorBoardWriter", "input_wait_metrics",
           "recovery_metrics"]

# the feed telemetry's summary keys (data/prefetch.FeedTelemetry) logged
# per epoch as input_<key>: the producer's upstream wait and staging, the
# consumer's wait on a ready batch and its time between batches, the
# consumer's share of waiting, and the wire's bytes an image
_INPUT_WAIT_KEYS = ("host_wait_ms", "shard_ms", "h2d_wait_ms", "step_ms",
                    "wait_frac", "h2d_bytes_per_image",
                    "image_bytes_per_image")


def input_wait_metrics(summary: dict, prefix: str = "input_") -> dict:
    """A ``FeedTelemetry.summary()`` as loggable scalars
    (``input_host_wait_ms``, ...), shared by the Trainer and the GAN
    loop."""
    return {prefix + k: float(summary[k])
            for k in _INPUT_WAIT_KEYS if k in summary}


def recovery_metrics(counters, prefix: str = "recovery_") -> dict:
    """A ``resilience.RecoveryCounters`` (or its snapshot dict) as
    loggable scalars (``recovery_rollbacks``, ...): cumulative counts
    logged per epoch, so that the history says when a run recovered."""
    snap = counters.snapshot() if hasattr(counters, "snapshot") \
        else dict(counters)
    return {prefix + k: float(v) for k, v in snap.items()}


class Loggers:
    def __init__(self):
        self.data: dict[str, dict[str, list]] = {}

    def log_metrics(self, epoch: int, metrics: dict[str, float]) -> None:
        for name, value in metrics.items():
            series = self.data.setdefault(name, {"epochs": [], "value": []})
            series["epochs"].append(int(epoch))
            series["value"].append(float(value))

    def latest(self, name: str):
        vals = self.data.get(name, {}).get("value", [])
        return vals[-1] if vals else None

    def to_json(self) -> str:
        return json.dumps(self.data)

    @classmethod
    def from_json(cls, s: str) -> "Loggers":
        out = cls()
        out.data = json.loads(s)
        return out


class _EventFile:
    """One TensorBoard event file: tensorboard's ``Event`` protos in
    TFRecord framing (``data/tfrecord.frame_record``), the file
    ``SummaryWriter`` writes, opened with its ``file_version`` event."""

    def __init__(self, logdir: Path):
        import socket
        import time

        from tensorboard.compat.proto.event_pb2 import Event

        self._event = Event
        logdir.mkdir(parents=True, exist_ok=True)
        self._f = open(logdir / (f"events.out.tfevents.{int(time.time())}."
                                 f"{socket.gethostname()}.{os.getpid()}"),
                       "ab")
        self._write(Event(wall_time=time.time(),
                          file_version="brain.Event:2"))

    def _write(self, event) -> None:
        from deepvision_tpu_torch.data.tfrecord import frame_record

        self._f.write(frame_record(event.SerializeToString()))

    def scalar(self, tag: str, value: float, step: int) -> None:
        import time

        from tensorboard.compat.proto.summary_pb2 import Summary

        self._write(self._event(
            wall_time=time.time(), step=step,
            summary=Summary(value=[Summary.Value(tag=tag,
                                                 simple_value=value)])))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorBoardWriter:
    """Per-split (``train``, ``val``) event files under ``logdir``, made
    at the first scalar; a no-op, said once, without ``tensorboard``."""

    def __init__(self, logdir: str | Path):
        self._logdir = Path(logdir)
        self._enabled = True
        self._checked = False
        self._writers: dict = {}

    def scalar(self, tag: str, value: float, step: int,
               split: str = "train") -> None:
        if not self._enabled:
            return
        if not self._checked:
            self._checked = True
            try:
                import tensorboard  # noqa: F401
            except ImportError:
                print("[tensorboard] tensorboard is not installed; "
                      "scalars are not written", flush=True)
                self._enabled = False
                return
        if split not in self._writers:
            self._writers[split] = _EventFile(self._logdir / split)
        self._writers[split].scalar(tag, float(value), int(step))

    def flush(self) -> None:
        for w in self._writers.values():
            w.flush()

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
        self._writers.clear()
