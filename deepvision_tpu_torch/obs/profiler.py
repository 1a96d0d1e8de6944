"""Opt-in ``torch.profiler`` windows and device-memory gauges, the port's
twin of ``deepvision_tpu/obs/profiler.py``.

- :class:`ProfileWindow`: ``--profile-steps A:B`` of the training CLI.
  A ``torch.profiler`` session starts just before global step A and
  stops after step B, once a run, and writes its Chrome trace
  (``steps_A_B.pt.trace.json`` under ``logdir``) when it stops. It
  traces the card when there is one, else the CPU. A profiler error
  degrades to one warning line, as the JAX window's does;
- :func:`profile_session`: one session around a whole region;
- :func:`device_memory_stats` / :func:`sample_memory_gauges`: the
  card's allocator statistics (``torch.cuda.memory_stats``) as
  ``mem_bytes_in_use_devI``, ``mem_peak_bytes_in_use_devI`` and
  ``mem_bytes_limit_devI``, gauges in the registry and per-epoch
  metrics; ``{}`` without an initialized card, as the JAX samplers give
  ``{}`` on the CPU.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

from deepvision_tpu_torch.obs.metrics import Registry, default_registry

__all__ = [
    "ProfileWindow",
    "device_memory_stats",
    "profile_session",
    "sample_memory_gauges",
]

# torch.cuda.memory_stats() fields under the JAX gauges' names
_MEM_FIELDS = {"bytes_in_use": "allocated_bytes.all.current",
               "peak_bytes_in_use": "allocated_bytes.all.peak"}


def device_memory_stats() -> dict[str, float]:
    """``{"mem_bytes_in_use_dev0": ..., ...}`` over the cards this process
    initialized; ``{}`` on the CPU."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    out: dict[str, float] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        for name, field in _MEM_FIELDS.items():
            if field in stats:
                out[f"mem_{name}_dev{i}"] = float(stats[field])
        out[f"mem_bytes_limit_dev{i}"] = float(
            torch.cuda.get_device_properties(i).total_memory)
    return out


def sample_memory_gauges(registry: Registry | None = None) -> dict:
    """Sample device memory into ``mem_*`` gauges of ``registry`` (default:
    the process's) and return the sample, which the Trainer logs per
    epoch."""
    stats = device_memory_stats()
    if stats:
        reg = registry if registry is not None else default_registry()
        for name, value in stats.items():
            reg.gauge(name).set(value)
    return stats


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                  else [ProfilerActivity.CPU])
    prof = profile(activities=activities)
    prof.start()
    return prof


@contextlib.contextmanager
def profile_session(logdir: str | Path | None):
    """One ``torch.profiler`` session around a region, its Chrome trace
    written to ``logdir/session.pt.trace.json`` at the end; yields True
    while it runs, False when disabled or unavailable."""
    if not logdir:
        yield False
        return
    prof = None
    try:
        Path(logdir).mkdir(parents=True, exist_ok=True)
        prof = _start_profiler()
        print(f"[obs] torch.profiler trace -> {logdir}", file=sys.stderr,
              flush=True)
    except Exception as e:
        print(f"[obs] profiler unavailable ({e!r}); continuing without",
              file=sys.stderr, flush=True)
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                prof.stop()
                prof.export_chrome_trace(
                    str(Path(logdir) / "session.pt.trace.json"))
            except Exception as e:
                print(f"[obs] profiler stop failed ({e!r})",
                      file=sys.stderr, flush=True)


class ProfileWindow:
    """``--profile-steps A:B``: profile global steps A..B (inclusive),
    once. ``on_step(step)`` takes the 0-based global index of the step
    ABOUT to run; the session starts when ``step == A`` arrives and
    stops as soon as a step past B is seen (or at :meth:`close`),
    writing ``trace_path``."""

    def __init__(self, spec: str, logdir: str | Path):
        try:
            a, _, b = spec.partition(":")
            self.start, self.stop = int(a), int(b)
        except ValueError:
            raise ValueError(
                f"--profile-steps wants 'A:B' (ints), got {spec!r}"
            ) from None
        if self.start < 0 or self.stop < self.start:
            raise ValueError(
                f"--profile-steps wants 0 <= A <= B, got {spec!r}")
        self.logdir = Path(logdir)
        self.trace_path = (self.logdir
                           / f"steps_{self.start}_{self.stop}.pt.trace.json")
        self.active = False
        self.done = False
        self._prof = None

    def on_step(self, step: int) -> None:
        if self.done:
            return
        if not self.active and step >= self.start:
            self.active = self._start()
            self.done = not self.active  # profiler unavailable: give up
        elif self.active and step > self.stop:
            self._stop()

    def close(self) -> None:
        """Stop a still-open window (the run ended inside [A, B])."""
        if self.active:
            self._stop()
        self.done = True

    def _start(self) -> bool:
        try:
            self.logdir.mkdir(parents=True, exist_ok=True)
            self._prof = _start_profiler()
            print(f"[obs] profiling steps {self.start}..{self.stop} -> "
                  f"{self.logdir}", flush=True)
            return True
        except Exception as e:
            print(f"[obs] profiler unavailable ({e!r}); --profile-steps "
                  "ignored", flush=True)
            return False

    def _stop(self) -> None:
        try:
            self._prof.stop()
            self._prof.export_chrome_trace(str(self.trace_path))
            print(f"[obs] profile window closed -> {self.trace_path}",
                  flush=True)
        except Exception as e:
            print(f"[obs] profiler stop failed ({e!r})", flush=True)
        self._prof = None
        self.active = False
        self.done = True
