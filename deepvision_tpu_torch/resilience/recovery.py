"""Recovery policy and counters, the port's twin of
``deepvision_tpu/resilience/recovery.py``.

:class:`RecoveryPolicy` is the one bundle of knobs shared by the
Trainer's NaN rollback loop, the device feed's transient read retries
and the checkpoint fallback scan. Every retry is bounded with
exponential backoff, and the Trainer aborts after ``max_rollbacks``
CONSECUTIVE rollbacks: a persistent fault must still fail loudly.

:class:`RecoveryCounters` is the audit trail: counters of rollbacks,
checkpoint fallbacks, data retries and LR re-warms in the process
registry (``recovery_*``), logged per epoch and printed at the end of
``fit`` as the ``[recovery]`` line.
"""

from __future__ import annotations

from dataclasses import dataclass

from deepvision_tpu_torch.obs.metrics import Counter, Registry, default_registry

__all__ = [
    "NumericDivergence",
    "RecoveryCounters",
    "RecoveryError",
    "RecoveryPolicy",
]


class RecoveryError(RuntimeError):
    """Recovery budget exhausted — the run aborts loudly."""


class NumericDivergence(RuntimeError):
    """The NaN/Inf tripwire fired at a known step (the JAX package's
    checkify check; the port's per-step finite flag); carries the
    position so that the rollback can skip past the batch window."""

    def __init__(self, epoch: int, step_in_epoch: int,
                 cause: BaseException | None = None):
        self.epoch = int(epoch)
        self.step_in_epoch = int(step_in_epoch)
        super().__init__(
            f"NaN/Inf detected at epoch {epoch} step {step_in_epoch}"
            + (f": {cause}" if cause is not None else ""))


class RecoveryCounters:
    """Thread-safe recovery event counters (producer thread + step loop
    + checkpoint scan all increment).

    Each field is an :class:`obs.metrics.Counter` registered into
    ``registry`` (default: the process registry) under ``recovery_*``
    names — the SAME names ``train/loggers.recovery_metrics`` logs per
    epoch — so the merged obs snapshot and ``GET /metrics`` carry the
    recovery audit trail without a second bookkeeping path."""

    FIELDS = ("rollbacks", "ckpt_fallbacks", "data_retries", "lr_rewarms")

    def __init__(self, registry: Registry | None = None):
        reg = registry if registry is not None else default_registry()
        self._counts = {k: reg.register(f"recovery_{k}", Counter())
                        for k in self.FIELDS}

    def inc(self, name: str, n: int = 1) -> None:
        self._counts[name].inc(n)

    def get(self, name: str) -> int:
        return self._counts[name].value

    def snapshot(self) -> dict:
        """Plain-dict view; ``train/loggers.recovery_metrics`` flattens
        it into the per-epoch ``recovery_*`` metric surface."""
        return {k: c.value for k, c in self._counts.items()}

    def format(self) -> str:
        """Grep-stable one-liner (``make chaos-smoke`` asserts on it)."""
        return " ".join(f"{k}={v}" for k, v in self.snapshot().items())

    def __repr__(self) -> str:
        return f"RecoveryCounters({self.format()})"


@dataclass
class RecoveryPolicy:
    """Bounded-retry / rollback knobs.

    - ``max_data_retries``: transient read retries per batch pull before
      the error propagates (prefetcher).
    - ``backoff_s`` × ``backoff_mult`` (capped at ``max_backoff_s``):
      exponential backoff between retries/restarts.
    - ``max_rollbacks``: CONSECUTIVE NaN rollbacks before the Trainer
      aborts with :class:`RecoveryError` (a completed epoch resets the
      streak).
    - ``skip_batches``: how far past the offending step the rollback
      resumes (the "batch window" presumed poisoned).
    - ``lr_rewarm``: optional factor (<1) applied to the optimizer's
      ``lr_scale`` on each rollback — re-warming after a blow-up, the
      classic divergence response.
    """

    max_data_retries: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0
    max_rollbacks: int = 3
    skip_batches: int = 1
    lr_rewarm: float | None = None

    def __post_init__(self):
        if self.max_data_retries < 0:
            raise ValueError("max_data_retries must be >= 0")
        if self.max_rollbacks < 1:
            raise ValueError("max_rollbacks must be >= 1")
        if self.skip_batches < 1:
            raise ValueError("skip_batches must be >= 1")
        if self.lr_rewarm is not None and not 0.0 < self.lr_rewarm <= 1.0:
            raise ValueError(f"lr_rewarm must be in (0, 1], "
                             f"got {self.lr_rewarm}")

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        return min(self.backoff_s * self.backoff_mult ** attempt,
                   self.max_backoff_s)
