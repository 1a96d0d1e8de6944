"""deepvision_tpu_torch.resilience: self-healing training, the port's
twin of ``deepvision_tpu/resilience/`` on one host.

- ``faults``: :class:`FaultInjector`, the deterministic (or seeded
  probabilistic) injector of NaN steps, transient read errors,
  checkpoint corruption, stalls, loader-worker kills and SDC, consulted
  by the Trainer, the device feed, the loader and the checkpoints;
- ``recovery``: :class:`RecoveryPolicy` (bounded retries, backoff, the
  rollback budget, the batch window skipped, the LR re-warm) and
  :class:`RecoveryCounters` (``recovery_*`` in the registry, the
  ``[recovery]`` line);
- ``sentinel``: the in-step sentinel scalars, the EWMA detector, state
  fingerprints and the SDC drills; imported lazily by its consumers, as
  the JAX package's is, so that ``import
  deepvision_tpu_torch.resilience`` stays cheap.

The JAX package's ``cluster`` (multi-host coordination, supervised
relaunch, cross-host audits) is not ported yet.
"""

from deepvision_tpu_torch.resilience.faults import (
    CLUSTER_SITES,
    FaultInjector,
    FaultSpec,
    InjectedCrash,
    InjectedIOError,
    format_spec,
    parse_schedule,
    poison_batch,
    split_schedule,
)
from deepvision_tpu_torch.resilience.recovery import (
    NumericDivergence,
    RecoveryCounters,
    RecoveryError,
    RecoveryPolicy,
)

__all__ = [
    "CLUSTER_SITES",
    "FaultInjector",
    "FaultSpec",
    "InjectedCrash",
    "InjectedIOError",
    "format_spec",
    "parse_schedule",
    "poison_batch",
    "split_schedule",
    "NumericDivergence",
    "RecoveryCounters",
    "RecoveryError",
    "RecoveryPolicy",
]
