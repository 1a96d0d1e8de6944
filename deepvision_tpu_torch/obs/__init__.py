"""deepvision_tpu_torch.obs: the port's observability for training, the
twin of the single-process half of ``deepvision_tpu/obs/``:

- ``metrics``: the process-wide registry of counters, gauges and
  reservoir histograms, its JSON ``snapshot()`` and its Prometheus text;
- ``trace``: span tracing (``with span("step")``) into a ring buffer,
  Chrome-trace export and ``summarize_chrome``;
- ``profiler``: ``torch.profiler`` windows (``--profile-steps A:B``) and
  the ``mem_*`` device-memory gauges.

The JAX package's cross-process layer (``obs/distributed.py``: trace
propagation, span spools, federated metrics, the flight recorder) comes
with the port's cluster.
"""

from deepvision_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    default_registry,
)
from deepvision_tpu_torch.obs.profiler import (
    ProfileWindow,
    device_memory_stats,
    profile_session,
    sample_memory_gauges,
)
from deepvision_tpu_torch.obs.trace import (
    Span,
    Tracer,
    get_tracer,
    span,
    summarize_chrome,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "default_registry",
    "ProfileWindow",
    "device_memory_stats",
    "profile_session",
    "sample_memory_gauges",
    "Span",
    "Tracer",
    "get_tracer",
    "span",
    "summarize_chrome",
]
