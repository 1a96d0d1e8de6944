"""deepvision_tpu_torch.obs: the port's observability, the twin of
``deepvision_tpu/obs/``:

- ``metrics``: the process-wide registry of counters, gauges and
  reservoir histograms, its JSON ``snapshot()`` and its Prometheus text;
- ``trace``: span tracing (``with span("step")``) into a ring buffer,
  Chrome-trace export and ``summarize_chrome``;
- ``profiler``: ``torch.profiler`` windows (``--profile-steps A:B``) and
  the ``mem_*`` device-memory gauges;
- ``distributed``: the fleet's half of the JAX package's
  ``obs/distributed.py``: the trace id's HTTP hop and federated metrics
  (``render_federated``, ``parse_prometheus``). Its span spools and
  flight recorder come with the port's distributed observability.
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
