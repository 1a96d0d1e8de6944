"""deepvision_tpu_torch.obs: the port's observability, the twin of
``deepvision_tpu/obs/``:

- ``metrics``: the process-wide registry of counters, gauges and
  reservoir histograms, its JSON ``snapshot()`` and its Prometheus text;
- ``trace``: span tracing (``with span("step")``) into a ring buffer,
  Chrome-trace export and ``summarize_chrome``;
- ``profiler``: ``torch.profiler`` windows (``--profile-steps A:B``) and
  the ``mem_*`` device-memory gauges;
- ``distributed``: the trace id's HTTP hop, the crash-safe span spools
  (``SpanSpool``, ``read_spool``), federated metrics
  (``render_federated``, ``parse_prometheus``) and the flight recorder
  (``install_flight_recorder``, ``flight_dump``);
- ``trace_merge``: the spools and flight dumps of many processes as one
  Chrome trace (``python -m deepvision_tpu_torch.obs.trace_merge DIR``).
"""

from deepvision_tpu_torch.obs.distributed import (
    TRACE_HEADER,
    FlightRecorder,
    SpanSpool,
    enable_spool_from_env,
    flight_dump,
    get_flight_recorder,
    install_flight_recorder,
    new_trace_id,
    parse_prometheus,
    read_spool,
    render_federated,
)

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
    "TRACE_HEADER",
    "FlightRecorder",
    "SpanSpool",
    "enable_spool_from_env",
    "flight_dump",
    "get_flight_recorder",
    "install_flight_recorder",
    "new_trace_id",
    "parse_prometheus",
    "read_spool",
    "render_federated",
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
