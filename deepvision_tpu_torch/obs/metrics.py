"""Process-wide metric registry: counters, gauges, reservoir histograms.

The port's twin of ``deepvision_tpu/obs/metrics.py``, with the same
names and the same exposition text:

- :class:`Counter` / :class:`Gauge`: lock-guarded scalars;
- :class:`Histogram`: a bounded reservoir (the newest ``maxlen``
  samples, for p50/p95/p99) with an exact lifetime ``count`` and
  ``total``, read together under the histogram's own lock;
- :class:`Registry`: a thread-safe name -> metric table under the
  ``namespace_name`` scheme (``input_h2d_wait``, ``recovery_rollbacks``,
  ``mem_bytes_in_use_dev0``), one merged JSON :meth:`~Registry.snapshot`
  and the Prometheus text exposition (:meth:`~Registry.render_prometheus`).

:func:`default_registry` is the process's registry, into which the
recovery counters, the loader's restart counter and the sentinel's
counters register; registering a name again replaces its owner.

Histograms record seconds; the JSON snapshot reports milliseconds
(``*_ms``), the Prometheus text seconds (quantiles and ``_sum``).
"""

from __future__ import annotations

import re
import threading
from collections import deque

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "default_registry",
    "histogram_export",
    "histogram_summary",
    "render_family",
]

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class Counter:
    """Monotonic (in normal use) integer counter; ``inc`` from any
    thread, ``value`` reads are consistent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def __repr__(self) -> str:
        return f"Counter({self.value})"


class Gauge:
    """Last-written float value (memory in use, queue depth, ...)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def __repr__(self) -> str:
        return f"Gauge({self.value})"


class Histogram:
    """Bounded-reservoir time series with percentile snapshots.

    ``observe`` takes seconds; :meth:`summary` reports milliseconds in
    the exact shape ``serve/telemetry.LatencyStats.summary`` has always
    produced (``/stats`` JSON contract). The reservoir keeps the most
    recent ``maxlen`` samples (enough for stable p99 at serving rates)
    while ``count``/``total`` stay exact over the metric's lifetime.

    All three of (samples, count, total) mutate and read under ONE
    internal lock: ``summary()`` computes ``mean_ms`` from a coherent
    (count, total) pair even while writers are mid-``observe``.
    """

    def __init__(self, maxlen: int = 8192):
        self._lock = threading.Lock()
        self._samples: deque[float] = deque(maxlen=maxlen)
        self._count = 0
        self._total = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._samples.append(value)
            self._count += 1
            self._total += value

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._count = 0
            self._total = 0.0

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._total

    def dump(self) -> dict:
        """Typed raw view INCLUDING the reservoir samples, so that
        several processes' reservoirs merge sample for sample."""
        with self._lock:
            return {"type": "histogram", "count": self._count,
                    "total": self._total,
                    "samples": [float(s) for s in self._samples]}

    def export(self, qs=(0.5, 0.95, 0.99)) -> dict:
        """Base-unit (seconds) view for the Prometheus rendering: one
        locked read yields a coherent (count, sum, quantiles) triple."""
        return histogram_export(self.dump(), qs)

    def summary(self) -> dict:
        return histogram_summary(self.dump())

    def __repr__(self) -> str:
        return f"Histogram(count={self.count})"


_METRIC_TYPES = (Counter, Gauge, Histogram)


class Registry:
    """Thread-safe name -> metric table with one merged snapshot.

    Names follow ``namespace_name`` (``serve_completed``,
    ``input_h2d_wait``); :meth:`register` replaces an existing owner
    (latest wins), the get-or-create helpers (:meth:`counter`,
    :meth:`gauge`, :meth:`histogram`) return the existing metric — and
    refuse a type change, which is always a naming-collision bug.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    # -- registration ----------------------------------------------------
    def register(self, name: str, metric):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r} (want "
                             "[a-zA-Z_][a-zA-Z0-9_]*)")
        if not isinstance(metric, _METRIC_TYPES):
            raise TypeError(f"not a metric: {metric!r}")
        with self._lock:
            self._metrics[name] = metric
        return metric

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, not {cls.__name__}")
                return m
        # create outside the lock, register() re-takes it (a racing
        # duplicate create is harmless: last registration wins)
        return self.register(name, factory())

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, Gauge)

    def histogram(self, name: str, maxlen: int = 8192) -> Histogram:
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(maxlen=maxlen))

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def value_of(self, name: str, default: float = 0.0) -> float:
        """Scalar read of a counter/gauge by name (``default`` when the
        metric is absent or a histogram)."""
        m = self.get(name)
        if isinstance(m, (Counter, Gauge)):
            return float(m.value)
        return default

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- export ----------------------------------------------------------
    def collect(self, scalars_only: bool = False
                ) -> list[tuple[str, str, object]]:
        """One atomic collection pass: ``[(name, kind, payload), ...]``
        with every value read in one sweep under the registry lock.
        Every renderer formats from a collect() result, so one scrape
        sees one point in time. ``scalars_only`` skips the histograms
        and their reservoir copies: the flight recorder's notes run on
        hot cadences and read only counters and gauges."""
        out: list[tuple[str, str, object]] = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Counter):
                    out.append((name, "counter", m.value))
                elif isinstance(m, Gauge):
                    out.append((name, "gauge", m.value))
                elif not scalars_only:
                    out.append((name, "histogram", m.dump()))
        return out

    def snapshot(self) -> dict:
        """One merged JSON-able view: counters -> int, gauges -> float,
        histograms -> their ``summary()`` dict (ms). Rendered from one
        :meth:`collect` pass."""
        out: dict = {}
        for name, kind, payload in self.collect():
            if kind == "histogram":
                out[name] = histogram_summary(payload)
            else:
                out[name] = payload
        return out

    def dump(self) -> dict:
        """Typed raw registry view: counters/gauges with kind tags,
        histograms with their full reservoir (see
        :meth:`Histogram.dump`). One atomic :meth:`collect` pass."""
        out: dict = {}
        for name, kind, payload in self.collect():
            if kind == "histogram":
                out[name] = payload  # already typed by Histogram.dump
            else:
                out[name] = {"type": kind, "value": payload}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4): counters
        as ``<name>_total``, gauges verbatim, histograms as summaries
        (p50/p95/p99 quantile samples in seconds + ``_sum``/``_count``).
        Formats from one atomic :meth:`collect` pass, so families in
        one scrape never mix epochs."""
        lines: list[str] = []
        for name, payload in self.dump().items():
            lines.extend(render_family(name, payload))
        return "\n".join(lines) + "\n"


def histogram_export(dump: dict, qs=(0.5, 0.95, 0.99)) -> dict:
    """Seconds-unit (count, sum, quantiles) from a histogram dump —
    the pure half of :meth:`Histogram.export`, reusable on merged
    (federated) reservoirs."""
    samples = dump.get("samples") or []
    if samples:
        arr = np.asarray(samples, np.float64)
        vals = np.percentile(arr, [q * 100.0 for q in qs])
        quant = {q: float(v) for q, v in zip(qs, vals)}
    else:
        quant = {q: 0.0 for q in qs}
    return {"count": dump.get("count", 0),
            "sum": dump.get("total", 0.0), "quantiles": quant}


def histogram_summary(dump: dict) -> dict:
    """Milliseconds-unit summary (the ``/stats`` shape) from a
    histogram dump — the pure half of :meth:`Histogram.summary`."""
    samples = dump.get("samples") or []
    count = dump.get("count", 0)
    total = dump.get("total", 0.0)
    if not samples:
        return {"count": count, "mean_ms": 0.0, "p50_ms": 0.0,
                "p95_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
    arr = np.asarray(samples, np.float64) * 1e3
    p50, p95, p99 = np.percentile(arr, [50, 95, 99])
    return {
        "count": count,
        "mean_ms": round(total / max(1, count) * 1e3, 3),
        "p50_ms": round(float(p50), 3),
        "p95_ms": round(float(p95), 3),
        "p99_ms": round(float(p99), 3),
        "max_ms": round(float(arr.max()), 3),
    }


def _fmt(v: float) -> str:
    return f"{v:.9g}"


def render_family(name: str, payload: dict) -> list[str]:
    """Exposition lines for ONE unlabelled metric family from its
    typed :meth:`Registry.dump` payload: the one definition of the
    counter/gauge/histogram-summary text format."""
    t = payload.get("type")
    if t == "counter":
        return [f"# TYPE {name}_total counter",
                f"{name}_total {int(payload['value'])}"]
    if t == "gauge":
        return [f"# TYPE {name} gauge", f"{name} {_fmt(payload['value'])}"]
    ex = histogram_export(payload)
    lines = [f"# TYPE {name} summary"]
    for q, v in ex["quantiles"].items():
        lines.append(f'{name}{{quantile="{q:g}"}} {_fmt(v)}')
    lines.append(f"{name}_sum {_fmt(ex['sum'])}")
    lines.append(f"{name}_count {ex['count']}")
    return lines


_DEFAULT = Registry()


def default_registry() -> Registry:
    """The process-wide registry every telemetry object registers into
    by default."""
    return _DEFAULT
