"""Fleet-wide observability: the trace id's hop, span spools, federated
metrics and the crash flight recorder, the port's twin of
``deepvision_tpu/obs/distributed.py``.

The serving fleet is a router over N replica processes, and a training
run may feed from spawned decode workers: this module is the
cross-process layer on top of ``metrics.py`` and ``trace.py``, in four
pieces. The files it writes are byte-compatible with the twin's, so
that either package's reader reads the other's.

**Trace-context propagation.** Every routed request gets a trace id at
the router (:func:`new_trace_id`), carried over the HTTP hop in the
``X-DVTPU-Trace`` header (:data:`TRACE_HEADER`; the stdin surface takes
a ``"trace"`` field). The router stamps its ``router_attempt`` span with
it and the replica's engine its ``replica_queue``, ``device``,
``stage:<node>`` and ``postprocess`` spans, so that one request's spans
share one id across processes.

**Per-process span spools.** :class:`SpanSpool` attaches to the tracer
as a sink and appends every completed span to a crash-safe JSONL file
(one complete record a line: a SIGKILL tears at most the last line,
which the reader skips), bounded by a two-file rotation. Its header
line calibrates the tracer's monotonic clock against the wall clock
(``epoch_wall``), which lets ``obs/trace_merge.py`` put the spools of N
processes on one Perfetto timeline. ``serve --trace-spool DIR`` attaches
one; a child that finds :data:`ENV_SPOOL` in its environment attaches
one there (:func:`enable_spool_from_env`).

**Federated metrics.** A parent (the fleet router) scrapes its
children's typed registry dumps (:meth:`Registry.dump`, histogram
reservoirs included) and :func:`render_federated` re-exports one
Prometheus surface: exact sums for counters, sample-merged reservoirs
for histogram quantiles, per-child series labelled ``{replica="r1"}``.
:func:`parse_prometheus` reads that text back.

**Flight recorder.** :class:`FlightRecorder` keeps an always-on bounded
ring of the newest spans (a tracer sink: no ring of the tracer needed)
and notes of counter deltas, and dumps it atomically beside the spool on
SIGTERM and on a dispatcher crash. A SIGKILLed process runs no handler:
its spool is what survives. Nothing here touches the card: the dump's
registry snapshot reads the gauges as they were last set, so a router
that opened no card file opens none to record.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import uuid
from collections import deque
from pathlib import Path

from deepvision_tpu_torch.obs.metrics import (
    Registry,
    default_registry,
    histogram_export,
    render_family,
)
from deepvision_tpu_torch.obs.trace import Tracer, get_tracer

__all__ = [
    "ENV_SPOOL",
    "TRACE_HEADER",
    "FlightRecorder",
    "SpanSpool",
    "enable_spool_from_env",
    "flight_dump",
    "get_flight_recorder",
    "install_flight_recorder",
    "merge_histograms",
    "new_trace_id",
    "parse_prometheus",
    "read_spool",
    "render_federated",
    "spool_paths",
]

# the spool directory's hand-off: a parent exports it, and a child (a
# decode worker) attaches a SpanSpool there
ENV_SPOOL = "DVTPU_TRACE_SPOOL"
# the HTTP hop carrier of the trace id (router -> replica)
TRACE_HEADER = "X-DVTPU-Trace"
_SPOOL_PREFIX = "trace-spool-"


def new_trace_id() -> str:
    """A fleet-unique request trace id (16 hex characters of a uuid4)."""
    return uuid.uuid4().hex[:16]


# --------------------------------------------------------------- spools


class SpanSpool:
    """A crash-safe span spool of one process: a tracer sink that appends
    one JSON record a completed span.

    - crash-safe appends: every line is a complete record, written with
      one ``write`` and a flush; a SIGKILL tears at most the last line,
      which :func:`read_spool` skips;
    - bounded: past ``max_bytes`` the file moves to ``<name>.1`` (the
      previous ``.1`` dropped), a two-file ring;
    - calibrated: a header line records ``epoch_wall``, the wall time of
      the tracer's monotonic zero, and is written again whenever the
      tracer is re-epoched (``clear()``), so that the merger places every
      span on the fleet's wall timeline.
    """

    def __init__(self, directory: str | Path, *, role: str | None = None,
                 tracer: Tracer | None = None,
                 max_bytes: int = 8 << 20):
        self._tracer = tracer if tracer is not None else get_tracer()
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self.role = role or self._tracer.labels.get("role") or "proc"
        safe = "".join(c if c.isalnum() or c in "-_." else "-"
                       for c in str(self.role))
        self.path = self._dir / f"{_SPOOL_PREFIX}{safe}-{os.getpid()}.jsonl"
        self._max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._file = open(self.path, "a", encoding="utf-8")
        self._size = self.path.stat().st_size
        self._epoch_wall = None
        self._write_header()
        self._tracer.add_sink(self._sink)

    def _write_header(self) -> None:
        self._epoch_wall = self._tracer.epoch_wall
        self._write_line({
            "spool": 1, "pid": os.getpid(), "role": self.role,
            "labels": self._tracer.labels,
            "epoch_wall": self._epoch_wall, "time": time.time(),
        })

    def _write_line(self, rec: dict) -> None:
        line = json.dumps(rec) + "\n"
        self._file.write(line)
        self._file.flush()
        self._size += len(line)

    def _sink(self, rec: dict) -> None:
        with self._lock:
            if self._file.closed:
                return
            if self._tracer.epoch_wall != self._epoch_wall:
                self._write_header()  # the tracer re-epoched: recalibrate
            self._write_line(rec)
            if self._size > self._max_bytes:
                self._rotate()

    def _rotate(self) -> None:
        self._file.close()
        os.replace(self.path, self.path.with_name(self.path.name + ".1"))
        self._file = open(self.path, "a", encoding="utf-8")
        self._size = 0
        self._write_header()

    def close(self) -> None:
        self._tracer.remove_sink(self._sink)
        with self._lock:
            if not self._file.closed:
                self._file.close()

    def __enter__(self) -> "SpanSpool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def enable_spool_from_env(role: str | None = None,
                          labels: dict | None = None,
                          environ=os.environ) -> SpanSpool | None:
    """A child process's hook: when :data:`ENV_SPOOL` names a directory,
    label the process's tracer and attach a spool there (spans then
    record through the sink with the ring off). -> the spool, or None
    when no spool was asked for."""
    d = environ.get(ENV_SPOOL)
    if not d:
        return None
    tracer = get_tracer()
    merged = dict(labels or {})
    if role is not None:
        merged.setdefault("role", role)
    tracer.set_labels(**merged)
    return SpanSpool(d, role=merged.get("role"), tracer=tracer)


def spool_paths(root: str | Path) -> list[Path]:
    """Every spool file under ``root`` (the rotated ``.1`` halves among
    them), recursively: the merger's sweep."""
    root = Path(root)
    if root.is_file():
        return [root]
    return sorted(p for p in root.rglob(f"{_SPOOL_PREFIX}*.jsonl*")
                  if p.is_file())


def read_spool(path: str | Path) -> dict:
    """One spool file -> ``{"headers": [...], "events": [...]}``. Every
    event carries ``wall`` (seconds of the wall clock) from the header
    that governs it, so that events of different processes compare
    directly. A torn last line (a SIGKILL mid-write) is skipped: by
    construction it is the only damage there can be."""
    headers: list[dict] = []
    events: list[dict] = []
    cur: dict | None = None
    try:
        text = Path(path).read_text(encoding="utf-8", errors="replace")
    except OSError:
        return {"headers": [], "events": []}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # a torn tail line
        if rec.get("spool") == 1:
            headers.append(rec)
            cur = rec
            continue
        if cur is not None and "ts" in rec:
            rec = dict(rec)
            rec["wall"] = cur.get("epoch_wall", 0.0) + rec["ts"]
            rec["pid"] = cur.get("pid")
            rec["role"] = cur.get("role")
            rec["labels"] = cur.get("labels", {})
            events.append(rec)
    return {"headers": headers, "events": events}


# --------------------------------------------------- metric federation


def merge_histograms(dumps: list[dict]) -> dict:
    """N histogram dumps as one: summed count and total and the
    concatenated reservoirs, so that federated quantiles are taken over
    every child's samples rather than averaged from per-child
    quantiles."""
    samples: list[float] = []
    count, total = 0, 0.0
    for d in dumps:
        count += int(d.get("count", 0))
        total += float(d.get("total", 0.0))
        samples.extend(d.get("samples") or [])
    return {"type": "histogram", "count": count, "total": total,
            "samples": samples}


def render_federated(children: dict[str, dict], *,
                     own: Registry | None = None,
                     label: str = "replica",
                     own_label: str = "parent") -> str:
    """One Prometheus text surface over N children.

    ``children`` maps a label value (a replica id) to that child's
    :meth:`Registry.dump`. By family:

    - counters: one ``{label="child"}`` sample a child and the
      unlabelled exact sum;
    - gauges: the per-child samples only (the reader picks the
      aggregation);
    - histograms: reservoir-merged quantiles and summed ``_sum`` and
      ``_count``, with a ``_count`` sample a child.

    ``own`` adds the parent's own registry (the ``router_*`` families):
    a family no child has renders unlabelled as usual; a family a child
    has too folds the parent in as one more child under ``own_label``,
    so that no name is emitted twice."""
    table: dict[str, dict] = {}  # name -> {"type", "series": {label: payload}}
    for child, dump in children.items():
        for name, payload in (dump or {}).items():
            fam = table.setdefault(
                name, {"type": payload.get("type"), "series": {}})
            if fam["type"] == payload.get("type"):
                fam["series"][str(child)] = payload
    own_plain: list[tuple[str, dict]] = []
    if own is not None:
        for name, payload in own.dump().items():
            if name in table:
                if table[name]["type"] == payload.get("type"):
                    table[name]["series"][own_label] = payload
            else:
                own_plain.append((name, payload))

    lines: list[str] = []

    def fmt(v) -> str:
        return f"{float(v):.9g}"

    for name, fam in sorted({**dict(own_plain), **table}.items()):
        if name not in table:
            lines.extend(render_family(name, dict(own_plain)[name]))
            continue
        t, series = fam["type"], fam["series"]
        if t == "counter":
            lines.append(f"# TYPE {name}_total counter")
            for child in sorted(series):
                lines.append(
                    f'{name}_total{{{label}="{child}"}} '
                    f"{int(series[child]['value'])}")
            lines.append(f"{name}_total "
                         f"{sum(int(p['value']) for p in series.values())}")
        elif t == "gauge":
            lines.append(f"# TYPE {name} gauge")
            for child in sorted(series):
                lines.append(f'{name}{{{label}="{child}"}} '
                             f"{fmt(series[child]['value'])}")
        elif t == "histogram":
            merged = merge_histograms(list(series.values()))
            ex = histogram_export(merged)
            lines.append(f"# TYPE {name} summary")
            for q, v in ex["quantiles"].items():
                lines.append(f'{name}{{quantile="{q:g}"}} {fmt(v)}')
            for child in sorted(series):
                lines.append(f'{name}_count{{{label}="{child}"}} '
                             f"{int(series[child].get('count', 0))}")
            lines.append(f"{name}_sum {fmt(ex['sum'])}")
            lines.append(f"{name}_count {ex['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """The text exposition this module and ``metrics.py`` render, as
    ``{series_name: [(labels_dict, value), ...]}``: the checking half of
    federation, which re-derives the sums from the scraped text."""
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(None, 1)
            value = float(val)
        except ValueError:
            continue
        labels: dict = {}
        name = key
        if "{" in key and key.endswith("}"):
            name, _, rest = key.partition("{")
            for pair in rest[:-1].split(","):
                if "=" in pair:
                    k, _, v = pair.partition("=")
                    labels[k.strip()] = v.strip().strip('"')
        out.setdefault(name, []).append((labels, value))
    return out


# ------------------------------------------------------ flight recorder


class FlightRecorder:
    """An always-on bounded black box: the newest ``capacity`` span
    records (a tracer sink, active with the tracer's ring off) and
    notes, dumped when the process dies loudly enough to tell.

    ``note(label, ...)`` appends a marker with the counters' deltas since
    the previous note (gauges as they are), on a cadence that already
    exists (the router's probe tick), so that the ring tells what the
    process did, tick by tick, up to its end.

    ``dump(reason)`` writes one JSON file atomically,
    ``flightrec-<tag>-<reason>-<pid>-<n>.json``: the ring, the registry's
    snapshot, the tracer's labels and calibration; ``obs/trace_merge.py``
    folds it into a merged timeline as it does a spool. The callers'
    triggers: SIGTERM (the serving CLI's handler, or
    :meth:`install_signals`) and a dispatcher crash (the serving
    engine's supervisor). A SIGKILL runs no handler: the spool's tail is
    the record there."""

    def __init__(self, directory: str | Path | None = None, *,
                 capacity: int = 512,
                 registry: Registry | None = None,
                 tracer: Tracer | None = None,
                 meta: dict | None = None):
        self._dir = Path(directory) if directory is not None else None
        self._registry = (registry if registry is not None
                          else default_registry())
        self._tracer = tracer if tracer is not None else get_tracer()
        self.meta = dict(meta or {})
        self._ring: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._last_counters: dict[str, float] = {}
        self._dumps = 0
        self._tracer.add_sink(self._sink)

    def _sink(self, rec: dict) -> None:
        with self._lock:
            self._ring.append({"kind": "span", **rec})

    def note(self, label: str, step: int | None = None, **fields) -> None:
        """Append a marker with the metrics' deltas since the last note:
        counters as deltas, non-zero gauges as they are. Scalars only: a
        copy of the histograms' reservoirs on every tick would make the
        black box the overhead."""
        deltas: dict = {}
        for name, kind, payload in self._registry.collect(
                scalars_only=True):
            if kind == "counter":
                d = payload - self._last_counters.get(name, 0)
                self._last_counters[name] = payload
                if d:
                    deltas[name] = d
            elif kind == "gauge" and payload:
                deltas[name] = payload
        rec = {"kind": "note", "t": time.time(), "label": label,
               "metrics": deltas, **fields}
        if step is not None:
            rec["step"] = int(step)
        with self._lock:
            self._ring.append(rec)

    def dump(self, reason: str, directory: str | Path | None = None
             ) -> Path | None:
        """Write the black box atomically; -> its path (None when no
        directory was ever given). Never raises: a failing dump must not
        mask the failure it records."""
        try:
            d = Path(directory) if directory is not None else self._dir
            if d is None:
                return None
            d.mkdir(parents=True, exist_ok=True)
            labels = self._tracer.labels
            tag = labels.get("role") or self.meta.get("role") or "proc"
            if labels.get("host") is not None:
                tag = f"host{labels['host']}"
            self._dumps += 1
            safe_reason = "".join(c if c.isalnum() or c in "-_" else "-"
                                  for c in reason)
            path = d / (f"flightrec-{tag}-{safe_reason}-"
                        f"{os.getpid()}-{self._dumps}.json")
            with self._lock:
                events = list(self._ring)
            body = {
                "flightrec": 1,
                "reason": reason,
                "time": time.time(),
                "pid": os.getpid(),
                "meta": self.meta,
                "labels": labels,
                "epoch_wall": self._tracer.epoch_wall,
                "events": events,
                "snapshot": self._registry.snapshot(),
            }
            tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
            tmp.write_text(json.dumps(body))
            os.replace(tmp, path)
            return path
        except Exception:
            return None

    def install_signals(self, *signums) -> None:
        """Dump on each of ``signums`` (default SIGTERM), then chain to the
        previous disposition: a handler installed before still runs, and
        the default one is raised again, so that the process still dies.
        Main thread only (``signal.signal``'s rule)."""
        for signum in (signums or (signal.SIGTERM,)):
            prev = signal.getsignal(signum)

            def _handler(sig, frame, prev=prev):
                self.dump(f"signal-{sig}")
                if callable(prev):
                    prev(sig, frame)
                elif prev == signal.SIG_DFL:
                    signal.signal(sig, signal.SIG_DFL)
                    os.kill(os.getpid(), sig)
                # SIG_IGN: swallowed, as before

            signal.signal(signum, _handler)

    def close(self) -> None:
        self._tracer.remove_sink(self._sink)


_FLIGHT: FlightRecorder | None = None


def install_flight_recorder(directory: str | Path | None, *,
                            capacity: int = 512,
                            meta: dict | None = None,
                            signals: tuple = (),
                            registry: Registry | None = None
                            ) -> FlightRecorder | None:
    """Make and register the process's flight recorder, replacing any
    previous one; ``signals`` also installs dump-on-signal handlers (main
    thread only). A ``None`` directory uninstalls it instead: a recorder
    with nowhere to dump would still keep every span's sink running for a
    black box that can never be written."""
    global _FLIGHT
    if _FLIGHT is not None:
        _FLIGHT.close()
        _FLIGHT = None
    if directory is None:
        return None
    _FLIGHT = FlightRecorder(directory, capacity=capacity, meta=meta,
                             registry=registry)
    if signals:
        _FLIGHT.install_signals(*signals)
    return _FLIGHT


def get_flight_recorder() -> FlightRecorder | None:
    return _FLIGHT


def flight_dump(reason: str) -> Path | None:
    """Dump the process's flight recorder, if one is installed: the
    one-liner of a failure path (a dispatcher crash, SIGTERM), which does
    not care whether observability is wired."""
    rec = _FLIGHT
    return rec.dump(reason) if rec is not None else None
