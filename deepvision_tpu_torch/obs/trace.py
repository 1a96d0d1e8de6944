"""Span tracing with Chrome-trace export, the port's twin of
``deepvision_tpu/obs/trace.py``.

``torch.profiler`` answers what the card ran, op by op; this module
answers the coarser question of the training loop, what a step or an
epoch spent its time on, with host spans cheap enough to leave in every
loop::

    from deepvision_tpu_torch.obs.trace import get_tracer, span

    get_tracer().enable()
    with span("fetch"):
        batch = next(feed)
    with span("step") as sp:
        metrics = train_step(state, batch, generator)
        sp.device_sync(metrics)  # the card's work, not its enqueue
    get_tracer().export("trace.json")  # chrome://tracing / Perfetto

- disabled by default: ``span()`` hands out one shared no-op context
  manager unless the tracer is enabled, so the loops carry their spans
  unconditionally;
- ``time.perf_counter``, a monotonic clock;
- thread-aware: a span records its thread and its nesting depth, so the
  feed's producer thread has its own track;
- ``device_sync``: CUDA runs asynchronously, so a span closed just after
  a launch measures the enqueue. ``sp.device_sync(value)`` (or the
  ``device_sync=`` argument) records a ``torch.cuda.Event`` on the
  current stream and waits for it before the end stamp, when ``value``
  holds a CUDA tensor; on the CPU it does nothing;
- a ring buffer of the newest ``capacity`` spans; evicted spans are
  counted (``dropped_spans``, the ``trace_dropped_spans`` counter) and
  the export says so in its metadata;
- sinks: ``add_sink(fn)`` registers a callback a completed span (the
  span spool and the flight recorder, ``obs/distributed.py``). Spans
  record while the tracer is enabled OR a sink is attached
  (:attr:`Tracer.active`), so that an always-on flight recorder needs
  no ring; a span with a sink and no ring still reaches the sink;
- retroactive spans: :meth:`Tracer.record_span` records a span from
  explicit ``perf_counter`` stamps, for code that already takes them
  (the serving engine's queue wait, device call and post-process, a
  pipeline's stages from the CUDA events of its graph). It never
  touches the card;
- ``epoch_wall``, the wall time of the trace's monotonic zero (reset by
  ``clear()``), so that a cross-process merger
  (``obs/trace_merge.py``) aligns the spools of many processes on one
  timeline;
- process labels: ``set_labels(role=..., host=..., generation=...)``
  stamps exports and spool headers, so that a merged fleet trace names
  its pid rows (``router``, ``replica r1``; :func:`format_labels`).

:func:`summarize_chrome` turns an exported trace back into per-span
totals and the share of the wall time the spans cover; ``python -m
deepvision_tpu_torch.obs TRACE.json`` prints it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path

__all__ = ["Span", "Tracer", "format_labels", "get_tracer", "span",
           "summarize_chrome"]


def _cuda_tensors(value):
    """The CUDA tensors in ``value`` (a tensor, or a dict, list or tuple
    of them)."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value] if value.is_cuda else []
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _cuda_tensors(v)]
    return []


def _device_sync(value) -> None:
    """Wait for the card's work queued so far on the current stream of
    ``value``'s device, through an event, when ``value`` holds a CUDA
    tensor."""
    tensors = _cuda_tensors(value)
    if not tensors:
        return
    import torch

    with torch.cuda.device(tensors[0].device):
        event = torch.cuda.Event()
        event.record()
        event.synchronize()


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def device_sync(self, value):
        return value


_NOOP = _NoopSpan()


class Span:
    """One live ``with`` region; created by :meth:`Tracer.span`."""

    __slots__ = ("_tracer", "name", "cat", "args", "_sync", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: dict | None, device_sync):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._sync = device_sync

    def device_sync(self, value):
        """Wait for the card's work on ``value`` (a tensor or a dict of
        them) before the span's end stamp, so that the span measures the
        work and not its launch. Returns ``value``."""
        self._sync = value
        return value

    def __enter__(self):
        self._tracer._push()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            try:
                _device_sync(self._sync)
            except Exception:
                pass  # a failed sync must not mask the body's exception
        t1 = time.perf_counter()
        depth = self._tracer._pop()
        self._tracer._record(self.name, self.cat, self._t0,
                             t1 - self._t0, depth, self.args)
        return False


class Tracer:
    """Ring buffer of completed spans and their Chrome-trace export."""

    def __init__(self, capacity: int = 65536):
        self._lock = threading.Lock()
        self._events: deque[tuple] = deque(maxlen=capacity)
        self._capacity = capacity
        self._enabled = False
        self._epoch = time.perf_counter()  # trace time zero
        self.epoch_wall = time.time()      # wall clock of that zero
        self._local = threading.local()
        self._sinks: list = []
        self._dropped = 0          # ring evictions since clear()
        self._drop_counter = None  # lazily bound obs counter
        self._labels: dict = {}

    # -- lifecycle -------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def active(self) -> bool:
        """Spans record while the ring is enabled OR a sink is attached
        (a spool or a flight recorder keeps spans flowing without the
        ring)."""
        return self._enabled or bool(self._sinks)

    @property
    def dropped_spans(self) -> int:
        """Spans evicted from the ring since the last :meth:`clear`."""
        with self._lock:
            return self._dropped

    def enable(self, clear: bool = True) -> "Tracer":
        if clear:
            self.clear()
        self._enabled = True
        return self

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._epoch = time.perf_counter()
            self.epoch_wall = time.time()

    def add_sink(self, fn) -> None:
        """Register ``fn(record: dict)``, called (under the tracer's lock,
        in recording order) for every completed span. A sink runs on the
        recording thread, so it must be cheap."""
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    def set_labels(self, **labels) -> None:
        """Stamp the process's identity (``role``, ``host``,
        ``generation``) on exports and spool headers; a cross-process
        merge names this process's pid row from them. None values are
        ignored."""
        self._labels.update({k: v for k, v in labels.items()
                             if v is not None})

    @property
    def labels(self) -> dict:
        return dict(self._labels)

    # -- recording -------------------------------------------------------
    def span(self, name: str, cat: str = "app", args: dict | None = None,
             device_sync=None):
        """Context manager timing its body; a no-op while inactive."""
        if not self.active:
            return _NOOP
        return Span(self, name, cat, args, device_sync)

    def _push(self) -> None:
        self._local.depth = getattr(self._local, "depth", 0) + 1

    def _pop(self) -> int:
        depth = getattr(self._local, "depth", 1) - 1
        self._local.depth = depth
        return depth  # 0 for outermost spans

    def record_span(self, name: str, t0: float, t1: float,
                    cat: str = "app", args: dict | None = None) -> None:
        """Record a completed span from explicit ``time.perf_counter()``
        stamps (the clock of the live spans), for code that already
        stamps the region: the serving engine's queue wait, device call
        and post-process, and a DAG's stages. It reads no device state,
        so it never waits for the card."""
        if not self.active:
            return
        self._emit(name, cat, t0, max(0.0, t1 - t0), 0, args)

    def _record(self, name: str, cat: str, t0: float, dur: float,
                depth: int, args: dict | None) -> None:
        if self.active:  # deactivated while the span was open: drop it
            self._emit(name, cat, t0, dur, depth, args)

    def _emit(self, name: str, cat: str, t0: float, dur: float,
              depth: int, args: dict | None) -> None:
        thread = threading.current_thread()
        event = (name, cat, t0 - self._epoch, dur,
                 thread.ident, thread.name, depth, args)
        with self._lock:
            if self._enabled:
                if len(self._events) >= self._capacity:
                    # the deque evicts silently; the count says so
                    self._dropped += 1
                    self._inc_drop_counter()
                self._events.append(event)
            if self._sinks:
                rec = self._sink_record(event)
                for sink in self._sinks:
                    try:
                        sink(rec)
                    except Exception:
                        pass  # a broken sink must never fail the loop

    @staticmethod
    def _sink_record(event: tuple) -> dict:
        name, cat, ts, dur, tid, tname, depth, args = event
        rec = {"name": name, "cat": cat, "ts": ts, "dur": dur,
               "tid": tid, "tname": tname, "depth": depth}
        if args:
            rec["args"] = args
        return rec

    def _inc_drop_counter(self) -> None:
        if self._drop_counter is None:
            from deepvision_tpu_torch.obs.metrics import default_registry

            self._drop_counter = default_registry().counter(
                "trace_dropped_spans")
        self._drop_counter.inc()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export ----------------------------------------------------------
    def chrome_events(self) -> list[dict]:
        """Chrome trace event dicts ("X" complete events, ts/dur in
        microseconds) and thread-name metadata events."""
        with self._lock:
            events = list(self._events)
        pid = os.getpid()
        out: list[dict] = []
        threads: dict[int, str] = {}
        for name, cat, ts, dur, tid, tname, depth, args in events:
            threads.setdefault(tid, tname)
            out.append({
                "name": name, "cat": cat, "ph": "X",
                "ts": round(ts * 1e6, 3), "dur": round(dur * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": {**(args or {}), "depth": depth},
            })
        for tid, tname in threads.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        if self._labels:
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": format_labels(
                            self._labels)}})
        return out

    def export(self, path: str | Path) -> int:
        """Write ``{"traceEvents": [...]}`` (chrome://tracing, Perfetto);
        returns the number of spans written. The ``metadata`` block
        carries ``trace_dropped_spans``, so a truncated trace says so."""
        events = self.chrome_events()
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        meta = {"trace_dropped_spans": self.dropped_spans,
                "complete": self.dropped_spans == 0,
                "pid": os.getpid(), "epoch_wall": self.epoch_wall}
        if self._labels:
            meta["labels"] = dict(self._labels)
        path.write_text(json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms",
             "metadata": meta}))
        return sum(1 for e in events if e.get("ph") == "X")


def format_labels(labels: dict) -> str:
    """The row name of a labelled process: ``role`` first, then the
    cluster identity (``"replica r1"``, ``"host 0 gen 2"``)."""
    parts = []
    role = labels.get("role")
    if role:
        parts.append(str(role))
    host = labels.get("host")
    if host is not None and (not role or str(role) != f"host{host}"):
        parts.append(f"host {host}")
    gen = labels.get("generation")
    if gen is not None:
        g = str(gen)
        parts.append(g if g.startswith(("gen", "replay"))
                     else f"gen {g}")
    for k in sorted(labels):
        if k not in ("role", "host", "generation"):
            parts.append(f"{k}={labels[k]}")
    return " ".join(parts) or "process"


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer the loops' ``span(...)`` calls feed."""
    return _TRACER


def span(name: str, cat: str = "app", args: dict | None = None,
         device_sync=None):
    """``with span("step"): ...`` against the default tracer."""
    return _TRACER.span(name, cat=cat, args=args, device_sync=device_sync)


# ------------------------------------------------------- trace analysis


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of possibly-overlapping [start, end) intervals."""
    out: list[tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _clip(intervals, windows) -> list[tuple[float, float]]:
    """Intersect merged ``intervals`` with merged ``windows``."""
    out = []
    for s, e in intervals:
        for ws, we in windows:
            lo, hi = max(s, ws), min(e, we)
            if lo < hi:
                out.append((lo, hi))
    return _merge(out)


def summarize_chrome(trace: dict | list, wall_span: str = "epoch") -> dict:
    """Per-span time attribution from a Chrome-trace event list.

    ``wall_span`` names the enclosing span whose total duration is the
    wall clock being attributed (default ``"epoch"`` — the trainer's
    outermost per-epoch span). Attribution is the UNION of the other
    spans' intervals on the wall spans' threads, clipped to the wall
    windows — nesting and overlap never double-count. When no
    ``wall_span`` events exist, the full [first start, last end) extent
    of the trace is the wall.

    Returns ``{"spans": {name: {count,total_ms,mean_ms,max_ms,
    pct_of_wall}}, "wall_ms", "attributed_ms", "coverage", "wall_span"}``.
    """
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace
    xs = [e for e in events if e.get("ph") == "X"]
    per: dict[str, dict] = {}
    for e in xs:
        d = per.setdefault(e["name"], {"count": 0, "total_us": 0.0,
                                       "max_us": 0.0})
        d["count"] += 1
        d["total_us"] += e["dur"]
        d["max_us"] = max(d["max_us"], e["dur"])

    walls = [e for e in xs if e["name"] == wall_span]
    if walls:
        wall_tids = {(e.get("pid"), e.get("tid")) for e in walls}
        windows = _merge([(e["ts"], e["ts"] + e["dur"]) for e in walls])
    elif xs:
        wall_tids = {(e.get("pid"), e.get("tid")) for e in xs}
        windows = _merge([(min(e["ts"] for e in xs),
                           max(e["ts"] + e["dur"] for e in xs))])
    else:
        wall_tids, windows = set(), []
    wall_us = sum(e - s for s, e in windows)
    leaves = _merge([(e["ts"], e["ts"] + e["dur"]) for e in xs
                     if e["name"] != wall_span
                     and (e.get("pid"), e.get("tid")) in wall_tids])
    attributed_us = sum(e - s for s, e in _clip(leaves, windows))

    spans = {}
    for name, d in sorted(per.items(), key=lambda kv: -kv[1]["total_us"]):
        spans[name] = {
            "count": d["count"],
            "total_ms": round(d["total_us"] / 1e3, 3),
            "mean_ms": round(d["total_us"] / d["count"] / 1e3, 3),
            "max_ms": round(d["max_us"] / 1e3, 3),
            "pct_of_wall": (round(d["total_us"] / wall_us * 100.0, 1)
                            if wall_us else 0.0),
        }
    return {
        "spans": spans,
        "wall_span": wall_span,
        "wall_ms": round(wall_us / 1e3, 3),
        "attributed_ms": round(attributed_us / 1e3, 3),
        "coverage": round(attributed_us / wall_us, 4) if wall_us else 0.0,
    }

