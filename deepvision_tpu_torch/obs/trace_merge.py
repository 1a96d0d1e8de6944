"""The spools and flight-recorder dumps of a fleet's processes as ONE
Chrome trace (Perfetto, chrome://tracing): the port's twin of
``tools/trace_merge.py``, with the same output and exit codes.

    # merge everything under a fleet's spool directory
    python -m deepvision_tpu_torch.obs.trace_merge /tmp/fleet-obs -o merged.json

    # the fleet's gate: at least one request whose flow crosses from the
    # router's row into a replica's
    python -m deepvision_tpu_torch.obs.trace_merge /tmp/fleet-obs \
        --assert-flow --assert-spans router_attempt,replica_queue,device

Every process of a fleet (``serve --fleet N --trace-spool DIR``) appends
its completed spans to a crash-safe spool (``obs/distributed.SpanSpool``)
and leaves a flight-recorder dump (``flightrec-*.json``) when it dies
loudly. This tool collects both, aligns them on the wall clock by each
spool's calibration header (``epoch_wall``, the wall time of that
process's trace zero, written again on a re-epoch), and writes one
Chrome-trace JSON:

- one **pid row a process**, named from its labels (``router``,
  ``replica r1``), and a tid row a thread;
- **flow arrows a request**: the spans that share a trace id
  (``X-DVTPU-Trace``) get Chrome flow events s/t/f in wall order, so that
  Perfetto draws router attempt -> replica queue -> device for a request;
- flight-recorder **notes as instant events** (``note:<label>``, with
  the metric deltas in args).

A missing spool (a SIGKILLed child that never flushed, a replica that
never started) or a torn one is skipped, never fatal: the merge is the
union of the evidence that survived. Exit code 1 when nothing was found
or an assertion fails, else 0.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from deepvision_tpu_torch.obs.distributed import read_spool, spool_paths
from deepvision_tpu_torch.obs.trace import format_labels

__all__ = ["collect", "cross_process_requests", "main", "merge"]


def _flightrec_events(path: Path) -> tuple[dict, list[dict]]:
    """One dump -> (source meta, events-with-wall). Span events get
    ``wall`` from the dump's calibration; notes carry their own wall
    ``t``."""
    try:
        body = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}, []
    if body.get("flightrec") != 1:
        return {}, []
    epoch_wall = float(body.get("epoch_wall") or 0.0)
    meta = {"file": path.name, "kind": "flightrec",
            "reason": body.get("reason"),
            "pid": body.get("pid"), "labels": body.get("labels") or {}}
    out = []
    for e in body.get("events", []):
        e = dict(e)
        if e.get("kind") == "note":
            e["wall"] = float(e.get("t", 0.0))
        elif "ts" in e:
            e["wall"] = epoch_wall + float(e["ts"])
        else:
            continue
        out.append(e)
    return meta, out


def collect(root: str | Path) -> list[dict]:
    """Every source under ``root``: spools and flight-recorder dumps,
    each as ``{"meta", "events"}``. A rotated spool's two halves
    (``<name>.jsonl`` + ``<name>.jsonl.1``) fold into ONE source — they
    are the same process's ring, and two sources would render it as
    two pid rows with its timeline split at the rotation boundary
    (inflating the cross-process flow count when a request straddles
    it)."""
    root = Path(root)
    sources: list[dict] = []
    by_stem: dict[Path, dict] = {}
    for p in spool_paths(root):
        data = read_spool(p)
        if not data["headers"]:
            continue
        h = data["headers"][-1]
        stem = (p.with_suffix("") if p.name.endswith(".jsonl.1") else p)
        src = by_stem.get(stem)
        if src is None:
            by_stem[stem] = src = {
                "meta": {"file": stem.name, "kind": "spool",
                         "pid": h.get("pid"), "role": h.get("role"),
                         "labels": h.get("labels") or {}},
                "events": [],
            }
            sources.append(src)
        src["events"].extend(data["events"])
    seen = {s["meta"]["file"] for s in sources}
    pool = ([root] if root.is_file() else
            sorted(root.rglob("flightrec-*.json")))
    for p in pool:
        if p.name in seen or not p.name.startswith("flightrec-"):
            continue
        meta, events = _flightrec_events(p)
        if events or meta:
            sources.append({"meta": meta, "events": events})
    return sources


def _trace_ids(args: dict | None) -> list[str]:
    if not args:
        return []
    out = []
    if args.get("trace"):
        out.append(str(args["trace"]))
    for t in args.get("traces") or []:
        out.append(str(t))
    return out


def merge(sources: list[dict]) -> dict:
    """-> Chrome-trace JSON dict (``traceEvents`` + metadata)."""
    walls = [e["wall"] for s in sources for e in s["events"]
             if "wall" in e]
    t0 = min(walls) if walls else 0.0
    events: list[dict] = []
    # trace id -> [(wall, pid, tid, name)] for flow synthesis
    traces: dict[str, list[tuple]] = {}
    for i, src in enumerate(sources):
        meta = src["meta"]
        # synthetic pid per SOURCE: two hosts can share an OS
        # pid, and extracted dumps may have none — row identity must
        # come from the source, not the kernel
        pid = i + 1
        labels = dict(meta.get("labels") or {})
        if meta.get("role") and "role" not in labels:
            labels["role"] = meta["role"]
        name = format_labels(labels) if labels else (
            meta.get("file") or f"process {pid}")
        if meta.get("kind") == "flightrec" and meta.get("reason"):
            name += f" [flightrec:{meta['reason']}]"
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        tnames: dict[int, str] = {}
        for e in src["events"]:
            ts_us = round((e["wall"] - t0) * 1e6, 3)
            tid = int(e.get("tid") or 0)
            if e.get("kind") == "note":
                events.append({
                    "ph": "i", "name": f"note:{e.get('label', '')}",
                    "cat": "flightrec", "ts": ts_us, "pid": pid,
                    "tid": tid, "s": "p",
                    "args": {k: v for k, v in e.items()
                             if k not in ("kind", "wall", "tid")},
                })
                continue
            if e.get("tname"):
                tnames.setdefault(tid, e["tname"])
            args = e.get("args") or {}
            events.append({
                "ph": "X", "name": e.get("name", "?"),
                "cat": e.get("cat", "app"), "ts": ts_us,
                "dur": round(float(e.get("dur", 0.0)) * 1e6, 3),
                "pid": pid, "tid": tid, "args": args,
            })
            for t in _trace_ids(args):
                traces.setdefault(t, []).append(
                    (e["wall"], pid, tid, e.get("name", "?")))
        for tid, tname in tnames.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
    # flow events: one arrow chain per trace id, in wall order. The
    # s/t/f events land just inside their span's start, so the viewer
    # binds each to the enclosing slice
    flows = 0
    cross = 0
    for t, spans in sorted(traces.items()):
        if len(spans) < 2:
            continue
        spans.sort()
        flows += 1
        if len({pid for _, pid, _, _ in spans}) > 1:
            cross += 1
        fid = int(t[:15], 16) + 1 if all(
            c in "0123456789abcdef" for c in t[:15].lower()) \
            else abs(hash(t)) + 1
        for j, (wall, pid, tid, _name) in enumerate(spans):
            ph = "s" if j == 0 else ("f" if j == len(spans) - 1 else "t")
            ev = {"ph": ph, "name": "request", "cat": "flow", "id": fid,
                  "ts": round((wall - t0) * 1e6 + 0.5, 3),
                  "pid": pid, "tid": tid}
            if ph == "f":
                ev["bp"] = "e"  # bind to the enclosing slice
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "sources": [s["meta"] for s in sources],
            "trace_count": len(traces),
            "flow_count": flows,
            "cross_process_flows": cross,
        },
    }


def cross_process_requests(merged: dict,
                           router_span: str = "router_attempt",
                           replica_spans: tuple = ("replica_queue",
                                                   "device")) -> int:
    """How many requests have a flow spanning a router row AND a
    replica row in DIFFERENT processes — the propagation acceptance
    check, re-derived from the merged artifact itself."""
    per_trace: dict[str, set] = {}
    for e in merged["traceEvents"]:
        if e.get("ph") != "X":
            continue
        for t in _trace_ids(e.get("args")):
            per_trace.setdefault(t, set()).add((e["pid"], e["name"]))
    n = 0
    for spans in per_trace.values():
        router_pids = {p for p, name in spans if name == router_span}
        replica_pids = {p for p, name in spans
                        if name in replica_spans}
        if router_pids and replica_pids - router_pids:
            n += 1
    return n


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.obs.trace_merge",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root", help="a directory holding the fleet's "
                                "trace-spool-*.jsonl / flightrec-*.json")
    p.add_argument("-o", "--out", default=None,
                   help="merged Chrome-trace path (default: "
                        "<root>/trace_merged.json)")
    p.add_argument("--assert-spans", default=None, metavar="A,B,...",
                   help="fail unless every named span appears")
    p.add_argument("--assert-flow", action="store_true",
                   help="fail unless >= 1 request's flow links a "
                        "router_attempt span and a replica-side span "
                        "in different processes")
    args = p.parse_args(argv)

    sources = collect(args.root)
    if not sources:
        print(f"{args.root}: no spools or flight-recorder dumps found",
              file=sys.stderr)
        return 1
    merged = merge(sources)
    out = Path(args.out) if args.out else (
        Path(args.root) / "trace_merged.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(merged))

    xs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    notes = [e for e in merged["traceEvents"] if e.get("ph") == "i"]
    meta = merged["metadata"]
    print(f"{out}: {len(sources)} source(s), {len(xs)} span(s), "
          f"{len(notes)} note(s), {meta['trace_count']} traced "
          f"request(s), {meta['cross_process_flows']} cross-process "
          "flow(s)")
    for m in meta["sources"]:
        extra = f" [{m.get('reason')}]" if m.get("reason") else ""
        print(f"  - {m.get('kind', '?'):9s} {m.get('file')}{extra}")

    rc = 0
    if args.assert_spans:
        names = {e["name"] for e in xs}
        missing = [n for n in args.assert_spans.split(",")
                   if n.strip() and n.strip() not in names]
        if missing:
            print(f"FAIL: missing span(s): {', '.join(missing)}",
                  file=sys.stderr)
            rc = 1
    if args.assert_flow:
        n = cross_process_requests(merged)
        if n < 1:
            print("FAIL: no request's flow spans a router row and a "
                  "replica row (trace propagation broken?)",
                  file=sys.stderr)
            rc = 1
        else:
            print(f"flow check OK: {n} request(s) span router and "
                  "replica rows")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
