"""Fleet-wide observability: the trace id's hop and federated metrics.

The port's copy of two of the four pieces of
``deepvision_tpu/obs/distributed.py``:

**Trace-context propagation.** Every routed request gets a trace id at
the router (:func:`new_trace_id`), carried over the HTTP hop in the
``X-DVTPU-Trace`` header (:data:`TRACE_HEADER`). The router stamps its
``router_attempt`` span with it; the replica's HTTP front accepts the
header, and its engine has no spans to stamp yet.

**Federated metrics.** A parent (the fleet router) scrapes its
children's typed registry dumps (:meth:`Registry.dump`, histogram
reservoirs included) and :func:`render_federated` re-exports one
Prometheus surface: exact sums for counters, sample-merged reservoirs
for histogram quantiles, per-child series labelled ``{replica="r1"}``.
:func:`parse_prometheus` reads that text back.

The span spools and the crash flight recorder (the twin's other two
pieces, with ``--trace-spool`` and ``--obs-role``) come with the port's
distributed observability.
"""

from __future__ import annotations

import uuid

from deepvision_tpu_torch.obs.metrics import (
    Registry,
    histogram_export,
    render_family,
)

__all__ = [
    "TRACE_HEADER",
    "merge_histograms",
    "new_trace_id",
    "parse_prometheus",
    "render_federated",
]

# the HTTP hop carrier of the trace id (router -> replica)
TRACE_HEADER = "X-DVTPU-Trace"


def new_trace_id() -> str:
    """A fleet-unique request trace id (16 hex characters of a uuid4)."""
    return uuid.uuid4().hex[:16]


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
