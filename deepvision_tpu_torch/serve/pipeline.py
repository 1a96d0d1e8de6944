"""Pipeline serving: DAGs of served models and glue stages on one device.

The twin of ``deepvision_tpu/serve/pipeline.py``. Production traffic
composes the zoo (detect people, crop them, run pose on each crop), and a
client that composes it itself makes each hop a round trip that drags
tensors back to the host. A pipeline serves the whole DAG behind one
request:

- :class:`ModelStage`: the unit a ``ServedModel`` is made of, its
  forward with explicit input and output avals (``in_avals``,
  ``out_avals``: :class:`~deepvision_tpu_torch.export.TensorSpec`
  trees, the ``export.py`` seam).
- **Glue stages** (:func:`register_glue`): top-K selection
  (``top_k_boxes``), crop-from-boxes (``crop_resize``) and whole-image
  resize (``resize``), fixed-shape tensor code on the device
  (``ops/crop_resize.py``).
- :class:`PipelineSpec`: the declarative DAG, read from JSON
  (``serve --pipelines FILE``, :func:`load_pipeline_specs`, which needs
  nothing but ``json``).
- :class:`Pipeline`: the built DAG, validated before anything runs
  (acyclic, every edge's shape and dtype checked by shape propagation
  under ``FakeTensorMode``: no forward, on the card or the CPU), then
  served by the engine as a model: it has the ``ServedModel`` surface
  the engine reads (``input_shape``, ``buckets``, ``compile_for``,
  ``postprocess``), so its requests take the same queue, buckets,
  runner cache and admission.

Execution, per entry bucket (the engine pads every batch to one):

- **one program**: the eager DAG (each model stage's chunks, the glue,
  and the outputs packed into one byte buffer, ``models._pack``) is a
  fixed sequence of tensor operations, since ``K`` is a constant of the
  spec and raggedness lives in the ``valid`` mask. On the card
  :meth:`Pipeline.compile_for` captures it as one CUDA graph
  (``models.CudaGraphRunner``): the DAG never leaves the device and the
  only fetch is the final decode. On the CPU it runs eagerly and
  :attr:`Pipeline.stage_hook` fires after each stage.
- **fan-out**: the flattened ``B*K`` crops go through each model
  stage's own bucket ladder (:func:`chunk_plan`), each chunk padded with
  zero rows to its stage bucket, so that the chunk plan is a pure
  function of the entry bucket and ``engine.warm()`` covers everything;
  the runner cache is then frozen.
- **thresholds**: ``top_k_boxes``' ``class_id`` and ``min_score`` are
  fixed by the spec and are constants of the program, as the task
  heads' thresholds are.

Tenancy (``serve/tenancy.py``): a pipeline takes each model stage
(``ServedModel.as_stage``, its forward and weights edition) when it is
built or bound, and its graphs are captured over those editions. An
eviction of a stage tenant drops the DAG's graphs with the tenant's own,
and its restore recaptures them over the same stages. After a hot swap
of a stage model the DAG keeps serving the weights it was captured over,
as the JAX DAG does, until it is built again: its runner cache key
(:meth:`Pipeline.weights_fingerprint`) and its stages do not follow the
swap, and the old edition counts as ``retired_pinned``.

Stage timing (``stage:<node>`` spans): the JAX runner syncs the device
at each stage boundary while tracing; a graph replay has no boundary to
sync at. So every capture records a pair of timing events around each
stage (``torch.cuda.Event(enable_timing=True, external=True)``, event
record nodes of the graph), whether or not anything traces: the graph,
and so its answers, are the same with the tracer on or off. The runner
stamps the host clock just before each replay; after the replay's fetch,
:meth:`Pipeline.take_stage_stamps` reads the events' ``elapsed_time``
from the first stage's start and places each stage from that stamp, as
``(node, t0, t1)`` in ``perf_counter`` time inside the batch's ``device``
span, which the engine records. A build that refuses timing events in a
capture fails the capture, and one whose events cannot be read fails
the engine's warm-up (its first read); there is no untimed graph and no
fallback to the eager DAG. On the CPU the eager DAG stamps the host
clock around each stage.

The JAX package checks at ``bind`` that every stage bucket divides the
mesh's data axis; the port serves on one device and has no mesh, so
there is nothing to check yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from deepvision_tpu_torch.export import TensorSpec

__all__ = [
    "PipelineError", "PipelineNode", "PipelineOutput", "PipelineSpec",
    "Pipeline", "ModelStage", "register_glue", "chunk_plan",
    "load_pipeline_specs", "shape_eval",
]


class PipelineError(ValueError):
    """A pipeline spec that cannot be served: cyclic, with an edge whose
    shapes do not match, dangling references. Raised when the pipeline
    is built, before anything runs."""


# ------------------------------------------------------ shape propagation


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shape_eval(fn: Callable, avals: list, device) -> Any:
    """The output avals of ``fn(*inputs)`` for inputs of ``avals``
    (:class:`TensorSpec` trees: a spec or a dict of them) on ``device``,
    by running ``fn`` on fake tensors (``FakeTensorMode``): shapes and
    dtypes propagate, no kernel runs and no memory is touched. The port's
    ``jax.eval_shape``; the custom ops (``deepvision::lrn_forward``,
    ``::nms_sweep``) have fake implementations."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True), torch.inference_mode():
        fakes = [_tree_map(lambda s: torch.empty(tuple(s.shape),
                                                 dtype=s.dtype,
                                                 device=device), a)
                 for a in avals]
        out = fn(*fakes)
    return _tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), out)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


# ------------------------------------------------------------ ModelStage


@dataclasses.dataclass
class ModelStage:
    """The unit behind a ``ServedModel``: its device forward (a batch ->
    a dict of device tensors, the task head included), the per-example
    input geometry and explicit input and output avals, so that a DAG
    edge is checked before anything runs. A model served from a
    ``torch.export`` artifact (``models.from_exported``) is pinned to its
    exported batch (``pinned_buckets``) and takes its output avals from
    the program's metadata (``program_out_avals``, its output nodes'
    ``meta["val"]``, through the task ``head``), not from a forward."""

    name: str
    forward: Callable
    input_shape: tuple[int, ...]
    device: Any
    input_dtype: Any = np.float32
    pinned_buckets: tuple[int, ...] | None = None
    program_out_avals: tuple | None = None
    head: Callable | None = None
    # the ``tenancy.WeightsEdition`` that ``forward`` reads (None: an
    # artifact's program, or a stage without weights)
    edition: Any = None

    def in_avals(self, bucket: int) -> tuple[TensorSpec, ...]:
        return (TensorSpec((bucket, *self.input_shape),
                           _torch_dtype(self.input_dtype)),)

    def out_avals(self, bucket: int) -> dict:
        """The output avals at ``bucket``, by shape propagation alone."""
        if self.program_out_avals is not None:
            # the loaded program's own signature at this batch, through
            # the task head on fake tensors: the program never runs
            logits = [TensorSpec((bucket, *s.shape[1:]), s.dtype)
                      for s in self.program_out_avals]
            return shape_eval(self.head, logits, self.device)
        return shape_eval(self.forward, list(self.in_avals(bucket)),
                          self.device)

    def runner(self, bucket: int) -> Callable:
        """The forward that a pipeline calls on a chunk of ``bucket``
        rows. An artifact is shape-specialized: another bucket than the
        one it was exported at raises ``ValueError``."""
        if self.pinned_buckets and bucket not in self.pinned_buckets:
            raise ValueError(
                f"{self.name}: exported artifact is pinned to batch "
                f"{self.pinned_buckets}, cannot serve bucket {bucket}")
        return self.forward


# ---------------------------------------------------------- glue stages


_GLUE: dict[str, Callable] = {}


def register_glue(name: str):
    """Register a glue-stage builder: ``build(params, in_avals) -> (fn,
    batch_factor)``, where ``fn`` is fixed-shape tensor code over the
    input tensors (or dicts of them) and ``batch_factor`` the fan-out of
    the output batch axis over the FIRST input's (crop-from-boxes returns
    K rows an image; most glue returns 1)."""

    def deco(build: Callable) -> Callable:
        _GLUE[name] = build
        return build

    return deco


def _require_keys(aval, keys: tuple[str, ...], glue: str) -> None:
    if not isinstance(aval, dict) or any(k not in aval for k in keys):
        have = sorted(aval) if isinstance(aval, dict) else type(aval)
        raise PipelineError(
            f"glue {glue!r} needs a detect-style dict input with keys "
            f"{keys}, got {have}")


@register_glue("top_k_boxes")
def _build_top_k_boxes(params: dict, in_avals: list):
    """Detect output dict -> the K best (optionally class-filtered) boxes
    an image: ``{"boxes": (B,K,4), "scores": (B,K), "valid": (B,K)}``.
    Invalid and padded detections score 0 and come out ``valid=False``.
    Ties go to the lowest index, as ``jax.lax.top_k``'s do: a stable
    descending sort (``torch.topk`` promises no order among ties)."""
    k = int(params.get("k", 1))
    class_id = params.get("class_id")
    min_score = float(params.get("min_score", 0.0))
    (det,) = in_avals
    _require_keys(det, ("boxes", "scores", "valid"), "top_k_boxes")
    if k > det["scores"].shape[1]:
        raise PipelineError(
            f"top_k_boxes: k={k} exceeds the detector's max "
            f"{det['scores'].shape[1]} candidates")

    def fn(det):
        scores = det["scores"].float() * det["valid"].float()
        if class_id is not None:
            scores = scores * (det["classes"] == class_id).float()
        top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        boxes = torch.gather(det["boxes"], 1,
                             idx[..., None].expand(-1, -1, 4))
        return {"boxes": boxes, "scores": top, "valid": top > min_score}

    return fn, 1


@register_glue("crop_resize")
def _build_crop_resize(params: dict, in_avals: list):
    """(images, selected boxes) -> flattened crops, one a box:
    ``{"crops": (B*K, S, S, C), "valid": (B*K,)}``: the fan-out stage.
    K is the selector's box count, a constant of the spec; the flattened
    rows are what the next stage's bucket ladder chunks."""
    from deepvision_tpu_torch.ops.crop_resize import crop_and_resize

    size = int(params["size"])
    _, sel = in_avals
    _require_keys(sel, ("boxes", "valid"), "crop_resize")
    k = int(sel["boxes"].shape[1])

    def fn(images, sel):
        crops = crop_and_resize(images, sel["boxes"], size)
        b = crops.shape[0]
        return {"crops": crops.reshape(b * k, size, size, crops.shape[-1]),
                "valid": sel["valid"].reshape(b * k)}

    return fn, k


@register_glue("resize")
def _build_resize(params: dict, in_avals: list):
    """Whole-image bilinear resize to a stage's input geometry (antialiased
    when it shrinks, as ``jax.image.resize``)."""
    from deepvision_tpu_torch.ops.crop_resize import resize_bilinear

    size = int(params["size"])

    def fn(images):
        return resize_bilinear(images, size)

    return fn, 1


# ----------------------------------------------------------------- spec


@dataclasses.dataclass
class PipelineNode:
    """One DAG node: a model stage (``model=<served name>``) or a glue
    stage (``glue=<registered name>`` and ``params``). ``inputs`` are the
    edges: ``"input"`` (the request tensor), another node's name, or
    ``"node.key"`` to select one output of a dict-valued stage.
    ``buckets`` overrides this stage's chunking ladder."""

    name: str
    model: str | None = None
    glue: str | None = None
    inputs: tuple[str, ...] = ("input",)
    params: dict = dataclasses.field(default_factory=dict)
    buckets: tuple[int, ...] | None = None


@dataclasses.dataclass
class PipelineOutput:
    """One returned node. ``mask`` names a boolean plane (``node.key``)
    that gates fan-out rows at decode time: ``crop.valid`` keeps only the
    real person crops of each image's K slots."""

    node: str
    mask: str | None = None


@dataclasses.dataclass
class PipelineSpec:
    """Declarative pipeline: name -> nodes and edges (and optionally the
    entry geometry and the entry bucket ladder). ``input_shape`` may be
    left out when exactly one MODEL node consumes ``"input"`` directly:
    its geometry is the pipeline's."""

    name: str
    nodes: list[PipelineNode]
    outputs: list[PipelineOutput]
    input_shape: tuple[int, ...] | None = None
    input_dtype: str = "float32"
    buckets: tuple[int, ...] | None = None

    @classmethod
    def from_json(cls, d: dict) -> "PipelineSpec":
        if not isinstance(d, dict) or "name" not in d or "nodes" not in d:
            raise PipelineError(
                f"pipeline spec needs 'name' and 'nodes', got {d!r}")
        nodes = [PipelineNode(
            name=n["name"], model=n.get("model"), glue=n.get("glue"),
            inputs=tuple(n.get("inputs", ("input",))),
            params=dict(n.get("params", {})),
            buckets=tuple(n["buckets"]) if n.get("buckets") else None,
        ) for n in d["nodes"]]
        outs = []
        for o in d.get("outputs", [nodes[-1].name if nodes else []]):
            if isinstance(o, str):
                outs.append(PipelineOutput(node=o))
            else:
                outs.append(PipelineOutput(node=o["node"],
                                           mask=o.get("mask")))
        inp = d.get("input", {})
        return cls(
            name=d["name"], nodes=nodes, outputs=outs,
            input_shape=(tuple(inp["shape"]) if inp.get("shape")
                         else None),
            input_dtype=inp.get("dtype", "float32"),
            buckets=tuple(d["buckets"]) if d.get("buckets") else None,
        )


def load_pipeline_specs(path: str | Path) -> list[PipelineSpec]:
    """Parse a ``--pipelines`` JSON file: one spec object, a list of
    them, or ``{"pipelines": [...]}``. Plain ``json``: a fleet router
    reads the pipeline NAMES with it and builds nothing."""
    body = json.loads(Path(path).read_text())
    if isinstance(body, dict) and "pipelines" in body:
        body = body["pipelines"]
    if isinstance(body, dict):
        body = [body]
    return [PipelineSpec.from_json(d) for d in body]


def chunk_plan(n: int, ladder: tuple[int, ...]) -> list[tuple[int, int, int]]:
    """Chunk ``n`` rows through a bucket ladder: ``[(start, rows,
    bucket), ...]``. Full max-ladder chunks first, then one padded chunk
    at the smallest bucket that fits the remainder: the policy the
    engine's front door applies to a backlog."""
    if n <= 0 or not ladder:
        raise PipelineError(f"chunk_plan: n={n} ladder={ladder}")
    plan, i = [], 0
    while i < n:
        rem = n - i
        bucket = max(ladder)
        for b in ladder:
            if b >= rem:
                bucket = b
                break
        rows = min(rem, bucket)
        plan.append((i, rows, bucket))
        i += rows
    return plan


# ------------------------------------------------------------- Pipeline


_INPUT = "input"
_KEY_SEP = "/"  # a dict output's key in the packed outputs: "node/key"
_MASK = "__mask"


class Pipeline:
    """A built, validated DAG of served models and glue, served by the
    engine through the ``ServedModel`` surface. Construction validates
    the spec end to end (structure, acyclicity, every edge's shapes and
    dtypes by shape propagation: nothing runs); :meth:`bind` (the engine
    calls it when it takes the pipeline) attaches the engine's ladder;
    :meth:`compile_for` builds one entry bucket's runner: on the card
    one CUDA graph of the whole DAG, on the CPU the eager DAG."""

    is_pipeline = True
    task = "pipeline"
    exported = False

    def __init__(self, spec: PipelineSpec, models: dict,
                 *, default_buckets: tuple[int, ...] = (1, 4, 16, 64)):
        self.spec = spec
        self.name = spec.name
        self._models = dict(models)
        self._default_buckets = tuple(default_buckets)
        self._cache = None  # bound by the engine (bind())
        self.requests_served = 0
        self.last_chunk_plans: dict[str, list] = {}
        # test and chaos instrumentation: called on the dispatcher thread
        # after each stage of an eager run (the CPU's; on the card the
        # stages run inside one graph replay, so it fires only while the
        # graph is built)
        self.stage_hook: Callable[[str], None] | None = None
        # the last run's stage stamps: the CPU's host stamps, or the last
        # graph replay's host stamp and stage events
        self._stage_stamps: list[tuple[str, float, float]] = []
        self._last_replay: tuple | None = None
        self._programs: dict[int, Any] = {}  # entry bucket -> eager DAG
        self._walks: dict[int, dict] = {}  # entry bucket -> its walk
        self._validate_structure()
        self._order = self._toposort()
        self._stages = self._build_stages()
        self.device = self._device()
        # per-edge shape and dtype validation happens HERE, before
        # anything runs (the entry bucket scales linearly, so one bucket
        # proves the family)
        self._walk_avals(self._canonical_bucket())

    # -- ServedModel surface ----------------------------------------------
    @property
    def buckets(self) -> tuple[int, ...]:
        return tuple(self.spec.buckets or self._default_buckets)

    @property
    def input_shape(self) -> tuple[int, ...]:
        shape, _ = self._entry_geometry()
        return shape

    @property
    def input_dtype(self):
        _, dtype = self._entry_geometry()
        return dtype

    @property
    def dtype_str(self) -> str:
        return str(np.dtype(self.input_dtype))

    def weights_fingerprint(self) -> str:
        """The runner cache's key part: a digest of the spec and of the
        weights fingerprint of every model stage as the DAG took it, so
        that a runner built over one generation of weights is never found
        for another (and a stage model's hot swap leaves the DAG's key
        and graphs as they are)."""
        parts = [json.dumps(dataclasses.asdict(self.spec), sort_keys=True,
                            default=str)]
        for node in self._order:
            if node.model:
                edition = self._stages[node.name]["stage"].edition
                if edition is not None:
                    fp = edition.fingerprint
                else:  # an artifact: its program's digest
                    fp = getattr(self._models[node.model],
                                 "weights_fingerprint", lambda: "static")()
                parts.append(f"{node.model}:{fp}")
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()

    def stage_models(self) -> dict[str, Any]:
        """The served models that the DAG's model nodes name, by name
        (the engine's plain path shares them): the tenants whose weights
        its graphs read."""
        return {n.model: self._models[n.model]
                for n in self._order if n.model}

    # -- validation ------------------------------------------------------
    def _node_map(self) -> dict[str, PipelineNode]:
        return {n.name: n for n in self.spec.nodes}

    def _validate_structure(self) -> None:
        spec = self.spec
        if not spec.nodes:
            raise PipelineError(f"pipeline {spec.name!r} has no nodes")
        names = [n.name for n in spec.nodes]
        if len(set(names)) != len(names):
            raise PipelineError(
                f"pipeline {spec.name!r}: duplicate node names {names}")
        if _INPUT in names:
            raise PipelineError(
                f"pipeline {spec.name!r}: {_INPUT!r} is the reserved "
                "entry edge, not a node name")
        known = set(names)
        for n in spec.nodes:
            if bool(n.model) == bool(n.glue):
                raise PipelineError(
                    f"node {n.name!r}: exactly one of model= / glue= "
                    "must be set")
            if n.model and n.model not in self._models:
                raise PipelineError(
                    f"node {n.name!r}: unknown model {n.model!r}; "
                    f"serving {sorted(self._models)}")
            if n.glue and n.glue not in _GLUE:
                raise PipelineError(
                    f"node {n.name!r}: unknown glue {n.glue!r}; "
                    f"registered: {sorted(_GLUE)}")
            if n.model and len(n.inputs) != 1:
                raise PipelineError(
                    f"model node {n.name!r} takes exactly one input "
                    f"edge, got {n.inputs}")
            for ref in n.inputs:
                src = ref.split(".", 1)[0]
                if src != _INPUT and src not in known:
                    raise PipelineError(
                        f"node {n.name!r}: input {ref!r} references "
                        f"unknown node {src!r}")
        if not spec.outputs:
            raise PipelineError(f"pipeline {spec.name!r} has no outputs")
        for o in spec.outputs:
            if o.node not in known:
                raise PipelineError(
                    f"output references unknown node {o.node!r}")
            if o.mask and o.mask.split(".", 1)[0] not in known:
                raise PipelineError(
                    f"output mask {o.mask!r} references an unknown node")

    def _toposort(self) -> list[PipelineNode]:
        nodes = self._node_map()
        deps = {n.name: {ref.split(".", 1)[0] for ref in n.inputs
                         if ref.split(".", 1)[0] != _INPUT}
                for n in self.spec.nodes}
        order, ready = [], sorted(n for n, d in deps.items() if not d)
        deps = {n: set(d) for n, d in deps.items() if d}
        while ready:
            name = ready.pop(0)
            order.append(nodes[name])
            for other in sorted(deps):
                deps[other].discard(name)
                if not deps[other]:
                    del deps[other]
                    ready.append(other)
        if deps:
            raise PipelineError(
                f"pipeline {self.spec.name!r} has a cycle through "
                f"{sorted(deps)}")
        return order

    def _device(self) -> torch.device:
        """The one device of every stage model (the CPU for a DAG of glue
        alone)."""
        devices = {str(self._models[n.model].device)
                   for n in self._order if n.model}
        if len(devices) > 1:
            raise PipelineError(
                f"pipeline {self.name!r}: its models live on "
                f"{sorted(devices)}; a DAG runs on one device")
        return torch.device(devices.pop() if devices else "cpu")

    def _entry_geometry(self) -> tuple[tuple[int, ...], Any]:
        if self.spec.input_shape is not None:
            return tuple(self.spec.input_shape), np.dtype(
                self.spec.input_dtype)
        consumers = [n for n in self.spec.nodes
                     if _INPUT in n.inputs and n.model]
        if len(consumers) == 1:
            served = self._models[consumers[0].model]
            return tuple(served.input_shape), np.dtype(served.input_dtype)
        raise PipelineError(
            f"pipeline {self.spec.name!r}: give an explicit input "
            "shape; the entry geometry is only inferable when exactly "
            "one model node consumes 'input' directly")

    def _canonical_bucket(self) -> int:
        return min(self.buckets)

    def _build_stages(self) -> dict[str, dict]:
        """node name -> {"kind", "served"/"build", "ladder"} and a model
        node's ``stage`` (``as_stage()``, taken here: the forward and
        weights edition that the DAG's graphs are captured over, kept
        through a later hot swap of the model)."""
        stages = {}
        for node in self._order:
            if node.model:
                served = self._models[node.model]
                ladder = tuple(node.buckets or served.buckets
                               or self._default_buckets)
                stages[node.name] = {"kind": "model", "served": served,
                                     "stage": served.as_stage(),
                                     "ladder": ladder}
            else:
                stages[node.name] = {"kind": "glue",
                                     "build": _GLUE[node.glue]}
        return stages

    def _select_aval(self, env: dict, ref: str, node: str):
        src, _, key = ref.partition(".")
        val = env[src]
        if key:
            if not isinstance(val, dict) or key not in val:
                raise PipelineError(
                    f"node {node!r}: input {ref!r} selects key "
                    f"{key!r} but {src!r} produces "
                    f"{sorted(val) if isinstance(val, dict) else type(val)}")
            return val[key]
        return val

    def _walk_avals(self, bucket: int) -> dict:
        """Shape-propagate the whole DAG at an entry bucket: every edge's
        shape and dtype checked, each node's output avals and fan-out
        factor, each glue node's function. Nothing runs (fake tensors
        only): the validator that the ``out_avals`` seam exists for. A
        walk is kept by entry bucket: at full width it takes seconds of
        host time (the stages' ladders, which ``bind`` may change, play
        no part in it)."""
        walk = self._walks.get(bucket)
        if walk is None:
            walk = self._walks[bucket] = self._walk(bucket)
        self._factors = walk["factors"]
        return walk

    def _walk(self, bucket: int) -> dict:
        shape, dtype = self._entry_geometry()
        env = {_INPUT: TensorSpec((bucket, *shape), _torch_dtype(dtype))}
        factors = {_INPUT: 1}
        glue_fns: dict[str, Callable] = {}
        for node in self._order:
            ins = [self._select_aval(env, ref, node.name)
                   for ref in node.inputs]
            info = self._stages[node.name]
            if info["kind"] == "model":
                stage = info["stage"]
                (aval,) = ins
                if not isinstance(aval, TensorSpec):
                    raise PipelineError(
                        f"model node {node.name!r} needs an array "
                        f"input, got {type(aval)} from "
                        f"{node.inputs[0]!r}")
                if tuple(aval.shape[1:]) != tuple(stage.input_shape) \
                        or aval.dtype != _torch_dtype(stage.input_dtype):
                    raise PipelineError(
                        f"aval mismatch on edge {node.inputs[0]!r} -> "
                        f"{node.name!r}: stage expects per-example "
                        f"{tuple(stage.input_shape)} "
                        f"{np.dtype(stage.input_dtype)}, got "
                        f"{tuple(aval.shape[1:])} {aval.dtype}")
                env[node.name] = stage.out_avals(int(aval.shape[0]))
                factors[node.name] = factors[
                    node.inputs[0].split(".", 1)[0]]
            else:
                fn, batch_factor = info["build"](node.params, ins)
                glue_fns[node.name] = fn
                try:
                    env[node.name] = shape_eval(fn, ins, self.device)
                except (TypeError, ValueError, RuntimeError,
                        IndexError) as e:
                    raise PipelineError(
                        f"glue node {node.name!r} rejects its input "
                        f"avals: {e}") from e
                factors[node.name] = factors[
                    node.inputs[0].split(".", 1)[0]] * batch_factor
        for o in self.spec.outputs:
            if o.mask:
                mask_aval = self._select_aval(env, o.mask, o.node)
                src = o.mask.split(".", 1)[0]
                if factors[src] != factors[o.node]:
                    raise PipelineError(
                        f"output {o.node!r}: mask {o.mask!r} has "
                        f"fan-out {factors[src]}, output has "
                        f"{factors[o.node]}")
                if not isinstance(mask_aval, TensorSpec):
                    raise PipelineError(
                        f"output mask {o.mask!r} must be an array")
        return {"env": env, "factors": factors, "glue_fns": glue_fns}

    # -- binding / building ------------------------------------------------
    def bind(self, cache, default_buckets: tuple[int, ...] | None = None
             ) -> None:
        """Attach the engine's runner cache and its bucket ladder (the
        default of the entry and of every stage without its own), called
        when the engine takes the pipeline."""
        if default_buckets:
            self._default_buckets = tuple(default_buckets)
            self._stages = self._build_stages()
        self._cache = cache

    def program(self, bucket: int):
        """The whole DAG at entry bucket ``bucket`` as one served unit
        (a ``ServedModel`` whose forward is the eager DAG, returning every
        output as a flat dict of tensors with the entry batch on axis 0):
        what :meth:`compile_for` captures and what :meth:`run` runs.
        Records each model stage's chunk plan in ``last_chunk_plans``."""
        from deepvision_tpu_torch.serve.models import ServedModel

        walk = self._walk_avals(bucket)
        env_avals, glue_fns = walk["env"], walk["glue_fns"]
        executors: list[tuple[PipelineNode, Callable]] = []
        forwards = []
        for node in self._order:
            info = self._stages[node.name]
            if info["kind"] == "model":
                rows = int(self._select_aval(
                    env_avals, node.inputs[0], node.name).shape[0])
                execute, fwd = self._model_executor(node, info, rows)
                forwards.append(fwd)
                executors.append((node, execute))
            else:
                executors.append((node, glue_fns[node.name]))
        forward = self._dag(executors)
        # the graph reads the stages' weights at their addresses: the
        # program holds every stage's forward, and with it its module,
        # and names their editions (``ServedModel.pinned_editions``)
        forward.stage_forwards = tuple(forwards)
        forward.stage_editions = tuple(
            info["stage"].edition for info in self._stages.values()
            if info["kind"] == "model" and info["stage"].edition is not None)
        return ServedModel(
            name=f"{self.name}@{bucket}", task=self.task, module=None,
            input_shape=self.input_shape, postprocess=self.postprocess,
            device=self.device, forward=forward,
            input_dtype=self.input_dtype)

    def compile_for(self, bucket: int, pool=None):
        """The runner of entry bucket ``bucket``, ``host batch -> host
        outputs``: on the card one CUDA graph of the whole DAG
        (``models.CudaGraphRunner``: an eager run of the DAG on a side
        stream, then the capture into the graph memory pool ``pool``; a
        capture that fails raises, and the card never falls back to the
        eager DAG), on the CPU the eager DAG. The engine's ``warm()``
        calls it for every entry bucket."""
        return self.program(bucket).compile_for(bucket, pool)

    def run(self, batch: np.ndarray) -> dict[str, np.ndarray]:
        """A host batch of an entry bucket's rows through the eager DAG on
        the pipeline's device, its outputs fetched with one copy: the
        flat dict that :meth:`postprocess` reads, and what a graph's
        replay is held to."""
        bucket = len(batch)
        if bucket not in self._programs:
            self._programs[bucket] = self.program(bucket)
        return self._programs[bucket].run(batch)

    def _model_executor(self, node: PipelineNode, info: dict, rows: int):
        """Chunk ``rows`` inter-stage rows through this stage's own
        ladder, each chunk padded with zero rows to its bucket. -> (the
        stage's executor, its forward)."""
        stage = info["stage"]
        plan = chunk_plan(rows, info["ladder"])
        runners = {b: stage.runner(b) for _, _, b in plan}
        self.last_chunk_plans[node.name] = plan

        def run_model_stage(x: torch.Tensor):
            outs = []
            for start, k, b in plan:
                xa = x[start:start + k] if (start or k < rows) else x
                if k < b:
                    xa = torch.cat(
                        [xa, xa.new_zeros((b - k, *xa.shape[1:]))])
                o = runners[b](xa)
                if k < b:
                    o = _tree_map(lambda a, k=k: a[:k], o)
                outs.append(o)
            if len(outs) == 1:
                return outs[0]
            if isinstance(outs[0], dict):
                return {key: torch.cat([o[key] for o in outs])
                        for key in outs[0]}
            return torch.cat(outs)

        return run_model_stage, stage.forward

    def _dag(self, executors) -> Callable:
        """The eager DAG: stage outputs feed stage inputs as device
        tensors; the result is every declared output, folded to the entry
        batch (fan-out rows ``(B*F, ...)`` -> ``(B, F, ...)``) and
        flattened to one level (``node``, ``node/key``, ``node__mask``)
        for ``models._pack``. Under a CUDA graph's capture each stage is
        bracketed by a pair of timing events, which the graph replays; on
        the CPU each stage's host stamps are kept for
        :meth:`take_stage_stamps`. The forward's ``after_replay(t)`` (a
        ``CudaGraphRunner`` calls it after each replay, with the host
        stamp taken just before it) keeps the stamp and the captured
        events, which nothing reads until a span wants them."""
        spec = self.spec
        factors = self._factors
        select = self._select_value
        captured: list[tuple[str, Any, Any]] = []

        def run_pipeline(x: torch.Tensor) -> dict[str, torch.Tensor]:
            capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
            stamps: list[tuple[str, float, float]] = []
            if capturing:
                captured.clear()
            env = {_INPUT: x}
            for node, execute in executors:
                ins = [select(env, ref) for ref in node.inputs]
                if capturing:
                    start = torch.cuda.Event(enable_timing=True,
                                             external=True)
                    start.record()
                t0 = time.perf_counter()
                env[node.name] = execute(*ins)
                if capturing:
                    end = torch.cuda.Event(enable_timing=True,
                                           external=True)
                    end.record()
                    captured.append((node.name, start, end))
                elif not x.is_cuda:
                    stamps.append((node.name, t0, time.perf_counter()))
                if self.stage_hook is not None:
                    self.stage_hook(node.name)
            if not x.is_cuda:
                self._stage_stamps = stamps
            flat: dict[str, torch.Tensor] = {}
            for o in spec.outputs:
                val = self._fold_fanout(env[o.node], factors[o.node])
                if isinstance(val, dict):
                    for key, t in val.items():
                        flat[f"{o.node}{_KEY_SEP}{key}"] = t
                else:
                    flat[o.node] = val
                if o.mask:
                    flat[o.node + _MASK] = self._fold_fanout(
                        select(env, o.mask),
                        factors[o.mask.split(".", 1)[0]])
            return flat

        def after_replay(t_replay: float) -> None:
            self._last_replay = (t_replay, captured)

        run_pipeline.after_replay = after_replay
        return run_pipeline

    @staticmethod
    def _select_value(env: dict, ref: str):
        src, _, key = ref.partition(".")
        return env[src][key] if key else env[src]

    @staticmethod
    def _fold_fanout(val, factor: int):
        """(B*F, ...) fan-out leaves -> (B, F, ...), so that the decode
        indexes by original request."""
        if factor == 1:
            return val
        return _tree_map(lambda a: a.reshape(a.shape[0] // factor, factor,
                                             *a.shape[1:]), val)

    def take_stage_stamps(self) -> list[tuple[str, float, float]]:
        """The stages of the last run as ``(node, t0, t1)`` in
        ``perf_counter`` time, in DAG order; consumed (and cleared) by the
        engine, which records them as ``stage:<node>`` spans. After a
        graph replay each stage is placed from the host stamp taken just
        before the replay, by its events' ``elapsed_time`` from the first
        stage's start: the events have completed once the runner fetched
        the outputs, so the read waits for nothing. The card cannot start
        a graph before its launch, so the placed stages lie inside the
        batch's ``device`` span, at most the graph's launch latency early.
        On the CPU they are the eager stages' host stamps."""
        last, self._last_replay = self._last_replay, None
        if last is not None:
            t_replay, events = last
            if not events:
                return []
            first = events[0][1]
            return [(name, t_replay + first.elapsed_time(s) / 1e3,
                     t_replay + first.elapsed_time(e) / 1e3)
                    for name, s, e in events]
        stamps, self._stage_stamps = self._stage_stamps, []
        return stamps

    def record_served(self, rows: int) -> None:
        self.requests_served += rows

    # -- decode ----------------------------------------------------------
    def postprocess(self, host: dict, i: int) -> dict:
        """Row ``i`` of the fetched DAG outputs (the flat dict of a
        runner or :meth:`run`) -> JSON-able dict, one entry a declared
        output node. Model-stage outputs decode with that stage's own
        task postprocess; fan-out outputs decode as a list over the K
        slots, masked rows dropped."""
        nested: dict[str, Any] = {}
        for key, val in host.items():
            node, sep, sub = key.partition(_KEY_SEP)
            if sep:
                nested.setdefault(node, {})[sub] = val
            else:
                nested[node] = val
        result = {}
        nodes = self._node_map()
        for o in self.spec.outputs:
            sub = nested[o.node]
            served = (self._stages[o.node]["served"]
                      if nodes[o.node].model else None)
            factor = self._factors[o.node]
            if factor == 1:
                result[o.node] = (served.postprocess(sub, i)
                                  if served else _row_jsonable(sub, i))
                continue
            mask = nested.get(o.node + _MASK)
            sub_i = _tree_map(lambda a: a[i], sub)
            rows = []
            for j in range(factor):
                if mask is not None and not bool(np.asarray(mask[i][j])):
                    continue
                rows.append(served.postprocess(sub_i, j)
                            if served else _row_jsonable(sub_i, j))
            result[o.node] = rows
        return result


def _row_jsonable(val, i: int):
    if isinstance(val, dict):
        return {k: _row_jsonable(v, i) for k, v in val.items()}
    return np.asarray(val[i]).tolist()
