"""Served models: one load + post-process path for the engine and the CLI.

The twin of ``deepvision_tpu/serve/models.py`` for the classify task
(``lenet5``, the AlexNets, ``vgg16`` and ``vgg19``, Inception V1 in both
variants and Inception V3, ``resnet34``, ``resnet50``, ``resnet152``,
``resnet50v2``, ``mobilenet1``, ``shufflenet1`` and ``darknet53``; a
model with aux heads returns only its main logits in eval, as the JAX
forward keeps only them), the detect task of ``yolov3`` and ``centernet``, and
the pose task of ``hourglass104``. ``yolov3``'s raw grids go through
``ops/yolo_postprocess`` (decode, then batched greedy NMS with
``score_thresh`` and ``iou_thresh``, the sweep on the CUDA kernel for a
batch on the card); ``centernet``'s last stack goes through the peak
decode (``ops/centernet_decode``, its 100 best peaks, valid above
``score_thresh``). Each detect answer keeps the valid rows as
normalized corner boxes ``(x1, y1, x2, y2)`` with their scores and
classes. A pose answer is each joint's ``(x, y, conf)`` from the last
stack's heatmaps (``ops/heatmap.decode_heatmaps``), x and y normalized.
The gan task serves the DCGAN generator (``dcgan`` or
``dcgan_generator``): the input is the noise ``z`` of ``(noise_dim,)``,
the answer the generated ``(28, 28, 1)`` image in [-1, 1]. A model
served from a GAN checkpoint takes the generator's weights out of it
(``CheckpointManager.restore_model(net="generator")``). Each served model
names its input's pixel convention (``scale``, the JAX
``input_scale``: ``"tanh"`` for every task but classify). A model
is built without its training config's ``model_kwargs``, as the JAX
``load_served`` builds it: a checkpoint trained under ``resnet50``'s
``s2d_stem`` has the same state dict and serves on the plain stem, whose
float32 numbers are the same, and ``resnet152`` serves without the remat
it trains under. A :class:`ServedModel` holds the module on its device,
the per-example input geometry, and a host-side ``postprocess`` that
turns batch row ``i`` into a JSON-able result. The task head (softmax
and top-k) runs on the device inside :meth:`ServedModel.run`, which
moves a batch to the device with one copy and brings every output back
with one copy.

The engine's path is :meth:`ServedModel.compile_for`, the twin of the
JAX ``compile_for``: one runner a bucket, ``host batch -> host
outputs``. On the card it is a :class:`CudaGraphRunner`, one captured
``torch.cuda.CUDAGraph`` of the forward, the task head and the packing
of every output into one byte buffer, replayed between one copy in and
one copy out; on the CPU an :class:`EagerRunner` over :meth:`run`. A
served model is also a stage of a serving DAG (``serve/pipeline.py``):
:meth:`ServedModel.as_stage`, with its input and output avals
(:meth:`ServedModel.out_avals`, by shape propagation; an artifact's from
its program's metadata).

Tenancy (``serve/tenancy.py``): a served model with weights carries a
``WeightsEdition`` (its module, the weights' fingerprint and bytes), made
with it. An eviction moves the module's weights to host and back in
place, so the module and its parameters keep their identity; every
runner names the editions it was captured over (``runner.editions``), so
that an eviction can drop it first. A hot swap never writes into the
live parameters: :meth:`ServedModel.shadow` builds a new module and a new
forward (``make_forward``) with the new weights and a new edition, which
:meth:`ServedModel.flip_to` makes the model's own once its runners are
captured. Captures take :data:`capture_lock`, so that a swap's captures
and the dispatcher's recaptures take turns.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.device import resolve_device
from deepvision_tpu_torch.models import create_model
from deepvision_tpu_torch.ops import captured_launches, credit_launches
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.configs import get_config

__all__ = ["ServedModel", "CudaGraphRunner", "EagerRunner", "load_served",
           "from_exported", "restore_state", "model_geometry", "task_for",
           "input_scale", "capture_lock"]

# one CUDA graph capture at a time in the process: ``torch.cuda.graph``
# synchronizes the device and empties the allocator's cache, which must
# not happen inside another thread's capture (a hot swap captures while
# the dispatcher may recapture an evicted tenant)
capture_lock = threading.Lock()

# the served task of each model that is not a classifier ("gan" serves
# the DCGAN generator: the input is the noise z, the output an image)
_TASKS = {"yolov3": "detect", "centernet": "detect", "hourglass104": "pose",
          "dcgan": "gan", "dcgan_generator": "gan"}


def task_for(name: str) -> str:
    """The serving task of registry model ``name``."""
    return _TASKS.get(name, "classify")


def input_scale(name: str) -> str:
    """The pixel convention of registry model ``name``'s inputs, as its
    training pipeline feeds them: ``"tanh"`` ([-1, 1]) for every task but
    classify, ``"unit"`` ([0, 1]) for a grayscale classifier
    (``lenet5``), ``"torch"`` for a config with ``augment: "pt"``, else
    ``"imagenet"``."""
    if task_for(name) != "classify":
        return "tanh"
    cfg = get_config(name)
    if cfg.get("channels", 3) == 1:
        return "unit"
    return "torch" if cfg.get("augment", "tf") == "pt" else "imagenet"


@dataclasses.dataclass
class ServedModel:
    """One model the engine can serve. ``forward`` maps a device batch
    to a dict of device tensors with the batch on axis 0;
    ``postprocess`` turns row ``i`` of the fetched (numpy) outputs into
    a JSON-able dict. ``buckets`` overrides the engine's ladder (an
    artifact is pinned to the batch it was exported at); ``exported``
    marks a model whose forward is a loaded ``torch.export`` program
    (:func:`from_exported`). ``make_forward(module)`` builds ``forward``
    over a module of the same architecture: what a hot swap's shadow
    model runs. ``edition``: the weights' ``tenancy.WeightsEdition``,
    made with the model for every model with a module of its own (not an
    artifact, whose weights live in its program)."""

    name: str
    task: str
    module: nn.Module
    input_shape: tuple[int, ...]
    postprocess: Callable[[dict, int], dict]
    device: torch.device
    forward: Callable[[torch.Tensor], dict]
    input_dtype: Any = np.float32
    scale: str = "imagenet"
    buckets: tuple[int, ...] | None = None
    exported: bool = False
    # a model served from an artifact: its program's output avals (the
    # output nodes' ``meta["val"]``) and the task head that ``forward``
    # runs on the program's outputs (:func:`from_exported`)
    program_out_avals: tuple | None = None
    head: Callable | None = None
    make_forward: Callable[[nn.Module], Callable] | None = dataclasses.field(
        default=None, repr=False, compare=False)
    edition: Any = dataclasses.field(default=None, repr=False, compare=False)
    _fingerprint: str | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.edition is None and self.module is not None \
                and not self.exported:
            from deepvision_tpu_torch.serve.tenancy import WeightsEdition

            self.edition = WeightsEdition(self.module,
                                          fingerprint=self._fingerprint)

    @property
    def dtype_str(self) -> str:
        return str(np.dtype(self.input_dtype))

    def weights_fingerprint(self) -> str:
        """The digest of the weights (``resilience/sentinel``'s
        fingerprint of the module's JAX-layout tree), taken once: the
        runner cache's key holds it, so that a runner built for one
        generation of weights can never be found for another. A model
        with an edition has its edition's."""
        if self.edition is not None:
            return self.edition.fingerprint
        if self._fingerprint is None:
            from deepvision_tpu_torch.resilience.sentinel import (
                state_tree,
                tree_fingerprint,
            )

            self._fingerprint = tree_fingerprint(
                state_tree(self.module))["digest"]
        return self._fingerprint

    def as_stage(self):
        """The unit a serving DAG composes (``pipeline.ModelStage``): the
        forward with explicit input and output avals and an artifact's
        pinned batch."""
        from deepvision_tpu_torch.serve.pipeline import ModelStage

        return ModelStage(
            name=self.name, forward=self.forward,
            input_shape=self.input_shape, device=self.device,
            input_dtype=self.input_dtype, pinned_buckets=self.buckets,
            program_out_avals=self.program_out_avals, head=self.head,
            edition=self.edition)

    def pinned_editions(self) -> tuple:
        """The editions a runner of this model is captured over: its own,
        and a DAG program's stage editions (``Pipeline.program``)."""
        own = (self.edition,) if self.edition is not None else ()
        return own + tuple(getattr(self.forward, "stage_editions", ()))

    def shadow(self, variables, fingerprint: str | None = None
               ) -> "ServedModel":
        """This model with new weights ``variables`` (a tree in the JAX
        layout, ``resilience/sentinel.state_tree``'s) as a new module, a
        new forward and a new resident edition on the model's device: a
        hot swap's stand-in, whose runners are captured before the flip.
        The live module is copied, never written."""
        if self.make_forward is None or self.edition is None:
            raise ValueError(f"{self.name!r} has no forward builder; it "
                             "cannot take new weights")
        from deepvision_tpu_torch.convert.from_flax import (
            module_state_from_flax,
        )
        from deepvision_tpu_torch.serve.tenancy import (
            WeightsEdition,
            tree_nbytes,
        )

        module = copy.deepcopy(self.module)
        module.load_state_dict(module_state_from_flax(module, variables))
        module.to(self.device)
        module.eval()
        module.requires_grad_(False)
        edition = WeightsEdition(module, fingerprint,
                                 tree_nbytes(variables), resident=True)
        return dataclasses.replace(
            self, module=module, forward=self.make_forward(module),
            edition=edition, _fingerprint=edition.fingerprint)

    def flip_to(self, shadow: "ServedModel") -> None:
        """Serve ``shadow``'s module, forward and edition from now on
        (a hot swap's flip, under the residency lock)."""
        self.module = shadow.module
        self.forward = shadow.forward
        self.edition = shadow.edition
        self._fingerprint = shadow._fingerprint

    def in_avals(self, bucket: int):
        return self.as_stage().in_avals(bucket)

    def out_avals(self, bucket: int):
        """The output avals at ``bucket`` (``export.TensorSpec`` by key),
        by shape propagation on fake tensors (``pipeline.shape_eval``):
        no forward runs. A model served from an artifact takes them from
        the program's metadata. The seam a pipeline checks its edges
        against."""
        return self.as_stage().out_avals(bucket)

    def run(self, batch: np.ndarray) -> dict[str, np.ndarray]:
        """Host batch -> host outputs, eagerly: one H2D copy, the
        forward, one D2H copy of all outputs together."""
        x = torch.from_numpy(np.ascontiguousarray(batch, self.input_dtype))
        with torch.inference_mode():
            return _to_host(self.forward(x.to(self.device)))

    def export_bytes(self, bucket: int) -> bytes:
        """The whole request program at ``bucket``, the forward and the
        task head with the current weights, as ``torch.export`` bytes
        (``export.export_callable``): what the artifact store keeps under
        this model's :meth:`weights_fingerprint`, so that a fresh server
        loads it instead of tracing."""
        from deepvision_tpu_torch.export import export_callable

        dtype = torch.from_numpy(np.zeros(0, self.input_dtype)).dtype
        return export_callable(self.forward,
                               [((bucket, *self.input_shape), dtype)],
                               device=self.device, module=self.module)

    def with_program(self, program) -> "ServedModel":
        """This model served by ``program`` (a loaded request program of
        :meth:`export_bytes`) in place of its forward: same name, key,
        task head and post-process."""
        # the program carries its weights: its runners read no edition
        return dataclasses.replace(self, forward=program, exported=True,
                                   edition=None,
                                   _fingerprint=self.weights_fingerprint())

    def compile_for(self, bucket: int, pool=None):
        """The runner of batches of ``bucket`` rows, ``host batch -> host
        outputs`` (a batch of fewer rows is padded with zero rows): a
        :class:`CudaGraphRunner` on the card, captured into the graph
        memory pool ``pool`` (``torch.cuda.graph_pool_handle()``; the
        buckets of one model share one), an :class:`EagerRunner` on the
        CPU. A capture that fails raises: the card never falls back to
        the eager forward."""
        if self.device.type == "cuda":
            return CudaGraphRunner(self, bucket, pool)
        return EagerRunner(self, bucket)


def _pack(out: Mapping[str, torch.Tensor]):
    """Every output's bytes a row laid side by side in one ``(B, bytes)``
    uint8 tensor, so that one copy fetches them all. -> (the tensor, its
    layout for :func:`_unpack`)."""
    rows = [t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)
            for t in out.values()]
    layout = [(key, torch.empty((), dtype=t.dtype).numpy().dtype,
               tuple(t.shape[1:]), r.shape[1])
              for (key, t), r in zip(out.items(), rows)]
    return torch.cat(rows, dim=1), layout


def _unpack(host: np.ndarray, layout) -> dict[str, np.ndarray]:
    """:func:`_pack`'s host bytes split into the outputs again, each a
    copy of its own."""
    result, start = {}, 0
    for key, np_dtype, shape, width in layout:
        part = np.array(host[:, start:start + width])
        start += width
        result[key] = part.view(np_dtype).reshape((host.shape[0], *shape))
    return result


def _to_host(out: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Fetch every output in one device-to-host copy."""
    packed, layout = _pack(out)
    return _unpack(packed.cpu().numpy(), layout)


def _check_batch(batch: np.ndarray, shape: tuple) -> None:
    """A runner of ``shape`` takes a batch of at most ``shape[0]`` rows of
    its row shape."""
    if batch.ndim != len(shape) or len(batch) > shape[0] \
            or batch.shape[1:] != shape[1:]:
        raise ValueError(f"a runner of {shape} got a batch of "
                         f"{batch.shape}")


class EagerRunner:
    """The CPU's bucket runner: the eager forward (:meth:`ServedModel.run`)
    on the batch padded to the bucket, of the model as it was when the
    runner was built (a shallow copy: a hot swap flips the model in
    place, and the runner keeps its forward, as a graph keeps the weights
    it was captured over). ``calls`` counts its calls."""

    kind = "eager"
    pool_bytes = 0
    capture_s = 0.0

    def __init__(self, served: ServedModel, bucket: int):
        self.served, self.bucket = copy.copy(served), bucket
        self.editions = served.pinned_editions()
        self.launches: dict[str, int] = {}
        self.calls = 0

    def __call__(self, batch: np.ndarray) -> dict[str, np.ndarray]:
        self.calls += 1
        shape = (self.bucket, *self.served.input_shape)
        batch = np.asarray(batch)
        _check_batch(batch, shape)
        x = np.zeros(shape, self.served.input_dtype)
        x[:len(batch)] = batch
        return self.served.run(x)


class CudaGraphRunner:
    """One bucket of one served model as a captured CUDA graph.

    The graph holds the forward, the task head and :func:`_pack`, from a
    static input of ``(bucket, *input_shape)`` to one packed output
    buffer. A call copies the batch into the static input (rows past the
    batch zeroed on the card), replays the graph and copies the packed
    outputs back into a pinned host buffer: one copy in, one copy out,
    on the current stream of the served device, whatever thread calls.

    Before the capture the forward runs once eagerly on a side stream,
    so that what a first call does (the kernels' build and ``ctypes``
    load, ``anchor_tensor``'s cache, cuDNN's algorithm choice, the
    allocator's growth) is never captured. The thresholds of the task
    head (``--top``, ``--score``, ``--iou``) are fixed for a served model
    and are captured as constants; nothing that changes per request
    reaches the graph but the static input's bytes. ``launches`` are the
    port's kernels that one replay launches: those that the capture's
    calls of their wrappers recorded (``ops.note_captured``); each call
    credits them (``ops.credit_launches``), and ``calls`` counts the
    replays, so that the launches of a process split exactly among its
    runners (each capture's eager forward launches once more).
    ``pool_bytes`` is what the capture added to the memory the allocator
    reserves: the graph's share of its pool (approximate when another
    thread allocates or frees during the capture). Graphs of one pool are
    replayed one at a time (the engine's one dispatcher), each output
    copied out before the next replay. ``editions`` are the weights the
    graph reads (``ServedModel.pinned_editions``), which the runner keeps
    alive; the eager forward and the capture hold :data:`capture_lock`.
    A forward that carries ``after_replay`` (a DAG's, for its stage
    events) is told, after each replay, the host stamp taken just before
    it."""

    kind = "cuda_graph"

    def __init__(self, served: ServedModel, bucket: int, pool=None):
        dev = served.device
        self.bucket = bucket
        self._device = dev
        # the graph reads the weights at their addresses: the runner keeps
        # the forward, and with it the module or the loaded program that
        # owns them, alive. A program loaded from the artifact store has
        # no other owner once the warm-up is over; freed, its weights'
        # blocks went to the next allocation (the next model's program)
        self._forward = served.forward
        self._after_replay = getattr(served.forward, "after_replay", None)
        self.editions = served.pinned_editions()
        self._input_dtype = served.input_dtype
        shape = (bucket, *served.input_shape)
        dtype = torch.from_numpy(np.zeros(0, served.input_dtype)).dtype
        t0 = time.perf_counter()
        with capture_lock, torch.cuda.device(dev), torch.inference_mode():
            self._static_in = torch.zeros(shape, dtype=dtype, device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _, self._layout = _pack(served.forward(self._static_in))
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            # the capture empties the allocator's cache itself; empty it
            # first, so that the reserved bytes move by the pool alone
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            counts = captured_launches()
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self._static_out, _ = _pack(served.forward(self._static_in))
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            after = captured_launches()
            self.launches = {k: n - counts.get(k, 0)
                             for k, n in after.items()
                             if n != counts.get(k, 0)}
            self._host_out = torch.empty(self._static_out.shape,
                                         dtype=torch.uint8, pin_memory=True)
        self.capture_s = time.perf_counter() - t0
        self.calls = 0

    def __call__(self, batch: np.ndarray) -> dict[str, np.ndarray]:
        batch = np.ascontiguousarray(batch, self._input_dtype)
        _check_batch(batch, tuple(self._static_in.shape))
        n = len(batch)
        x = torch.from_numpy(batch)
        with torch.cuda.device(self._device), torch.inference_mode():
            stream = torch.cuda.current_stream(self._device)
            self._static_in[:n].copy_(x)
            if n < self.bucket:
                self._static_in[n:].zero_()
            t_replay = time.perf_counter()
            self._graph.replay()
            self._host_out.copy_(self._static_out, non_blocking=True)
            stream.synchronize()
        self.calls += 1
        credit_launches(self.launches)
        if self._after_replay is not None:
            self._after_replay(t_replay)
        return _unpack(self._host_out.numpy(), self._layout)


def _classify_head(top_k: int):
    def head(logits: torch.Tensor) -> dict[str, torch.Tensor]:
        probs = torch.softmax(logits.float(), dim=-1)
        top_probs, top_classes = torch.topk(probs, top_k, dim=-1)
        return {"probs": top_probs, "classes": top_classes.to(torch.int32)}

    return head


def _classify_forward(module: nn.Module, top_k: int):
    head = _classify_head(top_k)

    def forward(x: torch.Tensor) -> dict[str, torch.Tensor]:
        return head(module(x))

    return forward


def _classify_post(host: dict, i: int) -> dict:
    return {"classes": np.asarray(host["classes"][i]).tolist(),
            "probs": np.asarray(host["probs"][i]).tolist()}


def _yolo_forward(module: nn.Module, num_classes: int, score_thresh: float,
                  iou_thresh: float):
    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_postprocess

    def forward(x: torch.Tensor) -> dict[str, torch.Tensor]:
        boxes, scores, classes, valid, _ = yolo_postprocess(
            module(x), num_classes, score_thresh=score_thresh,
            iou_thresh=iou_thresh)
        return {"boxes": boxes, "scores": scores, "classes": classes,
                "valid": valid}

    return forward


def _centernet_forward(module: nn.Module, score_thresh: float,
                       top_k: int = 100):
    from deepvision_tpu_torch.ops.centernet_decode import decode_centernet
    from deepvision_tpu_torch.ops.iou import xywh_to_corners

    def forward(x: torch.Tensor) -> dict[str, torch.Tensor]:
        heat, wh, off = module(x)[-1]
        det = decode_centernet(heat, wh, off, top_k=top_k)
        # the detect head's corner-box contract, as YOLO's
        return {"boxes": xywh_to_corners(det["boxes"]),
                "scores": det["scores"], "classes": det["classes"],
                "valid": det["scores"] > score_thresh}

    return forward


def _pose_forward(module: nn.Module):
    from deepvision_tpu_torch.ops.heatmap import decode_heatmaps

    def forward(x: torch.Tensor) -> dict[str, torch.Tensor]:
        kx, ky, conf = decode_heatmaps(module(x)[-1])  # the last stack
        return {"x": kx, "y": ky, "conf": conf}

    return forward


def _pose_post(host: dict, i: int) -> dict:
    return {"joints": np.stack(
        [np.asarray(host["x"][i]), np.asarray(host["y"][i]),
         np.asarray(host["conf"][i])], axis=-1).tolist()}


def _gan_post(host: dict, i: int) -> dict:
    return {"image": np.asarray(host["image"][i]).tolist()}


def _load_gan_served(name: str, workdir: str | None, epoch: int | None,
                     variables, seed: int, dev: torch.device) -> ServedModel:
    """The DCGAN generator as a served model: input z, output image."""
    cfg = get_config("dcgan")
    noise_dim = cfg["noise_dim"]
    restored = None
    if workdir is not None:
        restored, saved = CheckpointManager(
            Path(workdir) / "ckpt").restore_model(epoch, device=dev,
                                                  net="generator")
        noise_dim = saved.get("noise_dim") or noise_dim
    elif epoch is not None:
        raise FileNotFoundError(
            f"requested epoch {epoch} of {name!r} but no checkpoint "
            "directory (workdir) was given")
    module = create_model("dcgan_generator", device=dev, seed=seed,
                          noise_dim=noise_dim)
    if restored is not None:
        module.load_state_dict(restored)
    elif variables is not None:
        module.load_state_dict(flax_to_torch("dcgan_generator", variables,
                                             noise_dim=noise_dim))
    module.eval()
    module.requires_grad_(False)

    return ServedModel(name=name, task="gan", module=module,
                       input_shape=(noise_dim,), postprocess=_gan_post,
                       device=dev, forward=_gan_forward(module),
                       make_forward=_gan_forward, scale="tanh")


def _gan_forward(module: nn.Module):
    def forward(z: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"image": module(z)}

    return forward


def _detect_post(host: dict, i: int) -> dict:
    keep = np.asarray(host["valid"][i]).astype(bool)
    return {"boxes": np.asarray(host["boxes"][i])[keep].tolist(),
            "scores": np.asarray(host["scores"][i])[keep].tolist(),
            "classes": np.asarray(host["classes"][i])[keep].tolist()}


def model_geometry(name: str) -> tuple[int, int]:
    """(input size, channels) of registry model ``name``'s training
    config; (224, 3) for a model without one (the JAX
    ``model_geometry``)."""
    try:
        cfg = get_config(name)
    except KeyError:
        return 224, 3
    return cfg["input_size"], cfg["channels"]


def restore_state(name: str, workdir: str | None = None,
                  epoch: int | None = None, *,
                  device: str | torch.device | None = None, seed: int = 0,
                  variables: Mapping[str, Any] | None = None,
                  input_size: int | None = None,
                  num_classes: int | None = None,
                  num_heatmaps: int | None = None) -> tuple[nn.Module, dict]:
    """Registry model ``name`` built on ``device`` (default ``"cuda"``,
    which raises without a card) in eval mode with its weights, the one
    restore path of :func:`load_served`, ``predict`` and ``eval``. ->
    (module, its geometry: ``input_size``, ``num_classes``,
    ``channels`` and a pose model's ``num_heatmaps``).

    Weights, in this order: the newest verified port checkpoint (or
    ``epoch``'s, which must verify) under ``{workdir}/ckpt`` (the
    trainer's ``{workdir}/{model}/ckpt`` with ``workdir`` naming the
    model's directory), with its geometry unless ``input_size``,
    ``num_classes`` or ``num_heatmaps`` say otherwise; else
    ``variables``, the JAX package's flax variables as nested numpy
    dicts, carried across by ``convert.from_flax.flax_to_torch``; else
    fresh weights from a ``torch.Generator`` seeded with ``seed``. A
    ``workdir`` without a verified checkpoint raises, and so does an
    ``epoch`` without a ``workdir``: an explicit epoch is never served
    on fresh weights."""
    dev = resolve_device(device)
    cfg = get_config(name)
    restored = None
    if workdir is not None:
        restored, saved = CheckpointManager(
            Path(workdir) / "ckpt").restore_model(epoch, device=dev)
        cfg.update({k: saved[k] for k in ("input_size", "num_classes",
                                          "num_heatmaps")
                    if saved.get(k) is not None})
    elif epoch is not None:
        raise FileNotFoundError(
            f"requested epoch {epoch} of {name!r} but no checkpoint "
            "directory (workdir) was given")
    model_kw = {"num_classes": (num_classes if num_classes is not None
                                else cfg["num_classes"]),
                "input_size": (input_size if input_size is not None
                               else cfg["input_size"])}
    if task_for(name) == "pose":
        model_kw["num_heatmaps"] = (num_heatmaps if num_heatmaps is not None
                                    else cfg["num_heatmaps"])
    module = create_model(name, device=dev, seed=seed, **model_kw)
    if restored is not None:
        module.load_state_dict(restored)
    elif variables is not None:
        module.load_state_dict(flax_to_torch(name, variables, **model_kw))
    module.eval()
    module.requires_grad_(False)
    return module, {**model_kw, "channels": cfg["channels"]}


def load_served(name: str, workdir: str | None = None, *,
                epoch: int | None = None,
                variables: Mapping[str, Any] | None = None, seed: int = 0,
                device: str | torch.device | None = None,
                input_size: int | None = None,
                num_classes: int | None = None,
                num_heatmaps: int | None = None,
                top_k: int = 5, score_thresh: float = 0.5,
                iou_thresh: float = 0.5) -> ServedModel:
    """Registry model ``name`` as a :class:`ServedModel` on ``device``
    (default ``"cuda"``, which raises without a card), for its task
    (:func:`task_for`): classify answers the ``top_k`` classes, detect
    the boxes that ``score_thresh`` (and for ``yolov3`` ``iou_thresh``)
    keep, pose the ``num_heatmaps`` joints, gan (``dcgan``,
    ``dcgan_generator``) the DCGAN generator's image for a noise ``z``.
    The weights and geometry are :func:`restore_state`'s."""
    dev = resolve_device(device)
    task = task_for(name)
    if task == "gan":
        return _load_gan_served(name, workdir, epoch, variables, seed, dev)
    module, geo = restore_state(name, workdir, epoch, device=dev, seed=seed,
                                variables=variables, input_size=input_size,
                                num_classes=num_classes,
                                num_heatmaps=num_heatmaps)
    classes, size = geo["num_classes"], geo["input_size"]
    if task == "detect" and name == "centernet":
        def make(m):
            return _centernet_forward(m, score_thresh)
        post = _detect_post
    elif task == "detect":
        def make(m):
            return _yolo_forward(m, classes, score_thresh, iou_thresh)
        post = _detect_post
    elif task == "pose":
        make, post = _pose_forward, _pose_post
    else:
        def make(m):
            return _classify_forward(m, top_k)
        post = _classify_post
    return ServedModel(
        name=name, task=task, module=module,
        input_shape=(size, size, geo["channels"]), postprocess=post,
        device=dev, forward=make(module), make_forward=make,
        scale=input_scale(name))


def from_exported(path: str | Path, *, name: str | None = None,
                  task: str = "classify", top_k: int = 5,
                  device: str | torch.device | None = None) -> ServedModel:
    """An ``export.py`` artifact of a classifier's logits
    (``export_forward``, ``predict export``) as a :class:`ServedModel`,
    the twin of the JAX ``from_stablehlo``: the top-``top_k`` head runs
    on the program's logits. The artifact is shape-specialized, so its
    bucket ladder is the exported batch alone. It runs on the device it
    was exported on, which must be ``device`` (default ``"cuda"``, which
    raises without a card); its key's fingerprint is the artifact's
    SHA-256."""
    import hashlib

    from deepvision_tpu_torch.export import deserialize_exported

    if task != "classify":
        raise ValueError(f"an artifact serves classify heads only, got task "
                         f"{task!r}")
    dev = resolve_device(device)
    data = Path(path).read_bytes()
    program = deserialize_exported(data)
    if program.device.type != dev.type:
        raise ValueError(f"{path} was exported on {program.device} and "
                         f"runs there only; asked to serve it on {dev}")
    (spec,) = program.in_avals  # export_forward exports a one-input forward
    batch, *input_shape = spec.shape
    if len(program.out_avals) != 1:
        raise ValueError(f"{path}: a classifier's artifact has one output, "
                         f"its logits; got {len(program.out_avals)}")
    return ServedModel(
        name=name or Path(path).stem, task=task, module=program.module,
        input_shape=tuple(input_shape), postprocess=_classify_post,
        device=program.device, forward=_classify_forward(program, top_k),
        input_dtype=torch.empty((), dtype=spec.dtype).numpy().dtype,
        buckets=(int(batch),), exported=True,
        program_out_avals=program.out_avals, head=_classify_head(top_k),
        _fingerprint=hashlib.sha256(data).hexdigest())
