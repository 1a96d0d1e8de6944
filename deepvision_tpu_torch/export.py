"""Model export: serialized ``torch.export`` artifacts.

The twin of ``deepvision_tpu/export.py``, whose StableHLO artifacts carry
the reference's deployment surface (CycleGAN's saved_model and TFLite
converter): the eval-mode forward is traced once at a fixed input shape
and serialized with its signature and its weights, and the artifact
reloads and runs without the model's Python code.

Here an artifact is a ``torch.export.ExportedProgram`` saved with
``torch.export.save`` into bytes (files end in ``.pt2``). The weights
travel inside it. The port's kernels are ``torch.library`` custom ops
(``deepvision::lrn_forward`` in ``ops/lrn.py``, ``deepvision::nms_sweep``
in ``ops/nms.py``), so an exported graph holds each as one node, and a
loaded program launches the hand-written kernel for a CUDA tensor as the
eager module does. Loading imports those modules first, so that the ops
resolve. A program runs on the device it was exported on.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import NamedTuple

import torch
from torch import nn

__all__ = ["TensorSpec", "export_forward", "export_callable",
           "deserialize_exported", "save_exported", "load_exported",
           "graph_ops", "SUFFIX"]

SUFFIX = ".pt2"


class TensorSpec(NamedTuple):
    """An input or output of an artifact: the twin of
    ``jax.ShapeDtypeStruct``."""

    shape: tuple[int, ...]
    dtype: torch.dtype


class _Callable(nn.Module):
    """``fn`` as a module for ``torch.export.export``; ``module``, where
    given, is registered, so that the weights ``fn`` reads through it are
    the program's parameters and buffers."""

    def __init__(self, fn, module: nn.Module | None = None):
        super().__init__()
        self.fn = fn
        self.module = module

    def forward(self, *args):
        return self.fn(*args)


def _serialize(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _device_of(module: nn.Module) -> torch.device:
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return torch.device("cpu")


def export_forward(module: nn.Module, sample) -> bytes:
    """Export ``module``'s eval-mode forward at the sample's shape and
    dtype (a tensor or an array; it is placed on the module's device) and
    return the serialized bytes. The module's mode is restored after."""
    x = torch.as_tensor(sample).to(_device_of(module))
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(module, (x,))
    finally:
        module.train(was_training)
    return _serialize(program)


def export_callable(fn, in_specs, *, device=None,
                    module: nn.Module | None = None) -> bytes:
    """Export an arbitrary callable at explicit input specs (``(shape,
    dtype)`` pairs, inputs made on ``device``, default the card) and
    return the serialized bytes: the general form of
    :func:`export_forward`, with which ``ServedModel.export_bytes``
    exports a whole request program (the forward and the task head) for
    the artifact store. ``module`` names the module whose weights ``fn``
    reads, so that they travel as the program's parameters; tensors that
    ``fn`` holds otherwise are baked in as constants."""
    from deepvision_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    args = tuple(torch.zeros(tuple(shape), dtype=dtype, device=dev)
                 for shape, dtype in in_specs)
    with torch.no_grad():
        program = torch.export.export(_Callable(fn, module).eval(), args)
    return _serialize(program)


def _specs(nodes) -> tuple[TensorSpec, ...]:
    return tuple(TensorSpec(tuple(n.meta["val"].shape), n.meta["val"].dtype)
                 for n in nodes)


def deserialize_exported(data: bytes):
    """Artifact bytes -> callable, the in-memory dual of
    :func:`load_exported` for callers that keep their own files and
    integrity manifests (``serve/artifact_store.py``). The callable
    carries ``in_avals`` and ``out_avals`` (:class:`TensorSpec` tuples,
    the outputs flattened in the program's pytree order), ``exported``
    (the ``ExportedProgram``), ``module`` (the module it runs) and
    ``device`` (the device it was exported on, which it runs on)."""
    # the programs' custom ops: deepvision::lrn_forward, ::nms_sweep
    import deepvision_tpu_torch.ops.lrn  # noqa: F401
    import deepvision_tpu_torch.ops.nms  # noqa: F401

    program = torch.export.load(io.BytesIO(data))
    sig = program.graph_signature
    placeholders = {n.name: n for n in program.graph.nodes
                    if n.op == "placeholder"}
    (output,) = [n for n in program.graph.nodes if n.op == "output"]
    outs = output.args[0][len(output.args[0]) - len(sig.user_outputs):]
    module = program.module()

    def call(*args):
        return module(*args)

    inputs = [placeholders[name] for name in sig.user_inputs]
    call.in_avals = _specs(inputs)
    call.out_avals = _specs(outs)
    call.exported = program
    call.module = module
    # the device of the example inputs, which the program runs on
    call.device = inputs[0].meta["val"].device
    return call


def save_exported(path: str | Path, data: bytes) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path


def load_exported(path: str | Path):
    """-> callable running the deserialized program, with its full
    signature as metadata (:func:`deserialize_exported`): an artifact is
    shape-specialized, so a serving host (``serve.models.from_exported``)
    pins its bucket ladder to the exported batch from ``in_avals``, and a
    caller that feeds another shape finds out from the spec."""
    return deserialize_exported(Path(path).read_bytes())


def graph_ops(program) -> dict[str, int]:
    """How many nodes of each ``call_function`` target an
    ``ExportedProgram`` (or a loaded callable's ``exported``) holds, by
    the target's name (``deepvision.lrn_forward.default``)."""
    program = getattr(program, "exported", program)
    counts: dict[str, int] = {}
    for n in program.graph.nodes:
        if n.op == "call_function":
            name = str(n.target)
            counts[name] = counts.get(name, 0) + 1
    return counts

