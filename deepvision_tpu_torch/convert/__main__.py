"""Converter CLI: a reference checkpoint file -> a port checkpoint.

    python -m deepvision_tpu_torch.convert <ckpt.pt|weights.h5> -m <model> \
        -o <workdir> [--num-classes 1000] [--input-size 224] [--device cuda]

The twin of ``python -m deepvision_tpu.convert``. It reads a reference
PyTorch ``.pt`` (the checkpoint dict of everything or a state dict,
``module.`` prefixes handled; ``convert/torch_import.py``) or a Keras
``.h5`` (``resnet50v2`` only; ``convert/keras_import.py``, which needs
h5py), and writes epoch 0 of ``<workdir>/<model>/ckpt`` with the port's
``train/checkpoint.CheckpointManager`` (a throwaway SGD as the
optimizer; ``meta.json`` carries the model's name and geometry), which
``python -m deepvision_tpu_torch.predict ... --workdir
<workdir>/<model>``, ``eval classification`` and ``serve`` restore
directly. The module is built on ``--device`` (``cuda`` by default,
which raises without a card; ``cpu`` when asked) and the converted
weights load into it before the save.

Families by model name: ``resnet34``/``resnet50``/``resnet152`` (stage
and block naming), ``vgg16``/``vgg19``/``alexnet2`` (Sequential order,
the NCHW flatten turned NHWC), ``inception1_ref`` (the BN-free variant
with its aux heads), ``mobilenet1`` (dw/pw separable convs),
``resnet50v2`` (keras-applications HDF5 naming).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

__all__ = ["convert_file", "save_as_checkpoint", "main"]


def convert_file(path: str, model_name: str, **model_kw) -> dict:
    """-> the port's state dict of ``model_name`` from ``path``."""
    if str(path).endswith((".h5", ".hdf5")):
        if model_name != "resnet50v2":
            raise SystemExit(
                f"h5 conversion is wired for resnet50v2, not {model_name}")
        from deepvision_tpu_torch.convert.keras_import import keras_h5_to_port

        return keras_h5_to_port(path, model_name, **model_kw)
    from deepvision_tpu_torch.convert.torch_import import (
        convert_state_dict,
        load_torch_checkpoint,
    )

    try:
        return convert_state_dict(model_name, load_torch_checkpoint(path),
                                  **model_kw)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def save_as_checkpoint(state_dict: dict, model_name: str, workdir: str, *,
                       num_classes: int, input_size: int, device,
                       source: str = "reference-checkpoint") -> Path:
    """Write ``state_dict`` as epoch 0 of ``<workdir>/<model>/ckpt``;
    returns that directory."""
    import torch

    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager
    from deepvision_tpu_torch.train.state import TrainState

    module = create_model(model_name, device=device, num_classes=num_classes,
                          input_size=input_size)
    module.load_state_dict(state_dict)
    state = TrainState(module, torch.optim.SGD(module.parameters(), lr=0.1))
    out = Path(workdir) / model_name / "ckpt"
    CheckpointManager(out).save(
        0, state, extra={"converted_from": source},
        config={"name": model_name, "input_size": input_size,
                "num_classes": num_classes})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.convert", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help=".pt/.pth/.h5 reference checkpoint")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-o", "--workdir", required=True,
                   help="output workdir (the model's directory goes under "
                        "it)")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--input-size", type=int, default=224)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    from deepvision_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    geometry = {"num_classes": args.num_classes,
                "input_size": args.input_size}
    state_dict = convert_file(args.checkpoint, args.model, **geometry)
    out = save_as_checkpoint(state_dict, args.model, args.workdir,
                             device=device, source=str(args.checkpoint),
                             **geometry)
    n_params = sum(v.numel() for k, v in state_dict.items()
                   if not k.endswith((".mean", ".var")))
    print(f"converted {args.checkpoint} -> {out} ({n_params:,} params, "
          f"model={args.model})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
