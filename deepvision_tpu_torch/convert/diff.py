"""Layer-for-layer activation diffing, the port's twin of
``deepvision_tpu/convert/diff.py``.

:func:`diff_activations` runs one image through a port module and a
source torch module (the reference's layout: NCHW, its own names), each
with forward hooks on its named submodules, aligns the activations by a
name map and reports each mapped layer's max abs error: where a
converted model first departs from its source. The port's activations
are NHWC, the source's NCHW (turned NHWC to compare).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["diff_activations", "resnet_name_map"]


def _intermediates(module: torch.nn.Module, x: torch.Tensor
                   ) -> dict[str, np.ndarray]:
    """{submodule name: its output} of one eval-mode forward, and the
    module's own output under ``"__output__"``."""
    acts: dict[str, np.ndarray] = {}

    def keep(name):
        def hook(_mod, _inp, out):
            if isinstance(out, torch.Tensor):
                acts.setdefault(name, out.detach().float().cpu().numpy())
        return hook

    hooks = [sub.register_forward_hook(keep(name))
             for name, sub in module.named_modules() if name]
    try:
        module.eval()
        with torch.no_grad():
            out = module(x)
        if isinstance(out, (tuple, list)):
            out = out[0]
        acts["__output__"] = out.detach().float().cpu().numpy()
    finally:
        for h in hooks:
            h.remove()
    return acts


def diff_activations(module: torch.nn.Module, torch_module: torch.nn.Module,
                     image_nhwc, name_map: Mapping[str, str]
                     ) -> dict[str, float]:
    """-> {port layer name: max abs error against the mapped source
    module's output}; NaN where either side has no such layer, inf where
    the shapes differ. ``name_map``: port submodule name (``"stage1_block1"``)
    -> source submodule name (``"conv2x.0"``); ``"__output__"`` compares
    the final outputs. Both run on the CPU in float32."""
    image = np.asarray(image_nhwc, np.float32)
    ours = _intermediates(module, torch.from_numpy(image))
    theirs = _intermediates(
        torch_module,
        torch.from_numpy(np.ascontiguousarray(image.transpose(0, 3, 1, 2))))
    report = {}
    for name, source in name_map.items():
        a, b = ours.get(name), theirs.get(source)
        if a is None or b is None:
            report[name] = float("nan")
            continue
        if b.ndim == 4:
            b = b.transpose(0, 2, 3, 1)
        report[name] = (float(np.max(np.abs(a - b))) if a.shape == b.shape
                        else float("inf"))
    return report


def resnet_name_map(stage_sizes=(3, 4, 6, 3)) -> dict[str, str]:
    """The port -> reference map of the ResNet family: every block's
    output and the logits."""
    out = {"__output__": "__output__"}
    for s, n in enumerate(stage_sizes):
        for j in range(n):
            out[f"stage{s + 1}_block{j + 1}"] = f"conv{s + 2}x.{j}"
    return out
