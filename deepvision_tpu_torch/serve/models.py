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
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from deepvision_tpu_torch.convert.from_flax import flax_to_torch
from deepvision_tpu_torch.device import resolve_device
from deepvision_tpu_torch.models import create_model
from deepvision_tpu_torch.train.checkpoint import CheckpointManager
from deepvision_tpu_torch.train.configs import get_config

__all__ = ["ServedModel", "load_served", "task_for", "input_scale"]

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
    a JSON-able dict."""

    name: str
    task: str
    module: nn.Module
    input_shape: tuple[int, ...]
    postprocess: Callable[[dict, int], dict]
    device: torch.device
    forward: Callable[[torch.Tensor], dict]
    input_dtype: Any = np.float32
    scale: str = "imagenet"

    def run(self, batch: np.ndarray) -> dict[str, np.ndarray]:
        """Host batch -> host outputs: one H2D copy, the forward, one
        D2H copy of all outputs together."""
        x = torch.from_numpy(np.ascontiguousarray(batch, self.input_dtype))
        with torch.inference_mode():
            return _to_host(self.forward(x.to(self.device)))


def _to_host(out: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Fetch every output in one device-to-host copy: each output's
    bytes per row are laid side by side, copied, and split again."""
    rows = [t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)
            for t in out.values()]
    host = torch.cat(rows, dim=1).cpu().numpy()
    result, start = {}, 0
    for (key, t), r in zip(out.items(), rows):
        part = np.ascontiguousarray(host[:, start:start + r.shape[1]])
        start += r.shape[1]
        np_dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        result[key] = part.view(np_dtype).reshape(tuple(t.shape))
    return result


def _classify_forward(module: nn.Module, top_k: int):
    def forward(x: torch.Tensor) -> dict[str, torch.Tensor]:
        logits = module(x)
        probs = torch.softmax(logits.float(), dim=-1)
        top_probs, top_classes = torch.topk(probs, top_k, dim=-1)
        return {"probs": top_probs, "classes": top_classes.to(torch.int32)}

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

    def forward(z: torch.Tensor) -> dict[str, torch.Tensor]:
        return {"image": module(z)}

    return ServedModel(name=name, task="gan", module=module,
                       input_shape=(noise_dim,), postprocess=_gan_post,
                       device=dev, forward=forward, scale="tanh")


def _detect_post(host: dict, i: int) -> dict:
    keep = np.asarray(host["valid"][i]).astype(bool)
    return {"boxes": np.asarray(host["boxes"][i])[keep].tolist(),
            "scores": np.asarray(host["scores"][i])[keep].tolist(),
            "classes": np.asarray(host["classes"][i])[keep].tolist()}


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

    Weights, in this order: the newest verified port checkpoint (or
    ``epoch``'s, which must verify) under
    ``{workdir}/ckpt`` (the trainer's ``{workdir}/{model}/ckpt`` with
    ``workdir`` naming the model's directory, as the JAX package's); its
    geometry unless ``input_size``/``num_classes`` say otherwise; else
    ``variables``, the JAX package's flax variables as nested numpy
    dicts (``params``, and ``batch_stats`` for a model with BN), carried
    across by ``convert.from_flax.flax_to_torch``; else
    fresh weights, drawn from a ``torch.Generator`` seeded with
    ``seed``. A ``workdir`` without a verified checkpoint raises, and so
    does an ``epoch`` without a ``workdir``: an explicit epoch is never
    served on fresh weights."""
    dev = resolve_device(device)
    task = task_for(name)
    if task == "gan":
        return _load_gan_served(name, workdir, epoch, variables, seed, dev)
    cfg = get_config(name)
    restored = None
    if workdir is not None:
        restored, saved = CheckpointManager(
            Path(workdir) / "ckpt").restore_model(epoch, device=dev)
        cfg.update({k: saved[k] for k in ("input_size", "num_classes",
                                          "num_heatmaps")
                    if saved.get(k) is not None})
    size = input_size if input_size is not None else cfg["input_size"]
    classes = num_classes if num_classes is not None else cfg["num_classes"]
    model_kw = {"num_classes": classes, "input_size": size}
    if task == "pose":
        model_kw["num_heatmaps"] = (num_heatmaps if num_heatmaps is not None
                                    else cfg["num_heatmaps"])
    module = create_model(name, device=dev, seed=seed, **model_kw)
    if restored is not None:
        module.load_state_dict(restored)
    elif variables is not None:
        module.load_state_dict(flax_to_torch(name, variables, **model_kw))
    module.eval()
    module.requires_grad_(False)
    if task == "detect" and name == "centernet":
        forward, post = _centernet_forward(module, score_thresh), _detect_post
    elif task == "detect":
        forward = _yolo_forward(module, classes, score_thresh, iou_thresh)
        post = _detect_post
    elif task == "pose":
        forward, post = _pose_forward(module), _pose_post
    else:
        forward, post = _classify_forward(module, top_k), _classify_post
    return ServedModel(
        name=name, task=task, module=module,
        input_shape=(size, size, cfg["channels"]), postprocess=post,
        device=dev, forward=forward, scale=input_scale(name))
