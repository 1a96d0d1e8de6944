"""Device-side augmentation inside the train step, the classification,
detection, pose and GAN families of ``deepvision_tpu/data/device_aug.py``.

The host ships decode-stage uint8 images (``data/imagenet.py`` and
``data/detection.py`` with ``device_aug``) and every per-element op runs
on the card, in the step:

- the deterministic cores :func:`crop`, :func:`flip`,
  :func:`color_jitter` and :func:`mixup` take EXPLICIT decisions
  (offsets, coins, factors, a permutation and lam), so that they are held
  to their JAX twins op by op on the same decisions (trap C6: threefry
  and torch's Philox never give the same numbers);
- the ``*_params`` samplers draw those decisions from a
  ``torch.Generator`` on the images' device; mixup's Beta(alpha, alpha)
  weight is drawn on the host from a numpy generator of the same seed
  (torch's Beta sampler takes no generator), and crosses as a 0-d
  tensor with no wait;
- :class:`DeviceAugment` keeps the JAX fixed fan-out of one stream a
  slot (``_SLOTS``), so that the op set, not which ops fire, fixes each
  op's stream: switching jitter on does not re-deal the flip coins;
- :func:`augment_step` derives the augmentation's seed from the step's
  generator without drawing from it, so the dropout stream is the same
  with and without augmentation.

Color jitter is factor for factor the JAX ``color_jitter`` (PIL-enhance
semantics, brightness then contrast then saturation), and every uint8
result is re-rounded by ``image_io.wire_uint8``. Normalization stays in
the step (``ops/normalize.maybe_normalize``) unless ``normalize`` is
given. The detection family moves the boxes with the pixels:
:func:`flip_boxes` mirrors the centres of real rows, :func:`crop_boxes`
renormalizes them to a crop window (dropping a box whose centre leaves
it); the detection reader keeps its bbox-preserving crop on the host, so
``--device-aug`` runs the flip alone there. The pose family moves the
keypoints: :func:`flip_keypoints` mirrors them and swaps the left and
right joints by a permutation (:data:`MPII_FLIP_PERM` for the 16 MPII
joints), :func:`crop_keypoints` renormalizes them to a crop window and
hides a joint that leaves it; the pose reader keeps its person crop on
the host. The GAN family augments image batches alone (``{"a", "b"}``
or ``{"image"}``): each crops, flips and normalizes under its own seed,
``derive_seed(seed, i)`` for the i-th present of ``a``, ``b`` and
``image``, as the JAX family folds ``i`` into the key.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from deepvision_tpu_torch.data.image_io import wire_uint8
from deepvision_tpu_torch.ops.normalize import maybe_normalize

__all__ = ["crop", "crop_params", "flip", "flip_params", "color_jitter",
           "jitter_params", "mixup", "mixup_params", "flip_boxes",
           "crop_boxes", "flip_keypoints", "crop_keypoints",
           "MPII_FLIP_PERM", "DeviceAugment", "augment_step",
           "derive_seed"]

# PIL / ITU-R 601 luma, as the JAX twins weigh it
_LUMA = (0.299, 0.587, 0.114)

# the MPII joint order: r-ankle..r-hip (0-2), l-hip..l-ankle (3-5),
# pelvis, thorax, neck, head (6-9), r-wrist..r-shoulder (10-12),
# l-shoulder..l-wrist (13-15); a horizontal flip swaps left and right
MPII_FLIP_PERM = (5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 15, 14, 13, 12, 11, 10)


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for stream ``path`` under ``seed`` (numpy's
    ``SeedSequence``: distinct paths give independent streams)."""
    seq = np.random.SeedSequence(int(seed), spawn_key=tuple(path))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# --------------------------------------------------------------- crop


def crop_params(generator: torch.Generator, n: int, in_h: int, in_w: int,
                size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample offsets: (tops, lefts), int64 in [0, in_h - size] x
    [0, in_w - size], on the generator's device."""
    if size > in_h or size > in_w:
        raise ValueError(f"crop {size} exceeds canvas {in_h}x{in_w}")
    dev = generator.device
    tops = torch.randint(0, in_h - size + 1, (n,), generator=generator,
                         device=dev)
    lefts = torch.randint(0, in_w - size + 1, (n,), generator=generator,
                          device=dev)
    return tops, lefts


def crop(images: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
         size: int) -> torch.Tensor:
    """Per-sample ``size``² crop of an NHWC batch at explicit offsets
    (dtype-preserving), one gather."""
    b = images.shape[0]
    span = torch.arange(size, device=images.device)
    rows = (tops.to(images.device)[:, None] + span)[:, :, None]
    cols = (lefts.to(images.device)[:, None] + span)[:, None, :]
    batch = torch.arange(b, device=images.device)[:, None, None]
    return images[batch, rows, cols]


# --------------------------------------------------------------- flip


def flip_params(generator: torch.Generator, n: int,
                p: float = 0.5) -> torch.Tensor:
    """Per-sample horizontal-flip coins, (n,) bool."""
    return torch.rand(n, generator=generator, device=generator.device) < p


def flip(images: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the samples where ``flips`` (dtype-preserving)."""
    return torch.where(flips.to(images.device)[:, None, None, None],
                       images.flip(2), images)


# ------------------------------------------------------- color jitter


def jitter_params(generator: torch.Generator, n: int,
                  brightness: float = 0.0, contrast: float = 0.0,
                  saturation: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample PIL-enhance factors, each U[max(0, 1 - a), 1 + a]; an
    amount of 0 pins 1.0. All three are drawn whatever the amounts, so
    one amount never shifts another's draws."""
    out = []
    for amount in (brightness, contrast, saturation):
        f = torch.empty(n, device=generator.device).uniform_(
            max(0.0, 1.0 - amount), 1.0 + amount, generator=generator)
        out.append(f if amount else torch.ones_like(f))
    return tuple(out)


def _gray(img: torch.Tensor) -> torch.Tensor:
    """Luma of float32 RGB pixels, ``img @ luma`` as the JAX twin takes
    it (one matrix-vector product over the channels)."""
    return img @ torch.tensor(_LUMA, dtype=torch.float32, device=img.device)


def color_jitter(images: torch.Tensor, fb: torch.Tensor, fc: torch.Tensor,
                 fs: torch.Tensor) -> torch.Tensor:
    """Per-sample brightness, contrast and saturation with PIL-enhance
    semantics on [0, 255] pixels (brightness scale, contrast blend with
    the image's grayscale mean, saturation blend with each pixel's
    gray), in float32. uint8 in -> uint8 out, re-rounded by
    ``wire_uint8``; float in -> float out."""
    was_uint8 = images.dtype == torch.uint8

    def per_sample(f):
        return f.to(images.device, torch.float32)[:, None, None, None]

    # in place on one float32 copy: mean·(1 - c) + img·c and
    # gray·(1 - s) + img·s, each sum taken as the JAX twin takes it
    img = images.float().mul_(per_sample(fb))
    mean = _gray(img).mean(dim=(1, 2))[:, None, None, None]
    c = per_sample(fc)
    img.mul_(c).add_(mean * (1.0 - c))
    s = per_sample(fs)
    gray = _gray(img)[..., None].mul_(1.0 - s)
    img.mul_(s).add_(gray)
    return wire_uint8(img) if was_uint8 else img


# -------------------------------------------------------------- mixup


def mixup_params(seed: int, n: int, alpha: float, device: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A partner permutation (from a generator on ``device``) and one
    Beta(alpha, alpha) weight for the batch (Zhang et al. 2018, one lam a
    batch as the JAX twin draws it), both from ``seed``. lam is drawn on
    the host by numpy (torch's Beta takes no generator) and returned as a
    0-d float32 tensor on ``device``, filled without a wait."""
    perm = torch.randperm(n, generator=_generator(seed, device),
                          device=device)
    lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    return perm, torch.full((), lam, dtype=torch.float32, device=device)


def mixup(images: torch.Tensor, perm: torch.Tensor,
          lam: torch.Tensor) -> torch.Tensor:
    """``lam·x + (1 - lam)·x[perm]`` in float32; uint8 in -> uint8 out
    (re-rounded by ``wire_uint8``)."""
    was_uint8 = images.dtype == torch.uint8
    x = images.float()
    mixed = lam * x + (1.0 - lam) * x[perm.to(images.device)]
    return wire_uint8(mixed) if was_uint8 else mixed


# -------------------------------------------------- detection targets


def flip_boxes(boxes: torch.Tensor, labels: torch.Tensor,
               flips: torch.Tensor) -> torch.Tensor:
    """Mirror xywh-normalized boxes of flipped samples: cx -> 1 - cx on
    real rows (label >= 0); padding rows stay all-zero."""
    real = (labels >= 0) & flips.to(boxes.device)[:, None]
    cx = torch.where(real, 1.0 - boxes[..., 0], boxes[..., 0])
    return torch.cat([cx[..., None], boxes[..., 1:]], dim=-1)


def crop_boxes(boxes: torch.Tensor, labels: torch.Tensor,
               tops: torch.Tensor, lefts: torch.Tensor, in_h: int,
               in_w: int, size: int, min_extent: float = 1e-3
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Renormalize xywh boxes of an ``in_h`` x ``in_w`` canvas to each
    sample's ``size``² crop window, clipped to it; a box whose centre
    leaves the window, or whose clipped extent falls below
    ``min_extent``, becomes padding (zero box, label -1)."""
    ty = tops.to(boxes.device)[:, None].float() / size
    lx = lefts.to(boxes.device)[:, None].float() / size
    sx = in_w / size
    sy = in_h / size
    cx = boxes[..., 0] * sx - lx
    cy = boxes[..., 1] * sy - ty
    w = boxes[..., 2] * sx
    h = boxes[..., 3] * sy
    x1 = (cx - w / 2).clamp(0.0, 1.0)
    y1 = (cy - h / 2).clamp(0.0, 1.0)
    x2 = (cx + w / 2).clamp(0.0, 1.0)
    y2 = (cy + h / 2).clamp(0.0, 1.0)
    valid = ((labels >= 0) & (cx > 0.0) & (cx < 1.0) & (cy > 0.0)
             & (cy < 1.0) & (x2 - x1 > min_extent)
             & (y2 - y1 > min_extent))
    new = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                      dim=-1)
    new = torch.where(valid[..., None], new, torch.zeros_like(new))
    return new, torch.where(valid, labels, torch.full_like(labels, -1))


# ------------------------------------------------------- pose targets


@functools.lru_cache(maxsize=None)
def _perm_tensor(perm: tuple, device: torch.device) -> torch.Tensor:
    """``perm`` on ``device``, made once a device: a host-to-device copy
    of a pageable array waits for the host, and the step makes none."""
    with torch.inference_mode(False):
        return torch.tensor(perm, device=device)


def flip_keypoints(kx: torch.Tensor, ky: torch.Tensor, v: torch.Tensor,
                   flips: torch.Tensor, perm=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mirror the normalized keypoints of flipped samples (kx -> 1 - kx),
    with ``perm`` (a joint permutation, or None) applied to kx, ky and v
    together: a mirrored person's left wrist is the right-wrist
    channel."""
    if perm is not None:
        idx = _perm_tensor(tuple(perm), kx.device)
        kx_f, ky_f, v_f = kx[:, idx], ky[:, idx], v[:, idx]
    else:
        kx_f, ky_f, v_f = kx, ky, v
    f = flips.to(kx.device)[:, None]
    return (torch.where(f, 1.0 - kx_f, kx), torch.where(f, ky_f, ky),
            torch.where(f, v_f, v))


def crop_keypoints(kx: torch.Tensor, ky: torch.Tensor, v: torch.Tensor,
                   tops: torch.Tensor, lefts: torch.Tensor, in_h: int,
                   in_w: int, size: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Renormalize keypoints of an ``in_h`` x ``in_w`` canvas to each
    sample's ``size``² crop window; a joint that leaves the window loses
    its visibility (the heatmaps then skip it)."""
    nkx = (kx * in_w - lefts.to(kx.device)[:, None]) / size
    nky = (ky * in_h - tops.to(kx.device)[:, None]) / size
    inside = (nkx >= 0.0) & (nkx <= 1.0) & (nky >= 0.0) & (nky <= 1.0)
    return nkx, nky, torch.where(inside, v, torch.zeros_like(v))


# ------------------------------------------------------- composition


class DeviceAugment:
    """The pipeline run inside the step: ``augment(batch, seed) ->
    batch``. Crops from the host's uint8 canvas when ``crop`` is set,
    flips, jitters, mixes up (adding ``label_b`` and ``lam``, which
    ``steps.classification_train_step`` takes) and normalizes only when
    ``normalize`` is given. The ``"detection"`` family moves the batch's
    ``boxes`` and ``label`` with the crop and the flip, the ``"pose"``
    family its ``kx``, ``ky`` and ``v`` (``flip_pairs``: the joint
    permutation of a flip, or None). The ``"gan"`` family augments each
    of the batch's ``a``, ``b`` and ``image`` alone, under its own
    seed."""

    FAMILIES = ("classification", "detection", "pose", "gan")
    # one stream a slot, fixed by the config: toggling an op never
    # re-deals another op's draws
    _SLOTS = ("crop", "flip", "jitter", "mixup")

    def __init__(self, family: str = "classification", *,
                 crop: int | None = None, flip: bool = True,
                 flip_pairs=None, jitter: float = 0.0, mixup: float = 0.0,
                 normalize: str | None = None):
        if family not in self.FAMILIES:
            raise ValueError(f"unknown device augmentation family "
                             f"{family!r}; one of {self.FAMILIES}")
        if mixup < 0:
            raise ValueError(f"mixup alpha must be >= 0, got {mixup}")
        if mixup and family != "classification":
            raise ValueError("mixup mixes labels pairwise: a "
                             "classification-only augmentation")
        self.family = family
        self.crop = crop
        self.flip = flip
        self.flip_pairs = flip_pairs
        self.jitter = float(jitter)
        self.mixup = float(mixup)
        self.normalize = normalize

    def __repr__(self):
        on = [f"crop={self.crop}" if self.crop else None,
              "flip" if self.flip else None,
              f"jitter={self.jitter}" if self.jitter else None,
              f"mixup={self.mixup}" if self.mixup else None,
              f"normalize={self.normalize}" if self.normalize else None]
        return (f"DeviceAugment({self.family}, "
                + ", ".join(o for o in on if o) + ")")

    def seeds(self, seed: int) -> dict[str, int]:
        """The seed of each slot's stream under ``seed``."""
        return {slot: derive_seed(seed, i)
                for i, slot in enumerate(self._SLOTS)}

    def __call__(self, batch: dict, seed: int) -> dict:
        batch = dict(batch)
        if self.family == "gan":
            for i, name in enumerate(k for k in ("a", "b", "image")
                                     if k in batch):
                batch[name] = self._image_only(batch[name],
                                               derive_seed(seed, i))
            return batch
        images = batch["image"]
        dev = images.device
        seeds = self.seeds(seed)
        b, in_h, in_w = images.shape[:3]
        if self.crop is not None:
            tops, lefts = crop_params(_generator(seeds["crop"], dev), b,
                                      in_h, in_w, self.crop)
            images = crop(images, tops, lefts, self.crop)
            if self.family == "detection":
                batch["boxes"], batch["label"] = crop_boxes(
                    batch["boxes"], batch["label"], tops, lefts, in_h,
                    in_w, self.crop)
            elif self.family == "pose":
                batch["kx"], batch["ky"], batch["v"] = crop_keypoints(
                    batch["kx"], batch["ky"], batch["v"], tops, lefts,
                    in_h, in_w, self.crop)
        if self.flip:
            flips = flip_params(_generator(seeds["flip"], dev), b)
            images = flip(images, flips)
            if self.family == "detection":
                batch["boxes"] = flip_boxes(batch["boxes"], batch["label"],
                                            flips)
            elif self.family == "pose":
                batch["kx"], batch["ky"], batch["v"] = flip_keypoints(
                    batch["kx"], batch["ky"], batch["v"], flips,
                    self.flip_pairs)
        if self.jitter:
            a = self.jitter
            images = color_jitter(images, *jitter_params(
                _generator(seeds["jitter"], dev), b, a, a, a))
        if self.mixup:
            perm, lam = mixup_params(seeds["mixup"], b, self.mixup, dev)
            images = mixup(images, perm, lam)
            batch["label_b"] = batch["label"][perm]
            batch["lam"] = lam
        if self.normalize is not None:
            images = maybe_normalize(images, self.normalize)
        batch["image"] = images
        return batch


    def _image_only(self, images: torch.Tensor, seed: int) -> torch.Tensor:
        dev = images.device
        seeds = self.seeds(seed)
        if self.crop is not None:
            b, in_h, in_w = images.shape[:3]
            images = crop(images, *crop_params(
                _generator(seeds["crop"], dev), b, in_h, in_w, self.crop),
                self.crop)
        if self.flip:
            images = flip(images, flip_params(_generator(seeds["flip"], dev),
                                              images.shape[0]))
        if self.jitter:
            a = self.jitter
            images = color_jitter(images, *jitter_params(
                _generator(seeds["jitter"], dev), images.shape[0], a, a, a))
        if self.normalize is not None:
            images = maybe_normalize(images, self.normalize)
        return images


# the stream of the step's generator that augmentation takes
_AUGMENT_STREAM = 1


def augment_step(step_fn: Callable, augment: DeviceAugment) -> Callable:
    """``step_fn(state, batch, generator)`` with ``augment`` run on the
    batch first. The augmentation's seed derives from the generator's
    seed, and nothing is drawn from the generator itself: the dropout
    stream is the one the step draws without augmentation. Eval steps
    stay unwrapped."""

    @functools.wraps(step_fn)
    def step(state, batch, generator):
        seed = derive_seed(generator.initial_seed(), _AUGMENT_STREAM)
        return step_fn(state, augment(batch, seed), generator)

    return step
