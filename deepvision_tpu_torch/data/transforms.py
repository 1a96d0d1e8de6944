"""Numpy image transforms, the twin of ``deepvision_tpu/data/transforms.py``.

Callables ``(rng, image) -> image`` over HWC uint8 or float32 arrays,
composed with :class:`Compose`, for the flattened-folder dataset
(``data/folder.py``) and CPU-side tooling: Rescale (the shorter side,
cv2's bilinear resize where cv2 is installed, else nearest neighbour in
numpy, as JAX), RandomCrop, CenterCrop, RandomHorizontalFlip, ToFloat,
EnsureRGB, ToUint8, Normalize and ColorJitter (PIL-enhance semantics in
float), and the ImageNet train, eval and host-stage composes. The
random decisions come from the ``numpy.random.Generator`` passed in, so
the same generator gives the same image on both sides.

cv2 is imported on first use, never at import (the card's machine has
none); setting the module's ``cv2`` to None takes the numpy fallback.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Compose", "Rescale", "RandomCrop", "CenterCrop",
           "RandomHorizontalFlip", "ToFloat", "EnsureRGB", "ToUint8",
           "Normalize", "apply_color_jitter", "ColorJitter",
           "imagenet_train_transform", "imagenet_eval_transform",
           "imagenet_host_transform", "load_cv2"]

_UNSET = object()
# cv2, once :func:`load_cv2` looked for it (None: not installed, or
# switched off)
cv2 = _UNSET


def load_cv2():
    """The cv2 module, or None where it is not installed (imported on the
    first call)."""
    global cv2
    if cv2 is _UNSET:
        try:
            import cv2 as module
        except ImportError:
            module = None
        cv2 = module
    return cv2


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, rng: np.random.Generator, image: np.ndarray):
        for t in self.transforms:
            image = t(rng, image)
        return image


class Rescale:
    """Aspect-preserving resize of the SHORTER side to ``size``
    (ref: data_load.py Rescale)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, rng, image):
        h, w = image.shape[:2]
        scale = self.size / min(h, w)
        new_h, new_w = int(round(h * scale)), int(round(w * scale))
        lib = load_cv2()
        if lib is not None:
            return lib.resize(image, (new_w, new_h),
                              interpolation=lib.INTER_LINEAR)
        # nearest-neighbor numpy fallback
        ys = (np.arange(new_h) * h / new_h).astype(int)
        xs = (np.arange(new_w) * w / new_w).astype(int)
        return image[ys][:, xs]


class RandomCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, rng, image):
        h, w = image.shape[:2]
        top = int(rng.integers(0, h - self.size + 1))
        left = int(rng.integers(0, w - self.size + 1))
        return image[top : top + self.size, left : left + self.size]


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, rng, image):
        h, w = image.shape[:2]
        top, left = (h - self.size) // 2, (w - self.size) // 2
        return image[top : top + self.size, left : left + self.size]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, rng, image):
        if rng.random() < self.p:
            return image[:, ::-1]
        return image


class ToFloat:
    """uint8 HWC -> float32 [0,1]; grayscale -> 3 channels
    (ref: data_load.py ToTensor :183-189 minus the CHW transpose — the
    framework is NHWC)."""

    def __call__(self, rng, image):
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        elif image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        return image.astype(np.float32) / 255.0


class EnsureRGB:
    """Grayscale -> 3 channels, dtype preserved (the channel repair
    ToFloat performs, split out so the uint8 host stage can use it
    without the f32 conversion)."""

    def __call__(self, rng, image):
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        elif image.shape[-1] == 1:
            image = np.repeat(image, 3, axis=-1)
        return image


class ToUint8:
    """Round-then-clip to uint8 (identity on uint8 input), the uint8
    wire's rule (``data/image_io.wire_uint8``)."""

    def __call__(self, rng, image):
        if image.dtype == np.uint8:
            return image
        return np.clip(np.round(image), 0, 255).astype(np.uint8)


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, rng, image):
        return (image - self.mean) / self.std


def apply_color_jitter(img: np.ndarray, fb: float, fc: float, fs: float):
    """Deterministic PIL-enhance-semantics core on f32: brightness scale,
    contrast blend with the grayscale mean, saturation blend per pixel
    (``data/device_aug.color_jitter`` is its device twin)."""
    coeffs = np.array([0.299, 0.587, 0.114], np.float32)
    img = img * fb
    gray = img @ coeffs
    img = gray.mean() * (1 - fc) + img * fc
    gray = (img @ coeffs)[..., None]
    img = gray * (1 - fs) + img * fs
    return img


class ColorJitter:
    """brightness/contrast/saturation jitter with PIL-enhance semantics
    (factor sampled in [max(0, 1-x), 1+x])."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    @staticmethod
    def _factor(rng, amount):
        return float(rng.uniform(max(0.0, 1 - amount), 1 + amount))

    def __call__(self, rng, image):
        fb = self._factor(rng, self.brightness) if self.brightness else 1.0
        fc = self._factor(rng, self.contrast) if self.contrast else 1.0
        fs = self._factor(rng, self.saturation) if self.saturation else 1.0
        img = apply_color_jitter(image.astype(np.float32), fb, fc, fs)
        if image.dtype == np.uint8:
            # round-then-clip, as the wire; plain astype would truncate
            # and drift 1 LSB
            return np.clip(np.round(img), 0, 255).astype(np.uint8)
        return img


# The standard train and eval pipelines. The resize floor scales with the
# crop (the 0.875 rule), so crops over 256 (Inception V3) work.
def _resize_min(size: int) -> int:
    return max(256, round(size / 0.875))


def imagenet_train_transform(size: int = 224) -> Compose:
    return Compose([
        Rescale(_resize_min(size)),
        RandomCrop(size),
        RandomHorizontalFlip(),
        ColorJitter(0.4, 0.4, 0.4),
        ToFloat(),
        Normalize((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    ])


def imagenet_eval_transform(size: int = 224) -> Compose:
    return Compose([
        Rescale(_resize_min(size)),
        CenterCrop(size),
        ToFloat(),
        Normalize((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    ])


def imagenet_host_transform(size: int = 224) -> Compose:
    """The host stage of the split pipeline: resize the shorter side and
    centre-crop the fixed square canvas (``_resize_min(size)``², uint8
    HWC); the random crop, flip, jitter and normalization run on the
    device from it (``data/device_aug.py``). Pass it as the folder
    dataset's transform for uint8 batches."""
    return Compose([
        Rescale(_resize_min(size)),
        CenterCrop(_resize_min(size)),
        EnsureRGB(),
        ToUint8(),
    ])
