"""JPEG decode for the ImageNet reader: nvJPEG on the card, PIL on the CPU,
and the JAX reader's resize.

The JAX reader decodes with ``tf.io.decode_jpeg`` and resizes with
``tf.image.resize`` (``deepvision_tpu/data/imagenet.py:138-151``). The
card's machine has neither TensorFlow nor PIL, so a JPEG batch crosses
to the card as its packed bytes (:class:`PackedJpegBatch`) and
``csrc/nvjpeg.cu`` decodes it there; on the CPU PIL decodes it. Both
then run the same torch code:

- the resize target is ``ceil(h · scale)`` by ``ceil(w · scale)`` with
  ``scale = resize_min / min(h, w)``, all in float32, as tf computes it
  (trap C9; :func:`resize_dims`);
- the resize is bilinear with half-pixel centres and no antialias, on
  float32 (``F.interpolate(mode="bilinear", align_corners=False,
  antialias=False)``: ``tf.image.resize``'s default);
- then the crop (random from explicit draws, or central), the flip and
  jitter the plan asks for, and the uint8 wire or, for validation, the
  float32 normalization.

On the card nvJPEG decodes to Y, Cb and Cr planes and a kernel of
``csrc/nvjpeg.cu`` (:func:`ycc_to_rgb_reference` is its plain version)
upsamples the chroma and converts to RGB as libjpeg does: nvJPEG's own
RGB output repeats each chroma sample over its 2x2 block, 20 steps off
tf's pixels where libjpeg's interpolation leaves the IDCTs' own 3-4
steps. The tests and ``chip_smoke.py`` state the bounds. On a CUDA
device the decode is nvJPEG's or the call raises; there is no quiet
fallback to the host.
"""

from __future__ import annotations

import ctypes
import dataclasses
import io
import threading

import numpy as np
import torch
import torch.nn.functional as F

from deepvision_tpu_torch.data.image_io import wire_uint8
from deepvision_tpu_torch.ops.normalize import (
    IMAGENET_CHANNEL_MEANS,
    TORCH_CHANNEL_MEANS,
    TORCH_CHANNEL_STDS,
)

__all__ = ["RESIZE_MIN", "resize_min_for", "resize_dims", "resize_bilinear",
           "pack", "decode_images", "encode_images", "nvjpeg",
           "ycc_launches", "QUALITY",
           "planes_of", "ycc_to_rgb_reference", "JpegPlan",
           "PackedJpegBatch"]

RESIZE_MIN = 256


def resize_min_for(size: int) -> int:
    """Shorter-side resize target for a ``size`` crop: 256 for 224, the
    0.875 crop fraction above (the JAX ``resize_min_for``)."""
    return max(RESIZE_MIN, round(size / 0.875))


def resize_dims(h: int, w: int, resize_min: int) -> tuple[int, int]:
    """The aspect-preserving resize target, in float32 as tf computes it:
    ``scale = resize_min / min(h, w)``, then ``ceil(h · scale)`` and
    ``ceil(w · scale)``."""
    hf, wf = np.float32(h), np.float32(w)
    scale = np.float32(resize_min) / np.minimum(hf, wf)
    return int(np.ceil(hf * scale)), int(np.ceil(wf * scale))


def resize_bilinear(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """HWC pixels -> float32 HWC at ``(h, w)``: bilinear, half-pixel
    centres, no antialias (``tf.image.resize``'s default)."""
    x = image.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False)
    return y[0].permute(1, 2, 0)


def pack(blobs) -> tuple[np.ndarray, np.ndarray]:
    """JPEG byte strings -> (packed uint8 bytes, int64 offsets of
    ``len(blobs) + 1``)."""
    offsets = np.zeros(len(blobs) + 1, np.int64)
    offsets[1:] = np.cumsum([len(b) for b in blobs])
    packed = np.frombuffer(b"".join(blobs), np.uint8)
    return packed, offsets


# ---------------------------------------------------------------- nvJPEG

_NVJPEG_ERRORS = {
    1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
    4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
    7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR", 9: "IMPLEMENTATION_NOT_SUPPORTED",
    10: "INCOMPLETE_BITSTREAM"}
# nvjpegBackend_t NVJPEG_BACKEND_GPU_HYBRID: Huffman decode on the card
# for batches over 100 (the hardware backend is refused on sm_90 with
# ARCH_MISMATCH)
_GPU_HYBRID = 2
# the encoder's quality (nvJPEG on the card, PIL on the CPU)
QUALITY = 90
# nvjpegOutputFormat_t
_YUV = 1
# nvjpegChromaSubsampling_t -> chroma (horizontal, vertical) factors;
# NVJPEG_CSS_GRAY (6) has no chroma
_SUBSAMPLING = {0: (1, 1), 1: (2, 1), 2: (2, 2), 6: None}
_CSS_NAMES = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0", 3: "4:4:0", 4: "4:1:1",
              5: "4:1:0", 6: "gray", 7: "4:1:0V"}
# the kernel's YccImage descriptor (csrc/nvjpeg.cu)
_YCC_IMAGE = np.dtype([("y_off", "<i8"), ("c_off", "<i8"), ("out_off", "<i8"),
                       ("h", "<i4"), ("w", "<i4"),
                       ("ch", "<i4"), ("cw", "<i4"), ("hs", "<i4"),
                       ("vs", "<i4"), ("gray", "<i4"), ("pad", "<i4")])


def _check(status: int, what: str) -> None:
    if status == 0:
        return
    if status >= 1000:
        raise RuntimeError(f"nvJPEG {what}: CUDA error {status - 1000}")
    raise RuntimeError(f"nvJPEG {what}: status {status} "
                       f"({_NVJPEG_ERRORS.get(status, 'unknown')})")


class NvJpeg:
    """nvJPEG on one card: batched decode into uint8 RGB tensors (planes
    from nvJPEG, RGB from the ``ycc_to_rgb`` kernel), header sizes, and
    an encoder. The decoder is nvJPEG's ``gpu_hybrid`` backend, or the
    constructor raises with nvJPEG's status: there is no fallback to the
    default backend, whose Huffman decode runs on one host thread.
    Counts the batches and images it decoded and the kernel's launches
    (:attr:`ycc_launches`)."""

    def __init__(self, device: torch.device):
        from deepvision_tpu_torch.ops._build import load_library

        self.device = device
        lib = self.lib = load_library("nvjpeg")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        for name, args in {
            "dv_nvjpeg_create": [i32, ctypes.POINTER(vp)],
            "dv_nvjpeg_info": [vp, vp, ctypes.c_size_t, vp],
            "dv_nvjpeg_decode_batched": [vp, i32, i32, vp, vp, vp, vp, vp],
            "dv_nvjpeg_encoder_create": [i32, ctypes.POINTER(vp)],
            "dv_nvjpeg_encode": [vp, vp, i32, i32, vp, ctypes.c_size_t,
                                 ctypes.POINTER(ctypes.c_size_t), vp],
            "dv_ycc_to_rgb": [vp, vp, vp, vp, vp, i32, i32, vp],
            "dv_ycc_image_bytes": [],
        }.items():
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i32
        if lib.dv_ycc_image_bytes() != _YCC_IMAGE.itemsize:
            raise RuntimeError("csrc/nvjpeg.cu's YccImage does not match "
                               "data/jpeg.py's descriptor")
        self._lock = threading.Lock()
        self.batches = self.images = self.ycc_launches = 0
        with torch.cuda.device(device):
            self._decoder = vp()
            _check(lib.dv_nvjpeg_create(_GPU_HYBRID,
                                        ctypes.byref(self._decoder)),
                   "gpu_hybrid decoder create")
            self._encoder = vp()
            _check(lib.dv_nvjpeg_encoder_create(
                QUALITY, ctypes.byref(self._encoder)), "encoder create")

    def info(self, blob) -> tuple[int, ...]:
        """(height, width, components, chroma subsampling, chroma height,
        chroma width) from a JPEG's header."""
        view = np.frombuffer(blob, np.uint8)
        out = np.zeros(6, np.int32)
        _check(self.lib.dv_nvjpeg_info(self._decoder, view.ctypes.data,
                                       len(view), out.ctypes.data), "info")
        return tuple(int(v) for v in out)

    def decode(self, packed: np.ndarray, offsets: np.ndarray
               ) -> list[torch.Tensor]:
        """Packed JPEGs -> uint8 (H, W, 3) RGB tensors on the card, on
        the current stream: nvJPEG decodes to planes (returning once it
        is done), then one ``ycc_to_rgb`` launch for the batch."""
        planes = self.decode_to_planes(packed, offsets)
        out = self.ycc_to_rgb(planes)
        desc = planes[3]
        return [out[3 * int(d["y_off"]):3 * int(d["y_off"] + d["h"] * d["w"])
                    ].view(int(d["h"]), int(d["w"]), 3) for d in desc]

    def decode_to_planes(self, packed: np.ndarray, offsets: np.ndarray):
        """Packed JPEGs -> the batch's (Y, Cb, Cr) uint8 buffers on the
        card and the kernel's descriptors of its images (a numpy array of
        ``_YCC_IMAGE``), decoded by nvJPEG on the current stream; returns
        once the decode is done."""
        packed = np.ascontiguousarray(packed, np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        n = len(offsets) - 1
        desc = np.zeros(n, _YCC_IMAGE)
        y_at = c_at = 0
        with self._lock, torch.cuda.device(self.device):
            for i in range(n):
                h, w, _, css, ch, cw = self.info(
                    packed[offsets[i]:offsets[i + 1]])
                if css not in _SUBSAMPLING:
                    raise ValueError(
                        f"JPEG {i} has {_CSS_NAMES.get(css, css)} chroma "
                        "subsampling; the decoder takes 4:4:4, 4:2:2, "
                        "4:2:0 and gray")
                factors = _SUBSAMPLING[css]
                hs, vs = factors or (1, 1)
                if factors and (ch, cw) != (-(-h // vs), -(-w // hs)):
                    raise ValueError(f"JPEG {i}: chroma {ch}x{cw} does not "
                                     f"fit {h}x{w} at {hs}x{vs}")
                desc[i] = (y_at, c_at, 3 * y_at, h, w, ch, cw, hs, vs,
                           factors is None, 0)
                y_at += h * w
                c_at += ch * cw if factors else 0
            dev = self.device
            y = torch.empty(max(y_at, 1), dtype=torch.uint8, device=dev)
            cb = torch.empty(max(c_at, 1), dtype=torch.uint8, device=dev)
            cr = torch.empty(max(c_at, 1), dtype=torch.uint8, device=dev)
            ptrs = np.zeros((n, 3), np.uint64)
            pitches = np.zeros((n, 3), np.int32)
            for i, d in enumerate(desc):
                ptrs[i, 0] = y.data_ptr() + int(d["y_off"])
                pitches[i, 0] = d["w"]
                if not d["gray"]:
                    ptrs[i, 1] = cb.data_ptr() + int(d["c_off"])
                    ptrs[i, 2] = cr.data_ptr() + int(d["c_off"])
                    pitches[i, 1:] = d["cw"]
            self._decode(n, _YUV, packed, offsets, ptrs, pitches)
            self.batches += 1
            self.images += n
        return y, cb, cr, desc

    def ycc_to_rgb(self, planes) -> torch.Tensor:
        """The batch's planes (:meth:`decode_to_planes`) -> its RGB pixels,
        one flat uint8 buffer (image i at ``3 · y_off``), by one launch of
        ``ycc_to_rgb_kernel`` on the current stream."""
        y, cb, cr, desc = planes
        pixels = desc["h"].astype(np.int64) * desc["w"]
        total = int(pixels.sum())
        with torch.cuda.device(self.device):
            out = torch.empty(max(3 * total, 1), dtype=torch.uint8,
                              device=self.device)
            images = torch.from_numpy(desc.view(np.uint8)).to(self.device)
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _check(self.lib.dv_ycc_to_rgb(
                y.data_ptr(), cb.data_ptr(), cr.data_ptr(), out.data_ptr(),
                images.data_ptr(), len(desc), int(pixels.max(initial=0)),
                stream),
                "ycc_to_rgb launch")
            self.ycc_launches += 1
        return out

    def _decode(self, n, fmt, packed, offsets, ptrs, pitches) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(self.lib.dv_nvjpeg_decode_batched(
            self._decoder, n, fmt, packed.ctypes.data, offsets.ctypes.data,
            ptrs.ctypes.data, pitches.ctypes.data, stream), "decode")

    def encode(self, image: torch.Tensor) -> bytes:
        """One uint8 (H, W, 3) RGB tensor on the card -> JPEG bytes
        (4:2:0, at ``QUALITY``)."""
        image = image.contiguous()
        h, w = image.shape[:2]
        cap = ctypes.c_size_t(0)
        with self._lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            buf = np.empty(h * w * 3 + 4096, np.uint8)
            while True:
                status = self.lib.dv_nvjpeg_encode(
                    self._encoder, image.data_ptr(), h, w, buf.ctypes.data,
                    len(buf), ctypes.byref(cap), stream)
                if status != -1:
                    break
                buf = np.empty(cap.value, np.uint8)
            _check(status, "encode")
        return buf[:cap.value].tobytes()


def _fancy_upsample(p: torch.Tensor, h: int, w: int, hs: int,
                    vs: int) -> torch.Tensor:
    """libjpeg-turbo's fancy upsampling of an int32 chroma plane to
    ``(h, w)`` (jdsample.c: h2v2 and h2v1; 3/4 of the nearer sample, 1/4
    of the farther, edges repeated, its rounding biases)."""
    if (hs, vs) == (1, 1):
        return p
    if vs == 2:
        above = torch.cat([p[:1], p[:-1]])
        below = torch.cat([p[1:], p[-1:]])
        near = p.repeat_interleave(2, 0)[:h]
        far = torch.stack([above, below], 1).reshape(-1, p.shape[1])[:h]
        col = 3 * near + far
        left = torch.cat([col[:, :1], col[:, :-1]], 1)
        right = torch.cat([col[:, 1:], col[:, -1:]], 1)
        even = (3 * col + left + 8) >> 4
        odd = (3 * col + right + 7) >> 4
        even[:, 0] = (4 * col[:, 0] + 8) >> 4
        odd[:, -1] = (4 * col[:, -1] + 7) >> 4
    else:  # h2v1
        left = torch.cat([p[:, :1], p[:, :-1]], 1)
        right = torch.cat([p[:, 1:], p[:, -1:]], 1)
        even = (3 * p + left + 1) >> 2
        odd = (3 * p + right + 2) >> 2
        even[:, 0] = p[:, 0]
        odd[:, -1] = p[:, -1]
    return torch.stack([even, odd], -1).reshape(even.shape[0], -1)[:h, :w]


def planes_of(planes) -> list[tuple]:
    """The batch's planes (:meth:`NvJpeg.decode_to_planes`) image by
    image: (Y, Cb, Cr, chroma factors) views, Cb and Cr and the factors
    None for a gray image; the input of :func:`ycc_to_rgb_reference`."""
    y, cb, cr, desc = planes
    out = []
    for d in desc:
        yo, co, h, w, ch, cw = (int(d[k]) for k in (
            "y_off", "c_off", "h", "w", "ch", "cw"))
        luma = y[yo:yo + h * w].view(h, w)
        if d["gray"]:
            out.append((luma, None, None, None))
            continue
        out.append((luma, cb[co:co + ch * cw].view(ch, cw),
                    cr[co:co + ch * cw].view(ch, cw),
                    (int(d["hs"]), int(d["vs"]))))
    return out


def ycc_to_rgb_reference(y: torch.Tensor, cb: torch.Tensor | None,
                         cr: torch.Tensor | None,
                         factors: tuple[int, int] | None) -> torch.Tensor:
    """The plain version of ``csrc/nvjpeg.cu``'s ``ycc_to_rgb_kernel``
    for one image: uint8 planes -> uint8 (H, W, 3) RGB, libjpeg's fancy
    upsampling (chroma ``factors`` (horizontal, vertical); None: gray)
    and its fixed-point JFIF conversion (jdcolor.c)."""
    h, w = y.shape
    yv = y.to(torch.int32)
    if factors is None:
        return y[..., None].expand(h, w, 3).clone()
    u = _fancy_upsample(cb.to(torch.int32), h, w, *factors) - 128
    v = _fancy_upsample(cr.to(torch.int32), h, w, *factors) - 128
    half = 1 << 15
    r = yv + ((91881 * v + half) >> 16)
    g = yv + ((-22554 * u + half - 46802 * v) >> 16)
    b = yv + ((116130 * u + half) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


_nvjpeg: dict[int, NvJpeg] = {}
_nvjpeg_lock = threading.Lock()


def nvjpeg(device: torch.device | str = "cuda") -> NvJpeg:
    """The process's :class:`NvJpeg` for ``device`` (built and created
    on first use)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG runs on a CUDA device, not {device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _nvjpeg_lock:
        if index not in _nvjpeg:
            _nvjpeg[index] = NvJpeg(torch.device("cuda", index))
        return _nvjpeg[index]


def ycc_launches() -> int:
    """The ``ycc_to_rgb`` kernel's launches in this process, over every
    card's decoder (0 where none was created)."""
    with _nvjpeg_lock:
        return sum(nv.ycc_launches for nv in _nvjpeg.values())


# ------------------------------------------------------- decode, encode


def _pil_decode(blob) -> torch.Tensor:
    from PIL import Image

    img = Image.open(io.BytesIO(bytes(blob))).convert("RGB")
    return torch.from_numpy(np.array(img, np.uint8))


def decode_images(packed: np.ndarray, offsets: np.ndarray,
                  device: torch.device) -> list[torch.Tensor]:
    """Packed JPEGs -> uint8 (H, W, 3) RGB tensors on ``device``: nvJPEG
    on a CUDA device, PIL on the CPU (the plain version)."""
    device = torch.device(device)
    if device.type == "cuda":
        return nvjpeg(device).decode(packed, offsets)
    return [_pil_decode(packed[offsets[i]:offsets[i + 1]])
            for i in range(len(offsets) - 1)]


def encode_images(images) -> list[bytes]:
    """uint8 (H, W, 3) RGB tensors -> JPEG bytes at ``QUALITY``, 4:2:0:
    nvJPEG's encoder for tensors on a card, PIL for CPU tensors."""
    out = []
    for image in images:
        if image.device.type == "cuda":
            out.append(nvjpeg(image.device).encode(image))
            continue
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(image.numpy()).save(buf, "JPEG", quality=QUALITY)
        out.append(buf.getvalue())
    return out


# ------------------------------------------------------- packed batches


@dataclasses.dataclass(frozen=True)
class JpegPlan:
    """What the decode stage does to a packed batch, after the resize to
    ``resize_min`` on the shorter side:

    - ``crop_u``: (B, 2) uniform draws in [0, 1) that pick the random
      crop's top and left (``floor(u · (limit + 1))``, uniform over the
      offsets as ``tf.image.random_crop``'s); None: the central crop;
    - ``flips``: (B,) coins, or None; ``jitter``: (B, 3) brightness,
      contrast and saturation factors, or None (the result rounds to
      integers, as the JAX ``_random_jitter`` does);
    - ``normalize``: None ships uint8 (``wire_uint8``); ``"torch"`` or
      ``"imagenet"`` ships float32 normalized (validation);
    - ``pad_to``: pad a short batch with zero rows and attach ``mask``."""

    size: int
    resize_min: int
    crop_u: np.ndarray | None = None
    flips: np.ndarray | None = None
    jitter: np.ndarray | None = None
    normalize: str | None = None
    pad_to: int | None = None


class PackedJpegBatch(dict):
    """A batch of JPEGs as it crosses to the device: ``jpeg`` (packed
    bytes), ``offsets`` and ``label`` arrays, and the :class:`JpegPlan`
    its decode stage follows. It is a packed batch of the device feed
    (``data/prefetch.py``): the feed runs :meth:`decode` on its side
    stream and counts :attr:`image_bytes` over :attr:`n_images` as its
    image bytes, on a ``"jpeg"`` wire."""

    wire_dtype = "jpeg"

    def __init__(self, blobs, labels, plan: JpegPlan):
        packed, offsets = pack(blobs)
        super().__init__(jpeg=packed, offsets=offsets,
                         label=np.asarray(labels, np.int32))
        self.plan = plan

    @property
    def n_images(self) -> int:
        return len(self["offsets"]) - 1

    @property
    def image_bytes(self) -> int:
        """The JPEGs' bytes."""
        return int(self["jpeg"].nbytes)

    def decode(self, device: torch.device) -> dict:
        """Decode, resize, crop, flip and jitter as planned -> the batch
        the JAX host stage yields, on ``device``: ``image`` (uint8, or
        float32 normalized) and ``label`` (and ``mask`` when padded)."""
        device = torch.device(device)
        plan = self.plan
        s = plan.size
        crops = []
        for i, img in enumerate(decode_images(self["jpeg"], self["offsets"],
                                              device)):
            h, w = resize_dims(img.shape[0], img.shape[1], plan.resize_min)
            if h < s or w < s:
                raise ValueError(f"resized image {h}x{w} is smaller than "
                                 f"the crop {s}")
            x = resize_bilinear(img, h, w)
            if plan.crop_u is None:
                top, left = (h - s) // 2, (w - s) // 2
            else:
                top = min(int(plan.crop_u[i, 0] * (h - s + 1)), h - s)
                left = min(int(plan.crop_u[i, 1] * (w - s + 1)), w - s)
            crops.append(x[top:top + s, left:left + s])
        x = (torch.stack(crops) if crops
             else torch.zeros((0, s, s, 3), device=device))
        if plan.flips is not None:
            flips = torch.from_numpy(np.asarray(plan.flips, bool))
            x = torch.where(flips.to(device)[:, None, None, None],
                            x.flip(2), x)
        if plan.jitter is not None:
            from deepvision_tpu_torch.data.device_aug import color_jitter

            f = torch.from_numpy(np.asarray(plan.jitter, np.float32)
                                 ).to(device)
            x = torch.round(color_jitter(x, f[:, 0], f[:, 1], f[:, 2])
                            ).clamp_(0.0, 255.0)
        if plan.normalize is None:
            x = wire_uint8(x)
        else:
            x = _normalize_f32(x, plan.normalize)
        batch = {"image": x,
                 "label": torch.from_numpy(self["label"]).to(device)}
        n = self.n_images
        if plan.pad_to is not None:
            pad = plan.pad_to - n
            if pad < 0:
                raise ValueError(f"batch of {n} exceeds pad target "
                                 f"{plan.pad_to}")
            batch = {k: torch.cat([v, v.new_zeros((pad, *v.shape[1:]))])
                     for k, v in batch.items()}
            mask = torch.zeros(plan.pad_to, dtype=torch.float32)
            mask[:n] = 1.0
            batch["mask"] = mask.to(device)
        return batch


def _normalize_f32(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The JAX reader's float32 normalization of [0, 255] pixels:
    ``"torch"`` is torchvision's mean and std of x / 255, ``"imagenet"``
    subtracts the channel means."""
    def const(values):
        return torch.tensor(values, dtype=torch.float32, device=x.device)

    if kind == "torch":
        return (x / 255.0 - const(TORCH_CHANNEL_MEANS)) \
            / const(TORCH_CHANNEL_STDS)
    if kind == "imagenet":
        return x - const(IMAGENET_CHANNEL_MEANS)
    raise ValueError(f"unknown normalization {kind!r}")
