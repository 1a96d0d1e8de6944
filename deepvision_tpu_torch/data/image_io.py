"""Image bytes for the port: the uint8 wire's quantization, JPEG headers,
PNG read and write, and the builders' RGB-JPEG repair.

:func:`wire_uint8` is the twin of ``tf_wire_uint8`` in
``deepvision_tpu/data/image_io.py``: every reader that ships uint8 images
over the host-to-device link goes through it (round half to even, as
``tf.round`` and ``torch.round``; clip to [0, 255]; cast), and the
device-side twins (``data/device_aug.py``'s re-rounding after jitter and
mixup) use the same expression.

:func:`ensure_rgb_jpeg` is the twin of the JAX builders' PIL repair: an
RGB JPEG keeps its bytes, anything else (a grayscale or CMYK JPEG, a PNG
under a ``.JPEG`` name) is re-encoded as an RGB JPEG at quality 95. The
keep-or-re-encode decision and the size come from the file's own
header (:func:`jpeg_header`: the SOF segment's component count, as PIL
decides its mode; :func:`png_header`), read with the standard library.
The re-encode is PIL's on the CPU, byte for byte the JAX builders'; on a
card it is nvJPEG's decode and encode (``data/jpeg.py``) and, for a PNG,
:func:`read_png`, a standard-library PNG decoder (zlib and the five row
filters), since the card's machine has no PIL. A four-component (CMYK
or YCCK) JPEG has no decoder on the card and raises there, as does a
file that is neither JPEG nor PNG: the builders report such a file by
name and reason.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

__all__ = ["wire_uint8", "jpeg_header", "png_header", "read_png",
           "encode_png", "ensure_rgb_jpeg", "REENCODE_QUALITY"]

# the JAX builders' re-encode quality (PIL's ``quality=95``)
REENCODE_QUALITY = 95
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the SOF markers (every 0xFFCn but DHT, JPG and DAC)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}
# markers that carry no length: TEM, RST0-7, SOI
_BARE = {0x01, *range(0xD0, 0xD9)}


def wire_uint8(images):
    """float pixels in [0, 255] (a torch tensor) -> uint8: round half to
    even, clip, cast."""
    return images.round().clamp_(0.0, 255.0).to(dtype=_torch().uint8)


def _torch():
    # imported on first use: a builder's spawned worker that keeps an RGB
    # JPEG's bytes never needs torch, and starts in a fraction of the time
    import torch

    return torch


# ------------------------------------------------------------------ JPEG


def jpeg_header(data: bytes) -> dict | None:
    """A JPEG's frame header, read from its markers up to the scan:
    ``{"height", "width", "components", "precision", "progressive",
    "adobe_transform"}`` (the APP14 Adobe segment's colour transform, or
    None without one). None when ``data`` is not a JPEG (no SOI);
    raises ``ValueError`` on a JPEG with no readable frame header."""
    if data[:3] != b"\xff\xd8\xff":
        return None
    pos, n = 2, len(data)
    adobe = None
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker in _BARE:
            continue
        if pos + 2 > n:
            break
        length = struct.unpack_from(">H", data, pos)[0]
        seg = data[pos + 2:pos + length]
        if marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        if marker in _SOF:
            if len(seg) < 6:
                break
            precision, height, width, comps = struct.unpack_from(">BHHB",
                                                                 seg)
            return {"height": height, "width": width, "components": comps,
                    "precision": precision,
                    "progressive": marker in (0xC2, 0xC6, 0xCA, 0xCE),
                    "adobe_transform": adobe}
        if marker == 0xDA:  # the scan starts before any frame header
            break
        pos += length
    raise ValueError("JPEG without a readable frame (SOF) header")


# ------------------------------------------------------------------- PNG


def _png_chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack_from(">I", data, pos + 8 + length)[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before IEND")


def png_header(data: bytes) -> dict | None:
    """A PNG's IHDR: ``{"height", "width", "bit_depth", "color_type",
    "interlace"}``; None when ``data`` is not a PNG."""
    if data[:8] != PNG_SIGNATURE:
        return None
    if data[12:16] != b"IHDR":
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = struct.unpack_from(
        ">IIBBBBB", data, 16)
    return {"height": height, "width": width, "bit_depth": depth,
            "color_type": ctype, "interlace": interlace}


# samples a pixel by colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters -> (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if len(rows) < h * (stride + 1):
        raise ValueError("PNG image data is short")
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum, per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: byte by byte
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                    continue
                c = up[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def read_png(data: bytes) -> np.ndarray:
    """A PNG -> uint8 (H, W, 3) RGB, as PIL's ``convert("RGB")`` gives
    it: alpha dropped, a palette looked up, gray repeated, a 16-bit
    colour sample's high byte, gray below 8 bits scaled to [0, 255].
    Interlaced images and 16-bit gray raise ``ValueError``."""
    header = png_header(data)
    if header is None:
        raise ValueError("not a PNG")
    h, w, depth, ctype = (header[k] for k in ("height", "width",
                                              "bit_depth", "color_type"))
    if header["interlace"]:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not one of 0, 2, 3, "
                         "4, 6")
    if depth == 16 and ctype in (0, 4):
        raise ValueError("16-bit gray PNG is not supported")
    if depth not in (1, 2, 4, 8, 16) or (depth < 8 and ctype not in (0, 3)):
        raise ValueError(f"PNG bit depth {depth} with colour type {ctype}")
    palette = None
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    channels = _PNG_CHANNELS[ctype]
    bits = channels * depth
    stride = (w * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                     max(1, bits // 8))
    if depth < 8:
        samples = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint8)
        values = (samples[:, :w] * weights).sum(-1).astype(np.uint8)
        if ctype == 0:
            values = values * np.uint8(255 // ((1 << depth) - 1))
        pix = values[..., None]
    elif depth == 16:
        pix = rows.reshape(h, w, channels, 2)[..., 0]  # the high byte
    else:
        pix = rows.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        index = pix[..., 0]
        if index.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[index]
    if ctype in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 (H, W, C) pixels, C 1 (gray), 3 (RGB) or 4 (RGBA) -> PNG
    bytes: 8 bits a sample, every row under filter 0 (None), zlib at its
    default level."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, not {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * c)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))


# ------------------------------------------------------------ the repair


def _pil_rgb_jpeg(data: bytes) -> tuple[bytes, int, int]:
    """The JAX builders' repair, as it is (PIL)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    width, height = img.size
    if data[:2] == b"\xff\xd8" and img.format == "JPEG" and img.mode == "RGB":
        return data, width, height
    buf = io.BytesIO()
    img.convert("RGB").save(buf, "JPEG", quality=REENCODE_QUALITY)
    return buf.getvalue(), width, height


def ensure_rgb_jpeg(data: bytes, device="cpu") -> tuple[bytes, int, int]:
    """-> (RGB JPEG bytes, width, height). An RGB (3-component) JPEG
    keeps its bytes; anything else is re-encoded at quality 95: by PIL
    on the CPU (the JAX builders' bytes), by nvJPEG on a CUDA ``device``
    (a 1-component JPEG decoded by nvJPEG, a PNG by :func:`read_png`).
    Raises on a file it cannot convert (the builders' reported skip)."""
    if getattr(device, "type", str(device).split(":")[0]) != "cuda":
        return _pil_rgb_jpeg(data)
    header = jpeg_header(data)
    if header is not None and header["components"] == 3:
        return data, header["width"], header["height"]
    # a re-encode, with torch and nvJPEG (imported only here)
    from deepvision_tpu_torch.data.jpeg import decode_images, nvjpeg, pack

    torch = _torch()
    device = torch.device(device)
    if header is not None:
        if header["components"] != 1:
            raise ValueError(f"{header['components']}-component JPEG "
                             "(CMYK or YCCK) has no decoder on the card")
        (rgb,) = decode_images(*pack([data]), device)
    elif png_header(data) is not None:
        rgb = torch.from_numpy(read_png(data)).to(device)
    else:
        raise ValueError("neither a JPEG nor a PNG")
    h, w = rgb.shape[:2]
    return nvjpeg(device).encode(rgb, REENCODE_QUALITY), w, h
