"""Stress of the nvJPEG sequence that aborted ``chip_smoke.py`` once
(ROADMAP C29), on one CUDA card: each round decodes a grayscale JPEG,
encodes at quality 95, decodes batches of 258 and 192, decodes batches
of 256 and 100 from a second thread on a side stream, and encodes at 90.
Mode ``one``: the process's one encoder, its quality set on each call
(``data/jpeg.NvJpeg``); mode ``two``: a second encoder, with a library
handle of its own, for quality 95 (the layout of the run that aborted).

    python3 nvjpeg_stress.py one 40
    python3 nvjpeg_stress.py two 40

Prints one line with the rounds and seconds; an abort ends the process
with the signal's code."""

import ctypes
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def main(mode: str, rounds: int) -> int:
    import torch

    if not torch.cuda.is_available():
        print("nvjpeg_stress: no CUDA device visible", file=sys.stderr)
        return 1

    import chip_smoke
    from deepvision_tpu_torch.data import jpeg
    from deepvision_tpu_torch.data.synthetic_records import synthetic_image

    dev = torch.device("cuda")
    nv = jpeg.nvjpeg(dev)
    second = None
    if mode == "two":
        second = ctypes.c_void_p()
        assert nv.lib.dv_nvjpeg_encoder_create(ctypes.byref(second)) == 0

    def encode95(img):
        if second is None:
            return nv.encode(img, 95)
        saved = nv._encoder
        nv._encoder = second
        try:
            return nv.encode(img, 95)
        finally:
            nv._encoder = saved

    rng = np.random.default_rng(0)
    imgs = [synthetic_image(rng, int(rng.integers(224, 320)),
                            int(rng.integers(224, 320)), i, dev)
            for i in range(450)]
    blobs = jpeg.encode_images(imgs)
    gray = np.repeat(np.repeat(np.arange(0, 240, 8, dtype=np.uint8)
                               .reshape(5, 6), 8, 0), 8, 1)
    gblob = chip_smoke._gray_jpeg(gray)
    t0 = time.perf_counter()
    for r in range(rounds):
        (g,) = jpeg.decode_images(*jpeg.pack([gblob]), dev)
        e = [encode95(g.contiguous()), encode95(imgs[r % 450])]
        b = blobs[:256] + e
        jpeg.decode_images(*jpeg.pack(b), dev)
        jpeg.decode_images(*jpeg.pack(blobs[256:448]), dev)
        out = []

        def side():
            s = torch.cuda.Stream(dev)
            with torch.cuda.stream(s):
                out.append(jpeg.decode_images(*jpeg.pack(blobs[:256]), dev))
                out.append(jpeg.decode_images(*jpeg.pack(blobs[:100]), dev))
            s.synchronize()

        t = threading.Thread(target=side)
        t.start()
        t.join()
        jpeg.encode_images(imgs[:2])
    torch.cuda.synchronize()
    print(f"[nvjpeg-stress] mode {mode}: {rounds} rounds in "
          f"{time.perf_counter() - t0:.1f} s, no abort", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
