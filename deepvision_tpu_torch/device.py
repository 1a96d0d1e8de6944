"""Device choice and the float32 policy of the port's entry points.

The port runs on the card. ``resolve_device`` never falls back to the
CPU: ``"cpu"`` is honoured only when the caller asks for it (the CPU
tests do), and a missing card is an error.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "strict_fp32"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a visible card
    raises; ``"cpu"`` is returned as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepvision_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def strict_fp32() -> dict:
    """Serve in true float32: turn TF32 off for cuDNN convolutions and
    cuBLAS matmuls. cuDNN's default is TF32 (about three decimal
    digits), which moves logits beyond the float32 tolerances the port
    is held to. Returns the settings as applied."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
