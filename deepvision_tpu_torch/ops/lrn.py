"""Local Response Normalization (cross-channel), the AlexNet-era op.

The twin of ``deepvision_tpu/ops/lrn.py``. NHWC input, normalised over
the trailing channel axis with torch semantics:
``b_c = a_c / (k + (alpha/n) * sum_{c'} a_{c'}^2)^beta``, the sum over a
window of ``n`` channels centred at ``c`` (``n//2`` to the left,
``n-1-n//2`` to the right, zero beyond the edges).

:func:`local_response_norm` runs the hand-written CUDA kernel
(``ops/lrn_cuda.py``) on a CUDA tensor and the plain PyTorch version on
a CPU tensor. It never swaps one for the other: a CUDA tensor the
kernel cannot take raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepvision_tpu_torch.ops.lrn_cuda import local_response_norm_cuda

__all__ = ["local_response_norm", "local_response_norm_reference"]


def local_response_norm_reference(x: torch.Tensor, size: int = 5,
                                  alpha: float = 1e-4, beta: float = 0.75,
                                  k: float = 2.0) -> torch.Tensor:
    """The plain PyTorch version: float32 math, output in ``x.dtype``."""
    x32 = x.float()
    half = size // 2
    sq = F.pad(x32 * x32, (half, size - 1 - half))
    sums = sq.unfold(-1, size, 1).sum(-1)
    denom = torch.pow(k + (alpha / size) * sums, beta)
    return (x32 / denom).to(x.dtype)


def local_response_norm(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return local_response_norm_reference(x, size, alpha, beta, k)
    return local_response_norm_cuda(x, size, alpha, beta, k)
