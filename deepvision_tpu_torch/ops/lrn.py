"""Local Response Normalization (cross-channel), the AlexNet-era op.

The twin of ``deepvision_tpu/ops/lrn.py`` and of the ``custom_vjp`` in
``ops/lrn_pallas.py``. NHWC input, normalised over the trailing channel
axis with torch semantics:
``b_c = a_c / (k + (alpha/n) * sum_{c'} a_{c'}^2)^beta``, the sum over a
window of ``n`` channels centred at ``c`` (``n//2`` to the left,
``n-1-n//2`` to the right, zero beyond the edges).

The forward and the backward are ``torch.library`` custom ops,
``deepvision::lrn_forward`` and ``deepvision::lrn_backward``, so that
``torch.export`` keeps each one a node of its graph (``export.py``) in
place of tracing into the ctypes launch or the plain version. Each has a
``cpu`` implementation, the plain PyTorch version, a ``cuda`` one, the
hand-written kernel (``ops/lrn_cuda.py``: ``csrc/lrn.cu`` forward,
``csrc/lrn_bwd.cu`` backward), and a fake one that gives the shape and
dtype alone. The window and the constants are op arguments, which an
exported graph holds as constants. The forward's gradient is registered
with ``register_autograd``: like the JAX ``_fwd`` it saves only x, and
the backward op recomputes the denominator. A CPU tensor takes the plain
versions both ways, so the CPU tests run the same analytic backward as
the card; a CUDA tensor the kernels both ways, and one that they cannot
take raises. No other device has an implementation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepvision_tpu_torch.ops.lrn_cuda import (
    local_response_norm_backward_cuda,
    local_response_norm_cuda,
)

__all__ = ["local_response_norm", "local_response_norm_reference",
           "local_response_norm_backward_reference", "lrn_forward",
           "lrn_backward"]


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 math for float32 and narrower inputs; float64 stays
    float64 (``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _window_sum(v: torch.Tensor, size: int,
                mirrored: bool = False) -> torch.Tensor:
    """Channel-window sum with torch centring; ``mirrored`` swaps the
    padding offsets (the adjoint window of the backward pass), as
    ``lrn_pallas._window_sum``."""
    half = size // 2
    lo, hi = (size - 1 - half, half) if mirrored else (half, size - 1 - half)
    return F.pad(v, (lo, hi)).unfold(-1, size, 1).sum(-1)


def local_response_norm_reference(x: torch.Tensor, size: int = 5,
                                  alpha: float = 1e-4, beta: float = 0.75,
                                  k: float = 2.0) -> torch.Tensor:
    """The plain PyTorch forward: float32 math, output in ``x.dtype``."""
    xm = x.to(_math_dtype(x.dtype))
    denom = torch.pow(k + (alpha / size) * _window_sum(xm * xm, size), beta)
    return (xm / denom).to(x.dtype)


def local_response_norm_backward_reference(
        x: torch.Tensor, g: torch.Tensor, size: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """The plain PyTorch backward, the twin of ``lrn_pallas._bwd``: with
    d = k + (alpha/n)·S(x²),
    ``dx = g·d^−β − (2αβ/n)·x·S̃(g·x·d^(−β−1))``, S̃ the mirrored window.
    float32 math, dx in ``x.dtype``."""
    dtype = _math_dtype(x.dtype)
    xm, gm = x.to(dtype), g.to(dtype)
    d = k + (alpha / size) * _window_sum(xm * xm, size)
    d_mb = torch.exp(-beta * torch.log(d))
    adj = _window_sum(gm * xm * d_mb / d, size, mirrored=True)
    dx = gm * d_mb - (2.0 * alpha * beta / size) * xm * adj
    return dx.to(x.dtype)


@torch.library.custom_op("deepvision::lrn_forward", mutates_args=(),
                         device_types="cpu")
def lrn_forward(x: torch.Tensor, size: int, alpha: float, beta: float,
                k: float) -> torch.Tensor:
    """The LRN op; on the CPU the plain forward."""
    return local_response_norm_reference(x, size, alpha, beta, k)


@lrn_forward.register_kernel("cuda")
def _lrn_forward_cuda(x, size, alpha, beta, k):
    return local_response_norm_cuda(x, size, alpha, beta, k)


@lrn_forward.register_fake
def _lrn_forward_fake(x, size, alpha, beta, k):
    return torch.empty_like(x)


@torch.library.custom_op("deepvision::lrn_backward", mutates_args=(),
                         device_types="cpu")
def lrn_backward(x: torch.Tensor, g: torch.Tensor, size: int, alpha: float,
                 beta: float, k: float) -> torch.Tensor:
    """The LRN's gradient op; on the CPU the plain backward."""
    return local_response_norm_backward_reference(x, g, size, alpha, beta, k)


@lrn_backward.register_kernel("cuda")
def _lrn_backward_cuda(x, g, size, alpha, beta, k):
    # layout, not a fallback: the gradient that reaches the LRN from
    # max_pool2d's backward on the NCHW view can be NCHW in memory, and
    # the kernel reads NHWC rows
    return local_response_norm_backward_cuda(x, g.contiguous(), size, alpha,
                                             beta, k)


@lrn_backward.register_fake
def _lrn_backward_fake(x, g, size, alpha, beta, k):
    return torch.empty_like(x)


def _save_x(ctx, inputs, output):
    x, *lrn = inputs
    ctx.save_for_backward(x)
    ctx.lrn = lrn


def _lrn_grad(ctx, g):
    (x,) = ctx.saved_tensors
    return lrn_backward(x, g, *ctx.lrn), None, None, None, None


lrn_forward.register_autograd(_lrn_grad, setup_context=_save_x)


def local_response_norm(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 2.0) -> torch.Tensor:
    """``deepvision::lrn_forward``: the kernels for a CUDA tensor, the
    plain versions for a CPU one, forward and backward."""
    return lrn_forward(x, size, alpha, beta, k)
