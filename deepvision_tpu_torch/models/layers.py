"""Layer helpers of the port, on NHWC tensors like their JAX twins.

Activations stay contiguous NHWC between layers. A convolution or a
pool runs on the NCHW view ``x.permute(0, 3, 1, 2)``, which has
``torch.channels_last`` memory, so the view costs no copy and cuDNN
writes its output in the same layout; permuting back gives a contiguous
NHWC tensor again.

Mixed precision follows flax's ``dtype`` convention: parameters stay
float32 masters and are cast to the compute ``dtype`` at use, inside the
forward (:func:`conv2d`, :func:`dense`), so their gradients flow back
through the cast as float32. :class:`MixedBatchNorm` keeps its
statistics and its affine in float32 and casts them at use too;
:class:`BatchNorm`, flax's stock layer, normalizes in float32 and casts
only its output (trap C8).

XLA's ``"SAME"`` padding is asymmetric under a stride (trap C2): the
pads are spelled out by :func:`same_padding` and applied explicitly.
flax's ``ConvTranspose(padding="SAME")`` is the same trap over a dilated
input: :func:`conv_transpose_same` runs it as torch's transposed
convolution of the spatially flipped kernel with the trailing rows and
columns cropped, which torch's own ``padding``/``output_padding`` cannot
express. :class:`InstanceNorm` is flax's, with its eps of 1e-6.

Rematerialization (:func:`remat`) runs a region under
``torch.utils.checkpoint`` and recomputes it in the backward. Both
BatchNorms update their running statistics in place in the forward, so
the recompute would apply the momentum a second time (trap C11); while a
region is recomputed (:func:`recomputing`) they normalize by the batch as
before and skip the update, as flax's functional ``nn.remat`` updates
once.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

__all__ = ["conv2d", "dense", "dropout", "max_pool", "avg_pool",
           "global_avg_pool", "upsample2x", "same_padding", "make_conv",
           "conv_padding", "same_conv",
           "lecun_normal_", "he_normal_", "xavier_uniform_", "normal_",
           "MixedBatchNorm", "BatchNorm",
           "ConvBN", "init_weights", "REMAT_POLICIES", "CONV_OUT",
           "recomputing", "remat", "ConvTranspose", "conv_transpose_padding",
           "conv_transpose_same", "reflect_pad", "InstanceNorm"]

Padding = str | Sequence[tuple[int, int]]


def _explicit_pads(padding: Padding) -> tuple[int, ...] | None:
    """``"VALID"`` or pairs of zeros -> None (``F.pad`` would copy the
    tensor for nothing); ``[(top, bottom), (left, right)]`` -> the
    ``F.pad`` tuple for the H and W axes of an NHWC tensor."""
    if isinstance(padding, str):
        if padding.upper() != "VALID":
            raise ValueError(
                f"padding must be 'VALID' or explicit (lo, hi) pairs, got "
                f"{padding!r}")
        return None
    (top, bottom), (left, right) = padding
    if not any((top, bottom, left, right)):
        return None
    return (0, 0, left, right, top, bottom)


def _cast(p: torch.Tensor | None, dtype: torch.dtype | None):
    return p if p is None or dtype is None else p.to(dtype)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, padding: Padding = "VALID",
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """``conv`` over an NHWC tensor; ``padding`` is applied explicitly
    (zeros) before a convolution whose own padding does the rest. With
    ``dtype`` the weights are cast to it at use (the input must already
    be in it)."""
    pads = _explicit_pads(padding)
    if pads is not None:
        x = F.pad(x, pads)
    y = F.conv2d(x.permute(0, 3, 1, 2), _cast(conv.weight, dtype),
                 _cast(conv.bias, dtype), conv.stride, conv.padding,
                 groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def dense(x: torch.Tensor, linear: nn.Linear,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """``linear`` with its weights cast to ``dtype`` at use."""
    return F.linear(x, _cast(linear.weight, dtype), _cast(linear.bias, dtype))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax's ``nn.Dropout``: identity unless training with ``rate`` > 0;
    then each value is kept with probability ``1 - rate`` (the mask drawn
    from ``generator``, which the train step passes in) and scaled by
    ``1 / (1 - rate)``."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs an explicit generator")
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def max_pool(x: torch.Tensor, window: tuple[int, int] = (2, 2),
             strides: tuple[int, int] | None = None,
             padding: Padding = "VALID") -> torch.Tensor:
    """Max pool over H and W of an NHWC tensor. Explicit padding pads
    with -inf, so a padded cell never wins (XLA's SAME pads a stride-2
    pool asymmetrically; callers spell those pads out)."""
    pads = _explicit_pads(padding)
    own = (0, 0)
    if pads is not None:
        (top, bottom), (left, right) = padding
        if top == bottom <= window[0] // 2 and left == right <= window[1] // 2:
            own = (top, left)  # symmetric: the pool's own -inf padding
        else:
            x = F.pad(x, pads, value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, strides or window, own)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: tuple[int, int] = (2, 2),
             strides: tuple[int, int] | None = None,
             padding: Padding = "VALID") -> torch.Tensor:
    """flax's ``nn.avg_pool`` over H and W of an NHWC tensor: each
    window's sum over the window's full size, explicit pads counted as
    zeros (flax's ``count_include_pad=True``; XLA's SAME pads of a
    stride-2 pool are asymmetric, and callers spell them out)."""
    pads = _explicit_pads(padding)
    if pads is not None:
        x = F.pad(x, pads)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, strides or window)
    return y.permute(0, 2, 3, 1)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, ``(B, H, W, C) -> (B, C)``, accumulated in
    float32 and cast back to ``x.dtype``."""
    return x.mean(dim=(1, 2), dtype=torch.float32).to(x.dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x of an NHWC tensor: each value repeated over
    a 2x2 block, which is what ``jax.image.resize(..., "nearest")`` gives
    at exactly twice the size."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def same_padding(in_hw: Sequence[int], window: Sequence[int],
                 strides: Sequence[int]) -> list[tuple[int, int]]:
    """XLA's ``"SAME"`` pads ``[(top, bottom), (left, right)]`` of a
    window over ``in_hw``: ``ceil(in / s)`` outputs, a total pad of
    ``max((ceil(in / s) - 1)·s + k - in, 0)``, its smaller half first.
    Under stride 2 that is asymmetric where torch pads symmetrically: a
    3x3/2 window pads 112 by (0, 1), a 7x7/2 one 224 by (2, 3)."""
    pads = []
    for n, k, s in zip(in_hw, window, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def make_conv(in_features: int, features: int, kernel: tuple[int, int],
              strides: tuple[int, int] = (1, 1), padding: Padding = "SAME",
              bias: bool = True, groups: int = 1) -> nn.Conv2d:
    """The ``nn.Conv2d`` of flax's ``nn.Conv(features, kernel, strides,
    padding, feature_group_count=groups)``: a grouped kernel is ``(O,
    I/groups, KH, KW)`` against flax's ``(KH, KW, I/groups, O)``, so the
    converter's transpose carries it as any other. Symmetric pads
    (explicit ones, or a stride-1 ``"SAME"`` over an odd kernel) are the
    convolution's own; any other padding is applied by :func:`conv2d`
    with what :func:`conv_padding` gives."""
    own = 0
    if padding == "SAME":
        if all(s == 1 and k % 2 for k, s in zip(kernel, strides)):
            own = [k // 2 for k in kernel]
    elif not isinstance(padding, str) and all(lo == hi for lo, hi in padding):
        own = [lo for lo, _ in padding]
    return nn.Conv2d(in_features, features, kernel, strides, padding=own,
                     bias=bias, groups=groups)


def conv_padding(x: torch.Tensor, conv: nn.Conv2d,
                 padding: Padding) -> Padding:
    """The padding :func:`conv2d` applies to NHWC ``x`` for ``conv``
    built by :func:`make_conv` with ``padding``: none where the
    convolution pads itself, XLA's ``"SAME"`` pads at ``x``'s size, or
    the explicit pairs as given."""
    if padding == "VALID" or any(conv.padding):
        return "VALID"
    if padding == "SAME":
        return same_padding(x.shape[1:3], conv.kernel_size, conv.stride)
    return padding


def same_conv(x: torch.Tensor, conv: nn.Conv2d,
              dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax's ``nn.Conv(..., padding="SAME", dtype=dtype)`` over NHWC
    ``x`` for ``conv`` built by :func:`make_conv` with ``"SAME"``: ``x``
    cast to ``dtype`` (flax casts its input), XLA's SAME pads, the
    weights cast at use; float32 throughout without a ``dtype``."""
    x = x.to(dtype or torch.float32)
    return conv2d(x, conv, conv_padding(x, conv, "SAME"), dtype)


class ConvTranspose(nn.Conv2d):
    """The parameters of flax's ``nn.ConvTranspose(features, kernel,
    strides)`` (``transpose_kernel=False``), applied by
    :func:`conv_transpose_same`. flax keeps the kernel as ``(KH, KW, I,
    O)`` and applies it unflipped; the weight here is that kernel in the
    plain convolution's layout ``(O, I, KH, KW)``, so the converter and
    the initializers treat it as a convolution's (fan-in ``I·KH·KW``,
    as flax counts it), and :func:`conv_transpose_same` flips it and
    swaps its axes at use. The stride is the module's ``stride``."""

    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int], strides: tuple[int, int] = (1, 1),
                 bias: bool = True):
        super().__init__(in_features, features, kernel, strides, bias=bias)


def conv_transpose_padding(k: int, s: int) -> tuple[int, int]:
    """``lax``'s ``_conv_transpose_padding`` for ``"SAME"``: the (before,
    after) zeros around the stride-dilated input, (2, 2) for k=5, s=1,
    (3, 2) for k=5, s=2 and (2, 1) for k=3, s=2."""
    total = k + s - 2
    before = k - 1 if s > k - 1 else -(-total // 2)
    return before, total - before


def conv_transpose_same(x: torch.Tensor, conv: ConvTranspose,
                        dtype: torch.dtype | None = None) -> torch.Tensor:
    """flax's ``nn.ConvTranspose(..., padding="SAME")`` over NHWC ``x``:
    ``s·H`` x ``s·W`` out. flax convolves the stride-dilated input with
    the unflipped kernel between ``conv_transpose_padding`` zeros; torch's
    transposed convolution correlates with the flipped kernel, so the
    kernel is flipped first, pads of ``k - 1 - before`` give ``before``
    zeros on each side, and the output is cropped (or, where ``after`` >
    ``before``, extended) at its end by the difference (trap C2). With
    ``dtype`` the input and weights are cast to it."""
    pads = [conv_transpose_padding(k, s)
            for k, s in zip(conv.kernel_size, conv.stride)]
    weight = _cast(conv.weight, dtype).transpose(0, 1).flip(2, 3)
    extra = [after - before for before, after in pads]
    if dtype is not None:
        x = x.to(dtype)
    y = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), weight, _cast(conv.bias, dtype), conv.stride,
        padding=[k - 1 - before for k, (before, _) in
                 zip(conv.kernel_size, pads)],
        output_padding=[max(e, 0) for e in extra])
    h, w = y.shape[2] + min(extra[0], 0), y.shape[3] + min(extra[1], 0)
    return y[:, :, :h, :w].permute(0, 2, 3, 1)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(mode="reflect")`` of H and W of an NHWC tensor by
    ``pad`` a side (the edge row is not repeated)."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return y.permute(0, 2, 3, 1)


class InstanceNorm(nn.Module):
    """flax's ``nn.InstanceNorm`` over an NHWC tensor: each sample's
    channels normalized by their own E[x] and E[x²] - E[x]² (clamped at
    0) over H and W of the float32 input, then ``(x - mean)·(rsqrt(var +
    eps)·scale) + bias`` in float32 and the result cast to ``dtype``.
    eps is flax's 1e-6, not torch's 1e-5: on a channel of low variance
    the two differ. ``scale`` and ``bias`` are float32 parameters named
    as flax's; there are no running statistics."""

    def __init__(self, features: int, eps: float = 1e-6, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train  # the same in training and evaluation
        x = x.float()
        mean = x.mean((1, 2), keepdim=True)
        var = torch.clamp((x * x).mean((1, 2), keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mean) * mul + self.bias).to(self.dtype)


# stddev of a standard normal truncated to (-2, 2), which flax's
# variance_scaling divides out so that the truncated draw keeps the
# asked-for variance
_TRUNC_STD = 0.87962566103423978


def _truncated_normal_(weight: torch.Tensor, variance: float,
                       generator: torch.Generator) -> None:
    std = math.sqrt(variance) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``lecun_normal`` (its default kernel init): variance
    1/fan_in, truncated to two standard deviations. fan_in is the
    product of every axis but the output one, as flax counts it for a
    conv ``(KH, KW, I, O)`` or a Dense ``(in, out)`` kernel."""
    _truncated_normal_(weight, 1.0 / weight[0].numel(), generator)


def he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``variance_scaling(2.0, "fan_out", "truncated_normal")``,
    the JAX ``ConvBN``'s kernel init: variance 2/fan_out, truncated to
    two standard deviations. fan_out is the output axis times the
    receptive field, as flax counts it for a conv ``(KH, KW, I, O)`` or
    a Dense ``(in, out)`` kernel."""
    fan_out = weight.shape[0] * weight[0, 0].numel()
    _truncated_normal_(weight, 2.0 / fan_out, generator)


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's ``xavier_uniform`` (``variance_scaling(1.0, "fan_avg",
    "uniform")``): uniform on ``±sqrt(3 / fan_avg)``, ``fan_avg`` the
    mean of fan_in and fan_out as :func:`lecun_normal_` and
    :func:`he_normal_` count them."""
    fan_in = weight[0].numel()
    fan_out = weight.shape[0] * weight[0, 0].numel()
    limit = math.sqrt(3.0 / ((fan_in + fan_out) / 2))
    nn.init.uniform_(weight, -limit, limit, generator=generator)


def normal_(stddev: float):
    """flax's ``normal(stddev)``: a kernel init drawing N(0, stddev²),
    untruncated."""

    def init(weight: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.normal_(weight, 0.0, stddev, generator=generator)

    return init


class _BatchNorm(nn.Module):
    """What both BatchNorms share: ``scale`` and ``bias``, float32
    parameters, and ``mean`` and ``var``, float32 buffers, named as
    flax's ``params`` and ``batch_stats`` leaves; flax's running update
    ``ra = momentum·ra + (1 - momentum)·batch`` (torch's momentum is 1 -
    flax's) with the biased batch variance (trap C1)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def _statistics(self, x: torch.Tensor, train: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Training: the batch's E[x] and E[x²] - E[x]² clamped at 0,
        over every axis but the last, with float32 accumulators, and the
        running statistics updated in place. Otherwise the running
        statistics."""
        if not train:
            return self.mean, self.var
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dims, dtype=torch.float32)
        mean2 = (x * x).mean(dims, dtype=torch.float32)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if _recompute.depth:  # the forward already updated them (C11)
            return mean, var
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return mean, var


class MixedBatchNorm(_BatchNorm):
    """BatchNorm over the channels of an NHWC tensor, computed as the JAX
    package's ``MixedBatchNorm``, which ``torch.nn.BatchNorm2d`` is not
    (trap C1): the running variance takes the biased batch variance,
    and ``momentum`` is flax's (``ra = momentum·ra + (1 - momentum)·
    batch``, torch's 1 - momentum).

    ``train``: normalize by the batch's moments, E[x] and E[x²] - E[x]²
    clamped at 0, taken with float32 accumulators (a bf16 input is
    squared in bf16, as the JAX twin squares it), and update the running
    ``mean`` and ``var`` in place. Otherwise normalize by the running
    statistics. A float32 input takes flax's stock expression
    ``(x - mean)·(rsqrt(var + eps)·scale) + bias``; any other dtype the
    channel affine folded in float32, cast once, and one ``x·mul +
    shift`` in that dtype. ``scale`` and ``bias`` are float32 parameters
    and ``mean`` and ``var`` float32 buffers, named as flax's ``params``
    and ``batch_stats`` leaves."""

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        mean, var = self._statistics(x, train)
        mul = torch.rsqrt(var + self.eps) * self.scale
        if x.dtype == torch.float32:
            return (x - mean) * mul + self.bias
        shift = self.bias - mean * mul
        return torch.addcmul(shift.to(x.dtype), x, mul.to(x.dtype))


class BatchNorm(_BatchNorm):
    """flax's stock ``nn.BatchNorm`` (``_compute_stats`` and
    ``_normalize`` of flax 0.12) over the channels of an NHWC tensor,
    under the names of :class:`MixedBatchNorm`. Where that one keeps a
    bf16 input in bf16, this one casts it to float32 first (trap C8):
    the statistics are E[x] and E[x²] - E[x]² of the float32 input, the
    apply ``(x - mean)·(rsqrt(var + eps)·scale) + bias`` runs in
    float32, and only the result is cast, to ``dtype`` (flax's explicit
    ``dtype``; every site of the zoo gives one). In float32 the two
    layers compute the same expression."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, *, dtype: torch.dtype):
        super().__init__(features, momentum, eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        mean, var = self._statistics(x, train)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mean) * mul + self.bias).to(self.dtype)


class ConvBN(nn.Module):
    """The JAX ``ConvBN``: a convolution without bias (``conv``, over
    ``groups`` channel groups: ``in_features`` for a depthwise one),
    then :class:`MixedBatchNorm` (``bn``, momentum 0.9, eps 1e-5), then
    ``act`` (ReLU; None for none), in the compute ``dtype``. Fresh
    kernels are ``he_normal``."""

    kernel_init = staticmethod(he_normal_)

    def __init__(self, in_features: int, features: int,
                 kernel: tuple[int, int] = (3, 3),
                 strides: tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", act=torch.relu,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__()
        self.conv = make_conv(in_features, features, kernel, strides,
                              padding, bias=False, groups=groups)
        self.bn = MixedBatchNorm(features)
        self.padding = padding
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = conv2d(x, self.conv, conv_padding(x, self.conv, self.padding),
                   self.dtype)
        x = self.bn(x, train)
        return x if self.act is None else self.act(x)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator,
                 kernel_init=None) -> None:
    """Fresh weights from ``generator`` as the model's JAX twin declares
    them: each Conv2d and Linear by the ``kernel_init`` of its nearest
    enclosing module that declares one (the AlexNets and Inception V1
    keep flax's default, :func:`lecun_normal_`; :class:`ConvBN` declares
    :func:`he_normal_`; a layer may declare its own), biases at the
    layer's ``bias_init`` (0 where it declares none), and every
    BatchNorm (either kind)
    at scale 1, bias 0, mean 0 and var 1, and every InstanceNorm at scale
    1 and bias 0. Modules are visited in
    registration order. Works on a module whose storage is
    uninitialised (``to_empty``)."""
    kernel_init = getattr(module, "kernel_init", kernel_init)
    if isinstance(module, (nn.Conv2d, nn.Linear)):
        kernel_init(module.weight, generator)
        if module.bias is not None:
            module.bias.fill_(getattr(module, "bias_init", 0.0))
    elif isinstance(module, (_BatchNorm, InstanceNorm)):
        module.reset_parameters()
    for child in module.children():
        init_weights(child, generator, kernel_init)


# -------------------------------------------------- rematerialization


class _RecomputeDepth(threading.local):
    """How many rematerialized regions this thread is recomputing (the
    autograd engine recomputes in the thread that runs the backward)."""

    depth = 0


_recompute = _RecomputeDepth()


@contextlib.contextmanager
def recomputing():
    """The recompute of a rematerialized region: BatchNorm skips its
    running update inside (trap C11)."""
    _recompute.depth += 1
    try:
        yield
    finally:
        _recompute.depth -= 1


# The "conv_out" of the JAX ``ConvBN`` (``checkpoint_name(x,
# "conv_out")`` on its convolution's output): every ``F.conv2d`` of
# :func:`conv2d` reaches the dispatcher as this op, whose outputs the
# ``"conv"`` policy saves.
CONV_OUT = torch.ops.aten.convolution.default

REMAT_POLICIES = ("block", "conv", "stack")


def _save_conv_out(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op is CONV_OUT:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _contexts(policy: str):
    """``checkpoint``'s ``context_fn`` for ``policy``: (the forward's
    context, the recompute's), the recompute's with :func:`recomputing`
    inside."""
    if policy in ("block", "stack"):
        return contextlib.nullcontext(), recomputing()
    forward, recompute = torch_checkpoint.create_selective_checkpoint_contexts(
        _save_conv_out)
    return forward, _both(recompute, recomputing())


def remat(fn, *args, policy: str):
    """``fn(*args)`` rematerialized, flax's ``nn.remat`` of the JAX
    ResNet and Hourglass: ``"block"`` (a ResNet block) and ``"stack"``
    (an hourglass module) save nothing inside ``fn`` and recompute it in
    the backward; ``"conv"`` saves only the convolutions' outputs
    (:data:`CONV_OUT`) and recomputes the BatchNorms and ReLUs. BatchNorm
    updates its running statistics once, in the forward. No RNG state is
    carried: the regions it serves draw no random numbers."""
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; one of {REMAT_POLICIES}")
    return torch_checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: _contexts(policy))
