"""The generative models, the twins of ``deepvision_tpu/models/gan.py``.

- :class:`DCGANGenerator` (``dcgan_generator``): ``fc``, a Dense without
  bias from the noise to 7·7·256, ``bn0`` over that flat vector, the
  reshape to NHWC ``(B, 7, 7, 256)`` (trap C5's order), then ``deconv1``
  (5x5, stride 1, 128), ``deconv2`` (5x5, stride 2, 64), each after its
  BatchNorm and a leaky ReLU of slope 0.3, and ``deconv3`` (5x5, stride 2,
  one channel) in float32 on the float32 cast, and tanh: ``(B, 28, 28,
  1)`` in [-1, 1].
- :class:`DCGANDiscriminator` (``dcgan_discriminator``): two 5x5 stride-2
  SAME convolutions (64, 128), each followed by a leaky ReLU of 0.3 and
  dropout at 0.3, the NHWC flatten and ``fc``, a float32 Dense to one
  logit on the float32 cast. In training its two dropout masks are
  given (``masks``): the GAN step draws them once and reuses the fake
  pass's masks in both tapes.
- :class:`CycleGANGenerator` (``cyclegan_generator``): reflection pad 3,
  the 7x7 ``stem`` (64), ``down1`` and ``down2`` (3x3, stride 2, 128 and
  256), ``n_blocks`` :class:`CycleGANResBlock` (reflection pad 1 and a
  VALID 3x3 convolution, twice, with a norm between and after, added to
  the input), ``up1`` and ``up2`` (3x3 stride-2 SAME transposed
  convolutions, 128 and 64), reflection pad 3 and ``head`` (7x7, three
  channels, float32 with bias on the float32 cast), tanh.
- :class:`CycleGANDiscriminator` (``cyclegan_discriminator``): the 70x70
  PatchGAN, 4x4 SAME convolutions of 64 (stride 2, with bias, no norm),
  128 and 256 (stride 2) and 512 (stride 1, the even kernel's SAME pads
  (1, 2)), each with a leaky ReLU of 0.2, and ``head`` (4x4, one
  channel, float32 with bias).

Every norm (:class:`Norm`, the JAX ``_Norm``) is flax's stock
``nn.BatchNorm`` (momentum 0.99, eps 1e-5, float32 statistics and
output: ``layers.BatchNorm``, never ``MixedBatchNorm``, trap C8) or with
``norm="instance"`` flax's ``nn.InstanceNorm`` (eps 1e-6), in a child
named ``norm``, as the flax module nests it. Transposed convolutions are
flax's SAME ones (``layers.conv_transpose_same``, trap C2). Convolutions
and Dense layers run in the compute ``dtype`` with float32 masters cast
at use; the norms' outputs are float32, so the generators' residual
stream is float32. Fresh weights follow flax's defaults:
``lecun_normal`` kernels (a transposed kernel's fan-in is ``I·KH·KW``),
zero biases, norms at scale 1 and bias 0. Parameter names are the flax
module paths (``res0.norm1.norm.scale``, ``up1.weight``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from deepvision_tpu_torch.models import layers
from deepvision_tpu_torch.models.layers import (
    BatchNorm,
    ConvTranspose,
    InstanceNorm,
    conv2d,
    conv_transpose_same,
    make_conv,
    reflect_pad,
    same_conv,
)
from deepvision_tpu_torch.models.registry import register

__all__ = ["leaky", "DCGANGenerator", "DCGANDiscriminator", "Norm",
           "CycleGANResBlock", "CycleGANGenerator", "CycleGANDiscriminator",
           "DROPOUT_RATE", "NORMS"]

DROPOUT_RATE = 0.3
NORMS = ("batch", "instance")
# flax's nn.BatchNorm defaults, which every GAN norm keeps
_BN_MOMENTUM = 0.99


def leaky(x: torch.Tensor, slope: float = 0.3) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _bn(features: int) -> BatchNorm:
    return BatchNorm(features, momentum=_BN_MOMENTUM, dtype=torch.float32)


class DCGANGenerator(nn.Module):
    """z ``(B, noise_dim)`` -> ``(B, 28, 28, 1)`` in [-1, 1]."""

    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, noise_dim: int = 100,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.noise_dim = noise_dim
        self.dtype = dtype
        self.fc = nn.Linear(noise_dim, 7 * 7 * 256, bias=False)
        self.bn0 = _bn(7 * 7 * 256)
        self.deconv1 = ConvTranspose(256, 128, (5, 5), bias=False)
        self.bn1 = _bn(128)
        self.deconv2 = ConvTranspose(128, 64, (5, 5), (2, 2), bias=False)
        self.bn2 = _bn(64)
        self.deconv3 = ConvTranspose(64, 1, (5, 5), (2, 2), bias=False)

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.dtype
        x = layers.dense(z.to(d), self.fc, d)
        x = leaky(self.bn0(x, train))
        x = x.reshape(x.shape[0], 7, 7, 256)  # NHWC, as the JAX reshape
        x = leaky(self.bn1(conv_transpose_same(x, self.deconv1, d), train))
        x = leaky(self.bn2(conv_transpose_same(x, self.deconv2, d), train))
        x = conv_transpose_same(x.float(), self.deconv3)
        return torch.tanh(x)


class DCGANDiscriminator(nn.Module):
    """``(B, 28, 28, 1)`` -> ``(B, 1)`` real/fake logit. ``masks``: the
    keep masks of the two dropouts (flax's Bernoulli draws of ``1 -
    DROPOUT_RATE``, shaped as the activations they gate), needed in
    training and ignored otherwise; a kept value is scaled by ``1 /
    (1 - DROPOUT_RATE)``."""

    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = make_conv(1, 64, (5, 5), (2, 2), "SAME")
        self.conv2 = make_conv(64, 128, (5, 5), (2, 2), "SAME")
        self.fc = nn.Linear(7 * 7 * 128, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                masks: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
        if train and masks is None:
            raise ValueError("the discriminator's dropout in training "
                             "needs its masks (train/gan.dcgan_draws)")
        d = self.dtype
        keep = 1.0 - DROPOUT_RATE
        x = leaky(same_conv(x, self.conv1, d))
        if train:
            x = torch.where(masks[0], x / keep, torch.zeros_like(x))
        x = leaky(same_conv(x, self.conv2, d))
        if train:
            x = torch.where(masks[1], x / keep, torch.zeros_like(x))
        x = x.reshape(x.shape[0], -1)  # the NHWC flatten
        return layers.dense(x.float(), self.fc)

    @staticmethod
    def mask_shapes(batch: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
        """The shapes of the two dropout masks at ``batch`` images."""
        return (batch, 14, 14, 64), (batch, 7, 7, 128)


class Norm(nn.Module):
    """The JAX ``_Norm``: ``norm``, flax's stock BatchNorm (momentum 0.99,
    float32) or InstanceNorm (eps 1e-6, float32)."""

    def __init__(self, features: int, kind: str = "batch"):
        super().__init__()
        if kind not in NORMS:
            raise ValueError(f"norm must be one of {NORMS}, got {kind!r}")
        self.norm = (_bn(features) if kind == "batch"
                     else InstanceNorm(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.norm(x, train)


class CycleGANResBlock(nn.Module):
    """Reflection pad 1 and a VALID 3x3 ``conv1``, ``norm1``, ReLU,
    reflection pad 1 and ``conv2``, ``norm2``, plus the input."""

    def __init__(self, features: int = 256, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = make_conv(features, features, (3, 3), padding="VALID",
                               bias=False)
        self.norm1 = Norm(features, norm)
        self.conv2 = make_conv(features, features, (3, 3), padding="VALID",
                               bias=False)
        self.norm2 = Norm(features, norm)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.dtype
        y = conv2d(reflect_pad(x, 1).to(d), self.conv1, dtype=d)
        y = torch.relu(self.norm1(y, train))
        y = conv2d(reflect_pad(y, 1).to(d), self.conv2, dtype=d)
        return x + self.norm2(y, train)


class CycleGANGenerator(nn.Module):
    """c7s1-64, d128, d256, R256 x ``n_blocks``, u128, u64, c7s1-3, tanh:
    ``(B, S, S, 3)`` -> ``(B, S, S, 3)`` in [-1, 1]."""

    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, n_blocks: int = 9, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_blocks = n_blocks
        self.dtype = dtype
        self.stem = make_conv(3, 64, (7, 7), padding="VALID", bias=False)
        self.stem_norm = Norm(64, norm)
        self.down1 = make_conv(64, 128, (3, 3), (2, 2), "SAME", bias=False)
        self.down1_norm = Norm(128, norm)
        self.down2 = make_conv(128, 256, (3, 3), (2, 2), "SAME", bias=False)
        self.down2_norm = Norm(256, norm)
        for i in range(n_blocks):
            setattr(self, f"res{i}", CycleGANResBlock(256, norm, dtype))
        self.up1 = ConvTranspose(256, 128, (3, 3), (2, 2), bias=False)
        self.up1_norm = Norm(128, norm)
        self.up2 = ConvTranspose(128, 64, (3, 3), (2, 2), bias=False)
        self.up2_norm = Norm(64, norm)
        self.head = make_conv(64, 3, (7, 7), padding="VALID")

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.dtype
        x = conv2d(reflect_pad(x, 3).to(d), self.stem, dtype=d)
        x = torch.relu(self.stem_norm(x, train))
        x = torch.relu(self.down1_norm(same_conv(x, self.down1, d), train))
        x = torch.relu(self.down2_norm(same_conv(x, self.down2, d), train))
        for i in range(self.n_blocks):
            x = getattr(self, f"res{i}")(x, train)
        x = torch.relu(self.up1_norm(conv_transpose_same(x, self.up1, d),
                                     train))
        x = torch.relu(self.up2_norm(conv_transpose_same(x, self.up2, d),
                                     train))
        x = conv2d(reflect_pad(x.float(), 3), self.head)
        return torch.tanh(x)


class CycleGANDiscriminator(nn.Module):
    """The 70x70 PatchGAN: ``(B, S, S, 3)`` -> ``(B, S/8, S/8, 1)`` patch
    logits."""

    kernel_init = staticmethod(layers.lecun_normal_)

    def __init__(self, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = make_conv(3, 64, (4, 4), (2, 2), "SAME")
        self.conv2 = make_conv(64, 128, (4, 4), (2, 2), "SAME", bias=False)
        self.norm2 = Norm(128, norm)
        self.conv3 = make_conv(128, 256, (4, 4), (2, 2), "SAME", bias=False)
        self.norm3 = Norm(256, norm)
        self.conv4 = make_conv(256, 512, (4, 4), (1, 1), "SAME", bias=False)
        self.norm4 = Norm(512, norm)
        self.head = make_conv(512, 1, (4, 4), (1, 1), "SAME")

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        d = self.dtype
        x = leaky(same_conv(x, self.conv1, d), 0.2)
        x = leaky(self.norm2(same_conv(x, self.conv2, d), train), 0.2)
        x = leaky(self.norm3(same_conv(x, self.conv3, d), train), 0.2)
        x = leaky(self.norm4(same_conv(x, self.conv4, d), train), 0.2)
        return same_conv(x, self.head)


@register("dcgan_generator")
def _dcgan_generator(**kw) -> DCGANGenerator:
    return DCGANGenerator(**kw)


@register("dcgan_discriminator")
def _dcgan_discriminator(**kw) -> DCGANDiscriminator:
    return DCGANDiscriminator(**kw)


@register("cyclegan_generator")
def _cyclegan_generator(**kw) -> CycleGANGenerator:
    return CycleGANGenerator(**kw)


@register("cyclegan_discriminator")
def _cyclegan_discriminator(**kw) -> CycleGANDiscriminator:
    return CycleGANDiscriminator(**kw)
