"""PyTorch/CUDA port of ``deepvision_tpu`` for one NVIDIA H100.

Each module sits at the same relative path as its JAX twin. The package
imports torch, numpy and the standard library only: it never imports
``jax``, ``flax`` or ``deepvision_tpu`` and keeps its own copies of the
host-side pieces it needs. Every entry point takes ``device=`` and runs
on ``"cuda"`` unless the caller asks for ``"cpu"``.

The fused LRN, the JAX package's one Pallas kernel, is a pair of
hand-written CUDA kernels here, forward (``csrc/lrn.cu``) and backward
(``csrc/lrn_bwd.cu``), bound in ``ops/lrn_cuda.py`` and paired by the
``torch.autograd.Function`` of ``ops/lrn.py``.
"""

from deepvision_tpu_torch.device import resolve_device, strict_fp32

__all__ = ["resolve_device", "strict_fp32"]
