"""The port's LRN against the JAX package's, on the same numpy inputs.

The plain PyTorch version (what a CPU tensor runs) is held against both
JAX paths: the jnp lowering and the Pallas kernel in interpret mode. The
cases mirror tests/test_ops.py's Pallas LRN tests. The CUDA kernel runs
only on the card; chip_smoke.py holds it against the plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.ops.lrn import local_response_norm as jax_lrn
from deepvision_tpu.ops.lrn_pallas import local_response_norm_pallas
from deepvision_tpu_torch.ops import _build
from deepvision_tpu_torch.ops.lrn import (
    local_response_norm,
    local_response_norm_reference,
)
from deepvision_tpu_torch.ops.lrn_cuda import local_response_norm_cuda

# (shape, size, k, scale): AlexNet's n=5/k=2, an odd channel count, a
# row count (289) that is not a multiple of any tile, Inception's
# full-width n=192/k=1 window, and a window narrower than C but wide
CASES = {
    "n5": ((2, 5, 5, 96), 5, 2.0, 1.0),
    "odd_c56": ((3, 3, 3, 56), 5, 2.0, 1.0),
    "ragged_rows": ((1, 17, 17, 96), 5, 2.0, 1.0),
    "n192_k1": ((2, 4, 4, 192), 192, 1.0, 2.0),
    "n64_c96": ((1, 5, 5, 96), 64, 2.0, 1.0),
}


def _input(shape, scale, seed=0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_jax(case):
    shape, size, k, scale = CASES[case]
    x = _input(shape, scale)
    got = local_response_norm_reference(torch.from_numpy(x), size, 1e-4,
                                        0.75, k).numpy()
    want_jnp = np.asarray(jax_lrn(jnp.asarray(x), size, 1e-4, 0.75, k,
                                  impl="jnp"))
    want_pallas = np.asarray(local_response_norm_pallas(
        jnp.asarray(x), size, 1e-4, 0.75, k, True))
    np.testing.assert_allclose(got, want_jnp, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, want_pallas, atol=1e-5, rtol=1e-5)


def test_reference_bf16_matches_jax():
    """bf16 in, bf16 out, f32 math inside on both sides."""
    x = _input((2, 5, 5, 96), 1.0)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = local_response_norm_reference(xt)
    assert got.dtype == torch.bfloat16
    # the same bf16 values feed both sides
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    want_jnp = np.asarray(jax_lrn(xj, impl="jnp").astype(jnp.float32))
    want_pallas = np.asarray(local_response_norm_pallas(
        xj, 5, 1e-4, 0.75, 2.0, True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want_jnp, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), want_pallas, atol=1e-5)


def test_dispatch_takes_plain_version_on_cpu():
    x = torch.from_numpy(_input((2, 3, 3, 96), 1.0, seed=3))
    torch.testing.assert_close(local_response_norm(x),
                               local_response_norm_reference(x),
                               rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensor():
    x = torch.zeros(1, 2, 2, 8)
    before = local_response_norm_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        local_response_norm_cuda(x)
    assert local_response_norm_cuda.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means an error, never a quiet substitute."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("lrn")
