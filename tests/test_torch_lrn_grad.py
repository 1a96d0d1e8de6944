"""The port's LRN backward against the JAX package's, on the same inputs.

The plain backward (``local_response_norm_backward_reference``, what a
CPU tensor runs) is held against two JAX references on seeded numpy
inputs: ``jax.vjp`` of the Pallas LRN in interpret mode, whose
``custom_vjp`` backward is ``_bwd``, and ``jax.vjp`` of the jnp LRN
(autodiff of the reduce_window lowering). Even windows matter: for odd n
the forward window and its adjoint coincide, for even n they do not. The
analytic backward is also checked by ``gradcheck`` in float64. The CUDA
backward kernel runs only on the card; ``chip_smoke.py`` holds it against
this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.ops.lrn import local_response_norm as jax_lrn
from deepvision_tpu.ops.lrn_pallas import local_response_norm_pallas
from deepvision_tpu_torch.ops import _build
from deepvision_tpu_torch.ops.lrn import (
    LocalResponseNorm,
    local_response_norm,
    local_response_norm_backward_reference,
    local_response_norm_reference,
)
from deepvision_tpu_torch.ops.lrn_cuda import (
    local_response_norm_backward_cuda,
    local_response_norm_cuda,
)

# (shape, size, k, scale): chip_smoke.py's PARITY_CASES at small sizes:
# AlexNet's n=5/k=2, odd C, a ragged row count, Inception's even n=64 and
# n=192 with k=1 (their adjoint window is mirrored), an odd C with even
# n, and a narrow odd n other than 5
CASES = {
    "n5_c96": ((2, 5, 5, 96), 5, 2.0, 1.0),
    "odd_c57": ((1, 7, 9, 57), 5, 2.0, 1.0),
    "ragged_rows": ((1, 17, 17, 96), 5, 2.0, 1.0),
    "n64_c64": ((2, 4, 4, 64), 64, 1.0, 2.0),
    "n192_c192": ((2, 4, 4, 192), 192, 1.0, 2.0),
    "odd_c57_n64": ((2, 3, 3, 57), 64, 1.0, 2.0),
    "n4_c10": ((2, 3, 3, 10), 4, 2.0, 1.0),
    "n3_c96": ((2, 3, 3, 96), 3, 2.0, 1.0),
}


def _inputs(shape, scale, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, shape).astype(np.float32),
            rng.normal(0, 1, shape).astype(np.float32))


def _jax_grads(x, g, size, k):
    """dx from the Pallas custom_vjp (``_bwd``) and from jnp autodiff."""
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    _, vjp_pallas = jax.vjp(
        lambda a: local_response_norm_pallas(a, size, 1e-4, 0.75, k, True),
        xj)
    _, vjp_jnp = jax.vjp(
        lambda a: jax_lrn(a, size, 1e-4, 0.75, k, impl="jnp"), xj)
    return vjp_pallas(gj)[0], vjp_jnp(gj)[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_reference_matches_jax(case):
    shape, size, k, scale = CASES[case]
    x, g = _inputs(shape, scale)
    got = local_response_norm_backward_reference(
        torch.from_numpy(x), torch.from_numpy(g), size, 1e-4, 0.75,
        k).numpy()
    for want in _jax_grads(x, g, size, k):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["n5_c96", "n64_c64", "odd_c57_n64"])
def test_backward_reference_bf16_matches_jax(case):
    """bf16 x and g on both sides, f32 math inside, dx rounded to bf16
    once: atol 1e-2 plus one bf16 step."""
    shape, size, k, scale = CASES[case]
    x, g = _inputs(shape, scale)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    got = local_response_norm_backward_reference(xt, gt, size, 1e-4, 0.75, k)
    assert got.dtype == torch.bfloat16
    # the same bf16 values feed both sides
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    gj = jnp.asarray(gt.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(
        lambda a: local_response_norm_pallas(a, size, 1e-4, 0.75, k, True),
        xj)
    want = np.asarray(vjp(gj)[0].astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=2**-7)


@pytest.mark.parametrize("size,c", [(5, 12), (4, 9), (6, 6)])
def test_analytic_backward_gradcheck_float64(size, c):
    """The Function's analytic backward against finite differences of its
    forward, and against autograd through the plain forward."""
    rng = np.random.default_rng(size)
    x = torch.from_numpy(rng.normal(0, 3, (2, 2, 2, c))).requires_grad_()
    g = torch.from_numpy(rng.normal(0, 1, (2, 2, 2, c)))
    # alpha large enough that the window term is far above the noise of
    # the finite differences
    assert torch.autograd.gradcheck(
        lambda a: local_response_norm(a, size, 0.5, 0.75, 1.0), (x,))
    (want,) = torch.autograd.grad(
        local_response_norm_reference(x, size, 0.5, 0.75, 1.0), x, g)
    got = local_response_norm_backward_reference(x.detach(), g, size, 0.5,
                                                 0.75, 1.0)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-10)


def test_function_takes_plain_versions_on_cpu():
    x, g = _inputs((2, 3, 3, 96), 1.0, seed=3)
    xt = torch.from_numpy(x).requires_grad_()
    y = local_response_norm(xt)
    assert y.grad_fn.name().startswith("LocalResponseNorm")
    torch.testing.assert_close(y.detach(),
                               local_response_norm_reference(xt.detach()),
                               rtol=0, atol=0)
    y.backward(torch.from_numpy(g))
    torch.testing.assert_close(
        xt.grad, local_response_norm_backward_reference(
            xt.detach(), torch.from_numpy(g)), rtol=0, atol=0)


def test_function_saves_x_only():
    xt = torch.ones(1, 1, 1, 8, requires_grad=True)
    y = LocalResponseNorm.apply(xt, 5, 1e-4, 0.75, 2.0)
    assert len(y.grad_fn.saved_tensors) == 1
    assert y.grad_fn.saved_tensors[0] is xt


def test_cuda_backward_wrapper_refuses_cpu_tensor():
    x = torch.zeros(1, 2, 2, 8)
    before = dict(local_response_norm_backward_cuda.launches_by_kernel)
    with pytest.raises(ValueError, match="CUDA tensor"):
        local_response_norm_backward_cuda(x, x)
    assert local_response_norm_backward_cuda.launches_by_kernel == before


def test_raw_forward_launcher_refuses_a_tensor_that_needs_grad():
    """Outside the Function the forward launcher would drop the graph, so
    a CPU tensor is refused for its device and no launch is counted."""
    x = torch.zeros(1, 2, 2, 8, requires_grad=True)
    before = local_response_norm_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        local_response_norm_cuda(x)
    assert local_response_norm_cuda.launches == before


def test_backward_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("lrn_bwd")
