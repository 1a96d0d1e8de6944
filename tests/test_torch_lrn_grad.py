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

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.ops.lrn import local_response_norm as jax_lrn
from deepvision_tpu.ops.lrn_pallas import local_response_norm_pallas
from deepvision_tpu_torch.ops import _build, lrn_cuda
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
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)
from tests.test_torch_lrn import PLAN_SHAPES

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


def test_library_name_follows_the_shared_header(monkeypatch, tmp_path):
    """An edit of a header under csrc/ alone rebuilds the kernels that
    include it: the library's name carries the header's hash."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("constexpr int kStages = 2;\n")
    (tmp_path / "notes.txt").write_text("not a header\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    first = _build.library_path("k")
    (tmp_path / "notes.txt").write_text("edited, still not a header\n")
    assert _build.library_path("k") == first
    header.write_text("constexpr int kStages = 3;\n")
    second = _build.library_path("k")
    assert second != first and second.parent == first.parent
    assert second.name.startswith("libk-") and second.suffix == ".so"
    header.write_text("constexpr int kStages = 2;\n")
    assert _build.library_path("k") == first


# ---- the backward kernel's launch plan and tile algorithm -------------------


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PLAN_SHAPES))
def test_backward_launch_plan(case, itemsize):
    """csrc/lrn_bwd.cu stages an x tile and a g tile of the forward's plan
    on one mbarrier: both tiles start 16-byte aligned, their transaction
    bytes stay under the mbarrier's 2^20, and the ragged end of the last
    tile of each (under 16 bytes) is fewer elements than a warp's lanes."""
    shape = PLAN_SHAPES[case]
    c, rows = shape[-1], math.prod(shape[:-1])
    plan = lrn_cuda._launch_plan(rows, c, itemsize)
    row_bytes = c * itemsize
    tile_bytes = plan.tile_rows * row_bytes
    assert tile_bytes % 16 == 0
    assert 2 * tile_bytes < 2 ** 19  # the C launcher's bound, under 2^20
    vec = 16 // itemsize if row_bytes % 16 == 0 else 1
    assert (plan.tile_rows * c) % vec == 0
    if vec > 1:  # a lane keeps `a` in registers for at most 768 elements
        assert plan.tile_rows * c <= 768
    last_rows = rows - (plan.tiles - 1) * plan.tile_rows
    assert 0 < last_rows <= plan.tile_rows
    tail = last_rows * row_bytes % 16
    assert tail // itemsize < 32
    # AlexNet V1's two LRNs: 96 vectors a tile (three whole runs of 32
    # lanes), one 1 KB row at C=256 in f32
    pinned = {("alexnet1_lrn1", 4): 4, ("alexnet1_lrn1", 2): 8,
              ("alexnet1_lrn2", 4): 1, ("alexnet1_lrn2", 2): 3}
    if (case, itemsize) in pinned:
        assert plan.tile_rows == pinned[case, itemsize]


F32 = np.float32


def _scan_rows(vals, vpr, vec, exclusive, right_pad):
    """float32 rendering of lrn_bwd.cu's scan_tile over one tile: vals are
    the tile's vectors (nvec, vec) in row order. Each lane sums its VEC
    values, a segmented Hillis-Steele scan over 32 lanes stops at row
    starts, the row goes on into the next 32 vectors by a carry. Returns
    the tile's prefix rows, (rows, vpr + 2, vec): a pad vector of zeros,
    the prefix (``exclusive`` or inclusive) of the row's vectors, and a
    right pad vector ``right_pad``: "total" (the kernel) or "inf" (the
    forward's pads, read through a min with the total); and the totals."""
    nvec = len(vals)
    nrows = nvec // vpr
    r_of, cv_of = np.arange(nvec) // vpr, np.arange(nvec) % vpr
    incl_own = np.cumsum(vals, axis=1, dtype=F32)
    own = (np.concatenate([np.zeros((nvec, 1), F32), incl_own[:, :-1]],
                          axis=1) if exclusive else incl_own)
    out = np.zeros((nrows, vpr + 2, vec), F32)
    totals = np.zeros(nrows, F32)
    carry = F32(0)
    for v0 in range(0, nvec, 32):
        idx = np.arange(v0, min(v0 + 32, nvec))
        lane, cv = idx - v0, cv_of[idx]
        reach = np.minimum(cv, lane)
        incl = incl_own[idx, -1].copy()
        d = 1
        while d < 32:
            shifted = np.concatenate([incl[:d], incl[:-d]])
            incl = np.where(d <= reach, incl + shifted, incl).astype(F32)
            d *= 2
        excl = np.where(reach == 0, F32(0),
                        np.concatenate([incl[:1], incl[:-1]])).astype(F32)
        go_on = cv > lane
        incl = np.where(go_on, incl + carry, incl).astype(F32)
        excl = np.where(go_on, excl + carry, excl).astype(F32)
        out[r_of[idx], cv + 1] = own[idx] + excl[:, None]
        ends = cv == vpr - 1
        totals[r_of[idx][ends]] = incl[ends]
        carry = incl[-1]
    out[:, vpr + 1] = (totals[:, None] if right_pad == "total" else np.inf)
    return out, totals


def _read_at(rows, totals, off, vpr, vec, right_pad):
    """The values at J = cv*vec + off + i of every vector of the tile, off
    a multiple of vec, as read_at takes them: one vector, its column
    cv + off/vec + 1 clamped into the pads."""
    assert off % vec == 0
    cols = np.clip(np.arange(vpr) + off // vec + 1, 0, vpr + 1)
    got = rows[:, cols]  # (rows, vpr, vec)
    if right_pad == "inf":
        got = np.minimum(got, totals[:, None, None])
    return got.reshape(rows.shape[0], vpr * vec)


def _kernel_vec(vec, size):
    """The VEC lrn_bwd.cu's launcher takes (C divisible by every VEC
    here): the prefix path reads whole vectors, so its window offsets,
    +-n/2 for even n, must be multiples of VEC, else VEC = 1."""
    if size == 5 or (size % 2 == 0 and size // 2 % vec == 0):
        return vec
    return 1


def _grad_terms(x, g, s, size, alpha, beta, k):
    d = F32(k) + F32(alpha / size) * s
    a = (g * np.exp2(F32(-beta) * np.log2(d))).astype(F32)
    return a, (a * x * (F32(1) / d)).astype(F32)


def _slide(vals, vec, left, right):
    """lrn_bwd.cu's slide: per vector, the neighbour vectors (zeros outside
    the row), the window [i - left, i + right] summed at the vector's first
    channel, then one add and one subtract an output."""
    nrows, c = vals.shape
    kh = -(-max(left, right) // vec)
    mid = kh * vec
    pad = np.zeros((nrows, mid), F32)
    padded = np.concatenate([pad, vals, pad], axis=1)
    vpr = c // vec
    e = np.stack([padded[:, cv * vec:cv * vec + (2 * kh + 1) * vec]
                  for cv in range(vpr)], axis=1)  # (rows, vpr, 2kh+1 vecs)
    s = np.zeros((nrows, vpr), F32)
    for m in range(-left, right + 1):
        s = (s + e[:, :, mid + m]).astype(F32)
    out = np.empty((nrows, vpr, vec), F32)
    for i in range(vec):
        out[:, :, i] = s
        if i + 1 < vec:
            s = (s + e[:, :, mid + i + 1 + right]
                 - e[:, :, mid + i - left]).astype(F32)
    return out.reshape(nrows, c)


def _backward_tiles(x2d, g2d, size, alpha, beta, k, vec, tile_rows,
                    right_pad="total"):
    """float32 rendering of lrn_bwd.cu over a (rows, C) view, tile by
    tile: n=5 slides both windows (S of x^2, then S~ of inner with the
    mirrored offsets); every other n scans x^2 into E, takes S from two
    vector reads of E, scans inner into Q and takes S~ from two vector
    reads of Q."""
    rows, c = x2d.shape
    half, right = size // 2, size - 1 - size // 2
    coef = F32(2 * alpha * beta / size)
    vec = _kernel_vec(vec, size)
    vpr = c // vec
    dx = np.empty((rows, c), F32)
    for r0 in range(0, rows, tile_rows):
        xt, gt = x2d[r0:r0 + tile_rows], g2d[r0:r0 + tile_rows]
        n = xt.shape[0]
        if size == 5:
            a, inner = _grad_terms(xt, gt, _slide(xt * xt, vec, half, right),
                                   size, alpha, beta, k)
            adj = _slide(inner, vec, right, half)
        else:
            # S(i) = E(i + right + 1) - E(i - half), E exclusive
            pre, ptot = _scan_rows((xt * xt).reshape(n * vpr, vec), vpr, vec,
                                   True, right_pad)
            s = (_read_at(pre, ptot, right + 1, vpr, vec, right_pad)
                 - _read_at(pre, ptot, -half, vpr, vec, right_pad))
            a, inner = _grad_terms(xt, gt, s, size, alpha, beta, k)
            # S~(j) = Q(j + half) - Q(j - right - 1), Q inclusive
            q, qtot = _scan_rows(inner.reshape(n * vpr, vec), vpr, vec,
                                 False, right_pad)
            adj = (_read_at(q, qtot, half, vpr, vec, right_pad)
                   - _read_at(q, qtot, -right - 1, vpr, vec, right_pad))
        dx[r0:r0 + n] = a - coef * xt * adj
    return dx


# (shape, size, k, scale): AlexNet's n=5, narrow n=3 and even n=4 (which
# take the prefix path with VEC = 1), Inception's n=64 on C=64 and n=192
# on C=192 (whole vectors at VEC 4 and 8); C divisible by 8
TILE_CASES = {
    "n5_c96": ((2, 5, 5, 96), 5, 2.0, 1.0),
    "n3_c96": ((2, 3, 3, 96), 3, 2.0, 1.0),
    "n4_c96": ((2, 3, 3, 96), 4, 2.0, 1.0),
    "n64_c64": ((1, 8, 8, 64), 64, 1.0, 2.0),
    "n192_c192": ((2, 4, 4, 192), 192, 1.0, 2.0),
}
# large enough that each window term, and so an error in either window
# sum, stands far above the 1e-5 tolerance
TILE_ALPHA = 0.5


def _tile_run(case, vec, right_pad="total"):
    shape, size, k, scale = TILE_CASES[case]
    x, g = _inputs(shape, scale, seed=7)
    c = shape[-1]
    itemsize = 2 if vec == 8 else 4  # vec 1: the odd-C path, in f32
    plan = lrn_cuda._launch_plan(math.prod(shape[:-1]), c, itemsize)
    got = _backward_tiles(x.reshape(-1, c), g.reshape(-1, c), size,
                          TILE_ALPHA, 0.75, k, vec, plan.tile_rows,
                          right_pad).reshape(shape)
    return got, x, g, size, k


@pytest.mark.parametrize("vec", [4, 8, 1])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_backward_tile_algorithm_matches_reference_and_jax(case, vec):
    got, x, g, size, k = _tile_run(case, vec)
    want = local_response_norm_backward_reference(
        torch.from_numpy(x), torch.from_numpy(g), size, TILE_ALPHA, 0.75,
        k).numpy()
    _, vjp = jax.vjp(lambda a: local_response_norm_pallas(
        a, size, TILE_ALPHA, 0.75, k, True), jnp.asarray(x))
    want_pallas = np.asarray(vjp(jnp.asarray(g))[0])
    for ref in (want, want_pallas):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["n3_c96", "n4_c96", "n64_c64",
                                  "n192_c192"])
def test_min_over_inf_pads_fails_for_the_signed_scan(case):
    """The forward's right-edge trick, min(prefix, total) over +inf pads,
    needs a non-decreasing prefix. Q, the prefix of the signed inner, is
    not: a rendering that reads it so disagrees with the reference."""
    got, x, g, size, k = _tile_run(case, 4, right_pad="inf")
    want = local_response_norm_backward_reference(
        torch.from_numpy(x), torch.from_numpy(g), size, TILE_ALPHA, 0.75,
        k).numpy()
    assert not np.allclose(got, want, atol=1e-5, rtol=1e-5)
