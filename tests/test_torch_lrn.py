"""The port's LRN against the JAX package's, on the same numpy inputs.

The plain PyTorch version (what a CPU tensor runs) is held against both
JAX paths: the jnp lowering and the Pallas kernel in interpret mode. The
cases mirror tests/test_ops.py's Pallas LRN tests. The CUDA kernel runs
only on the card; chip_smoke.py holds it against the plain version there.
What surrounds it is pinned here: the tiling of the launch plan at every
shape of the zoo, and a float32 numpy rendering of the kernel's prefix-sum window
(its lane walk, segmented scan and prefix differences).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvision_tpu.ops.lrn import local_response_norm as jax_lrn
from deepvision_tpu.ops.lrn_pallas import local_response_norm_pallas
from deepvision_tpu_torch.ops import _build, lrn_cuda
from deepvision_tpu_torch.ops.lrn import (
    local_response_norm,
    local_response_norm_reference,
)
from deepvision_tpu_torch.ops.lrn_cuda import local_response_norm_cuda
from tests.torch_threads import (  # noqa: F401  (autouse)
    share_cores_among_workers,
)

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


# every LRN the zoo runs, at batch 64 (AlexNet V1 and V2-TF with n=5, the
# Inception V1 stem with n=64 and n=192), the Inception stem at its
# training batch of 128, an odd channel count, the widest C the kernel
# takes, and a single row of 3 channels (under 16 bytes)
PLAN_SHAPES = {
    "alexnet1_lrn1": (64, 55, 55, 96),
    "alexnet1_lrn2": (64, 27, 27, 256),
    "alexnet2_tf_lrn1": (64, 55, 55, 64),
    "alexnet2_tf_lrn2": (64, 27, 27, 192),
    "inception1_lrn1": (64, 56, 56, 64),
    "inception1_lrn2": (64, 56, 56, 192),
    "inception1_lrn1_b128": (128, 56, 56, 64),
    "inception1_lrn2_b128": (128, 56, 56, 192),
    "odd_c57": (1, 7, 9, 57),
    "odd_c57_n64": (2, 9, 9, 57),
    "c768_n192": (2, 9, 9, 768),
    "tiny_c3": (1, 1, 1, 3),
}


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PLAN_SHAPES))
def test_launch_plan(case, itemsize):
    shape = PLAN_SHAPES[case]
    c = shape[-1]
    rows = math.prod(shape[:-1])
    plan = lrn_cuda._launch_plan(rows, c, itemsize)
    row_bytes = c * itemsize
    # 16-byte alignment: every tile starts on a multiple of 16 bytes, and
    # the bulk copy of the last tile leaves under 16 bytes to plain loads,
    # fewer than a warp's lanes
    assert plan.tile_rows >= 1
    assert plan.tile_rows * row_bytes % 16 == 0
    # about TILE_BYTES a tile, or the fewest rows that make 16 bytes
    step = 16 // math.gcd(row_bytes, 16)
    assert (plan.tile_rows * row_bytes <= lrn_cuda.TILE_BYTES
            or plan.tile_rows == step)
    last_rows = rows - (plan.tiles - 1) * plan.tile_rows
    assert 0 < last_rows <= plan.tile_rows
    tail = last_rows * row_bytes % 16
    assert tail < 16 and tail // itemsize < 32
    # the tiles cover every row exactly once
    cover = np.zeros(rows, np.int64)
    for t in range(plan.tiles):
        cover[t * plan.tile_rows:(t + 1) * plan.tile_rows] += 1
    assert (cover == 1).all()


def _tile_walk(tile_rows, vpr):
    """(row, vector) of each lane's turns over a tile: lane l takes the
    tile's vectors l, l + 32, ... in row-major order."""
    v = np.arange(tile_rows * vpr)
    return v // vpr, v % vpr


def _prefix_window_sums(x2d, size, vec, tile_rows):
    """float32 rendering of csrc/lrn.cu's prefix_tile: per tile, each lane's
    local prefix of x^2 over its VEC channels, a segmented Hillis-Steele
    scan over 32 lanes that stops at row starts, the carry of a row into
    the next 32 vectors, then S(i) = min(P(i + right), P(C-1)) -
    P(i - half - 1) from the padded prefix rows."""
    f32 = np.float32
    rows, c = x2d.shape
    half, right = size // 2, size - 1 - size // 2
    vpr = c // vec
    sums = np.empty((rows, c), f32)
    for r0 in range(0, rows, tile_rows):
        tile = x2d[r0:r0 + tile_rows]
        n = tile.shape[0]
        rr, cv = _tile_walk(n, vpr)
        vecs = tile.reshape(n * vpr, vec).astype(f32)
        q = np.cumsum(vecs * vecs, axis=1, dtype=f32)  # the lane's prefix
        prefix = np.zeros((n, c), f32)
        carry = f32(0)
        for v0 in range(0, n * vpr, 32):
            idx = np.arange(v0, min(v0 + 32, n * vpr))
            lane = idx - v0
            reach = np.minimum(cv[idx], lane)
            incl = q[idx, -1].copy()
            d = 1
            while d < 32:
                shifted = np.concatenate([incl[:d], incl[:-d]])
                incl = np.where(d <= reach, incl + shifted, incl).astype(f32)
                d *= 2
            excl = np.where(reach == 0, f32(0),
                            np.concatenate([incl[:1], incl[:-1]]))
            go_on = cv[idx] > lane  # the row began before these 32
            incl = np.where(go_on, incl + carry, incl).astype(f32)
            excl = np.where(go_on, excl + carry, excl).astype(f32)
            prefix.reshape(n * vpr, vec)[idx] = excl[:, None] + q[idx]
            carry = incl[-1]
        total = prefix[:, -1:]
        padded = np.concatenate(
            [np.zeros((n, half + 1), f32), prefix,
             np.full((n, right), np.inf, f32)], axis=1)
        i = np.arange(c)
        hi = np.minimum(padded[:, half + 1 + i + right], total)
        sums[r0:r0 + n] = hi - padded[:, i]
    return sums


def _lrn_from_sums(x, sums, size, alpha, beta, k):
    f32 = np.float32
    d = f32(k) + f32(alpha / size) * sums
    return (x * np.exp2(f32(-beta) * np.log2(d))).astype(f32)


# n192_k1 and n64_c96 of CASES, Inception's n=64 on C=64 at 8x8, and a
# narrow window other than n=5, which the prefix-sum path takes too
PREFIX_CASES = {
    "n192_k1": CASES["n192_k1"],
    "n64_c96": CASES["n64_c96"],
    "n64_c64": ((1, 8, 8, 64), 64, 1.0, 2.0),
    "n3_c96": ((2, 5, 5, 96), 3, 2.0, 1.0),
}


@pytest.mark.parametrize("vec", [4, 8, 1])
@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_difference_window_matches_reference_and_jax(case, vec):
    shape, size, k, scale = PREFIX_CASES[case]
    x = _input(shape, scale)
    c = shape[-1]
    itemsize = 2 if vec == 8 else 4  # vec 1: the odd-C path, in f32
    plan = lrn_cuda._launch_plan(math.prod(shape[:-1]), c, itemsize)
    sums = _prefix_window_sums(x.reshape(-1, c), size, vec,
                             plan.tile_rows).reshape(shape)
    got = _lrn_from_sums(x, sums, size, 1e-4, 0.75, k)
    want = local_response_norm_reference(torch.from_numpy(x), size, 1e-4,
                                         0.75, k).numpy()
    want_jnp = np.asarray(jax_lrn(jnp.asarray(x), size, 1e-4, 0.75, k,
                                  impl="jnp"))
    want_pallas = np.asarray(local_response_norm_pallas(
        jnp.asarray(x), size, 1e-4, 0.75, k, True))
    for ref in (want, want_jnp, want_pallas):
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
