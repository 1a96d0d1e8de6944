#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``deepvision_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without them, and in a
directory that does not hold the port. Phases, each of which raises on
failure (nothing is caught):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions,
   and the float32 policy (TF32 off for cuDNN and cuBLAS);
2. build: ``csrc/lrn.cu`` with ``nvcc`` for ``sm_90a``, from the sources
   in this checkout;
3. kernel vs plain version on the card, at every LRN shape of the model
   zoo (AlexNet V1 and V2-TF with n=5, k=2; the Inception V1 stem with
   n=64 and n=192, k=1), an odd channel count and a ragged row count: f32
   to atol 1e-5 and rtol 1e-5, bf16 to atol 1e-2 and one bf16 step
   (rtol 2^-7) against the plain version run in bf16;
4. times, with CUDA events (median of 100 runs after 10 of warm-up), of
   the kernel, the plain version and ``F.local_response_norm`` at the two
   AlexNet V1 shapes at batch 64, beside the least time the card could
   take;
5. serve: ``load_served("alexnet1")`` at 224x224x3 and 1000 classes with
   seeded weights, an ``InferenceEngine`` on buckets (1, 4, 16, 64), 96
   seeded requests; the answers are held against the same module run with
   the plain LRN, and the LRN launch count must be 2 per batch;
6. CLI: the same model through ``python -m deepvision_tpu_torch.serve``
   on stdin-JSONL, answering like the engine.

It then prints the ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet: HBM3 rate and float32 rate outside the
# tensor cores (the kernel's math is f32 for both input types)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

LRN_SOURCE = "deepvision_tpu_torch/csrc/lrn.cu"
LRN_REPLACES = "deepvision_tpu/ops/lrn_pallas.py:79"
# (name, shape, size, k, input scale); the first two are AlexNet V1's
# LRNs at batch 64, the shapes the served model gives the kernel
ALEXNET_V1_LRNS = [("lrn1", (64, 55, 55, 96)), ("lrn2", (64, 27, 27, 256))]
PARITY_CASES = [
    ("alexnet1_lrn1", (64, 55, 55, 96), 5, 2.0, 1.0),
    ("alexnet1_lrn2", (64, 27, 27, 256), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn1", (8, 55, 55, 64), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn2", (8, 27, 27, 192), 5, 2.0, 1.0),
    ("inception1_lrn1", (8, 56, 56, 64), 64, 1.0, 2.0),
    ("inception1_lrn2", (8, 56, 56, 192), 192, 1.0, 2.0),
    ("odd_c56", (3, 3, 3, 56), 5, 2.0, 1.0),
    ("ragged_rows", (1, 17, 17, 96), 5, 2.0, 1.0),  # 289 rows, 8 a block
]
N_REQUESTS = 96
BUCKETS = (1, 4, 16, 64)


def _say(*parts) -> None:
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Median device time of one call, from CUDA events around each."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _lrn_bound_ms(shape, itemsize: int, size: int) -> tuple[float, str]:
    """Least time for one LRN: one read and one write of the activation
    over the HBM rate, against size + 6 f32 operations an element
    (square, window adds, scale, add k, log, scale by beta, exp, divide)
    over the f32 rate."""
    numel = int(np.prod(shape))
    bytes_s = 2 * numel * itemsize / HBM_BYTES_PER_S
    ops_s = numel * (size + 6) / F32_OPS_PER_S
    if bytes_s >= ops_s:
        return bytes_s * 1e3, "bytes"
    return ops_s * 1e3, "operations"


def phase_card() -> str:
    import torch

    from deepvision_tpu_torch.device import strict_fp32

    smi = _nvidia_smi()
    _say(f"[card] {smi}")
    _say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} "
         f"count {torch.cuda.device_count()}")
    _say(f"[card] float32 policy {strict_fp32()} (TF32 off: convolutions "
         "and matmuls in full float32)")
    return smi


def phase_build() -> None:
    from deepvision_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load_library("lrn")
    _say(f"[build] {LRN_SOURCE} -> {lib._name} in "
         f"{time.perf_counter() - t0:.2f} s (flags: "
         f"{' '.join(_build.NVCC_FLAGS)})")
    for line in _build.build_logs.get("lrn", "").splitlines():
        if line.strip():
            _say(f"[build] {line.strip()}")


def phase_parity() -> dict[str, float]:
    """Kernel vs plain version at every zoo shape; max abs error by
    kernel name."""
    import torch

    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.ops.lrn_cuda import (
        KERNEL_NAMES,
        local_response_norm_cuda,
    )

    errs = dict.fromkeys(KERNEL_NAMES.values(), 0.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, size, k, scale in PARITY_CASES:
        x32 = torch.randn(shape, device="cuda", generator=gen) * scale
        # bf16: both sides compute in f32 and round once to bf16, so a
        # last-bit f32 difference can land on either side of a rounding
        # boundary; one bf16 step (2^-7 relative) on top of atol 1e-2
        for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)),
                           (torch.bfloat16, dict(atol=1e-2, rtol=2**-7))):
            x = x32.to(dtype)
            got = local_response_norm_cuda(x, size, 1e-4, 0.75, k)
            want = local_response_norm_reference(x, size, 1e-4, 0.75, k)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == x.shape
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda m: f"{name} {dtype}: {m}")
            err = (got.float() - want.float()).abs().max().item()
            kernel = KERNEL_NAMES[dtype]
            errs[kernel] = max(errs[kernel], err)
            _say(f"[parity] {name} {tuple(shape)} n={size} k={k} "
                 f"{str(dtype).removeprefix('torch.')}: max abs err "
                 f"{err:.3e}")
    return errs


def phase_times() -> dict[str, dict]:
    """Kernel, plain and library times at AlexNet V1's two LRNs, batch
    64; per kernel, the sums over the two (one served batch)."""
    import torch
    import torch.nn.functional as F

    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.ops.lrn_cuda import (
        KERNEL_NAMES,
        local_response_norm_cuda,
    )

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype, kernel in KERNEL_NAMES.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0}
        bound_by = set()
        for lrn, shape in ALEXNET_V1_LRNS:
            x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            nchw = x.permute(0, 3, 1, 2)  # channels_last view, no copy
            ms = _time_ms(lambda: local_response_norm_cuda(x))
            plain = _time_ms(lambda: local_response_norm_reference(x))
            lib = _time_ms(lambda: F.local_response_norm(nchw, 5, 1e-4,
                                                         0.75, 2.0))
            lib_err = (F.local_response_norm(nchw, 5, 1e-4, 0.75, 2.0)
                       .permute(0, 2, 3, 1).float()
                       - local_response_norm_reference(x).float()
                       ).abs().max().item()
            bound, by = _lrn_bound_ms(shape, x.element_size(), 5)
            bound_by.add(by)
            for key, v in (("ms", ms), ("plain_ms", plain),
                           ("library_ms", lib), ("bound_ms", bound)):
                tot[key] += v
            _say(f"[time] {kernel} {lrn} {tuple(shape)}: kernel {ms:.4f} ms"
                 f", plain {plain:.4f} ms, F.local_response_norm "
                 f"{lib:.4f} ms (max abs diff to plain {lib_err:.2e}), "
                 f"bound {bound:.4f} ms by {by} "
                 f"({bound / ms:.1%} of the bound)")
        tot["bound_by"] = "bytes" if bound_by == {"bytes"} else "operations"
        out[kernel] = tot
    return out


def _check_against(results, ref_probs, ref_classes, full_probs,
                   atol: float) -> None:
    """Engine answers vs the plain-LRN run: probabilities within
    ``atol``; a class may differ from the reference's only where the
    reference gives it the same probability within ``atol`` (a tie)."""
    for i, r in enumerate(results):
        classes = np.asarray(r["classes"])
        probs = np.asarray(r["probs"])
        assert classes.shape == (5,) and np.all(np.isfinite(probs)), r
        np.testing.assert_allclose(probs, ref_probs[i], atol=atol)
        for j in np.nonzero(classes != ref_classes[i])[0]:
            gap = abs(full_probs[i, classes[j]] - ref_probs[i, j])
            assert gap <= atol, (
                f"request {i}: class {classes[j]} in place {j} where the "
                f"plain-LRN run has {ref_classes[i, j]} (gap {gap:.2e})")


def phase_serve(smi: str) -> tuple[dict[str, int], list, np.ndarray]:
    """The port's main path; returns the LRN launches it made by kernel,
    the answers and the inputs."""
    import torch

    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.ops.lrn_cuda import local_response_norm_cuda
    from deepvision_tpu_torch.serve import InferenceEngine, load_served

    t0 = time.perf_counter()
    served = load_served("alexnet1", seed=0)
    engine = InferenceEngine([served], buckets=BUCKETS,
                             batch_window_s=0.002)
    _say(f"[serve] alexnet1 {served.input_shape} -> 1000 classes on "
         f"{served.device}, {sum(p.numel() for p in served.module.parameters())}"
         f" parameters; load + warm-up {time.perf_counter() - t0:.2f} s; "
         f"precision {engine.precision}")
    xs = (np.random.default_rng(0)
          .normal(0, 1, (N_REQUESTS, *served.input_shape))
          .astype(np.float32))
    local_response_norm_cuda.launches = 0
    for key in local_response_norm_cuda.launches_by_kernel:
        local_response_norm_cuda.launches_by_kernel[key] = 0
    try:
        t0 = time.perf_counter()
        futures = [engine.submit(x) for x in xs]
        results = [f.result(timeout=300) for f in futures]
        wall = time.perf_counter() - t0
        launches = local_response_norm_cuda.launches
        by_kernel = dict(local_response_norm_cuda.launches_by_kernel)
        snap = engine.telemetry.snapshot()
    finally:
        engine.close()
    batches = snap["batches"]
    assert snap["completed"] == N_REQUESTS and snap["failed"] == 0, snap
    assert launches == 2 * batches, (launches, batches)
    assert by_kernel["lrn_forward_f32"] == launches, by_kernel
    _say(f"[serve] {N_REQUESTS} requests in {batches} batches "
         f"(pad overhead {snap['pad_overhead_frac']}); LRN launches "
         f"{launches} = 2 per batch; {by_kernel}")
    _say(f"[serve] {N_REQUESTS / wall:.1f} images/s, e2e p50 "
         f"{snap['e2e_latency']['p50_ms']} ms p95 "
         f"{snap['e2e_latency']['p95_ms']} ms, device time per batch p50 "
         f"{snap['device_time']['p50_ms']} ms (offered as one burst; "
         f"{smi})")

    ref = copy.deepcopy(served.module)
    ref.lrn = local_response_norm_reference
    with torch.inference_mode():
        probs = torch.cat([
            torch.softmax(ref(torch.from_numpy(xs[i:i + 32]).cuda()), -1)
            for i in range(0, N_REQUESTS, 32)])
        top_p, top_c = torch.topk(probs, 5, dim=-1)
    _check_against(results, top_p.cpu().numpy(), top_c.cpu().numpy(),
                   probs.cpu().numpy(), atol=1e-4)
    _say("[serve] every answer matches the plain-LRN run of the same "
         "module (probs within 1e-4)")
    return by_kernel, results, xs


def phase_cli(results, xs, n: int = 4) -> None:
    """The serving CLI on the card answers like the engine."""
    lines = "".join(json.dumps({"id": i, "model": "alexnet1",
                                "input": xs[i].tolist()}) + "\n"
                    for i in range(n))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deepvision_tpu_torch.serve", "-m",
         "alexnet1", "--buckets", "1,4", "--seed", "0"],
        input=lines, capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-4000:]
    replies = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [r["id"] for r in replies] == list(range(n)), replies
    for r in replies:
        want = results[r["id"]]
        assert r["result"]["classes"][0] == want["classes"][0], (r, want)
        np.testing.assert_allclose(r["result"]["probs"], want["probs"],
                                   atol=1e-4)
    _say(f"[cli] python -m deepvision_tpu_torch.serve answered {n} "
         f"requests like the engine in {time.perf_counter() - t0:.1f} s; "
         f"{proc.stderr.strip().splitlines()[-1]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import deepvision_tpu_torch  # noqa: F401  (fails outside the checkout)

    smi = phase_card()
    phase_build()
    errs = phase_parity()
    times = phase_times()
    launches, results, xs = phase_serve(smi)
    phase_cli(results, xs)

    kernels = []
    for name, t in times.items():
        kernels.append({
            "name": name, "route": "cuda", "source": LRN_SOURCE,
            "replaces": LRN_REPLACES,
            # the served model runs in float32, so the bf16 entry point
            # is off the main path and counts 0 there
            "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
