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
   n=64 and n=192, k=1), odd channel counts (C*4 not a multiple of 16),
   row counts that leave a ragged last tile, and the widest C: f32 to atol
   1e-5 and rtol 1e-5, bf16 to atol 1e-2 and one bf16 step (rtol 2^-7)
   against the plain version run in bf16;
4. times, with CUDA events (``deepvision_tpu_torch/timing.py``: median of
   100 runs after 10 of warm-up, the stream held busy while the host
   queues them), of the kernel, the plain version,
   ``F.local_response_norm`` and a copy of the same bytes at the two
   AlexNet V1 shapes and the three Inception V1 stem LRNs (n=64 on
   C=64, n=192 and n=5 on C=192) at batch 64, beside the least time the
   card could take. "Cold" rotates over distinct input and output
   buffers, at least 100 MB of inputs, so that each call misses the 50 MB
   L2; "warm" calls on one buffer. The share of the bound is the cold one;
5. serve: ``load_served("alexnet1")`` at 224x224x3 and 1000 classes with
   seeded weights, an ``InferenceEngine`` on buckets (1, 4, 16, 64), 96
   seeded requests; the answers are held against the same module run with
   the plain LRN, and the LRN launch count must be 2 per batch; then
   ``torch.profiler`` windows over one bucket-64 batch (device time by
   kernel and the LRN's share with host and card traced; the device's
   idle share from windows that trace the card alone);
6. CLI: the same model through ``python -m deepvision_tpu_torch.serve``
   on stdin-JSONL, answering like the engine.

It then prints the ``{"kernels": [...]}`` line (with the per-shape times
under ``shapes``), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import os
import re
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
# (name, shape, size, k): AlexNet V1's LRNs at batch 64, the shapes the
# served model gives the kernel (their sums make the kernels line), then
# Inception V1's stem LRNs at batch 64, whose window costs O(C) and not
# O(C*n) only if n=192 takes about the time of n=5 on the same input
ALEXNET_V1_LRNS = [("lrn1", (64, 55, 55, 96), 5, 2.0),
                   ("lrn2", (64, 27, 27, 256), 5, 2.0)]
TIMED_LRNS = ALEXNET_V1_LRNS + [
    ("inception1_lrn1", (64, 56, 56, 64), 64, 1.0),
    ("inception1_lrn2", (64, 56, 56, 192), 192, 1.0),
    ("inception1_c192_n5", (64, 56, 56, 192), 5, 1.0),
]
# float operations an element whatever n is: square, two window adds,
# scale, add k, log2, scale by -beta, exp2, multiply
LRN_OPS_PER_ELEMENT = 9
# (name, shape, size, k, input scale)
PARITY_CASES = [
    ("alexnet1_lrn1", (64, 55, 55, 96), 5, 2.0, 1.0),
    ("alexnet1_lrn2", (64, 27, 27, 256), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn1", (8, 55, 55, 64), 5, 2.0, 1.0),
    ("alexnet2_tf_lrn2", (8, 27, 27, 192), 5, 2.0, 1.0),
    ("inception1_lrn1", (8, 56, 56, 64), 64, 1.0, 2.0),
    ("inception1_lrn2", (8, 56, 56, 192), 192, 1.0, 2.0),
    ("odd_c56", (3, 3, 3, 56), 5, 2.0, 1.0),
    # 289 rows: a ragged last tile at 4 (f32) and 8 (bf16) rows a tile
    ("ragged_rows", (1, 17, 17, 96), 5, 2.0, 1.0),
    # C*4 and C*2 not multiples of 16: one channel a lane, and a last
    # tile whose bytes end off a 16-byte boundary (63 rows, 4 a tile in
    # f32, 8 in bf16)
    ("odd_c57_ragged", (1, 7, 9, 57), 5, 2.0, 1.0),
    ("odd_c57_n64", (2, 9, 9, 57), 64, 1.0, 2.0),
    ("tiny_c3", (1, 1, 1, 3), 5, 2.0, 1.0),  # under 16 bytes in all
    ("wide_c768", (2, 9, 9, 768), 5, 2.0, 1.0),
    ("wide_c768_n192", (2, 9, 9, 768), 192, 1.0, 2.0),
    # a narrow window other than n=5 takes the prefix-sum path too
    ("n3_c96", (2, 9, 9, 96), 3, 2.0, 1.0),
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


def _lrn_bound_ms(shape, itemsize: int) -> tuple[float, str]:
    """Least time for one LRN: one read and one write of the activation
    over the HBM rate, against ``LRN_OPS_PER_ELEMENT`` f32 operations an
    element (what the algorithm needs, whatever n) over the f32 rate."""
    numel = int(np.prod(shape))
    bytes_s = 2 * numel * itemsize / HBM_BYTES_PER_S
    ops_s = numel * LRN_OPS_PER_ELEMENT / F32_OPS_PER_S
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
    for kernel, report in _ptxas_report(_build.build_logs.get("lrn", "")):
        _say(f"[build] ptxas {kernel}: {report}")


def _ptxas_report(log: str) -> list[tuple[str, str]]:
    """(instantiation, "N registers, spills") for each kernel in nvcc's
    ``-Xptxas -v`` output; shared memory is dynamic (the launch plan)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"kernelI(13__nv_bfloat16|f)Li(\d+)ELb([01])E",
                          m[1])
            name = (f"{'bf16' if t[1] != 'f' else 'f32'} vec={t[2]} "
                    f"{'prefix sums' if t[3] == '1' else 'n=5 slide'}"
                    ) if t else m[1]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = f"{m[1]}/{m[2]} bytes spilled (stores/loads)"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, f"{m[1]} registers, {spills}"))
            name = None
    return out


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
    # a base pointer off a 16-byte boundary is refused, never copied
    odd = torch.zeros(65, device="cuda")[1:].view(1, 1, 1, 64)
    before = local_response_norm_cuda.launches
    try:
        local_response_norm_cuda(odd)
    except ValueError as e:
        assert "16-byte aligned" in str(e), e
    else:
        raise AssertionError("a misaligned tensor was launched")
    assert local_response_norm_cuda.launches == before
    _say("[parity] a tensor 4 bytes off a 16-byte boundary is refused")
    return errs


def phase_times() -> dict[str, dict]:
    """Kernel, plain and library times at every shape of ``TIMED_LRNS``,
    cold and warm; per kernel, the cold sums over AlexNet V1's two LRNs
    (one served batch) and the per-shape detail."""
    import torch
    import torch.nn.functional as F

    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.ops.lrn_cuda import (
        KERNEL_NAMES,
        local_response_norm_cuda,
    )
    from deepvision_tpu_torch.timing import cold_inputs, time_ms

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype, kernel in KERNEL_NAMES.items():
        tot = {"ms": 0.0, "ms_warm": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0, "bound_ms": 0.0}
        bound_by, shapes, xs = set(), [], []
        for lrn, shape, size, k in TIMED_LRNS:
            if not xs or xs[0].shape != shape:  # same shape: same inputs
                xs = None  # free the last shape's buffers first
                xs = cold_inputs(shape, dtype, gen)
            n_bufs = len(xs)

            def kern(x, size=size, k=k):
                return local_response_norm_cuda(x, size, 1e-4, 0.75, k)

            def plain(x, size=size, k=k):
                return local_response_norm_reference(x, size, 1e-4, 0.75, k)

            def lib(x, size=size, k=k):  # on the channels_last NCHW view
                return F.local_response_norm(x.permute(0, 3, 1, 2), size,
                                             1e-4, 0.75, k)

            row = {"lrn": lrn, "shape": list(shape), "size": size, "k": k,
                   "cold_buffers": n_bufs,
                   "ms": time_ms(kern, xs),
                   "ms_warm": time_ms(kern, xs[:1]),
                   "plain_ms": time_ms(plain, xs),
                   "library_ms": time_ms(lib, xs),
                   # one read and one write of the same bytes: what the
                   # card reaches in practice, beside the bound
                   "copy_ms": time_ms(torch.clone, xs)}
            lib_err = (lib(xs[0]).permute(0, 2, 3, 1).float()
                       - plain(xs[0]).float()).abs().max().item()
            row["bound_ms"], row["bound_by"] = _lrn_bound_ms(
                shape, xs[0].element_size())
            row["bound_share"] = row["bound_ms"] / row["ms"]
            bound_by.add(row["bound_by"])
            shapes.append(row)
            _say(f"[time] {kernel} {lrn} {tuple(shape)} n={size}: kernel "
                 f"cold {row['ms']:.4f} ms warm {row['ms_warm']:.4f} ms "
                 f"({n_bufs} buffers cold), plain {row['plain_ms']:.4f} ms, "
                 f"F.local_response_norm {row['library_ms']:.4f} ms (max "
                 f"abs diff to plain {lib_err:.2e}), bound "
                 f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
                 f"({row['bound_share']:.1%} of the bound, cold; a copy "
                 f"of the same bytes {row['copy_ms']:.4f} ms, "
                 f"{row['bound_ms'] / row['copy_ms']:.1%})")
            if (lrn, shape, size, k) in ALEXNET_V1_LRNS:
                for key in tot:
                    tot[key] += row[key]
        by_name = {r["lrn"]: r for r in shapes}
        ratio = (by_name["inception1_lrn2"]["ms"]
                 / by_name["inception1_c192_n5"]["ms"])
        _say(f"[time] {kernel} (64,56,56,192): n=192 takes {ratio:.3f}x "
             "the time of n=5 on the same input (cold)")
        tot["bound_by"] = "bytes" if bound_by == {"bytes"} else "operations"
        tot["shapes"] = shapes
        out[kernel] = tot
        xs = None
        torch.cuda.empty_cache()
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
    _profile_batch(served, xs[:BUCKETS[-1]])
    return by_kernel, results, xs


def _profile_batch(served, batch: np.ndarray, top: int = 10,
                   windows: int = 5) -> None:
    """``torch.profiler`` windows over one served batch of the largest
    bucket (``ServedModel.run``: H2D copy, forward, top-k, D2H copy). One
    window traces the host and the card: the device time by kernel name
    and the LRN's share of it. Then ``windows`` windows trace the card
    alone, so that no tracing of host operations lengthens the host's
    wall time: the device's idle share of it, 1 - busy / wall, and the
    H2D copy's time in each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    served.run(batch)  # warm: the engine already ran this bucket
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        served.run(batch)
        torch.cuda.synchronize()

    def device_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    on_device = [e for e in prof.key_averages()
                 if e.device_type == cuda and device_us(e) > 0]
    total_us = sum(device_us(e) for e in on_device)
    if total_us == 0:
        _say(f"[profile] bucket-{len(batch)} batch: device time by kernel "
             "not measured (the profiler recorded no device time)")
        return
    lrn_us = sum(device_us(e) for e in on_device if "lrn" in e.key.lower())
    _say(f"[profile] bucket-{len(batch)} batch (host and card traced): "
         f"device time {total_us / 1e3:.3f} ms in {len(on_device)} "
         f"kernels/copies; LRN {lrn_us / 1e3:.4f} ms = "
         f"{lrn_us / total_us:.2%} of device time")
    for e in sorted(on_device, key=device_us, reverse=True)[:top]:
        _say(f"[profile]   {device_us(e) / 1e3:9.4f} ms "
             f"{device_us(e) / total_us:6.2%} x{e.count} {e.key[:110]}")

    idle = []
    for w in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            served.run(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.events() if e.device_type == cuda]
        busy_us, end = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in events):  # union of device intervals
            if b > end:
                busy_us += b - max(a, end)
                end = b
        if busy_us == 0:
            _say(f"[profile] card-only window {w}: idle share not measured "
                 "(the profiler recorded no device time)")
            return
        h2d_us = sum(e.time_range.end - e.time_range.start for e in events
                     if "HtoD" in e.name)
        idle.append(1 - busy_us / wall_us)
        _say(f"[profile] card-only window {w}: host wall "
             f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
             f"(H2D copy {h2d_us / 1e3:.3f} ms), idle share {idle[-1]:.1%}")
    _say(f"[profile] bucket-{len(batch)} batch: device idle share, median "
         f"of {windows} card-only windows, {statistics.median(idle):.1%} "
         f"(range {min(idle):.1%}-{max(idle):.1%})")


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
            # times: cold, summed over AlexNet V1's two LRNs
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "ms_warm": t["ms_warm"], "shapes": t["shapes"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
