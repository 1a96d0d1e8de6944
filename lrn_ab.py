#!/usr/bin/env python3
"""Time the LRN kernels of two checkouts on one card with one timer.

    python3 lrn_ab.py --against DIR

DIR is another checkout of this repo, for instance a parent commit
unpacked by ``git archive`` into ``build/``. Each of ``ROUNDS`` rounds
runs DIR's kernels, this checkout's, this checkout's again and DIR's
again (A B B A), each in a process of its own, since both packages are
named ``deepvision_tpu_torch``. Every process builds its checkout's
kernels and times that checkout's wrappers with this checkout's
``deepvision_tpu_torch/timing.py``, L2-cold (inputs rotated over
``cold_inputs``) and warm (one buffer), in float32 and bfloat16, on the
same seeded inputs, after holding each against its own plain version:
the forward ``local_response_norm_cuda`` at AlexNet V1's two LRN shapes
at the serving batch of 64, and the backward
``local_response_norm_backward_cuda`` (x and the incoming gradient g) at
the same LRNs at the training batch of 128. It prints one JSON line a
process, the card's name and power limit, and last a JSON summary: the
median of each side's runs.

Needs one CUDA card and ``nvcc``; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (name, shape): AlexNet V1's LRNs, n=5, k=2: the forward at the serving
# batch of 64, the backward at the training batch of 128
SHAPES = [("lrn1", (64, 55, 55, 96)), ("lrn2", (64, 27, 27, 256))]
BACKWARD_SHAPES = [("lrn1", (128, 55, 55, 96)), ("lrn2", (128, 27, 27, 256))]
LRN = (5, 1e-4, 0.75, 2.0)
ROUNDS = 2


def _timing():
    """This checkout's timer, loaded by path so that the package it sits
    in is not imported beside the other checkout's."""
    spec = importlib.util.spec_from_file_location(
        "_lrn_ab_timing", ROOT / "deepvision_tpu_torch" / "timing.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(checkout: Path) -> dict:
    """Cold and warm times of ``checkout``'s forward kernel at ``SHAPES``
    and backward kernel at ``BACKWARD_SHAPES``."""
    import torch

    sys.path.insert(0, str(checkout))
    import deepvision_tpu_torch
    from deepvision_tpu_torch.ops.lrn import (
        local_response_norm_backward_reference,
        local_response_norm_reference,
    )
    from deepvision_tpu_torch.ops.lrn_cuda import (
        local_response_norm_backward_cuda,
        local_response_norm_cuda,
    )

    package = Path(deepvision_tpu_torch.__file__).resolve()
    assert package.is_relative_to(checkout), (package, checkout)
    timing = _timing()
    kernels = {
        "forward": (SHAPES, 1,
                    lambda a: local_response_norm_cuda(*a, *LRN),
                    lambda a: local_response_norm_reference(*a, *LRN)),
        "backward": (BACKWARD_SHAPES, 2,
                     lambda a: local_response_norm_backward_cuda(*a, *LRN),
                     lambda a: local_response_norm_backward_reference(
                         *a, *LRN)),
    }
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    # bf16: both sides compute in f32 and round once, so one bf16 step
    # (2^-7 relative) on top of atol 1e-2
    for dtype, tol in ((torch.float32, dict(atol=1e-5, rtol=1e-5)),
                       (torch.bfloat16, dict(atol=1e-2, rtol=2**-7))):
        for kernel, (shapes, n_in, kern, plain) in kernels.items():
            for lrn, shape in shapes:
                # x, and for the backward g: the same seeded buffers in
                # every process
                bufs = [timing.cold_inputs(shape, dtype, gen)
                        for _ in range(n_in)]
                args = list(zip(*bufs))
                got, want = kern(args[0]).float(), plain(args[0]).float()
                torch.testing.assert_close(
                    got, want, **tol, msg=lambda m: f"{kernel} {lrn}: {m}")
                rows.append({
                    "kernel": kernel,
                    "dtype": str(dtype).removeprefix("torch."), "lrn": lrn,
                    "shape": list(shape), "cold_buffers": len(args),
                    "cold_ms": timing.time_ms(kern, args),
                    "warm_ms": timing.time_ms(kern, args[:1]),
                    "max_abs_err": (got - want).abs().max().item()})
                bufs = args = got = want = None
                torch.cuda.empty_cache()
    return {"checkout": str(checkout), "rows": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", type=Path,
                        help="the other checkout (a directory)")
    parser.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("lrn_ab: no CUDA device visible", file=sys.stderr)
        return 1
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    if args.against is None:
        parser.error("--against DIR is required")
    sides = {"against": args.against.resolve(), "this": ROOT}
    order = ["against", "this", "this", "against"] * ROUNDS
    runs = {side: [] for side in sides}
    for side in order:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(sides[side])],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[side].append(result)
        print(json.dumps({"side": side, **result}), flush=True)
    summary = {}
    for side, results in runs.items():
        summary[side] = {"checkout": str(sides[side]), "runs": len(results)}
        for i, row in enumerate(results[0]["rows"]):
            key = f"{row['kernel']} {row['dtype']} {row['lrn']}"
            summary[side][key] = {
                f"{t}_ms": statistics.median(r["rows"][i][f"{t}_ms"]
                                             for r in results)
                for t in ("cold", "warm")}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
