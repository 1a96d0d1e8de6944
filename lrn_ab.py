#!/usr/bin/env python3
"""Time the LRN kernels of two checkouts on one card with one timer.

    python3 lrn_ab.py --against DIR

DIR is another checkout of this repo, for instance a parent commit
unpacked by ``git archive`` into ``build/``. Each of ``ROUNDS`` rounds
runs DIR's kernel, this checkout's, this checkout's again and DIR's again
(A B B A), each in a process of its own, since both packages are named
``deepvision_tpu_torch``. Every process builds its checkout's
``csrc/lrn.cu`` and times that checkout's ``local_response_norm_cuda``
with this checkout's ``deepvision_tpu_torch/timing.py``, L2-cold (inputs
rotated over ``cold_inputs``) and warm (one buffer), at AlexNet V1's two
LRN shapes at batch 64 in float32 and bfloat16, on the same seeded
inputs, after holding it against its own plain version. It prints one
JSON line a process, the card's name and power limit, and last a JSON
summary: the median of each side's runs.

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
# (name, shape): AlexNet V1's LRNs at batch 64, n=5, k=2
SHAPES = [("lrn1", (64, 55, 55, 96)), ("lrn2", (64, 27, 27, 256))]
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
    """Cold and warm times of ``checkout``'s kernel at ``SHAPES``."""
    import torch

    sys.path.insert(0, str(checkout))
    import deepvision_tpu_torch
    from deepvision_tpu_torch.ops.lrn import local_response_norm_reference
    from deepvision_tpu_torch.ops.lrn_cuda import local_response_norm_cuda

    package = Path(deepvision_tpu_torch.__file__).resolve()
    assert package.is_relative_to(checkout), (package, checkout)
    timing = _timing()

    def kern(x):
        return local_response_norm_cuda(x, 5, 1e-4, 0.75, 2.0)

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for lrn, shape in SHAPES:
            xs = timing.cold_inputs(shape, dtype, gen)
            err = (kern(xs[0]).float() - local_response_norm_reference(
                xs[0], 5, 1e-4, 0.75, 2.0).float()).abs().max().item()
            assert err <= atol, (lrn, dtype, err)
            rows.append({
                "dtype": str(dtype).removeprefix("torch."), "lrn": lrn,
                "shape": list(shape), "cold_buffers": len(xs),
                "cold_ms": timing.time_ms(kern, xs),
                "warm_ms": timing.time_ms(kern, xs[:1]),
                "max_abs_err": err})
            xs = None
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
            key = f"{row['dtype']} {row['lrn']}"
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
