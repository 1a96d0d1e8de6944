"""Serving CLI of the port: the stdin-JSONL twin of ``serve.py``.

    python -m deepvision_tpu_torch.serve -m alexnet1 --buckets 1,4,16,64
    {"id": 1, "model": "alexnet1", "input": [[[...224x224x3 floats...]]]}
    -> {"id": 1, "result": {"classes": [...], "probs": [...]}, "ms": 4.2}
    python -m deepvision_tpu_torch.serve -m yolov3=runs/yolov3 --score 0.5
    {"id": 1, "input": [[[...416x416x3 floats in [-1, 1]...]]]}
    -> {"id": 1, "result": {"boxes": [[x1, y1, x2, y2], ...],
        "scores": [...], "classes": [...]}, "ms": 9.1}
    python -m deepvision_tpu_torch.serve -m dcgan=runs/dcgan
    {"id": 1, "input": [...100 noise floats...]}
    -> {"id": 1, "result": {"image": [[[...28x28x1 in [-1, 1]...]]]}}

One JSON request per line on stdin, one response per line on stdout in
submission order; start-up chatter goes to stderr. ``-m`` is repeatable.
Weights are fresh, drawn from ``--seed``, unless ``-m name=workdir``
names a directory whose ``ckpt/`` holds the port trainer's checkpoints
(``runs/alexnet1`` after ``python -m deepvision_tpu_torch.train -m
alexnet1``, ``-m inception1=runs/inception1`` after training
``inception1``, ``-m resnet50=runs/resnet50`` after training
``resnet50``, ``-m yolov3=runs/yolov3`` after training ``yolov3``): then
the newest verified epoch. ``yolov3`` serves the detect task: ``--score``
and ``--iou`` are its NMS thresholds, and its boxes are normalized
corners. ``dcgan`` (or ``dcgan_generator``) serves the DCGAN generator
of a ``train -m dcgan`` checkpoint: the input is the noise, the answer
the image. The HTTP surface and the fleet mode of ``serve.py`` come
later.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from deepvision_tpu_torch.serve.admission import ShedError
from deepvision_tpu_torch.serve.engine import InferenceEngine
from deepvision_tpu_torch.serve.models import load_served


def build_engine(args) -> InferenceEngine:
    models = []
    for spec in args.model:
        name, _, workdir = spec.partition("=")
        models.append(load_served(
            name, workdir or None, seed=args.seed, device=args.device,
            input_size=args.input_size, num_classes=args.num_classes,
            top_k=args.top, score_thresh=args.score,
            iou_thresh=args.iou))
    buckets = tuple(int(b) for b in args.buckets.split(","))
    print(f"serving {[m.name for m in models]} buckets={buckets} on "
          f"{args.device}; warming...", file=sys.stderr)
    engine = InferenceEngine(
        models, buckets=buckets, max_queue=args.max_queue,
        per_model_limit=args.per_model_limit,
        batch_window_s=args.batch_window_ms / 1e3)
    print(f"warmup done in {engine.warmup_s}s; precision "
          f"{engine.precision}", file=sys.stderr)
    return engine


def run_stdin(engine: InferenceEngine, args, stdin=None, stdout=None):
    """One JSON request per line; responses, in submission order, to
    ``stdout``. Requests keep flowing while earlier ones run, so the
    dispatcher sees real micro-batches even from a pipe."""
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    pending: list[tuple[object, object, float]] = []  # (id, future, t0)

    def emit(rid, fut, t0):
        try:
            result = fut.result(timeout=args.timeout_s + 1.0)
            line = {"id": rid, "result": result,
                    "ms": round((time.perf_counter() - t0) * 1e3, 2)}
        except ShedError as e:
            line = {"id": rid, "error": str(e),
                    "retry_after": e.retry_after_s}
        except Exception as e:
            line = {"id": rid, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(line), file=stdout, flush=True)

    for raw in stdin:
        raw = raw.strip()
        if not raw:
            continue
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            x = np.asarray(req["input"], np.float32)
        except (ValueError, KeyError, TypeError) as e:
            print(json.dumps({"error": f"bad request: {e}"}), file=stdout,
                  flush=True)
            continue
        rid = req.get("id")
        t0 = time.perf_counter()
        try:
            fut = engine.submit(x, model=req.get("model"),
                                timeout_s=args.timeout_s)
        except ShedError as e:
            print(json.dumps({"id": rid, "error": str(e),
                              "retry_after": e.retry_after_s}),
                  file=stdout, flush=True)
            continue
        except (ValueError, RuntimeError) as e:
            print(json.dumps({"id": rid, "error": str(e)}), file=stdout,
                  flush=True)
            continue
        pending.append((rid, fut, t0))
        # bounded in-flight window: about two ladders' worth queued, so
        # batching happens without unbounded memory on long streams
        while len(pending) > 2 * max(engine.buckets):
            emit(*pending.pop(0))
    for item in pending:
        emit(*item)


def main(argv=None, stdin=None, stdout=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m deepvision_tpu_torch.serve",
        description=__doc__.split("\n\n")[0])
    p.add_argument("-m", "--model", action="append", required=True,
                   metavar="NAME", help="registry model to serve "
                   "(repeatable)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, which is never chosen "
                   "for you")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the fresh weights")
    p.add_argument("--buckets", default="1,4,16,64",
                   help="batch-size ladder, comma-separated")
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--per-model-limit", type=int, default=None)
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="how long a partial batch waits to fill")
    p.add_argument("--timeout-s", type=float, default=30.0,
                   help="per-request deadline")
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--score", type=float, default=0.5,
                   help="detect: the NMS score threshold")
    p.add_argument("--iou", type=float, default=0.5,
                   help="detect: the NMS IoU threshold")
    args = p.parse_args(argv)
    engine = build_engine(args)
    try:
        run_stdin(engine, args, stdin, stdout)
    finally:
        engine.close()
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    t = engine.telemetry
    print(f"[serve] completed={t.completed} batches={t.batches} "
          f"failed={t.failed} shed={t.shed} timed_out={t.timed_out}; "
          f"kernel launches {{'nms_sweep': {nms_sweep_cuda.launches}}}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
