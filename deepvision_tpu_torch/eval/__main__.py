"""Offline evaluation CLI of the port, the twin of ``evaluate.py``'s
``detection``, ``pose`` and ``gan`` subcommands.

    python -m deepvision_tpu_torch.eval detection -m yolov3|centernet \
        --workdir runs/yolov3 --data-dir DIR [--split val] [--names voc] \
        [--num-classes N] [--size 416] [--batch-size 16] [--score 0.05] \
        [--iou 0.5] [--ap-method area|11point] [--epoch E]
    python -m deepvision_tpu_torch.eval pose -m hourglass104 \
        --workdir runs/hourglass104 --data-dir DIR [--split val] \
        [--num-joints K] [--size 256] [--batch-size 16] [--threshold 0.5] \
        [--norm 0.1] [--epoch E]
    python -m deepvision_tpu_torch.eval gan -m cyclegan|dcgan \
        --workdir runs/cyclegan [--size 64] [--n 256] [--epoch E]

Scores the newest verified checkpoint under ``--workdir`` (or
``--epoch``'s; seeded fresh weights without a workdir) on the
``{split}-*`` detection shards of ``--data-dir`` (decoded on the card by
nvJPEG, resized to ``--size``, unaugmented, the last batch short) or,
without a data directory, on the synthetic set (64 images, at most 128
px, as ``evaluate.py``). The detections are ``yolo_postprocess``'s at
``--score`` (NMS at IoU 0.5); ``--iou`` is the matching threshold of the
mAP. One JSON line goes to stdout: ``{"metric": "mAP", "iou", "value",
"images", "per_class", "nms_candidates_max", "nms_exact"}``, where
``nms_candidates_max`` is the most boxes of one image that cleared the
score threshold and ``nms_exact`` says whether that stayed within the
NMS candidate cap (else greedy NMS was cut short, and a warning goes to
stderr). ``-m centernet`` decodes the last stack's peaks
(``ops/centernet_decode``, its 100 best, kept at ``--score`` or above)
and has no NMS, so both fields are null. ``pose`` scores the last
stack's heatmap argmax against the keypoints of the ``{split}-*`` pose
shards (each person cropped at the validation margin) or, without a
data directory, of the synthetic set (32 images, at most 128 px), with
``--num-joints`` joints (16 by default): ``{"metric": "PCK@<threshold>",
"norm", "value", "per_joint"}``, where a joint is correct within
``threshold · norm`` of the crop. ``gan`` scores a GAN checkpoint (it
needs ``--workdir``) on the hermetic synthetic sets, as ``evaluate.py``:
``-m cyclegan`` translates ``--n`` held-out unpaired images
(``synthetic_unpaired(seed=113)`` at ``--size``) both ways and prints the
inversion score (``eval/gan.inversion_score``); ``-m dcgan`` trains a
LeNet-5 judge (Adam 1e-3, batch 64, 4 epochs on 1536 synthetic digits in
[-1, 1]), samples ``--n`` images from noise of seed 7 and prints their
Inception Score over the held-out reals' (``score``), the judge's
held-out accuracy and the classes the samples cover. Scores are printed,
not gated. The last stderr line counts the kernel launches. It runs on the card (``--device cuda``, the default, which
raises without one) and on the CPU when asked.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

__all__ = ["main", "cmd_detection", "cmd_pose", "cmd_gan"]


def cmd_detection(args) -> dict:
    import torch

    from deepvision_tpu_torch.data.detection import (
        eval_batches,
        synthetic_batches,
        synthetic_detection,
    )
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.eval.detection import class_names, evaluate_map
    from deepvision_tpu_torch.ops.centernet_decode import decode_centernet
    from deepvision_tpu_torch.ops.iou import xywh_to_corners
    from deepvision_tpu_torch.ops.nms import NMS_CANDIDATE_CAP
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda
    from deepvision_tpu_torch.ops.normalize import maybe_normalize
    from deepvision_tpu_torch.ops.yolo_postprocess import yolo_postprocess
    from deepvision_tpu_torch.serve.models import load_served

    device = _device(args)
    names = class_names(args.names)
    if args.num_classes:  # synthetic runs train with few classes
        names = (names[:args.num_classes] if args.num_classes <= len(names)
                 else [f"class{i}" for i in range(args.num_classes)])
    num_classes = len(names)
    size = args.size
    if args.data_dir:
        files = sorted(Path(args.data_dir).glob(f"{args.split}-*"))
        if not files:
            raise FileNotFoundError(
                f"no {args.split}-* records under {args.data_dir}")
        batches = eval_batches(files, args.batch_size, size, pad=False)
    else:
        size = min(size, 128)
        imgs, boxes, labels = synthetic_detection(64, size=size,
                                                  num_classes=num_classes)
        batches = synthetic_batches(imgs, boxes, labels, args.batch_size)
    served = load_served(args.model, args.workdir, epoch=args.epoch,
                         device=device, input_size=size,
                         num_classes=num_classes)

    centernet = args.model == "centernet"
    dets, gts = [], []
    # the greedy NMS's exactness tripwire; CenterNet's peak decode has
    # no candidate cap, so its fields stay null
    candidates_max = None if centernet else 0
    feed = DevicePrefetcher(batches, device)
    try:
        for batch in feed:
            with torch.inference_mode():
                preds = served.module(maybe_normalize(batch["image"],
                                                      "tanh"))
                if centernet:
                    d = decode_centernet(*preds[-1])
                    out = (xywh_to_corners(d["boxes"]), d["scores"],
                           d["classes"], d["scores"] >= args.score)
                else:
                    out = yolo_postprocess(preds, num_classes,
                                           score_thresh=args.score)
            b_boxes, b_scores, b_cls, b_valid = (
                t.cpu().numpy() for t in out[:4])
            if not centernet:
                candidates_max = max(candidates_max,
                                     int(out[4].cpu().numpy().max()))
            true_boxes = xywh_to_corners(batch["boxes"]).cpu().numpy()
            true_labels = batch["label"].cpu().numpy()
            for i in range(len(b_boxes)):
                keep = b_valid[i].astype(bool)
                dets.append({"boxes": b_boxes[i][keep],
                             "scores": b_scores[i][keep],
                             "classes": b_cls[i][keep]})
                real = true_labels[i] >= 0
                gts.append({"boxes": true_boxes[i][real],
                            "classes": true_labels[i][real]})
    finally:
        feed.close()
    out = evaluate_map(dets, gts, num_classes, iou_thresh=args.iou,
                       method=args.ap_method)
    per_class = {names[c]: round(float(out["ap"][c]), 4)
                 for c in range(num_classes) if np.isfinite(out["ap"][c])}
    if candidates_max is not None and candidates_max > NMS_CANDIDATE_CAP:
        print(f"# WARNING: {candidates_max} candidates cleared the score "
              f"threshold (> candidate_cap={NMS_CANDIDATE_CAP}); greedy-NMS "
              "exactness degraded: raise the cap or the score threshold.",
              file=sys.stderr)
    line = {"metric": "mAP", "iou": args.iou, "value": round(out["map"], 4),
            "images": len(dets), "per_class": per_class,
            "nms_candidates_max": candidates_max,
            "nms_exact": (None if candidates_max is None
                          else candidates_max <= NMS_CANDIDATE_CAP)}
    print(json.dumps(line), flush=True)
    print(f"[eval] {args.model}: {len(dets)} images on {device}; kernel "
          f"launches {{'nms_sweep': {nms_sweep_cuda.launches}}}",
          file=sys.stderr, flush=True)
    return line


def _device(args):
    from deepvision_tpu_torch.device import resolve_device, strict_fp32

    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()
    return device


def cmd_pose(args) -> dict:
    import torch

    from deepvision_tpu_torch.data.pose import (
        eval_batches,
        synthetic_pose,
        synthetic_pose_batches,
    )
    from deepvision_tpu_torch.data.prefetch import DevicePrefetcher
    from deepvision_tpu_torch.eval.pose import heatmap_argmax_keypoints, pck
    from deepvision_tpu_torch.ops.normalize import maybe_normalize
    from deepvision_tpu_torch.serve.models import load_served

    device = _device(args)
    size = args.size
    joints = args.num_joints or 16
    if args.data_dir:
        files = sorted(Path(args.data_dir).glob(f"{args.split}-*"))
        if not files:
            raise FileNotFoundError(
                f"no {args.split}-* records under {args.data_dir}")
        batches = eval_batches(files, args.batch_size, size, pad=False)
    else:
        size = min(size, 128)
        imgs, kx, ky, v = synthetic_pose(32, size=size, num_joints=joints)
        batches = synthetic_pose_batches(imgs, kx, ky, v, args.batch_size)
    served = load_served(args.model, args.workdir, epoch=args.epoch,
                         device=device, input_size=size,
                         num_heatmaps=joints)
    preds, trues, viss = [], [], []
    feed = DevicePrefetcher(batches, device)
    try:
        for batch in feed:
            with torch.inference_mode():
                heat = served.module(maybe_normalize(batch["image"],
                                                     "tanh"))[-1]
            heat = heat.cpu().numpy()
            preds.append(heatmap_argmax_keypoints(heat) / heat.shape[1])
            trues.append(torch.stack([batch["kx"], batch["ky"]], dim=-1)
                         .cpu().numpy())
            viss.append(batch["v"].cpu().numpy())
    finally:
        feed.close()
    pred, true, vis = (np.concatenate(a) for a in (preds, trues, viss))
    out = pck(pred, true, vis, norm_length=np.full(len(pred), args.norm),
              threshold=args.threshold)
    line = {"metric": f"PCK@{args.threshold}", "norm": args.norm,
            "value": round(out["pck"], 4),
            "per_joint": [round(float(x), 4) if np.isfinite(x) else None
                          for x in out["per_joint"]]}
    print(json.dumps(line), flush=True)
    # no kernel of the port's is on the pose path
    print(f"[eval] {args.model}: {len(pred)} images on {device}; kernel "
          "launches {}", file=sys.stderr, flush=True)
    return line


def _judge(device, steps_per_epoch: int = 24, epochs: int = 4,
           bs: int = 64):
    """LeNet-5 trained on the first 1536 synthetic digits in [-1, 1]
    (Adam 1e-3, float32) -> (module, held-out images, their labels)."""
    import torch

    from deepvision_tpu_torch.data.mnist import synthetic_mnist
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.optimizers import make_optimizer
    from deepvision_tpu_torch.train.state import TrainState
    from deepvision_tpu_torch.train.steps import classification_train_step

    imgs, labels = synthetic_mnist(2048, seed=0)
    imgs = (imgs * 2.0 - 1.0).astype(np.float32)
    module = create_model("lenet5", device=device, seed=0, num_classes=10)
    opt, _ = make_optimizer({"optimizer": "adam",
                             "optimizer_params": {"lr": 1e-3}},
                            module.parameters())
    state = TrainState(module, opt)
    x = torch.from_numpy(imgs).to(device)
    y = torch.from_numpy(labels).to(device)
    for _ in range(epochs):
        for i in range(0, steps_per_epoch * bs, bs):
            classification_train_step(
                state, {"image": x[i:i + bs], "label": y[i:i + bs]}, None)
    module.eval()
    n = steps_per_epoch * bs
    return module, x[n:], labels[n:]


def cmd_gan(args) -> dict:
    import torch

    from deepvision_tpu_torch.eval.gan import (
        embed_samples,
        inception_score,
        inversion_score,
    )
    from deepvision_tpu_torch.models import create_model
    from deepvision_tpu_torch.train.checkpoint import CheckpointManager

    device = _device(args)
    if not args.workdir:
        raise SystemExit("eval gan scores a checkpoint: pass --workdir")
    mgr = CheckpointManager(Path(args.workdir) / "ckpt")
    out = {"model": args.model}
    if args.model == "cyclegan":
        from deepvision_tpu_torch.data.gan import synthetic_unpaired

        gens = {}
        for net in ("gen_a2b", "gen_b2a"):
            weights, _ = mgr.restore_model(args.epoch, device=device, net=net)
            gens[net] = create_model("cyclegan_generator", device=device)
            gens[net].load_state_dict(weights)
            gens[net].eval()
        a, b = synthetic_unpaired(args.n, size=args.size, seed=113)

        def translate(net, x, bs=16):
            with torch.inference_mode():
                return np.concatenate([
                    gens[net](torch.from_numpy(x[i:i + bs]).to(device))
                    .float().cpu().numpy() for i in range(0, len(x), bs)])

        scores = inversion_score(translate("gen_a2b", a),
                                 translate("gen_b2a", b), a, b)
        out.update(n=len(a), **{k: round(v, 5 if k != "score" else 4)
                                for k, v in scores.items()})
    else:
        weights, meta = mgr.restore_model(args.epoch, device=device,
                                          net="generator")
        gen = create_model("dcgan_generator", device=device,
                           noise_dim=meta.get("noise_dim") or 100)
        gen.load_state_dict(weights)
        gen.eval()
        judge, held, labels = _judge(device)

        def probs(x):
            with torch.inference_mode():
                return torch.softmax(judge(x).float(), -1).cpu().numpy()

        p_real = probs(held)
        z = torch.randn((args.n, gen.noise_dim), device=device,
                        generator=torch.Generator(device).manual_seed(7))
        with torch.inference_mode():
            samples = gen(z).float().cpu().numpy()
        p_gen = probs(torch.from_numpy(embed_samples(samples)).to(device))
        is_gen, is_real = inception_score(p_gen), inception_score(p_real)
        out.update(n=int(args.n),
                   judge_holdout_acc=round(
                       float((p_real.argmax(1) == labels).mean()), 4),
                   is_generated=round(is_gen, 3), is_real=round(is_real, 3),
                   class_coverage=int(len(set(p_gen.argmax(1)))),
                   score=round(is_gen / is_real, 4))
    out["epoch"] = mgr.restore_meta(args.epoch)["epoch"] \
        if args.epoch is not None else mgr.latest_epoch()
    print(json.dumps(out), flush=True)
    # no kernel of the port's is on the GAN path
    print(f"[eval] {args.model} on {device}; kernel launches {{}}",
          file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m deepvision_tpu_torch.eval",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("detection", help="detection mAP")
    sp.add_argument("-m", "--model", default="yolov3",
                    choices=["yolov3", "centernet"])
    sp.add_argument("--workdir", default=None)
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--split", default="val")
    sp.add_argument("--names", default="voc", choices=["voc", "mscoco"])
    sp.add_argument("--num-classes", type=int, default=None,
                    help="override the class count (synthetic runs)")
    sp.add_argument("--size", type=int, default=416)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--score", type=float, default=0.05)
    sp.add_argument("--iou", type=float, default=0.5)
    sp.add_argument("--ap-method", default="area",
                    choices=["area", "11point"])
    sp.add_argument("--epoch", type=int, default=None,
                    help="saved epoch to score (default: the newest)")
    sp.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    sp.set_defaults(fn=cmd_detection)
    sp = sub.add_parser("pose", help="pose PCK")
    sp.add_argument("-m", "--model", default="hourglass104",
                    choices=["hourglass104"])
    sp.add_argument("--num-joints", type=int, default=None,
                    help="the joint count (default 16; synthetic runs)")
    sp.add_argument("--workdir", default=None)
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--split", default="val")
    sp.add_argument("--size", type=int, default=256)
    sp.add_argument("--batch-size", type=int, default=16)
    sp.add_argument("--threshold", type=float, default=0.5)
    sp.add_argument("--norm", type=float, default=0.1,
                    help="the PCK reference length, a fraction of the "
                         "crop")
    sp.add_argument("--epoch", type=int, default=None,
                    help="saved epoch to score (default: the newest)")
    sp.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    sp.set_defaults(fn=cmd_pose)
    sp = sub.add_parser("gan", help="GAN scores on the synthetic sets")
    sp.add_argument("-m", "--model", default="cyclegan",
                    choices=["cyclegan", "dcgan"])
    sp.add_argument("--workdir", default=None)
    sp.add_argument("--size", type=int, default=64)
    sp.add_argument("--n", type=int, default=256,
                    help="held-out images (cyclegan) / samples (dcgan)")
    sp.add_argument("--epoch", type=int, default=None,
                    help="saved epoch to score (default: the newest)")
    sp.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    sp.set_defaults(fn=cmd_gan)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
