"""Fixed-shape greedy non-maximum suppression, the twin of
``deepvision_tpu/ops/nms.py``.

As in the JAX code, on each image:

1. the top-K prefilter, K = ``min(N, max(candidate_cap, max_out))``,
   with scores under ``score_thresh`` masked to -inf: a stable
   descending sort, so that equal scores keep their index order, as
   ``jax.lax.top_k`` breaks ties toward the lower index (trap C17;
   ``torch.topk`` promises no order on CUDA, and an untrained head
   saturates many scores to exactly 1.0);
2. the greedy sweep over the K sorted boxes: box i, while alive, kills
   every later box j with ``IoU(i, j) > iou_thresh``;
3. survivors compacted to the front in score order (a stable sort of
   the dead flags), the first ``max_out`` kept, the rest zero.

The sweep is the one step that stock PyTorch cannot express without K
dependent launches. It is the custom op ``deepvision::nms_sweep``: on a
CUDA tensor ``csrc/nms.cu``
(:func:`~deepvision_tpu_torch.ops.nms_cuda.nms_sweep_cuda`, which writes
a fresh mask and only reads ``alive``), on a CPU tensor its plain
version :func:`nms_sweep_reference`, the JAX ``fori_loop`` in torch ops
over the ``(B, K)`` masks, and a fake implementation for
``torch.export``, so that an exported detector holds the op as one node
and never the unrolled loop. Both compute the
IoU with :func:`~deepvision_tpu_torch.ops.iou.broadcast_iou`'s float32
operations in the same order (trap C18) and keep identical indices.

``n_candidates``, the boxes that cleared ``score_thresh``, is the
tripwire: above ``candidate_cap`` the prefilter cut boxes the sweep
would have seen, and the result is no longer exact greedy NMS.
"""

from __future__ import annotations

import torch

from deepvision_tpu_torch.ops.iou import broadcast_iou

__all__ = ["NMS_CANDIDATE_CAP", "nms_sweep", "nms_sweep_reference",
           "nms_prefilter", "batched_nms", "nms_indices"]

# the greedy sweep's working set; eval compares the runtime candidate
# count against this same constant
NMS_CANDIDATE_CAP = 512


def nms_sweep_reference(boxes: torch.Tensor, alive: torch.Tensor,
                        iou_thresh: float) -> torch.Tensor:
    """The plain sweep: ``boxes (B, K, 4)`` corners sorted by score,
    ``alive (B, K)`` bool seeds -> the alive mask after the greedy
    sweep, one step a box as the JAX ``fori_loop``."""
    k = boxes.shape[1]
    idx = torch.arange(k, device=boxes.device)
    over = (broadcast_iou(boxes, boxes) > iou_thresh) & (
        idx[None, :] > idx[:, None])
    alive = alive.clone()
    for i in range(k):
        alive &= ~(over[:, i] & alive[:, i:i + 1])
    return alive


@torch.library.custom_op("deepvision::nms_sweep", mutates_args=(),
                         device_types="cpu")
def _nms_sweep_op(boxes: torch.Tensor, alive: torch.Tensor,
                  iou_thresh: float) -> torch.Tensor:
    return nms_sweep_reference(boxes, alive, iou_thresh)


@_nms_sweep_op.register_kernel("cuda")
def _nms_sweep_cuda(boxes, alive, iou_thresh):
    from deepvision_tpu_torch.ops.nms_cuda import nms_sweep_cuda

    return nms_sweep_cuda(boxes, alive, iou_thresh)


@_nms_sweep_op.register_fake
def _nms_sweep_fake(boxes, alive, iou_thresh):
    return torch.empty_like(alive)


def nms_sweep(boxes: torch.Tensor, alive: torch.Tensor,
              iou_thresh: float) -> torch.Tensor:
    """The sweep as the op ``deepvision::nms_sweep``, which
    ``torch.export`` keeps as one node (the threshold a constant of the
    graph): the CUDA kernel for a CUDA tensor (which launches or
    raises), the plain version for a CPU one, shape and dtype alone for
    a fake one."""
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS sweep for a tensor on {boxes.device}")
    return _nms_sweep_op(boxes, alive, iou_thresh)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for each image: ``x (B, N, ...)``, ``idx (B,
    K)``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[1] >= n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1],
                                      *x.shape[2:]))], dim=1)


def nms_prefilter(boxes: torch.Tensor, scores: torch.Tensor, *,
                  score_thresh: float, k: int):
    """The top-K prefilter of ``boxes (B, N, 4)``, ``scores (B, N)``: ->
    (the K best boxes ``(B, K, 4)`` in score order, their alive seeds
    (cleared ``score_thresh``), their scores (-inf where not cleared),
    their indices into the input, n_candidates ``(B,)`` int32)."""
    cleared = scores >= score_thresh
    n_candidates = cleared.sum(-1, dtype=torch.int32)
    masked = torch.where(cleared, scores,
                         torch.full_like(scores, float("-inf")))
    top_scores, top_idx = torch.sort(masked, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    return (_gather(boxes, top_idx).contiguous(),
            top_scores > float("-inf"), top_scores, top_idx, n_candidates)


def _nms(boxes, scores, *, iou_thresh, score_thresh, max_out, candidate_cap,
         sweep):
    """-> (indices into the input (B, max_out), scores, valid, n_candidates
    (B,)), the survivors first in score order."""
    k = min(boxes.shape[1], max(candidate_cap, max_out))
    top_boxes, seeds, top_scores, top_idx, n_candidates = nms_prefilter(
        boxes, scores, score_thresh=score_thresh, k=k)
    alive = (sweep or nms_sweep)(top_boxes, seeds, iou_thresh)
    order = torch.sort((~alive).to(torch.uint8), dim=-1, stable=True).indices
    idx = _gather(top_idx, order)[:, :max_out]
    out_scores = _gather(torch.where(alive, top_scores,
                                     torch.zeros_like(top_scores)),
                         order)[:, :max_out]
    valid = _gather(alive, order)[:, :max_out]
    return (_pad(idx, max_out), _pad(out_scores, max_out),
            _pad(valid, max_out), n_candidates)


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor, *,
                iou_thresh: float = 0.5, score_thresh: float = 0.5,
                max_out: int = 100, candidate_cap: int = NMS_CANDIDATE_CAP,
                sweep=None):
    """One image: ``boxes (N, 4)`` corners, ``scores (N,)`` -> (idx
    ``(max_out,)`` int64 into the input, scores, valid, n_candidates
    ``()`` int32), as the JAX ``nms_indices`` gives them (a dead slot's
    idx is the candidate's; only slots past K are 0)."""
    idx, out_scores, valid, n_cand = _nms(
        boxes[None], scores[None], iou_thresh=iou_thresh,
        score_thresh=score_thresh, max_out=max_out,
        candidate_cap=candidate_cap, sweep=sweep)
    return idx[0], out_scores[0], valid[0], n_cand[0]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, *, iou_thresh: float = 0.5,
                score_thresh: float = 0.5, max_out: int = 100,
                candidate_cap: int = NMS_CANDIDATE_CAP, sweep=None):
    """Class-agnostic greedy NMS over a batch: ``boxes (B, N, 4)``,
    ``scores (B, N)``, ``classes (B, N)`` -> (boxes ``(B, max_out, 4)``,
    scores, classes, valid, n_candidates ``(B,)``), zero where not valid.
    ``sweep`` replaces the device's sweep (the plain version, to hold
    the kernel against it on the card)."""
    idx, out_scores, valid, n_cand = _nms(
        boxes, scores, iou_thresh=iou_thresh, score_thresh=score_thresh,
        max_out=max_out, candidate_cap=candidate_cap, sweep=sweep)
    out_boxes = torch.where(valid[..., None], _gather(boxes, idx),
                            torch.zeros((), dtype=boxes.dtype,
                                        device=boxes.device))
    out_classes = torch.where(valid, _gather(classes, idx),
                              torch.zeros((), dtype=classes.dtype,
                                          device=classes.device))
    return out_boxes, out_scores, out_classes, valid, n_cand
