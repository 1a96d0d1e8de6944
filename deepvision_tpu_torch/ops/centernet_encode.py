"""CenterNet ground-truth targets, encoded inside the train step: the twin
of ``deepvision_tpu/ops/centernet_encode.py``.

Padded boxes ``(B, M, 4)`` (xywh normalized, zero rows for padding) and
labels ``(B, M)`` (-1 for padding) become, on a ``G`` x ``G`` grid:

- ``heatmap (B, G, G, C)``: one Gaussian a box, centred on its integer
  centre cell in its class's channel, of the CornerNet radius at IoU 0.7
  (:func:`gaussian_radius`, sigma = diameter / 6), drawn only within
  that radius and at most :data:`MAX_RADIUS` cells, max-combined;
- ``wh (B, G, G, 2)`` and ``offset (B, G, G, 2)``: each box's size in
  cells and its centre's sub-cell offset, at its centre cell;
- ``mask (B, G, G)``: 1 at the centre cells.

The heatmap's patch scatter is a ``scatter_reduce("amax")``, which is
order-free and exact, as the JAX ``.at[].max``. The centre-cell writes of
the JAX encoder are ``.at[].set(mode="drop")``: padding rows go to an
out-of-range row and are dropped, and of two boxes whose centres share a
cell XLA's scatter keeps the last in index order. ``index_put_`` with
repeated indices leaves the winner undefined on CUDA (trap C19), so each
cell's owner is chosen explicitly, the largest valid box index by
``scatter_reduce(amax)``, and its targets are gathered once, as
``ops/yolo_encode.py`` does for trap C16.

On a CUDA tensor, ATen divides by a Python number as a multiplication by
its reciprocal, which can round otherwise; the divisors that are not
powers of two are given as tensors (:func:`_div`), so that the card
divides as the CPU does.
"""

from __future__ import annotations

import torch

__all__ = ["MIN_OVERLAP", "MAX_RADIUS", "gaussian_radius",
           "encode_centernet"]

MIN_OVERLAP = 0.7  # CornerNet radius IoU target
MAX_RADIUS = 6  # patch cap: (2·6+1)² cells a box


def _div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor``, rounded as one float32 division on either
    device."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def gaussian_radius(height: torch.Tensor, width: torch.Tensor,
                    min_overlap: float = MIN_OVERLAP) -> torch.Tensor:
    """The largest corner displacement (in cells) that keeps IoU at least
    ``min_overlap``: the least of CornerNet's three quadratic cases, in
    the JAX function's float32 operations and order."""
    b1 = height + width
    c1 = _div(width * height * (1 - min_overlap), 1 + min_overlap)
    sq1 = torch.sqrt(torch.clamp(b1 * b1 - 4.0 * c1, min=0.0))
    r1 = (b1 - sq1) / 2.0

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = torch.sqrt(torch.clamp(b2 * b2 - 16.0 * c2, min=0.0))
    r2 = (b2 - sq2) / 8.0

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0.0))
    r3 = _div(b3 + sq3, 2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


@torch.no_grad()
def encode_centernet(boxes: torch.Tensor, labels: torch.Tensor,
                     num_classes: int, grid_size: int, *,
                     max_radius: int = MAX_RADIUS) -> dict:
    """``boxes (B, M, 4)`` normalized xywh, ``labels (B, M)`` (-1 pad) ->
    ``{"heatmap", "wh", "offset", "mask"}`` float32 targets on the
    boxes' device."""
    b, m = labels.shape
    g = grid_size
    dev = boxes.device
    valid = labels >= 0
    cls = labels.long().clamp(0, num_classes - 1)
    cx, cy = boxes[..., 0] * g, boxes[..., 1] * g
    w, h = boxes[..., 2] * g, boxes[..., 3] * g
    ix = cx.long().clamp(0, g - 1)  # truncation, as astype(int32)
    iy = cy.long().clamp(0, g - 1)

    radius = torch.clamp(gaussian_radius(h, w), min=0.0)
    sigma = torch.clamp(_div(2 * radius + 1, 6.0), min=1e-3)

    # the (2·max_radius + 1)² patch around each centre: x along axis 2,
    # y along axis 3, as the JAX encoder lays it out
    k = 2 * max_radius + 1
    d = torch.arange(k, device=dev) - max_radius
    px = (ix[..., None, None] + d[:, None]).expand(b, m, k, k)
    py = (iy[..., None, None] + d[None, :]).expand(b, m, k, k)
    fx = ix.float()[..., None, None]
    fy = iy.float()[..., None, None]
    dx, dy = px - fx, py - fy
    d2 = dx * dx + dy * dy
    s = sigma[..., None, None]
    gauss = torch.exp(-d2 / (2.0 * (s * s)))
    rint = torch.clamp(torch.ceil(radius), max=float(max_radius))
    r = rint[..., None, None]
    within = (((px - ix[..., None, None]).abs() <= r)
              & ((py - iy[..., None, None]).abs() <= r))
    inside = (py >= 0) & (py < g) & (px >= 0) & (px < g)
    gauss = torch.where(within & valid[..., None, None] & inside, gauss,
                        torch.zeros((), device=dev))
    image = torch.arange(b, device=dev)[:, None, None, None]
    cell = ((image * g + py.clamp(0, g - 1)) * g + px.clamp(0, g - 1))
    heatmap = torch.zeros(b * g * g * num_classes, device=dev)
    heatmap.scatter_reduce_(
        0, (cell * num_classes + cls[..., None, None]).reshape(-1),
        gauss.reshape(-1), reduce="amax")

    # the centre cell's owner: the last valid box in index order (-1:
    # none), whose targets are gathered once (trap C19)
    centre = (torch.arange(b, device=dev)[:, None] * g + iy) * g + ix
    rows = torch.arange(m, device=dev).expand(b, m)
    owner = torch.full((b * g * g,), -1, dtype=torch.long, device=dev)
    owner.scatter_reduce_(0, centre.reshape(-1),
                          torch.where(valid, rows, -1).reshape(-1),
                          reduce="amax")
    regress = torch.stack([w, h, cx - ix, cy - iy], dim=-1)  # (B, M, 4)
    cell_image = torch.arange(b * g * g, device=dev) // (g * g)
    taken = owner >= 0
    targets = torch.where(taken[:, None],
                          regress[cell_image, owner.clamp(min=0)],
                          torch.zeros((), device=dev))
    targets = targets.reshape(b, g, g, 4)
    return {"heatmap": heatmap.reshape(b, g, g, num_classes),
            "wh": targets[..., :2], "offset": targets[..., 2:],
            "mask": taken.float().reshape(b, g, g)}
