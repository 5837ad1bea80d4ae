"""Exact greedy NMS and soft-NMS on the device, fixed shapes (counterpart
of ``lsnet_tpu/ops/nms.py``).

Inputs are batches of padded candidate sets, (B, N, 4) boxes and (B, N)
scores, whose padding carries the score ``NEG_INF``; outputs are padded
keep sets with a validity mask.

The greedy keep mask is the unique fixed point of

    keep[i] = valid[i] and no kept j < i (in score order) has IoU > thr

Entry i depends only on entries before it, so iterating the map from
``keep = valid`` settles the first t entries after t steps. The loop runs
the map on the whole batch at once and checks for the fixed point every
few steps: one host synchronisation per check, none per box.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e10
_STEPS_PER_CHECK = 4


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. boxes (..., N, 4) x1y1x2y2 -> (..., N, M)."""
    area1 = ((boxes1[..., 2] - boxes1[..., 0])
             * (boxes1[..., 3] - boxes1[..., 1]))
    area2 = ((boxes2[..., 2] - boxes2[..., 0])
             * (boxes2[..., 3] - boxes2[..., 1]))
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp(min=1e-10)


def _greedy_keep(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy keep mask (B, N) from a score-sorted suppression matrix
    ``sup[b, j, i]`` (j suppresses i when kept) restricted to j < i."""
    N = valid.shape[-1]
    earlier = torch.ones(N, N, dtype=torch.bool,
                         device=sup.device).triu(diagonal=1)
    sup = sup & earlier
    keep = valid
    for _ in range(N + 1):
        prev = keep
        for _ in range(_STEPS_PER_CHECK):
            hit = (keep.unsqueeze(-1) & sup).any(dim=-2)
            keep = valid & ~hit
        if torch.equal(keep, prev):
            return keep
    raise RuntimeError("greedy NMS did not settle")


def _top_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Top k along the last axis, ties to the lower index (``lax.top_k``)."""
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
        max_out: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact greedy NMS: keep boxes whose IoU with every previously kept
    box is <= thr. Returns (keep_idx, keep_scores, keep_valid), each
    (B, max_out); invalid slots have idx 0 and score NEG_INF."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    sboxes = torch.gather(boxes, 1, order.unsqueeze(-1).expand_as(boxes))
    sscores = torch.gather(scores, 1, order)
    valid = sscores > NEG_INF / 2
    keep = _greedy_keep(box_iou(sboxes, sboxes) > iou_thr, valid)
    keep_scores = torch.where(keep, sscores, torch.full_like(sscores,
                                                             NEG_INF))
    top_scores, top_pos = _top_stable(keep_scores, max_out)
    keep_valid = top_scores > NEG_INF / 2
    keep_idx = torch.where(keep_valid, torch.gather(order, 1, top_pos),
                           torch.zeros_like(top_pos))
    return keep_idx, top_scores, keep_valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                idxs: torch.Tensor, iou_thr: float, max_out: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Class-wise NMS via the coordinate-offset trick."""
    live = (scores > NEG_INF / 2)
    max_coord = torch.where(live, boxes.amax(dim=-1),
                            torch.zeros_like(scores)).amax(dim=-1,
                                                           keepdim=True)
    offsets = idxs.to(boxes.dtype) * (max_coord + 1.0)
    return nms(boxes + offsets.unsqueeze(-1), scores, iou_thr, max_out)


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thr: float,
             max_out: int, sigma: float = 0.5, min_score: float = 1e-3,
             method: str = "linear"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Soft-NMS, linear or gaussian decay, on a batch: ``max_out``
    sequential selections, each taking the top remaining score (the lowest
    index among equals, as ``jnp.argmax``), decaying its neighbours'
    scores and dropping those that fall under ``min_score``. Returns
    (keep_idx, keep_scores, keep_valid), each (B, max_out), in selection
    order; invalid slots have idx 0 and score NEG_INF."""
    if method not in ("linear", "gaussian"):
        raise ValueError(f"soft_nms method {method!r}")
    cur = scores.clone()
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    neg = torch.full_like(cur, NEG_INF)
    idxs, kept = [], []
    for _ in range(max_out):
        i = cur.argmax(dim=1)            # the first of equal maxima
        top = cur[rows, i]
        ious = box_iou(boxes[rows, i][:, None, :], boxes)[:, 0]
        if method == "gaussian":
            decay = torch.exp(-(ious * ious) / sigma)
        else:
            decay = torch.where(ious > iou_thr, 1.0 - ious,
                                torch.ones_like(ious))
        cur = cur * decay
        cur[rows, i] = NEG_INF
        cur = torch.where(cur < min_score, neg, cur)
        idxs.append(i)
        kept.append(top)
    idx = torch.stack(idxs, dim=1)
    kept_scores = torch.stack(kept, dim=1)
    valid = kept_scores > NEG_INF / 2
    return (torch.where(valid, idx, torch.zeros_like(idx)),
            torch.where(valid, kept_scores,
                        torch.full_like(kept_scores, NEG_INF)), valid)
