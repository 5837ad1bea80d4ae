"""Cross-IOU loss (counterpart of ``lsnet_tpu/models/losses/cross_iou.py``):
vectorised and mask-driven, no boolean indexing.

* the 4-slot landmark layout: per coordinate a (neg, pos) slot pair; the GT
  fills one slot with |offset| and the other slot is filled with
  ``alpha * positive_value``;
* ``bbox`` mode: one cross-IOU ratio over all 4*(nv+1) components;
* ``polygon`` mode: stride-grouped subsets (stride=9) averaged;
* ``keypoint`` mode: per-point pair IOU, visibility-masked, normalised by
  the total pair count, no DIoU penalty;
* bbox/polygon add the DIoU/CIoU-style penalty from decoded enclosing
  boxes, ``rho2/c2 + v^2/(1-IoU+v)``;
* zero-positive batches reduce to 0 with zero gradients.

All inputs are flat (N, D) with a per-row weight; the reduction is
``sum(loss * w) / avg_factor``. Maxima are taken with ``amax`` /
``maximum``, which split the gradient between equal entries as
``jnp.max`` does.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch


def _signed_pairs(x: torch.Tensor) -> torch.Tensor:
    """(N, 2P) slot pairs -> (N, P/2, [y, x]) signed offsets: the larger
    slot, negative when the first slot wins (ties to the first)."""
    pairs = x.reshape(x.shape[0], -1, 2)
    val = pairs.amax(dim=2)
    sign = torch.where(pairs[..., 0] >= pairs[..., 1], -1.0, 1.0)
    return (val * sign).reshape(x.shape[0], -1, 2)


def decode_bbox_from_extreme(pred: torch.Tensor,
                             anchor_pts: torch.Tensor) -> torch.Tensor:
    """(N, 20) 4-slot landmarks + (N, 2) anchors -> (N, 4) x1y1x2y2; point
    order top, left, bottom, right, center."""
    signed = _signed_pairs(pred)
    xs = signed[:, :, 1] + anchor_pts[:, None, 0]
    ys = signed[:, :, 0] + anchor_pts[:, None, 1]
    return torch.stack([xs[:, 1], ys[:, 0], xs[:, 3], ys[:, 2]], dim=1)


def decode_bbox_from_polygon(pred: torch.Tensor,
                             anchor_pts: torch.Tensor) -> torch.Tensor:
    """(N, (nv+1)*4) landmarks -> enclosing box of the nv polygon points
    (the final center group is dropped)."""
    signed = _signed_pairs(pred[:, :-4])
    xs = signed[:, :, 1] + anchor_pts[:, None, 0]
    ys = signed[:, :, 0] + anchor_pts[:, None, 1]
    return torch.stack([xs.amin(1), ys.amin(1), xs.amax(1), ys.amax(1)],
                       dim=1)


def _alpha_fill(target: torch.Tensor, pos_inds: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """Fill each pair's negative slot with alpha * its positive slot."""
    N, D = target.shape
    tp = target.reshape(N, -1, 2)
    pm = pos_inds.reshape(N, -1, 2)
    pos_val = torch.where(pm, tp, torch.zeros_like(tp)).sum(dim=2,
                                                            keepdim=True)
    return torch.where(pm, tp, alpha * pos_val).reshape(N, D)


def _diou_penalty(bbox_pred: torch.Tensor, bbox_gt: torch.Tensor,
                  overlaps: torch.Tensor, eps: float) -> torch.Tensor:
    enclose_x1y1 = torch.minimum(bbox_pred[:, :2], bbox_gt[:, :2])
    enclose_x2y2 = torch.maximum(bbox_pred[:, 2:], bbox_gt[:, 2:])
    wh = (enclose_x2y2 - enclose_x1y1).clamp(min=0.0)
    c2 = wh[:, 0] ** 2 + wh[:, 1] ** 2 + eps
    b1x1, b1y1, b1x2, b1y2 = bbox_pred.unbind(dim=1)
    b2x1, b2y1, b2x2, b2y2 = bbox_gt.unbind(dim=1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    rho2 = (((b2x1 + b2x2) - (b1x1 + b1x2)) ** 2
            + ((b2y1 + b2y2) - (b1y1 + b1y2)) ** 2) / 4.0
    factor = 4.0 / math.pi ** 2
    v = factor * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    return rho2 / c2 + v ** 2 / (1.0 - overlaps + v).clamp(min=eps)


def cross_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                   weight: torch.Tensor, *, loss_type: str,
                   anchor_pts: Optional[torch.Tensor] = None,
                   vs: Optional[torch.Tensor] = None,
                   bbox_gt: Optional[torch.Tensor] = None,
                   pos_inds: Optional[torch.Tensor] = None,
                   avg_factor: Union[torch.Tensor, float] = 1.0,
                   eps: float = 1e-6, alpha: float = 0.2, stride: int = 9,
                   loss_weight: float = 1.0) -> torch.Tensor:
    """Weighted cross-IOU loss (mean reduction over avg_factor).

    pred: (N, D) softplus-ed 4-slot landmark predictions; target: (N, D)
    encoded GT regression (same layout); weight: (N,) row weights;
    pos_inds: (N, D) bool, which slot of each pair is the GT slot; vs:
    (N, nv) keypoint visibility (keypoint mode); bbox_gt: (N, 4) GT boxes
    (bbox and polygon modes)."""
    if loss_type not in ("bbox", "polygon", "keypoint"):
        raise ValueError(f"loss_type {loss_type!r}")
    pred = pred.float()
    target = _alpha_fill(target.float(), pos_inds, alpha)
    N = pred.shape[0]

    if loss_type == "polygon":
        groups = torch.stack([pred, target], -1).reshape(N, -1, 4, 2)
        subs = []
        for i in range(stride):
            sub = groups[:, i::stride].reshape(N, -1, 2)
            l_max = sub.amax(dim=2)
            l_min = sub.amin(dim=2)
            subs.append(l_min.sum(1) / l_max.sum(1).clamp(min=eps))
        overlaps = torch.stack(subs, -1).sum(-1) / stride
    elif loss_type == "bbox":
        l_max = torch.maximum(pred, target)
        l_min = torch.minimum(pred, target)
        overlaps = l_min.sum(1) / l_max.sum(1).clamp(min=eps)
    else:
        tr = target.reshape(N, -1, 2)
        pr = pred.reshape(N, -1, 2)
        l_max = torch.maximum(pr, tr).clamp(min=eps)
        l_min = torch.minimum(pr, tr)
        pair_iou = l_min.sum(-1) / l_max.sum(-1)              # (N, P)
        vsb = (vs > 0).to(pair_iou.dtype)                     # (N, nv)
        mask = torch.cat([vsb.repeat_interleave(2, dim=1),
                          pair_iou.new_ones(N, 2)], dim=1)
        overlaps = (pair_iou * mask).sum(-1) / pr.shape[1]

    if loss_type == "keypoint":
        loss = 1.0 - overlaps
    else:
        decode = (decode_bbox_from_extreme if loss_type == "bbox"
                  else decode_bbox_from_polygon)
        loss = 1.0 - (overlaps - _diou_penalty(decode(pred, anchor_pts),
                                               bbox_gt, overlaps, eps))
    denom = (avg_factor.clamp(min=1.0) if torch.is_tensor(avg_factor)
             else max(avg_factor, 1.0))
    return loss_weight * (loss * weight.float()).sum() / denom
