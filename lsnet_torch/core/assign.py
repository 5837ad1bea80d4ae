"""Label assignment (counterpart of ``lsnet_tpu/core/assign.py``): dense,
statically shaped, with a written-out batch dimension where the JAX package
uses ``vmap``.

* ``centroid_assign``: init stage; per GT the nearest grid point at the
  GT's matched FPN level; optional polygon-centroid anchor point.
* ``atss_assign``: refine stage; per-level top-k by center distance, IoU
  threshold = mean + std, center inside the GT.

Everything is dense (N points x M padded GTs) with validity masks; the
outputs are per-point assigned GT indices (-1 = background). Ties go to
the lowest index, as ``jax.lax.top_k``, ``argmin`` and ``argmax`` break
them: a stable sort where JAX takes a top-k (``torch.topk`` promises no
order among equals), ``torch.argmin`` / ``argmax`` elsewhere (first
occurrence).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..ops.nms import box_iou

INF = 1e8


class AssignResult(NamedTuple):
    """Per-point assignment. gt_idx: (B, N) int32, -1 for background;
    ``max_overlaps`` (B, N) is only populated by ATSS."""
    gt_idx: torch.Tensor
    max_overlaps: torch.Tensor


def _smallest_stable(x: torch.Tensor, k: int):
    """The k smallest along the last axis, ties to the lower index (what
    ``lax.top_k`` of the negated values gives)."""
    vals, order = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], order[..., :k]


def centroid_assign(points: torch.Tensor, point_valid: torch.Tensor,
                    gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                    gt_extremes: Optional[torch.Tensor] = None, *,
                    scale: float = 4.0, pos_num: int = 1,
                    iou_type: str = "center") -> AssignResult:
    """Init-stage assigner.

    points: (N, 3) (x, y, stride); point_valid: (B, N) bool; gt_bboxes:
    (B, M, 4) padded; gt_valid: (B, M) bool; gt_extremes: (B, M, 10)
    extreme points + center, for iou_type='centroid'."""
    B, M = gt_bboxes.shape[:2]
    N = points.shape[0]
    points_xy = points[:, :2]
    points_lvl = torch.log2(points[:, 2]).to(torch.int32)
    lvl_min, lvl_max = points_lvl.min(), points_lvl.max()

    if iou_type == "centroid":
        if gt_extremes is None:
            raise ValueError("iou_type='centroid' needs gt_extremes")
        gt_xy = _gen_centroid(gt_extremes)
    else:
        gt_xy = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2.0

    gt_wh = (gt_bboxes[..., 2:] - gt_bboxes[..., :2]).clamp(min=1e-6)
    gt_lvl = ((torch.log2(gt_wh[..., 0] / scale)
               + torch.log2(gt_wh[..., 1] / scale)) / 2.0).to(torch.int32)
    gt_lvl = torch.minimum(torch.maximum(gt_lvl, lvl_min), lvl_max)

    diff = ((points_xy[None, :, None, :] - gt_xy[:, None, :, :])
            / gt_wh[:, None, :, :])
    distances = diff.square().sum(-1).sqrt()                     # (B, N, M)
    bad = ((points_lvl[None, :, None] != gt_lvl[:, None, :])
           | ~point_valid[:, :, None] | ~gt_valid[:, None, :])
    distances = torch.where(bad, torch.full_like(distances, INF), distances)

    # per GT: the pos_num closest points
    top_d, top_idx = _smallest_stable(distances.transpose(1, 2), pos_num)
    # the "distances_inf" matrix: INF except at the selected points
    cols = torch.arange(M, device=points.device).view(1, M, 1)
    lin = (top_idx * M + cols).reshape(B, -1)
    dist_inf = torch.full((B, N * M), INF, dtype=distances.dtype,
                          device=points.device)
    dist_inf.scatter_reduce_(1, lin, top_d.reshape(B, -1), "amin",
                             include_self=True)
    dist_inf = dist_inf.view(B, N, M)
    # per point: the closest among the GTs that selected it
    min_dist = dist_inf.amin(dim=2)
    argmin = dist_inf.argmin(dim=2)
    gt_idx = torch.where(min_dist < INF / 2, argmin,
                         torch.full_like(argmin, -1)).to(torch.int32)
    return AssignResult(gt_idx, torch.zeros_like(min_dist))


def _gen_centroid(extremes: torch.Tensor) -> torch.Tensor:
    """(..., 10) -> (..., 2): polygon centroid of the 4 extreme points via
    the triangle-centroid line-intersection construction."""
    pts = extremes[..., :8].reshape(*extremes.shape[:-1], 4, 2)
    pts_rep = torch.cat([pts, pts], dim=-2)
    cxs = torch.stack([pts_rep[..., i:i + 3, 0].sum(-1) / 3.0
                       for i in range(4)], -1)
    cys = torch.stack([pts_rep[..., i:i + 3, 1].sum(-1) / 3.0
                       for i in range(4)], -1)
    det_l1 = cxs[..., 0] * cys[..., 2] - cys[..., 0] * cxs[..., 2]
    det_l2 = cxs[..., 1] * cys[..., 3] - cys[..., 1] * cxs[..., 3]
    x1mx2 = cxs[..., 0] - cxs[..., 2]
    x3mx4 = cxs[..., 1] - cxs[..., 3]
    y1my2 = cys[..., 0] - cys[..., 2]
    y3my4 = cys[..., 1] - cys[..., 3]
    xnom = det_l1 * x3mx4 - det_l2 * x1mx2
    ynom = det_l1 * y3my4 - det_l2 * y1my2
    denom = x1mx2 * y3my4 - y1my2 * x3mx4
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12),
                        denom)
    return torch.stack([xnom / denom, ynom / denom], dim=-1)


def atss_assign(bboxes: torch.Tensor, point_valid: torch.Tensor,
                num_level_bboxes: Sequence[int], gt_bboxes: torch.Tensor,
                gt_valid: torch.Tensor, *, topk: int = 9) -> AssignResult:
    """Refine-stage ATSS assigner on decoded init boxes.

    bboxes: (B, N, 4), one per grid point; point_valid: (B, N) bool
    (invalid points never become candidates); num_level_bboxes: per-level
    counts (sum == N); gt_bboxes (B, M, 4); gt_valid (B, M)."""
    B, N = bboxes.shape[:2]
    M = gt_bboxes.shape[1]
    dev = bboxes.device
    overlaps = box_iou(bboxes, gt_bboxes)                        # (B, N, M)

    gt_c = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2.0
    bb_c = (bboxes[..., :2] + bboxes[..., 2:]) / 2.0
    distances = (bb_c[:, :, None, :] - gt_c[:, None, :, :]).square().sum(
        -1).sqrt()
    distances = torch.where(point_valid[:, :, None], distances,
                            torch.full_like(distances, INF))

    # per level: the top-k closest candidates of every GT
    cand_idx = []
    start = 0
    for n_lvl in num_level_bboxes:
        d_lvl = distances[:, start:start + n_lvl]
        _, idx = _smallest_stable(d_lvl.transpose(1, 2), min(topk, n_lvl))
        cand_idx.append(idx.transpose(1, 2) + start)             # (B, k, M)
        start += n_lvl
    cand_idx = torch.cat(cand_idx, dim=1)                        # (B, K, M)

    cand_overlaps = torch.gather(overlaps, 1, cand_idx)
    thr = cand_overlaps.mean(dim=1) + cand_overlaps.std(dim=1)   # unbiased
    is_pos = cand_overlaps >= thr[:, None, :]

    flat_idx = cand_idx.reshape(B, -1)
    cand_c = torch.gather(bb_c, 1, flat_idx[..., None].expand(-1, -1, 2)
                          ).view(*cand_idx.shape, 2)
    l_ = cand_c[..., 0] - gt_bboxes[:, None, :, 0]
    t_ = cand_c[..., 1] - gt_bboxes[:, None, :, 1]
    r_ = gt_bboxes[:, None, :, 2] - cand_c[..., 0]
    b_ = gt_bboxes[:, None, :, 3] - cand_c[..., 1]
    in_gts = torch.minimum(torch.minimum(l_, t_),
                           torch.minimum(r_, b_)) > 0.01
    cand_valid = torch.gather(point_valid, 1, flat_idx).view(cand_idx.shape)
    is_pos = is_pos & in_gts & gt_valid[:, None, :] & cand_valid

    # a point claimed by several GTs keeps the one with the highest IoU
    cols = torch.arange(M, device=dev).view(1, 1, M)
    vals = torch.where(is_pos, cand_overlaps,
                       torch.full_like(cand_overlaps, -INF))
    over_inf = torch.full((B, N * M), -INF, dtype=bboxes.dtype, device=dev)
    over_inf.scatter_reduce_(1, (cand_idx * M + cols).reshape(B, -1),
                             vals.reshape(B, -1), "amax", include_self=True)
    over_inf = over_inf.view(B, N, M)
    max_overlaps = over_inf.amax(dim=2)
    argmax = over_inf.argmax(dim=2)
    hit = max_overlaps > -INF / 2
    gt_idx = torch.where(hit, argmax,
                         torch.full_like(argmax, -1)).to(torch.int32)
    return AssignResult(gt_idx, torch.where(
        hit, max_overlaps, torch.zeros_like(max_overlaps)))
