"""Target construction for the LSHead loss (counterpart of
``lsnet_tpu/core/targets.py``): dense, mask-driven gathers over padded GT
arrays, batch dimension written out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def get_border_center(gt_bboxes: torch.Tensor) -> torch.Tensor:
    """(..., M, 4) -> (..., M, 10): border midpoints t, l, b, r + center."""
    x1, y1, x2, y2 = gt_bboxes.unbind(dim=-1)
    cx = (x1 + x2) / 2.0
    cy = (y1 + y2) / 2.0
    return torch.stack([cx, y1, x1, cy, cx, y2, x2, cy, cx, cy], dim=-1)


def _with_centre(pts: torch.Tensor, lo_x, lo_y, hi_x, hi_y) -> torch.Tensor:
    """pts (..., M, 2*nv) + the centre of the box -> (..., M, 2*(nv+1))."""
    return torch.cat([pts, ((lo_x + hi_x) / 2.0)[..., None],
                      ((lo_y + hi_y) / 2.0)[..., None]], dim=-1)


def keypoints_with_bbox(gt_bboxes: torch.Tensor,
                        gt_keypoints_vs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., M, 4), (..., M, 3*nv) [x, y, v]* -> (kps (..., M, 2*(nv+1)):
    the keypoints and the box centre, vs (..., M, nv))."""
    kps = torch.stack([gt_keypoints_vs[..., 0::3], gt_keypoints_vs[..., 1::3]],
                      dim=-1).flatten(-2)
    x1, y1, x2, y2 = gt_bboxes.unbind(dim=-1)
    return _with_centre(kps, x1, y1, x2, y2), gt_keypoints_vs[..., 2::3]


def keypoints_with_kbox(gt_keypoints_vs: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., M, 3*nv) -> (kps, kboxes (..., M, 4), vs): the box is the
    extent of the visible keypoints. An instance with none gets the
    degenerate box [1e7, 1e7, -1, -1], which no point falls into."""
    kx = gt_keypoints_vs[..., 0::3]
    ky = gt_keypoints_vs[..., 1::3]
    vs = gt_keypoints_vs[..., 2::3]
    vis = vs > 0
    big = torch.full_like(kx, 1e7)
    none = torch.full_like(kx, -1.0)
    xmin = torch.where(vis, kx, big).amin(dim=-1)
    ymin = torch.where(vis, ky, big).amin(dim=-1)
    xmax = torch.where(vis, kx, none).amax(dim=-1)
    ymax = torch.where(vis, ky, none).amax(dim=-1)
    kps = torch.stack([kx, ky], dim=-1).flatten(-2)
    return (_with_centre(kps, xmin, ymin, xmax, ymax),
            torch.stack([xmin, ymin, xmax, ymax], dim=-1), vs)


def polygons_to_gt(gt_polygons: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., M, 2*nv) xy-interleaved contour -> (contour and the centre of
    its extent (..., M, 2*(nv+1)), bboxes (..., M, 4): the extent)."""
    px = gt_polygons[..., 0::2]
    py = gt_polygons[..., 1::2]
    xmin, ymin = px.amin(dim=-1), py.amin(dim=-1)
    xmax, ymax = px.amax(dim=-1), py.amax(dim=-1)
    return (_with_centre(gt_polygons, xmin, ymin, xmax, ymax),
            torch.stack([xmin, ymin, xmax, ymax], dim=-1))


class StageTargets(NamedTuple):
    labels: torch.Tensor          # (B, N) int32, background = num_classes
    label_weights: torch.Tensor   # (B, N)
    bboxes_gt: torch.Tensor       # (B, N, 4)
    bbox_weights: torch.Tensor    # (B, N) row weight
    lm_gt: torch.Tensor           # (B, N, P*2) landmark targets
    kp_vs: Optional[torch.Tensor]  # (B, N, nv) or None
    num_pos: torch.Tensor         # (B,) max(count, 1)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (B, M, D) rows at idx (B, N) -> (B, N, D)."""
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[-1]))


def build_stage_targets(gt_idx: torch.Tensor, point_valid: torch.Tensor,
                        gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                        gt_valid: torch.Tensor, lm_gt_src: torch.Tensor,
                        num_classes: int,
                        kp_vs_src: Optional[torch.Tensor] = None
                        ) -> StageTargets:
    """gt_idx (B, N): assigned GT per point, -1 = background; lm_gt_src
    (B, M, P*2): per-GT landmark coordinates in image units. ``gt_valid``
    is unused (the assigners never pick an invalid GT) and kept for the
    JAX signature."""
    pos = gt_idx >= 0
    safe = gt_idx.clamp(min=0).long()
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, safe),
                         torch.full_like(safe, num_classes)).to(torch.int32)
    # every valid point counts in the cls loss, out-of-image points do not
    label_weights = point_valid.to(torch.float32)
    posf = pos.to(torch.float32)
    zero = gt_bboxes.new_zeros(())
    bboxes_gt = torch.where(pos[..., None], _take(gt_bboxes, safe), zero)
    lm_gt = torch.where(pos[..., None], _take(lm_gt_src, safe), zero)
    kp_vs = (torch.where(pos[..., None], _take(kp_vs_src, safe), zero)
             if kp_vs_src is not None else None)
    num_pos = posf.sum(dim=1).clamp(min=1.0)
    return StageTargets(labels, label_weights, bboxes_gt, posf, lm_gt,
                        kp_vs, num_pos)


def encode_gt_reg(gt_pts: torch.Tensor, anchor_xy: torch.Tensor,
                  row_weight: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GT landmarks -> 4-slot regression encoding.

    gt_pts: (N, P*2) xy-interleaved landmark coordinates; anchor_xy:
    (N, 2) grid-point coordinates; row_weight: (N,) positive-row
    indicator. Returns (gt_reg (N, P*4) [y-, y+, x-, x+] per point,
    pos_inds (N, P*4) bool)."""
    N = gt_pts.shape[0]
    off = gt_pts.reshape(N, -1, 2) - anchor_xy[:, None, :]
    ox = off[..., 0]
    oy = off[..., 1]

    def pair(o):
        zero = torch.zeros_like(o)
        return torch.stack([torch.where(o < 0, -o, zero),
                            torch.where(o >= 0, o, zero)], dim=-1)

    yx = torch.cat([pair(oy), pair(ox)], dim=-1)              # (N, P, 4)
    gt_reg = yx.reshape(N, -1) * row_weight[:, None]
    pos_inds = torch.cat([torch.stack([oy < 0, oy >= 0], -1),
                          torch.stack([ox < 0, ox >= 0], -1)],
                         dim=-1).reshape(N, -1)
    return gt_reg, pos_inds
