"""CPV (corner point verification) training loss and decode (counterpart
of ``lsnet_tpu/core/cpv.py``), written with an explicit batch dimension
where the JAX package uses ``vmap``.

* Corner heatmap targets (the reference ``PointHMAssigner``): per FPN
  level the grid point nearest to each GT's top-left and bottom-right
  corner is a positive with a sub-stride offset target; gaussian bumps of
  CornerNet's radius soften the negatives around it.
* The loss: LSNet's bbox loss (focal cls, cross-IOU init and refine:
  :func:`lsnet_torch.core.loss.lsnet_loss`), then gaussian-focal
  heatmaps, smooth-L1 corner offsets and SEP-focal semantic maps.
* The decode: LSNet's, except that the box corners of candidates on
  levels > 0 snap to the 2x2 peak of the level-0 (levels 1, 2) or level-1
  (levels 3, 4) corner heatmap, plus the predicted sub-stride offset; the
  landmarks are the 8 extreme-point coordinates, clipped to the image.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple

import torch

from ..models.heads.ls_head import extreme_points2bbox
from ..ops.focal_loss import gaussian_focal_loss, sep_focal_loss
from ..ops.nms import _top_stable
from . import points as P
from .decode import Detections, TestConfig, _take, nms_candidates
from .loss import LossConfig, _flatten_levels, lsnet_loss


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def gaussian_radius(h: torch.Tensor, w: torch.Tensor,
                    min_overlap: float = 0.7) -> torch.Tensor:
    """CornerNet's radius: the least of the three roots."""
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0.0))) / 8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0.0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


class HMTargets(NamedTuple):
    hm_tl: torch.Tensor          # (B, N) gaussian in [0, 1], 1 at positives
    hm_br: torch.Tensor
    offset_tl: torch.Tensor      # (B, N, 2) sub-stride offsets at positives
    offset_br: torch.Tensor
    hm_weight: torch.Tensor      # (B, N) valid points
    offset_tl_w: torch.Tensor    # (B, N) positives
    offset_br_w: torch.Tensor
    num_pos_tl: torch.Tensor     # (B,) at least 1
    num_pos_br: torch.Tensor


def _last_writes(idx: torch.Tensor) -> torch.Tensor:
    """(B, M) bool: entry m is the last of its row's entries with its
    index, the one a sequential scatter of all M leaves standing (as the
    JAX package's ``.at[idx].set`` does on the CPU)."""
    M = idx.shape[-1]
    same = idx[..., :, None] == idx[..., None, :]
    later = torch.ones(M, M, dtype=torch.bool, device=idx.device).triu(1)
    return ~(same & later).any(-1)


def _scatter_last(dst: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``dst`` (B, N, ...) with ``dst[b, idx[b, m]] = vals[b, m]``, the
    last m winning where indices repeat; out of place."""
    win = _last_writes(idx)
    b = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(idx)
    out = dst.clone()
    out[b[win], idx[win]] = vals[win]
    return out


def hm_targets(points: torch.Tensor, point_valid: torch.Tensor,
               num_level_points: Sequence[int], gt_bboxes: torch.Tensor,
               gt_valid: torch.Tensor, *, gaussian_iou: float = 0.7
               ) -> HMTargets:
    """Corner heatmap targets of a batch. points (N, 3) [x, y, stride];
    point_valid (B, N); gt_bboxes (B, M, 4); gt_valid (B, M)."""
    Bn, N = point_valid.shape
    xy, stride = points[:, :2], points[:, 2]
    w = gt_bboxes[..., 2] - gt_bboxes[..., 0]
    h = gt_bboxes[..., 3] - gt_bboxes[..., 1]
    radius = gaussian_radius(h, w, gaussian_iou)                  # (B, M)
    sigma = (2 * radius + 1) / 6.0
    both = point_valid[:, :, None] & gt_valid[:, None, :]         # (B, N, M)

    def corner_targets(corner: torch.Tensor):
        d = torch.sqrt(((xy[None, :, None, :] - corner[:, None, :, :]) ** 2
                        ).sum(-1))
        d = torch.where(both, d, torch.full_like(d, 1e8))
        hm = torch.zeros(Bn, N, device=d.device)
        offset = torch.zeros(Bn, N, 2, device=d.device)
        pos = torch.zeros(Bn, N, dtype=torch.bool, device=d.device)
        start = 0
        for n_l in num_level_points:
            d_l = d[:, start:start + n_l]
            g = torch.exp(-(d_l ** 2) / (2 * sigma[:, None, :] ** 2))
            g = torch.where((d_l < radius[:, None, :]) & gt_valid[:, None, :],
                            g, torch.zeros_like(g))
            hm = torch.cat([hm[:, :start], torch.maximum(
                hm[:, start:start + n_l], g.amax(-1)), hm[:, start + n_l:]],
                dim=1)
            idx = d_l.argmin(dim=1) + start                        # (B, M)
            near = xy[idx]                                         # (B, M, 2)
            off_val = (corner - near) / stride[start]
            b = torch.arange(Bn, device=d.device)[:, None]
            old_off, old_hm, old_pos = offset[b, idx], hm[b, idx], pos[b, idx]
            offset = _scatter_last(offset, idx, torch.where(
                gt_valid[..., None], off_val, old_off))
            hm = _scatter_last(hm, idx, torch.where(
                gt_valid, torch.ones_like(old_hm), old_hm))
            pos = _scatter_last(pos, idx, gt_valid | old_pos)
            start += n_l
        return hm, offset, pos

    hm_tl, off_tl, pos_tl = corner_targets(gt_bboxes[..., 0:2])
    hm_br, off_br, pos_br = corner_targets(gt_bboxes[..., 2:4])
    return HMTargets(
        hm_tl, hm_br, off_tl, off_br, point_valid.float(), pos_tl.float(),
        pos_br.float(), pos_tl.sum(-1).float().clamp(min=1.0),
        pos_br.sum(-1).float().clamp(min=1.0))


@dataclass(frozen=True)
class CPVLossConfig:
    base: LossConfig
    heatmap_loss_weight: float = 0.25
    offset_loss_weight: float = 1.0
    sem_loss_weight: float = 0.1
    gaussian_iou: float = 0.7
    offset_beta: float = 1.0 / 9.0


def _nearest_resize(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of (B, H, W, C) (``F.interpolate``'s default, which
    the reference uses)."""
    B, H, W, C = x.shape
    th, tw = hw
    ridx = torch.arange(th, device=x.device) * H // th
    cidx = torch.arange(tw, device=x.device) * W // tw
    return x[:, ridx][:, :, cidx]


def make_sem_targets(gt_bboxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, image_shape: Tuple[int, int],
                     num_classes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gt_sem_map, gt_sem_weights), each (B, H/8, W/8, C) at stride 8:
    a GT's class is 1 over its box's cells, and a cell's weight is
    1 / area of the smallest GT of that class over it (GTs are laid in
    order of falling area, stable, the later one winning)."""
    H8, W8 = image_shape[0] // 8, image_shape[1] // 8
    Bn, M = gt_labels.shape
    dev = gt_bboxes.device
    area = ((gt_bboxes[..., 2] - gt_bboxes[..., 0])
            * (gt_bboxes[..., 3] - gt_bboxes[..., 1]))
    order = torch.argsort(-torch.where(gt_valid, area, torch.full_like(
        area, -1.0)), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)                  # m -> its place
    cell = torch.floor(gt_bboxes / 8)
    ys = torch.arange(H8, dtype=torch.float32, device=dev)
    xs = torch.arange(W8, dtype=torch.float32, device=dev)
    inside = (((ys >= cell[..., 1, None]) & (ys <= cell[..., 3, None])
               )[..., :, None]
              & ((xs >= cell[..., 0, None]) & (xs <= cell[..., 2, None])
                 )[..., None, :] & gt_valid[..., None, None])  # (B,M,H8,W8)
    key = torch.where(inside, rank[..., None, None],
                      torch.full_like(inside, -1, dtype=torch.long))
    labels = gt_labels.long().clamp(0, num_classes - 1)
    win = torch.full((Bn, num_classes, H8 * W8), -1, dtype=torch.long,
                     device=dev)
    win.scatter_reduce_(1, labels[..., None].expand(Bn, M, H8 * W8),
                        key.reshape(Bn, M, H8 * W8), reduce="amax")
    hit = win >= 0
    area_by_rank = torch.gather(area, 1, order)
    wts = torch.where(hit, 1.0 / torch.gather(
        area_by_rank, 1, win.clamp(min=0).reshape(Bn, -1)).reshape(
            win.shape).clamp(min=1.0), torch.zeros((), device=dev))
    as_map = (lambda t: t.reshape(Bn, num_classes, H8, W8)
              .permute(0, 2, 3, 1).contiguous())
    return as_map(hit.float()), as_map(wts)


def cpv_aux_losses(outs: Mapping[str, Sequence[torch.Tensor]],
                   batch: Mapping[str, torch.Tensor], points: torch.Tensor,
                   nlp: Sequence[int], valid: torch.Tensor,
                   image_shape: Tuple[int, int], num_classes: int, *,
                   gaussian_iou: float = 0.7,
                   heatmap_loss_weight: float = 0.25,
                   offset_beta: float = 1.0 / 9.0,
                   offset_loss_weight: float = 1.0,
                   sem_loss_weight: float = 0.1) -> Dict[str, torch.Tensor]:
    """``loss_heatmap``, ``loss_offset`` and ``loss_sem``."""
    gt_bboxes, gt_labels = batch["gt_bboxes"], batch["gt_labels"]
    gt_valid = batch["gt_valid"]
    hmt = hm_targets(points, valid, nlp, gt_bboxes, gt_valid,
                     gaussian_iou=gaussian_iou)
    hm_flat = _flatten_levels(outs["hem_score"])                 # (B, N, 2)
    off_flat = _flatten_levels(outs["hem_offset"])               # (B, N, 4)
    n_tl, n_br = hmt.num_pos_tl.sum(), hmt.num_pos_br.sum()
    losses: Dict[str, torch.Tensor] = {}
    loss_hm = (gaussian_focal_loss(torch.sigmoid(hm_flat[..., 0]), hmt.hm_tl,
                                   hmt.hm_weight, avg_factor=n_tl)
               + gaussian_focal_loss(torch.sigmoid(hm_flat[..., 1]),
                                     hmt.hm_br, hmt.hm_weight,
                                     avg_factor=n_br)) / 2.0
    losses["loss_heatmap"] = loss_hm * heatmap_loss_weight
    l_tl = smooth_l1(off_flat[..., 0:2], hmt.offset_tl, offset_beta)
    l_br = smooth_l1(off_flat[..., 2:4], hmt.offset_br, offset_beta)
    loss_off = ((l_tl * hmt.offset_tl_w[..., None]).sum() / n_tl
                + (l_br * hmt.offset_br_w[..., None]).sum() / n_br) / 2.0
    losses["loss_offset"] = loss_off * offset_loss_weight
    if "gt_sem_map" in batch:
        sem_map, sem_w = batch["gt_sem_map"], batch["gt_sem_weights"]
    else:
        sem_map, sem_w = make_sem_targets(gt_bboxes, gt_labels, gt_valid,
                                          image_shape, num_classes)
    losses["loss_sem"] = sem_loss(outs["sem_score"], sem_map, sem_w,
                                  sem_loss_weight)
    return losses


def sem_loss(sem_scores: Sequence[torch.Tensor], sem_map: torch.Tensor,
             sem_w: torch.Tensor, weight: float) -> torch.Tensor:
    """SEP-focal loss of the per-level semantic score maps (B, h, w, C)
    against the stride-8 targets, nearest-resized to each level, averaged
    over the targets' positive cells."""
    scores, maps, wts = [], [], []
    for lvl_score in sem_scores:
        hw = tuple(lvl_score.shape[1:3])
        scores.append(lvl_score.reshape(-1))
        maps.append(_nearest_resize(sem_map, hw).reshape(-1))
        wts.append(_nearest_resize(sem_w, hw).reshape(-1))
    maps_c = torch.cat(maps)
    avg = (maps_c > 0).sum().clamp(min=1)
    return sep_focal_loss(torch.cat(scores)[:, None], maps_c[:, None],
                          torch.cat(wts), avg_factor=avg) * weight


def lscpv_loss(outs: Mapping[str, Sequence[torch.Tensor]],
               batch: Mapping[str, torch.Tensor], ccfg: CPVLossConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, terms): LSNet's bbox terms ``loss_cls``,
    ``loss_bbox_init``, ``loss_bbox_refine``, then ``loss_heatmap``,
    ``loss_offset``, ``loss_sem``. outs: the CPV head's per-level NHWC
    maps (f32); batch as :func:`lsnet_torch.core.loss.lsnet_loss` takes
    it for the bbox task (``gt_sem_map`` / ``gt_sem_weights`` optional)."""
    cfg = ccfg.base
    if cfg.task != "bbox":
        raise ValueError(f"lscpv_loss: task {cfg.task!r}, CPV is bbox")
    _, losses = lsnet_loss(outs, batch, cfg)
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    nlp = P.num_level_points(cfg.image_shape, cfg.point_strides)
    valid = P.valid_flags(cfg.image_shape, cfg.point_strides,
                          batch["pad_shape"])
    losses.update(cpv_aux_losses(
        outs, batch, points, nlp, valid, cfg.image_shape, cfg.num_classes,
        gaussian_iou=ccfg.gaussian_iou,
        heatmap_loss_weight=ccfg.heatmap_loss_weight,
        offset_beta=ccfg.offset_beta,
        offset_loss_weight=ccfg.offset_loss_weight,
        sem_loss_weight=ccfg.sem_loss_weight))
    return sum(losses.values()), losses


def _snap(hm: torch.Tensor, off: torch.Tensor, x: torch.Tensor,
          y: torch.Tensor, stride: int, ch: Tuple[int, int]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corners (x, y) (B, k) snapped to the 2x2 max-pool peak of heatmap
    logits ``hm`` (B, H, W) at ``stride``, plus the offset channels
    ``ch`` of ``off`` (B, H, W, 4) there."""
    Bn, H, W = hm.shape
    prob = torch.sigmoid(hm)
    stack = torch.stack([prob[:, :-1, :-1], prob[:, :-1, 1:],
                         prob[:, 1:, :-1], prob[:, 1:, 1:]], dim=-1)
    arg = stack.argmax(dim=-1).reshape(Bn, -1)          # (B, (H-1)(W-1))
    xr = torch.floor((x / stride).clamp(0, W - 2)).long()
    yr = torch.floor((y / stride).clamp(0, H - 2)).long()
    a = torch.gather(arg, 1, yr * (W - 1) + xr)
    nx, ny = xr + a % 2, yr + a // 2
    o = _take(off.reshape(Bn, H * W, 4), ny * W + nx)
    return ((nx.to(x.dtype) + o[..., ch[0]]) * stride,
            (ny.to(y.dtype) + o[..., ch[1]]) * stride)


def lscpv_decode(outs: Mapping[str, Sequence[torch.Tensor]],
                 img_shapes: torch.Tensor, scale_factors: torch.Tensor,
                 cfg: TestConfig, rescale: bool = True) -> Detections:
    """Batched CPV decode + class-wise greedy NMS (always ``nms``, as the
    JAX decode). outs: per-level NHWC maps; img_shapes (B, 2) [h, w];
    scale_factors (B, 4). Landmarks are the 8 extreme coordinates."""
    B = img_shapes.shape[0]
    shp = img_shapes.to(torch.float32)
    h_max, w_max = shp[:, 0].view(B, 1), shp[:, 1].view(B, 1)

    def clip(v, hi):
        return torch.minimum(v.clamp(min=0.0), hi)

    hm_maps = [m.float() for m in outs["hem_score"][:2]]
    off_maps = [m.float() for m in outs["hem_offset"][:2]]
    level_hw = P.level_shapes(cfg.image_shape, cfg.point_strides)
    all_scores: List[torch.Tensor] = []
    all_boxes: List[torch.Tensor] = []
    all_exts: List[torch.Tensor] = []
    for lvl, s in enumerate(cfg.point_strides):
        scores = torch.sigmoid(outs["cls"][lvl].float().reshape(
            B, -1, cfg.num_classes))
        lm = outs["bbox_refine"][lvl].float().reshape(B, -1, 20)
        pts = P.grid_points(level_hw[lvl], s, device=scores.device)
        _, topk = _top_stable(scores.amax(dim=-1),
                              min(cfg.nms_pre, scores.shape[1]))
        scores, lm = _take(scores, topk), _take(lm, topk)
        xy = pts[:, :2][topk]
        ext, bbox = extreme_points2bbox(lm)
        ext = ext * s + xy.repeat(1, 1, 4)
        ext = torch.stack([clip(ext[..., 0::2], w_max[..., None]),
                           clip(ext[..., 1::2], h_max[..., None])],
                          dim=-1).flatten(-2)
        bbox = bbox * s + torch.cat([xy, xy], dim=-1)
        x1, y1 = clip(bbox[..., 0], w_max), clip(bbox[..., 1], h_max)
        x2, y2 = clip(bbox[..., 2], w_max), clip(bbox[..., 3], h_max)
        if lvl > 0:
            i = 0 if lvl in (1, 2) else 1
            hm, off = hm_maps[i], off_maps[i]
            si = cfg.point_strides[i]
            x1, y1 = _snap(hm[..., 0], off, x1, y1, si, (0, 1))
            x2, y2 = _snap(hm[..., 1], off, x2, y2, si, (2, 3))
            x1, y1 = clip(x1, w_max), clip(y1, h_max)
            x2, y2 = clip(x2, w_max), clip(y2, h_max)
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1))
        all_exts.append(ext)
        all_scores.append(scores)
    bboxes = torch.cat(all_boxes, dim=1)
    exts = torch.cat(all_exts, dim=1)
    if rescale:
        sf = scale_factors.to(torch.float32)
        bboxes = bboxes / sf[:, None, :]
        exts = exts / sf[:, None, :2].repeat(1, 1, 4)
    return nms_candidates(bboxes, exts, torch.cat(all_scores, dim=1),
                          dataclasses.replace(cfg, nms_type="nms"))
