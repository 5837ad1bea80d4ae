"""RepPoints v1 and v2 training loss and decode (counterpart of
``lsnet_tpu/core/reppoints.py``), written with an explicit batch dimension
where the JAX package uses ``vmap``.

* The point sets: the head predicts K (y, x) offsets per grid point in
  stride units; ``points2bbox`` turns a set into a box (``minmax``,
  ``partial_minmax`` over the first 4 points, or ``moment``: mean +- std
  scaled by the head's trained ``moment`` log-factors).
* Init stage: ``centroid_assign`` (the reference PointAssigner, the
  nearest grid point of each GT at its matched level).
* Refine stage: ``max_iou_assign`` on the init boxes, detached.
* Losses: sigmoid focal classification on the refine labels, smooth L1
  (beta 1/9) on both stages' boxes, normalised by ``point_base_scale *
  stride``.
* v2 adds the corner-heatmap, corner-offset and semantic losses of CPV
  (:func:`lsnet_torch.core.cpv.cpv_aux_losses`), and its decode snaps
  the box corners of levels > 0 to the corner heatmaps' peaks
  (:func:`lsnet_torch.core.cpv._snap`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

import torch

from ..ops.focal_loss import sigmoid_focal_loss
from ..ops.nms import _top_stable
from . import points as P
from .assign import centroid_assign, max_iou_assign
from .cpv import _snap, cpv_aux_losses
from .decode import Detections, TestConfig, _take, nms_candidates

Outs = Mapping[str, Sequence[torch.Tensor]]


@dataclass(frozen=True)
class RepPointsConfig:
    image_shape: Tuple[int, int]
    num_classes: int
    num_points: int = 9
    point_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    point_base_scale: int = 4
    transform_method: str = "moment"
    # init assigner (PointAssigner defaults)
    init_scale: float = 4.0
    init_pos_num: int = 1
    # refine assigner (MaxIoUAssigner, the RepPoints settings)
    refine_pos_iou: float = 0.5
    refine_neg_iou: float = 0.4
    refine_min_pos_iou: float = 0.0
    # loss weights (reference defaults: init 0.5, refine 1.0, beta 1/9)
    cls_weight: float = 1.0
    init_weight: float = 0.5
    refine_weight: float = 1.0
    smooth_beta: float = 1.0 / 9.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25


@dataclass(frozen=True)
class RepPointsV2Config(RepPointsConfig):
    """RepPoints v2: the v1 settings and the CPV terms' weights (the JAX
    ``reppoints_v2_loss`` keyword defaults). A type of its own, so that
    the train step's loss table tells v2 from v1."""
    gaussian_iou: float = 0.7
    heatmap_loss_weight: float = 0.25
    offset_loss_weight: float = 1.0
    sem_loss_weight: float = 0.1


def points2bbox(pts_xy: torch.Tensor, method: str,
                moment: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) xy point sets -> (..., 4) boxes."""
    xs, ys = pts_xy[..., 0], pts_xy[..., 1]
    if method == "minmax":
        return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1),
                            ys.amax(-1)], dim=-1)
    if method == "partial_minmax":
        xs4, ys4 = xs[..., :4], ys[..., :4]
        return torch.stack([xs4.amin(-1), ys4.amin(-1), xs4.amax(-1),
                            ys4.amax(-1)], dim=-1)
    if method == "moment":
        mx, my = xs.mean(-1), ys.mean(-1)
        # torch.std's unbiased (N - 1) normalisation, as the reference
        n = xs.shape[-1]
        sx = torch.sqrt(((xs - mx[..., None]) ** 2).sum(-1) / max(n - 1, 1)
                        + 1e-12)
        sy = torch.sqrt(((ys - my[..., None]) ** 2).sum(-1) / max(n - 1, 1)
                        + 1e-12)
        hw = sx * torch.exp(moment[0])
        hh = sy * torch.exp(moment[1])
        return torch.stack([mx - hw, my - hh, mx + hw, my + hh], dim=-1)
    raise ValueError(method)


def pts_flat_xy(maps: Sequence[torch.Tensor], K: int) -> torch.Tensor:
    """[(B, H, W, 2K) (y, x) maps ...] -> (B, N, K, 2) xy in stride
    units, f32."""
    yx = torch.cat([m.reshape(m.shape[0], -1, K, 2) for m in maps],
                   dim=1).float()
    return yx.flip(-1)


def pts_to_img(pts_xy: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Stride-unit point sets (B, N, K, 2) -> image coordinates."""
    return points[None, :, None, :2] + pts_xy * points[None, :, None, 2:3]


def smooth_l1_sum(pred: torch.Tensor, tgt: torch.Tensor,
                  beta: float) -> torch.Tensor:
    """Smooth L1 summed over the last axis."""
    d = (pred - tgt).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).sum(-1)


def point_assignments(cfg, points: torch.Tensor, valid: torch.Tensor,
                      bbox_init: torch.Tensor,
                      batch: Mapping[str, torch.Tensor]):
    """(init, refine) assignments of a batch: the init stage's point
    assigner and the refine stage's MaxIoU on the detached init boxes."""
    init = centroid_assign(points, valid, batch["gt_bboxes"],
                           batch["gt_valid"], scale=cfg.init_scale,
                           pos_num=cfg.init_pos_num, iou_type="center")
    refine = max_iou_assign(bbox_init.detach(), valid, batch["gt_bboxes"],
                            batch["gt_valid"],
                            pos_iou_thr=cfg.refine_pos_iou,
                            neg_iou_thr=cfg.refine_neg_iou,
                            min_pos_iou=cfg.refine_min_pos_iou)
    return init, refine


def box_stage_loss(bbox_pred: torch.Tensor, gt_idx: torch.Tensor,
                   gt_bboxes: torch.Tensor, norm: torch.Tensor, beta: float,
                   weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, n_pos): smooth L1 of the positives' boxes against their GT
    boxes, both over ``norm``, averaged over the batch's positives."""
    pos = (gt_idx >= 0).float()
    tgt = _take(gt_bboxes, gt_idx.clamp(min=0).long())
    n_pos = pos.sum().clamp(min=1.0)
    loss = smooth_l1_sum(bbox_pred / norm, tgt / norm, beta)
    return (loss * pos).sum() / n_pos * weight, n_pos


def refine_cls_loss(cls_flat: torch.Tensor, refine, valid: torch.Tensor,
                    gt_labels: torch.Tensor, n_pos: torch.Tensor,
                    cfg) -> torch.Tensor:
    """Focal classification on the refine stage's labels; ignored boxes
    and invalid points weigh 0."""
    B, N, C = cls_flat.shape
    gi = refine.gt_idx.long()
    labels = torch.where(gi >= 0, torch.gather(gt_labels.long(), 1,
                                               gi.clamp(min=0)),
                         torch.full_like(gi, C))
    lw = (valid & ~refine.ignore).float()
    return sigmoid_focal_loss(
        cls_flat.reshape(B * N, C), labels.reshape(B * N),
        lw.reshape(B * N), gamma=cfg.focal_gamma, alpha=cfg.focal_alpha,
        avg_factor=n_pos) * cfg.cls_weight


def reppoints_loss(outs: Outs, batch: Mapping[str, torch.Tensor],
                   cfg: RepPointsConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, terms ``loss_cls``, ``loss_pts_init``, ``loss_pts_refine``).
    outs: the head's per-level NHWC ``cls`` / ``pts_init`` /
    ``pts_refine`` maps and its ``moment`` (2,); batch: ``gt_bboxes``
    (B, M, 4), ``gt_labels``, ``gt_valid``, ``pad_shape``."""
    K, C = cfg.num_points, cfg.num_classes
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    valid = P.valid_flags(cfg.image_shape, cfg.point_strides,
                          batch["pad_shape"])
    cls_flat = torch.cat([m.reshape(m.shape[0], -1, C) for m in outs["cls"]],
                         dim=1).float()
    moment = outs["moment"].float()
    bbox_init = points2bbox(pts_to_img(pts_flat_xy(outs["pts_init"], K),
                                       points),
                            cfg.transform_method, moment)
    bbox_refine = points2bbox(pts_to_img(pts_flat_xy(outs["pts_refine"], K),
                                         points),
                              cfg.transform_method, moment)
    init, refine = point_assignments(cfg, points, valid, bbox_init, batch)
    norm = (cfg.point_base_scale * points[:, 2])[None, :, None]
    gt_bboxes = batch["gt_bboxes"]
    loss_init, _ = box_stage_loss(bbox_init, init.gt_idx, gt_bboxes, norm,
                                  cfg.smooth_beta, cfg.init_weight)
    loss_refine, n_pos = box_stage_loss(bbox_refine, refine.gt_idx,
                                        gt_bboxes, norm, cfg.smooth_beta,
                                        cfg.refine_weight)
    losses = {"loss_cls": refine_cls_loss(cls_flat, refine, valid,
                                          batch["gt_labels"], n_pos, cfg),
              "loss_pts_init": loss_init, "loss_pts_refine": loss_refine}
    return sum(losses.values()), losses


def _clip_boxes(boxes: torch.Tensor, img_shapes: torch.Tensor
                ) -> torch.Tensor:
    """(B, T, 4) boxes clipped to each image's [0, w] x [0, h]."""
    shp = img_shapes.to(torch.float32)
    h, w = shp[:, 0].view(-1, 1), shp[:, 1].view(-1, 1)
    return torch.stack([
        torch.minimum(boxes[..., 0].clamp(min=0.0), w),
        torch.minimum(boxes[..., 1].clamp(min=0.0), h),
        torch.minimum(boxes[..., 2].clamp(min=0.0), w),
        torch.minimum(boxes[..., 3].clamp(min=0.0), h)], dim=-1)


def reppoints_decode(outs: Outs, img_shapes: torch.Tensor,
                     scale_factors: torch.Tensor, tcfg: TestConfig,
                     cfg: RepPointsConfig, rescale: bool = True
                     ) -> Detections:
    """``points2bbox`` on every point's refined set, clip, class-wise NMS
    (``tcfg.nms_type``). Landmarks are zeros (B, max_per_img, 8)."""
    K, C = cfg.num_points, cfg.num_classes
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    cls = torch.cat([m.reshape(m.shape[0], -1, C) for m in outs["cls"]],
                    dim=1).float()
    boxes = points2bbox(pts_to_img(pts_flat_xy(outs["pts_refine"], K),
                                   points),
                        cfg.transform_method, outs["moment"].float())
    b = _clip_boxes(boxes, img_shapes)
    if rescale:
        b = b / scale_factors.to(torch.float32)[:, None, :]
    lms = torch.zeros(*b.shape[:2], 8, dtype=b.dtype, device=dev)
    return nms_candidates(b, lms, torch.sigmoid(cls), tcfg)


def reppoints_v2_loss(outs: Outs, batch: Mapping[str, torch.Tensor],
                      cfg: RepPointsV2Config
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """v1's terms, then ``loss_heatmap``, ``loss_offset`` and ``loss_sem``
    on the head's ``hem_score`` / ``hem_offset`` / ``sem_score`` maps."""
    total, losses = reppoints_loss(outs, batch, cfg)
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    nlp = P.num_level_points(cfg.image_shape, cfg.point_strides)
    valid = P.valid_flags(cfg.image_shape, cfg.point_strides,
                          batch["pad_shape"])
    aux = cpv_aux_losses(outs, batch, points, nlp, valid, cfg.image_shape,
                         cfg.num_classes, gaussian_iou=cfg.gaussian_iou,
                         heatmap_loss_weight=cfg.heatmap_loss_weight,
                         offset_loss_weight=cfg.offset_loss_weight,
                         sem_loss_weight=cfg.sem_loss_weight)
    losses.update(aux)
    return total + sum(aux.values()), losses


def reppoints_v2_decode(outs: Outs, img_shapes: torch.Tensor,
                        scale_factors: torch.Tensor, tcfg: TestConfig,
                        cfg: RepPointsConfig, rescale: bool = True
                        ) -> Detections:
    """Per level the ``nms_pre`` best points, ``points2bbox``, clip; on
    levels > 0 the corners snap to the peak of the level-0 (levels 1, 2)
    or level-1 (levels 3, 4) corner heatmap; then class-wise greedy NMS
    (always ``nms``, as the JAX decode)."""
    K, C = cfg.num_points, cfg.num_classes
    B = img_shapes.shape[0]
    shp = img_shapes.to(torch.float32)
    h_max, w_max = shp[:, 0].view(B, 1), shp[:, 1].view(B, 1)

    def clip(v, hi):
        return torch.minimum(v.clamp(min=0.0), hi)

    moment = outs["moment"].float()
    shapes = P.level_shapes(cfg.image_shape, cfg.point_strides)
    hm_maps = [m.float() for m in outs["hem_score"][:2]]
    off_maps = [m.float() for m in outs["hem_offset"][:2]]
    all_scores, all_boxes = [], []
    for lvl in range(len(outs["cls"])):
        s = cfg.point_strides[lvl]
        scores = torch.sigmoid(outs["cls"][lvl].float().reshape(B, -1, C))
        pts = P.grid_points(shapes[lvl], s, device=scores.device)
        _, topk = _top_stable(scores.amax(dim=-1),
                              min(tcfg.nms_pre, scores.shape[1]))
        scores = _take(scores, topk)
        yx = _take(outs["pts_refine"][lvl].float().reshape(B, -1, 2 * K),
                   topk).reshape(B, -1, K, 2)
        xy = yx.flip(-1) * s + pts[:, :2][topk][:, :, None, :]
        bbox = points2bbox(xy, cfg.transform_method, moment)
        x1, y1 = clip(bbox[..., 0], w_max), clip(bbox[..., 1], h_max)
        x2, y2 = clip(bbox[..., 2], w_max), clip(bbox[..., 3], h_max)
        if lvl > 0:
            i = 0 if lvl in (1, 2) else 1
            si = cfg.point_strides[i]
            x1, y1 = _snap(hm_maps[i][..., 0], off_maps[i], x1, y1, si,
                           (0, 1))
            x2, y2 = _snap(hm_maps[i][..., 1], off_maps[i], x2, y2, si,
                           (2, 3))
            x1, y1 = clip(x1, w_max), clip(y1, h_max)
            x2, y2 = clip(x2, w_max), clip(y2, h_max)
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1))
        all_scores.append(scores)
    bboxes = torch.cat(all_boxes, dim=1)
    if rescale:
        bboxes = bboxes / scale_factors.to(torch.float32)[:, None, :]
    lms = torch.zeros(*bboxes.shape[:2], 8, dtype=bboxes.dtype,
                      device=bboxes.device)
    return nms_candidates(bboxes, lms, torch.cat(all_scores, dim=1),
                          dataclasses.replace(tcfg, nms_type="nms"))
