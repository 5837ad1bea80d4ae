"""LSNet training loss (counterpart of ``lsnet_tpu/core/loss.py``).

Composes point generation, init / refine label assignment, target encoding
and the focal + cross-IOU losses as the reference ``LSHead.loss`` does,
vectorised: the batch is a written-out dimension, the per-level lists stay
concatenated (the per-level sums of the reference equal one flat weighted
sum because every factor is per point). Task ``bbox``; the segm and pose
tasks come later (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

import torch

from ..models.heads.ls_head import extreme_points2bbox
from ..models.losses.cross_iou import cross_iou_loss
from ..ops.focal_loss import sigmoid_focal_loss
from . import points as P
from .assign import atss_assign, centroid_assign
from .targets import build_stage_targets, encode_gt_reg, get_border_center


@dataclass(frozen=True)
class LossConfig:
    """Static loss configuration (train_cfg + the head's loss configs)."""
    image_shape: Tuple[int, int]
    num_classes: int
    task: str = "bbox"
    num_vectors: int = 4
    point_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    point_base_scale: int = 4
    # init assigner (CentroidAssigner)
    init_scale: float = 4.0
    init_pos_num: int = 1
    init_iou_type: str = "center"
    # refine assigner (ATSS)
    refine_topk: int = 9
    # losses
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    cls_loss_weight: float = 1.0
    init_loss_weight: float = 1.0
    refine_loss_weight: float = 2.0
    cross_iou_alpha: float = 0.2
    cross_iou_stride: int = 9


def _flatten_levels(level_maps: Sequence[torch.Tensor]) -> torch.Tensor:
    """[(B, H, W, C)...] -> (B, N, C), level-concatenated row-major (the
    grid points' order)."""
    return torch.cat([m.reshape(m.shape[0], -1, m.shape[-1])
                      for m in level_maps], dim=1)


def _per_point_stride(cfg: LossConfig, device) -> torch.Tensor:
    counts = P.num_level_points(cfg.image_shape, cfg.point_strides)
    return torch.cat([torch.full((n,), float(s), device=device)
                      for n, s in zip(counts, cfg.point_strides)])


def _decode_init_boxes(init_flat: torch.Tensor, points: torch.Tensor,
                       stride: torch.Tensor) -> torch.Tensor:
    """Init landmark field -> boxes for the refine-stage ATSS assigner,
    detached (the reference's ``.detach()``)."""
    _, bbox = extreme_points2bbox(init_flat.detach())
    center = torch.cat([points[:, :2], points[:, :2]], dim=-1)
    return center[None] + bbox * stride[None, :, None]


def _landmark_loss(pred_flat, lm_gt, row_w, points, stride, bboxes_gt,
                   num_pos, cfg: LossConfig, loss_type: str,
                   loss_weight: float) -> torch.Tensor:
    """One cross-IOU term over the flat point set (both stages use it)."""
    B, N, D = pred_flat.shape
    norm = (cfg.point_base_scale * stride)[None, :, None]         # (1, N, 1)
    pred = (pred_flat * stride[None, :, None] / norm).reshape(B * N, D)
    anchor_img = points[None, :, :2].expand(B, N, 2)
    anchor = (anchor_img / norm).reshape(B * N, 2)
    # encode the GT in image units, then normalise like the reference
    gt_reg, pos_inds = encode_gt_reg(lm_gt.reshape(B * N, -1),
                                     anchor_img.reshape(B * N, 2),
                                     row_w.reshape(B * N))
    gt_reg = gt_reg / norm.expand(B, N, 1).reshape(B * N, 1)
    return cross_iou_loss(
        pred, gt_reg, row_w.reshape(B * N), loss_type=loss_type,
        anchor_pts=anchor, bbox_gt=(bboxes_gt / norm).reshape(B * N, 4),
        pos_inds=pos_inds, avg_factor=num_pos, alpha=cfg.cross_iou_alpha,
        stride=cfg.cross_iou_stride, loss_weight=loss_weight)


def lsnet_loss(outs: Mapping[str, Sequence[torch.Tensor]],
               batch: Mapping[str, torch.Tensor], cfg: LossConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {"loss_cls", "loss_bbox_init", "loss_bbox_refine"}).

    outs: the head's per-level NHWC maps ``cls``, ``bbox_init``,
    ``bbox_refine`` (f32). batch: ``gt_bboxes`` (B, M, 4), ``gt_labels``
    (B, M), ``gt_valid`` (B, M) bool, ``pad_shape`` (B, 2) and optionally
    ``gt_extremes`` (B, M, 10)."""
    if cfg.task != "bbox":
        raise NotImplementedError(
            f"lsnet_loss task {cfg.task!r}: only 'bbox' is ported (ROADMAP "
            "Queue 1 item 10)")
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    stride = _per_point_stride(cfg, dev)
    nlp = P.num_level_points(cfg.image_shape, cfg.point_strides)
    valid = P.valid_flags(cfg.image_shape, cfg.point_strides,
                          batch["pad_shape"])                      # (B, N)
    gt_bboxes = batch["gt_bboxes"]
    gt_labels = batch["gt_labels"]
    gt_valid = batch["gt_valid"]
    lm_src = batch.get("gt_extremes")
    if lm_src is None:
        lm_src = get_border_center(gt_bboxes)

    def targets(gt_idx):
        return build_stage_targets(gt_idx, valid, gt_bboxes, gt_labels,
                                   gt_valid, lm_src, cfg.num_classes)

    # init stage: CentroidAssigner
    init_assign = centroid_assign(
        points, valid, gt_bboxes, gt_valid, gt_extremes=lm_src,
        scale=cfg.init_scale, pos_num=cfg.init_pos_num,
        iou_type=cfg.init_iou_type)
    init_t = targets(init_assign.gt_idx)
    num_pos_init = init_t.num_pos.sum()

    # decoded init boxes -> refine stage: ATSS
    init_flat = _flatten_levels(outs["bbox_init"])
    decoded = _decode_init_boxes(init_flat, points, stride)
    refine_assign = atss_assign(decoded, valid, nlp, gt_bboxes, gt_valid,
                                topk=cfg.refine_topk)
    refine_t = targets(refine_assign.gt_idx)
    num_pos_refine = refine_t.num_pos.sum()

    losses: Dict[str, torch.Tensor] = {}
    cls_flat = _flatten_levels(outs["cls"])
    B, N, C = cls_flat.shape
    losses["loss_cls"] = sigmoid_focal_loss(
        cls_flat.reshape(B * N, C), refine_t.labels.reshape(B * N),
        refine_t.label_weights.reshape(B * N), gamma=cfg.focal_gamma,
        alpha=cfg.focal_alpha, avg_factor=num_pos_refine
    ) * cfg.cls_loss_weight
    losses["loss_bbox_init"] = _landmark_loss(
        init_flat, init_t.lm_gt, init_t.bbox_weights, points, stride,
        init_t.bboxes_gt, num_pos_init, cfg, "bbox", cfg.init_loss_weight)
    losses["loss_bbox_refine"] = _landmark_loss(
        _flatten_levels(outs["bbox_refine"]), refine_t.lm_gt,
        refine_t.bbox_weights, points, stride, refine_t.bboxes_gt,
        num_pos_refine, cfg, "bbox", cfg.refine_loss_weight)
    return sum(losses.values()), losses
