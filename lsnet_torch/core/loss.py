"""LSNet training loss (counterpart of ``lsnet_tpu/core/loss.py``).

Composes point generation, init / refine label assignment, target encoding
and the focal + cross-IOU losses as the reference ``LSHead.loss`` does,
vectorised: the batch is a written-out dimension, the per-level lists stay
concatenated (the per-level sums of the reference equal one flat weighted
sum because every factor is per point). The four tasks differ in where
the landmark targets come from (box border centres, polygons, keypoints),
which boxes the assigners see, and which cross-IOU terms are summed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..models.heads.ls_head import extreme_points2bbox, vectors2bbox
from ..models.losses.cross_iou import cross_iou_loss
from ..ops.focal_loss import sigmoid_focal_loss
from . import points as P
from .assign import atss_assign, centroid_assign
from .targets import (build_stage_targets, encode_gt_reg, get_border_center,
                      keypoints_with_bbox, keypoints_with_kbox,
                      polygons_to_gt)

# the branch whose init field is decoded into the refine assigner's boxes
# (pose_bbox assigns by its bbox branch, although its refine gather is
# paired with pose)
ASSIGN_BRANCH = {"bbox": "bbox", "segm": "segm", "pose_bbox": "bbox",
                 "pose_kbox": "pose"}


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
    pose_init_loss_weight: float = 1.0
    pose_refine_loss_weight: float = 2.0
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
                       stride: torch.Tensor, branch: str) -> torch.Tensor:
    """Init landmark field -> boxes for the refine-stage ATSS assigner,
    detached (the reference's ``.detach()``): the extremes' box for the
    bbox branch, the extent of the vectors for segm and pose."""
    to_bbox = extreme_points2bbox if branch == "bbox" else vectors2bbox
    _, bbox = to_bbox(init_flat.detach())
    center = torch.cat([points[:, :2], points[:, :2]], dim=-1)
    return center[None] + bbox * stride[None, :, None]


def _landmark_loss(pred_flat, lm_gt, row_w, points, stride, bboxes_gt,
                   num_pos, cfg: LossConfig, loss_type: str,
                   loss_weight: float,
                   vs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cross-IOU term over the flat point set (both stages use it).
    ``bboxes_gt`` (B, N, 4) for the bbox and polygon types, ``vs`` (B, N,
    nv) for the keypoint type."""
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
        anchor_pts=anchor,
        bbox_gt=(None if bboxes_gt is None
                 else (bboxes_gt / norm).reshape(B * N, 4)),
        pos_inds=pos_inds, vs=None if vs is None else vs.reshape(B * N, -1),
        avg_factor=num_pos, alpha=cfg.cross_iou_alpha,
        stride=cfg.cross_iou_stride, loss_weight=loss_weight)


def lsnet_loss(outs: Mapping[str, Sequence[torch.Tensor]],
               batch: Mapping[str, torch.Tensor], cfg: LossConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, terms): ``loss_cls`` and, per task, ``loss_bbox_init/refine``
    (bbox, pose_bbox), ``loss_segm_init/refine`` (segm),
    ``loss_pose_init/refine`` (pose_bbox, pose_kbox).

    outs: the head's per-level NHWC maps (f32). batch: ``gt_bboxes``
    (B, M, 4), ``gt_labels`` (B, M), ``gt_valid`` (B, M) bool, ``pad_shape``
    (B, 2) and, by task, ``gt_extremes`` (B, M, 10, optional),
    ``gt_polygons`` (B, M, 2*nv) or ``gt_keypoints_vs`` (B, M, 3*nv). segm
    and pose_kbox take their boxes from the polygons and the visible
    keypoints, not from ``gt_bboxes``."""
    task = cfg.task
    if task not in ASSIGN_BRANCH:
        raise ValueError(f"lsnet_loss task {task!r}: want one of "
                         f"{sorted(ASSIGN_BRANCH)}")
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    stride = _per_point_stride(cfg, dev)
    nlp = P.num_level_points(cfg.image_shape, cfg.point_strides)
    valid = P.valid_flags(cfg.image_shape, cfg.point_strides,
                          batch["pad_shape"])                      # (B, N)
    gt_bboxes = batch["gt_bboxes"]
    gt_labels = batch["gt_labels"]
    gt_valid = batch["gt_valid"]

    # landmark targets, the assigners' boxes and the keypoints' visibility
    kp_vs = None
    if task == "segm":
        lm_src, gt_bboxes = polygons_to_gt(batch["gt_polygons"])
    elif task == "pose_bbox":
        lm_src, kp_vs = keypoints_with_bbox(gt_bboxes,
                                            batch["gt_keypoints_vs"])
    elif task == "pose_kbox":
        lm_src, gt_bboxes, kp_vs = keypoints_with_kbox(
            batch["gt_keypoints_vs"])
    if task in ("bbox", "pose_bbox"):
        bbox_lm_src = batch.get("gt_extremes")
        if bbox_lm_src is None:
            bbox_lm_src = get_border_center(gt_bboxes)
        if task == "bbox":
            lm_src = bbox_lm_src

    def targets(gt_idx, lm, vs=None):
        return build_stage_targets(gt_idx, valid, gt_bboxes, gt_labels,
                                   gt_valid, lm, cfg.num_classes, vs)

    # init stage: CentroidAssigner (the extremes only place bbox's centroids)
    init_assign = centroid_assign(
        points, valid, gt_bboxes, gt_valid,
        gt_extremes=lm_src if task == "bbox" else None,
        scale=cfg.init_scale, pos_num=cfg.init_pos_num,
        iou_type=cfg.init_iou_type)
    init_t = targets(init_assign.gt_idx, lm_src, kp_vs)
    num_pos_init = init_t.num_pos.sum()

    # decoded init boxes -> refine stage: ATSS
    branch = ASSIGN_BRANCH[task]
    init_flat = _flatten_levels(outs[f"{branch}_init"])
    refine_flat = _flatten_levels(outs[f"{branch}_refine"])
    decoded = _decode_init_boxes(init_flat, points, stride, branch)
    refine_assign = atss_assign(decoded, valid, nlp, gt_bboxes, gt_valid,
                                topk=cfg.refine_topk)
    refine_t = targets(refine_assign.gt_idx, lm_src, kp_vs)
    num_pos_refine = refine_t.num_pos.sum()

    losses: Dict[str, torch.Tensor] = {}
    cls_flat = _flatten_levels(outs["cls"])
    B, N, C = cls_flat.shape
    losses["loss_cls"] = sigmoid_focal_loss(
        cls_flat.reshape(B * N, C), refine_t.labels.reshape(B * N),
        refine_t.label_weights.reshape(B * N), gamma=cfg.focal_gamma,
        alpha=cfg.focal_alpha, avg_factor=num_pos_refine
    ) * cfg.cls_loss_weight

    def stage_terms(name, loss_type, init_pred, refine_pred, t_init,
                    t_refine, w_init, w_refine):
        for stage, pred, tg, num_pos, weight in (
                ("init", init_pred, t_init, num_pos_init, w_init),
                ("refine", refine_pred, t_refine, num_pos_refine, w_refine)):
            keypoint = loss_type == "keypoint"
            losses[f"loss_{name}_{stage}"] = _landmark_loss(
                pred, tg.lm_gt, tg.bbox_weights, points, stride,
                None if keypoint else tg.bboxes_gt, num_pos, cfg, loss_type,
                weight, vs=tg.kp_vs if keypoint else None)

    if task == "bbox":
        stage_terms("bbox", "bbox", init_flat, refine_flat, init_t, refine_t,
                    cfg.init_loss_weight, cfg.refine_loss_weight)
    elif task == "pose_bbox":
        # the bbox branch regresses the border centres on the same
        # assignments
        stage_terms("bbox", "bbox", init_flat, refine_flat,
                    targets(init_assign.gt_idx, bbox_lm_src),
                    targets(refine_assign.gt_idx, bbox_lm_src),
                    cfg.init_loss_weight, cfg.refine_loss_weight)
    elif task == "segm":
        stage_terms("segm", "polygon", init_flat, refine_flat, init_t,
                    refine_t, cfg.init_loss_weight, cfg.refine_loss_weight)
    if task in ("pose_bbox", "pose_kbox"):
        stage_terms("pose", "keypoint", _flatten_levels(outs["pose_init"]),
                    _flatten_levels(outs["pose_refine"]), init_t, refine_t,
                    cfg.pose_init_loss_weight, cfg.pose_refine_loss_weight)
    return sum(losses.values()), losses
