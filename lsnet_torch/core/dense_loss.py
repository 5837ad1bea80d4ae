"""Losses of the dense-head zoo (counterpart of
``lsnet_tpu/core/dense_loss.py``): RetinaNet, FCOS, ATSS, GFL, SSD,
FoveaBox, FSAF, FreeAnchor, PISA (RetinaNet and SSD) and the two Guided
Anchoring heads.

* ``retina_loss``: MaxIoU assignment on the anchor grid, focal + L1 on
  the deltas;
* ``fcos_loss``: regress-range point assignment (the smallest GT that
  holds the point), focal + IoU weighted by the centerness target +
  centerness BCE;
* ``atss_loss``: ATSS assignment on one square anchor a cell, focal +
  GIoU weighted by the centerness target + centerness BCE;
* ``gfl_loss``: ATSS assignment, quality focal loss against the IoU of the
  integral boxes, distribution focal loss and GIoU;
* ``ga_retina_loss`` / ``ga_rpn_loss``: the guided-anchor location
  (focal, positives in the centre-shrunk GT at its level) and shape (IoU
  of the guided anchor with its GT) terms, then MaxIoU assignment on the
  detached guided anchors: focal + L1 (GA-RetinaNet), or sampled BCE +
  SmoothL1 with hard negatives (GA-RPN);
* ``ssd_loss``: MaxIoU assignment at 0.5 / 0.5 (each GT's best anchor
  forced), softmax CE with 3:1 hard-negative mining, SmoothL1 on the
  deltas, both over the batch's positives;
* ``fovea_loss``: the smallest GT whose sigma-shrunk (fovea) region holds
  the point at its scale's level, focal + SmoothL1 on log-space (l, t, r,
  b) in base-edge units;
* ``fsaf_loss``: centre-region assignment on every level, then online
  level selection (each GT keeps the level of least mean focal + IoU
  loss), focal + IoU on the TBLR decode;
* ``free_anchor_loss``: per-GT bags of the top-k anchors by IoU, the
  mean-max positive bag likelihood and the focal negative bag term;
* ``pisa_retina_loss`` / ``pisa_ssd_loss``: the RetinaNet / SSD losses
  with ISR-P (IoU-HLR ranks reweight the positives' classification) and
  CARL (classification-aware regression).

Everything runs dense over padded GT (M slots and a validity mask) with a
written-out batch dimension where JAX ``vmap``s; each term is reduced per
image, then averaged over the batch, as JAX's. The IoU matrices are
(B, N, M) f32 and are never expanded per class. The anchor grids and the
FCOS points are built once per (config, canvas, device). SSD's anchors
lie on each level's own map (the reference generator's ``featmap_sizes``)
where JAX takes ceil(canvas / stride): the same grids on SSD300's
300x300 canvas, and the VGG's 3x3 and 1x1 maps (strides 100 and 300)
against grids of 4x4 and 2x2 on the image API's 320x320 bucket canvas,
where the JAX decode fails. Top-k bags and ranks sort stably, so ties
fall as ``jax.lax.top_k`` and ``jnp.lexsort`` place them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.losses.common import (bbox_overlaps_aligned,
                                    bce_with_logits, giou_loss, iou_loss,
                                    l1_loss, smooth_l1_loss)
from ..ops.focal_loss import sigmoid_focal_loss
from ..ops.nms import box_iou
from . import points as P
from .anchors import (AnchorConfig, anchor_valid_flags, bbox2delta,
                      bbox2distance, cached_constant, delta2bbox,
                      distance2bbox, grid_anchors_on, shifted_anchors,
                      ssd_base_anchors)
from .assign import atss_assign, max_iou_assign

INF = 1e8
# the head kinds whose loss and decode are ported: every kind of the JAX
# zoo
KINDS = ("retina", "fcos", "atss", "gfl", "ssd", "fovea", "fsaf",
         "free_anchor", "pisa_retina", "pisa_ssd", "ga_retina", "ga_rpn")
ATSS_STDS = (0.1, 0.1, 0.2, 0.2)
# GFL's distribution: 17 bins a side
REG_MAX = 16
# Guided Anchoring: the guided anchor's base is 8 x stride; location
# positives lie in the 0.2-shrunk GT, the ignore ring out to 0.5; GA-RPN
# samples 256 anchors an image
GA_OCTAVE_BASE = 8.0
GA_CENTER_RATIO = 0.2
GA_IGNORE_RATIO = 0.5
GA_RPN_SAMPLES = 256
# FoveaBox's SmoothL1 beta
FOVEA_BETA = 0.11
# FreeAnchor (the shipped file's values, which the JAX runner leaves to
# these defaults): bags of the top 50 anchors by IoU, an anchor's
# object probability saturating from IoU 0.6, focal gamma 2 and alpha
# 0.5 of the bag terms, SmoothL1 beta 0.11 and weight 0.75
FREE_ANCHOR_TOPK = 50
FREE_ANCHOR_BBOX_THR = 0.6
FREE_ANCHOR_GAMMA = 2.0
FREE_ANCHOR_ALPHA = 0.5
FREE_ANCHOR_BETA = 0.11
FREE_ANCHOR_BBOX_WEIGHT = 0.75
# PISA's ISR-P (k, bias) and CARL (k, bias) of the shipped RetinaNet and
# SSD files, CARL's weight 5
PISA_RETINA = dict(isr_k=2.0, isr_bias=0.0, carl_k=1.0, carl_bias=0.2)
PISA_SSD = dict(isr_k=2.0, isr_bias=0.25, carl_k=1.0, carl_bias=0.25)
PISA_CARL_WEIGHT = 5.0

Outs = Dict[str, Sequence[torch.Tensor]]
Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DenseLossConfig:
    """The JAX ``DenseLossConfig``'s fields that the runner sets. Its
    ``target_stds`` and loss weights, which no file sets, are their
    defaults here: the coders' unit stds and weight 1."""
    image_shape: Tuple[int, int]
    num_classes: int
    head: str = "retina"
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    # retina
    anchor: AnchorConfig = AnchorConfig()
    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    min_pos_iou: float = 0.0
    # fcos
    regress_ranges: Tuple[Tuple[float, float], ...] = (
        (-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))
    # atss
    topk: int = 9
    # ssd (the reference's configs/_base_/models/ssd300.py)
    ssd_input_size: int = 300
    ssd_ratios: Tuple[Tuple[float, ...], ...] = (
        (2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,), (2.0,))
    ssd_basesize_ratio_range: Tuple[float, float] = (0.15, 0.9)
    ssd_neg_pos_ratio: int = 3
    ssd_smoothl1_beta: float = 1.0
    ssd_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # fovea (the reference's defaults: alpha 0.4, gamma 1.5, bbox 0.75)
    fovea_base_edges: Tuple[float, ...] = (16, 32, 64, 128, 256)
    fovea_scale_ranges: Tuple[Tuple[float, float], ...] = (
        (8, 32), (16, 64), (32, 128), (64, 256), (128, 512))
    fovea_sigma: float = 0.4
    fovea_alpha: float = 0.4
    fovea_gamma: float = 1.5
    fovea_bbox_weight: float = 0.75
    # fsaf (CenterRegionAssigner + the TBLR coder)
    fsaf_pos_scale: float = 0.2
    fsaf_normalizer: float = 4.0


def _flatten(maps: Sequence[torch.Tensor], ch: int) -> torch.Tensor:
    """[(B, H, W, A * ch) ...] -> (B, N_total, ch) f32."""
    return torch.cat([m.reshape(m.shape[0], -1, ch) for m in maps],
                     dim=1).float()


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, D), idx (B, N) in [0, M) -> (B, N, D)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1,
                                                           x.shape[-1]))


def _assigned(gt_idx: torch.Tensor, gt_bboxes: torch.Tensor,
              gt_labels: torch.Tensor, num_classes: int):
    """(pos (B, N), labels (B, N) with ``num_classes`` = background,
    the assigned boxes (B, N, 4), GT 0's where unassigned)."""
    pos = gt_idx >= 0
    gi = gt_idx.clamp(min=0).long()
    labels = torch.where(pos, torch.gather(gt_labels.long(), 1, gi),
                         torch.full_like(gi, num_classes))
    return pos, labels, _take_rows(gt_bboxes, gi)


def _num_pos(pos: torch.Tensor) -> torch.Tensor:
    return pos.float().sum(-1).clamp(min=1.0)


def _focal_per_image(cls: torch.Tensor, labels: torch.Tensor,
                     weight, num_pos: torch.Tensor, **kw) -> torch.Tensor:
    """``sigmoid_focal_loss(..., avg_factor=num_pos)`` of each image:
    (B,)."""
    B, N = labels.shape
    loss = sigmoid_focal_loss(cls.reshape(B * N, -1), labels.reshape(-1),
                              None if weight is None else
                              weight.reshape(-1), reduction="none", **kw)
    return loss.reshape(B, -1).sum(-1) / num_pos


def _grid(acfg: AnchorConfig, cfg: DenseLossConfig, device):
    return grid_anchors_on(acfg, cfg.image_shape, device)


def _level_points(cfg: DenseLossConfig, device) -> torch.Tensor:
    """(N, 3) (x, y, stride) cell origins of every level."""
    return _level_points_on(tuple(cfg.strides), tuple(cfg.image_shape),
                            str(torch.device(device)))


@cached_constant
def _level_points_on(strides, image_shape, device):
    return P.multi_level_points(image_shape, strides, device)


def _centers(anchors: torch.Tensor) -> torch.Tensor:
    return torch.stack([(anchors[:, 0] + anchors[:, 2]) / 2,
                        (anchors[:, 1] + anchors[:, 3]) / 2], -1)


# ------------------------------------------------------------- RetinaNet ---

def retina_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)                               # (B, N, C)
    reg = _flatten(outs["reg"], 4)                               # (B, N, 4)
    anchors, _ = _grid(cfg.anchor, cfg, cls.device)
    B = cls.shape[0]
    pvalid = anchor_valid_flags(cfg.anchor, cfg.image_shape,
                                batch["img_shape"])
    res = max_iou_assign(anchors.expand(B, -1, -1), pvalid,
                         batch["gt_bboxes"], batch["gt_valid"],
                         pos_iou_thr=cfg.pos_iou_thr,
                         neg_iou_thr=cfg.neg_iou_thr,
                         min_pos_iou=cfg.min_pos_iou)
    pos, labels, target = _assigned(res.gt_idx, batch["gt_bboxes"],
                                    batch["gt_labels"], C)
    num_pos = _num_pos(pos)
    lw = (pvalid & ~res.ignore).float()
    loss_cls = _focal_per_image(cls, labels, lw, num_pos)
    # padded / unassigned rows would take log(0) in bbox2delta: the anchor
    # itself (zero delta) stands in; they weigh 0
    safe = torch.where(pos[..., None], target, anchors.expand(B, -1, -1))
    deltas = bbox2delta(anchors, safe)
    loss_bbox = l1_loss(reg, deltas, pos.float()[..., None],
                        reduction="none").sum((1, 2)) / num_pos
    losses = {"loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean()}
    return losses["loss_cls"] + losses["loss_bbox"], losses


# ------------------------------------------------------------------ FCOS ---

@cached_constant
def _fcos_points_on(strides, regress_ranges, image_shape, device):
    pts, stride, ranges = [], [], []
    for (h, w), s, rr in zip(P.level_shapes(image_shape, strides), strides,
                             regress_ranges):
        pts.append(P.grid_points((h, w), s, device)[:, :2] + s / 2.0)
        stride.append(torch.full((h * w,), float(s), device=device))
        ranges.append(torch.tensor(rr, dtype=torch.float32,
                                   device=device).repeat(h * w, 1))
    return torch.cat(pts), torch.cat(stride), torch.cat(ranges)


def _fcos_points(cfg: DenseLossConfig, device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(points (N, 2) at cell centres (+ stride / 2), per-point stride,
    per-point regress range (N, 2)), built once per (config, canvas,
    device)."""
    return _fcos_points_on(tuple(cfg.strides),
                           tuple(tuple(r) for r in cfg.regress_ranges),
                           tuple(cfg.image_shape), str(torch.device(device)))


def _centerness_target(ltrb: torch.Tensor, eps: float = 1e-12
                       ) -> torch.Tensor:
    lr = ltrb[..., 0::2]
    tb = ltrb[..., 1::2]
    return torch.sqrt(((lr.amin(-1) / lr.amax(-1).clamp(min=eps))
                       * (tb.amin(-1) / tb.amax(-1).clamp(min=eps))
                       ).clamp(min=0.0))


def fcos_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4)                      # positive l, t, r, b
    ctr = _flatten(outs["centerness"], 1)[..., 0]
    points, pt_stride, pt_range = _fcos_points(cfg, cls.device)
    pvalid = P.valid_flags(cfg.image_shape, cfg.strides, batch["img_shape"])
    gt = batch["gt_bboxes"]                                      # (B, M, 4)
    # (B, N, M, 4): l, t, r, b of each point in each GT
    ltrb = torch.stack([
        points[None, :, None, 0] - gt[:, None, :, 0],
        points[None, :, None, 1] - gt[:, None, :, 1],
        gt[:, None, :, 2] - points[None, :, None, 0],
        gt[:, None, :, 3] - points[None, :, None, 1]], -1)
    max_d = ltrb.amax(-1)
    cand = ((ltrb.amin(-1) > 0) & (max_d >= pt_range[None, :, None, 0])
            & (max_d <= pt_range[None, :, None, 1])
            & batch["gt_valid"][:, None, :])
    areas = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    area_mat = torch.where(cand, areas[:, None, :],
                           torch.full_like(max_d, INF))
    gt_idx = area_mat.argmin(dim=2)
    pos = (area_mat.amin(dim=2) < INF / 2) & pvalid
    labels = torch.where(pos, torch.gather(batch["gt_labels"].long(), 1,
                                           gt_idx),
                         torch.full_like(gt_idx, C))
    num_pos = _num_pos(pos)
    loss_cls = _focal_per_image(cls, labels, pvalid.float(), num_pos)
    pos_ltrb = torch.gather(ltrb, 2, gt_idx[..., None, None].expand(
        -1, -1, 1, 4))[:, :, 0]                                  # (B, N, 4)
    ctr_t = _centerness_target(pos_ltrb)
    posf = pos.float()
    # IoU loss on the decoded boxes, weighted by the centerness target
    pred_boxes = distance2bbox(points, reg * pt_stride[:, None])
    gt_boxes = distance2bbox(points, pos_ltrb.clamp(min=0.0))
    w = ctr_t * posf
    ctr_sum = w.sum(-1).clamp(min=1e-6)
    loss_bbox = iou_loss(pred_boxes, gt_boxes, w, reduction="none").sum(-1) \
        / ctr_sum
    loss_ctr = (bce_with_logits(ctr, ctr_t) * posf).sum(-1) / num_pos
    losses = {"loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean(),
              "loss_centerness": loss_ctr.mean()}
    return sum(losses.values()), losses


# ------------------------------------------------------------------ ATSS ---

def atss_anchor_cfg(cfg: DenseLossConfig) -> AnchorConfig:
    """ATSS (and GFL): one square anchor a cell, scale 8."""
    return AnchorConfig(strides=cfg.strides, ratios=(1.0,),
                        octave_base_scale=8.0, scales_per_octave=1)


def _atss_grid(cfg: DenseLossConfig, device):
    return _grid(atss_anchor_cfg(cfg), cfg, device)


def _atss(cfg: DenseLossConfig, batch: Batch, device):
    """The ATSS anchors, their per-level counts and valid flags, and the
    assignment."""
    anchors, counts = _atss_grid(cfg, device)
    pvalid = anchor_valid_flags(atss_anchor_cfg(cfg), cfg.image_shape,
                                batch["img_shape"])
    B = pvalid.shape[0]
    res = atss_assign(anchors.expand(B, -1, -1), pvalid, counts,
                      batch["gt_bboxes"], batch["gt_valid"], topk=cfg.topk)
    return anchors, counts, pvalid, res


def atss_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4)
    ctr = _flatten(outs["centerness"], 1)[..., 0]
    anchors, _, pvalid, res = _atss(cfg, batch, cls.device)
    pos, labels, tgt = _assigned(res.gt_idx, batch["gt_bboxes"],
                                 batch["gt_labels"], C)
    posf = pos.float()
    num_pos = _num_pos(pos)
    loss_cls = _focal_per_image(cls, labels, pvalid.float(), num_pos)
    # centerness target from the anchor centres inside the assigned GT
    c = _centers(anchors)
    ltrb = torch.stack([c[:, 0] - tgt[..., 0], c[:, 1] - tgt[..., 1],
                        tgt[..., 2] - c[:, 0], tgt[..., 3] - c[:, 1]], -1)
    ctr_t = _centerness_target(ltrb.clamp(min=0.0))
    pred_boxes = delta2bbox(anchors, reg, stds=ATSS_STDS)
    w = ctr_t * posf
    ctr_sum = w.sum(-1).clamp(min=1e-6)
    loss_bbox = giou_loss(pred_boxes, tgt, w, reduction="none").sum(-1) \
        / ctr_sum
    loss_ctr = (bce_with_logits(ctr, ctr_t) * posf).sum(-1) / num_pos
    losses = {"loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean(),
              "loss_centerness": loss_ctr.mean()}
    return sum(losses.values()), losses


# ------------------------------------------------------------------- GFL ---

def _integral(reg_logits: torch.Tensor) -> torch.Tensor:
    """Distribution -> expectation (the reference gfl ``Integral``):
    (..., 4 * (REG_MAX + 1)) logits -> (..., 4) distances, f32."""
    p = F.softmax(reg_logits.float().reshape(*reg_logits.shape[:-1], 4,
                                             REG_MAX + 1), dim=-1)
    bins = torch.arange(REG_MAX + 1, dtype=p.dtype, device=p.device)
    return (p * bins).sum(-1)


def _dfl(reg_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: cross-entropy on the two bins flanking the
    continuous ``target`` (bin units), weighted by its distance to each;
    reg_logits (..., n_bins), f32."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = target - tl.to(target.dtype)
    logp = F.log_softmax(reg_logits.float(), dim=-1)
    n_bins = reg_logits.shape[-1]
    ll = torch.gather(logp, -1, tl.clamp(0, n_bins - 1)[..., None])[..., 0]
    lr = torch.gather(logp, -1, tr.clamp(0, n_bins - 1)[..., None])[..., 0]
    return -(ll * wl + lr * wr)


def _qfl(cls_logits: torch.Tensor, labels: torch.Tensor,
         quality: torch.Tensor, num_classes: int,
         beta: float = 2.0) -> torch.Tensor:
    """Quality focal loss: BCE against the IoU quality at the labelled
    class (0 elsewhere, and everywhere for background), modulated by
    |y - sigmoid|^beta."""
    sig = torch.sigmoid(cls_logits)
    oh = F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].to(
        cls_logits.dtype)
    y = oh * quality[..., None]
    return (y - sig).abs() ** beta * bce_with_logits(cls_logits, y)


def gfl_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4 * (REG_MAX + 1))
    anchors, counts, pvalid, res = _atss(cfg, batch, cls.device)
    centers = _centers(anchors)
    stride_per = torch.cat([torch.full((n,), float(s), device=cls.device)
                            for n, s in zip(counts, cfg.strides)])
    pos, labels, tgt = _assigned(res.gt_idx, batch["gt_bboxes"],
                                 batch["gt_labels"], C)
    posf = pos.float()
    num_pos = _num_pos(pos)
    pred_boxes = distance2bbox(centers,
                               _integral(reg) * stride_per[:, None])
    quality = bbox_overlaps_aligned(pred_boxes, tgt).detach() * posf
    lq = _qfl(cls, labels, quality, C)
    loss_cls = (lq * pvalid.float()[..., None]).sum((1, 2)) / num_pos
    tgt_dist = (bbox2distance(centers, tgt) / stride_per[:, None]).clamp(
        0.0, REG_MAX - 0.1)
    B = reg.shape[0]
    ldfl = _dfl(reg.reshape(B, -1, 4, REG_MAX + 1), tgt_dist).mean(-1)
    wsum = quality.sum(-1).clamp(min=1e-6)
    loss_dfl = (ldfl * quality).sum(-1) / wsum * 0.25
    loss_bbox = giou_loss(pred_boxes, tgt, quality, reduction="none",
                          loss_weight=2.0).sum(-1) / wsum
    losses = {"loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean(),
              "loss_dfl": loss_dfl.mean()}
    return sum(losses.values()), losses


# ------------------------------------------------------ Guided Anchoring ---

def _ga_guided_anchors(outs: Outs, cfg: DenseLossConfig) -> torch.Tensor:
    """(B, N, 4) guided anchors from the shape branch: a square of
    ``GA_OCTAVE_BASE * stride`` scaled by exp(dw), exp(dh) (each clamped
    to [-4, 4]) around the cell origin."""
    shape = _flatten(outs["shape"], 2)
    pts = _level_points(cfg, shape.device)
    base = GA_OCTAVE_BASE * pts[:, 2]
    w = base * torch.exp(shape[..., 0].clamp(-4.0, 4.0))
    h = base * torch.exp(shape[..., 1].clamp(-4.0, 4.0))
    cx, cy = pts[:, 0], pts[:, 1]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _ga_center_mask(cfg: DenseLossConfig, pts: torch.Tensor,
                    gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                    ratio: float) -> torch.Tensor:
    """(B, N, M): the cell origin inside the ``ratio``-shrunk GT, at the
    GT's level (log2(sqrt(area) / 8) rounded, clamped to the levels;
    compared for equality with log2(stride / strides[0]))."""
    x1, y1, x2, y2 = gt_bboxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    hw, hh = (x2 - x1) * ratio / 2, (y2 - y1) * ratio / 2
    scale = torch.sqrt(((x2 - x1) * (y2 - y1)).clamp(min=1.0))
    gt_lvl = torch.floor(torch.log2(scale / 8.0) + 0.5).clamp(
        0, len(cfg.strides) - 1)
    pt_lvl = torch.log2(pts[:, 2] / cfg.strides[0])
    px, py = pts[None, :, 0, None], pts[None, :, 1, None]
    inside = ((px >= (cx - hw)[:, None]) & (px <= (cx + hw)[:, None])
              & (py >= (cy - hh)[:, None]) & (py <= (cy + hh)[:, None]))
    return (inside & (pt_lvl[None, :, None] == gt_lvl[:, None, :])
            & gt_valid[:, None, :])


def _ga_loc_shape(loc: torch.Tensor, anchors: torch.Tensor, batch: Batch,
                  cfg: DenseLossConfig):
    """The location and shape terms of each image: (loss_loc (B,),
    loss_shape (B,))."""
    gt, gvalid = batch["gt_bboxes"], batch["gt_valid"]
    pts = _level_points(cfg, loc.device)
    areas = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])).clamp(
        min=0.0)
    pos_m = _ga_center_mask(cfg, pts, gt, gvalid, GA_CENTER_RATIO)
    ign_m = _ga_center_mask(cfg, pts, gt, gvalid, GA_IGNORE_RATIO)
    loc_pos = pos_m.any(-1)
    loc_ign = ign_m.any(-1) & ~loc_pos
    n_loc_pos = _num_pos(loc_pos)
    lw = (~loc_ign).float()
    loss_loc = _focal_per_image(loc[..., None], (~loc_pos).long(), lw,
                                n_loc_pos, num_classes=1)
    # shape: the smallest GT whose centre region holds the cell
    rank = torch.where(pos_m, areas[:, None, :],
                       torch.full(pos_m.shape, INF, device=loc.device))
    tgt = _take_rows(gt, rank.argmin(-1))
    loss_shape = iou_loss(anchors, tgt, loc_pos.float(),
                          reduction="none").sum(-1) / n_loc_pos
    return loss_loc, loss_shape


def ga_retina_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """Guided-Anchoring RetinaNet: the location (focal; positives in the
    0.2-shrunk GT at its level, an ignore ring out to 0.5) and shape (IoU
    of the guided anchor with its GT) terms, then MaxIoU assignment on the
    detached guided anchors, focal + L1 on the deltas."""
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4)
    loc = _flatten(outs["loc"], 1)[..., 0]
    anchors = _ga_guided_anchors(outs, cfg)
    loss_loc, loss_shape = _ga_loc_shape(loc, anchors, batch, cfg)
    ga = anchors.detach()
    res = max_iou_assign(ga, torch.ones(ga.shape[:2], dtype=torch.bool,
                                        device=ga.device),
                         batch["gt_bboxes"], batch["gt_valid"],
                         pos_iou_thr=cfg.pos_iou_thr,
                         neg_iou_thr=cfg.neg_iou_thr,
                         min_pos_iou=cfg.min_pos_iou)
    pos, labels, target = _assigned(res.gt_idx, batch["gt_bboxes"],
                                    batch["gt_labels"], C)
    num_pos = _num_pos(pos)
    loss_cls = _focal_per_image(cls, labels, None, num_pos)
    deltas = bbox2delta(ga, torch.where(pos[..., None], target, ga))
    loss_bbox = l1_loss(reg, deltas, pos.float()[..., None],
                        reduction="none").sum((1, 2)) / num_pos
    losses = {"loss_loc": loss_loc.mean(), "loss_shape": loss_shape.mean(),
              "loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean()}
    return sum(losses.values()), losses


def ga_rpn_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """Guided-Anchoring RPN: the location and shape terms of
    :func:`ga_retina_loss`, then binary objectness: MaxIoU assignment on
    the detached guided anchors at 0.7 / 0.3 (min_pos_iou 0.3); the
    negatives whose score reaches the k-th highest negative score, k =
    max(GA_RPN_SAMPLES - positives, 1) (the values of a top-k, so the order
    of ties does not matter), join the positives in a BCE; SmoothL1 on
    the positives' deltas, both over the sample count."""
    cls = _flatten(outs["cls"], 1)[..., 0]
    reg = _flatten(outs["reg"], 4)
    loc = _flatten(outs["loc"], 1)[..., 0]
    anchors = _ga_guided_anchors(outs, cfg)
    loss_loc, loss_shape = _ga_loc_shape(loc, anchors, batch, cfg)
    ga = anchors.detach()
    gt = batch["gt_bboxes"]
    res = max_iou_assign(ga, torch.ones(ga.shape[:2], dtype=torch.bool,
                                        device=ga.device),
                         gt, batch["gt_valid"], pos_iou_thr=0.7,
                         neg_iou_thr=0.3, min_pos_iou=0.3)
    pos = res.gt_idx >= 0
    posf = pos.float()
    neg = ~pos & ~res.ignore
    neg_quota = (GA_RPN_SAMPLES - posf.sum(-1)).clamp(min=1.0)
    neg_rank = torch.where(neg, cls.detach(),
                           torch.full_like(cls, float("-inf")))
    thr_k = min(GA_RPN_SAMPLES, cls.shape[1])
    top_neg = torch.topk(neg_rank, thr_k, dim=-1).values
    at = (neg_quota.long() - 1).clamp(0, thr_k - 1)
    kth = torch.gather(top_neg, 1, at[:, None])
    wc = posf + (neg & (cls.detach() >= kth)).float()
    n_samp = wc.sum(-1).clamp(min=1.0)
    loss_cls = (bce_with_logits(cls, posf) * wc).sum(-1) / n_samp
    safe = torch.where(pos[..., None],
                       _take_rows(gt, res.gt_idx.clamp(min=0)), ga)
    deltas = bbox2delta(ga, safe)
    diff = (reg - deltas).abs()
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    loss_bbox = (sl1 * posf).sum(-1) / n_samp
    losses = {"loss_anchor_loc": loss_loc.mean(),
              "loss_anchor_shape": loss_shape.mean(),
              "loss_rpn_cls": loss_cls.mean(),
              "loss_rpn_bbox": loss_bbox.mean()}
    return sum(losses.values()), losses


# ------------------------------------------------------------------- SSD ---

@cached_constant
def _ssd_grid_on(strides, ratios, basesize_ratio_range, input_size,
                 level_shapes, device):
    bases = ssd_base_anchors(strides, ratios, basesize_ratio_range,
                             input_size)
    grids = [shifted_anchors(b, s, h, w)
             for b, s, (h, w) in zip(bases, strides, level_shapes)]
    return torch.from_numpy(np.concatenate(grids)).to(device)


def _ssd_anchors(cfg: DenseLossConfig, maps: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """(N, 4) SSD anchors on the (B, h, w, A_l * ch) head maps' own grids,
    built once per (config, map sizes, device)."""
    return _ssd_grid_on(
        tuple(cfg.strides), tuple(tuple(r) for r in cfg.ssd_ratios),
        tuple(cfg.ssd_basesize_ratio_range), cfg.ssd_input_size,
        tuple(tuple(m.shape[1:3]) for m in maps),
        str(torch.device(maps[0].device)))


def _ssd_common(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """What SSD and PISA-SSD share: (cls (B, N, C + 1), reg (B, N, 4),
    anchors, the assigned GT index, positives, labels, the assigned box
    (the anchor itself where unassigned), the CE of each anchor's label,
    the mined negatives)."""
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C + 1)
    reg = _flatten(outs["reg"], 4)
    anchors = _ssd_anchors(cfg, outs["cls"])
    B, N = cls.shape[:2]
    res = max_iou_assign(anchors.expand(B, -1, -1),
                         torch.ones(B, N, dtype=torch.bool,
                                    device=cls.device),
                         batch["gt_bboxes"], batch["gt_valid"],
                         pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0,
                         gt_max_assign_all=False)
    pos, labels, target = _assigned(res.gt_idx, batch["gt_bboxes"],
                                    batch["gt_labels"], C)
    ce = -torch.gather(F.log_softmax(cls, -1), -1, labels[..., None])[..., 0]
    # hard negatives: every negative whose CE reaches the k-th largest
    # negative CE, k = min(neg_pos_ratio * positives, negatives)
    neg = ~pos & ~res.ignore
    n_neg = torch.minimum(cfg.ssd_neg_pos_ratio * pos.float().sum(-1),
                          neg.float().sum(-1))
    ranked = torch.where(neg, ce, torch.full_like(ce, float("-inf"))).detach()
    top = torch.sort(ranked, dim=-1, descending=True).values
    kth = torch.gather(top, 1, (n_neg.long() - 1).clamp(0, N - 1)[:, None])
    neg_sel = neg & (ce.detach() >= kth) & (n_neg > 0)[:, None]
    safe = torch.where(pos[..., None], target, anchors.expand(B, -1, -1))
    return cls, reg, anchors, res.gt_idx, pos, labels, safe, ce, neg_sel


def ssd_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """SSD's multibox loss: the positives' and mined negatives' softmax
    CE and the positives' SmoothL1 on the deltas (stds ``ssd_stds``), each
    summed over the batch and divided by its positives."""
    _, reg, anchors, _, pos, _, safe, ce, neg_sel = _ssd_common(
        outs, batch, cfg)
    posf = pos.float()
    denom = posf.sum().clamp(min=1.0)
    deltas = bbox2delta(anchors, safe, stds=cfg.ssd_stds)
    sl1 = smooth_l1_loss(reg, deltas, beta=cfg.ssd_smoothl1_beta,
                         reduction="none").sum(-1)
    losses = {"loss_cls": ((ce * posf).sum() + (ce * neg_sel.float()).sum())
              / denom,
              "loss_bbox": (sl1 * posf).sum() / denom}
    return sum(losses.values()), losses


# ------------------------------------------------------------- FoveaBox ---

def _fovea_targets(cfg: DenseLossConfig, gt_bboxes: torch.Tensor,
                   gt_valid: torch.Tensor, gt_labels: torch.Tensor):
    """(labels (B, N), ``num_classes`` = background; log-space (l, t, r,
    b) / base-edge targets (B, N, 4), 0 off the positives): on each level,
    the points inside a GT's sigma-shrunk region, for the GTs whose
    sqrt(area) lies in the level's scale range; the smallest GT wins where
    regions overlap (the reference writes the largest first)."""
    C = cfg.num_classes
    dev = gt_bboxes.device
    x1g, y1g, x2g, y2g = gt_bboxes.unbind(-1)
    areas = torch.sqrt(((x2g - x1g) * (y2g - y1g)).clamp(min=0.0))
    sig = cfg.fovea_sigma
    labels_all, targets_all = [], []
    for (h, w), base, (lo, up), s in zip(
            P.level_shapes(cfg.image_shape, cfg.strides),
            cfg.fovea_base_edges, cfg.fovea_scale_ranges, cfg.strides):
        gx = torch.arange(w, dtype=torch.float32, device=dev)
        gy = torch.arange(h, dtype=torch.float32, device=dev)
        hit = (areas >= lo) & (areas <= up) & gt_valid          # (B, M)
        gb = gt_bboxes / s
        half_w = 0.5 * (gb[..., 2] - gb[..., 0])
        half_h = 0.5 * (gb[..., 3] - gb[..., 1])
        x1 = torch.ceil(gb[..., 0] + (1 - sig) * half_w - 0.5).clamp(0, w - 1)
        x2 = torch.floor(gb[..., 0] + (1 + sig) * half_w - 0.5).clamp(
            0, w - 1)
        y1 = torch.ceil(gb[..., 1] + (1 - sig) * half_h - 0.5).clamp(0, h - 1)
        y2 = torch.floor(gb[..., 1] + (1 + sig) * half_h - 0.5).clamp(
            0, h - 1)
        in_x = (gx[None, :, None] >= x1[:, None]) & \
            (gx[None, :, None] <= x2[:, None])                 # (B, w, M)
        in_y = (gy[None, :, None] >= y1[:, None]) & \
            (gy[None, :, None] <= y2[:, None])                 # (B, h, M)
        inside = (in_y[:, :, None] & in_x[:, None]
                  & hit[:, None, None]).flatten(1, 2)          # (B, hw, M)
        rank = torch.where(inside, areas[:, None],
                           torch.full(inside.shape, INF, device=dev))
        gi = rank.argmin(-1)                                   # (B, hw)
        any_hit = inside.any(-1)
        labels_all.append(torch.where(
            any_hit, torch.gather(gt_labels.long(), 1, gi),
            torch.full_like(gi, C)))
        gsel = _take_rows(gt_bboxes, gi)
        px = gx.repeat(h) * s
        py = gy.repeat_interleave(w) * s
        t = torch.stack([px - gsel[..., 0], py - gsel[..., 1],
                         gsel[..., 2] - px, gsel[..., 3] - py], -1) / base
        t = torch.log(t.clamp(1.0 / 16, 16.0))
        targets_all.append(torch.where(any_hit[..., None], t,
                                       torch.zeros_like(t)))
    return torch.cat(labels_all, 1), torch.cat(targets_all, 1)


def fovea_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """FoveaBox: focal (``fovea_alpha`` / ``fovea_gamma``) summed over the
    batch / (positives + B), SmoothL1 (beta 0.11, mean of the four sides)
    over the positives, weight ``fovea_bbox_weight``."""
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4)
    B = cls.shape[0]
    labels, tgts = _fovea_targets(cfg, batch["gt_bboxes"],
                                  batch["gt_valid"], batch["gt_labels"])
    posf = (labels < C).float()
    num_pos = posf.sum()
    lc = sigmoid_focal_loss(cls.reshape(-1, C), labels.reshape(-1),
                            gamma=cfg.fovea_gamma, alpha=cfg.fovea_alpha,
                            reduction="sum")
    sl1 = smooth_l1_loss(reg, tgts, beta=FOVEA_BETA,
                         reduction="none").mean(-1)
    losses = {"loss_cls": lc / (num_pos + B),
              "loss_bbox": (sl1 * posf).sum() / num_pos.clamp(min=1.0)
              * cfg.fovea_bbox_weight}
    return sum(losses.values()), losses


# ----------------------------------------------------------------- FSAF ---

def _fsaf_assign(cfg: DenseLossConfig, gt_bboxes: torch.Tensor,
                 gt_valid: torch.Tensor):
    """The CenterRegionAssigner on every level: a cell origin (the FSAF
    anchors' centre offset is 0) inside a GT's ``fsaf_pos_scale``-shrunk
    box is positive, the smallest such GT wins. -> (gt_idx (B, N), -1 =
    background; level of each point (N,))."""
    dev = gt_bboxes.device
    x1, y1, x2, y2 = gt_bboxes.unbind(-1)
    areas = ((x2 - x1) * (y2 - y1)).clamp(min=0.0)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    hw = (x2 - x1) * cfg.fsaf_pos_scale / 2
    hh = (y2 - y1) * cfg.fsaf_pos_scale / 2
    gt_idx_all, lvl_all = [], []
    for li, ((h, w), s) in enumerate(zip(
            P.level_shapes(cfg.image_shape, cfg.strides), cfg.strides)):
        px = torch.arange(w, dtype=torch.float32, device=dev).repeat(h) * s
        py = torch.arange(h, dtype=torch.float32,
                          device=dev).repeat_interleave(w) * s
        px, py = px[None, :, None], py[None, :, None]
        inside = ((px >= (cx - hw)[:, None]) & (px <= (cx + hw)[:, None])
                  & (py >= (cy - hh)[:, None]) & (py <= (cy + hh)[:, None])
                  & gt_valid[:, None])                         # (B, hw, M)
        rank = torch.where(inside, areas[:, None],
                           torch.full(inside.shape, INF, device=dev))
        gt_idx_all.append(torch.where(inside.any(-1), rank.argmin(-1),
                                      torch.full_like(rank[..., 0], -1,
                                                      dtype=torch.long)))
        lvl_all.append(torch.full((h * w,), li, device=dev))
    return torch.cat(gt_idx_all, 1), torch.cat(lvl_all)


def fsaf_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """FSAF: centre-region assignment, focal + IoU loss on the TBLR decode
    (distances x ``fsaf_normalizer`` x stride around the cell origin), and
    online level selection: each GT keeps the level of least mean
    (focal + IoU) over its positives there; its positives elsewhere are
    ignored, not background."""
    C = cfg.num_classes
    L = len(cfg.strides)
    gt = batch["gt_bboxes"]
    M = gt.shape[1]
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4)
    pts = _level_points(cfg, cls.device)
    gt_idx, lvl = _fsaf_assign(cfg, gt, batch["gt_valid"])
    pos, labels, tgt = _assigned(gt_idx, gt, batch["gt_labels"], C)
    posf = pos.float()
    r = reg * (cfg.fsaf_normalizer * pts[:, 2])[:, None]
    t, b, l, rr = r.unbind(-1)
    px, py = pts[:, 0], pts[:, 1]
    boxes = torch.stack([px - l, py - t, px + rr, py + b], -1)
    il = iou_loss(boxes, tgt, posf, reduction="none")          # (B, N)
    B, N = labels.shape
    lc_map = sigmoid_focal_loss(cls.reshape(B * N, C), labels.reshape(-1),
                                reduction="none").sum(-1).reshape(B, N)
    comb = (lc_map + il).detach()
    oh_gt = F.one_hot(torch.where(pos, gt_idx, torch.full_like(gt_idx, M)),
                      M + 1)[..., :M].float()                  # (B, N, M)
    oh_lvl = F.one_hot(lvl, L).float()                         # (N, L)
    sums = torch.einsum("bn,bnm,nl->bml", comb, oh_gt, oh_lvl)
    cnts = torch.einsum("bnm,nl->bml", oh_gt, oh_lvl)
    means = torch.where(cnts > 0, sums / cnts.clamp(min=1.0),
                        torch.full_like(sums, INF))
    best_lvl = means.argmin(-1)                                # (B, M)
    keep = (lvl[None] == torch.gather(best_lvl, 1, gt_idx.clamp(min=0))) \
        & pos
    keepf = keep.float()
    num_pos = _num_pos(keep)
    labels = torch.where(keep, labels, torch.full_like(labels, C))
    lw = torch.where(pos & ~keep, 0.0, 1.0)
    loss_cls = _focal_per_image(cls, labels, lw, num_pos)
    loss_bbox = (il * keepf).sum(-1) / num_pos
    losses = {"loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean()}
    return sum(losses.values()), losses


# ----------------------------------------------------------- FreeAnchor ---

def free_anchor_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """FreeAnchor's learning to match: for each GT a bag of the
    ``FREE_ANCHOR_TOPK`` anchors of highest IoU (a stable sort: ties keep
    the lower anchor first, as ``jax.lax.top_k``), the positive bag term
    -log of the mean-max of (class probability x exp(-SmoothL1 of the
    deltas)); the negative bag term focal on each anchor's class
    probability x (1 - its object probability), the saturated IoU of its
    (detached) decoded box with the GTs of that class (a scatter-max over
    the GT labels)."""
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4)
    anchors, _ = _grid(cfg.anchor, cfg, cls.device)
    gt, gvalid = batch["gt_bboxes"], batch["gt_valid"]
    B, N = cls.shape[:2]
    M, K = gt.shape[1], FREE_ANCHOR_TOPK
    thr = FREE_ANCHOR_BBOX_THR
    gvf = gvalid.float()
    cls_prob = torch.sigmoid(cls)
    with torch.no_grad():
        # each anchor's object probability by class
        pred = delta2bbox(anchors, reg)
        iou_gp = box_iou(gt, pred) * gvf[..., None]           # (B, M, N)
        t2 = iou_gp.amax(-1, keepdim=True).clamp(min=thr + 1e-12)
        obp = ((iou_gp - thr) / (t2 - thr)).clamp(0.0, 1.0) * gvf[..., None]
        lab = batch["gt_labels"].long()
        lab = torch.where(gvalid, lab, torch.full_like(lab, C))
        ibp = torch.zeros(B, C + 1, N, device=cls.device).scatter_reduce(
            1, lab[..., None].expand(-1, -1, N), obp, "amax")
        ibp = ibp[:, :C].transpose(1, 2)                       # (B, N, C)
        iou_ga = box_iou(gt, anchors.expand(B, -1, -1)) * gvf[..., None]
        matched = torch.sort(iou_ga, dim=-1, descending=True,
                             stable=True).indices[..., :K]     # (B, M, K)
    label = batch["gt_labels"].long().clamp(0, C - 1)
    m_cls = torch.gather(cls_prob.reshape(B, N * C), 1,
                         (matched * C + label[..., None]).reshape(B, -1)
                         ).reshape(B, M, K)
    m_anchors = anchors[matched]                               # (B, M, K, 4)
    # a padded zero-size GT would put log(0) in the deltas: the unit box
    # stands in; those bags weigh 0
    safe_gt = torch.where(gvalid[..., None], gt,
                          gt.new_tensor([0.0, 0.0, 1.0, 1.0]))
    tgt = bbox2delta(m_anchors, safe_gt[:, :, None].expand(-1, -1, K, -1))
    m_reg = torch.gather(reg, 1, matched.reshape(B, -1, 1).expand(
        -1, -1, 4)).reshape(B, M, K, 4)
    sl1 = smooth_l1_loss(m_reg, tgt, beta=FREE_ANCHOR_BETA,
                         reduction="none").sum(-1) * FREE_ANCHOR_BBOX_WEIGHT
    m_prob = m_cls * torch.exp(-sl1)
    w = 1.0 / (1.0 - m_prob).clamp(min=1e-12)
    w = w / w.sum(-1, keepdim=True)
    bag_prob = (w * m_prob).sum(-1).clamp(1e-12, 1.0)
    alpha = FREE_ANCHOR_ALPHA
    pos_loss = alpha * -torch.log(bag_prob) * gvf             # (B, M)
    nprob = (cls_prob * (1.0 - ibp)).clamp(0.0, 1.0 - 1e-12)
    neg_loss = (1 - alpha) * nprob ** FREE_ANCHOR_GAMMA * -torch.log1p(
        -nprob)
    num_pos = gvf.sum().clamp(min=1.0)
    losses = {"positive_bag_loss": pos_loss.sum() / num_pos,
              "negative_bag_loss": neg_loss.sum() / (num_pos * K)}
    return sum(losses.values()), losses


# ---------------------------------------------------------------- PISA ---

def _rank_in_groups(keys: torch.Tensor, groups: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """(B, N) descending rank of ``keys`` within each group (rank 0 =
    best), ties by index (two stable sorts, as JAX's ``lexsort`` of
    (group, -key)); invalid rows rank in a group of their own."""
    N = keys.shape[-1]
    g = torch.where(valid, groups.long(),
                    torch.full_like(groups, 2 ** 30, dtype=torch.long))
    by_key = torch.sort(-keys, dim=-1, stable=True).indices
    order = torch.gather(by_key, 1, torch.sort(
        torch.gather(g, 1, by_key), dim=-1, stable=True).indices)
    sorted_g = torch.gather(g, 1, order)
    idx = torch.arange(N, device=keys.device).expand_as(order)
    new = torch.ones_like(sorted_g, dtype=torch.bool)
    new[:, 1:] = sorted_g[:, 1:] != sorted_g[:, :-1]
    seg_start = torch.where(new, idx, torch.full_like(idx, -1)).cummax(
        -1).values
    return torch.zeros_like(order).scatter_(1, order, idx - seg_start)


def _isr_importance(ious: torch.Tensor, pos: torch.Tensor,
                    labels: torch.Tensor, gt_idx: torch.Tensor, M: int,
                    C: int, isr_k: float, isr_bias: float) -> torch.Tensor:
    """ISR-P's IoU-HLR importance of each positive (B, N): its rank among
    its GT's positives first, then over the class; -> ((bias + (1 - bias)
    x (max_l - rank) / max_l) ^ k, max_l the most positives of a
    class)."""
    grp_gt = labels * (M + 1) + gt_idx.clamp(min=0).long()
    r_local = _rank_in_groups(ious, grp_gt, pos)
    counts = torch.zeros(labels.shape[0], C + 1, dtype=torch.long,
                         device=labels.device).scatter_add_(
        1, labels, pos.long())
    max_l = counts[:, :C].amax(-1).clamp(min=1).float()[:, None]
    r_hlr = _rank_in_groups(ious + (max_l - r_local.float()), labels, pos)
    imp = ((max_l - r_hlr.float()) / max_l).clamp(min=0.0)
    return (isr_bias + imp * (1 - isr_bias)) ** isr_k


def pisa_retina_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """PISA RetinaNet: the RetinaNet assignment and L1, the positives'
    focal loss reweighted by ISR-P (scaled to keep their sum), and CARL:
    the positives' L1 weighted by their class probability."""
    p = PISA_RETINA
    C = cfg.num_classes
    cls = _flatten(outs["cls"], C)
    reg = _flatten(outs["reg"], 4)
    anchors, _ = _grid(cfg.anchor, cfg, cls.device)
    gt = batch["gt_bboxes"]
    B, N = cls.shape[:2]
    pvalid = anchor_valid_flags(cfg.anchor, cfg.image_shape,
                                batch["img_shape"])
    res = max_iou_assign(anchors.expand(B, -1, -1), pvalid, gt,
                         batch["gt_valid"], pos_iou_thr=cfg.pos_iou_thr,
                         neg_iou_thr=cfg.neg_iou_thr,
                         min_pos_iou=cfg.min_pos_iou)
    pos, labels, target = _assigned(res.gt_idx, gt, batch["gt_labels"], C)
    posf = pos.float()
    lw = (pvalid & ~res.ignore).float()
    num_pos = _num_pos(pos)[:, None]
    tgt = torch.where(pos[..., None], target, anchors.expand(B, -1, -1))
    deltas = bbox2delta(anchors, tgt)
    ious = bbox_overlaps_aligned(delta2bbox(anchors, reg.detach()), tgt)
    imp = _isr_importance(ious, pos, labels, res.gt_idx, gt.shape[1], C,
                          p["isr_k"], p["isr_bias"])
    per_cls = sigmoid_focal_loss(cls.reshape(B * N, C), labels.reshape(-1),
                                 reduction="none").sum(-1).reshape(B, N)
    ori = (per_cls * posf * lw).sum(-1, keepdim=True)
    new = (per_cls * posf * imp).sum(-1, keepdim=True).clamp(min=1e-12)
    imp = imp * (ori / new)
    w_cls = torch.where(pos, imp * lw, lw)
    loss_cls = (per_cls * w_cls).sum(-1) / num_pos[:, 0]
    loss_bbox = l1_loss(reg, deltas, posf[..., None],
                        reduction="none").sum((1, 2)) / num_pos[:, 0]
    p_cls = torch.sigmoid(torch.gather(cls, -1, labels.clamp(
        0, C - 1)[..., None])[..., 0])
    cw = (p["carl_bias"] + (1 - p["carl_bias"]) * p_cls) ** p["carl_k"]
    cw = cw * num_pos / (cw * posf).sum(-1, keepdim=True).clamp(min=1e-12)
    reg_l = (reg - deltas).abs().sum(-1) / num_pos
    loss_carl = (reg_l * cw * posf).sum(-1) * PISA_CARL_WEIGHT \
        / num_pos[:, 0]
    losses = {"loss_cls": loss_cls.mean(), "loss_bbox": loss_bbox.mean(),
              "loss_carl": loss_carl.mean()}
    return sum(losses.values()), losses


def pisa_ssd_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """PISA SSD: the SSD loss with the positives' CE reweighted by ISR-P
    (scaled to keep their sum; the mined negatives unweighted), and CARL:
    the positives' SmoothL1 weighted by their softmax class
    probability."""
    p = PISA_SSD
    C = cfg.num_classes
    cls, reg, anchors, gt_idx, pos, labels, safe, ce, neg_sel = \
        _ssd_common(outs, batch, cfg)
    posf = pos.float()
    num_pos = posf.sum(-1, keepdim=True)
    deltas = bbox2delta(anchors, safe, stds=cfg.ssd_stds)
    ious = bbox_overlaps_aligned(
        delta2bbox(anchors, reg.detach(), stds=cfg.ssd_stds), safe)
    imp = _isr_importance(ious, pos, labels, gt_idx,
                          batch["gt_bboxes"].shape[1], C, p["isr_k"],
                          p["isr_bias"])
    ori = (ce * posf).sum(-1, keepdim=True)
    new = (ce * posf * imp).sum(-1, keepdim=True).clamp(min=1e-12)
    imp = imp * (ori / new)
    loss_cls = (ce * posf * imp).sum(-1) + (ce * neg_sel.float()).sum(-1)
    sl1 = smooth_l1_loss(reg, deltas, beta=cfg.ssd_smoothl1_beta,
                         reduction="none").sum(-1)
    p_cls = torch.gather(F.softmax(cls, -1), -1, labels.clamp(
        0, C - 1)[..., None])[..., 0]
    cw = (p["carl_bias"] + (1 - p["carl_bias"]) * p_cls) ** p["carl_k"]
    np_ = num_pos.clamp(min=1.0)
    cw = cw * np_ / (cw * posf).sum(-1, keepdim=True).clamp(min=1e-12)
    loss_carl = (sl1 / np_ * cw * posf).sum(-1) * PISA_CARL_WEIGHT \
        / np_[:, 0]
    denom = num_pos.sum().clamp(min=1.0)
    losses = {"loss_cls": loss_cls.sum() / denom,
              "loss_bbox": (sl1 * posf).sum() / denom,
              "loss_carl": loss_carl.mean()}
    return sum(losses.values()), losses


LOSSES = {"retina": retina_loss, "fcos": fcos_loss, "atss": atss_loss,
          "gfl": gfl_loss, "ssd": ssd_loss, "fovea": fovea_loss,
          "fsaf": fsaf_loss, "free_anchor": free_anchor_loss,
          "pisa_retina": pisa_retina_loss, "pisa_ssd": pisa_ssd_loss,
          "ga_retina": ga_retina_loss, "ga_rpn": ga_rpn_loss}


def dense_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """Dispatch by head kind (the generic ``lsnet_loss`` counterpart);
    -> (total, {term: value})."""
    fn = LOSSES.get(cfg.head)
    if fn is None:
        raise NotImplementedError(
            f"dense head kind {cfg.head!r}: the port has the losses of "
            f"every dense kind, {', '.join(KINDS)}; the two-stage family "
            "is ROADMAP Queue 1 \"Inherited zoo\"")
    return fn(outs, batch, cfg)
