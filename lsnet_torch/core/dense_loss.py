"""Losses of the dense-head zoo (counterpart of
``lsnet_tpu/core/dense_loss.py``): RetinaNet, FCOS, ATSS, GFL and the two
Guided Anchoring heads.

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
  SmoothL1 with hard negatives (GA-RPN).

Everything runs dense over padded GT (M slots and a validity mask) with a
written-out batch dimension where JAX ``vmap``s; each term is reduced per
image, then averaged over the batch, as JAX's. The IoU matrices are
(B, N, M) f32 and are never expanded per class. The anchor grids and the
FCOS points are built once per (config, canvas, device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.losses.common import (bbox_overlaps_aligned,
                                    bce_with_logits, giou_loss, iou_loss,
                                    l1_loss)
from ..ops.focal_loss import sigmoid_focal_loss
from . import points as P
from .anchors import (AnchorConfig, anchor_valid_flags, bbox2delta,
                      bbox2distance, cached_constant, delta2bbox,
                      distance2bbox, grid_anchors_on)
from .assign import atss_assign, max_iou_assign

INF = 1e8
# the head kinds whose loss and decode are ported; the rest of the JAX
# zoo's kinds wait for the next dense slice (ROADMAP Queue 1)
KINDS = ("retina", "fcos", "atss", "gfl", "ga_retina", "ga_rpn")
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

Outs = Dict[str, Sequence[torch.Tensor]]
Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class DenseLossConfig:
    """The JAX ``DenseLossConfig``'s fields of the ported kinds that the
    runner sets (its SSD, FoveaBox and FSAF fields wait with those heads).
    Its ``target_stds`` and loss weights, which no file sets, are their
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

def _ga_points(cfg: DenseLossConfig, device) -> torch.Tensor:
    """(N, 3) (x, y, stride) cell origins of every level."""
    return _ga_points_on(tuple(cfg.strides), tuple(cfg.image_shape),
                         str(torch.device(device)))


@cached_constant
def _ga_points_on(strides, image_shape, device):
    return P.multi_level_points(image_shape, strides, device)


def _ga_guided_anchors(outs: Outs, cfg: DenseLossConfig) -> torch.Tensor:
    """(B, N, 4) guided anchors from the shape branch: a square of
    ``GA_OCTAVE_BASE * stride`` scaled by exp(dw), exp(dh) (each clamped
    to [-4, 4]) around the cell origin."""
    shape = _flatten(outs["shape"], 2)
    pts = _ga_points(cfg, shape.device)
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
    pts = _ga_points(cfg, loc.device)
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


LOSSES = {"retina": retina_loss, "fcos": fcos_loss, "atss": atss_loss,
          "gfl": gfl_loss, "ga_retina": ga_retina_loss,
          "ga_rpn": ga_rpn_loss}


def dense_loss(outs: Outs, batch: Batch, cfg: DenseLossConfig):
    """Dispatch by head kind (the generic ``lsnet_loss`` counterpart);
    -> (total, {term: value})."""
    fn = LOSSES.get(cfg.head)
    if fn is None:
        raise NotImplementedError(
            f"dense head kind {cfg.head!r}: the port has the losses of "
            f"{', '.join(KINDS)}; the rest of the dense zoo is ROADMAP "
            "Queue 1 \"Inherited zoo\", the next dense slice")
    return fn(outs, batch, cfg)
