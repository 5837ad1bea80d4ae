"""Two-stage (Faster R-CNN) training and inference logic (counterpart of
``lsnet_tpu/core/two_stage.py``, its Faster R-CNN, Double-Head, Dynamic
R-CNN and Fast R-CNN parts).

Fixed shapes throughout, as in the JAX package: proposals are padded sets
of ``proposal_count`` a image with a validity mask, and RoI sampling takes
a fixed quota a image, the highest-IoU positives, then the highest-IoU
negatives (the JAX package's deterministic stand-in for mmdet's
RandomSampler). Every top-k whose *indices* are used breaks ties to the
lower index, as ``lax.top_k`` does (``ops.nms._top_stable``): many
negatives tie at IoU 0, and at ``-inf`` in the padding. A top-k whose
values alone are read takes ``torch.topk``, whose values are the same.

The losses and decodes take the detector (a ``TwoStageDetector``,
``DoubleHeadRCNNDetector`` or, for :func:`fast_rcnn_decode`, a
``FastRCNNDetector``) and call its ``extract`` / ``rpn`` / ``roi_forward``
in turn; ``sampling`` is the backbone's DCN sampling, as everywhere in
the port. The RPN maps are detached before the proposals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..ops.flat_deform import INFERENCE_SAMPLING, TRAIN_SAMPLING
from ..ops.nms import NEG_INF, _top_stable, batched_nms, box_iou, nms
from ..models.losses.common import bce_with_logits
from .anchors import (AnchorConfig, anchor_valid_flags, bbox2delta,
                      delta2bbox, grid_anchors_on)
from .assign import max_iou_assign
from .decode import Detections, TestConfig
from .dense_loss import _flatten

Maps = Dict[str, List[torch.Tensor]]
Batch = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class TwoStageConfig:
    image_shape: Tuple[int, int]
    num_classes: int
    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)
    # RPN anchors: 1 scale x 3 ratios a level (the reference faster_rcnn)
    anchor_scales: Tuple[float, ...] = (8.0,)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # RPN assignment and sampling
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    rpn_num_samples: int = 256
    # proposals
    nms_pre: int = 1000
    proposal_count: int = 512      # post-NMS proposals kept (train + test)
    proposal_nms_iou: float = 0.7
    # RCNN
    rcnn_pos_iou: float = 0.5
    rcnn_num_samples: int = 512
    rcnn_pos_fraction: float = 0.25
    rcnn_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)


def rpn_anchor_cfg(cfg: TwoStageConfig) -> AnchorConfig:
    return AnchorConfig(strides=cfg.strides, ratios=cfg.anchor_ratios,
                        octave_base_scale=float(cfg.anchor_scales[0]),
                        scales_per_octave=len(cfg.anchor_scales))


def _rpn_flat(rpn_outs: Maps, cfg: TwoStageConfig):
    """(anchors (N, 4), scores (B, N), deltas (B, N, 4)), f32."""
    scores = _flatten(rpn_outs["rpn_cls"], 1)[..., 0]
    deltas = _flatten(rpn_outs["rpn_reg"], 4)
    anchors, _ = grid_anchors_on(rpn_anchor_cfg(cfg), cfg.image_shape,
                                 scores.device)
    return anchors, scores, deltas


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, D), idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def rpn_proposals(rpn_outs: Maps, img_shapes: torch.Tensor,
                  cfg: TwoStageConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RPN maps -> each image's fixed-count proposals: the top
    ``nms_pre`` scores decoded, clipped to the image and NMS-ed. Returns
    (proposals (B, P, 4), valid (B, P)); invalid rows are zeros."""
    anchors, scores, deltas = _rpn_flat(rpn_outs, cfg)
    k = min(cfg.nms_pre, scores.shape[1])
    top_s, top_i = _top_stable(scores, k)
    boxes = delta2bbox(anchors[top_i], _rows(deltas, top_i),
                       max_shape=img_shapes)
    keep_idx, _, keep_v = nms(boxes, torch.sigmoid(top_s),
                              cfg.proposal_nms_iou, cfg.proposal_count)
    props = _rows(boxes, keep_idx) * keep_v[..., None].to(boxes.dtype)
    return props, keep_v


def rois_with_batch_idx(proposals: torch.Tensor) -> torch.Tensor:
    """(B, P, 4) -> (B*P, 5) [batch_idx, x1, y1, x2, y2]."""
    B, P, _ = proposals.shape
    bi = torch.arange(B, dtype=proposals.dtype,
                      device=proposals.device).repeat_interleave(P)
    return torch.cat([bi[:, None], proposals.reshape(B * P, 4)], dim=1)


def sample_rois(proposals: torch.Tensor, prop_valid: torch.Tensor,
                gt_bboxes: torch.Tensor, gt_valid: torch.Tensor,
                gt_labels: torch.Tensor, cfg: TwoStageConfig, pos_iou=None):
    """Fixed-quota RoI sampling and targets: the GT boxes join the
    proposals as candidates (the reference ``add_gt_as_proposals``);
    ``rcnn_num_samples * rcnn_pos_fraction`` slots take the highest-IoU
    positives, the rest the highest-IoU negatives. ``pos_iou`` may be a
    scalar tensor (Dynamic R-CNN's threshold).

    Returns (rois (B, S, 4), labels (B, S) with ``num_classes`` the
    background, deltas (B, S, 4), pos (B, S), valid (B, S))."""
    S = cfg.rcnn_num_samples
    n_pos_max = int(S * cfg.rcnn_pos_fraction)
    if pos_iou is None:
        pos_iou = cfg.rcnn_pos_iou
    gts = gt_bboxes.to(proposals.dtype)
    cand = torch.cat([gts, proposals], dim=1)                 # (B, P', 4)
    cvalid = torch.cat([gt_valid, prop_valid], dim=1)
    ious = box_iou(cand, gts)                                 # (B, P', M)
    ious = torch.where(cvalid[:, :, None] & gt_valid[:, None, :], ious,
                       torch.full_like(ious, -1.0))
    max_iou = ious.amax(dim=2)
    arg = ious.argmax(dim=2)                  # the first of equal maxima
    is_pos = (max_iou >= pos_iou) & cvalid
    is_neg = (max_iou < pos_iou) & (max_iou >= 0) & cvalid
    ninf = torch.full_like(max_iou, float("-inf"))
    _, pos_idx = _top_stable(torch.where(is_pos, max_iou, ninf), n_pos_max)
    _, neg_idx = _top_stable(torch.where(is_neg, max_iou, ninf),
                             S - n_pos_max)
    pos_ok = torch.gather(is_pos, 1, pos_idx)
    neg_ok = torch.gather(is_neg, 1, neg_idx)
    sel = torch.cat([pos_idx, neg_idx], dim=1)
    sel_pos = torch.cat([pos_ok, torch.zeros_like(neg_ok)], dim=1)
    sel_ok = torch.cat([pos_ok, neg_ok], dim=1)
    rois = _rows(cand, sel)
    sel_arg = torch.gather(arg, 1, sel)
    tgt_gt = _rows(gts, sel_arg)
    labels = torch.where(sel_pos, torch.gather(gt_labels.long(), 1, sel_arg),
                         torch.full_like(sel_arg, cfg.num_classes))
    safe_tgt = torch.where(sel_pos[..., None], tgt_gt, rois)
    # padded zero rois would take log(0) in the deltas
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=rois.dtype,
                        device=rois.device)
    safe_rois = torch.where(sel_ok[..., None], rois, unit)
    deltas = bbox2delta(safe_rois,
                        torch.where(sel_pos[..., None], safe_tgt, safe_rois),
                        stds=cfg.rcnn_stds)
    return rois, labels, deltas, sel_pos, sel_ok


def rpn_loss(rpn_outs: Maps, batch: Batch, cfg: TwoStageConfig):
    """The RPN's BCE objectness and L1 delta losses over every positive
    and the highest-scoring negatives, ``rpn_num_samples`` in all, each
    normalised by the image's sample count (the reference's
    ``avg_factor``), then averaged over the images. The RPN assigner's
    ``min_pos_iou`` is ``rpn_neg_iou``, as in the JAX package."""
    acfg = rpn_anchor_cfg(cfg)
    anchors, scores, deltas = _rpn_flat(rpn_outs, cfg)
    B, N = scores.shape
    gts = batch["gt_bboxes"]
    pvalid = anchor_valid_flags(acfg, cfg.image_shape, batch["img_shape"])
    res = max_iou_assign(anchors.expand(B, -1, -1), pvalid, gts,
                         batch["gt_valid"], pos_iou_thr=cfg.rpn_pos_iou,
                         neg_iou_thr=cfg.rpn_neg_iou,
                         min_pos_iou=cfg.rpn_neg_iou)
    pos = res.gt_idx >= 0
    posf = pos.float()
    neg = ~pos & pvalid & ~res.ignore
    neg_quota = torch.clamp(cfg.rpn_num_samples - posf.sum(1), min=1.0)
    thr_k = min(cfg.rpn_num_samples, N)
    # the quota's score among the negatives: values only
    top_neg = torch.topk(torch.where(neg, scores, torch.full_like(
        scores, float("-inf"))), thr_k, dim=1).values
    kth = torch.gather(top_neg, 1, (neg_quota.long() - 1).clamp(
        0, thr_k - 1)[:, None])
    neg_sel = neg & (scores >= kth)
    wc = posf + neg_sel.float()
    n_samp = torch.clamp(wc.sum(1), min=1.0)
    tgt = torch.where(pos[..., None],
                      _rows(gts.float(), res.gt_idx.long().clamp(min=0)),
                      anchors.expand(B, -1, -1))
    loss_cls = (bce_with_logits(scores, posf) * wc).sum(1) / n_samp
    d = bbox2delta(anchors, tgt)
    loss_reg = ((deltas - d).abs().sum(-1) * posf).sum(1) / n_samp
    return loss_cls.mean(), loss_reg.mean()


def rcnn_loss(cls_logits: torch.Tensor, reg: torch.Tensor,
              labels: torch.Tensor, deltas: torch.Tensor, pos: torch.Tensor,
              valid: torch.Tensor, cfg: TwoStageConfig, smoothl1_beta=1.0):
    """Softmax CE over the sampled RoIs and SmoothL1 (``smoothl1_beta``,
    a number or a scalar tensor) of the label's deltas over the
    positives, both over the count of sampled RoIs (the reference's
    ``avg_factor``). cls_logits (B*S, C+1), reg (B*S, 4C or 4)."""
    BS = cls_logits.shape[0]
    labels_f = labels.reshape(-1)
    valid_f = valid.reshape(-1).float()
    pos_f = pos.reshape(-1).float()
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    ce = -torch.gather(logp, 1, labels_f[:, None])[:, 0]
    n_valid = torch.clamp(valid_f.sum(), min=1.0)
    loss_cls = (ce * valid_f).sum() / n_valid
    n_reg = reg.shape[-1] // 4
    reg = reg.reshape(BS, n_reg, 4).float()
    cls_idx = labels_f.clamp(max=n_reg - 1).clamp(min=0)
    reg_sel = torch.gather(reg, 1, cls_idx[:, None, None].expand(-1, 1, 4)
                           )[:, 0]
    diff = (reg_sel - deltas.reshape(BS, 4)).abs()
    b = smoothl1_beta
    sl1 = torch.where(diff < b, 0.5 * diff * diff / b, diff - 0.5 * b).sum(-1)
    loss_reg = (sl1 * pos_f).sum() / n_valid
    return loss_cls, loss_reg


def _detached(maps: Maps) -> Maps:
    return {k: [m.detach() for m in v] for k, v in maps.items()}


def _stages(model, batch: Batch, cfg: TwoStageConfig, sampling,
            pos_iou=None, smoothl1_beta=1.0):
    """backbone + neck once, the RPN loss, proposals from the detached
    RPN maps, sampling, the RoI head and its loss. Returns (losses,
    proposals, their validity, sampled deltas, positives)."""
    feats = model.extract(batch["image"], sampling)
    rpn_outs = model.rpn(feats)
    l_rpn_cls, l_rpn_reg = rpn_loss(rpn_outs, batch, cfg)
    props, pvalid = rpn_proposals(_detached(rpn_outs), batch["img_shape"],
                                  cfg)
    rois, labels, deltas, pos, valid = sample_rois(
        props, pvalid, batch["gt_bboxes"], batch["gt_valid"],
        batch["gt_labels"], cfg, pos_iou=pos_iou)
    cls_logits, reg = model.roi_forward(feats, rois_with_batch_idx(rois))
    l_cls, l_reg = rcnn_loss(cls_logits, reg, labels, deltas, pos, valid,
                             cfg, smoothl1_beta=smoothl1_beta)
    losses = {"loss_rpn_cls": l_rpn_cls, "loss_rpn_bbox": l_rpn_reg,
              "loss_cls": l_cls, "loss_bbox": l_reg}
    return losses, props, pvalid, deltas, pos


def two_stage_loss(model, batch: Batch, cfg: TwoStageConfig,
                   sampling: Mapping[str, str] = TRAIN_SAMPLING):
    """Faster R-CNN's training loss: (total, {loss_rpn_cls,
    loss_rpn_bbox, loss_cls, loss_bbox})."""
    losses, *_ = _stages(model, batch, cfg, sampling)
    return sum(losses.values()), losses


def dynamic_rcnn_loss(model, batch: Batch, cfg: TwoStageConfig, iou_thr,
                      beta, iou_topk: int = 75, beta_topk: int = 10,
                      sampling: Mapping[str, str] = TRAIN_SAMPLING):
    """Dynamic R-CNN's training loss (reference ``dynamic_roi_head.py:
    12-152``): Faster R-CNN's with the RoI positive threshold ``iou_thr``
    and the SmoothL1 ``beta`` given per step, and two statistics for
    :class:`DynamicRCNNSchedule`, without gradient:

    * ``stat_iou``: the mean over images of the ``iou_topk``-th largest
      proposal-to-GT IoU;
    * ``stat_beta``: the ``beta_topk * B``-th smallest mean(|dx|, |dy|) of
      the positives' targets; with fewer positives the smallest of them
      (JAX's expression), ``inf`` with none."""
    losses, props, pvalid, deltas, pos = _stages(
        model, batch, cfg, sampling, pos_iou=iou_thr, smoothl1_beta=beta)
    with torch.no_grad():
        gts, gvalid = batch["gt_bboxes"], batch["gt_valid"]
        ious = box_iou(props, gts.to(props.dtype))
        ious = torch.where(pvalid[:, :, None] & gvalid[:, None, :], ious,
                           torch.zeros_like(ious))
        mx = ious.amax(dim=2)
        k = min(iou_topk, mx.shape[1])
        stat_iou = torch.topk(mx, k, dim=1).values[:, k - 1].mean()
        err = deltas.reshape(-1, 4)[:, :2].abs().mean(-1)
        posf = pos.reshape(-1)
        k = beta_topk * props.shape[0]
        neg_err = torch.where(posf, -err, torch.full_like(err,
                                                          float("-inf")))
        kth = -torch.topk(neg_err, k).values[k - 1]
        npos = posf.sum()
        smallest = -neg_err.max()
        stat_beta = torch.where(npos >= k, kth, torch.where(
            npos > 0, smallest, torch.full_like(kth, float("inf"))))
    total = (losses["loss_rpn_cls"] + losses["loss_rpn_bbox"]
             + losses["loss_cls"] + losses["loss_bbox"])
    return total, {**losses, "stat_iou": stat_iou, "stat_beta": stat_beta}


class DynamicRCNNSchedule:
    """Dynamic R-CNN's host-side controller (reference
    ``dynamic_roi_head.py update_hyperparameters:133-152``): every
    ``update_iter_interval`` steps, iou_thr <- max(initial, mean of the
    interval's ``stat_iou``) and beta <- min(initial, median of its finite
    ``stat_beta``)."""

    def __init__(self, initial_iou: float = 0.4, initial_beta: float = 1.0,
                 update_iter_interval: int = 100):
        self.initial_iou = initial_iou
        self.initial_beta = initial_beta
        self.interval = update_iter_interval
        self.iou_thr = initial_iou
        self.beta = initial_beta
        self.iou_history: List[float] = []
        self.beta_history: List[float] = []

    def update(self, stat_iou: float, stat_beta: float):
        self.iou_history.append(float(stat_iou))
        if np.isfinite(stat_beta):
            self.beta_history.append(float(stat_beta))
        if len(self.iou_history) % self.interval == 0:
            self.iou_thr = max(self.initial_iou,
                               float(np.mean(self.iou_history)))
            if self.beta_history:
                self.beta = min(self.initial_beta,
                                float(np.median(self.beta_history)))
            self.iou_history = []
            self.beta_history = []
        return self.iou_thr, self.beta


def _rcnn_detections(props: torch.Tensor, pvalid: torch.Tensor,
                     cls_logits: torch.Tensor, reg: torch.Tensor,
                     img_shapes: torch.Tensor, scale_factors: torch.Tensor,
                     cfg: TwoStageConfig, tcfg: TestConfig,
                     rescale: bool) -> Detections:
    """Per-class delta decode of each proposal, the scores over
    ``score_thr``, the top ``nms_pre`` and class-wise NMS."""
    B, P, _ = props.shape
    C = cfg.num_classes
    probs = torch.softmax(cls_logits.reshape(B, P, C + 1).float(),
                          dim=-1)[..., :C]
    probs = probs * pvalid[..., None].to(probs.dtype)
    boxes = delta2bbox(props[:, :, None, :].expand(B, P, C, 4),
                       reg.reshape(B, P, C, 4).float(), stds=cfg.rcnn_stds,
                       max_shape=img_shapes[:, None, :])
    if rescale:
        boxes = boxes / scale_factors[:, None, None, :]
    flat_boxes = boxes.reshape(B, P * C, 4)
    flat_scores = probs.reshape(B, P * C)
    flat_labels = torch.arange(C, device=props.device).repeat(P).expand(
        B, -1)
    cand = torch.where(flat_scores > tcfg.score_thr, flat_scores,
                       torch.full_like(flat_scores, NEG_INF))
    k = min(tcfg.nms_pre, P * C)
    top_s, top_i = _top_stable(cand, k)
    top_boxes = _rows(flat_boxes, top_i)
    top_labels = torch.gather(flat_labels, 1, top_i)
    keep_idx, keep_s, keep_v = batched_nms(top_boxes, top_s, top_labels,
                                           tcfg.nms_iou, tcfg.max_per_img)
    z = keep_v[..., None].to(boxes.dtype)
    return Detections(
        _rows(top_boxes, keep_idx) * z,
        torch.where(keep_v, keep_s, torch.zeros_like(keep_s)),
        (torch.gather(top_labels, 1, keep_idx) * keep_v).to(torch.int32),
        torch.zeros(B, tcfg.max_per_img, 8, dtype=boxes.dtype,
                    device=boxes.device), keep_v)


def two_stage_decode(model, images: torch.Tensor, img_shapes: torch.Tensor,
                     scale_factors: torch.Tensor, cfg: TwoStageConfig,
                     tcfg: TestConfig, rescale: bool = True,
                     sampling: Mapping[str, str] = INFERENCE_SAMPLING
                     ) -> Detections:
    """Faster R-CNN's ``simple_test``: proposals -> RoI head -> per-class
    decode and NMS; zero landmarks."""
    feats = model.extract(images, sampling)
    props, pvalid = rpn_proposals(model.rpn(feats), img_shapes, cfg)
    cls_logits, reg = model.roi_forward(feats, rois_with_batch_idx(props))
    return _rcnn_detections(props, pvalid, cls_logits, reg, img_shapes,
                            scale_factors, cfg, tcfg, rescale)


def fast_rcnn_decode(model, images: torch.Tensor, proposals: torch.Tensor,
                     prop_valid: torch.Tensor, img_shapes: torch.Tensor,
                     scale_factors: torch.Tensor, cfg: TwoStageConfig,
                     tcfg: TestConfig, rescale: bool = True,
                     sampling: Mapping[str, str] = INFERENCE_SAMPLING
                     ) -> Detections:
    """Fast R-CNN's ``simple_test`` (reference ``fast_rcnn.py``):
    proposals (B, P, 4) given from outside -> RoI head -> per-class decode
    and NMS."""
    feats = model.extract(images, sampling)
    cls_logits, reg = model.roi_forward(feats,
                                        rois_with_batch_idx(proposals))
    return _rcnn_detections(proposals, prop_valid, cls_logits, reg,
                            img_shapes, scale_factors, cfg, tcfg, rescale)
