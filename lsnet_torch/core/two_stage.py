"""Two-stage training and inference logic (counterpart of
``lsnet_tpu/core/two_stage.py``: Faster R-CNN, Double-Head, Dynamic R-CNN,
Fast R-CNN, Mask R-CNN, Mask Scoring R-CNN, PointRend, Cascade R-CNN
(DetectoRS too), Grid R-CNN and HTC).

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
``FastRCNNDetector``; a mask detector of ``models.heads.two_stage`` for
the mask branch's) and call its ``extract`` / ``rpn`` / ``roi_forward``
(``mask_forward``, ``maskiou_forward``, ``point_forward``) in turn;
``sampling`` is the backbone's DCN sampling, as everywhere in the port.
The RPN maps are detached before the proposals.

The mask branch computes each piece once. JAX's ``mask_scoring_rcnn_loss``
and ``point_rend_loss`` call ``mask_rcnn_loss`` and then run the backbone,
the RPN, the proposals, the sampling and the mask head again, and its mask
decodes run the backbone two or three times; every step is deterministic
and the backbone's BatchNorm is frozen, so the second run gives the same
numbers, and the gradient of the sum over both uses of one forward is the
same as JAX's. Mask targets are rasterised from the segm pipeline's
36-point GT contours (``gt_polygons``), on the device. So do Grid R-CNN's
loss and decode (JAX runs the backbone again for the grid head) and the
HTC decode's mask heads (JAX extracts each stage's RoI features again).

The cascade (Cascade R-CNN, DetectoRS and HTC) samples each of its three
stages from the one before's boxes: stage s samples at
``CASCADE_IOUS[s]`` and encodes at ``CASCADE_STDS[s]``, its terms weigh
``CASCADE_WEIGHTS[s]``, and its detached class-agnostic deltas, decoded
and clipped to the canvas, are the next stage's proposals, all valid
where the stage's samples were. These three are fixed, as in the JAX
package; they equal the shipped files' values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.flat_deform import INFERENCE_SAMPLING, TRAIN_SAMPLING
from ..parallel import (all_reduce_sum, batch_mean, gather_rows,
                        global_count, world_size)
from ..ops.nms import NEG_INF, _top_stable, batched_nms, box_iou, nms
from ..models.losses.common import bce_with_logits
from .anchors import (AnchorConfig, _clip_boxes, anchor_valid_flags,
                      bbox2delta, delta2bbox, grid_anchors_on)
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
    # every RoI but a positive encodes the unit box against itself (zero
    # deltas): a padded zero RoI, or a proposal clipped to zero height at
    # the image's edge and sampled as a negative, would take log(0 / 0).
    # JAX keeps the valid negatives' own boxes, so such a negative makes
    # its loss_bbox NaN (ROADMAP Queue 3); a box of positive size gives
    # the same zeros either way
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0], dtype=rois.dtype,
                        device=rois.device)
    safe_rois = torch.where(sel_pos[..., None], rois, unit)
    deltas = bbox2delta(safe_rois,
                        torch.where(sel_pos[..., None], safe_tgt, safe_rois),
                        stds=cfg.rcnn_stds)
    return rois, labels, deltas, sel_pos, sel_ok


def rpn_loss(rpn_outs: Maps, batch: Batch, cfg: TwoStageConfig):
    """The RPN's BCE objectness and L1 delta losses over every positive
    and the highest-scoring negatives, ``rpn_num_samples`` in all, each
    normalised by the image's sample count (the reference's
    ``avg_factor``), then averaged over the images (the global batch's
    under W ranks: ``parallel.batch_mean``). The RPN assigner's
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
    return batch_mean(loss_cls), batch_mean(loss_reg)


def rcnn_loss(cls_logits: torch.Tensor, reg: torch.Tensor,
              labels: torch.Tensor, deltas: torch.Tensor, pos: torch.Tensor,
              valid: torch.Tensor, cfg: TwoStageConfig, smoothl1_beta=1.0):
    """Softmax CE over the sampled RoIs and SmoothL1 (``smoothl1_beta``,
    a number or a scalar tensor) of the label's deltas over the
    positives, both over the count of sampled RoIs (the reference's
    ``avg_factor``; the global batch's under W ranks). cls_logits
    (B*S, C+1), reg (B*S, 4C or 4)."""
    BS = cls_logits.shape[0]
    labels_f = labels.reshape(-1)
    valid_f = valid.reshape(-1).float()
    pos_f = pos.reshape(-1).float()
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    ce = -torch.gather(logp, 1, labels_f[:, None])[:, 0]
    n_valid = torch.clamp(global_count(valid_f.sum()), min=1.0)
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


def _num_pos(posf: torch.Tensor) -> torch.Tensor:
    """The count of positive RoIs a loss divides by, at least 1: the
    global batch's under W ranks."""
    return torch.clamp(global_count(posf.sum()), min=1.0)


def _detached(maps: Maps) -> Maps:
    return {k: [m.detach() for m in v] for k, v in maps.items()}


class Stages(NamedTuple):
    """What the first stages leave for the RoI heads: the neck's levels,
    the proposals and the sampled RoIs with their targets."""
    feats: List[torch.Tensor]     # the neck's NCHW levels
    props: torch.Tensor           # (B, P, 4) proposals
    pvalid: torch.Tensor          # (B, P)
    rois: torch.Tensor            # (B, S, 4) sampled RoIs
    rois5: torch.Tensor           # (B*S, 5) with their image index
    labels: torch.Tensor          # (B, S), num_classes the background
    deltas: torch.Tensor          # (B, S, 4)
    pos: torch.Tensor             # (B, S)
    valid: torch.Tensor           # (B, S)


def rpn_stage(model, batch: Batch, cfg: TwoStageConfig, sampling):
    """backbone + neck once, the RPN loss and proposals from the detached
    RPN maps: ({loss_rpn_cls, loss_rpn_bbox}, the neck's levels,
    proposals (B, P, 4), valid (B, P))."""
    feats = model.extract(batch["image"], sampling)
    rpn_outs = model.rpn(feats)
    l_rpn_cls, l_rpn_reg = rpn_loss(rpn_outs, batch, cfg)
    props, pvalid = rpn_proposals(_detached(rpn_outs), batch["img_shape"],
                                  cfg)
    return ({"loss_rpn_cls": l_rpn_cls, "loss_rpn_bbox": l_rpn_reg}, feats,
            props, pvalid)


def sample_stage(feats: List[torch.Tensor], props: torch.Tensor,
                 pvalid: torch.Tensor, batch: Batch, cfg: TwoStageConfig,
                 pos_iou=None) -> Stages:
    """The RoI sampling of ``props`` as a :class:`Stages`."""
    rois, labels, deltas, pos, valid = sample_rois(
        props, pvalid, batch["gt_bboxes"], batch["gt_valid"],
        batch["gt_labels"], cfg, pos_iou=pos_iou)
    return Stages(feats, props, pvalid, rois, rois_with_batch_idx(rois),
                  labels, deltas, pos, valid)


def sample_stages(model, batch: Batch, cfg: TwoStageConfig, sampling,
                  pos_iou=None):
    """backbone + neck once, the RPN loss, proposals from the detached
    RPN maps and the RoI sampling. Returns ({loss_rpn_cls,
    loss_rpn_bbox}, :class:`Stages`)."""
    losses, feats, props, pvalid = rpn_stage(model, batch, cfg, sampling)
    return losses, sample_stage(feats, props, pvalid, batch, cfg, pos_iou)


def rcnn_losses(model, st: Stages, cfg: TwoStageConfig, smoothl1_beta=1.0
                ) -> Dict[str, torch.Tensor]:
    """The RoI head on the sampled RoIs and its {loss_cls, loss_bbox}."""
    cls_logits, reg = model.roi_forward(st.feats, st.rois5)
    l_cls, l_reg = rcnn_loss(cls_logits, reg, st.labels, st.deltas, st.pos,
                             st.valid, cfg, smoothl1_beta=smoothl1_beta)
    return {"loss_cls": l_cls, "loss_bbox": l_reg}


def _stages(model, batch: Batch, cfg: TwoStageConfig, sampling,
            pos_iou=None, smoothl1_beta=1.0):
    """Faster R-CNN's four terms and the :class:`Stages` they came from."""
    losses, st = sample_stages(model, batch, cfg, sampling, pos_iou)
    losses.update(rcnn_losses(model, st, cfg, smoothl1_beta))
    return losses, st


def two_stage_loss(model, batch: Batch, cfg: TwoStageConfig,
                   sampling: Mapping[str, str] = TRAIN_SAMPLING):
    """Faster R-CNN's training loss: (total, {loss_rpn_cls,
    loss_rpn_bbox, loss_cls, loss_bbox})."""
    losses, _ = _stages(model, batch, cfg, sampling)
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
      (JAX's expression), ``inf`` with none.

    Both are the global batch's under W ranks."""
    losses, st = _stages(model, batch, cfg, sampling, pos_iou=iou_thr,
                         smoothl1_beta=beta)
    props, pvalid, deltas, pos = st.props, st.pvalid, st.deltas, st.pos
    with torch.no_grad():
        gts, gvalid = batch["gt_bboxes"], batch["gt_valid"]
        ious = box_iou(props, gts.to(props.dtype))
        ious = torch.where(pvalid[:, :, None] & gvalid[:, None, :], ious,
                           torch.zeros_like(ious))
        mx = ious.amax(dim=2)
        k = min(iou_topk, mx.shape[1])
        stat_iou = all_reduce_sum(batch_mean(
            torch.topk(mx, k, dim=1).values[:, k - 1]))
        # over the global batch's positives under W ranks
        err = gather_rows(deltas.reshape(-1, 4)[:, :2].abs().mean(-1))
        posf = gather_rows(pos.reshape(-1))
        k = beta_topk * props.shape[0] * world_size()
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


def _nms_detections(flat_boxes: torch.Tensor, flat_scores: torch.Tensor,
                    flat_labels: torch.Tensor, tcfg: TestConfig
                    ) -> Detections:
    """(B, N) candidates: the scores over ``score_thr``, the top
    ``nms_pre`` and class-wise NMS; zero landmarks."""
    cand = torch.where(flat_scores > tcfg.score_thr, flat_scores,
                       torch.full_like(flat_scores, NEG_INF))
    k = min(tcfg.nms_pre, cand.shape[1])
    top_s, top_i = _top_stable(cand, k)
    top_boxes = _rows(flat_boxes, top_i)
    top_labels = torch.gather(flat_labels, 1, top_i)
    keep_idx, keep_s, keep_v = batched_nms(top_boxes, top_s, top_labels,
                                           tcfg.nms_iou, tcfg.max_per_img)
    z = keep_v[..., None].to(flat_boxes.dtype)
    B = flat_boxes.shape[0]
    return Detections(
        _rows(top_boxes, keep_idx) * z,
        torch.where(keep_v, keep_s, torch.zeros_like(keep_s)),
        (torch.gather(top_labels, 1, keep_idx) * keep_v).to(torch.int32),
        torch.zeros(B, tcfg.max_per_img, 8, dtype=flat_boxes.dtype,
                    device=flat_boxes.device), keep_v)


def _class_labels(B: int, P: int, C: int, device) -> torch.Tensor:
    """(B, P*C): class c of candidate p at p*C + c."""
    return torch.arange(C, device=device).repeat(P).expand(B, -1)


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
    return _nms_detections(boxes.reshape(B, P * C, 4),
                           probs.reshape(B, P * C),
                           _class_labels(B, P, C, props.device), tcfg)


def _detect(model, images, img_shapes, scale_factors, cfg, tcfg, rescale,
            sampling) -> Tuple[List[torch.Tensor], Detections]:
    """(the neck's levels, :func:`two_stage_decode`'s detections)."""
    feats = model.extract(images, sampling)
    props, pvalid = rpn_proposals(model.rpn(feats), img_shapes, cfg)
    cls_logits, reg = model.roi_forward(feats, rois_with_batch_idx(props))
    return feats, _rcnn_detections(props, pvalid, cls_logits, reg,
                                   img_shapes, scale_factors, cfg, tcfg,
                                   rescale)


def two_stage_decode(model, images: torch.Tensor, img_shapes: torch.Tensor,
                     scale_factors: torch.Tensor, cfg: TwoStageConfig,
                     tcfg: TestConfig, rescale: bool = True,
                     sampling: Mapping[str, str] = INFERENCE_SAMPLING
                     ) -> Detections:
    """Faster R-CNN's ``simple_test``: proposals -> RoI head -> per-class
    decode and NMS; zero landmarks."""
    return _detect(model, images, img_shapes, scale_factors, cfg, tcfg,
                   rescale, sampling)[1]


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


# --------------------------------------------------------------- Mask R-CNN

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as XLA fuses it (the f64 product of
    two f32 is exact)."""
    return (a.double() * b.double() + c.double()).float()


def rasterize_polygon_in_roi(polys: torch.Tensor, rois: torch.Tensor,
                             out_size: int = 28) -> torch.Tensor:
    """GT contours -> each RoI's binary mask target, on the device: the
    crossing number (even-odd) of a ray to +x from each cell centre of
    the RoI's ``out_size`` x ``out_size`` grid. polys (S, nv*2)
    xy-interleaved closed contours; rois (S, 4) -> (S, out, out) {0, 1}
    f32. The edges are taken one at a time (1 / nv of the memory of JAX's
    (S, out, out, nv) form), with JAX's comparisons, and its products and
    sums each rounded once as XLA's fused multiply-adds round them: a GT
    RoI's cell centres lie exactly on a triangle's diagonal, where a
    second rounding flips cells."""
    nv = polys.shape[1] // 2
    px, py = polys[:, 0::2], polys[:, 1::2]
    w = torch.clamp(rois[:, 2] - rois[:, 0], min=1e-3)
    h = torch.clamp(rois[:, 3] - rois[:, 1], min=1e-3)
    # XLA divides by the constant as a product with its f32 reciprocal
    frac = (torch.arange(out_size, dtype=torch.float32, device=rois.device)
            + 0.5) * torch.tensor(1.0 / out_size, dtype=torch.float32)
    gx = _fma(frac[None, :], w[:, None], rois[:, 0, None])    # (S, out)
    gy = _fma(frac[None, :], h[:, None], rois[:, 1, None])
    crossings = torch.zeros(rois.shape[0], out_size, out_size,
                            dtype=torch.int32, device=rois.device)
    for k in range(nv):
        x1, y1 = px[:, k, None], py[:, k, None]
        x2, y2 = px[:, (k + 1) % nv, None], py[:, (k + 1) % nv, None]
        # an edge's crossing of each row depends on the row alone
        cond = (y1 <= gy) != (y2 <= gy)                       # (S, out_y)
        dy = y2 - y1
        t = (gy - y1) / torch.where(dy.abs() < 1e-9,
                                    torch.full_like(dy, 1e-9), dy)
        xint = _fma(t, x2 - x1, x1)
        crossings += (cond[:, :, None]
                      & (xint[:, :, None] > gx[:, None, :])).int()
    return (crossings % 2 == 1).float()


def _label_maps(mask_logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """Each RoI's map of its label (clamped into the classes, as JAX's
    ``jnp.clip``; background RoIs take the last class): (S, H, W)."""
    C = mask_logits.shape[-1]
    idx = labels.long().clamp(0, C - 1)
    return torch.gather(mask_logits, 3, idx[:, None, None, None].expand(
        -1, *mask_logits.shape[1:3], 1))[..., 0]


def _mask_targets(rois: torch.Tensor, gt_polys: torch.Tensor,
                  gt_idx: torch.Tensor, size: int) -> torch.Tensor:
    """The rasterised GT of each RoI's ``gt_idx`` (a padded slot and a
    negative RoI's -1 read a row too, as JAX's ``jnp.maximum(gt_idx, 0)``;
    the positives alone weigh in the losses)."""
    return rasterize_polygon_in_roi(gt_polys[gt_idx.clamp(min=0)].float(),
                                    rois.float(), size)


def mask_loss(mask_logits: torch.Tensor, rois: torch.Tensor,
              labels: torch.Tensor, pos: torch.Tensor,
              gt_polys: torch.Tensor, gt_idx: torch.Tensor,
              cfg: TwoStageConfig,
              targets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each positive RoI's mean BCE of its label's mask logits against its
    rasterised GT, over the positives (at least 1). mask_logits (S, 28,
    28, C); rois (S, 4); labels, pos, gt_idx (S,); gt_polys (M, nv*2);
    ``targets`` the RoIs' rasterised GT where the caller has them."""
    if targets is None:
        targets = _mask_targets(rois, gt_polys, gt_idx, mask_logits.shape[1])
    sel = _label_maps(mask_logits, labels).float()
    posf = pos.float()
    bce = bce_with_logits(sel, targets).mean(dim=(1, 2))
    return (bce * posf).sum() / _num_pos(posf)


def _gt_of(rois: torch.Tensor, gts: torch.Tensor, gvalid: torch.Tensor
           ) -> torch.Tensor:
    """Each sampled RoI's GT, the argmax of its IoU over the valid GTs
    (the first of equal IoUs, as ``jnp.argmax``): (B, S)."""
    ious = box_iou(rois, gts.to(rois.dtype))
    return torch.where(gvalid[:, None, :], ious,
                       torch.full_like(ious, -1.0)).argmax(dim=2)


class MaskStage(NamedTuple):
    """The mask branch on the sampled RoIs of one :class:`Stages`."""
    roi_feats: torch.Tensor       # (B*S, 14, 14, C) NHWC
    logits: torch.Tensor          # (B*S, 28, 28, num_classes)
    rois: torch.Tensor            # (B*S, 4)
    labels: torch.Tensor          # (B*S,)
    pos: torch.Tensor             # (B*S,)
    polys: torch.Tensor           # (B*M, nv*2) the batch's GT contours
    gt_idx: torch.Tensor          # (B*S,) rows of ``polys``
    targets: torch.Tensor         # (B*S, 28, 28) rasterised GT


def mask_stage(model, batch: Batch, st: Stages) -> MaskStage:
    """The mask head on every sampled RoI (the loss weighs the positives;
    mmdet runs the head on the positives alone, for the same loss), each
    RoI's GT contour and its 28 x 28 target."""
    B, S = st.rois.shape[:2]
    roi_feats = model.mask_roi_feats(st.feats, st.rois5)
    logits = model.mask_head(roi_feats)
    polys = batch["gt_polygons"]
    M = polys.shape[1]
    gt_idx = (_gt_of(st.rois, batch["gt_bboxes"], batch["gt_valid"])
              + torch.arange(B, device=polys.device)[:, None] * M
              ).reshape(-1)
    rois = st.rois.reshape(B * S, 4)
    flat = polys.reshape(B * M, polys.shape[-1])
    return MaskStage(roi_feats, logits, rois, st.labels.reshape(-1),
                     st.pos.reshape(-1), flat, gt_idx,
                     _mask_targets(rois, flat, gt_idx, logits.shape[1]))


def _mask_losses(model, batch: Batch, cfg: TwoStageConfig, sampling):
    """Faster R-CNN's terms and ``loss_mask``; (losses, stages, mask
    stage)."""
    losses, st = _stages(model, batch, cfg, sampling)
    ms = mask_stage(model, batch, st)
    losses["loss_mask"] = mask_loss(ms.logits, ms.rois, ms.labels, ms.pos,
                                    ms.polys, ms.gt_idx, cfg, ms.targets)
    return losses, st, ms


def mask_rcnn_loss(model, batch: Batch, cfg: TwoStageConfig,
                   sampling: Mapping[str, str] = TRAIN_SAMPLING):
    """Mask R-CNN's training loss: Faster R-CNN's terms and
    ``loss_mask``; the batch carries the segm pipeline's
    ``gt_polygons``."""
    losses, _, _ = _mask_losses(model, batch, cfg, sampling)
    return sum(losses.values()), losses


class MaskOutputs(NamedTuple):
    """The mask branch on a decode's detections."""
    rois: torch.Tensor            # (B*K, 5) in network coordinates
    roi_feats: torch.Tensor       # (B*K, 14, 14, C)
    logits: torch.Tensor          # (B*K, 28, 28, num_classes)
    sel: torch.Tensor             # (B*K, 28, 28) each one's label's map


def mask_outputs(model, feats: List[torch.Tensor], det: Detections,
                 scale_factors: torch.Tensor, rescale: bool = True
                 ) -> MaskOutputs:
    """The mask head on the detections' boxes (back in network
    coordinates where the decode rescaled them)."""
    boxes = det.bboxes
    if rescale:
        boxes = boxes * scale_factors[:, None, :]
    rois = rois_with_batch_idx(boxes)
    roi_feats = model.mask_roi_feats(feats, rois)
    logits = model.mask_head(roi_feats)
    return MaskOutputs(rois, roi_feats, logits,
                       _label_maps(logits, det.labels.reshape(-1)))


def mask_probs(det: Detections, sel: torch.Tensor) -> torch.Tensor:
    """(B*K, h, w) logits -> (B, K, h, w) f32 probabilities."""
    B, K = det.bboxes.shape[:2]
    return torch.sigmoid(sel.float()).reshape(B, K, *sel.shape[1:])


def mask_rcnn_decode(model, images: torch.Tensor, img_shapes: torch.Tensor,
                     scale_factors: torch.Tensor, cfg: TwoStageConfig,
                     tcfg: TestConfig, rescale: bool = True,
                     sampling: Mapping[str, str] = INFERENCE_SAMPLING
                     ) -> Tuple[Detections, torch.Tensor]:
    """Mask R-CNN's ``simple_test``: :func:`two_stage_decode`'s
    detections and each one's 28 x 28 mask probabilities of its label, on
    its box (B, K, 28, 28) f32; the paste into the image is the host's
    (``evalkit.evaluator.paste_mask``)."""
    feats, det = _detect(model, images, img_shapes, scale_factors, cfg,
                         tcfg, rescale, sampling)
    mo = mask_outputs(model, feats, det, scale_factors, rescale)
    return det, mask_probs(det, mo.sel)


# ------------------------------------------------------ Mask Scoring R-CNN

def mask_iou_targets(mask_logits: torch.Tensor, rois: torch.Tensor,
                     labels: torch.Tensor, gt_polys: torch.Tensor,
                     gt_idx: torch.Tensor,
                     targets: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The IoU of each RoI's binarised mask (sigmoid > 0.5) of its label
    with its rasterised GT, on the 28 x 28 grid (mmdet takes area ratios):
    (S,), without gradient. ``targets`` as in :func:`mask_loss`."""
    if targets is None:
        targets = _mask_targets(rois, gt_polys, gt_idx, mask_logits.shape[1])
    with torch.no_grad():
        pred = (torch.sigmoid(_label_maps(mask_logits, labels).float())
                > 0.5).float()
        inter = (pred * targets).sum(dim=(1, 2))
        union = torch.clamp(pred.sum(dim=(1, 2)) + targets.sum(dim=(1, 2))
                            - inter, min=1.0)
        return inter / union


def _label_column(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x (N, C)'s entry at each row's label, clamped into [0, C)."""
    idx = labels.long().clamp(0, x.shape[-1] - 1)
    return torch.gather(x, 1, idx[:, None])[:, 0]


def maskiou_loss(model, st: Stages, ms: MaskStage) -> torch.Tensor:
    """``loss_mask_iou``: 0.5 x the mean over the positives of the squared
    error of the label's predicted IoU against :func:`mask_iou_targets`.
    The MaskIoU head reads the mask logits with their gradient, as in
    JAX."""
    maskiou = model.maskiou_forward(st.feats, st.rois5, ms.logits,
                                    roi_feats=ms.roi_feats)
    iou_t = mask_iou_targets(ms.logits, ms.rois, ms.labels, ms.polys,
                             ms.gt_idx, ms.targets)
    iou_p = _label_column(maskiou.float(), ms.labels)
    posf = ms.pos.float()
    return 0.5 * ((iou_p - iou_t) ** 2 * posf).sum() / _num_pos(posf)


def mask_scoring_rcnn_loss(model, batch: Batch, cfg: TwoStageConfig,
                           sampling: Mapping[str, str] = TRAIN_SAMPLING):
    """Mask Scoring R-CNN's training loss: Mask R-CNN's terms and
    ``loss_mask_iou`` (:func:`maskiou_loss`)."""
    losses, st, ms = _mask_losses(model, batch, cfg, sampling)
    losses["loss_mask_iou"] = maskiou_loss(model, st, ms)
    return sum(losses.values()), losses


def maskiou_rescore(model, feats: List[torch.Tensor], det: Detections,
                    mo: MaskOutputs) -> Detections:
    """Each valid detection's score times its label's predicted mask IoU,
    clamped to [0, 1]."""
    B, K = det.bboxes.shape[:2]
    iou = _label_column(model.maskiou_forward(
        feats, mo.rois, mo.logits, roi_feats=mo.roi_feats).float(),
        det.labels.reshape(-1)).reshape(B, K)
    scores = det.scores * iou.clamp(0.0, 1.0)
    return det._replace(scores=torch.where(det.valid, scores,
                                           torch.zeros_like(scores)))


def mask_scoring_rcnn_decode(model, images: torch.Tensor,
                             img_shapes: torch.Tensor,
                             scale_factors: torch.Tensor,
                             cfg: TwoStageConfig, tcfg: TestConfig,
                             rescale: bool = True,
                             sampling: Mapping[str, str] = INFERENCE_SAMPLING
                             ) -> Tuple[Detections, torch.Tensor]:
    """:func:`mask_rcnn_decode` with the scores rescored by the predicted
    mask IoU (:func:`maskiou_rescore`)."""
    feats, det = _detect(model, images, img_shapes, scale_factors, cfg,
                         tcfg, rescale, sampling)
    mo = mask_outputs(model, feats, det, scale_factors, rescale)
    return maskiou_rescore(model, feats, det, mo), mask_probs(det, mo.sel)


# ---------------------------------------------------------------- PointRend

def _uncertain_points(mask_logits_cls: torch.Tensor, n_points: int
                      ) -> torch.Tensor:
    """The ``n_points`` most uncertain (smallest |logit|) cells of each
    (S, H, W) map, as normalised xy cell centres (S, n, 2); equal
    uncertainties go to the lower index, as ``lax.top_k``'s (the
    deterministic stand-in for the reference's random oversampling)."""
    S, H, W = mask_logits_cls.shape
    _, idx = _top_stable(-mask_logits_cls.abs().reshape(S, H * W), n_points)
    # / W and / H as XLA's products with the f32 reciprocals
    xs = ((idx % W).float() + 0.5) * torch.tensor(1.0 / W)
    ys = ((idx // W).float() + 0.5) * torch.tensor(1.0 / H)
    return torch.stack([xs, ys], -1)


def point_loss(model, st: Stages, ms: MaskStage, num_points: int = 196,
               points: Optional[torch.Tensor] = None):
    """``loss_point``: the point head's BCE at each RoI's ``num_points``
    most uncertain cells of its label's coarse logits (or at ``points``
    where given), against the GT rasterised at 56 x 56 and sampled there,
    over the positives. Returns (loss, the points)."""
    from ..models.heads.two_stage import point_sample
    if points is None:
        points = _uncertain_points(_label_maps(ms.logits.detach(),
                                               ms.labels), num_points)
    pt_logits = model.point_forward(st.feats, st.rois5, points, ms.logits)
    pt_sel = torch.gather(pt_logits, 2, ms.labels.long().clamp(
        0, pt_logits.shape[-1] - 1)[:, None, None].expand(
            -1, points.shape[1], 1))[..., 0].float()
    grid = _mask_targets(ms.rois, ms.polys, ms.gt_idx, 56)
    tgt = point_sample(grid[..., None], points)[..., 0]
    posf = ms.pos.float()
    loss = (bce_with_logits(pt_sel, tgt).mean(-1) * posf).sum() \
        / _num_pos(posf)
    return loss, points


def point_rend_loss(model, batch: Batch, cfg: TwoStageConfig,
                    sampling: Mapping[str, str] = TRAIN_SAMPLING, *,
                    num_points: int = 196):
    """PointRend's training loss: Mask R-CNN's terms and ``loss_point``
    (:func:`point_loss`)."""
    losses, st, ms = _mask_losses(model, batch, cfg, sampling)
    losses["loss_point"] = point_loss(model, st, ms, num_points)[0]
    return sum(losses.values()), losses


def _resize_matrix(n: int, device) -> torch.Tensor:
    """(2n, n) weights of JAX's 2x bilinear upsampling on one axis
    (``jax.image.resize``: half-pixel centres, the triangle kernel, the
    weights renormalised at the edges)."""
    src = (torch.arange(2 * n, dtype=torch.float32) + 0.5) / 2 - 0.5
    w = torch.clamp(1 - (src[:, None] - torch.arange(n)[None, :]).abs(),
                    min=0.0)
    return (w / w.sum(dim=1, keepdim=True)).to(device)


def resize_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W) -> (N, 2H, 2W) as ``jax.image.resize(..., "bilinear")``
    computes it: rows, then columns, each a product with its weight
    matrix (on the CPU the same bits at 28 -> 56 and within an ulp at
    56 -> 112, where ``F.interpolate`` differs in half the cells: each
    difference can reorder near-equal uncertainties)."""
    wy = _resize_matrix(x.shape[1], x.device).to(x.dtype)
    wx = _resize_matrix(x.shape[2], x.device).to(x.dtype)
    return torch.einsum("now,pw->nop", torch.einsum("nhw,oh->now", x, wy),
                        wx)


def point_rend_subdivide(model, feats: List[torch.Tensor],
                         rois: torch.Tensor, logits: torch.Tensor,
                         labels: torch.Tensor, cur: torch.Tensor,
                         num_points: int) -> torch.Tensor:
    """One subdivision step of :func:`point_rend_decode`: the (N, H, W)
    logits of each RoI's label upsampled 2x, and the ``num_points`` most
    uncertain cells set to the point head's logits there (``logits``, the
    (N, 28, 28, C) coarse ones)."""
    labels = labels.long().clamp(0, logits.shape[-1] - 1)
    cur = resize_bilinear_2x(cur)
    N, H2, W2 = cur.shape
    pts = _uncertain_points(cur, num_points)
    pt_logits = model.point_forward(feats, rois, pts, logits)
    pt_sel = torch.gather(pt_logits, 2, labels[:, None, None].expand(
        -1, num_points, 1))[..., 0]
    xi = (pts[..., 0] * W2).long().clamp(0, W2 - 1)
    yi = (pts[..., 1] * H2).long().clamp(0, H2 - 1)
    return cur.reshape(N, H2 * W2).scatter(
        1, yi * W2 + xi, pt_sel.to(cur.dtype)).reshape(N, H2, W2)


def point_rend_decode(model, images: torch.Tensor, img_shapes: torch.Tensor,
                      scale_factors: torch.Tensor, cfg: TwoStageConfig,
                      tcfg: TestConfig, rescale: bool = True,
                      sampling: Mapping[str, str] = INFERENCE_SAMPLING,
                      subdivision_steps: int = 2, num_points: int = 784
                      ) -> Tuple[Detections, torch.Tensor]:
    """PointRend's ``simple_test``: Mask R-CNN's detections; each one's
    logits of its label refined ``subdivision_steps`` times by
    :func:`point_rend_subdivide` (the coarse logits stay the 28 x 28
    ones): (B, K, 112, 112) probabilities."""
    feats, det = _detect(model, images, img_shapes, scale_factors, cfg,
                         tcfg, rescale, sampling)
    mo = mask_outputs(model, feats, det, scale_factors, rescale)
    cur = mo.sel
    for _ in range(subdivision_steps):
        cur = point_rend_subdivide(model, feats, mo.rois, mo.logits,
                                   det.labels.reshape(-1), cur, num_points)
    return det, mask_probs(det, cur)


# ------------------------------------------------------------ Cascade R-CNN

CASCADE_IOUS = (0.5, 0.6, 0.7)
CASCADE_WEIGHTS = (1.0, 0.5, 0.25)
CASCADE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
                (0.033, 0.033, 0.067, 0.067))


def cascade_stage_cfg(cfg: TwoStageConfig, stage: int) -> TwoStageConfig:
    """``cfg`` with stage ``stage``'s positive IoU and stds."""
    return dataclasses.replace(cfg, rcnn_pos_iou=CASCADE_IOUS[stage],
                               rcnn_stds=CASCADE_STDS[stage])


def _refine(rois: torch.Tensor, reg: torch.Tensor, stage: int,
            max_shape=None) -> torch.Tensor:
    """(B, S, 4) rois moved by their (B*S, 4) class-agnostic deltas at
    stage ``stage``'s stds, clipped to ``max_shape`` where given."""
    B, S, _ = rois.shape
    return delta2bbox(rois.reshape(B * S, 4), reg.float(),
                      stds=CASCADE_STDS[stage],
                      max_shape=max_shape).reshape(B, S, 4)


def cascade_stage(model, batch: Batch, cfg: TwoStageConfig,
                  feats: List[torch.Tensor], st: Stages, s: int,
                  sem_feat: Optional[torch.Tensor] = None,
                  last: Optional[torch.Tensor] = None):
    """Stage ``s`` of a training loss (JAX ``_cascade_stage_loss`` and
    ``htc_loss``'s body) on its samples ``st``: its head's CE and SmoothL1
    (``rcnn_loss`` over all sampled RoIs, its one class-agnostic box)
    weighted ``CASCADE_WEIGHTS[s]``, then its RoIs refined by its detached
    deltas and clipped to the canvas. With ``sem_feat`` (HTC), the
    semantic embedding's RoI features join the bbox head's, and the
    stage's mask head runs on the refined boxes, after the stage before's
    features ``last``, against the GT contours of the GTs they overlap
    most, with the stage's labels and positives (JAX's interleaved order).
    Returns ({s{s}.loss_cls, s{s}.loss_bbox[, s{s}.loss_mask]} weighted,
    the refined boxes (B, S, 4), the mask head's features)."""
    scfg = cascade_stage_cfg(cfg, s)
    sem = () if sem_feat is None else (sem_feat,)
    cls_logits, reg = model.roi_forward_stage(feats, st.rois5, s, *sem)
    l_cls, l_reg = rcnn_loss(cls_logits, reg, st.labels, st.deltas, st.pos,
                             st.valid, scfg)
    w = CASCADE_WEIGHTS[s]
    terms = {f"s{s}.loss_cls": l_cls * w, f"s{s}.loss_bbox": l_reg * w}
    refined = _refine(st.rois, reg.detach(), s, cfg.image_shape)
    if sem_feat is None:
        return terms, refined, last
    mask_logits, last = model.mask_forward_stage(
        feats, rois_with_batch_idx(refined), s, sem_feat, last)
    polys = batch["gt_polygons"]
    B, M = polys.shape[:2]
    gt_idx = (_gt_of(refined, batch["gt_bboxes"], batch["gt_valid"])
              + torch.arange(B, device=polys.device)[:, None] * M)
    terms[f"s{s}.loss_mask"] = mask_loss(
        mask_logits, refined.reshape(-1, 4), st.labels.reshape(-1),
        st.pos.reshape(-1), polys.reshape(B * M, polys.shape[-1]),
        gt_idx.reshape(-1), scfg) * w
    return terms, refined, last


def cascade_stages(model, batch: Batch, cfg: TwoStageConfig,
                   feats: List[torch.Tensor], props: torch.Tensor,
                   pvalid: torch.Tensor, total: torch.Tensor,
                   sem_feat: Optional[torch.Tensor] = None):
    """The three cascade stages of a training loss (JAX
    ``cascade_rcnn_loss`` / ``htc_loss``): each samples the one before's
    refined boxes (stage 0 the proposals) at its own IoU and stds and runs
    :func:`cascade_stage`. Returns (``total`` plus the weighted terms,
    {s{s}.loss_cls, s{s}.loss_bbox[, s{s}.loss_mask]}, each stage's
    (samples, refined boxes))."""
    terms: Dict[str, torch.Tensor] = {}
    drawn: List[Tuple[Stages, torch.Tensor]] = []
    last = None
    for s in range(3):
        st = sample_stage(feats, props, pvalid, batch,
                          cascade_stage_cfg(cfg, s))
        stage_terms, props, last = cascade_stage(model, batch, cfg, feats,
                                                 st, s, sem_feat, last)
        pvalid = st.valid
        terms.update(stage_terms)
        total = total + sum(stage_terms.values())
        drawn.append((st, props))
    return total, terms, drawn


def cascade_rcnn_loss(model, batch: Batch, cfg: TwoStageConfig,
                      sampling: Mapping[str, str] = TRAIN_SAMPLING):
    """Cascade R-CNN's (and DetectoRS') training loss: (total,
    {loss_rpn_cls, loss_rpn_bbox, s0.loss_cls, s0.loss_bbox, ...,
    s2.loss_bbox}), the stages' terms weighted (:func:`cascade_stages`)."""
    losses, feats, props, pvalid = rpn_stage(model, batch, cfg, sampling)
    total, terms, _ = cascade_stages(
        model, batch, cfg, feats, props, pvalid,
        losses["loss_rpn_cls"] + losses["loss_rpn_bbox"])
    return total, {**losses, **terms}


def cascade_refine(model, feats: List[torch.Tensor], props: torch.Tensor,
                   pvalid: torch.Tensor,
                   sem_feat: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cascade's inference: the proposals moved by each stage's deltas
    in turn (unclipped), and the mean of the three stages' softmax scores,
    each on the boxes it saw (the running ensemble; mmdet scores the last
    boxes again). Returns (boxes (B, P, 4), class scores (B, P, C), zero
    where the proposal is not valid)."""
    B, P, _ = props.shape
    sem = () if sem_feat is None else (sem_feat,)
    scores = 0.0
    for s in range(3):
        cls_logits, reg = model.roi_forward_stage(
            feats, rois_with_batch_idx(props), s, *sem)
        scores = scores + torch.softmax(cls_logits.float(), dim=-1)
        props = _refine(props, reg, s)
    probs = (scores / 3.0).reshape(B, P, -1)[..., :-1]
    return props, probs * pvalid[..., None].to(probs.dtype)


def cascade_detections(boxes: torch.Tensor, probs: torch.Tensor,
                       img_shapes: torch.Tensor, scale_factors: torch.Tensor,
                       tcfg: TestConfig, rescale: bool = True) -> Detections:
    """Each box clipped to its image (and rescaled), one candidate per
    class with the box's score of it, class-wise NMS."""
    B, P, C = probs.shape
    boxes = torch.stack(_clip_boxes(*boxes.unbind(-1), img_shapes), -1)
    if rescale:
        boxes = boxes / scale_factors[:, None, :]
    return _nms_detections(
        boxes.repeat_interleave(C, dim=1), probs.reshape(B, P * C),
        _class_labels(B, P, C, boxes.device), tcfg)


def cascade_rcnn_decode(model, images: torch.Tensor,
                        img_shapes: torch.Tensor,
                        scale_factors: torch.Tensor, cfg: TwoStageConfig,
                        tcfg: TestConfig, rescale: bool = True,
                        sampling: Mapping[str, str] = INFERENCE_SAMPLING
                        ) -> Detections:
    """Cascade R-CNN's ``simple_test``: the proposals through
    :func:`cascade_refine`, then :func:`cascade_detections`."""
    feats = model.extract(images, sampling)
    props, pvalid = rpn_proposals(model.rpn(feats), img_shapes, cfg)
    boxes, probs = cascade_refine(model, feats, props, pvalid)
    return cascade_detections(boxes, probs, img_shapes, scale_factors, tcfg,
                              rescale)


# --------------------------------------------------------------- Grid R-CNN

def grid_sub_regions(grid_points: int, whole: int
                     ) -> Tuple[List[Tuple[int, int]], int]:
    """Each grid point's half-size sub-region origin (x, y) in the
    ``whole`` map, and the half size (Grid R-CNN Plus, reference
    ``grid_head.py:189-219``; JAX ``_grid_sub_regions``)."""
    gs = int(round(grid_points ** 0.5))
    half = whole // 4 * 2

    def origin(k: int) -> int:
        if k == 0:
            return 0
        if k == gs - 1:
            return half
        return max(int((k / (gs - 1) - 0.25) * whole), 0)
    return [(origin(i // gs), origin(i % gs))
            for i in range(grid_points)], half


def _expanded(boxes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(x1, y1, w, h) of each box grown by half its size a side."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return boxes[..., 0] - w / 2, boxes[..., 1] - h / 2, w, h


def grid_targets(pos_bboxes: torch.Tensor, gt_bboxes: torch.Tensor,
                 grid_points: int = 9, whole: int = 56,
                 radius: int = 1) -> torch.Tensor:
    """Each RoI's grid-point targets (JAX ``grid_targets``, reference
    ``grid_head.get_targets``): in the RoI grown by half its size a side,
    mapped onto a ``whole`` x ``whole`` map, point j of the GT box (its
    corners, edge centres and centre) lies in cell floor(.); its target is
    a disk of ``radius`` cells about that cell, in the point's half-size
    sub-region, where the grown RoI is wider and taller than sqrt(G) px.
    (S, 4), (S, 4) -> (S, half, half, G) f32."""
    gs = int(round(grid_points ** 0.5))
    regions, half = grid_sub_regions(grid_points, whole)
    x1, y1, _, _ = _expanded(pos_bboxes)
    x2 = pos_bboxes[:, 2] + (pos_bboxes[:, 2] - pos_bboxes[:, 0]) / 2
    y2 = pos_bboxes[:, 3] + (pos_bboxes[:, 3] - pos_bboxes[:, 1]) / 2
    w = torch.clamp(x2 - x1, min=1e-6)
    h = torch.clamp(y2 - y1, min=1e-6)
    big = (w > gs) & (h > gs)
    cells = torch.arange(half, device=pos_bboxes.device)
    maps = []
    for j in range(grid_points):
        fx = 1 - (j // gs) / (gs - 1)
        fy = 1 - (j % gs) / (gs - 1)
        px = fx * gt_bboxes[:, 0] + (1 - fx) * gt_bboxes[:, 2]
        py = fy * gt_bboxes[:, 1] + (1 - fy) * gt_bboxes[:, 3]
        cx = torch.floor((px - x1) / w * whole).long() - regions[j][0]
        cy = torch.floor((py - y1) / h * whole).long() - regions[j][1]
        d2 = ((cells[None, None, :] - cx[:, None, None]) ** 2
              + (cells[None, :, None] - cy[:, None, None]) ** 2)
        maps.append(((d2 <= radius ** 2) & big[:, None, None]).float())
    return torch.stack(maps, dim=-1)


def grid_loss(model, batch: Batch, st: Stages, grid_points: int = 9,
              loss_weight: float = 15.0) -> torch.Tensor:
    """``loss_grid``: the grid head on the sampled RoIs, the mean BCE of
    its fused and of its unfused heatmaps against :func:`grid_targets` of
    each RoI's GT (the one it overlaps most), each over the positives,
    summed, times ``loss_weight`` (JAX's fixed 15)."""
    B, S = st.rois.shape[:2]
    out = model.grid_forward(st.feats, st.rois5)
    gts = batch["gt_bboxes"].to(st.rois.dtype)
    gt = _rows(gts, _gt_of(st.rois, gts, batch["gt_valid"]))
    tgt = grid_targets(st.rois.reshape(B * S, 4), gt.reshape(B * S, 4),
                       grid_points)
    posf = st.pos.reshape(-1).float()
    n_pos = _num_pos(posf)
    loss = 0.0
    for key in ("fused", "unfused"):
        bce = bce_with_logits(out[key].float(), tgt).mean(dim=(1, 2, 3))
        loss = loss + (bce * posf).sum() / n_pos
    return loss * loss_weight


def grid_rcnn_loss(model, batch: Batch, cfg: TwoStageConfig,
                   sampling: Mapping[str, str] = TRAIN_SAMPLING, *,
                   grid_points: int = 9, loss_weight: float = 15.0):
    """Grid R-CNN's training loss: Faster R-CNN's four terms and
    ``loss_grid`` (:func:`grid_loss`) on the same samples."""
    losses, st = _stages(model, batch, cfg, sampling)
    total = sum(losses.values())
    losses["loss_grid"] = grid_loss(model, batch, st, grid_points,
                                    loss_weight)
    return total + losses["loss_grid"], losses


def grid_refine(model, feats: List[torch.Tensor], det: Detections,
                img_shapes: torch.Tensor, scale_factors: torch.Tensor,
                rescale: bool = True, grid_points: int = 9) -> Detections:
    """The detections' boxes (network coordinates) re-localised by the
    grid head's fused heatmaps (reference ``grid_head.get_bboxes``): each
    point's hottest cell (the first of equal maxima) in its sub-region,
    mapped into the box grown by half its size a side; each edge the
    heat-weighted mean of its sqrt(G) points' coordinate; clipped to the
    image, rescaled, zero where not valid."""
    boxes = det.bboxes
    B, K = boxes.shape[:2]
    out = model.grid_forward(feats, rois_with_batch_idx(boxes))
    hm = torch.sigmoid(out["fused"].float())
    R, hh, ww, G = hm.shape
    gs = int(round(grid_points ** 0.5))
    regions, _ = grid_sub_regions(grid_points, hh * 2)
    flat = hm.permute(0, 3, 1, 2).reshape(R, G, hh * ww)
    score, posn = flat.amax(dim=-1), flat.argmax(dim=-1)
    rx, ry = (torch.tensor([r[i] for r in regions], dtype=torch.float32,
                           device=hm.device) for i in (0, 1))
    xs = (posn % ww).float() + rx
    ys = (posn // ww).float() + ry
    x1, y1, w, h = _expanded(boxes.reshape(R, 4).float())
    whole = float(hh * 2)
    ax = (xs + 0.5) / whole * (2 * w)[:, None] + x1[:, None]
    ay = (ys + 0.5) / whole * (2 * h)[:, None] + y1[:, None]

    def vote(vals, idx):
        s = score[:, idx]
        return (vals[:, idx] * s).sum(-1) / torch.clamp(s.sum(-1), min=1e-6)
    new = torch.stack([
        vote(ax, list(range(gs))),
        vote(ay, [i * gs for i in range(gs)]),
        vote(ax, [grid_points - gs + i for i in range(gs)]),
        vote(ay, [(i + 1) * gs - 1 for i in range(gs)])],
        -1).reshape(B, K, 4)
    new = torch.stack(_clip_boxes(*new.unbind(-1), img_shapes), -1)
    if rescale:
        new = new / scale_factors[:, None, :]
    return det._replace(bboxes=new * det.valid[..., None].to(new.dtype))


def grid_rcnn_decode(model, images: torch.Tensor, img_shapes: torch.Tensor,
                     scale_factors: torch.Tensor, cfg: TwoStageConfig,
                     tcfg: TestConfig, rescale: bool = True,
                     sampling: Mapping[str, str] = INFERENCE_SAMPLING,
                     grid_points: int = 9) -> Detections:
    """Grid R-CNN's ``simple_test``: :func:`two_stage_decode`'s detections
    (not rescaled), their boxes re-localised by :func:`grid_refine`."""
    feats, det = _detect(model, images, img_shapes, scale_factors, cfg,
                         tcfg, False, sampling)
    return grid_refine(model, feats, det, img_shapes, scale_factors,
                       rescale, grid_points)


# ---------------------------------------------------------------------- HTC

def _nearest_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC x resized to (h, w) as ``jax.image.resize(method="nearest")``:
    half-pixel centres, source index floor((i + 0.5) * in / out)."""
    H, W = x.shape[1:3]
    ri = ((2 * torch.arange(h, device=x.device) + 1) * H) // (2 * h)
    ci = ((2 * torch.arange(w, device=x.device) + 1) * W) // (2 * w)
    return x.index_select(1, ri).index_select(2, ci)


def semantic_targets(batch: Batch, cfg: TwoStageConfig, h: int, w: int
                     ) -> torch.Tensor:
    """HTC's semantic class map (B, h, w) (JAX ``htc_loss``): the GT
    boxes' class maps at stride 8 (``core.cpv.make_sem_targets``),
    resized to (h, w) by nearest, each cell the first class set there,
    ``num_classes`` (the background) where none is. The reference trains
    on COCO-stuff maps, which a detection set lacks."""
    from .cpv import make_sem_targets
    sem_map, _ = make_sem_targets(batch["gt_bboxes"].float(),
                                  batch["gt_labels"], batch["gt_valid"],
                                  cfg.image_shape, cfg.num_classes)
    tgt = _nearest_resize(sem_map, h, w)
    return torch.where(tgt.amax(dim=-1) > 0, tgt.argmax(dim=-1),
                       torch.full(tgt.shape[:-1], cfg.num_classes,
                                  dtype=torch.long, device=tgt.device))


def semantic_loss(sem_logits: torch.Tensor, batch: Batch,
                  cfg: TwoStageConfig, weight: float = 0.2) -> torch.Tensor:
    """``loss_semantic_seg``: the mean over the cells of the semantic
    logits' (B, h, w, C + 1) CE against :func:`semantic_targets`, times
    ``weight``."""
    tgt = semantic_targets(batch, cfg, *sem_logits.shape[1:3])
    logp = torch.log_softmax(sem_logits.float(), dim=-1)
    return -batch_mean(torch.gather(logp, 3, tgt[..., None])) * weight


def htc_loss(model, batch: Batch, cfg: TwoStageConfig,
             sampling: Mapping[str, str] = TRAIN_SAMPLING, *,
             sem_loss_weight: float = 0.2):
    """HTC's training loss: the RPN's terms, the three stages with their
    mask heads (:func:`cascade_stages` with the semantic embedding), and
    ``loss_semantic_seg`` (:func:`semantic_loss`); the batch carries the
    segm pipeline's ``gt_polygons``."""
    losses, feats, props, pvalid = rpn_stage(model, batch, cfg, sampling)
    sem_logits, sem_feat = model.semantic(feats)
    total, terms, _ = cascade_stages(
        model, batch, cfg, feats, props, pvalid,
        losses["loss_rpn_cls"] + losses["loss_rpn_bbox"], sem_feat)
    losses.update(terms)
    losses["loss_semantic_seg"] = semantic_loss(sem_logits, batch, cfg,
                                                sem_loss_weight)
    return total + losses["loss_semantic_seg"], losses


def htc_masks(model, feats: List[torch.Tensor], det: Detections,
              scale_factors: torch.Tensor, sem_feat: torch.Tensor,
              rescale: bool = True) -> torch.Tensor:
    """The mean of the three stages' sigmoid masks of each detection's
    label, on its box (network coordinates; the RoI features taken once),
    each stage after the one before's features: (B, K, 28, 28) f32."""
    boxes = det.bboxes
    if rescale:
        boxes = boxes * scale_factors[:, None, :]
    roi_feats = model.mask_roi_feats(feats, rois_with_batch_idx(boxes),
                                     sem_feat)
    probs, last = 0.0, None
    for s in range(3):
        logits, last = model.mask_head_stage(s, roi_feats, last)
        probs = probs + torch.sigmoid(logits.float())
    sel = _label_maps(probs / 3.0, det.labels.reshape(-1))
    return sel.reshape(*boxes.shape[:2], *sel.shape[1:])


def htc_decode(model, images: torch.Tensor, img_shapes: torch.Tensor,
               scale_factors: torch.Tensor, cfg: TwoStageConfig,
               tcfg: TestConfig, rescale: bool = True,
               sampling: Mapping[str, str] = INFERENCE_SAMPLING
               ) -> Tuple[Detections, torch.Tensor]:
    """HTC's ``simple_test``: the cascade's detections with the semantic
    embedding (:func:`cascade_refine`, :func:`cascade_detections`) and
    their masks (:func:`htc_masks`)."""
    feats = model.extract(images, sampling)
    props, pvalid = rpn_proposals(model.rpn(feats), img_shapes, cfg)
    _, sem_feat = model.semantic(feats)
    boxes, probs = cascade_refine(model, feats, props, pvalid, sem_feat)
    det = cascade_detections(boxes, probs, img_shapes, scale_factors, tcfg,
                             rescale)
    return det, htc_masks(model, feats, det, scale_factors, sem_feat,
                          rescale)


# the training loss and the decode of each detector of the family that
# does not run two_stage_loss and two_stage_decode, by its class name
# (``models.heads.two_stage``); the mask detectors' decodes give masks
TWO_STAGE_LOSSES = {"MaskRCNNDetector": mask_rcnn_loss,
                    "MaskScoringRCNNDetector": mask_scoring_rcnn_loss,
                    "PointRendDetector": point_rend_loss,
                    "HTCDetector": htc_loss,
                    "CascadeRCNNDetector": cascade_rcnn_loss,
                    "GridRCNNDetector": grid_rcnn_loss}
TWO_STAGE_DECODES = {"MaskRCNNDetector": mask_rcnn_decode,
                     "MaskScoringRCNNDetector": mask_scoring_rcnn_decode,
                     "PointRendDetector": point_rend_decode,
                     "HTCDetector": htc_decode,
                     "CascadeRCNNDetector": cascade_rcnn_decode,
                     "GridRCNNDetector": grid_rcnn_decode}
