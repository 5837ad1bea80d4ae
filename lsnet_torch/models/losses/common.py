"""The general loss zoo (counterpart of ``lsnet_tpu/models/losses/
common.py``): the IoU family (IoU / GIoU / DIoU / CIoU), SmoothL1 / L1,
cross-entropy and BCE, GHM-C, the associative-embedding loss and the
chamfer loss, with the mmdet ``weight`` / ``avg_factor`` conventions: the
mean is ``sum(loss * weight) / max(avg_factor, 1e-12)`` where an
``avg_factor`` is given.

The box losses take aligned (..., 4) x1y1x2y2 boxes, any leading
dimensions (the JAX functions take (N, 4)). Maxima and minima split the
gradient between equal entries, as ``jnp.maximum`` does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops.misc import chamfer_distance


def _reduce(loss, weight, reduction, avg_factor):
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"reduction {reduction!r}")
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor), min=1e-12)


def _area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (
        b[..., 3] - b[..., 1]).clamp(min=0)


def _enclosing_wh(pred, target):
    lt = torch.minimum(pred[..., :2], target[..., :2])
    rb = torch.maximum(pred[..., 2:], target[..., 2:])
    return (rb - lt).clamp(min=0)


def _inter(pred, target):
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def bbox_overlaps_aligned(pred: torch.Tensor, target: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """Elementwise IoU of aligned (..., 4) x1y1x2y2 boxes."""
    inter = _inter(pred, target)
    return inter / torch.clamp(_area(pred) + _area(target) - inter, min=eps)


def iou_loss(pred, target, weight=None, *, eps=1e-6, reduction="mean",
             avg_factor=None, loss_weight=1.0):
    loss = -torch.log(bbox_overlaps_aligned(pred, target, eps).clamp(eps,
                                                                     1.0))
    return loss_weight * _reduce(loss, weight, reduction, avg_factor)


def giou_loss(pred, target, weight=None, *, eps=1e-6, reduction="mean",
              avg_factor=None, loss_weight=1.0):
    ious = bbox_overlaps_aligned(pred, target, eps)
    wh = _enclosing_wh(pred, target)
    enclose = torch.clamp(wh[..., 0] * wh[..., 1], min=eps)
    union = _area(pred) + _area(target) - _inter(pred, target)
    gious = ious - (enclose - union) / enclose
    return loss_weight * _reduce(1 - gious, weight, reduction, avg_factor)


def _center_term(pred, target, eps):
    """rho^2 / c^2: squared centre distance over the enclosing diagonal."""
    wh = _enclosing_wh(pred, target)
    c2 = wh[..., 0] ** 2 + wh[..., 1] ** 2 + eps
    pc = (pred[..., :2] + pred[..., 2:]) / 2
    tc = (target[..., :2] + target[..., 2:]) / 2
    return ((pc - tc) ** 2).sum(-1) / c2


def diou_loss(pred, target, weight=None, *, eps=1e-6, reduction="mean",
              avg_factor=None, loss_weight=1.0):
    ious = bbox_overlaps_aligned(pred, target, eps)
    return loss_weight * _reduce(1 - ious + _center_term(pred, target, eps),
                                 weight, reduction, avg_factor)


def ciou_loss(pred, target, weight=None, *, eps=1e-6, reduction="mean",
              avg_factor=None, loss_weight=1.0):
    ious = bbox_overlaps_aligned(pred, target, eps)
    w1 = (pred[..., 2] - pred[..., 0]).clamp(min=eps)
    h1 = (pred[..., 3] - pred[..., 1]).clamp(min=eps)
    w2 = (target[..., 2] - target[..., 0]).clamp(min=eps)
    h2 = (target[..., 3] - target[..., 1]).clamp(min=eps)
    v = 4 / math.pi ** 2 * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / torch.clamp(1 - ious + v, min=eps)).detach()
    return loss_weight * _reduce(
        1 - ious + _center_term(pred, target, eps) + alpha * v, weight,
        reduction, avg_factor)


def smooth_l1_loss(pred, target, weight=None, *, beta=1.0,
                   reduction="mean", avg_factor=None, loss_weight=1.0):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return loss_weight * _reduce(loss, weight, reduction, avg_factor)


def l1_loss(pred, target, weight=None, *, reduction="mean",
            avg_factor=None, loss_weight=1.0):
    return loss_weight * _reduce((pred - target).abs(), weight, reduction,
                                 avg_factor)


def cross_entropy_loss(pred, label, weight=None, *, reduction="mean",
                       avg_factor=None, class_weight=None, loss_weight=1.0):
    """Softmax CE, integer labels (N,) over logits (N, C)."""
    logp = F.log_softmax(pred.float(), dim=-1)
    ce = -torch.gather(logp, -1, label.long()[:, None])[:, 0]
    if class_weight is not None:
        ce = ce * _cw(class_weight, ce)[label.long()]
    return loss_weight * _reduce(ce, weight, reduction, avg_factor)


def _cw(class_weight, like):
    return torch.as_tensor(class_weight, dtype=like.dtype, device=like.device)


def bce_with_logits(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy of logits ``p`` against targets
    ``t`` (the numerically stable form)."""
    return p.clamp(min=0) - p * t + torch.log1p(torch.exp(-p.abs()))


def binary_cross_entropy_loss(pred, label, weight=None, *, reduction="mean",
                              avg_factor=None, loss_weight=1.0):
    """BCE with logits; label the shape of pred."""
    return loss_weight * _reduce(bce_with_logits(pred.float(), label.float()),
                                 weight, reduction, avg_factor)


def ghm_c_loss(pred, target, label_weight, *, bins=10, momentum=0.0,
               loss_weight=1.0):
    """Gradient-harmonizing classification loss (the reference
    ``ghm_loss.py``): examples reweighted inversely to the local density
    of gradient norms. target / label_weight: (N, C) one-hot / valid."""
    p = torch.sigmoid(pred.float())
    t = target.float()
    valid = label_weight.bool()
    g = (p - t).abs()
    tot = torch.clamp(valid.sum().float(), min=1.0)
    weights = torch.zeros_like(p)
    edges = torch.linspace(0, 1, bins + 1, device=p.device)
    edges[-1] += 1e-6
    for i in range(bins):
        inds = (g >= edges[i]) & (g < edges[i + 1]) & valid
        num_in_bin = inds.sum().float()
        w = torch.where(num_in_bin > 0,
                        tot / torch.clamp(num_in_bin, min=1.0),
                        torch.zeros_like(tot))
        weights = torch.where(inds, w, weights)
    weights = weights / bins
    bce = bce_with_logits(pred.float(), t)
    return loss_weight * (bce * weights).sum() / tot


def ae_loss(tag_preds, match_mask, *, pull_weight=0.25, push_weight=0.25):
    """Grouping loss of corner embeddings (the reference ``ae_loss.py``):
    matched pairs pulled together, different objects pushed apart.
    tag_preds (M, 2) [tl_tag, br_tag] per (padded) object; match_mask
    (M,) valid objects."""
    t = tag_preds.float()
    m = match_mask.float()
    n = torch.clamp(m.sum(), min=1.0)
    mean = (t[:, 0] + t[:, 1]) / 2
    pull = (((t[:, 0] - mean) ** 2 + (t[:, 1] - mean) ** 2) * m).sum() / n
    diff = (mean[:, None] - mean[None, :]).abs()
    pair_m = m[:, None] * m[None, :] * (
        1 - torch.eye(t.shape[0], device=t.device))
    push = ((1.0 - diff).clamp(min=0.0) * pair_m).sum() / torch.clamp(
        n * (n - 1), min=1.0)
    return pull_weight * pull + push_weight * push


def chamfer_loss(pred_pts, gt_pts, weight=None, *, reduction="mean",
                 avg_factor=None, loss_weight=1.0):
    """Point-set chamfer loss (the reference ``chamfer_loss.py``) on
    (N, P, 2) point sets."""
    d1, d2 = chamfer_distance(pred_pts, gt_pts)
    loss = d1.mean(-1) + d2.mean(-1)
    return loss_weight * _reduce(loss, weight, reduction, avg_factor)
