"""The focal-loss family (counterpart of ``lsnet_tpu/ops/focal_loss.py``):
``sigmoid_focal_loss`` for classification, and CPV's ``sep_focal_loss``
(semantic maps) and ``gaussian_focal_loss`` (corner heatmaps).

Classification targets are class indices in [0, num_classes]; index ==
num_classes means background (an all-zero one-hot row). Arithmetic is f32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

AvgFactor = Union[torch.Tensor, float, None]


def _reduce(loss: torch.Tensor, weight: Optional[torch.Tensor],
            reduction: str, avg_factor: AvgFactor) -> torch.Tensor:
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
    return loss.sum() / avg_factor


def sigmoid_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                       weight: Optional[torch.Tensor] = None, *,
                       gamma: float = 2.0, alpha: float = 0.25,
                       reduction: str = "mean",
                       avg_factor: AvgFactor = None,
                       num_classes: Optional[int] = None) -> torch.Tensor:
    """pred (N, C) logits; target (N,) int class indices, ``num_classes``
    (C unless given) = background; weight (N,) per-sample label weights.
    Guided Anchoring's location loss passes ``num_classes=1`` with a
    (N, 1) ``pred`` and targets 0 (an object's centre) or 1."""
    C = pred.shape[-1] if num_classes is None else num_classes
    oh = F.one_hot(target.long(), C + 1)[..., :C].to(torch.float32)
    logits = pred.float()
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * oh + p * (1.0 - oh)
    focal_weight = (alpha * oh + (1.0 - alpha) * (1.0 - oh)) * pt ** gamma
    # numerically stable BCE with logits
    bce = (logits.clamp(min=0) - logits * oh
           + torch.log1p(torch.exp(-logits.abs())))
    loss = bce * focal_weight
    return _reduce(loss, None if weight is None else weight.reshape(-1, 1),
                   reduction, avg_factor)


def sep_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                   weight: Optional[torch.Tensor] = None, *,
                   gamma: float = 2.0, alpha: float = 0.25,
                   reduction: str = "mean",
                   avg_factor: AvgFactor = None) -> torch.Tensor:
    """Separate positive / negative focal loss on a (N, C) {0, 1} target
    map (CPV's semantic branch): ``alpha (1-p)^gamma log p`` at the
    positives, ``(1-alpha) p^gamma log(1-p)`` at the negatives. A 1-d
    ``weight`` weighs rows."""
    p = torch.sigmoid(pred.float())
    t = target.float()
    eps = 1e-12
    pos = -alpha * (1.0 - p) ** gamma * torch.log(p.clamp(min=eps)) * t
    neg = (-(1.0 - alpha) * p ** gamma
           * torch.log((1.0 - p).clamp(min=eps)) * (1.0 - t))
    if weight is not None and weight.dim() == 1:
        weight = weight.reshape(-1, 1)
    return _reduce(pos + neg, weight, reduction, avg_factor)


def gaussian_focal_loss(pred: torch.Tensor, gaussian_target: torch.Tensor,
                        weight: Optional[torch.Tensor] = None, *,
                        alpha: float = 2.0, gamma: float = 4.0,
                        reduction: str = "mean",
                        avg_factor: AvgFactor = None) -> torch.Tensor:
    """CornerNet's focal loss on a probability heatmap ``pred`` (after the
    sigmoid) against gaussian targets in [0, 1], 1 at the bump centres."""
    p = pred.float()
    t = gaussian_target.float()
    eps = 1e-12
    pos_weights = (t == 1.0).float()
    neg_weights = (1.0 - t) ** gamma
    pos = -torch.log(p.clamp(min=eps)) * (1.0 - p) ** alpha * pos_weights
    neg = -torch.log((1.0 - p).clamp(min=eps)) * p ** alpha * neg_weights
    return _reduce(pos + neg, weight, reduction, avg_factor)
