"""Sigmoid focal loss (counterpart of ``lsnet_tpu/ops/focal_loss.py``
``sigmoid_focal_loss``; the separate and gaussian variants come with CPV).

Classification targets are class indices in [0, num_classes]; index ==
num_classes means background (an all-zero one-hot row).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                       weight: Optional[torch.Tensor] = None, *,
                       gamma: float = 2.0, alpha: float = 0.25,
                       reduction: str = "mean",
                       avg_factor: Union[torch.Tensor, float, None] = None
                       ) -> torch.Tensor:
    """pred (N, C) logits; target (N,) int class indices, C = background;
    weight (N,) per-sample label weights. f32 arithmetic."""
    C = pred.shape[-1]
    oh = F.one_hot(target.long(), C + 1)[..., :C].to(torch.float32)
    logits = pred.float()
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * oh + p * (1.0 - oh)
    focal_weight = (alpha * oh + (1.0 - alpha) * (1.0 - oh)) * pt ** gamma
    # numerically stable BCE with logits
    bce = (logits.clamp(min=0) - logits * oh
           + torch.log1p(torch.exp(-logits.abs())))
    loss = bce * focal_weight
    if weight is not None:
        loss = loss * weight.reshape(-1, 1)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"reduction {reduction!r}")
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / avg_factor
