"""FPN grid points (counterpart of ``lsnet_tpu/core/points.py``): (x, y,
stride) triples, row-major per level."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def level_shapes(image_shape: Tuple[int, int],
                 strides: Sequence[int]) -> List[Tuple[int, int]]:
    """Feature-map (H, W) per level: ceil division by the stride."""
    H, W = image_shape
    return [(-(-H // s), -(-W // s)) for s in strides]


def grid_points(featmap_size: Tuple[int, int], stride: int,
                device=None) -> torch.Tensor:
    """(H*W, 3) f32 points (x, y, stride), x fastest."""
    h, w = featmap_size
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride
    xx = xs.repeat(h)
    yy = ys.repeat_interleave(w)
    ss = torch.full((h * w,), float(stride), device=device)
    return torch.stack([xx, yy, ss], dim=-1)
