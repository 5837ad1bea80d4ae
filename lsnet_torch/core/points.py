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


def multi_level_points(image_shape: Tuple[int, int], strides: Sequence[int],
                       device=None) -> torch.Tensor:
    """All levels concatenated: (sum_l H_l*W_l, 3)."""
    shapes = level_shapes(image_shape, strides)
    return torch.cat([grid_points(sh, s, device)
                      for sh, s in zip(shapes, strides)], dim=0)


def num_level_points(image_shape: Tuple[int, int],
                     strides: Sequence[int]) -> List[int]:
    return [h * w for h, w in level_shapes(image_shape, strides)]


def valid_flags(image_shape: Tuple[int, int], strides: Sequence[int],
                pad_shape: torch.Tensor) -> torch.Tensor:
    """Per-point validity. ``pad_shape`` (..., 2) integer (h, w): each
    image's own padded shape before batch collation, inside the static
    canvas ``image_shape``. Returns (..., sum_l H_l*W_l) bool."""
    dev = pad_shape.device
    ph = pad_shape[..., 0, None, None]
    pw = pad_shape[..., 1, None, None]
    flags = []
    for (fh, fw), s in zip(level_shapes(image_shape, strides), strides):
        valid_h = torch.clamp(-torch.div(-ph, s, rounding_mode="floor"),
                              max=fh)
        valid_w = torch.clamp(-torch.div(-pw, s, rounding_mode="floor"),
                              max=fw)
        row = torch.arange(fh, device=dev).view(fh, 1) < valid_h
        col = torch.arange(fw, device=dev).view(1, fw) < valid_w
        flags.append((row & col).flatten(-2))
    return torch.cat(flags, dim=-1)
