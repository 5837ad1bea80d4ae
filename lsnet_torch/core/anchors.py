"""Anchors and box coders of the dense-head zoo (counterpart of
``lsnet_tpu/core/anchors.py``).

The anchor grids are host numpy, as in the JAX package, where ``jit``
bakes them in as constants; :func:`grid_anchors_on` builds each grid once
per (config, canvas, device) and keeps the tensor there, so no step
rebuilds it. The coders are elementwise tensor code with a written-out
batch dimension: a ``max_shape`` is a (2,) or (..., 2) [h, w] tensor or
pair, one per row of leading dimensions, broadcast over the boxes' last
axis but one.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class AnchorConfig:
    """mmdet AnchorGenerator semantics (v2): per-level base size = stride,
    anchors = octave scales x aspect ratios, zero center offset."""
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    octave_base_scale: float = 4.0
    scales_per_octave: int = 3
    center_offset: float = 0.0

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * self.scales_per_octave


def base_anchors(cfg: AnchorConfig, stride: int) -> np.ndarray:
    """(A, 4) base anchors for one level (x1, y1, x2, y2 around the cell
    origin; the reference ``gen_single_level_base_anchors``)."""
    scales = np.array([cfg.octave_base_scale * 2 ** (i / cfg.scales_per_octave)
                       for i in range(cfg.scales_per_octave)], np.float32)
    ratios = np.asarray(cfg.ratios, np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (stride * w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (stride * h_ratios[:, None] * scales[None, :]).reshape(-1)
    xc = cfg.center_offset * stride
    yc = cfg.center_offset * stride
    return np.stack([xc - 0.5 * ws, yc - 0.5 * hs,
                     xc + 0.5 * ws, yc + 0.5 * hs], axis=1)


def _shifted(base: np.ndarray, stride: int, h: int, w: int) -> np.ndarray:
    """(h * w * A, 4): ``base`` at every cell origin, cells row-major."""
    xs = np.arange(w, dtype=np.float32) * stride
    ys = np.arange(h, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x.ravel(), shift_y.ravel(),
                       shift_x.ravel(), shift_y.ravel()], 1)
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4).astype(
        np.float32)


def grid_anchors(cfg: AnchorConfig, image_shape: Tuple[int, int]
                 ) -> Tuple[np.ndarray, List[int]]:
    """All-level anchors for a padded canvas: (anchors (N_total*A, 4)
    float32, per-level counts)."""
    H, W = image_shape
    all_anchors = [_shifted(base_anchors(cfg, s), s, -(-H // s), -(-W // s))
                   for s in cfg.strides]
    return (np.concatenate(all_anchors),
            [a.shape[0] for a in all_anchors])


def cached_constant(fn):
    """``fn``'s results kept per argument tuple, each built outside
    inference mode: a table first made under ``torch.inference_mode``
    (an evaluation) is then read by a training step's autograd too."""
    @functools.lru_cache(maxsize=32)
    def build(*args):
        with torch.inference_mode(False):
            return fn(*args)
    return functools.wraps(fn)(build)


@cached_constant
def _grid_on(cfg: AnchorConfig, image_shape: Tuple[int, int],
             device: str) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    anchors, counts = grid_anchors(cfg, image_shape)
    return torch.from_numpy(anchors).to(device), tuple(counts)


def grid_anchors_on(cfg: AnchorConfig, image_shape: Tuple[int, int],
                    device) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """:func:`grid_anchors` as a tensor on ``device``, built once per
    (config, canvas, device) and shared by every later call, inference or
    training (do not modify it in place)."""
    return _grid_on(cfg, tuple(int(v) for v in image_shape),
                    str(torch.device(device)))


def anchor_valid_flags(cfg: AnchorConfig, image_shape: Tuple[int, int],
                       img_shape: torch.Tensor) -> torch.Tensor:
    """(..., N) bool: the anchor's cell origin inside the un-padded image
    (the reference ``valid_flags``); ``img_shape`` (..., 2) [h, w]."""
    H, W = image_shape
    dev = img_shape.device
    ih = img_shape[..., 0, None, None]
    iw = img_shape[..., 1, None, None]
    flags = []
    for s in cfg.strides:
        h, w = -(-H // s), -(-W // s)
        vy = (torch.arange(h, device=dev) * s).view(h, 1) < ih
        vx = (torch.arange(w, device=dev) * s).view(1, w) < iw
        v = (vy & vx).flatten(-2)
        flags.append(v.repeat_interleave(cfg.num_base_anchors, dim=-1))
    return torch.cat(flags, dim=-1)


# ------------------------------------------------------------- box coders --

def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _clip_boxes(x1, y1, x2, y2, max_shape):
    """Clip to [0, w] x [0, h] (``jnp.clip``: max, then min)."""
    if max_shape is None:
        return x1, y1, x2, y2
    m = _as_tensor(max_shape, x1)
    h, w = m[..., 0:1], m[..., 1:2]

    def clip(v, hi):
        return torch.minimum(v.clamp(min=0), hi)
    return clip(x1, w), clip(y1, h), clip(x2, w), clip(y2, h)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0),
               stds=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """The reference DeltaXYWHBBoxCoder.encode."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], -1)
    return (deltas - _as_tensor(means, deltas)) / _as_tensor(stds, deltas)


def delta2bbox(anchors: torch.Tensor, deltas: torch.Tensor,
               means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0),
               max_shape=None, wh_ratio_clip: float = 16.0 / 1000.0
               ) -> torch.Tensor:
    """The reference DeltaXYWHBBoxCoder.decode: dw, dh clamped to
    |log(wh_ratio_clip)|, the box clipped to ``max_shape`` where given."""
    d = deltas * _as_tensor(stds, deltas) + _as_tensor(means, deltas)
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy = d[..., 0], d[..., 1]
    dw = d[..., 2].clamp(-max_ratio, max_ratio)
    dh = d[..., 3].clamp(-max_ratio, max_ratio)
    px = (anchors[..., 0] + anchors[..., 2]) * 0.5
    py = (anchors[..., 1] + anchors[..., 3]) * 0.5
    pw = anchors[..., 2] - anchors[..., 0]
    ph = anchors[..., 3] - anchors[..., 1]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    return torch.stack(_clip_boxes(gx - gw * 0.5, gy - gh * 0.5,
                                   gx + gw * 0.5, gy + gh * 0.5, max_shape),
                       -1)


def distance2bbox(points: torch.Tensor, distances: torch.Tensor,
                  max_shape=None) -> torch.Tensor:
    """FCOS-style (l, t, r, b) -> box (the reference ``distance2bbox``)."""
    return torch.stack(_clip_boxes(
        points[..., 0] - distances[..., 0], points[..., 1] - distances[..., 1],
        points[..., 0] + distances[..., 2], points[..., 1] + distances[..., 3],
        max_shape), -1)


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor,
                  max_dist=None) -> torch.Tensor:
    d = torch.stack([points[..., 0] - bbox[..., 0],
                     points[..., 1] - bbox[..., 1],
                     bbox[..., 2] - points[..., 0],
                     bbox[..., 3] - points[..., 1]], -1)
    if max_dist is not None:
        d = d.clamp(0, max_dist)
    return d


def ssd_base_anchors(strides: Sequence[int],
                     ratios: Sequence[Sequence[float]],
                     basesize_ratio_range: Tuple[float, float],
                     input_size: int = 300) -> List[np.ndarray]:
    """SSDAnchorGenerator base anchors: per-level min/max sizes from the
    basesize ratio range, scales [1, sqrt(max/min)], ratios [1, 1/r, r,
    ...] with scale_major=False and the SSD row reorder (ratio-1 anchors
    at both scales first, the other ratios at scale 1)."""
    n_levels = len(strides)
    min_ratio = int(basesize_ratio_range[0] * 100)
    max_ratio = int(basesize_ratio_range[1] * 100)
    step = int(np.floor(max_ratio - min_ratio) / (n_levels - 2))
    min_sizes = [int(input_size * r / 100)
                 for r in range(min_ratio, max_ratio + 1, step)]
    max_sizes = [int(input_size * (r + step) / 100)
                 for r in range(min_ratio, max_ratio + 1, step)]
    first = {(300, 0.15): (7, 15), (300, 0.2): (10, 20),   # COCO, VOC
             (512, 0.1): (4, 10), (512, 0.15): (7, 15)}     # COCO, VOC
    key = (input_size, basesize_ratio_range[0])
    if key not in first:
        raise ValueError("unsupported SSD basesize_ratio_range/input_size")
    min_sizes.insert(0, int(input_size * first[key][0] / 100))
    max_sizes.insert(0, int(input_size * first[key][1] / 100))
    bases = []
    for lvl, s in enumerate(strides):
        base = float(min_sizes[lvl])
        scales = np.array([1.0, np.sqrt(max_sizes[lvl] / min_sizes[lvl])],
                          np.float32)
        rs = [1.0]
        for r in ratios[lvl]:
            rs += [1.0 / r, r]
        rs = np.asarray(rs, np.float32)
        h_ratios = np.sqrt(rs)
        w_ratios = 1.0 / h_ratios
        # scale_major=False: SCALE-major enumeration (index = s*R + r)
        ws = (base * scales[:, None] * w_ratios[None, :]).reshape(-1)
        hs = (base * scales[:, None] * h_ratios[None, :]).reshape(-1)
        xc = yc = s / 2.0
        anchors = np.stack([xc - 0.5 * ws, yc - 0.5 * hs,
                            xc + 0.5 * ws, yc + 0.5 * hs], 1)
        # the reference row reorder: (ratio1, scale1), (ratio1, scale2),
        # then the other ratios at scale 1
        R = len(rs)
        keep = [0, R] + list(range(1, R))
        bases.append(anchors[keep].astype(np.float32))
    return bases


def ssd_grid_anchors(image_shape: Tuple[int, int], strides: Sequence[int],
                     ratios: Sequence[Sequence[float]],
                     basesize_ratio_range: Tuple[float, float],
                     input_size: int = 300
                     ) -> Tuple[np.ndarray, List[int], List[int]]:
    """(anchors (N, 4), per-level anchor counts, per-level num_base)."""
    bases = ssd_base_anchors(strides, ratios, basesize_ratio_range,
                             input_size)
    H, W = image_shape
    all_anchors = [_shifted(base, s, -(-H // s), -(-W // s))
                   for s, base in zip(strides, bases)]
    return (np.concatenate(all_anchors), [a.shape[0] for a in all_anchors],
            [b.shape[0] for b in bases])
