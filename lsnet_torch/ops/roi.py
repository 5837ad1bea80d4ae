"""RoI feature extraction, plain PyTorch (counterpart of
``lsnet_tpu/ops/roi.py``): RoIAlign, deformable RoI pooling and RoIPool
with the JAX package's sampling, for the two-stage detectors.

Layout NHWC; rois are (N, 5) [batch_idx, x1, y1, x2, y2]. Each RoI reads
its own image's rows of the flattened map through a row offset
(``bilinear_gather_rows``), so no copy of the map is made per RoI (the
JAX code's ``feats[batch_idx]``, which XLA fuses into its gather, would
be one map per RoI in eager torch). :func:`multilevel_roi_align` routes
each RoI to its FPN level by the same offsets into one table of the
levels' rows: the forward and the gradient equal the JAX package's
all-levels-then-mask form (``r * 1 + 0``), with a quarter of its
gathers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .deform_conv import bilinear_gather_rows


def _bin_grid(rois: torch.Tensor, scale, out_size: Tuple[int, int],
              s: int, offset: float, min_size: float):
    """Each RoI's box in map coordinates and its (N, oh*s) / (N, ow*s)
    sample rows and columns, ``s`` samples a bin a side, at the bin
    fractions (i + 0.5) / s: (ys, xs, roi_h, roi_w)."""
    oh, ow = out_size
    x1 = rois[:, 1] * scale - offset
    y1 = rois[:, 2] * scale - offset
    x2 = rois[:, 3] * scale - offset
    y2 = rois[:, 4] * scale - offset
    roi_w = torch.clamp(x2 - x1, min=min_size)
    roi_h = torch.clamp(y2 - y1, min=min_size)
    f32 = dict(dtype=torch.float32, device=rois.device)
    gy = (torch.arange(oh * s, **f32) + 0.5) / s
    gx = (torch.arange(ow * s, **f32) + 0.5) / s
    ys = y1[:, None] + gy[None, :] * (roi_h / oh)[:, None]
    xs = x1[:, None] + gx[None, :] * (roi_w / ow)[:, None]
    return ys, xs, roi_h, roi_w


def _pool_bins(rows, base, h, w, yy, xx, out_size, s):
    """Bilinear samples (N, oh*s, ow*s) -> the mean of each bin's s x s,
    (N, oh, ow, C)."""
    N = yy.shape[0]
    oh, ow = out_size
    vals = bilinear_gather_rows(rows, base, h, w, yy.reshape(N, -1),
                                xx.reshape(N, -1))
    return vals.reshape(N, oh, s, ow, s, -1).mean(dim=(2, 4))


def _grid(ys: torch.Tensor, xs: torch.Tensor):
    N = ys.shape[0]
    return (ys[:, :, None].expand(N, ys.shape[1], xs.shape[1]),
            xs[:, None, :].expand(N, ys.shape[1], xs.shape[1]))


def _image_rows(feats: torch.Tensor, rois: torch.Tensor):
    """(rows (B*H*W, C), each RoI's first row (N, 1), H, W)."""
    B, H, W, C = feats.shape
    base = (rois[:, 0].long() * (H * W))[:, None]
    return feats.reshape(B * H * W, C), base, H, W


def roi_align(feats: torch.Tensor, rois: torch.Tensor,
              out_size: Tuple[int, int] = (7, 7), spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """RoIAlign (v2 'aligned' semantics by default). feats (B,H,W,C),
    rois (N,5) -> (N, oh, ow, C)."""
    rows, base, H, W = _image_rows(feats, rois)
    ys, xs, _, _ = _bin_grid(rois, spatial_scale, out_size, sampling_ratio,
                             0.5 if aligned else 0.0,
                             1e-6 if aligned else 1.0)
    yy, xx = _grid(ys, xs)
    return _pool_bins(rows, base, H, W, yy, xx, out_size, sampling_ratio)


def deform_roi_pool(feats: torch.Tensor, rois: torch.Tensor,
                    offsets: torch.Tensor,
                    out_size: Tuple[int, int] = (7, 7),
                    spatial_scale: float = 1.0, gamma: float = 0.1,
                    sample_per_part: int = 4) -> torch.Tensor:
    """Deformable RoI pooling (reference ``deform_pool_cuda_kernel.cu``):
    each output bin's samples shift by its offset x ``gamma`` x the RoI's
    size before the average. offsets (N, oh, ow, 2) per-bin (dy, dx)."""
    s = sample_per_part
    rows, base, H, W = _image_rows(feats, rois)
    ys, xs, roi_h, roi_w = _bin_grid(rois, spatial_scale, out_size, s, 0.5,
                                     0.1)
    dy = offsets[..., 0] * gamma * roi_h[:, None, None]      # (N, oh, ow)
    dx = offsets[..., 1] * gamma * roi_w[:, None, None]
    yy, xx = _grid(ys, xs)
    yy = yy + dy.repeat_interleave(s, 1).repeat_interleave(s, 2)
    xx = xx + dx.repeat_interleave(s, 1).repeat_interleave(s, 2)
    return _pool_bins(rows, base, H, W, yy, xx, out_size, s)


def roi_pool(feats: torch.Tensor, rois: torch.Tensor,
             out_size: Tuple[int, int] = (7, 7),
             spatial_scale: float = 1.0) -> torch.Tensor:
    """RoIPool: the max over each bin of a 4 x 4 lattice of integer
    samples. feats (B,H,W,C) -> (N,oh,ow,C). Equal maxima share the
    gradient (``amax``), as ``jnp.max``'s do."""
    S = 4
    oh, ow = out_size
    N = rois.shape[0]
    rows, base, H, W = _image_rows(feats, rois)
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    roi_w = torch.clamp(x2 - x1 + 1, min=1.0)
    roi_h = torch.clamp(y2 - y1 + 1, min=1.0)
    f32 = dict(dtype=torch.float32, device=rois.device)
    gy = torch.arange(oh * S, **f32) / S
    gx = torch.arange(ow * S, **f32) / S
    ys = (y1[:, None] + gy[None, :] * roi_h[:, None] / oh).clamp(0, H - 1)
    xs = (x1[:, None] + gx[None, :] * roi_w[:, None] / ow).clamp(0, W - 1)
    idx = (torch.floor(ys).long()[:, :, None] * W
           + torch.floor(xs).long()[:, None, :]).reshape(N, -1) + base
    vals = rows[idx.reshape(-1)].reshape(N, oh, S, ow, S, -1)
    return vals.amax(dim=(2, 4))


def roi_levels(rois: torch.Tensor, n_lvl: int,
               finest_scale: float = 56.0) -> torch.Tensor:
    """Each RoI's FPN level (the reference SingleRoIExtractor's
    ``map_roi_levels``): floor(log2(sqrt(area) / finest_scale)), clamped
    to [0, n_lvl)."""
    w = rois[:, 3] - rois[:, 1]
    h = rois[:, 4] - rois[:, 2]
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, n_lvl - 1).long()


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int],
                         out_size: Tuple[int, int] = (7, 7),
                         finest_scale: float = 56.0,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """RoIAlign of each RoI on its own FPN level (the first four levels
    at most, as the reference extractor uses). feats: NHWC levels;
    rois: (N, 5) -> (N, oh, ow, C)."""
    n_lvl = min(len(feats), 4)
    lvl = roi_levels(rois, n_lvl, finest_scale)
    dev = rois.device
    sizes = [f.shape[1:3] for f in feats[:n_lvl]]
    B = feats[0].shape[0]
    counts = [B * h * w for h, w in sizes]
    starts = torch.tensor([sum(counts[:i]) for i in range(n_lvl)],
                          device=dev)
    hs = torch.tensor([h for h, _ in sizes], device=dev)
    ws = torch.tensor([w for _, w in sizes], device=dev)
    scales = torch.tensor([1.0 / s for s in strides[:n_lvl]],
                          dtype=torch.float32, device=dev)
    rows = torch.cat([f.reshape(n, f.shape[-1])
                      for f, n in zip(feats[:n_lvl], counts)])
    h, w = hs[lvl][:, None], ws[lvl][:, None]
    base = starts[lvl][:, None] + rois[:, 0].long()[:, None] * h * w
    ys, xs, _, _ = _bin_grid(rois, scales[lvl], out_size, sampling_ratio,
                             0.5, 1e-6)
    yy, xx = _grid(ys, xs)
    return _pool_bins(rows, base, h, w, yy, xx, out_size, sampling_ratio)
