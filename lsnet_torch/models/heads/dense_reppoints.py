"""Dense RepPoints v1 and v2 heads (counterpart of
``lsnet_tpu/models/heads/dense_reppoints.py``): dense point-set instance
segmentation.

Each grid point predicts ``num_points`` (729 in the shipped files) point
offsets ([x, y], in stride units, around a k x k grid prior).
Classification pools the cls features at the first point of each of
``num_group`` groups; a per-point mask score is read from a
``num_score_group``-channel position-sensitive score map, each point from
the channel of its cell in a sqrt(G) x sqrt(G) grid over its set's box;
refinement samples a per-point 2-channel flow at each point's own
location. Every sampling step is a bilinear read with the coordinates
clamped to the map (``F.grid_sample``'s ``padding_mode='border'``,
``align_corners=True``), written as batched gathers over the level map:

* the group-leader features: 9 reads of C channels per grid point;
* the refine flow: each point reads only its own 2 channels, one batched
  gather over (B, H, W, P) for the whole level;
* the mask scores: each point reads only the one channel its group
  selects. The JAX head samples all G channels and then takes one, which
  materialises (B, H, W, P, G); at 800x1344 with P = 729 and G = 121 that
  is 1.48e9 values an image at level 0, for each corner.

No step runs the deformable conv engine, so the heads launch no K1.
The JAX head's ``fuse_mask_feat`` (off in every shipped file) is not
ported.
Modules run in NCHW; the returned maps are NHWC like the JAX head's.
Submodule names are the flax names (the towers are flax's auto-named
``_Tower_0`` cls, ``_Tower_1`` reg, ``_Tower_2`` mask).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import nchw, nhwc
from .dense import Tower, conv3


def _border_corners(xs: torch.Tensor, ys: torch.Tensor, H: int, W: int):
    """Clamped bilinear corners of (xs, ys): ((y0, y1), (x0, x1)) integer
    rows and columns, and the weights' fractions (fx, fy)."""
    x = xs.clamp(0.0, W - 1.0)
    y = ys.clamp(0.0, H - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    x0i = x0.long().clamp(0, W - 1)
    y0i = y0.long().clamp(0, H - 1)
    return ((y0i, (y0i + 1).clamp(max=H - 1)),
            (x0i, (x0i + 1).clamp(max=W - 1)), x - x0, y - y0)


def _blend(read, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Bilinear blend of the four corner reads ``read(dy, dx)``."""
    return ((read(0, 0) * (1 - fx) + read(0, 1) * fx) * (1 - fy)
            + (read(1, 0) * (1 - fx) + read(1, 1) * fx) * fy)


def border_sample(feat: torch.Tensor, xs: torch.Tensor,
                  ys: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with border clamp. feat (B, H, W, C); xs / ys
    (B, ...) absolute pixel coordinates -> (B, ..., C)."""
    B, H, W, C = feat.shape
    ys_, xs_, fx, fy = _border_corners(xs, ys, H, W)
    flat = feat.reshape(B * H * W, C)
    base = (torch.arange(B, device=feat.device) * (H * W)).view(
        B, *([1] * (xs.dim() - 1)))

    def read(dy, dx):
        return flat[(base + ys_[dy] * W + xs_[dx]).reshape(-1)].reshape(
            *xs.shape, C)

    return _blend(read, fx[..., None], fy[..., None])


def sample_offset_feature(feat: torch.Tensor, flow: torch.Tensor
                          ) -> torch.Tensor:
    """``feat`` (B, H, W, C) sampled at (grid + flow) of every cell; flow
    (B, H, W, P, 2) [x, y] pixel offsets -> (B, H, W, P, C)."""
    B, H, W, C = feat.shape
    gx = torch.arange(W, dtype=flow.dtype, device=flow.device).view(
        1, 1, W, 1)
    gy = torch.arange(H, dtype=flow.dtype, device=flow.device).view(
        1, H, 1, 1)
    return border_sample(feat, gx + flow[..., 0], gy + flow[..., 1])


def sample_group_scores(score_map: torch.Tensor, pts: torch.Tensor,
                        group_idx: torch.Tensor) -> torch.Tensor:
    """Position-sensitive score sampling: each point's bilinear read of
    the score-map channel its group index selects. score_map
    (B, H, W, G); pts (B, H, W, P, 2) absolute [x, y]; group_idx
    (B, H, W, P) -> (B, H, W, P). Only the selected channel is read."""
    B, H, W, G = score_map.shape
    ys_, xs_, fx, fy = _border_corners(pts[..., 0], pts[..., 1], H, W)
    flat = score_map.reshape(-1)
    base = (torch.arange(B, device=pts.device) * (H * W)).view(B, 1, 1, 1)
    gi = group_idx.long()

    def read(dy, dx):
        return flat[((base + ys_[dy] * W + xs_[dx]) * G + gi).reshape(-1)
                    ].reshape(gi.shape)

    return _blend(read, fx, fy)


def sample_own_flow(field: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Each point's own 2-channel flow read at its own location: field
    (B, H, W, P, 2) (point p's flow map is ``field[..., p, :]``); xs / ys
    (B, H, W, P) absolute pixel coordinates -> (B, H, W, P, 2)."""
    B, H, W, Pn, _ = field.shape
    ys_, xs_, fx, fy = _border_corners(xs, ys, H, W)
    flat = field.reshape(-1, 2)
    base = (torch.arange(B, device=xs.device) * (H * W)).view(B, 1, 1, 1)
    p = torch.arange(Pn, device=xs.device)

    def read(dy, dx):
        return flat[((base + ys_[dy] * W + xs_[dx]) * Pn + p).reshape(-1)
                    ].reshape(*xs.shape, 2)

    return _blend(read, fx[..., None], fy[..., None])


def grid_group_partition(pts: torch.Tensor, num_score_group: int
                         ) -> torch.Tensor:
    """Each point's cell in a sqrt(G) x sqrt(G) grid over its set's
    min / max box. pts (B, H, W, P, 2) [x, y] -> (B, H, W, P) int32."""
    k = math.isqrt(num_score_group)
    x, y = pts[..., 0], pts[..., 1]
    x1, x2 = x.amin(-1, keepdim=True), x.amax(-1, keepdim=True)
    y1, y2 = y.amin(-1, keepdim=True), y.amax(-1, keepdim=True)
    nx = (x - x1) / (x2 - x1 + 1e-6)
    ny = (y - y1) / (y2 - y1 + 1e-6)
    gx = (nx * k).to(torch.int32).clamp(0, k - 1)
    gy = (ny * k).to(torch.int32).clamp(0, k - 1)
    return gy * k + gx


class DenseRepPointsHead(nn.Module):
    """``forward(feats, sampling)`` -> per-level NHWC ``cls``,
    ``pts_init`` / ``pts_refine`` (2P, [x, y] per point, stride units)
    and ``pts_score`` (P logits). ``sampling`` is accepted for the
    detector's interface and unused: the head runs no deformable conv."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, stacked_mask_convs: int = 3,
                 num_points: int = 729, num_group: int = 9,
                 num_score_group: int = 121, gradient_mul: float = 0.1,
                 point_base_scale: int = 4):
        super().__init__()
        self.num_points, self.num_group = num_points, num_group
        self.num_score_group = num_score_group
        self.gradient_mul = gradient_mul
        self.point_base_scale = point_base_scale
        fc, pf, P2 = feat_channels, point_feat_channels, 2 * num_points
        self._Tower_0 = Tower(stacked_convs, in_channels, fc, True, "cls_conv")
        self._Tower_1 = Tower(stacked_convs, in_channels, fc, True, "reg_conv")
        self._Tower_2 = Tower(stacked_mask_convs, in_channels, fc, True,
                               "mask_conv")
        self.pts_init_conv = conv3(fc, pf)
        self.pts_init_out = nn.Conv2d(pf, P2, 1)
        self.pts_refine_conv = conv3(fc, pf)
        self.pts_refine_out = nn.Conv2d(pf, P2, 1)
        self.cls_conv1x1 = nn.Conv2d(num_group * fc, pf, 1)
        self.cls_out = nn.Conv2d(pf, num_classes, 1)
        self.mask_init_conv = conv3(fc, pf)
        self.mask_init_out = nn.Conv2d(pf, num_score_group, 1)
        self.register_buffer("init_prior", torch.from_numpy(
            self.points_init()), persistent=False)

    def points_init(self) -> np.ndarray:
        """The grid prior, (2P,) [x, y] per point in stride units: a k x k
        grid of half-width ``point_base_scale / 2``."""
        k = math.isqrt(self.num_points)
        pad = (k - 1) // 2
        base = np.arange(-pad, pad + 1).astype(np.float64)
        init = np.stack([np.tile(base, k), np.repeat(base, k)], 1)
        init = init / max(pad, 1) * (self.point_base_scale / 2)
        return init.astype(np.float32).reshape(-1)

    def forward(self, feats: Sequence[torch.Tensor], sampling=None
                ) -> Dict[str, List[torch.Tensor]]:
        return self._run(list(feats))

    def _run(self, feats: List[torch.Tensor]
             ) -> Dict[str, List[torch.Tensor]]:
        Pn, g = self.num_points, self.gradient_mul
        outs: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("cls", "pts_init", "pts_refine", "pts_score")}
        mask_feats, detached = [], []
        for x in feats:
            B, _, H, W = x.shape
            cf, pf = self._Tower_0(x), self._Tower_1(x)
            mask_feats.append(self._Tower_2(x))
            pts_init = nhwc(self.pts_init_out(F.relu(self.pts_init_conv(pf)))
                            ) + self.init_prior.to(x.dtype)
            pts_detach = (1 - g) * pts_init.detach() + g * pts_init
            detached.append(pts_detach)
            # classification pools the cls features at each group's first
            # point
            flow = pts_detach.reshape(B, H, W, Pn, 2)
            per_grp = Pn // self.num_group
            leader = flow[:, :, :, ::per_grp][:, :, :, :self.num_group]
            sampled = sample_offset_feature(nhwc(cf), leader)
            cat = nchw(sampled.reshape(B, H, W, -1))
            outs["cls"].append(nhwc(self.cls_out(F.relu(
                self.cls_conv1x1(cat)))))
            # refine: each point's own flow, read at its own location
            field = nhwc(self.pts_refine_out(F.relu(self.pts_refine_conv(
                pf)))).reshape(B, H, W, Pn, 2)
            gx, gy = self._grid(H, W, x)
            moved = sample_own_flow(field, gx + flow[..., 0],
                                    gy + flow[..., 1])
            outs["pts_refine"].append((moved + flow).reshape(B, H, W, 2 * Pn))
            outs["pts_init"].append(pts_init)
        for mf, pts_detach, x in zip(mask_feats, detached, feats):
            B, _, Hp, Wp = x.shape
            score_map = nhwc(self.mask_init_out(F.relu(
                self.mask_init_conv(mf))))
            flow = pts_detach.reshape(B, Hp, Wp, Pn, 2)
            gx, gy = self._grid(Hp, Wp, mf)
            abs_pts = torch.stack([gx + flow[..., 0], gy + flow[..., 1]], -1)
            grp = grid_group_partition(abs_pts, self.num_score_group)
            outs["pts_score"].append(sample_group_scores(score_map, abs_pts,
                                                         grp))
        return outs

    @staticmethod
    def _grid(H: int, W: int, like: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Cell columns (1, 1, W, 1) and rows (1, H, 1, 1) in the maps'
        dtype."""
        kw = dict(dtype=like.dtype, device=like.device)
        return (torch.arange(W, **kw).view(1, 1, W, 1),
                torch.arange(H, **kw).view(1, H, 1, 1))


class DenseRepPointsV2Head(DenseRepPointsHead):
    """Dense RepPoints v2: v1 on level maps mixed with a semantic
    embedding, plus ``sem`` scores (from the raw level) and the contour
    branch's ``hm_tl`` score (1) and ``off_tl`` offset (2) maps."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, **kw):
        kw.pop("stacked_shared_convs", None)    # v2 reads the raw level
        super().__init__(num_classes, in_channels, feat_channels, **kw)
        self.sem_out = conv3(in_channels, num_classes)
        self.sem_embedding = conv3(in_channels, feat_channels)
        self.cont_score_out = conv3(feat_channels, 1)
        self.cont_offset_out = conv3(feat_channels, 2)
        self.sem_gn = nn.GroupNorm(32, feat_channels, eps=1e-6)

    def forward(self, feats: Sequence[torch.Tensor], sampling=None
                ) -> Dict[str, List[torch.Tensor]]:
        mixed, sem, cont, cont_off = [], [], [], []
        for x in feats:
            sem.append(nhwc(self.sem_out(x)))
            xm = x + self.sem_gn(self.sem_embedding(x))
            cont.append(nhwc(self.cont_score_out(xm)))
            cont_off.append(nhwc(self.cont_offset_out(xm)))
            mixed.append(xm)
        outs = self._run(mixed)
        outs["sem"], outs["hm_tl"], outs["off_tl"] = sem, cont, cont_off
        return outs
