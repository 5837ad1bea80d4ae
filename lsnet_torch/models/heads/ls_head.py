"""LSHead, bbox task (counterpart of ``lsnet_tpu/models/heads/ls_head.py``).

Per FPN level, a two-stage regressor:

  stage 1: conv towers (DCNv2+GN+ReLU blocks or plain conv+GN+ReLU) ->
    init landmark head -> softplus -> signed sampling field -> DCN offsets;
  stage 2: three cross-level pyramid deformable gathers per level, shared
    by the bbox-refine and cls branches (one corner table, two
    contractions) -> 1x1 fuse + 3x3 skip -> GN -> ReLU -> output conv;
    refine = softplus(out + init).

The reference quirk the JAX package keeps as ``offset_scale_compat=True``
is reproduced: the offset field is scaled in place across the 3-level
loop, so the scale compounds (published checkpoints were trained so).
Channel layout per landmark point: ``[y-, y+, x-, x+]``. Modules run in
NCHW; the returned maps are NHWC like the JAX head's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING, SampleJob
from ..layers import (ConvModule, DCNConvModule, PairedPyramidDeformConv,
                      nchw, nhwc)


def level_list(lvl: int, num_levels: int) -> List[int]:
    """Source levels of output level ``lvl`` (the reference's order)."""
    if lvl == 0:
        return [0, 1, 2]
    if lvl == num_levels - 1:
        return [lvl, lvl - 1, lvl - 2]
    return [lvl, lvl - 1, lvl + 1]


def branch_pyramid_jobs(feat_shapes: Sequence[Tuple[int, int]],
                        dcn_offs: Sequence[torch.Tensor],
                        dcn_kernel: int) -> List[SampleJob]:
    """All cross-level jobs of a refine branch in (out_lvl, src) order, 3
    per output level, the offset scale compounding across them.
    feat_shapes: per-level (H, W); dcn_offs NHWC."""
    num_levels = len(feat_shapes)
    pad = (dcn_kernel - 1) // 2
    jobs = []
    for lvl in range(num_levels):
        base_h, base_w = feat_shapes[lvl]
        off = dcn_offs[lvl]
        for level in level_list(lvl, num_levels):
            cur_h, cur_w = feat_shapes[level]
            scale_h = cur_h / base_h
            scale_w = cur_w / base_w
            o2 = off.reshape(*off.shape[:-1], -1, 2)
            off = (o2 * torch.tensor([scale_h, scale_w], dtype=off.dtype,
                                     device=off.device)).reshape(off.shape)
            jobs.append(SampleJob(level, off, None, (scale_h, scale_w),
                                  (1, 1), (pad, pad), (1, 1)))
    return jobs


def dcn_base_offset(kernel: int) -> np.ndarray:
    """(1,1,1,2K) base tap displacements [y,x]."""
    pad = (kernel - 1) // 2
    base = np.arange(-pad, pad + 1).astype(np.float32)
    yy = np.repeat(base, kernel)
    xx = np.tile(base, kernel)
    return np.stack([yy, xx], axis=1).reshape(1, 1, 1, -1)


def signed_from_pairs(x: torch.Tensor) -> torch.Tensor:
    """(..., 2P) (neg_slot, pos_slot) pairs -> (..., P): the larger slot,
    negated when the neg slot wins (ties go to the neg slot, as argmax)."""
    pairs = x.reshape(*x.shape[:-1], -1, 2)
    val = pairs.amax(dim=-1)
    neg = pairs[..., 0] >= pairs[..., 1]
    return torch.where(neg, -val, val)


def extreme_points2bbox(pts: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts (..., 20) -> (extremes (..., 8) [xt,yt, xl,yl, xb,yb, xr,yr],
    bbox (..., 4) [left, up, right, bottom]) in stride units."""
    signed = signed_from_pairs(pts)
    yx = signed.reshape(*signed.shape[:-1], -1, 2)
    ys = yx[..., 0]
    xs = yx[..., 1]
    bbox = torch.stack([xs[..., 1], ys[..., 0], xs[..., 3], ys[..., 2]],
                       dim=-1)
    extremes = torch.stack([xs[..., 0], ys[..., 0], xs[..., 1], ys[..., 1],
                            xs[..., 2], ys[..., 2], xs[..., 3], ys[..., 3]],
                           dim=-1)
    return extremes, bbox


class LSHead(nn.Module):

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_kernel_points: int = 9,
                 gradient_mul: float = 0.1, task: str = "bbox",
                 conv_module_type: str = "norm", norm_groups: int = 32):
        super().__init__()
        if task != "bbox":
            raise NotImplementedError(f"LSHead task {task!r}")
        if conv_module_type not in ("norm", "dcn"):
            raise ValueError(f"conv_module_type={conv_module_type!r}")
        self.gradient_mul = gradient_mul
        self.dcn_kernel = math.isqrt(num_kernel_points)
        pf = point_feat_channels
        ng = norm_groups
        for prefix in ("cls", "bbox"):
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                if conv_module_type == "norm":
                    blk = ConvModule(cin, feat_channels, 3,
                                     norm_cfg=dict(type="GN", num_groups=ng))
                else:
                    blk = DCNConvModule(cin, feat_channels, self.dcn_kernel,
                                        num_groups=ng)
                setattr(self, f"{prefix}_convs_{i}", blk)
        self.stacked_convs = stacked_convs
        bbox_out_dim = 4 * 5 + (num_kernel_points - 5) * 2            # 28
        self.pts_bbox_init_conv = nn.Conv2d(feat_channels, pf, 3, padding=1)
        self.pts_bbox_init_out = nn.Conv2d(pf, bbox_out_dim, 1)
        self.pts_bbox_refine_out = nn.Conv2d(pf, 4 * 5, 1)
        self.bbox_af_dcn_conv = nn.Conv2d(3 * pf, pf, 1)
        self.bbox_feat_conv = nn.Conv2d(feat_channels, pf, 3, padding=1)
        self.bbox_GN = nn.GroupNorm(ng, pf, eps=1e-5)
        self.pts_bbox_cls_pair = PairedPyramidDeformConv(
            feat_channels, feat_channels, pf, pf, self.dcn_kernel)
        self.pts_cls_out = nn.Conv2d(pf, num_classes, 1)
        self.cls_af_dcn_conv = nn.Conv2d(3 * pf, pf, 1)
        self.cls_feat_conv = nn.Conv2d(feat_channels, pf, 3, padding=1)
        self.cls_GN = nn.GroupNorm(ng, pf, eps=1e-5)
        self.register_buffer("base_offset", torch.from_numpy(
            dcn_base_offset(self.dcn_kernel)), persistent=False)

    def _tower(self, prefix: str, feats: List[torch.Tensor],
               sampling: Mapping[str, str]) -> List[torch.Tensor]:
        cur = list(feats)
        for i in range(self.stacked_convs):
            blk = getattr(self, f"{prefix}_convs_{i}")
            cur = blk(cur, sampling) if isinstance(blk, DCNConvModule) \
                else [blk(f) for f in cur]
        return cur

    def _get_pred_reg(self, raw_reg1: torch.Tensor,
                      raw_reg2: torch.Tensor) -> torch.Tensor:
        """Signed 2K-channel sampling field: 5 signed points + 4 raw
        extra points (NHWC)."""
        return torch.cat([signed_from_pairs(raw_reg1), raw_reg2], dim=-1)

    def _init_branch(self, feat: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW tower map -> (init_sp NHWC (…,20), dcn offset NHWC (…,2K))."""
        raw = nhwc(self.pts_bbox_init_out(F.relu(
            self.pts_bbox_init_conv(feat))))
        init_sp = F.softplus(raw[..., :20])
        pred_reg = self._get_pred_reg(init_sp, raw[..., 20:])
        g = self.gradient_mul
        mixed = (1.0 - g) * pred_reg.detach() + g * pred_reg
        return init_sp, mixed - self.base_offset.to(feat.dtype)

    @staticmethod
    def _fuse(raws: List[torch.Tensor], skip_feat: torch.Tensor, af_conv,
              feat_conv, gn, out_conv) -> torch.Tensor:
        x = F.relu(af_conv(torch.cat(raws, dim=1)))
        x = gn(x + feat_conv(skip_feat))
        return out_conv(F.relu(x))

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Dict[str, List[torch.Tensor]]:
        """NCHW level maps -> {"cls", "bbox_init", "bbox_refine"}: per-level
        NHWC maps. The towers sample at site "tower", the paired refine and
        cls gathers at "refine"."""
        n = len(feats)
        cls_feats = self._tower("cls", list(feats), sampling)
        bbox_feats = self._tower("bbox", list(feats), sampling)
        pairs = [self._init_branch(bf) for bf in bbox_feats]
        init_sps = [p[0] for p in pairs]
        jobs = branch_pyramid_jobs([tuple(f.shape[-2:]) for f in bbox_feats],
                                   [p[1] for p in pairs], self.dcn_kernel)
        bbox_raws, cls_raws = self.pts_bbox_cls_pair(
            [nhwc(f) for f in bbox_feats], [nhwc(f) for f in cls_feats],
            jobs, sampling)
        outs = {"cls": [], "bbox_init": [], "bbox_refine": []}
        for lvl in range(n):
            out = self._fuse([nchw(r) for r in bbox_raws[3 * lvl:3 * lvl + 3]],
                             bbox_feats[lvl], self.bbox_af_dcn_conv,
                             self.bbox_feat_conv, self.bbox_GN,
                             self.pts_bbox_refine_out)
            refine_sp = F.softplus(nhwc(out) + init_sps[lvl].detach())
            outs["bbox_init"].append(init_sps[lvl])
            outs["bbox_refine"].append(refine_sp)
        for lvl in range(n):
            cls_out = self._fuse([nchw(r) for r in cls_raws[3 * lvl:3 * lvl + 3]],
                                 cls_feats[lvl], self.cls_af_dcn_conv,
                                 self.cls_feat_conv, self.cls_GN,
                                 self.pts_cls_out)
            outs["cls"].append(nhwc(cls_out))
        return outs
