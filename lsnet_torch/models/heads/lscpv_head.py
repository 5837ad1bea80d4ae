"""LSCPVHead, the corner-point-verification head (counterpart of
``lsnet_tpu/models/heads/lscpv_head.py``): the bbox LSHead with

* a semantic branch (``sem_out`` scores, ``sem_embedding`` added to every
  tower map) on the shared tower, which reads the bbox tower's output;
* top-left and bottom-right corner-pooling branches (``hem_tl`` /
  ``hem_br``: :class:`CornerPoolPack`) predicting a corner heatmap (1
  channel each) and sub-stride offsets (2 each);
* those 6 channels concatenated onto the cls and bbox tower maps, so the
  paired refine and cls gather reads C = feat + 6 channels (262 at the
  shipped width);
* LSHead's init -> cross-level deformable refine scheme of the bbox task.

Modules run in NCHW; the returned maps are NHWC like the JAX head's.
Submodule names are the flax names, for :mod:`lsnet_torch.weights`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.corner_pool import POOLS
from ...ops.flat_deform import TRAIN_SAMPLING
from ..layers import (ConvModule, DCNConvModule, PairedPyramidDeformConv,
                      nchw, nhwc)
from .ls_head import (LSHead, branch_pyramid_jobs, dcn_base_offset,
                      signed_from_pairs)


class CornerPoolPack(nn.Module):
    """Two directional cummax pools of ``corner_dim`` channels, a 3x3
    conv + GN back to ``dim``, a residual 1x1 conv + GN of the input,
    ReLU, then a ConvModule."""

    def __init__(self, in_channels: int, dim: int, pool_modes: Sequence[str],
                 first_kernel_size: int = 3, kernel_size: int = 1,
                 corner_dim: int = 64, norm_groups: int = 32):
        super().__init__()
        norm = dict(type="GN", num_groups=norm_groups)
        self.pool_modes = tuple(pool_modes)
        self.p1_conv1 = ConvModule(in_channels, corner_dim,
                                   first_kernel_size, norm_cfg=norm)
        self.p2_conv1 = ConvModule(in_channels, corner_dim,
                                   first_kernel_size, norm_cfg=norm)
        self.p_conv1 = nn.Conv2d(corner_dim, dim, 3, padding=1, bias=False)
        self.p_gn1 = nn.GroupNorm(32, dim, eps=1e-5)
        self.conv1 = nn.Conv2d(in_channels, dim, 1, bias=False)
        self.gn1 = nn.GroupNorm(32, dim, eps=1e-5)
        self.conv2 = ConvModule(dim, dim, kernel_size, norm_cfg=norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, second = (POOLS[m] for m in self.pool_modes)
        pooled = (nchw(first(nhwc(self.p1_conv1(x))))
                  + nchw(second(nhwc(self.p2_conv1(x)))))
        p = self.p_gn1(self.p_conv1(pooled))
        r = self.gn1(self.conv1(x))
        return self.conv2(F.relu(p + r))


class LSCPVHead(nn.Module):
    """The CPV head; ``forward(feats, sampling)`` returns per-level NHWC
    ``cls``, ``bbox_init``, ``bbox_refine``, ``hem_score`` (2: TL, BR),
    ``hem_offset`` (4) and ``sem_score`` maps. The towers and
    ``shared_convs_*`` sample at site "tower", the paired refine and cls
    gather at "refine"."""

    # LSHead's tower runner and its 1x1 fuse + 3x3 skip + GN tail
    _tower = LSHead._tower
    _fuse = LSHead._fuse

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, shared_stacked_convs: int = 1,
                 first_kernel_size: int = 3, kernel_size: int = 1,
                 corner_dim: int = 64, num_kernel_points: int = 9,
                 gradient_mul: float = 0.1, conv_module_type: str = "norm",
                 norm_groups: int = 32, offset_scale_compat: bool = True):
        super().__init__()
        if conv_module_type not in ("norm", "dcn"):
            raise ValueError(f"conv_module_type={conv_module_type!r}")
        self.gradient_mul = gradient_mul
        self.offset_scale_compat = offset_scale_compat
        self.dcn_kernel = math.isqrt(num_kernel_points)
        self.stacked_convs = stacked_convs
        self.shared_stacked_convs = shared_stacked_convs
        fc, pf, ng = feat_channels, point_feat_channels, norm_groups
        norm = dict(type="GN", num_groups=ng)

        def block(cin, k):
            if conv_module_type == "norm":
                return ConvModule(cin, fc, 3, norm_cfg=norm)
            return DCNConvModule(cin, fc, k, num_groups=ng)

        for prefix in ("cls", "bbox"):
            for i in range(stacked_convs):
                setattr(self, f"{prefix}_convs_{i}",
                        block(in_channels if i == 0 else fc,
                              self.dcn_kernel))
        for i in range(shared_stacked_convs):
            setattr(self, f"shared_convs_{i}", block(fc, 3))
        for corner, modes in (("tl", ("top", "left")),
                              ("br", ("bottom", "right"))):
            setattr(self, f"hem_{corner}", CornerPoolPack(
                fc, fc, modes, first_kernel_size, kernel_size, corner_dim,
                ng))
            setattr(self, f"hem_{corner}_score_out",
                    nn.Conv2d(fc, 1, 3, padding=1))
            setattr(self, f"hem_{corner}_offset_out",
                    nn.Conv2d(fc, 2, 3, padding=1))
        self.pts_bbox_cls_pair = PairedPyramidDeformConv(
            fc + 6, fc + 6, pf, pf, self.dcn_kernel)
        self.pts_cls_out = nn.Conv2d(pf, num_classes, 1)
        self.pts_bbox_init_conv = nn.Conv2d(fc, pf, 3, padding=1)
        self.pts_bbox_init_out = nn.Conv2d(
            pf, 4 * 5 + (num_kernel_points - 5) * 2, 1)
        self.pts_bbox_refine_out = nn.Conv2d(pf, 20, 1)
        self.sem_out = nn.Conv2d(fc, num_classes, 1)
        self.sem_embedding = ConvModule(fc, fc, 1, norm_cfg=norm)
        for key in ("cls", "bbox"):
            setattr(self, f"{key}_af_dcn_conv", nn.Conv2d(3 * pf, pf, 1))
            setattr(self, f"{key}_feat_conv",
                    nn.Conv2d(fc + 6, pf, 3, padding=1))
            setattr(self, f"{key}_GN", nn.GroupNorm(ng, pf, eps=1e-5))
        self.register_buffer("base_offset", torch.from_numpy(
            dcn_base_offset(self.dcn_kernel)), persistent=False)

    def _shared(self, feats: List[torch.Tensor],
                sampling: Mapping[str, str]) -> List[torch.Tensor]:
        cur = feats
        for i in range(self.shared_stacked_convs):
            blk = getattr(self, f"shared_convs_{i}")
            cur = blk(cur, sampling) if isinstance(blk, DCNConvModule) \
                else [blk(f) for f in cur]
        return cur

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Dict[str, List[torch.Tensor]]:
        """NCHW level maps -> the per-level NHWC output maps."""
        n = len(feats)
        cls_t = self._tower("cls", list(feats), sampling)
        bbox_t = self._tower("bbox", list(feats), sampling)
        shared_t = self._shared(bbox_t, sampling)
        outs: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("cls", "bbox_init", "bbox_refine", "hem_score",
                            "hem_offset", "sem_score")}
        cls_feats, bbox_feats, dcn_offs = [], [], []
        g = self.gradient_mul
        for cf, bf, sf in zip(cls_t, bbox_t, shared_t):
            outs["sem_score"].append(nhwc(self.sem_out(sf)))
            sem_feat = self.sem_embedding(sf)
            cf, bf, hf = cf + sem_feat, bf + sem_feat, sf + sem_feat
            tl, br = self.hem_tl(hf), self.hem_br(hf)
            score = torch.cat([self.hem_tl_score_out(tl),
                               self.hem_br_score_out(br)], dim=1)
            offset = torch.cat([self.hem_tl_offset_out(tl),
                                self.hem_br_offset_out(br)], dim=1)
            outs["hem_score"].append(nhwc(score))
            outs["hem_offset"].append(nhwc(offset))
            raw = nhwc(self.pts_bbox_init_out(F.relu(
                self.pts_bbox_init_conv(bf))))
            init_sp = F.softplus(raw[..., :20])
            pred_reg = torch.cat([signed_from_pairs(init_sp), raw[..., 20:]],
                                 dim=-1)
            mixed = (1.0 - g) * pred_reg.detach() + g * pred_reg
            dcn_offs.append(mixed - self.base_offset.to(bf.dtype))
            outs["bbox_init"].append(init_sp)
            cls_feats.append(torch.cat([cf, score, offset], dim=1))
            bbox_feats.append(torch.cat([bf, score, offset], dim=1))
        jobs = branch_pyramid_jobs([tuple(f.shape[-2:]) for f in feats],
                                   dcn_offs, self.dcn_kernel,
                                   self.offset_scale_compat)
        bbox_raws, cls_raws = self.pts_bbox_cls_pair(
            [nhwc(f) for f in bbox_feats], [nhwc(f) for f in cls_feats],
            jobs, sampling)
        for lvl in range(n):
            refine = nhwc(self._fuse("bbox", bbox_raws[3 * lvl:3 * lvl + 3],
                                     bbox_feats[lvl],
                                     self.pts_bbox_refine_out))
            outs["bbox_refine"].append(F.softplus(
                refine + outs["bbox_init"][lvl].detach()))
            outs["cls"].append(nhwc(self._fuse(
                "cls", cls_raws[3 * lvl:3 * lvl + 3], cls_feats[lvl],
                self.pts_cls_out)))
        return outs
