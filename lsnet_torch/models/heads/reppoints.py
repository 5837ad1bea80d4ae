"""RepPoints v1 and v2 heads (counterpart of
``lsnet_tpu/models/heads/reppoints.py``), LSNet's published ancestor and
the template of LSNet-CPV.

Per FPN level: cls and reg conv towers, an init branch predicting K point
offsets (y, x, in stride units), then two deformable 3x3 convs (cls and
refine) that sample at the init points. The offsets reach the sampling
through a straight-through mix, ``g * x + (1 - g) * x.detach()`` with
``g = gradient_mul``, so the points' gradient from the sampling is scaled
by g. The two branches share one offset field, so they run as one paired
gather over the whole pyramid (:class:`PairedPyramidDeformConv`, site
"refine"): one corner table and two K1 contractions per forward. Each
job reads its own level at scale 1, stride 1, with no mask: plain
DeformConv semantics.

v2 adds a shared tower with a semantic branch (``sem_out`` scores,
``sem_embedding`` added to the cls, reg and shared maps) and top-left /
bottom-right corner-pooling branches whose 2 heatmap and 4 offset
channels are concatenated onto the cls and reg maps before the paired
gather (C = feat + 6).

Modules run in NCHW; the returned maps are NHWC like the JAX head's.
Submodule names are the flax names, for :mod:`lsnet_torch.weights`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING, SampleJob
from ..layers import ConvModule, PairedPyramidDeformConv, nchw, nhwc
from .ls_head import dcn_base_offset
from .lscpv_head import CornerPoolPack


class RepPointsHead(nn.Module):
    """``forward(feats, sampling)`` -> per-level NHWC ``cls``,
    ``pts_init`` and ``pts_refine`` (2K channels, (y, x) per point) and
    ``moment`` (2,), the trained log-scale factors of the ``moment``
    transform (zeros for the other transforms)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1, transform_method: str = "moment",
                 moment_mul: float = 0.01, norm_groups: int = 32):
        super().__init__()
        self.num_points = num_points
        self.gradient_mul = gradient_mul
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        self.stacked_convs = stacked_convs
        self.dcn_kernel = math.isqrt(num_points)
        self._towers(in_channels, feat_channels, stacked_convs, norm_groups)
        pf = point_feat_channels
        self.pts_init_conv = nn.Conv2d(feat_channels, pf, 3, padding=1)
        self.pts_init_out = nn.Conv2d(pf, 2 * num_points, 1)
        cin = feat_channels + self.extra_channels
        self.cls_refine_dcn = PairedPyramidDeformConv(cin, cin, pf, pf,
                                                      self.dcn_kernel)
        self.cls_out = nn.Conv2d(pf, num_classes, 1)
        self.pts_refine_out = nn.Conv2d(pf, 2 * num_points, 1)
        if transform_method == "moment":
            self.moment_transfer = nn.Parameter(torch.zeros(2))
        self.register_buffer("base_offset", torch.from_numpy(
            dcn_base_offset(self.dcn_kernel)), persistent=False)

    # channels concatenated onto the tower maps before the paired gather
    extra_channels = 0

    def _towers(self, in_channels, fc, stacked, ng):
        norm = dict(type="GN", num_groups=ng)
        for prefix in ("cls", "reg"):
            for i in range(stacked):
                setattr(self, f"{prefix}_convs_{i}", ConvModule(
                    in_channels if i == 0 else fc, fc, 3, norm_cfg=norm))

    def _tower(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.stacked_convs):
            x = getattr(self, f"{prefix}_convs_{i}")(x)
        return x

    def _level(self, f: torch.Tensor, outs: Dict[str, List[torch.Tensor]]):
        """(cls map, reg map) of one level as the paired gather reads
        them, and the reg map the init branch reads; NCHW."""
        cf, pf = self._tower("cls", f), self._tower("reg", f)
        return cf, pf, pf

    def _moment(self, device) -> torch.Tensor:
        if self.transform_method != "moment":
            return torch.zeros(2, device=device)
        mt = self.moment_transfer
        return mt * self.moment_mul + mt.detach() * (1 - self.moment_mul)

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Dict[str, List[torch.Tensor]]:
        """NCHW level maps -> the per-level NHWC output maps."""
        pad = (self.dcn_kernel - 1) // 2
        g = self.gradient_mul
        outs: Dict[str, List[torch.Tensor]] = {
            k: [] for k in ("cls", "pts_init", "pts_refine")}
        cls_feats, pts_feats, jobs = [], [], []
        for i, f in enumerate(feats):
            cf, pf, reg = self._level(f, outs)
            pts_init = nhwc(self.pts_init_out(F.relu(self.pts_init_conv(
                reg))))
            mix = g * pts_init + (1.0 - g) * pts_init.detach()
            jobs.append(SampleJob(i, (mix - self.base_offset).to(f.dtype),
                                  None, (1.0, 1.0), (1, 1), (pad, pad),
                                  (1, 1)))
            cls_feats.append(nhwc(cf))
            pts_feats.append(nhwc(pf))
            outs["pts_init"].append(pts_init)
        cls_g, ref_g = self.cls_refine_dcn(cls_feats, pts_feats, jobs,
                                           sampling)
        for i in range(len(feats)):
            outs["cls"].append(nhwc(self.cls_out(F.relu(nchw(cls_g[i])))))
            refine = nhwc(self.pts_refine_out(F.relu(nchw(ref_g[i]))))
            outs["pts_refine"].append(refine + outs["pts_init"][i].detach())
        outs["moment"] = self._moment(feats[0].device)
        return outs


class RepPointsV2Head(RepPointsHead):
    """RepPoints v2: v1 plus the shared tower, the semantic branch and the
    corner verification branches. Adds the per-level NHWC outputs
    ``hem_score`` (2: TL, BR), ``hem_offset`` (4) and ``sem_score``."""

    extra_channels = 6

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, shared_stacked_convs: int = 1,
                 first_kernel_size: int = 3, kernel_size: int = 1,
                 corner_dim: int = 64, num_points: int = 9,
                 gradient_mul: float = 0.1, transform_method: str = "moment",
                 moment_mul: float = 0.01, norm_groups: int = 32):
        super().__init__(num_classes, in_channels, feat_channels,
                         point_feat_channels, stacked_convs, num_points,
                         gradient_mul, transform_method, moment_mul,
                         norm_groups)
        fc, ng = feat_channels, norm_groups
        norm = dict(type="GN", num_groups=ng)
        self.shared_stacked_convs = shared_stacked_convs
        for i in range(shared_stacked_convs):
            setattr(self, f"shared_convs_{i}",
                    ConvModule(fc, fc, 3, norm_cfg=norm))
        self.sem_out = nn.Conv2d(fc, num_classes, 1)
        self.sem_embedding = ConvModule(fc, fc, 1, norm_cfg=norm)
        for corner, modes in (("tl", ("top", "left")),
                              ("br", ("bottom", "right"))):
            setattr(self, f"hem_{corner}", CornerPoolPack(
                fc, fc, modes, first_kernel_size, kernel_size, corner_dim,
                ng))
            setattr(self, f"hem_{corner}_score_out",
                    nn.Conv2d(fc, 1, 3, padding=1))
            setattr(self, f"hem_{corner}_offset_out",
                    nn.Conv2d(fc, 2, 3, padding=1))

    def _level(self, f: torch.Tensor, outs: Dict[str, List[torch.Tensor]]):
        cf, pf = self._tower("cls", f), self._tower("reg", f)
        sf = pf
        for i in range(self.shared_stacked_convs):
            sf = getattr(self, f"shared_convs_{i}")(sf)
        outs.setdefault("sem_score", []).append(nhwc(self.sem_out(sf)))
        sem_feat = self.sem_embedding(sf)
        cf, pf, hf = cf + sem_feat, pf + sem_feat, sf + sem_feat
        tl, br = self.hem_tl(hf), self.hem_br(hf)
        score = torch.cat([self.hem_tl_score_out(tl),
                           self.hem_br_score_out(br)], dim=1)
        offset = torch.cat([self.hem_tl_offset_out(tl),
                            self.hem_br_offset_out(br)], dim=1)
        outs.setdefault("hem_score", []).append(nhwc(score))
        outs.setdefault("hem_offset", []).append(nhwc(offset))
        return (torch.cat([cf, score, offset], dim=1),
                torch.cat([pf, score, offset], dim=1), pf)
