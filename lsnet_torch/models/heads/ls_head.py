"""LSHead (counterpart of ``lsnet_tpu/models/heads/ls_head.py``), the
location-sensitive dense head for the four tasks ``bbox``, ``segm``,
``pose_bbox`` and ``pose_kbox``.

Per FPN level, a two-stage regressor:

  stage 1: conv towers (DCNv2+GN+ReLU blocks or plain conv+GN+ReLU) ->
    init landmark head -> softplus -> signed sampling field -> DCN offsets;
  stage 2: three cross-level pyramid deformable gathers per level, shared
    by the task's main refine branch and the cls branch (one corner table,
    two contractions; ``pose_bbox``'s second regression branch, bbox, runs
    its own gather) -> 1x1 fuse + 3x3 skip -> GN -> ReLU -> output conv;
    refine = softplus(out + init).

A landmark field has 4 slots per point (``num_vectors`` points and the
centre): bbox 4 extremes, segm 36 contour points, pose 17 keypoints.

The reference quirk the JAX package keeps as ``offset_scale_compat=True``
(the default here too) is reproduced: the offset field is scaled in place
across the 3-level loop, so the scale compounds (published checkpoints
were trained so); ``offset_scale_compat=False`` scales each job once.
Channel layout per landmark point: ``[y-, y+, x-, x+]``. Modules run in
NCHW; the returned maps are NHWC like the JAX head's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING, SampleJob
from ..layers import (ConvModule, DCNConvModule, PairedPyramidDeformConv,
                      PyramidDeformConv, nchw, nhwc)

# towers of each task: cls first, then its regression branches
TASK_BRANCHES = {"bbox": ("cls", "bbox"), "segm": ("cls", "segm"),
                 "pose_bbox": ("cls", "bbox", "pose"),
                 "pose_kbox": ("cls", "pose")}
# the branch whose refine gather is paired with cls, and whose refined
# landmarks decode reads
MAIN_BRANCH = {"bbox": "bbox", "segm": "segm", "pose_bbox": "pose",
               "pose_kbox": "pose"}


def level_list(lvl: int, num_levels: int) -> List[int]:
    """Source levels of output level ``lvl`` (the reference's order)."""
    if lvl == 0:
        return [0, 1, 2]
    if lvl == num_levels - 1:
        return [lvl, lvl - 1, lvl - 2]
    return [lvl, lvl - 1, lvl + 1]


def branch_pyramid_jobs(feat_shapes: Sequence[Tuple[int, int]],
                        dcn_offs: Sequence[torch.Tensor],
                        dcn_kernel: int,
                        offset_scale_compat: bool = True
                        ) -> List[SampleJob]:
    """All cross-level jobs of a refine branch in (out_lvl, src) order, 3
    per output level. With ``offset_scale_compat`` the offset scale
    compounds across them (the reference's in-place scaling); without it
    each job scales the level's own offsets once. feat_shapes: per-level
    (H, W); dcn_offs NHWC."""
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
            src = off if offset_scale_compat else dcn_offs[lvl]
            o2 = src.reshape(*src.shape[:-1], -1, 2)
            scaled = (o2 * torch.tensor([scale_h, scale_w], dtype=src.dtype,
                                        device=src.device)
                      ).reshape(src.shape)
            if offset_scale_compat:
                off = scaled
            jobs.append(SampleJob(level, scaled, None, (scale_h, scale_w),
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


def vectors2bbox(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts (..., 4*(nv+1)) -> (vectors (..., 2*nv) xy-interleaved, bbox
    (..., 4) their extent) in stride units; the final centre group is
    dropped."""
    signed = signed_from_pairs(pts[..., :-4])
    yx = signed.reshape(*signed.shape[:-1], -1, 2)
    ys = yx[..., 0]
    xs = yx[..., 1]
    bbox = torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)],
                       dim=-1)
    vectors = torch.stack([xs, ys], dim=-1).reshape(*ys.shape[:-1], -1)
    return vectors, bbox


class LSHead(nn.Module):
    """One head for the four tasks. Every task has a ``cls`` tower and one
    tower per regression branch of ``TASK_BRANCHES``; each regression
    branch ``key`` owns ``pts_{key}_init_conv/_init_out/_refine_out``,
    ``{key}_af_dcn_conv``, ``{key}_feat_conv`` and ``{key}_GN``. The main
    branch (``MAIN_BRANCH``) shares its offset field with cls in
    ``pts_{main}_cls_pair``; ``pose_bbox``'s bbox branch refines through its
    own ``pts_bbox_refine_conv``."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_kernel_points: int = 9,
                 gradient_mul: float = 0.1, task: str = "bbox",
                 num_vectors: int = 4, conv_module_type: str = "norm",
                 norm_groups: int = 32, offset_scale_compat: bool = True):
        super().__init__()
        if task not in TASK_BRANCHES:
            raise ValueError(f"LSHead task {task!r}: want one of "
                             f"{sorted(TASK_BRANCHES)}")
        if conv_module_type not in ("norm", "dcn"):
            raise ValueError(f"conv_module_type={conv_module_type!r}")
        self.task = task
        self.main = MAIN_BRANCH[task]
        self.num_vectors = num_vectors
        self.num_kernel_points = num_kernel_points
        self.gradient_mul = gradient_mul
        self.offset_scale_compat = offset_scale_compat
        self.dcn_kernel = math.isqrt(num_kernel_points)
        self.stacked_convs = stacked_convs
        pf = point_feat_channels
        ng = norm_groups
        if self.main != "bbox" and \
                len(self._landmark_groups()) != num_kernel_points - 1:
            raise ValueError(
                f"task {task!r} with num_vectors={num_vectors} gives "
                f"{len(self._landmark_groups())} sampling points, the "
                f"{num_kernel_points}-point kernel needs "
                f"{num_kernel_points - 1} and the centre")
        for prefix in TASK_BRANCHES[task]:
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                if conv_module_type == "norm":
                    blk = ConvModule(cin, feat_channels, 3,
                                     norm_cfg=dict(type="GN", num_groups=ng))
                else:
                    blk = DCNConvModule(cin, feat_channels, self.dcn_kernel,
                                        num_groups=ng)
                setattr(self, f"{prefix}_convs_{i}", blk)
        for key in TASK_BRANCHES[task]:
            if key != "cls":
                init_dim, refine_dim = self._branch_dims(key)
                setattr(self, f"pts_{key}_init_conv",
                        nn.Conv2d(feat_channels, pf, 3, padding=1))
                setattr(self, f"pts_{key}_init_out",
                        nn.Conv2d(pf, init_dim, 1))
                setattr(self, f"pts_{key}_refine_out",
                        nn.Conv2d(pf, refine_dim, 1))
            setattr(self, f"{key}_af_dcn_conv", nn.Conv2d(3 * pf, pf, 1))
            setattr(self, f"{key}_feat_conv",
                    nn.Conv2d(feat_channels, pf, 3, padding=1))
            setattr(self, f"{key}_GN", nn.GroupNorm(ng, pf, eps=1e-5))
        if task == "pose_bbox":
            self.pts_bbox_refine_conv = PyramidDeformConv(
                feat_channels, pf, self.dcn_kernel)
        setattr(self, f"pts_{self.main}_cls_pair", PairedPyramidDeformConv(
            feat_channels, feat_channels, pf, pf, self.dcn_kernel))
        self.pts_cls_out = nn.Conv2d(pf, num_classes, 1)
        self.register_buffer("base_offset", torch.from_numpy(
            dcn_base_offset(self.dcn_kernel)), persistent=False)

    def _branch_dims(self, key: str) -> Tuple[int, int]:
        """(init, refine) output channels of regression branch ``key``: the
        bbox branch has 5 four-slot points, plus the K - 5 extra sampling
        points as raw [y, x] in its init head; the others nv + 1 four-slot
        points in both."""
        if key == "bbox":
            return 4 * 5 + (self.num_kernel_points - 5) * 2, 4 * 5
        d = 4 * (self.num_vectors + 1)
        return d, d

    def _landmark_groups(self) -> range:
        """Which of the nv landmark groups of a segm / pose branch become
        sampling points: every ceil(nv / (K-1))-th contour point, every
        second keypoint from the second on."""
        nv = self.num_vectors
        if self.task == "segm":
            return range(0, nv, math.ceil(nv / (self.num_kernel_points - 1)))
        return range(1, nv, 2)

    def _tower(self, prefix: str, feats: List[torch.Tensor],
               sampling: Mapping[str, str]) -> List[torch.Tensor]:
        cur = list(feats)
        for i in range(self.stacked_convs):
            blk = getattr(self, f"{prefix}_convs_{i}")
            cur = blk(cur, sampling) if isinstance(blk, DCNConvModule) \
                else [blk(f) for f in cur]
        return cur

    def _get_pred_reg(self, raw_reg1: torch.Tensor,
                      raw_reg2: Optional[torch.Tensor]) -> torch.Tensor:
        """Signed 2K-channel sampling field (NHWC). bbox branch: 5 signed
        points + the raw extra points ``raw_reg2``; segm / pose
        (``raw_reg2`` None): the landmark groups subsampled to K - 1 points,
        then the centre group."""
        if raw_reg2 is not None:
            return torch.cat([signed_from_pairs(raw_reg1), raw_reg2], dim=-1)
        groups = raw_reg1.reshape(*raw_reg1.shape[:-1], -1, 4)
        sel = list(self._landmark_groups()) + [groups.shape[-2] - 1]
        return signed_from_pairs(
            groups[..., sel, :].reshape(*raw_reg1.shape[:-1], -1))

    def _init_branch(self, key: str, feat: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW tower map -> (init_sp NHWC, dcn offset NHWC (…, 2K)). The
        bbox branch softpluses its 20 four-slot channels and keeps the rest
        raw; the others softplus every channel."""
        raw = nhwc(getattr(self, f"pts_{key}_init_out")(F.relu(
            getattr(self, f"pts_{key}_init_conv")(feat))))
        if key == "bbox":
            init_sp = F.softplus(raw[..., :20])
            pred_reg = self._get_pred_reg(init_sp, raw[..., 20:])
        else:
            init_sp = F.softplus(raw)
            pred_reg = self._get_pred_reg(init_sp, None)
        g = self.gradient_mul
        mixed = (1.0 - g) * pred_reg.detach() + g * pred_reg
        return init_sp, mixed - self.base_offset.to(feat.dtype)

    def _fuse(self, key: str, raws: Sequence[torch.Tensor],
              skip_feat: torch.Tensor, out_conv: nn.Module) -> torch.Tensor:
        """Three NHWC gather outputs of one level + the tower map (NCHW)
        -> the branch's output map (NCHW)."""
        x = F.relu(getattr(self, f"{key}_af_dcn_conv")(
            torch.cat([nchw(r) for r in raws], dim=1)))
        x = getattr(self, f"{key}_GN")(
            x + getattr(self, f"{key}_feat_conv")(skip_feat))
        return out_conv(F.relu(x))

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Dict[str, List[torch.Tensor]]:
        """NCHW level maps -> {"cls", "{key}_init", "{key}_refine" for each
        regression branch of the task}: per-level NHWC maps. The towers
        sample at site "tower", the refine and cls gathers at "refine"."""
        n = len(feats)
        towers = {key: self._tower(key, list(feats), sampling)
                  for key in TASK_BRANCHES[self.task]}
        shapes = [tuple(f.shape[-2:]) for f in feats]
        init_sps, jobs = {}, {}
        for key in TASK_BRANCHES[self.task][1:]:
            pairs = [self._init_branch(key, f) for f in towers[key]]
            init_sps[key] = [p[0] for p in pairs]
            jobs[key] = branch_pyramid_jobs(shapes, [p[1] for p in pairs],
                                            self.dcn_kernel,
                                            self.offset_scale_compat)
        # the main branch and cls share one offset field: one corner
        # table, two contractions
        main = self.main
        raws = {}
        raws[main], raws["cls"] = getattr(self, f"pts_{main}_cls_pair")(
            [nhwc(f) for f in towers[main]],
            [nhwc(f) for f in towers["cls"]], jobs[main], sampling)
        if self.task == "pose_bbox":
            raws["bbox"] = self.pts_bbox_refine_conv(
                [nhwc(f) for f in towers["bbox"]], jobs["bbox"], sampling)
        outs: Dict[str, List[torch.Tensor]] = {"cls": []}
        for key in TASK_BRANCHES[self.task][1:]:
            out_conv = getattr(self, f"pts_{key}_refine_out")
            outs[f"{key}_init"] = init_sps[key]
            outs[f"{key}_refine"] = [
                F.softplus(nhwc(self._fuse(
                    key, raws[key][3 * lvl:3 * lvl + 3], towers[key][lvl],
                    out_conv)) + init_sps[key][lvl].detach())
                for lvl in range(n)]
        for lvl in range(n):
            outs["cls"].append(nhwc(self._fuse(
                "cls", raws["cls"][3 * lvl:3 * lvl + 3], towers["cls"][lvl],
                self.pts_cls_out)))
        return outs
