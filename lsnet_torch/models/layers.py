"""Shared building blocks (counterpart of ``lsnet_tpu/models/layers.py``).

Modules take and return NCHW tensors and hold ``nn.Conv2d`` weights in
OIHW; the deformable layers hold their weight in HWIO, the layout of the
``ops`` functions, and hand NHWC views of their inputs to
:mod:`lsnet_torch.ops.flat_deform`. Submodule and parameter names follow
the flax modules so that :mod:`lsnet_torch.weights` maps one tree onto
the other. Every deformable layer has a sampling ``site`` ("backbone",
"tower" or "refine") and takes its mode at call time from a ``sampling``
mapping (``flat_deform.TRAIN_SAMPLING`` unless the caller passes another,
such as ``flat_deform.INFERENCE_SAMPLING``).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flat_deform import (TRAIN_SAMPLING, SampleJob, dual_pyramid_dcn,
                               multilevel_modulated_dcn,
                               multilevel_pyramid_dcn, refine_taps)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always normalises with the stored running statistics
    (the reference's ``norm_eval=True``); ``weight`` is flax's ``scale``."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + 1e-5) * self.weight
        shift = self.bias - self.mean * inv
        return (x * inv.view(1, -1, 1, 1)
                + shift.view(1, -1, 1, 1)).to(x.dtype)


def make_norm(norm_cfg: Optional[dict], channels: int) -> Optional[nn.Module]:
    if norm_cfg is None:
        return None
    kind = norm_cfg["type"]
    if kind == "GN":
        return nn.GroupNorm(norm_cfg.get("num_groups", 32), channels,
                            eps=1e-5)
    if kind in ("BN", "SyncBN", "FrozenBN"):
        return FrozenBatchNorm(channels)
    raise ValueError(f"unknown norm type {kind}")


class ConvModule(nn.Module):
    """conv -> norm -> activation; the conv has a bias where ``bias`` says
    so, by default only where no norm follows (flax's ``bias="auto"``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 norm_cfg: Optional[dict] = None, act: Optional[str] = "relu",
                 bias: Optional[bool] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              bias=norm_cfg is None if bias is None
                              else bias)
        self.norm = make_norm(norm_cfg, out_channels)
        if act not in (None, "relu"):
            raise ValueError(f"unknown act {act}")
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act == "relu":
            x = F.relu(x)
        return x


class ModulatedDeformConvPack(nn.Module):
    """DCNv2 'pack': ``conv_offset`` predicts (offset, mask) from the input.

    Takes one map or a list of maps (FPN levels); a list runs as one flat
    multi-level sampling call, one kernel launch. With ``groups`` > 1 (the
    ResNeXt backbone DCN) the weight is the compact (k, k, cin/G, cout)
    with group-major cout; ``conv_offset`` stays ungrouped."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 site: str = "tower"):
        super().__init__()
        K = kernel_size * kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.site = site
        self.conv_offset = nn.Conv2d(in_channels, 3 * K, kernel_size,
                                     stride=stride, padding=padding,
                                     dilation=dilation)
        self.weight = nn.Parameter(torch.zeros(
            kernel_size, kernel_size, in_channels // groups, out_channels))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, x, sampling: Mapping[str, str] = TRAIN_SAMPLING):
        multi = isinstance(x, (list, tuple))
        xs = list(x) if multi else [x]
        offsets, masks = [], []
        for f in xs:
            # the reference chunks into (o1, o2, mask) then cat(o1, o2);
            # o1/o2 are halves of the interleaved [y0,x0,...] layout
            o1, o2, mask = nhwc(self.conv_offset(f)).chunk(3, dim=-1)
            offsets.append(torch.cat([o1, o2], dim=-1))
            masks.append(torch.sigmoid(mask))
        dt = xs[0].dtype
        outs = multilevel_modulated_dcn(
            [nhwc(f) for f in xs], offsets, masks, self.weight.to(dt),
            None if self.bias is None else self.bias.to(dt),
            stride=self.stride, padding=self.padding,
            dilation=self.dilation, groups=self.groups,
            sampling=sampling[self.site])
        outs = [nchw(o) for o in outs]
        return outs if multi else outs[0]


class PyramidDeformConv(nn.Module):
    """Weight holder for the cross-level deformable conv: a whole branch's
    jobs (NHWC) run as one flat call (site "refine", at the mapping's
    refine taps)."""

    site = "refine"

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(
            kernel_size, kernel_size, in_channels, out_channels))

    def forward(self, feats: Sequence[torch.Tensor],
                jobs: Sequence[SampleJob],
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> List[torch.Tensor]:
        return multilevel_pyramid_dcn(list(feats), list(jobs),
                                      self.weight.to(feats[0].dtype),
                                      sampling[self.site],
                                      refine_taps(sampling))


class PairedPyramidDeformConv(nn.Module):
    """Two PyramidDeformConv branches sharing one offset field (the task
    refine and cls branches): one corner table, two contractions (site
    "refine")."""

    site = "refine"

    def __init__(self, in_channels_a: int, in_channels_b: int,
                 out_channels_a: int, out_channels_b: int,
                 kernel_size: int = 3):
        super().__init__()
        k = kernel_size
        self.weight_a = nn.Parameter(torch.zeros(k, k, in_channels_a,
                                                 out_channels_a))
        self.weight_b = nn.Parameter(torch.zeros(k, k, in_channels_b,
                                                 out_channels_b))

    def forward(self, feats_a, feats_b, jobs,
                sampling: Mapping[str, str] = TRAIN_SAMPLING):
        """NHWC level lists and jobs -> two NHWC output lists."""
        return dual_pyramid_dcn(list(feats_a), list(feats_b), jobs,
                                self.weight_a.to(feats_a[0].dtype),
                                self.weight_b.to(feats_b[0].dtype),
                                sampling[self.site], refine_taps(sampling))


class DCNConvModule(nn.Module):
    """DCNv2 + GN + ReLU tower block, list in / list out over levels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, num_groups: int = 32):
        super().__init__()
        self.conv = ModulatedDeformConvPack(in_channels, out_channels,
                                            kernel_size,
                                            padding=(kernel_size - 1) // 2)
        self.bn = nn.GroupNorm(num_groups, out_channels, eps=1e-5)

    def forward(self, x, sampling: Mapping[str, str] = TRAIN_SAMPLING):
        outs = self.conv(x, sampling)
        if isinstance(x, (list, tuple)):
            return [F.relu(self.bn(o)) for o in outs]
        return F.relu(self.bn(outs))


class GroupedConv(nn.Conv2d):
    """Grouped conv (ResNeXt conv2 outside the DCN stages), counterpart of
    ``lsnet_tpu/models/layers.py`` ``GroupedConv``: an ``nn.Conv2d`` with
    ``groups`` whose ``weight`` is flax's compact ``kernel`` (k, k, cin/G,
    cout) in OIHW, group-major cout. The JAX module runs small groups
    (cg <= 8) as a dense block-diagonal conv on the TPU; that is an
    execution policy with the same numbers, which the port leaves out."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 groups: int = 1):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size // 2 * dilation,
                         dilation=dilation, groups=groups, bias=False)
