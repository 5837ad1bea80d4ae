"""ResNet / ResNeXt / Res2Net backbone (counterpart of
``lsnet_tpu/models/backbones/resnet.py``).

'pytorch' style (stride on the 3x3 conv; stage ``strides`` 1, 2, 2, 2 and
``dilations`` 1 by default), FrozenBatchNorm, optional DCNv2 on the 3x3
convs of the stages in ``stage_with_dcn`` (bottleneck depths, sampling
site "backbone"), ``frozen_stages`` (those parameters take no gradient)
and ``out_indices``. As in the JAX package, the first block of every stage
has a projection shortcut and the widths scale with ``base_channels``
(64: the stem's width and the first stage's planes).
``block_type="resnext"`` gives the bottleneck ``groups`` and
``base_width`` (conv2 width ``int(planes * (base_width / base_channels))
* groups``): conv2 is a grouped DCN in the DCN stages and a
``GroupedConv`` elsewhere. ``stage_with_sac`` (DetectoRS' backbones)
makes conv2 of those stages' bottlenecks an ``SAConv`` (Switchable
Atrous Convolution, grouped in a ResNeXt), outside the DCN stages.
``block_type="res2net"`` gives the Res2Net
bottle2neck (``scales``, ``base_width``; 3x3 width ``floor(planes *
(base_width / base_channels))``) and ``deep_stem`` the v1d stem of three
3x3 convs. ``with_cp`` (the configs' activation checkpointing, ``remat``
in the JAX package) runs each residual block under
``torch.utils.checkpoint`` while training with gradients on: its
activations are recomputed in the backward instead of kept; the numbers
are the same.
"""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.flat_deform import TRAIN_SAMPLING
from ..layers import (FrozenBatchNorm, GroupedConv, ModulatedDeformConvPack,
                      SAConv)

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv(cin, cout, k, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2 * dilation,
                     dilation=dilation, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes)
        self.downsample = downsample

    def forward(self, x, sampling: Mapping[str, str] = TRAIN_SAMPLING):
        """``sampling`` is unused: the block has no deformable conv."""
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, use_dcn: bool = False,
                 groups: int = 1, base_width: int = 4,
                 base_channels: int = 64, dilation: int = 1,
                 use_sac: bool = False):
        super().__init__()
        width = (planes if groups == 1
                 else int(planes * (base_width / base_channels)) * groups)
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.use_dcn = use_dcn
        if use_dcn:
            self.conv2 = ModulatedDeformConvPack(
                width, width, 3, stride=stride, padding=dilation,
                dilation=dilation, groups=groups, use_bias=False,
                site="backbone")
        elif use_sac:
            self.conv2 = SAConv(width, width, 3, stride, dilation, groups)
        elif groups > 1:
            self.conv2 = GroupedConv(width, width, 3, stride, dilation,
                                     groups=groups)
        else:
            self.conv2 = _conv(width, width, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, planes * self.expansion, 1)
        self.bn3 = FrozenBatchNorm(planes * self.expansion)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * self.expansion,
                                         1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * self.expansion)
        self.downsample = downsample

    def forward(self, x, sampling: Mapping[str, str] = TRAIN_SAMPLING):
        out = F.relu(self.bn1(self.conv1(x)))
        out = (self.conv2(out, sampling) if self.use_dcn
               else self.conv2(out))
        out = F.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class Res2Bottleneck(nn.Module):
    """Res2Net bottle2neck (JAX ``Res2Bottleneck``): conv1 gives ``scales``
    slices of ``width`` channels; the 3x3 runs as ``scales - 1``
    hierarchical convs ``conv2_{i}`` / ``bn2_{i}``, slice i after slice
    i - 1's output is added to it, except in the first block of a stage
    (``stage_type="stage"``), where every slice is independent and the
    last one is average-pooled (3x3, the block's stride, padding 1,
    padded taps counted as JAX's ``nn.avg_pool`` counts them). The
    shortcut of the first block is an average pool of the stride, then
    the 1x1 ``downsample_conv`` / ``downsample_bn``. In the DCN stages
    each ``conv2_{i}`` is a DCNv2 pack (site "backbone"): three K1 calls
    a block, each on a channel slice of conv1's output, which
    ``flat_deform.pack_levels`` copies into its contiguous row buffer."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, use_dcn: bool = False,
                 scales: int = 4, base_width: int = 26,
                 base_channels: int = 64, dilation: int = 1,
                 stage_type: str = "normal"):
        super().__init__()
        width = int(math.floor(planes * (base_width / base_channels)))
        self.width, self.scales, self.stride = width, scales, stride
        self.use_dcn, self.stage_type = use_dcn, stage_type
        self.conv1 = _conv(inplanes, width * scales, 1)
        self.bn1 = FrozenBatchNorm(width * scales)
        for i in range(scales - 1):
            setattr(self, f"conv2_{i}", ModulatedDeformConvPack(
                width, width, 3, stride=stride, padding=dilation,
                dilation=dilation, use_bias=False, site="backbone")
                if use_dcn else _conv(width, width, 3, stride, dilation))
            setattr(self, f"bn2_{i}", FrozenBatchNorm(width))
        self.conv3 = _conv(width * scales, planes * self.expansion, 1)
        self.bn3 = FrozenBatchNorm(planes * self.expansion)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * self.expansion,
                                         1)
            self.downsample_bn = FrozenBatchNorm(planes * self.expansion)
        self.downsample = downsample

    def forward(self, x, sampling: Mapping[str, str] = TRAIN_SAMPLING):
        out = F.relu(self.bn1(self.conv1(x)))
        spx = torch.split(out, self.width, dim=1)
        outs: List[torch.Tensor] = []
        for i in range(self.scales - 1):
            inp = (spx[i] if i == 0 or self.stage_type == "stage"
                   else outs[-1] + spx[i])
            conv = getattr(self, f"conv2_{i}")
            sp = conv(inp, sampling) if self.use_dcn else conv(inp)
            outs.append(F.relu(getattr(self, f"bn2_{i}")(sp)))
        if self.stage_type == "normal" and self.stride == 1:
            outs.append(spx[-1])
        else:
            outs.append(F.avg_pool2d(spx[-1], 3, self.stride, 1))
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        identity = x
        if self.downsample:
            if self.stride != 1:
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


class ResNet(nn.Module):

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 frozen_stages: int = -1,
                 stage_with_dcn: Sequence[bool] = (False, False, False,
                                                   False),
                 stage_with_sac: Sequence[bool] = (False, False, False,
                                                   False),
                 block_type: str = "resnet", groups: int = 1,
                 base_width: int = 4, scales: int = 4,
                 base_channels: int = 64, deep_stem: bool = False,
                 with_cp: bool = False):
        super().__init__()
        self.with_cp = with_cp
        if block_type not in ("resnet", "resnext", "res2net"):
            raise NotImplementedError(f"block_type {block_type!r}")
        kind, stage_blocks = ARCH_SETTINGS[depth]
        groups = groups if block_type == "resnext" else 1
        self.out_indices = tuple(out_indices)
        self.deep_stem = deep_stem
        if deep_stem:       # v1d: 3x3/2 (C/2) -> 3x3 (C/2) -> 3x3 (C)
            half = base_channels // 2
            for i, (cin, cout, stride) in enumerate(
                    ((3, half, 2), (half, half, 1),
                     (half, base_channels, 1)), 1):
                setattr(self, f"stem_conv{i}", _conv(cin, cout, 3, stride))
                setattr(self, f"stem_bn{i}", FrozenBatchNorm(cout))
        else:
            self.conv1 = _conv(3, base_channels, 7, 2)
            self.bn1 = FrozenBatchNorm(base_channels)
        self.stage_names = []
        self.out_channels = []
        inplanes = planes = base_channels
        for si, nblocks in enumerate(stage_blocks[:num_stages]):
            names = []
            for bi in range(nblocks):
                name = f"layer{si + 1}_{bi}"
                stride = strides[si] if bi == 0 else 1
                dilation = dilations[si]
                if kind == "basic":
                    if stage_with_dcn[si]:
                        raise NotImplementedError("DCN in a BasicBlock")
                    block = BasicBlock(inplanes, planes, stride, bi == 0,
                                       dilation)
                elif block_type == "res2net":
                    block = Res2Bottleneck(
                        inplanes, planes, stride, bi == 0,
                        stage_with_dcn[si], scales, base_width,
                        base_channels, dilation,
                        "stage" if bi == 0 else "normal")
                else:
                    block = Bottleneck(inplanes, planes, stride, bi == 0,
                                       stage_with_dcn[si], groups,
                                       base_width, base_channels, dilation,
                                       stage_with_sac[si])
                setattr(self, name, block)
                inplanes = planes * block.expansion
                names.append(name)
            self.stage_names.append(names)
            if si in self.out_indices:
                self.out_channels.append(inplanes)
            planes *= 2
        self._freeze_stages(frozen_stages)

    def stem(self) -> List[nn.Module]:
        """The stem's convs and norms, in order."""
        if self.deep_stem:
            return [getattr(self, f"stem_{kind}{i}") for i in (1, 2, 3)
                    for kind in ("conv", "bn")]
        return [self.conv1, self.bn1]

    def _freeze_stages(self, frozen_stages: int) -> None:
        """The parameters of ``frozen_param_paths`` (JAX
        ``frozen_param_paths``: the stem, then stages 1..frozen_stages)
        take no gradient."""
        if frozen_stages < 0:
            return
        frozen = self.stem() + [
            getattr(self, n) for names in self.stage_names[:frozen_stages]
            for n in names]
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, ...]:
        stem = self.stem()
        for conv, bn in zip(stem[::2], stem[1::2]):
            x = F.relu(bn(conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        remat = self.with_cp and self.training and torch.is_grad_enabled()
        for si, names in enumerate(self.stage_names):
            for n in names:
                block = getattr(self, n)
                x = (checkpoint(block, x, sampling, use_reentrant=False)
                     if remat else block(x, sampling))
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)
