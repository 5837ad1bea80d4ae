"""ResNet / ResNeXt backbone (counterpart of
``lsnet_tpu/models/backbones/resnet.py``).

'pytorch' style (stride on the 3x3 conv, stage strides 1, 2, 2, 2),
FrozenBatchNorm, optional DCNv2 on conv2 of the stages in
``stage_with_dcn`` (bottleneck depths, sampling site "backbone"),
``frozen_stages`` (those parameters take no gradient) and ``out_indices``.
As in the JAX package, the first block of every stage has a projection
shortcut. ``block_type="resnext"`` gives the bottleneck ``groups`` and
``base_width`` (conv2 width ``int(planes * base_width / 64) * groups``):
conv2 is a grouped DCN in the DCN stages and a ``GroupedConv`` elsewhere.
``with_cp`` (the configs' activation checkpointing, ``remat`` in the JAX
package) runs each residual block under ``torch.utils.checkpoint`` while
training with gradients on: its activations are recomputed in the
backward instead of kept; the numbers are the same. Res2Net comes with a
later slice.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.flat_deform import TRAIN_SAMPLING
from ..layers import FrozenBatchNorm, GroupedConv, ModulatedDeformConvPack

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
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
                 groups: int = 1, base_width: int = 4):
        super().__init__()
        width = (planes if groups == 1
                 else int(planes * base_width / 64) * groups)
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.use_dcn = use_dcn
        if use_dcn:
            self.conv2 = ModulatedDeformConvPack(
                width, width, 3, stride=stride, padding=1, groups=groups,
                use_bias=False, site="backbone")
        elif groups > 1:
            self.conv2 = GroupedConv(width, width, 3, stride, groups=groups)
        else:
            self.conv2 = _conv(width, width, 3, stride)
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


class ResNet(nn.Module):

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1,
                 stage_with_dcn: Sequence[bool] = (False, False, False,
                                                   False),
                 block_type: str = "resnet", groups: int = 1,
                 base_width: int = 4, with_cp: bool = False):
        super().__init__()
        self.with_cp = with_cp
        if block_type not in ("resnet", "resnext"):
            raise NotImplementedError(f"block_type {block_type!r}")
        kind, stage_blocks = ARCH_SETTINGS[depth]
        groups = groups if block_type == "resnext" else 1
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        self.stage_names = []
        self.out_channels = []
        inplanes, planes = 64, 64
        for si, nblocks in enumerate(stage_blocks[:num_stages]):
            names = []
            for bi in range(nblocks):
                name = f"layer{si + 1}_{bi}"
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                if kind == "basic":
                    if stage_with_dcn[si]:
                        raise NotImplementedError("DCN in a BasicBlock")
                    block = BasicBlock(inplanes, planes, stride, bi == 0)
                else:
                    block = Bottleneck(inplanes, planes, stride, bi == 0,
                                       stage_with_dcn[si], groups,
                                       base_width)
                setattr(self, name, block)
                inplanes = planes * block.expansion
                names.append(name)
            self.stage_names.append(names)
            if si in self.out_indices:
                self.out_channels.append(inplanes)
            planes *= 2
        self._freeze_stages(frozen_stages)

    def _freeze_stages(self, frozen_stages: int) -> None:
        if frozen_stages < 0:
            return
        frozen = [self.conv1, self.bn1] + [
            getattr(self, n) for names in self.stage_names[:frozen_stages]
            for n in names]
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
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
