"""RegNet, HourglassNet and SSD's VGG-16 (counterparts of ``RegNet``,
``HourglassModule``, ``HourglassNet`` and ``SSDVGG`` in
``lsnet_tpu/models/backbones/extra.py``).

NCHW in, NCHW maps out; submodule and parameter names are the flax ones
(RegNet's ``conv1`` / ``bn1`` and ``layer{s}_{b}`` with ``conv1`` ...
``bn3``, ``downsample_conv`` / ``downsample_bn``; the hourglass's
``stem_conv1`` / ``stem_bn1`` / ``stem_res``, ``hg{s}`` with ``up1_{i}``,
``low1_{i}``, ``low2`` (the next module) or ``low2_{i}``, ``low3_{i}``,
and ``out{s}_conv`` / ``_bn``, ``remap{s}_a`` / ``_abn`` / ``_b`` /
``_bbn``, ``inter{s}``; VGG's ``conv{s}_{i}``, ``fc6``, ``fc7``,
``extra{i}_{1,2}``, ``l2_norm_scale_param``).
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING
from ..layers import FrozenBatchNorm
from ..necks.fpn import upsample_nearest_to
from .resnet import BasicBlock, _conv

# VGG-16's five stages: (3x3 convs, width)
VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
# SSD300's extra layers: (1x1 squeeze width, 3x3 width, stride of the
# 3x3; 0 = unpadded stride 1)
SSD300_EXTRAS = ((256, 512, 2), (128, 256, 2), (128, 256, 0), (128, 256, 0))
# the L2 norm's per-channel scale at init (JAX's ``build_backbone`` drops
# the file's ``l2_norm_scale``, 20 as well)
L2_NORM_SCALE = 20.0


class SSDVGG(nn.Module):
    """The VGG-16 conv stack with SSD's changes: conv4_3's output
    L2-normalised over channels (the norm in f32, + 1e-10) and scaled by a
    learned per-channel ``l2_norm_scale_param`` (L2_NORM_SCALE at init),
    ceil-mode 2x2 pools (JAX pads the bottom / right edge by its own
    values, then pools: the same maxima), pool5 3x3 stride 1, fc6 (3x3,
    dilation 6) and fc7 (1x1), both 1024 wide, then four (1x1, 3x3) extra
    pairs, the last two unpadded. Returns conv4_3*, fc7 and the four
    extras' outputs: 38, 19, 10, 5, 3 and 1 px a side at 300x300. Only
    VGG-16 is built."""

    out_channels = (512, 1024, 512, 256, 256, 256)

    def __init__(self, depth: int = 16):
        super().__init__()
        if depth != 16:
            raise NotImplementedError(f"SSDVGG depth {depth}: VGG-16 only")
        cin = 3
        for s, (n, ch) in enumerate(VGG16_STAGES):
            for i in range(n):
                setattr(self, f"conv{s + 1}_{i + 1}",
                        nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.l2_norm_scale_param = nn.Parameter(
            torch.full((VGG16_STAGES[3][1],), L2_NORM_SCALE))
        self.fc6 = nn.Conv2d(cin, 1024, 3, padding=6, dilation=6)
        self.fc7 = nn.Conv2d(1024, 1024, 1)
        cin = 1024
        for i, (c1, c2, stride) in enumerate(SSD300_EXTRAS):
            setattr(self, f"extra{i}_1", nn.Conv2d(cin, c1, 1))
            setattr(self, f"extra{i}_2", nn.Conv2d(
                c1, c2, 3, stride=max(stride, 1), padding=1 if stride else 0))
            cin = c2

    def forward(self, x: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, ...]:
        outs = []
        for s, (n, _) in enumerate(VGG16_STAGES):
            for i in range(n):
                x = F.relu(getattr(self, f"conv{s + 1}_{i + 1}")(x))
            if s == 3:
                xf = x.float()
                norm = xf.pow(2).sum(1, keepdim=True).sqrt() + 1e-10
                outs.append((xf / norm * self.l2_norm_scale_param.view(
                    1, -1, 1, 1)).to(x.dtype))
            if s < 4:
                x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            else:
                x = F.max_pool2d(x, 3, 1, padding=1)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        outs.append(x)
        for i in range(len(SSD300_EXTRAS)):
            x = F.relu(getattr(self, f"extra{i}_1")(x))
            x = F.relu(getattr(self, f"extra{i}_2")(x))
            outs.append(x)
        return tuple(outs)


# ---------------------------------------------------------------- RegNet

def regnet_widths(w0: float, wa: float, wm: float, depth: int,
                  group_width: int):
    """The quantised linear width rule (the RegNet paper, the reference's
    ``generate_regnet``), as JAX's ``regnet_widths``: (stage widths,
    blocks a stage)."""
    ws_cont = w0 + wa * np.arange(depth)
    ks = np.round(np.log(ws_cont / w0) / np.log(wm))
    ws = w0 * np.power(wm, ks)
    ws = np.round(ws / 8) * 8
    ws = [int(min(w, group_width * max(1, round(w / group_width))))
          for w in ws]
    ws = [int(max(group_width, round(w / group_width) * group_width))
          for w in ws]
    widths, stages = [], []
    for w in ws:
        if not widths or widths[-1] != w:
            widths.append(w)
            stages.append(1)
        else:
            stages[-1] += 1
    return widths, stages


def freeze_before(module: nn.Module, prefixes: Sequence[str],
                  frozen_stages: int) -> None:
    """``requires_grad=False`` on the parameters whose names start with
    one of ``prefixes``, where ``frozen_stages`` >= 0."""
    if frozen_stages < 0:
        return
    for n, p in module.named_parameters():
        if n.startswith(tuple(prefixes)):
            p.requires_grad_(False)


class RegBottleneck(nn.Module):
    """1x1 -> grouped 3x3 (``groups = max(1, width // group_width)``, the
    stride) -> 1x1, each with BN, ReLU after the first two and after the
    sum; a projection shortcut where the stride or the width changes."""

    def __init__(self, inplanes: int, width: int, stride: int,
                 group_width: int):
        super().__init__()
        self.conv1 = _conv(inplanes, width, 1)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               groups=max(1, width // group_width),
                               bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = _conv(width, width, 1)
        self.bn3 = FrozenBatchNorm(width)
        self.downsample = stride != 1 or inplanes != width
        if self.downsample:
            self.downsample_conv = _conv(inplanes, width, 1, stride)
            self.downsample_bn = FrozenBatchNorm(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + identity)


class RegNet(nn.Module):
    """RegNetX: ``arch`` is the reference dict (``w0``, ``wa``, ``wm``,
    ``depth``, ``group_w``; other keys are not read); a 3x3 stride-2
    stem of ``stem_channels``, then one stage a width of
    :func:`regnet_widths`, each opening with a stride-2 block.
    ``frozen_stages`` >= 0 stops the gradient after the stem and >= s
    after stage s (JAX's ``stop_gradient`` on the activations); the
    parameters before the last stop are frozen (``requires_grad=False``),
    the prefixes JAX's runner masks (``conv1``, ``bn1``, ``layer{s}_``)."""

    def __init__(self, arch: Mapping[str, float], stem_channels: int = 32,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1):
        super().__init__()
        widths, self.stages = regnet_widths(arch["w0"], arch["wa"],
                                            arch["wm"], arch["depth"],
                                            arch["group_w"])
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.conv1 = _conv(3, stem_channels, 3, 2)
        self.bn1 = FrozenBatchNorm(stem_channels)
        cin = stem_channels
        self.out_channels = []
        for si, (w, d) in enumerate(zip(widths, self.stages)):
            for bi in range(d):
                setattr(self, f"layer{si + 1}_{bi}", RegBottleneck(
                    cin, w, 2 if bi == 0 else 1, arch["group_w"]))
                cin = w
            if si in self.out_indices:
                self.out_channels.append(w)
        freeze_before(self, ["conv1.", "bn1."] + [
            f"layer{s}_" for s in range(1, frozen_stages + 1)],
            frozen_stages)

    def forward(self, x: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, ...]:
        """``sampling`` is unused: RegNet has no deformable conv."""
        x = F.relu(self.bn1(self.conv1(x)))
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for si, d in enumerate(self.stages):
            for bi in range(d):
                x = getattr(self, f"layer{si + 1}_{bi}")(x)
            if self.frozen_stages >= si + 1:
                x = x.detach()
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)


# ------------------------------------------------------------- Hourglass

class HourglassModule(nn.Module):
    """CornerNet's recursive hourglass: ``up1`` (basic blocks at
    ``stage_channels[0]``) beside ``low1`` (a stride-2 basic block, then
    more, at ``stage_channels[1]``), ``low2`` (the next module, or basic
    blocks at the bottom), ``low3`` (back to ``stage_channels[0]``),
    upsampled to ``up1``'s size by the integer source index and added."""

    def __init__(self, in_channels: int, depth: int,
                 stage_channels: Sequence[int], stage_blocks: Sequence[int]):
        super().__init__()
        cur, nxt, n = stage_channels[0], stage_channels[1], stage_blocks[0]
        self.n = n
        cin = in_channels
        for i in range(n):
            setattr(self, f"up1_{i}", BasicBlock(
                cin, cur, downsample=cin != cur and i == 0))
            cin = cur
        cin = in_channels
        for i in range(n):
            setattr(self, f"low1_{i}", BasicBlock(
                cin, nxt, stride=2 if i == 0 else 1, downsample=i == 0))
            cin = nxt
        self.deep = depth > 1
        if self.deep:
            self.low2 = HourglassModule(nxt, depth - 1, stage_channels[1:],
                                        stage_blocks[1:])
        else:
            for i in range(n):
                setattr(self, f"low2_{i}", BasicBlock(nxt, nxt))
        cin = nxt
        for i in range(n):
            setattr(self, f"low3_{i}", BasicBlock(
                cin, cur, downsample=cin != cur and i == 0))
            cin = cur

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = low1 = x
        for i in range(self.n):
            up1 = getattr(self, f"up1_{i}")(up1)
        for i in range(self.n):
            low1 = getattr(self, f"low1_{i}")(low1)
        if self.deep:
            low2 = self.low2(low1)
        else:
            low2 = low1
            for i in range(self.n):
                low2 = getattr(self, f"low2_{i}")(low2)
        low3 = low2
        for i in range(self.n):
            low3 = getattr(self, f"low3_{i}")(low3)
        return up1 + upsample_nearest_to(low3, *up1.shape[-2:])


class HourglassNet(nn.Module):
    """Stacked hourglass (JAX's defaults: CornerNet's HourglassNet-104): a
    7x7 stride-2 stem of 128 and a stride-2 basic block to
    ``stage_channels[0]``, then ``num_stacks`` hourglasses, each followed
    by a 3x3 conv + BN + ReLU of ``feat_channel`` (one output a stack, at
    stride 4) and, between stacks, the remap of the stack's input and
    output (1x1 + BN each, summed, ReLU, a basic block)."""

    def __init__(self, num_stacks: int = 2, downsample_times: int = 5,
                 stage_channels: Sequence[int] = (256, 256, 384, 384, 384,
                                                  512),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 feat_channel: int = 256):
        super().__init__()
        ch0 = stage_channels[0]
        self.num_stacks = num_stacks
        self.stem_conv1 = _conv(3, 128, 7, 2)
        self.stem_bn1 = FrozenBatchNorm(128)
        self.stem_res = BasicBlock(128, ch0, stride=2, downsample=True)
        for s in range(num_stacks):
            setattr(self, f"hg{s}", HourglassModule(
                ch0, downsample_times, stage_channels, stage_blocks))
            setattr(self, f"out{s}_conv", _conv(ch0, feat_channel, 3))
            setattr(self, f"out{s}_bn", FrozenBatchNorm(feat_channel))
            if s < num_stacks - 1:
                setattr(self, f"remap{s}_a", _conv(ch0, ch0, 1))
                setattr(self, f"remap{s}_abn", FrozenBatchNorm(ch0))
                setattr(self, f"remap{s}_b", _conv(feat_channel, ch0, 1))
                setattr(self, f"remap{s}_bbn", FrozenBatchNorm(ch0))
                setattr(self, f"inter{s}", BasicBlock(ch0, ch0))
        self.out_channels = [feat_channel] * num_stacks

    def forward(self, x: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, ...]:
        """``sampling`` is unused: the hourglass has no deformable conv."""
        x = F.relu(self.stem_bn1(self.stem_conv1(x)))
        inter = self.stem_res(x)
        outs = []
        for s in range(self.num_stacks):
            hg = getattr(self, f"hg{s}")(inter)
            feat = F.relu(getattr(self, f"out{s}_bn")(
                getattr(self, f"out{s}_conv")(hg)))
            outs.append(feat)
            if s < self.num_stacks - 1:
                a = getattr(self, f"remap{s}_abn")(
                    getattr(self, f"remap{s}_a")(inter))
                b = getattr(self, f"remap{s}_bbn")(
                    getattr(self, f"remap{s}_b")(feat))
                inter = getattr(self, f"inter{s}")(F.relu(a + b))
        return tuple(outs)
