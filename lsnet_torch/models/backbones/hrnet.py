"""HRNet (counterpart of ``lsnet_tpu/models/backbones/hrnet.py``).

High-Resolution Net: a stem of two stride-2 3x3 convs, a bottleneck
stage 1, then stages 2-4 of parallel branches at strides 4, 8, 16 and 32
that exchange information through fuse units. Configured by the
mmdet-style ``extra`` dict; HRNetV2p-W32's::

    extra=dict(
        stage1=dict(num_modules=1, num_branches=1, block='BOTTLENECK',
                    num_blocks=(4,), num_channels=(64,)),
        stage2=dict(num_modules=1, num_branches=2, block='BASIC',
                    num_blocks=(4, 4), num_channels=(32, 64)),
        stage3=dict(num_modules=4, num_branches=3, block='BASIC',
                    num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
        stage4=dict(num_modules=3, num_branches=4, block='BASIC',
                    num_blocks=(4, 4, 4, 4),
                    num_channels=(32, 64, 128, 256)))

As in the JAX module, stage 1 is always bottlenecks (of planes
``num_channels[0]``, the first with a projection) and the later stages
basic blocks, whatever ``block`` says. NCHW in, the branches' NCHW maps
out; submodule names are the flax ones (``conv1`` ... ``bn2``,
``layer1_{i}``, ``transition{s}_{b}_conv`` / ``_bn``,
``stage{s}_module{m}`` with ``branch{b}_block{i}``, ``fuse{i}_{j}_conv``
/ ``_bn`` and ``fuse{i}_{j}_d{k}_conv`` / ``_bn``).
"""

from __future__ import annotations

from typing import Any, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING
from ..layers import FrozenBatchNorm
from ..necks.fpn import upsample_nearest_to
from .extra import freeze_before
from .resnet import BasicBlock, Bottleneck, _conv

STAGES = ("stage2", "stage3", "stage4")


class HRModule(nn.Module):
    """Per-branch basic blocks (the first with a projection where the
    width changes), then, for each output branch i, the sum over input
    branches j of: j itself (i == j); a 1x1 conv + BN upsampled to i's
    size by the integer source index (j > i); a chain of i - j stride-2
    3x3 conv + BN, ReLU between them (j < i); then a ReLU. With
    ``multiscale_output=False`` only branch 0 is fused and returned."""

    def __init__(self, in_channels: Sequence[int], num_blocks: Sequence[int],
                 num_channels: Sequence[int],
                 multiscale_output: bool = True):
        super().__init__()
        self.nb = len(num_channels)
        self.num_blocks = tuple(num_blocks)
        self.n_out = self.nb if multiscale_output else 1
        for b, ch in enumerate(num_channels):
            cin = in_channels[b]
            for i in range(num_blocks[b]):
                setattr(self, f"branch{b}_block{i}", BasicBlock(
                    cin, ch, downsample=cin != ch and i == 0))
                cin = ch
        if self.nb == 1:
            return
        for i in range(self.n_out):
            for j in range(self.nb):
                if j > i:
                    setattr(self, f"fuse{i}_{j}_conv",
                            _conv(num_channels[j], num_channels[i], 1))
                    setattr(self, f"fuse{i}_{j}_bn",
                            FrozenBatchNorm(num_channels[i]))
                for k in range(i - j):
                    last = k == i - j - 1
                    cout = num_channels[i] if last else num_channels[j]
                    setattr(self, f"fuse{i}_{j}_d{k}_conv",
                            _conv(num_channels[j], cout, 3, 2))
                    setattr(self, f"fuse{i}_{j}_d{k}_bn",
                            FrozenBatchNorm(cout))

    def forward(self, xs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        feats = []
        for b in range(self.nb):
            x = xs[b]
            for i in range(self.num_blocks[b]):
                x = getattr(self, f"branch{b}_block{i}")(x)
            feats.append(x)
        if self.nb == 1:
            return (feats[0],)
        outs = []
        for i in range(self.n_out):
            acc = None
            for j in range(self.nb):
                y = feats[j]
                if j > i:
                    y = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(y))
                    y = upsample_nearest_to(y, *feats[i].shape[-2:])
                for k in range(i - j):
                    y = getattr(self, f"fuse{i}_{j}_d{k}_bn")(
                        getattr(self, f"fuse{i}_{j}_d{k}_conv")(y))
                    if k < i - j - 1:
                        y = F.relu(y)
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return tuple(outs)


class HRNet(nn.Module):
    """``frozen_stages`` >= 0 stops the gradient after the stem, and >= s
    (2, 3, 4) after stage s, on the activations as JAX's
    ``stop_gradient``; the parameters before the last stop take no
    gradient there, and here are frozen (``requires_grad=False``: no
    update, no weight decay). Stage 1 is never a stop of its own, as in
    JAX."""

    def __init__(self, extra: Mapping[str, Any], frozen_stages: int = -1):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.conv1 = _conv(3, 64, 3, 2)
        self.bn1 = FrozenBatchNorm(64)
        self.conv2 = _conv(64, 64, 3, 2)
        self.bn2 = FrozenBatchNorm(64)
        s1 = dict(extra["stage1"])
        ch1 = s1["num_channels"][0]
        self.n_layer1 = s1["num_blocks"][0]
        cin = 64
        for i in range(self.n_layer1):
            setattr(self, f"layer1_{i}", Bottleneck(cin, ch1,
                                                    downsample=i == 0))
            cin = ch1 * Bottleneck.expansion
        prev = [cin]
        self.stage_cfgs = []
        for stage_i, key in enumerate(STAGES):
            scfg = dict(extra[key])
            nb, chans = scfg["num_branches"], list(scfg["num_channels"])
            adapt = []
            for b in range(nb):
                name = f"transition{stage_i + 2}_{b}"
                if b < len(prev) and prev[b] == chans[b]:
                    adapt.append(False)
                    continue
                stride = 1 if b < len(prev) else 2
                setattr(self, f"{name}_conv", _conv(
                    prev[b] if b < len(prev) else prev[-1], chans[b], 3,
                    stride))
                setattr(self, f"{name}_bn", FrozenBatchNorm(chans[b]))
                adapt.append(True)
            ins = chans
            for m in range(scfg["num_modules"]):
                last = m == scfg["num_modules"] - 1
                multiscale = (True if not last or key != "stage4"
                              else scfg.get("multiscale_output", True))
                setattr(self, f"{key}_module{m}", HRModule(
                    ins, scfg["num_blocks"], chans, multiscale))
                ins = chans if multiscale else chans[:1]
            self.stage_cfgs.append((key, nb, scfg["num_modules"], adapt))
            prev = ins
        self.out_channels = list(prev)
        # the stem, then, from stage 2 on, stage 1 and each stopped
        # stage's transition and modules
        freeze_before(self, ["conv1.", "bn1.", "conv2.", "bn2."] + (
            ["layer1_"] if frozen_stages >= 2 else []) + [
            f"{kind}{s}_" for s in range(2, min(frozen_stages, 4) + 1)
            for kind in ("transition", "stage")], frozen_stages)

    def forward(self, x: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, ...]:
        """``sampling`` is unused: HRNet has no deformable conv."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        if self.frozen_stages >= 0:
            x = x.detach()
        for i in range(self.n_layer1):
            x = getattr(self, f"layer1_{i}")(x)
        xs: List[torch.Tensor] = [x]
        for stage_i, (key, nb, n_modules, adapt) in enumerate(
                self.stage_cfgs):
            new = []
            for b in range(nb):
                if not adapt[b]:
                    new.append(xs[b])
                    continue
                name = f"transition{stage_i + 2}_{b}"
                y = getattr(self, f"{name}_conv")(xs[b] if b < len(xs)
                                                  else xs[-1])
                new.append(F.relu(getattr(self, f"{name}_bn")(y)))
            xs = new
            for m in range(n_modules):
                xs = list(getattr(self, f"{key}_module{m}")(xs))
            if self.frozen_stages >= stage_i + 2:
                xs = [v.detach() for v in xs]
        return tuple(xs)
