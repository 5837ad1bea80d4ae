"""SSD's VGG-16 backbone (counterpart of ``SSDVGG`` in
``lsnet_tpu/models/backbones/extra.py``; that file's RegNet and
HourglassNet are not ported).

NCHW in, six NCHW maps out; submodule and parameter names are the flax
ones (``conv{s}_{i}``, ``fc6``, ``fc7``, ``extra{i}_{1,2}``,
``l2_norm_scale_param``).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING

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
