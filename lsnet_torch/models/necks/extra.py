"""The NAS-FCOS FPN (counterpart of ``_NASFCOSConcatCell`` and
``NASFCOSFPN`` in ``lsnet_tpu/models/necks/extra.py``; that file's other
necks are not ported).

NCHW in and out; submodule names are the flax ones (``adapt_{i}``,
``adapt_bn_{i}``, the cells ``c22_1`` ... ``c61`` with ``input1_conv`` /
``input2_conv`` / ``bn`` / ``out_conv``, ``extra_{k}``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import ConvModule, FrozenBatchNorm
from .fpn import upsample_nearest_to

# the searched DAG: (cell, first input, second input, 3x3 conv on the
# first, on the second); inputs index the adapted levels, then the cells
NASFCOS_CELLS = (("c22_1", 2, 2, True, True), ("c22_2", 2, 2, True, True),
                 ("c32", 3, 2, True, False), ("c02", 0, 2, True, False),
                 ("c42", 4, 2, True, True), ("c36", 3, 6, True, True),
                 ("c61", 6, 1, True, True))
# the outputs: (cell summed with c32's output, input level it resizes to)
NASFCOS_OUTS = ((9, 1), (8, 2), (7, 3))
NASFCOS_FUSED = 5


def bilinear_to(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """``jax.image.resize(method="bilinear")`` of NCHW x to (th, tw):
    half-pixel centres, and, where a side shrinks, JAX's antialiasing
    (the triangle kernel widened by the factor, renormalised at the
    edges): torch's ``antialias=True``, computed in f32 (the CPU has no
    bf16 antialiased resize)."""
    H, W = x.shape[-2:]
    if (H, W) == (th, tw):
        return x
    return F.interpolate(x.float(), size=(th, tw), mode="bilinear",
                         align_corners=False,
                         antialias=th < H or tw < W).to(x.dtype)


class NASFCOSConcatCell(nn.Module):
    """3x3 input convs (conv with bias, norm, ReLU) where asked, both
    inputs resized to the larger (nearest, integer source rows: JAX's
    ``_resize_to`` takes its max-pool branch only for an input larger
    than the target, which the larger of two never is), the block concat
    [x1, x2], then
    FrozenBatchNorm, ReLU and a 1x1 conv with ``groups = channels`` over
    the 2 x channels (group c mixes concat channels 2c and 2c + 1, flax's
    contiguous grouping)."""

    def __init__(self, channels: int, with_input1_conv: bool = True,
                 with_input2_conv: bool = False,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        for i, on in ((1, with_input1_conv), (2, with_input2_conv)):
            if on:
                setattr(self, f"input{i}_conv", ConvModule(
                    channels, channels, 3, norm_cfg=norm_cfg, bias=True))
        self.bn = FrozenBatchNorm(2 * channels)
        self.out_conv = nn.Conv2d(2 * channels, channels, 1, groups=channels,
                                  bias=False)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "input1_conv"):
            x1 = self.input1_conv(x1)
        if hasattr(self, "input2_conv"):
            x2 = self.input2_conv(x2)
        th = max(x1.shape[-2], x2.shape[-2])
        tw = max(x1.shape[-1], x2.shape[-1])
        x = torch.cat([upsample_nearest_to(x1, th, tw),
                       upsample_nearest_to(x2, th, tw)], 1)
        return self.out_conv(F.relu(self.bn(x)))


class NASFCOSFPN(nn.Module):
    """1x1 adapters (no bias) + FrozenBatchNorm + ReLU on the inputs from
    ``start_level``, the seven-cell DAG, three outputs (a cell plus c32's
    output resized to it, bilinear, then resized to the input level's
    size) and stride-2 3x3 extra convs (ReLU before all but the first) up
    to ``num_outs``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 1,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        C = out_channels
        self.start_level = start_level
        used = list(in_channels[start_level:])
        if len(used) != 3:
            raise ValueError(f"NASFCOSFPN: the DAG reads 3 levels, "
                             f"{len(used)} from start_level {start_level}")
        for i, c in enumerate(used):
            setattr(self, f"adapt_{i}", nn.Conv2d(c, C, 1, bias=False))
            setattr(self, f"adapt_bn_{i}", FrozenBatchNorm(C))
        for name, _, _, w1, w2 in NASFCOS_CELLS:
            setattr(self, name, NASFCOSConcatCell(C, w1, w2, norm_cfg))
        self.n_extra = num_outs - len(NASFCOS_OUTS)
        for k in range(self.n_extra):
            setattr(self, f"extra_{k}", nn.Conv2d(C, C, 3, stride=2,
                                                  padding=1))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        feats = [F.relu(getattr(self, f"adapt_bn_{i}")(
            getattr(self, f"adapt_{i}")(f)))
            for i, f in enumerate(inputs[self.start_level:])]
        for name, i1, i2, _, _ in NASFCOS_CELLS:
            feats.append(getattr(self, name)(feats[i1], feats[i2]))
        fused = feats[NASFCOS_FUSED]
        ret = []
        for idx, input_idx in NASFCOS_OUTS:
            f1 = feats[idx]
            s = f1 + bilinear_to(fused, *f1.shape[-2:])
            ret.append(bilinear_to(s, *inputs[input_idx].shape[-2:]))
        x = ret[-1]
        for k in range(self.n_extra):
            if k > 0:
                x = F.relu(x)
            x = getattr(self, f"extra_{k}")(x)
            ret.append(x)
        return tuple(ret)
