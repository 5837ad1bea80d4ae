"""The necks past the FPN (counterparts of ``lsnet_tpu/models/necks/
extra.py``): PAFPN, BFP, NAS-FPN (``_resize_to``, ``_SumCell``,
``_GPCell``), the NAS-FCOS FPN, HRFPN, FPN_CARAFE and DetectoRS'
recursive feature pyramid.

NCHW in and out; submodule names are the flax ones (PAFPN's ``fpn``,
``downsample_{i}``, ``pafpn_conv_{i}``; BFP's ``refine``; NAS-FPN's
``lateral_{i}``, ``extra_{k}`` and the cells ``s{s}_gp_64_4`` ...
``s{s}_gp_75_6`` with ``out_conv``; NAS-FCOS's ``adapt_{i}``,
``adapt_bn_{i}``, the cells ``c22_1`` ... ``c61`` with ``input1_conv`` /
``input2_conv`` / ``bn`` / ``out_conv``, ``extra_{k}``; HRFPN's
``reduction``, ``fpn_{i}``; FPN_CARAFE's ``lateral_{i}``,
``up_comp_{i}``, ``up_enc_{i}``, ``fpn_{i}``; RFP's ``fpn``,
``fpn_step{s}``, ``rfp_agg_s{s}_{i}``, ``rfp_gate_s{s}_{i}``). Where
the JAX modules depart from mmdet's, these follow JAX (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.misc import carafe
from ..layers import ConvModule, FrozenBatchNorm, nchw, nhwc
from .fpn import FPN, upsample_nearest_to

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


class RFP(nn.Module):
    """DetectoRS' Recursive Feature Pyramid as the JAX package builds it
    (``lsnet_tpu/models/necks/extra.py:265-310``): the reference feeds the
    FPN's outputs back into the backbone's stages; JAX, and so the port,
    unrolls the recursion at the neck. An FPN ``fpn`` (extra levels by
    convs on the last input); then, for each of the ``rfp_steps - 1``
    further steps s, each used input plus ``rfp_agg_s{s}_{i}`` (1x1 to the
    input's width, with bias) of output i, a second FPN ``fpn_step{s+1}``
    on those, and each level mixed by a gate, sigmoid(``rfp_gate_s{s}_{i}``
    (1x1 to one channel) of the new output): gate x new + (1 - gate) x
    old. NCHW in and out."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, rfp_steps: int = 2, start_level: int = 0,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        self.in_channels = list(in_channels)
        self.start_level, self.rfp_steps = start_level, rfp_steps
        self.n_used = len(self.in_channels) - start_level

        def fpn():
            return FPN(self.in_channels, out_channels, num_outs, start_level,
                       add_extra_convs="on_input", norm_cfg=norm_cfg)
        self.fpn = fpn()
        for s in range(rfp_steps - 1):
            for i in range(self.n_used):
                setattr(self, f"rfp_agg_s{s}_{i}", ConvModule(
                    out_channels, self.in_channels[start_level + i], 1,
                    act=None))
            setattr(self, f"fpn_step{s + 1}", fpn())
            for i in range(num_outs):
                setattr(self, f"rfp_gate_s{s}_{i}", ConvModule(
                    out_channels, 1, 1, act=None))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        outs = self.fpn(inputs)
        for s in range(self.rfp_steps - 1):
            fed = list(inputs)
            for i in range(self.n_used):
                j = self.start_level + i
                fed[j] = inputs[j] + getattr(self, f"rfp_agg_s{s}_{i}")(
                    outs[i])
            new = getattr(self, f"fpn_step{s + 1}")(fed)
            fused = []
            for i, (o, n) in enumerate(zip(outs, new)):
                gate = torch.sigmoid(getattr(self, f"rfp_gate_s{s}_{i}")(n))
                fused.append(gate * n + (1 - gate) * o)
            outs = tuple(fused)
        return outs


class PAFPN(nn.Module):
    """PANet: an FPN ``fpn``, then a bottom-up path over all its
    ``num_outs`` outputs, the extra levels included (JAX's; mmdet's runs
    it over the backbone's levels and pools the extra levels after it):
    out_0 is the FPN's first output, and out_i = ``pafpn_conv_{i}``(fpn_i
    + ``downsample_{i}``(out_{i-1}) cropped to fpn_i's size), where JAX
    downsamples the previous output (mmdet the previous sum). The
    downsample is a stride-2 3x3 ConvModule, both without activation."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 add_extra_convs: Optional[str] = None,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        self.fpn = FPN(in_channels, out_channels, num_outs, start_level,
                       add_extra_convs, norm_cfg)
        self.num_outs = num_outs
        for i in range(1, num_outs):
            setattr(self, f"downsample_{i}", ConvModule(
                out_channels, out_channels, 3, stride=2, norm_cfg=norm_cfg,
                act=None))
            setattr(self, f"pafpn_conv_{i}", ConvModule(
                out_channels, out_channels, 3, norm_cfg=norm_cfg, act=None))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        fpn_outs = self.fpn(inputs)
        outs = [fpn_outs[0]]
        for i in range(1, len(fpn_outs)):
            h, w = fpn_outs[i].shape[-2:]
            down = getattr(self, f"downsample_{i}")(outs[-1])[..., :h, :w]
            outs.append(getattr(self, f"pafpn_conv_{i}")(fpn_outs[i] + down))
        return tuple(outs)


def _max_pool_by_ratio(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """flax's VALID ``max_pool`` of size and stride (H // h, W // w), each
    at least 1, cropped to (h, w): BFP's rescale of a larger level."""
    sh = max(x.shape[-2] // h, 1)
    sw = max(x.shape[-1] // w, 1)
    return F.max_pool2d(x, (sh, sw), (sh, sw))[..., :h, :w]


class BFP(nn.Module):
    """Balanced Feature Pyramid (Libra R-CNN): every level rescaled to
    level ``refine_level``'s size (larger ones by ``_max_pool_by_ratio``,
    smaller ones by the nearest upsample's integer source index), their
    mean refined by a 3x3 ConvModule ``refine`` where ``refine_type`` is
    ``"conv"`` (JAX takes ``None`` or ``"conv"``; any other value, mmdet's
    ``"non_local"`` too, refines nothing), then rescaled back to each
    level and added to it. Every level has ``out_channels`` channels
    (``in_channels``, the builder's, is not read)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 refine_level: int = 2, refine_type: Optional[str] = "conv"):
        super().__init__()
        self.refine_level = refine_level
        self.refine_type = refine_type
        if refine_type == "conv":
            self.refine = ConvModule(out_channels, out_channels, 3, act=None)

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        ref_h, ref_w = inputs[self.refine_level].shape[-2:]
        gathered = []
        for i, x in enumerate(inputs):
            if i < self.refine_level:
                x = _max_pool_by_ratio(x, ref_h, ref_w)
            elif i > self.refine_level:
                x = upsample_nearest_to(x, ref_h, ref_w)
            gathered.append(x)
        bsf = sum(gathered) / len(gathered)
        if self.refine_type == "conv":
            bsf = self.refine(bsf)
        outs = []
        for i, x in enumerate(inputs):
            h, w = x.shape[-2:]
            if i < self.refine_level:
                r = upsample_nearest_to(bsf, h, w)
            elif i > self.refine_level:
                r = _max_pool_by_ratio(bsf, h, w)
            else:
                r = bsf
            outs.append(x + r)
        return tuple(outs)


def resize_to(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """JAX's ``_resize_to`` (nearest): x itself at (th, tw); the nearest
    upsample by the integer source index where either side is smaller
    than the target; else a VALID max pool of size and stride H // th on
    both axes (the ratio from H alone; JAX crops nothing, so a W ratio
    that differs gives another width)."""
    H, W = x.shape[-2:]
    if (H, W) == (th, tw):
        return x
    if H < th or W < tw:
        return upsample_nearest_to(x, th, tw)
    k = H // th
    return F.max_pool2d(x, k, k)


class SumCell(nn.Module):
    """NAS-FPN's sum cell: both inputs resized to the output size and
    added, then (``with_out_conv``) ReLU and a 3x3 ConvModule
    ``out_conv`` with the norm and no activation (mmdet's
    ``out_conv_order=('act', 'conv', 'norm')``)."""

    def __init__(self, channels: int, norm_cfg: Optional[dict] = None,
                 with_out_conv: bool = True):
        super().__init__()
        if with_out_conv:
            self.out_conv = ConvModule(channels, channels, 3,
                                       norm_cfg=norm_cfg, act=None)

    def merge(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return x1 + x2

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                out_hw: Tuple[int, int]) -> torch.Tensor:
        x = self.merge(resize_to(x1, *out_hw), resize_to(x2, *out_hw))
        if hasattr(self, "out_conv"):
            x = self.out_conv(F.relu(x))
        return x


class GPCell(SumCell):
    """NAS-FPN's global-pooling cell: x2 + sigmoid(mean of x2 over H, W)
    x x1, then the sum cell's ``out_conv`` where it has one."""

    def merge(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return x2 + torch.sigmoid(x2.mean(dim=(2, 3), keepdim=True)) * x1


# NAS-FPN's searched stage: (cell, kind, first input, second input,
# output size's level, whether it has out_conv, the level it writes)
NASFPN_CELLS = (("gp_64_4", GPCell, "p6", "p4", "p4", True, "p4_1"),
                ("sum_44_4", SumCell, "p4_1", "p4", "p4", True, "p4_2"),
                ("sum_43_3", SumCell, "p4_2", "p3", "p3", True, "p3"),
                ("sum_34_4", SumCell, "p3", "p4_2", "p4", True, "p4"),
                ("gp_43_5", GPCell, "p4", "p3", "p5", False, "p5_tmp"),
                ("sum_55_5", SumCell, "p5", "p5_tmp", "p5", True, "p5"),
                ("gp_54_7", GPCell, "p5", "p4_2", "p7", False, "p7_tmp"),
                ("sum_77_7", SumCell, "p7", "p7_tmp", "p7", True, "p7"),
                ("gp_75_6", GPCell, "p7", "p5", "p6", True, "p6"))


class NASFPN(nn.Module):
    """NAS-FPN: 1x1 ConvModule laterals ``lateral_{i}`` (norm, no
    activation) of the inputs from ``start_level``, extra levels up to
    ``num_outs`` = 5 by a 1x1 ConvModule ``extra_{k}`` on the last level
    then a 2x2 stride-2 max pool, then ``stack_times`` stages of the
    searched cells (``NASFPN_CELLS``), each writing its level in turn at
    the size of its output level. Returns (p3, p4, p5, p6, p7).
    ``norm_cfg=BN`` is a FrozenBatchNorm, as in JAX (mmdet trains that
    BN)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, stack_times: int = 7,
                 start_level: int = 0, norm_cfg: Optional[dict] = None):
        super().__init__()
        used = list(in_channels[start_level:])
        self.start_level, self.stack_times = start_level, stack_times
        self.n_extra = num_outs - len(used)
        for i, c in enumerate(used):
            setattr(self, f"lateral_{i}", ConvModule(
                c, out_channels, 1, norm_cfg=norm_cfg, act=None))
        for k in range(self.n_extra):
            setattr(self, f"extra_{k}", ConvModule(
                out_channels, out_channels, 1, norm_cfg=norm_cfg, act=None))
        for s in range(stack_times):
            for name, kind, _, _, _, conv, _ in NASFPN_CELLS:
                setattr(self, f"s{s}_{name}", kind(
                    out_channels, norm_cfg, with_out_conv=conv))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        feats = [getattr(self, f"lateral_{i}")(f)
                 for i, f in enumerate(inputs[self.start_level:])]
        for k in range(self.n_extra):
            feats.append(F.max_pool2d(getattr(self, f"extra_{k}")(
                feats[-1]), 2, 2))
        p = dict(zip(("p3", "p4", "p5", "p6", "p7"), feats))
        for s in range(self.stack_times):
            for name, _, a, b, size, _, out in NASFPN_CELLS:
                p[out] = getattr(self, f"s{s}_{name}")(
                    p[a], p[b], tuple(p[size].shape[-2:]))
        return tuple(p[k] for k in ("p3", "p4", "p5", "p6", "p7"))


class HRFPN(nn.Module):
    """HRNet's pyramid: every input resized to the first's size
    (``bilinear_to``, JAX's ``jax.image.resize``), concatenated, reduced
    by the 1x1 ConvModule ``reduction``, pooled to ``num_outs`` levels
    (VALID 2^i x 2^i average pools, max pools for ``pooling_type="MAX"``),
    and a 3x3 ConvModule ``fpn_{i}`` on each; no norm, no activation."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, pooling_type: str = "AVG"):
        super().__init__()
        self.num_outs, self.pooling_type = num_outs, pooling_type
        self.reduction = ConvModule(sum(in_channels), out_channels, 1,
                                    act=None)
        for i in range(num_outs):
            setattr(self, f"fpn_{i}", ConvModule(out_channels, out_channels,
                                                 3, act=None))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        th, tw = inputs[0].shape[-2:]
        out = self.reduction(torch.cat(
            [inputs[0]] + [bilinear_to(x, th, tw) for x in inputs[1:]], 1))
        pool = F.max_pool2d if self.pooling_type == "MAX" else F.avg_pool2d
        levels = [out] + [pool(out, 2 ** i, 2 ** i)
                          for i in range(1, self.num_outs)]
        return tuple(getattr(self, f"fpn_{i}")(lv)
                     for i, lv in enumerate(levels))


class FPNCarafe(nn.Module):
    """FPN whose top-down path upsamples by CARAFE: at each step down, the
    upper lateral x predicts its reassembly kernels (``up_comp_{i}``, a 1x1
    ConvModule to ``compressed_channels``, then ``up_enc_{i}``, an
    ``encoder_kernel`` ConvModule to 4 G k^2, both with bias and no
    activation), softmaxed over each sub-pixel's G k^2 values, and
    ``ops.misc.carafe`` upsamples x by 2; the lower lateral adds its
    crop. Then a 3x3 ``fpn_{i}`` on each level and 2x2 stride-2 max pools
    up to ``num_outs``.

    The encoder's channel c = (2 dy + dx) G k^2 + j is kernel value j of
    sub-pixel (dy, dx): JAX's reshape to (B, H, W, 2, 2, G k^2) and
    interleave into (B, 2H, 2W, G k^2), not ``F.pixel_shuffle``'s order
    (channel j 4 + 2 dy + dx), and not mmdet's (its encoder's output goes
    through ``pixel_shuffle``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0, up_kernel: int = 5,
                 up_group: int = 1, encoder_kernel: int = 3,
                 compressed_channels: int = 64,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        used = list(in_channels[start_level:])
        self.start_level, self.n_used = start_level, len(used)
        self.num_outs = num_outs
        self.up_kernel, self.up_group = up_kernel, up_group
        for i, c in enumerate(used):
            setattr(self, f"lateral_{i}", ConvModule(
                c, out_channels, 1, norm_cfg=norm_cfg, act=None))
            setattr(self, f"fpn_{i}", ConvModule(
                out_channels, out_channels, 3, norm_cfg=norm_cfg, act=None))
        for i in range(1, len(used)):
            setattr(self, f"up_comp_{i}", ConvModule(
                out_channels, compressed_channels, 1, act=None))
            setattr(self, f"up_enc_{i}", ConvModule(
                compressed_channels, 4 * up_group * up_kernel ** 2,
                encoder_kernel, act=None))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        used = inputs[self.start_level:]
        laterals = [getattr(self, f"lateral_{i}")(f)
                    for i, f in enumerate(used)]
        gk2 = self.up_group * self.up_kernel ** 2
        for i in range(self.n_used - 1, 0, -1):
            x = laterals[i]
            enc = getattr(self, f"up_enc_{i}")(
                getattr(self, f"up_comp_{i}")(x))
            B, _, H, W = enc.shape
            masks = torch.softmax(enc.view(B, 2, 2, gk2, H, W), dim=3)
            # (B, dy, dx, GK2, H, W) -> (B, H, dy, W, dx, GK2)
            masks = masks.permute(0, 4, 1, 5, 2, 3).reshape(
                B, 2 * H, 2 * W, gk2)
            up = nchw(carafe(nhwc(x), masks, self.up_kernel, self.up_group,
                             2))
            th, tw = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[..., :th, :tw]
        outs = [getattr(self, f"fpn_{i}")(lat)
                for i, lat in enumerate(laterals)]
        while len(outs) < self.num_outs:
            outs.append(F.max_pool2d(outs[-1], 2, 2))
        return tuple(outs)
