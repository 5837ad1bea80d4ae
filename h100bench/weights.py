"""Weights of a benchmark run, minted on the device from the seed.

One draw of N(0, 1) for every parameter of the reference's module tree
(a CUDA generator seeded with ``--seed``), each tensor then scaled by the
rule of its kind, so that activations keep their scale through the
depth, every layer's contribution reaches the head's maps, and the
scores spread as a trained detector's do:

* convolutions (OIHW) and deformable weights (HWIO): He normal over
  fan-in, ``sqrt(2 / fan_in)``;
* ``conv_offset`` of a DCNv2: ``1 / sqrt(fan_in)``, offsets and mask
  logits of about one pixel and one unit; in the backbone the offsets'
  rows are ``BACKBONE_OFFSET_PX`` times that, offsets of about a
  twentieth of a pixel. The backbone samples its nearest tap at
  inference, and an offset near a half pixel rounds to one tap in
  bfloat16 and to the other in float32: at a pixel's scale the X-101
  head's maps part from the reference's by 15-18 % in bfloat16 and by
  20-25 % under the fp8 control (H100), the flips and not the
  precision. Offsets of a twentieth never come near a half, so the check
  sees the precision and not the rounding's edge; a wrong rounding
  (a floor for a round) still moves every negative offset's tap. The
  published initialisation sets these rows to zero;
* FrozenBatchNorm and GroupNorm scales ``1 + 0.1 z``; the last norm of a
  residual branch (``bn3``) ``0.2 (1 + 0.1 z)``, so the residual stream
  grows by some 4 % a block and not by half; their shifts ``0.1 z``;
* convolution biases 0, the classifier's at the focal prior
  ``-log(99)`` (a score of 0.01).

The statistics of FrozenBatchNorm are mean 0 and variance 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .reference.model import (FrozenBatchNorm, ModulatedDeformConvPack,
                              PairedPyramidDeformConv)

PRIOR_BIAS = -math.log(99.0)
BACKBONE_OFFSET_PX = 0.05


def _scale(module: nn.Module, mname: str, pname: str,
           shape) -> tuple:
    """(multiplier of z, added constant) of one parameter."""
    if isinstance(module, (FrozenBatchNorm, nn.GroupNorm)):
        if pname == "bias":
            return 0.1, 0.0
        gain = 0.2 if mname.endswith("bn3") else 1.0
        return 0.1 * gain, gain
    if isinstance(module, (ModulatedDeformConvPack,
                           PairedPyramidDeformConv)):
        if pname == "bias":
            return 0.0, 0.0
        kh, kw, cg = shape[:3]
        return math.sqrt(2.0 / (kh * kw * cg)), 0.0
    if isinstance(module, nn.Conv2d):
        if pname == "bias":
            return 0.0, (PRIOR_BIAS if mname.endswith("pts_cls_out")
                         else 0.0)
        fan_in = math.prod(shape[1:])
        if not mname.endswith("conv_offset"):
            return math.sqrt(2.0 / fan_in), 0.0
        mul = torch.full((shape[0], 1, 1, 1), math.sqrt(1.0 / fan_in))
        if mname.startswith("backbone."):      # rows: 2K offsets, K masks
            mul[:shape[0] * 2 // 3] *= BACKBONE_OFFSET_PX
        return mul, 0.0
    raise ValueError(f"no minting rule for {mname}.{pname}")


def mint(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (parameters and buffers, float32, on ``device``)
    of ``model``'s tree for ``seed``."""
    owners = [(mname, pname, m, p) for mname, m in model.named_modules()
              for pname, p in m.named_parameters(recurse=False)]
    total = sum(p.numel() for *_, p in owners)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 63)
    z = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    start = 0
    for mname, pname, m, p in owners:
        n = p.numel()
        mul, add = _scale(m, mname, pname, tuple(p.shape))
        if isinstance(mul, torch.Tensor):
            mul = mul.to(device)
        out[f"{mname}.{pname}"] = z[start:start + n].view(p.shape) * mul + add
        start += n
    for name, b in model.named_buffers():
        out[name] = (torch.zeros if name.endswith("mean") else torch.ones)(
            b.shape, device=device)
    return out
