"""Fold FrozenBatchNorm into the preceding conv (inference-time fusion;
counterpart of ``lsnet_tpu/train/fuse.py``, the reference's
``tools/fuse_conv_bn.py``).

A frozen BN is an affine map with constant statistics, so it folds into
the conv before it:

    weight' = weight * scale / sqrt(var + eps)            (per out-channel)
    bn'     = a bias add: mean 0, var 1, scale sqrt(1 + eps),
              bias = (conv_bias - mean) * factor + bn_bias

The module tree keeps its structure (the BN stays, as ``x + bias`` up to
one ULP of the rsqrt), so a fused model loads and saves like an unfused
one. Pairing rule (the JAX package's, on the port's module names, which
are flax's): a ``FrozenBatchNorm`` child ``bnN``, ``norm`` or ``X_bn``
with a sibling ``nn.Conv2d`` ``convN``, ``conv`` or ``X_conv``. A
deformable pack beside a BN is not an ``nn.Conv2d`` and is skipped, as
JAX skips a pair without a ``kernel``. The rule knows neither the deep
stem's ``stem_bnN`` nor Res2Net's ``bn2_i``: those stay unfused, as in
JAX.
"""

from __future__ import annotations

import re
from typing import List, Optional

import torch
from torch import nn

from ..models.layers import FrozenBatchNorm


def _conv_key_for(bn_key: str, siblings) -> Optional[str]:
    m = re.fullmatch(r"bn(\d*)", bn_key)
    if m:
        cand = f"conv{m.group(1)}"
    elif bn_key == "norm":
        cand = "conv"
    elif bn_key.endswith("_bn"):
        cand = bn_key[:-3] + "_conv"
    else:
        return None
    return cand if cand in siblings else None


@torch.no_grad()
def fuse_conv_bn(model: nn.Module, epsilon: float = 1e-5) -> List[str]:
    """Fold every FrozenBatchNorm of ``model`` into its conv, in place.
    Returns the fused BNs as JAX names them (``/backbone/layer1_0/bn1``),
    in module order."""
    fused: List[str] = []
    for path, parent in model.named_modules():
        children = dict(parent.named_children())
        for key, bn in children.items():
            if not isinstance(bn, FrozenBatchNorm):
                continue
            conv_key = _conv_key_for(key, children)
            conv = children.get(conv_key)
            if not isinstance(conv, nn.Conv2d):
                continue
            mean = bn.mean.double()
            factor = bn.weight.double() / torch.sqrt(bn.var.double()
                                                     + epsilon)
            conv.weight.copy_(conv.weight.double()
                              * factor.view(-1, 1, 1, 1))
            conv_b = 0.0
            if conv.bias is not None:
                conv_b = conv.bias.double()
                conv.bias.zero_()
            bn.bias.copy_((conv_b - mean) * factor + bn.bias.double())
            bn.weight.fill_((1.0 + epsilon) ** 0.5)
            bn.mean.zero_()
            bn.var.fill_(1.0)
            fused.append("/" + "/".join(filter(None, path.split(".")
                                               + [key])))
    return fused
