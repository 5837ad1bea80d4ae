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
with a sibling ``nn.Conv2d`` ``convN``, ``conv`` or ``X_conv``; the
module types are read from the state dict's keys, so a checkpoint fuses
without its model. A
deformable pack beside a BN is not an ``nn.Conv2d`` and is skipped, as
JAX skips a pair without a ``kernel``. The rule knows neither the deep
stem's ``stem_bnN`` nor Res2Net's ``bn2_i``: those stay unfused, as in
JAX.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


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
    """Fold every FrozenBatchNorm of ``model`` into its conv, in place
    (:func:`fuse_state_dict` on its state dict). Returns the fused BNs as
    JAX names them (``/backbone/layer1_0/bn1``), in module order."""
    state, fused = fuse_state_dict(model.state_dict(), epsilon)
    model.load_state_dict(state)
    return fused


_BN_KEYS = {"weight", "bias", "mean", "var"}


@torch.no_grad()
def fuse_state_dict(state: Dict[str, torch.Tensor], epsilon: float = 1e-5
                    ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The fused copy of a model's ``state_dict`` (a checkpoint's, with no
    config needed) and the fused BNs' names.

    The module types are read from the keys: a FrozenBatchNorm is a module
    whose entries are exactly weight, bias, mean and var; an ``nn.Conv2d``
    one whose entries are a 4-d weight and perhaps a bias (a deformable
    pack has ``conv_offset`` entries too, and is skipped)."""
    leaves: Dict[str, Dict[str, str]] = {}
    for key in state:
        mod, _, leaf = key.rpartition(".")
        leaves.setdefault(mod, {})[leaf] = key
    prefixes = set()
    for mod in leaves:
        parts = mod.split(".")
        prefixes.update(".".join(parts[:i]) for i in range(1, len(parts)))
    children: Dict[str, set] = {}
    for mod in set(leaves) | prefixes:
        parent, _, key = mod.rpartition(".")
        children.setdefault(parent, set()).add(key)
    out = dict(state)
    fused: List[str] = []
    for mod, bn in leaves.items():
        if set(bn) != _BN_KEYS or mod in prefixes:
            continue
        parent, _, key = mod.rpartition(".")
        conv_key = _conv_key_for(key, children[parent])
        if conv_key is None:
            continue
        conv = leaves.get(f"{parent}.{conv_key}" if parent else conv_key, {})
        if (f"{parent}.{conv_key}" in prefixes or "weight" not in conv
                or not set(conv) <= {"weight", "bias"}
                or state[conv["weight"]].dim() != 4):
            continue
        mean = state[bn["mean"]].double()
        factor = state[bn["weight"]].double() / torch.sqrt(
            state[bn["var"]].double() + epsilon)
        conv_b = 0.0
        if "bias" in conv:
            conv_b = state[conv["bias"]].double()
            out[conv["bias"]] = torch.zeros_like(state[conv["bias"]])
        w = state[conv["weight"]]
        out[conv["weight"]] = (w.double() * factor.view(-1, 1, 1, 1)).to(
            w.dtype)
        out[bn["bias"]] = ((conv_b - mean) * factor
                           + state[bn["bias"]].double()).to(
                               state[bn["bias"]].dtype)
        out[bn["weight"]] = torch.full_like(state[bn["weight"]],
                                            (1.0 + epsilon) ** 0.5)
        out[bn["mean"]] = torch.zeros_like(state[bn["mean"]])
        out[bn["var"]] = torch.ones_like(state[bn["var"]])
        fused.append("/" + "/".join(mod.split(".")))
    return out, fused
