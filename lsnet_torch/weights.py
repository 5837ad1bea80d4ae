"""JAX (flax) variables -> a ``state_dict`` of the port's modules.

The port's modules carry the flax module names, so a variable at
``params/head/cls_convs_0/conv/conv_offset/kernel`` becomes
``head.cls_convs_0.conv.conv_offset.weight``. Leaf rules:

* ``kernel`` (an ``nn.Conv2d``): HWIO -> OIHW, renamed ``weight``;
* ``scale`` (GroupNorm, FrozenBatchNorm): renamed ``weight``;
* ``bias``, the deformable layers' HWIO ``weight``/``weight_a``/
  ``weight_b``, the RepPoints heads' ``moment_transfer`` (2,), the dense
  heads' per-level ``scales`` (L,), the Guided Anchoring heads' HWIO
  ``adaption_weight``/``adaption_weight_cls``/``adaption_weight_reg`` and
  SSDVGG's ``l2_norm_scale_param`` (512,): unchanged;
* ``batch_stats`` ``mean``/``var``: the FrozenBatchNorm buffers.

:func:`load_jax_variables` loads strictly: a variable the model does not
have, or a model entry no variable fills, raises.
:func:`to_jax_variables` is the inverse bridge, for laying the port's
parameters, gradients or updated parameters beside the flax trees.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "weight": "weight", "weight_a": "weight_a",
                 "weight_b": "weight_b",
                 "moment_transfer": "moment_transfer", "scales": "scales",
                 "adaption_weight": "adaption_weight",
                 "adaption_weight_cls": "adaption_weight_cls",
                 "adaption_weight_reg": "adaption_weight_reg",
                 "l2_norm_scale_param": "l2_norm_scale_param"}
_STAT_LEAVES = {"mean": "mean", "var": "var"}


def _walk(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_variables(variables: Mapping[str, Any]
                       ) -> "OrderedDict[str, torch.Tensor]":
    """{"params": tree, "batch_stats": tree} of numpy arrays -> state_dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for coll, tree in variables.items():
        rules = {"params": _PARAM_LEAVES,
                 "batch_stats": _STAT_LEAVES}.get(coll)
        if rules is None:
            raise KeyError(f"unknown variable collection {coll!r}")
        for path, leaf in _walk(tree):
            name = rules.get(path[-1])
            if name is None:
                raise KeyError(f"unknown {coll} leaf {'/'.join(path)}")
            t = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if path[-1] == "kernel":
                t = t.permute(3, 2, 0, 1)
            key = ".".join(path[:-1] + (name,))
            if key in sd:
                raise KeyError(f"two variables map to {key}")
            sd[key] = t.contiguous()
    return sd


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any]
                       ) -> Dict[str, Any]:
    """Load flax variables into ``model`` (strict: raises on an unused or
    missing key, or a shape mismatch)."""
    return model.load_state_dict(from_jax_variables(variables), strict=True)


def to_jax_variables(model: nn.Module,
                     tensors: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, Dict[str, Any]]:
    """The inverse of :func:`from_jax_variables`: ``tensors`` keyed like
    ``model.state_dict()`` (by default the state dict itself; a dict of
    gradients by parameter name works too) -> {"params": tree,
    "batch_stats": tree} of f32 numpy arrays in the flax names and
    layouts (``nn.Conv2d`` weights OIHW -> HWIO ``kernel``, norm weights
    -> ``scale``). ``model`` tells a convolution's weight from a norm's
    or a deformable layer's."""
    if tensors is None:
        tensors = model.state_dict()
    modules = dict(model.named_modules())
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, t in tensors.items():
        *path, leaf = key.split(".")
        module = modules[".".join(path)]
        arr = t.detach().to("cpu", torch.float32)
        coll = "params"
        if leaf in _STAT_LEAVES:
            coll = "batch_stats"
        elif leaf == "weight" and isinstance(module, nn.Conv2d):
            leaf, arr = "kernel", arr.permute(2, 3, 1, 0)
        elif leaf == "weight" and not hasattr(module, "conv_offset") \
                and arr.dim() == 1:
            leaf = "scale"
        node = out[coll]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = arr.contiguous().numpy()
    return out
