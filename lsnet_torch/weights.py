"""JAX (flax) variables -> a ``state_dict`` of the port's modules.

The port's modules carry the flax module names, so a variable at
``params/head/cls_convs_0/conv/conv_offset/kernel`` becomes
``head.cls_convs_0.conv.conv_offset.weight``. Leaf rules:

* ``kernel`` (an ``nn.Conv2d``): HWIO -> OIHW, renamed ``weight``;
* ``scale`` (GroupNorm, FrozenBatchNorm): renamed ``weight``;
* ``bias`` and the deformable layers' HWIO ``weight``/``weight_a``/
  ``weight_b``: unchanged;
* ``batch_stats`` ``mean``/``var``: the FrozenBatchNorm buffers.

:func:`load_jax_variables` loads strictly: a variable the model does not
have, or a model entry no variable fills, raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                 "weight": "weight", "weight_a": "weight_a",
                 "weight_b": "weight_b"}
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
