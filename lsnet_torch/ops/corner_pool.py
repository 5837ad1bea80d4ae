"""Corner pooling by directional cumulative max (counterpart of
``lsnet_tpu/ops/corner_pool.py``), on NHWC maps x (B, H, W, C):

  top_pool(x)[h]    = max over h' >= h
  bottom_pool(x)[h] = max over h' <= h
  left_pool(x)[w]   = max over w' >= w
  right_pool(x)[w]  = max over w' <= w

``torch.cummax``, flipped for the reversed directions. Its gradient goes
to the one input its index names (the last of tied maxima, counting in
the scan's direction), where the JAX package's ``associative_scan`` of
``jnp.maximum`` splits a tie's gradient between the tied inputs; the
values are the same.
"""

from __future__ import annotations

import torch


def _cummax(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    if reverse:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def top_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 1, True)


def bottom_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 1, False)


def left_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 2, True)


def right_pool(x: torch.Tensor) -> torch.Tensor:
    return _cummax(x, 2, False)


POOLS = {"top": top_pool, "bottom": bottom_pool, "left": left_pool,
         "right": right_pool}


def corner_pool(x: torch.Tensor, mode: str) -> torch.Tensor:
    return POOLS[mode](x)
