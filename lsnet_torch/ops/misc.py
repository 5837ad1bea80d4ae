"""Small dense ops (counterpart of part of ``lsnet_tpu/ops/misc.py``): the
chamfer distance that Dense RepPoints' point-set loss reads."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor,
                     valid1: Optional[torch.Tensor] = None,
                     valid2: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional squared nearest-neighbour distances.

    xyz1 (N, P1, 2), xyz2 (N, P2, 2) -> (dist1 (N, P1), dist2 (N, P2)).
    An invalid point of the other set reads 1e10 away."""
    d = ((xyz1[:, :, None, :] - xyz2[:, None, :, :]) ** 2).sum(-1)
    if valid2 is not None:
        d = torch.where(valid2[:, None, :], d, torch.full_like(d, 1e10))
    dist1 = d.amin(dim=2)
    d2 = d
    if valid1 is not None:
        d2 = torch.where(valid1[:, :, None], d, torch.full_like(d, 1e10))
    return dist1, d2.amin(dim=1)
