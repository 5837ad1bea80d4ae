"""Soft-voting cluster merge of the TTA vote on the device (counterpart of
``lsnet_tpu/ops/vote.py``, which has no Pallas kernel).

The reference's ``instances_vote`` is a host while-loop per class; here
every class of a call runs in one fixed-iteration loop over its padded
slots, vectorised over classes (the numpy ``evalkit.tta.instances_vote``
stays the oracle). The JAX function's semantics, quirks included:

* a class with one or no valid detection gives an empty result;
* the cluster is every live detection with IoU >= ``vote_thresh`` with
  the best-scoring live one (the first in slot order on a tie);
* the merged box and vector are the score-weighted means, its score the
  cluster's max;
* the members come back as "soft" detections at score * (1 - IoU) where
  that is >= ``soft_thresh``, only from clusters of two or more (the
  seed's IoU is 1, so it never does);
* the output is sorted by score, padded slots invalid.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def instances_vote_batch(boxes: torch.Tensor, vectors: torch.Tensor,
                         scores: torch.Tensor, valid: torch.Tensor, *,
                         vote_thresh: float = 0.66, soft_thresh: float = 0.05
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """boxes (K, N, 4), vectors (K, N, P), scores (K, N), valid (K, N)
    bool, all on one device.

    Returns (boxes (K, 2N, 4), vectors (K, 2N, P), scores (K, 2N), valid
    (K, 2N)): merged then soft detections of each class, score-sorted."""
    K, N = scores.shape
    eps = 1e-6
    rows = torch.arange(K, device=scores.device)
    slots = torch.arange(N, device=scores.device)
    enough = valid.sum(dim=1, keepdim=True) > 1        # the reference quirk
    live = valid & enough
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0))
    m_box = torch.zeros_like(boxes)
    m_vec = torch.zeros_like(vectors)
    m_sc = torch.zeros_like(scores)
    m_ok = torch.zeros_like(valid)
    s_sc = torch.zeros_like(scores)
    s_ok = torch.zeros_like(valid)
    for _ in range(N):
        seed = torch.where(live, scores, NEG_INF).argmax(dim=1)
        any_live = live.any(dim=1)
        sb = boxes[rows, seed]                                 # (K, 4)
        inter = ((torch.minimum(sb[:, None, 2], boxes[..., 2])
                  - torch.maximum(sb[:, None, 0], boxes[..., 0])).clamp(min=0)
                 * (torch.minimum(sb[:, None, 3], boxes[..., 3])
                    - torch.maximum(sb[:, None, 1], boxes[..., 1])
                    ).clamp(min=0))
        union = (area[rows, seed][:, None] + area - inter).clamp(min=eps)
        is_seed = slots[None] == seed[:, None]
        iou = torch.where(is_seed, 1.0, inter / union)
        cluster = live & (iou >= vote_thresh) & any_live[:, None]
        cw = scores * cluster
        s = cw.sum(dim=1).clamp(min=eps)[:, None]
        mb = (boxes * cw[..., None]).sum(dim=1) / s
        mv = (vectors * cw[..., None]).sum(dim=1) / s
        msc = torch.where(cluster, scores, NEG_INF).amax(dim=1)
        multi = cluster.sum(dim=1, keepdim=True) > 1
        soft = scores * (1.0 - iou)
        emit = cluster & multi & (soft >= soft_thresh)
        s_sc = torch.where(emit, soft, s_sc)
        s_ok = s_ok | emit
        put = (slots[None] == m_ok.sum(dim=1, keepdim=True)) \
            & any_live[:, None]                       # the next merged slot
        m_box = torch.where(put[..., None], mb[:, None], m_box)
        m_vec = torch.where(put[..., None], mv[:, None], m_vec)
        m_sc = torch.where(put, msc[:, None], m_sc)
        m_ok = m_ok | put
        live = live & ~cluster
    out_box = torch.cat([m_box, boxes], dim=1)
    out_vec = torch.cat([m_vec, vectors], dim=1)
    out_sc = torch.cat([m_sc, s_sc], dim=1)
    out_ok = torch.cat([m_ok, s_ok], dim=1)
    order = torch.argsort(-torch.where(out_ok, out_sc, NEG_INF), dim=1,
                          stable=True)
    take = order[..., None]
    return (torch.gather(out_box, 1, take.expand(-1, -1, 4)),
            torch.gather(out_vec, 1, take.expand(-1, -1, out_vec.shape[-1])),
            torch.gather(out_sc, 1, order), torch.gather(out_ok, 1, order))
