"""Small dense ops (counterpart of ``lsnet_tpu/ops/misc.py``): CARAFE's
reassembly (FPN_CARAFE's upsampling), the masked convolution, the chamfer
distance that Dense RepPoints' point-set loss reads, and ``nms_match``.
None of them is a Pallas kernel in the JAX package; each is PyTorch here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .nms import NEG_INF, box_iou


def carafe(feats: torch.Tensor, masks: torch.Tensor, kernel_size: int = 5,
           group_size: int = 1, scale: int = 2) -> torch.Tensor:
    """CARAFE reassembly, NHWC as the JAX op: feats (B, H, W, C), masks
    (B, sH, sW, G*k*k) normalised kernels (the caller normalises) ->
    (B, sH, sW, C); output pixel (y, x) of group g is the k x k window
    around source pixel (y // s, x // s) (zero-padded), weighted by its
    mask.

    The windows are unfolded once at the source resolution (``F.unfold``,
    whose backward is a fold), (B, G, C/G, k*k, H, W), and contracted in
    one product with the s*s sub-pixel planes ``masks[:, dy::s, dx::s]``
    (B, G, k*k, H, W, s*s), the plane of (dy, dx) giving the output's
    ``[dy::s, dx::s]``. JAX's form gathers a (B, sH, sW, k*k, C) patch
    tensor by advanced indexing: s*s times the memory, and a scatter in
    its backward."""
    B, H, W, C = feats.shape
    k, G, s = kernel_size, group_size, scale
    unf = F.unfold(feats.permute(0, 3, 1, 2), k, padding=k // 2).view(
        B, G, C // G, k * k, H, W)
    planes = masks.reshape(B, H, s, W, s, G, k * k).permute(
        0, 5, 6, 1, 3, 2, 4)
    out = torch.einsum("bgckhw,bgkhwz->bgchwz", unf,
                       planes.reshape(B, G, k * k, H, W, s * s))
    # (B, C, H, W, dy, dx) -> (B, H, dy, W, dx, C)
    return out.reshape(B, C, H, W, s, s).permute(0, 2, 4, 3, 5, 1).reshape(
        B, s * H, s * W, C)


def masked_conv2d(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  padding: int = 1) -> torch.Tensor:
    """The convolution where mask > 0, zero elsewhere (a dense conv times
    the mask, as the JAX op): x (B, H, W, Cin), mask (B, H, W), weight
    (kh, kw, Cin, Cout) -> (B, H, W, Cout)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.permute(3, 2, 0, 1),
                   padding=padding).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    return out * (mask[..., None] > 0).to(out.dtype)


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


def nms_match(boxes: torch.Tensor, scores: torch.Tensor,
              iou_thr: float) -> torch.Tensor:
    """Greedy NMS grouping: each box (N, 4) gets the index of the kept box
    that suppressed it, its own if kept, -1 if it is padding (score <=
    NEG_INF / 2) or suppressed by none. The JAX op's fixed-trip loop, in
    its order (boxes by descending score, ties in index order), as tensor
    ops: no host synchronisation."""
    N = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = box_iou(boxes[order], boxes[order])
    valid = scores[order] > NEG_INF / 2
    group = torch.full((N,), -1, dtype=torch.long, device=boxes.device)
    taken = torch.zeros(N, dtype=torch.bool, device=boxes.device)
    for i in range(N):
        is_new = ~taken[i] & valid[i]
        sup = (iou[i] > iou_thr) & ~taken & valid & is_new
        group = torch.where(sup, i, group)
        taken = taken | sup
    out = torch.full((N,), -1, dtype=torch.long, device=boxes.device)
    return out.scatter(0, order, torch.where(
        group >= 0, order[group.clamp(min=0)], -1))
