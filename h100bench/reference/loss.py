"""Plain reference of LSNet's bbox training loss and its SGD step, one
image at a time.

Init stage: the CentroidAssigner (each valid GT takes the grid point
nearest its box centre, distances in units of the box, on the FPN level
``log2(sqrt(w h) / 4)`` clamped to the levels). Refine stage: ATSS on
the boxes decoded from the init landmarks (per level the 9 points whose
box centres lie nearest the GT's, threshold mean + std of their IoUs,
centre inside the GT, a point claimed twice keeps the higher IoU).
Targets: the box's four border centres and its centre. Losses: sigmoid
focal loss over every valid point, cross-IoU over the positives (slot
pairs, the empty slot filled with alpha times the other, minus the
DIoU / aspect penalty of the decoded box), each divided by the batch's
positive count (each image's at least 1).

The optimizer: the global norm of the trainable gradients clipped to 35,
weight decay 1e-4 added, momentum 0.9, the step schedule's linear
warm-up from 0.001 of the base rate over 500 steps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .model import signed_pairs

INF = 1e8


def grid(shapes: Sequence, strides: Sequence[int], device):
    """(N, 3) points (x, y, stride), levels concatenated, x fastest."""
    pts = []
    for (h, w), s in zip(shapes, strides):
        ys, xs = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device),
                                indexing="ij")
        pts.append(torch.stack([xs.reshape(-1).float() * s,
                                ys.reshape(-1).float() * s,
                                torch.full((h * w,), float(s),
                                           device=device)], -1))
    return torch.cat(pts)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None] - inter).clamp(min=1e-10)


def centroid_assign(points, valid, gt, gt_ok, scale=4.0):
    levels = torch.log2(points[:, 2]).round().long()
    c = (gt[:, :2] + gt[:, 2:]) / 2
    wh = (gt[:, 2:] - gt[:, :2]).clamp(min=1e-6)
    lvl = ((torch.log2(wh[:, 0] / scale) + torch.log2(wh[:, 1] / scale))
           / 2).long().clamp(int(levels.min()), int(levels.max()))
    d = (((points[:, None, :2] - c[None]) / wh[None]) ** 2).sum(-1).sqrt()
    bad = (levels[:, None] != lvl[None]) | ~valid[:, None] | ~gt_ok[None]
    d = torch.where(bad, torch.full_like(d, INF), d)
    N, M = d.shape
    best = torch.full((N,), INF, device=d.device)
    owner = torch.full((N,), -1, dtype=torch.long, device=d.device)
    for m in range(M):
        if not bool(gt_ok[m]):
            continue
        col = d[:, m]
        i = int(torch.argmin(col))        # the first of equal minima
        if col[i] < INF / 2 and col[i] < best[i]:
            best[i], owner[i] = col[i], m
    return owner


def atss_assign(boxes, valid, level_sizes, gt, gt_ok, topk=9):
    ov = iou(boxes, gt)
    gc = (gt[:, :2] + gt[:, 2:]) / 2
    bc = (boxes[:, :2] + boxes[:, 2:]) / 2
    d = ((bc[:, None] - gc[None]) ** 2).sum(-1).sqrt()
    d = torch.where(valid[:, None], d, torch.full_like(d, INF))
    cands, start = [], 0
    for n in level_sizes:
        order = torch.sort(d[start:start + n].t(), dim=1, stable=True)[1]
        cands.append(order[:, :min(topk, n)] + start)            # (M, k)
        start += n
    cand = torch.cat(cands, 1)                                   # (M, K)
    M = gt.shape[0]
    rows = torch.arange(M, device=gt.device)[:, None]
    cov = ov[cand, rows]
    thr = cov.mean(1, keepdim=True) + cov.std(1, keepdim=True)
    cc = bc[cand]                                                # (M, K, 2)
    inside = torch.stack([cc[..., 0] - gt[:, None, 0],
                          cc[..., 1] - gt[:, None, 1],
                          gt[:, None, 2] - cc[..., 0],
                          gt[:, None, 3] - cc[..., 1]], -1).amin(-1) > 0.01
    pos = (cov >= thr) & inside & gt_ok[:, None] & valid[cand]
    N = boxes.shape[0]
    best = torch.full((N, M), -INF, device=gt.device)
    best[cand[pos], rows.expand_as(cand)[pos]] = cov[pos]
    top, owner = best.amax(1), best.argmax(1)  # the first of equal maxima
    return torch.where(top > -INF / 2, owner, torch.full_like(owner, -1))


def border_centres(gt):
    x1, y1, x2, y2 = gt.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    return torch.stack([cx, y1, x1, cy, cx, y2, x2, cy, cx, cy], -1)


def extremes_box(pred):
    """(N, 20) slot pairs -> (N, 4) [left, top, right, bottom] offsets
    from the point (top, left, bottom, right, centre points)."""
    yx = signed_pairs(pred).reshape(-1, 5, 2)
    return torch.stack([yx[:, 1, 1], yx[:, 0, 0], yx[:, 3, 1], yx[:, 2, 0]],
                       -1)


def focal(logits, labels, weight, gamma=2.0, alpha=0.25):
    C = logits.shape[1]
    oh = F.one_hot(labels, C + 1)[:, :C].float()
    p = torch.sigmoid(logits)
    pt = (1 - p) * oh + p * (1 - oh)
    fw = (alpha * oh + (1 - alpha) * (1 - oh)) * pt ** gamma
    bce = F.binary_cross_entropy_with_logits(logits, oh, reduction="none")
    return (bce * fw * weight[:, None]).sum()


def cross_iou(pred, gt_pts, points, stride, bbox_gt, pos, alpha=0.2,
              eps=1e-6):
    """Sum over the positive rows of 1 - (cross-IoU - penalty)."""
    norm = 4.0 * stride[:, None]
    pred = pred * stride[:, None] / norm
    off = gt_pts.reshape(-1, 5, 2) - points[:, None, :2]
    oy, ox = off[..., 1], off[..., 0]
    z = torch.zeros_like(oy)
    tgt = torch.stack([torch.where(oy < 0, -oy, z), torch.where(oy >= 0, oy, z),
                       torch.where(ox < 0, -ox, z), torch.where(ox >= 0, ox, z)],
                      -1).reshape(len(pred), -1) / norm
    slot = torch.stack([oy < 0, oy >= 0, ox < 0, ox >= 0], -1).reshape(
        len(pred), -1, 2)
    tp = tgt.reshape(len(pred), -1, 2)
    val = (tp * slot).sum(-1, keepdim=True)
    tgt = torch.where(slot, tp, alpha * val).reshape(len(pred), -1)
    overlap = torch.minimum(pred, tgt).sum(1) / \
        torch.maximum(pred, tgt).sum(1).clamp(min=eps)
    anchor = points[:, :2] / norm
    o = extremes_box(pred)
    b1 = torch.stack([o[:, 0] + anchor[:, 0], o[:, 1] + anchor[:, 1],
                      o[:, 2] + anchor[:, 0], o[:, 3] + anchor[:, 1]], -1)
    b2 = bbox_gt / norm
    enc = (torch.maximum(b1[:, 2:], b2[:, 2:])
           - torch.minimum(b1[:, :2], b2[:, :2])).clamp(min=0)
    c2 = enc[:, 0] ** 2 + enc[:, 1] ** 2 + eps
    rho2 = (((b2[:, 0] + b2[:, 2]) - (b1[:, 0] + b1[:, 2])) ** 2
            + ((b2[:, 1] + b2[:, 3]) - (b1[:, 1] + b1[:, 3])) ** 2) / 4
    w1, h1 = b1[:, 2] - b1[:, 0], b1[:, 3] - b1[:, 1] + eps
    w2, h2 = b2[:, 2] - b2[:, 0], b2[:, 3] - b2[:, 1] + eps
    v = 4 / math.pi ** 2 * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    pen = rho2 / c2 + v ** 2 / (1 - overlap + v).clamp(min=eps)
    return ((1 - (overlap - pen)) * pos).sum()


def _flat(maps):
    return torch.cat([m.reshape(-1, m.shape[-1]) for m in maps])


def _points(shapes, pad_shape, strides, dev):
    """The grid points and which of them lie inside the padded image."""
    pts = grid(shapes, strides, dev)
    valid = torch.cat([
        ((torch.arange(h, device=dev)[:, None]
          < min(-(-int(pad_shape[0]) // s), h))
         & (torch.arange(w, device=dev)[None]
            < min(-(-int(pad_shape[1]) // s), w))).reshape(-1)
        for (h, w), s in zip(shapes, strides)])
    return pts, valid


def assign(init_maps: List[torch.Tensor], gt, gt_ok, pad_shape, strides):
    """One image's assignments (init owners, refine owners), the refine
    stage's from the boxes that ``init_maps`` (each (H, W, C)) decode to;
    -1 where a point is no GT's."""
    shapes = [m.shape[:2] for m in init_maps]
    pts, valid = _points(shapes, pad_shape, strides, gt.device)
    own_i = centroid_assign(pts, valid, gt, gt_ok)
    dec = extremes_box(_flat(init_maps).detach().float()) \
        * pts[:, 2:3] + pts[:, :2].repeat(1, 2)
    own_r = atss_assign(dec, valid, [h * w for h, w in shapes], gt, gt_ok)
    return own_i, own_r


def image_terms(outs: Dict[str, List[torch.Tensor]], gt, labels, gt_ok,
                pad_shape, strides, num_classes, owners=None):
    """One image's head maps (each (H, W, C)) -> unnormalised sums
    ``cls``, ``init``, ``refine``, the positive counts ``n_init``,
    ``n_refine`` (at least 1) and the assignments (``owners``, reused when
    given)."""
    shapes = [m.shape[:2] for m in outs["cls"]]
    pts, valid = _points(shapes, pad_shape, strides, gt.device)
    stride = pts[:, 2]
    cls, init, refine = (_flat(outs["cls"]), _flat(outs["bbox_init"]),
                         _flat(outs["bbox_refine"]))
    if owners is None:
        owners = assign(outs["bbox_init"], gt, gt_ok, pad_shape, strides)
    lm = border_centres(gt)
    out = {"owners": owners}
    for name, own, pred in (("init", owners[0], init),
                            ("refine", owners[1], refine)):
        pos = own >= 0
        safe = own.clamp(min=0)
        out[f"n_{name}"] = max(int(pos.sum()), 1)
        out[name] = cross_iou(pred, lm[safe] * pos[:, None], pts, stride,
                              gt[safe] * pos[:, None], pos.float())
    lab = torch.where(owners[1] >= 0, labels[owners[1].clamp(min=0)],
                      torch.full_like(owners[1], num_classes))
    out["cls"] = focal(cls, lab, valid.float())
    return out


def lr_at(step: int, base=0.01, warmup=500, ratio=0.001) -> float:
    if step >= warmup:
        return base
    return base * (1 - (1 - step / warmup) * (1 - ratio))


@torch.no_grad()
def sgd_step(params, grads, bufs, step: int, clip=35.0, wd=1e-4,
             momentum=0.9):
    """One update in place; returns (the norm before the clip, the
    clipped gradients)."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = clip / torch.clamp(norm, min=clip)
    lr = lr_at(step)
    clipped = [g * scale for g in grads]
    for i, (p, g) in enumerate(zip(params, clipped)):
        d = g + wd * p
        bufs[i] = d.clone() if bufs[i] is None else momentum * bufs[i] + d
        p -= lr * bufs[i]
    return norm, clipped
