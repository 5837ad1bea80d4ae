"""Plain reference of LSNet's bbox decode and class-wise greedy NMS, one
image at a time.

Per level: sigmoid scores, the ``nms_pre`` points of highest max score
(ties to the lower index), the extreme points decoded at the level's
stride, boxes clipped to the image and mapped back by the scale factor.
Over all levels: the (point, class) pairs above ``score_thr``, the
``nms_pre`` best, class-wise greedy NMS at ``iou_thr`` as mmdet's
``batched_nms`` runs it (each class's boxes shifted apart by the label
times the largest coordinate plus one), then the ``max_per_img`` best
kept. The NMS walks the candidates in score order on the host in
float32, as the sequential greedy algorithm states it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .model import signed_pairs

NEG = -1e10


def _top(x: torch.Tensor, k: int):
    vals, order = torch.sort(x, descending=True, stable=True)
    return vals[:k], order[:k]


def candidates(cls_maps: Sequence[torch.Tensor],
               refine_maps: Sequence[torch.Tensor], img_shape, scale_factor,
               strides: Sequence[int], nms_pre: int):
    """One image's NHWC maps (f32) -> (boxes (T, 4), extremes (T, 8),
    scores (T, C)) of the pre-selected points, in the original image's
    coordinates."""
    h, w = float(img_shape[0]), float(img_shape[1])
    boxes, lms, scores = [], [], []
    for cls, ref, s in zip(cls_maps, refine_maps, strides):
        H, W, C = cls.shape
        sc = torch.sigmoid(cls.reshape(H * W, C))
        _, keep = _top(sc.amax(-1), min(nms_pre, H * W))
        sc = sc[keep]
        yx = signed_pairs(ref.reshape(H * W, -1)[keep]).reshape(-1, 5, 2)
        px = (keep % W).float() * s
        py = torch.div(keep, W, rounding_mode="floor").float() * s
        ys = yx[..., 0] * s + py[:, None]
        xs = yx[..., 1] * s + px[:, None]

        def cx(v):
            return torch.clamp(torch.clamp(v, min=0.0), max=w)

        def cy(v):
            return torch.clamp(torch.clamp(v, min=0.0), max=h)
        # points: top, left, bottom, right, centre
        x1, y1, x2, y2 = cx(xs[:, 1]), cy(ys[:, 0]), cx(xs[:, 3]), cy(ys[:, 2])
        boxes.append(torch.stack([x1, y1, x2, y2], -1))
        lms.append(torch.stack([cx(xs[:, 0]), y1, x1, cy(ys[:, 1]),
                                cx(xs[:, 2]), y2, x2, cy(ys[:, 3])], -1))
        scores.append(sc)
    sf = torch.as_tensor(scale_factor, dtype=torch.float32,
                         device=boxes[0].device)
    boxes = torch.cat(boxes) / sf
    lms = torch.cat(lms) / sf[:2].repeat(4)
    return boxes, lms, torch.cat(scores)


def greedy_nms(boxes: np.ndarray, iou_thr: float) -> List[int]:
    """Indices kept, in order, of score-sorted float32 boxes: each box is
    kept unless a kept box before it overlaps it by IoU > thr."""
    x1, y1, x2, y2 = boxes.T
    area = (x2 - x1) * (y2 - y1)
    keep: List[int] = []
    dead = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        if dead[i]:
            continue
        keep.append(i)
        iw = np.clip(np.minimum(x2[i], x2) - np.maximum(x1[i], x1), 0, None)
        ih = np.clip(np.minimum(y2[i], y2) - np.maximum(y1[i], y1), 0, None)
        inter = iw * ih
        union = np.maximum(area[i] + area - inter, np.float32(1e-10))
        dead |= inter / union > np.float32(iou_thr)
    return keep


def detect_one(cls_maps, refine_maps, img_shape, scale_factor, *,
               strides: Sequence[int], nms_pre: int, score_thr: float,
               iou_thr: float, max_per_img: int) -> Dict[str, np.ndarray]:
    """One image's detections: boxes (n, 4), scores (n,), labels (n,),
    landmarks (n, 8), best first."""
    boxes, lms, scores = candidates(cls_maps, refine_maps, img_shape,
                                    scale_factor, strides, nms_pre)
    C = scores.shape[1]
    cand = torch.where(scores > score_thr, scores,
                       torch.full_like(scores, NEG)).reshape(-1)
    vals, idx = _top(cand, min(nms_pre, cand.numel()))
    live = vals > NEG / 2
    vals, idx = vals[live], idx[live]
    point = torch.div(idx, C, rounding_mode="floor")
    label = idx % C
    b = boxes[point]
    shift = (b.amax() + 1.0) if len(b) else torch.zeros((), device=b.device)
    shifted = (b + (label.float() * shift)[:, None]).cpu().numpy()
    keep = greedy_nms(shifted.astype(np.float32), iou_thr)[:max_per_img]
    keep = torch.as_tensor(keep, dtype=torch.long, device=b.device)
    return {"boxes": b[keep].cpu().numpy(),
            "scores": vals[keep].cpu().numpy(),
            "labels": label[keep].cpu().numpy().astype(np.int64),
            "landmarks": lms[point[keep]].cpu().numpy()}
