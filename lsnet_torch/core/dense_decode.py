"""Inference decode of the dense-head zoo (counterpart of
``lsnet_tpu/core/dense_decode.py``): each head's boxes and scores for
every anchor or point, then the LSNet class-wise NMS tail
(:func:`lsnet_torch.core.decode.nms_candidates`). Landmark slots are
zeros (these heads have none). Boxes and scores are decoded in f32
whatever the head's dtype; the boxes are clipped to each image's
``img_shape``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from .anchors import delta2bbox, distance2bbox
from .decode import Detections, TestConfig, nms_candidates
from .dense_loss import (ATSS_STDS, KINDS, REG_MAX, DenseLossConfig,
                         _atss_grid, _centers, _fcos_points, _flatten,
                         _ga_guided_anchors, _grid, _integral)

# Guided Anchoring scores only cells whose sigmoid(loc) passes this (the
# files' ``loc_filter_thr``)
LOC_THR = 0.01


def _finish(boxes: torch.Tensor, scores: torch.Tensor,
            scale_factors: torch.Tensor, tcfg: TestConfig) -> Detections:
    """Back to each image's original scale, then NMS."""
    boxes = boxes / scale_factors.float()[:, None, :]
    lms = torch.zeros(*boxes.shape[:2], 8, dtype=boxes.dtype,
                      device=boxes.device)
    return nms_candidates(boxes, lms, scores, tcfg)


def dense_decode(outs: Dict[str, Sequence[torch.Tensor]],
                 img_shapes: torch.Tensor, scale_factors: torch.Tensor,
                 tcfg: TestConfig, lcfg: DenseLossConfig) -> Detections:
    """Batched decode + NMS of the retina / fcos / atss / gfl / ga_retina
    / ga_rpn heads. img_shapes (B, 2) [h, w]; scale_factors (B, 4)."""
    kind = lcfg.head
    if kind == "ga_retina":
        return ga_decode(outs, img_shapes, scale_factors, tcfg, lcfg)
    if kind == "ga_rpn":
        return ga_rpn_decode(outs, img_shapes, scale_factors, tcfg, lcfg)
    if kind not in KINDS:
        raise NotImplementedError(
            f"dense head kind {kind!r}: the port decodes "
            f"{', '.join(KINDS)}; the rest of the dense zoo is ROADMAP "
            "Queue 1 \"Inherited zoo\", the next dense slice")
    C = tcfg.num_classes
    cls = _flatten(outs["cls"], C)
    scores = torch.sigmoid(cls)
    dev = cls.device
    if kind == "gfl":
        anchors, counts = _atss_grid(lcfg, dev)
        stride_per = torch.cat([torch.full((n,), float(s), device=dev)
                                for n, s in zip(counts, lcfg.strides)])
        d = _integral(_flatten(outs["reg"], 4 * (REG_MAX + 1)))
        boxes = distance2bbox(_centers(anchors), d * stride_per[:, None],
                              max_shape=img_shapes)
    elif kind == "fcos":
        pts, pt_stride, _ = _fcos_points(lcfg, dev)
        boxes = distance2bbox(pts, _flatten(outs["reg"], 4)
                              * pt_stride[:, None], max_shape=img_shapes)
    else:
        anchors, _ = (_atss_grid(lcfg, dev) if kind == "atss"
                      else _grid(lcfg.anchor, lcfg, dev))
        boxes = delta2bbox(anchors, _flatten(outs["reg"], 4),
                           stds=ATSS_STDS if kind == "atss"
                           else (1.0, 1.0, 1.0, 1.0), max_shape=img_shapes)
    if kind in ("fcos", "atss"):
        scores = scores * torch.sigmoid(
            _flatten(outs["centerness"], 1))
    return _finish(boxes, scores, scale_factors, tcfg)


def _ga_boxes_scores(cls: torch.Tensor, outs, img_shapes, lcfg):
    """Guided anchors + deltas, scores gated by sigmoid(loc) > LOC_THR
    (the static-shape form of the reference's ``loc_filter_thr``)."""
    keep = torch.sigmoid(_flatten(outs["loc"], 1)) > LOC_THR
    scores = torch.sigmoid(cls) * keep.float()
    boxes = delta2bbox(_ga_guided_anchors(outs, lcfg),
                       _flatten(outs["reg"], 4), max_shape=img_shapes)
    return boxes, scores


def ga_decode(outs, img_shapes, scale_factors, tcfg: TestConfig,
              lcfg: DenseLossConfig) -> Detections:
    """Guided-Anchoring RetinaNet decode."""
    boxes, scores = _ga_boxes_scores(_flatten(outs["cls"], tcfg.num_classes),
                                     outs, img_shapes, lcfg)
    return _finish(boxes, scores, scale_factors, tcfg)


def ga_rpn_decode(outs, img_shapes, scale_factors, tcfg: TestConfig,
                  lcfg: DenseLossConfig) -> Detections:
    """GA-RPN proposals: binary objectness on the location-gated guided
    anchors, emitted as label-0 Detections."""
    boxes, scores = _ga_boxes_scores(_flatten(outs["cls"], 1), outs,
                                     img_shapes, lcfg)
    return _finish(boxes, scores, scale_factors, tcfg)
