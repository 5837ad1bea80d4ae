"""Inference decoding on the device: head outputs -> detections
(counterpart of ``lsnet_tpu/core/decode.py``), for the four tasks.

Per-level top-k pre-selection (``nms_pre``), stride decode with the grid
shift, clipping to the image, score threshold, class-wise exact greedy NMS
(or soft-NMS) and the ``max_per_img`` cut, written with an explicit batch dimension where
the JAX package uses ``vmap``. Top-k selections break ties toward the lower
index, as ``jax.lax.top_k`` does. Scores and landmarks are decoded in f32
whatever the head's dtype. Outputs are padded to ``max_per_img`` with a
validity mask. The landmark vector rides along through every selection:
the 4 extremes of a bbox, the ``num_vectors`` contour points of segm or
keypoints of pose, xy-interleaved.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from ..models.heads.ls_head import (MAIN_BRANCH, extreme_points2bbox,
                                    vectors2bbox)
from ..ops.nms import NEG_INF, _top_stable, batched_nms, soft_nms
from . import points as P


@dataclass(frozen=True)
class TestConfig:
    image_shape: Tuple[int, int]
    num_classes: int
    task: str = "bbox"
    num_vectors: int = 4
    point_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    nms_pre: int = 1000
    score_thr: float = 0.05
    nms_iou: float = 0.6
    max_per_img: int = 100
    nms_type: str = "nms"        # 'nms' | 'soft_nms'
    soft_sigma: float = 0.5
    soft_min_score: float = 1e-3


TestConfig.__test__ = False  # not a pytest class


class Detections(NamedTuple):
    bboxes: torch.Tensor      # (B, max_per_img, 4) image-coordinate x1y1x2y2
    scores: torch.Tensor      # (B, max_per_img)
    labels: torch.Tensor      # (B, max_per_img) int32
    # (B, max_per_img, 2*nv) xy-interleaved; bbox: [xt,y1, x1,yl, xb,y2, x2,yr]
    landmarks: torch.Tensor
    valid: torch.Tensor       # (B, max_per_img) bool


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, k) -> (B, k, D)."""
    return torch.gather(x, 1, idx.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


def _decode_levels(cls_flats, lm_flats, img_shapes, scale_factors,
                   cfg: TestConfig, rescale: bool):
    """-> (bboxes (B,T,4), landmarks (B,T,2*nv), scores (B,T,C))."""
    B = img_shapes.shape[0]
    shp = img_shapes.to(torch.float32)
    h_max = shp[:, 0].view(B, 1)
    w_max = shp[:, 1].view(B, 1)

    def clip(v, hi):
        return torch.minimum(v.clamp(min=0.0), hi)

    level_hw = P.level_shapes(cfg.image_shape, cfg.point_strides)
    all_scores, all_boxes, all_lms = [], [], []
    for lvl, (score_l, lm_l, s) in enumerate(
            zip(cls_flats, lm_flats, cfg.point_strides)):
        scores = torch.sigmoid(score_l.float())                  # (B, n, C)
        pts = P.grid_points(level_hw[lvl], s, device=scores.device)
        k = min(cfg.nms_pre, scores.shape[1])
        _, topk = _top_stable(scores.amax(dim=-1), k)            # (B, k)
        scores = _take(scores, topk)
        lm = _take(lm_l.float(), topk)
        xy = pts[:, :2][topk]                                    # (B, k, 2)
        if cfg.task == "bbox":
            extremes, bbox = extreme_points2bbox(lm)
            lm_dec = extremes * s + xy.repeat(1, 1, 4)
        else:
            vectors, bbox = vectors2bbox(lm)
            lm_dec = vectors * s + xy.repeat(1, 1, cfg.num_vectors)
        bbox_dec = bbox * s + torch.cat([xy, xy], dim=-1)
        x1 = clip(bbox_dec[..., 0], w_max)
        y1 = clip(bbox_dec[..., 1], h_max)
        x2 = clip(bbox_dec[..., 2], w_max)
        y2 = clip(bbox_dec[..., 3], h_max)
        if cfg.task == "bbox":
            # the extremes' free coordinates; the others are the box's
            xt = clip(lm_dec[..., 0], w_max)
            yl = clip(lm_dec[..., 3], h_max)
            xb = clip(lm_dec[..., 4], w_max)
            yr = clip(lm_dec[..., 7], h_max)
            all_lms.append(torch.stack([xt, y1, x1, yl, xb, y2, x2, yr], -1))
        else:
            lm_x = clip(lm_dec[..., 0::2], w_max[..., None])
            lm_y = clip(lm_dec[..., 1::2], h_max[..., None])
            all_lms.append(torch.stack([lm_x, lm_y], -1).flatten(-2))
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1))
        all_scores.append(scores)
    scores = torch.cat(all_scores, dim=1)
    bboxes = torch.cat(all_boxes, dim=1)
    lms = torch.cat(all_lms, dim=1)
    if rescale:
        sf = scale_factors.to(torch.float32)                      # (B, 4)
        bboxes = bboxes / sf[:, None, :]
        lms = lms / sf[:, None, :2].repeat(1, 1, lms.shape[-1] // 2)
    return bboxes, lms, scores


def nms_candidates(bboxes: torch.Tensor, lms: torch.Tensor,
                   scores: torch.Tensor, cfg: TestConfig) -> Detections:
    """Batched multiclass NMS tail: (B,T,4)/(B,T,2*nv)/(B,T,C) ->
    Detections."""
    B, T, C = scores.shape
    cand_scores = torch.where(scores > cfg.score_thr, scores,
                              torch.full_like(scores, NEG_INF))
    k = min(cfg.nms_pre, T * C)
    flat_scores, flat_idx = _top_stable(cand_scores.reshape(B, -1), k)
    cand = flat_idx // C
    labels = (flat_idx % C).to(torch.int32)
    nms_boxes = _take(bboxes, cand)
    if cfg.nms_type == "soft_nms":
        # class-wise by the coordinate-offset trick, as batched_nms
        live = flat_scores > NEG_INF / 2
        max_coord = torch.where(live, nms_boxes.amax(dim=-1),
                                torch.zeros_like(flat_scores)
                                ).amax(dim=-1, keepdim=True)
        shifted = nms_boxes + (labels.to(nms_boxes.dtype)
                               * (max_coord + 1.0)).unsqueeze(-1)
        keep_idx, keep_scores, keep_valid = soft_nms(
            shifted, flat_scores, cfg.nms_iou, cfg.max_per_img,
            sigma=cfg.soft_sigma, min_score=cfg.soft_min_score)
    elif cfg.nms_type == "nms":
        keep_idx, keep_scores, keep_valid = batched_nms(
            nms_boxes, flat_scores, labels, cfg.nms_iou, cfg.max_per_img)
    else:
        raise ValueError(f"nms_type {cfg.nms_type!r}")
    out_boxes = _take(nms_boxes, keep_idx)
    out_labels = torch.gather(labels, 1, keep_idx)
    out_lms = _take(lms, torch.gather(cand, 1, keep_idx))
    out_scores = torch.where(keep_valid, keep_scores,
                             torch.zeros_like(keep_scores))
    z = keep_valid.unsqueeze(-1).to(bboxes.dtype)
    return Detections(out_boxes * z, out_scores,
                      out_labels * keep_valid.to(torch.int32), out_lms * z,
                      keep_valid)


def _level_flats(outs: Dict[str, Sequence[torch.Tensor]], cfg: TestConfig):
    """Per-level (B, n, C) score and (B, n, 4*(nv+1)) landmark flats: the
    cls maps and the refined maps of the task's main branch."""
    if cfg.task not in MAIN_BRANCH:
        raise ValueError(f"decode for task {cfg.task!r}: want one of "
                         f"{sorted(MAIN_BRANCH)}")
    lm_maps = outs[f"{MAIN_BRANCH[cfg.task]}_refine"]
    want = 4 * (cfg.num_vectors + 1)
    if lm_maps[0].shape[-1] != want:
        raise ValueError(
            f"{MAIN_BRANCH[cfg.task]}_refine has {lm_maps[0].shape[-1]} "
            f"channels, num_vectors={cfg.num_vectors} needs {want}")
    return ([m.reshape(m.shape[0], -1, m.shape[-1]) for m in outs["cls"]],
            [m.reshape(m.shape[0], -1, m.shape[-1]) for m in lm_maps])


def lsnet_decode_candidates(outs: Dict[str, Sequence[torch.Tensor]],
                            img_shapes: torch.Tensor,
                            scale_factors: torch.Tensor, cfg: TestConfig,
                            rescale: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The candidates before NMS: (bboxes (B,T,4), landmarks (B,T,2*nv),
    scores (B,T,C))."""
    cls_flats, lm_flats = _level_flats(outs, cfg)
    return _decode_levels(cls_flats, lm_flats, img_shapes, scale_factors,
                          cfg, rescale)


def lsnet_decode(outs: Dict[str, Sequence[torch.Tensor]],
                 img_shapes: torch.Tensor, scale_factors: torch.Tensor,
                 cfg: TestConfig, rescale: bool = True) -> Detections:
    """Batched decode + class-wise NMS. outs: per-level NHWC maps;
    img_shapes (B,2) [h,w]; scale_factors (B,4)."""
    return nms_candidates(*lsnet_decode_candidates(
        outs, img_shapes, scale_factors, cfg, rescale), cfg)
