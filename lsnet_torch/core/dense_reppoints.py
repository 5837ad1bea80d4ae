"""Dense RepPoints v1 and v2 training loss and decode (counterpart of
``lsnet_tpu/core/dense_reppoints.py``), written with an explicit batch
dimension where the JAX package uses ``vmap``.

As in the JAX package, which rebuilt the reference flow with static
shapes:

* GT point sets are the pipeline's GT contour polygons (36 vertices, the
  segm task's) resampled to ``gt_contour_points`` by exact arc-length
  interpolation (the reference samples a band around the mask contour on
  the host);
* per-point mask labels come from an exact point-in-polygon test
  (crossing number) at the predicted init points;
* the chamfer loss runs on a fixed quota of ``max_pos_chamfer`` positives
  per image.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.focal_loss import gaussian_focal_loss
from ..ops.misc import chamfer_distance
from ..ops.nms import NEG_INF, _top_stable, batched_nms
from . import points as P
from .cpv import _scatter_last, make_sem_targets, sem_loss
from .decode import TestConfig, _take
from .reppoints import box_stage_loss, point_assignments, refine_cls_loss

Outs = Mapping[str, Sequence[torch.Tensor]]
# rows of the point-in-polygon labels computed at once (bounds the
# (rows, P, V) intermediates)
LABEL_CHUNK = 4096


@dataclass(frozen=True)
class DenseRepPointsConfig:
    image_shape: Tuple[int, int]
    num_classes: int
    num_points: int = 729
    num_group: int = 9
    num_score_group: int = 121
    point_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    point_base_scale: int = 4
    init_scale: int = 4
    init_pos_num: int = 1
    refine_pos_iou: float = 0.5
    refine_neg_iou: float = 0.4
    refine_min_pos_iou: float = 0.0
    cls_weight: float = 1.0
    bbox_init_weight: float = 0.5
    bbox_refine_weight: float = 1.0
    pts_init_weight: float = 0.5
    pts_refine_weight: float = 1.0
    mask_score_weight: float = 1.0
    smooth_beta: float = 1.0 / 9.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    max_pos_chamfer: int = 32
    gt_contour_points: int = 128   # resampled contour size for chamfer


@dataclass(frozen=True)
class DenseRepPointsV2Config(DenseRepPointsConfig):
    """Dense RepPoints v2: the v1 settings and the contour and semantic
    terms' weights (the JAX ``dense_reppoints_v2_loss`` keyword
    defaults); a type of its own for the train step's loss table."""
    cont_loss_weight: float = 1.0
    sem_loss_weight: float = 0.1


def resample_polygon(poly: torch.Tensor, n: int) -> torch.Tensor:
    """(..., V, 2) closed polygons -> (..., n, 2): n points at equal
    arc-length steps from the first vertex."""
    V = poly.shape[-2]
    nxt = torch.roll(poly, -1, dims=-2)
    seg = torch.sqrt(((nxt - poly) ** 2).sum(-1) + 1e-12)          # (..., V)
    cum = torch.cat([torch.zeros_like(seg[..., :1]),
                     torch.cumsum(seg, dim=-1)], dim=-1)           # (..., V+1)
    t = (torch.arange(n, dtype=torch.float32, device=poly.device) / n
         * cum[..., -1:])
    idx = (torch.searchsorted(cum.contiguous(), t.contiguous(), right=True)
           - 1).clamp(0, V - 1)
    frac = ((t - torch.gather(cum, -1, idx))
            / torch.gather(seg, -1, idx).clamp(min=1e-12))
    ix = idx[..., None].expand(*idx.shape, 2)
    start = torch.gather(poly, -2, ix)
    return start + (torch.gather(nxt, -2, ix) - start) * frac[..., None]


def point_in_polygon(poly: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Crossing-number inside test. poly (..., V, 2); pts (..., P, 2) with
    the same leading dims -> (..., P) bool."""
    x = pts[..., 0][..., None]                                     # (..,P,1)
    y = pts[..., 1][..., None]
    x1, y1 = poly[..., None, :, 0], poly[..., None, :, 1]          # (..,1,V)
    x2 = torch.roll(poly[..., 0], -1, dims=-1)[..., None, :]
    y2 = torch.roll(poly[..., 1], -1, dims=-1)[..., None, :]
    cond = (y1 <= y) != (y2 <= y)
    dy = y2 - y1
    xint = x1 + (y - y1) * (x2 - x1) / torch.where(
        dy.abs() < 1e-12, torch.full_like(dy, 1e-12), dy)
    cross = cond & (x < xint)
    return cross.sum(-1) % 2 == 1


def _flat(maps: Sequence[torch.Tensor], ch: int) -> torch.Tensor:
    return torch.cat([m.reshape(m.shape[0], -1, ch) for m in maps], dim=1)


def _pts_img(pts_flat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(B, N, 2P) stride-unit [x, y] offsets -> image coordinates
    (B, N, P, 2)."""
    B, N, _ = pts_flat.shape
    p = pts_flat.reshape(B, N, -1, 2)
    return p * points[None, :, None, 2:3] + points[None, :, None, :2]


def minmax_bbox(pts: torch.Tensor) -> torch.Tensor:
    """(..., P, 2) -> (..., 4) minmax box."""
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([x.amin(-1), y.amin(-1), x.amax(-1), y.amax(-1)], -1)


def _gt_polygons(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    polys = batch["gt_polygons"]
    return polys.reshape(*polys.shape[:2], -1, 2)                 # (B,M,V,2)


def _chamfer_loss(pts_pred: torch.Tensor, gt_idx: torch.Tensor,
                  contours: torch.Tensor, norm1: torch.Tensor, quota: int,
                  weight: float) -> torch.Tensor:
    """Chamfer loss of each image's first ``quota`` positives (by index;
    negatives fill the quota and weigh 0), averaged over the batch's
    counted positives."""
    B, N = gt_idx.shape
    pos = gt_idx >= 0
    rank = (torch.where(pos, 1.0, -float("inf"))
            + torch.arange(N, dtype=torch.float32, device=pos.device) * 1e-9)
    _, sel = _top_stable(rank, quota)                              # (B, Q)
    ok = torch.gather(pos, 1, sel).float()
    n1 = norm1[sel][..., None, None]                               # (B,Q,1,1)
    pred = torch.gather(pts_pred, 1, sel[..., None, None].expand(
        -1, -1, *pts_pred.shape[2:])) / n1
    gi = torch.gather(gt_idx.long(), 1, sel).clamp(min=0)
    tgt = torch.gather(contours, 1, gi[..., None, None].expand(
        -1, -1, *contours.shape[2:])) / n1
    d1, d2 = chamfer_distance(pred.flatten(0, 1), tgt.flatten(0, 1))
    loss = (torch.sqrt(d1 + 1e-12).mean(-1)
            + torch.sqrt(d2 + 1e-12).mean(-1)).view(B, -1)
    return (loss * ok).sum() / ok.sum().clamp(min=1.0) * weight


@torch.no_grad()
def _inside_labels(polys: torch.Tensor, gt_idx: torch.Tensor,
                   pts: torch.Tensor) -> torch.Tensor:
    """(B, N, P) f32: whether each point lies inside the polygon of its
    box's GT (GT 0 for the background), LABEL_CHUNK rows at a time."""
    B, N = gt_idx.shape
    gi = gt_idx.long().clamp(min=0)
    out = torch.empty(pts.shape[:3], device=pts.device)
    for b in range(B):
        for r in range(0, N, LABEL_CHUNK):
            out[b, r:r + LABEL_CHUNK] = point_in_polygon(
                polys[b][gi[b, r:r + LABEL_CHUNK]],
                pts[b, r:r + LABEL_CHUNK]).float()
    return out


def dense_reppoints_loss(outs: Outs, batch: Mapping[str, torch.Tensor],
                         cfg: DenseRepPointsConfig
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, terms): focal cls, smooth-L1 minmax boxes of both stages,
    chamfer point sets of both stages and the BCE of the mask scores.
    outs: the head's per-level NHWC ``cls``, ``pts_init`` /
    ``pts_refine`` (2P, (x, y) per point) and ``pts_score`` (P) maps;
    batch: ``gt_bboxes``, ``gt_labels``, ``gt_valid``, ``gt_polygons``
    (B, M, 2V), ``pad_shape``."""
    Pn, C = cfg.num_points, cfg.num_classes
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    valid = P.valid_flags(cfg.image_shape, cfg.point_strides,
                          batch["pad_shape"])
    cls = _flat(outs["cls"], C).float()
    pts_init = _pts_img(_flat(outs["pts_init"], 2 * Pn).float(), points)
    pts_refine = _pts_img(_flat(outs["pts_refine"], 2 * Pn).float(), points)
    pts_score = _flat(outs["pts_score"], Pn).float()
    bbox_init, bbox_refine = minmax_bbox(pts_init), minmax_bbox(pts_refine)
    gt_bboxes = batch["gt_bboxes"]
    gt_polys = _gt_polygons(batch)
    gt_contour = resample_polygon(gt_polys, cfg.gt_contour_points)
    init, refine = point_assignments(cfg, points, valid, bbox_init, batch)
    norm1 = cfg.point_base_scale * points[:, 2]
    norm = norm1[None, :, None]
    loss_bbox_init, _ = box_stage_loss(bbox_init, init.gt_idx, gt_bboxes,
                                       norm, cfg.smooth_beta,
                                       cfg.bbox_init_weight)
    loss_bbox_refine, n_pos = box_stage_loss(
        bbox_refine, refine.gt_idx, gt_bboxes, norm, cfg.smooth_beta,
        cfg.bbox_refine_weight)
    Q = cfg.max_pos_chamfer
    loss_pts_init = _chamfer_loss(pts_init, init.gt_idx, gt_contour, norm1,
                                  Q, cfg.pts_init_weight)
    loss_pts_refine = _chamfer_loss(pts_refine, refine.gt_idx, gt_contour,
                                    norm1, Q, cfg.pts_refine_weight)
    loss_cls = refine_cls_loss(cls, refine, valid, batch["gt_labels"], n_pos,
                               cfg)
    # mask scores: BCE at the init points against inside-polygon labels of
    # the refine-assigned GT, over the refine positives
    y = _inside_labels(gt_polys, refine.gt_idx, pts_init.detach())
    posm = (refine.gt_idx >= 0).float()
    ps = pts_score
    bce = ps.clamp(min=0) - ps * y + torch.log1p(torch.exp(-ps.abs()))
    loss_mask = ((bce.mean(-1) * posm).sum() / posm.sum().clamp(min=1.0)
                 * cfg.mask_score_weight)
    losses = {"loss_cls": loss_cls, "loss_bbox_init": loss_bbox_init,
              "loss_bbox_refine": loss_bbox_refine,
              "loss_pts_init": loss_pts_init,
              "loss_pts_refine": loss_pts_refine,
              "loss_mask_score_init": loss_mask}
    return sum(losses.values()), losses


def _contour_targets(polys: torch.Tensor, gt_valid: torch.Tensor,
                     hw: Tuple[int, int], stride: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level's contour targets: (B, h*w) 1 at the cells of the valid
    GTs' polygon vertices, and (B, h*w, 2) the vertices' sub-cell offsets
    (every GT's vertices write theirs, the last write winning)."""
    h, w = hw
    B, M, V, _ = polys.shape
    vx = (polys[..., 0] / stride).clamp(0, w - 1)
    vy = (polys[..., 1] / stride).clamp(0, h - 1)
    xi, yi = vx.to(torch.int32), vy.to(torch.int32)
    cell = (yi * w + xi).reshape(B, -1).long()
    ok = gt_valid[:, :, None].expand(B, M, V).reshape(B, -1).float()
    hm = torch.zeros(B, h * w, device=polys.device)
    hm.scatter_reduce_(1, cell, ok, "amax", include_self=True)
    off = torch.stack([vx - xi, vy - yi], -1).reshape(B, -1, 2)
    om = _scatter_last(torch.zeros(B, h * w, 2, device=polys.device), cell,
                       off)
    return hm, om


def dense_reppoints_v2_loss(outs: Outs, batch: Mapping[str, torch.Tensor],
                            cfg: DenseRepPointsV2Config
                            ) -> Tuple[torch.Tensor,
                                       Dict[str, torch.Tensor]]:
    """v1's terms, then ``loss_cont_heatmap`` / ``loss_cont_offset`` on the
    head's contour maps (``hm_tl`` / ``off_tl``: gaussian-focal at the
    GT polygon vertices' cells, L1 offsets there) and ``loss_sem`` on its
    ``sem`` maps."""
    _, losses = dense_reppoints_loss(outs, batch, cfg)
    gt_polys = _gt_polygons(batch)
    gt_valid = batch["gt_valid"]
    scores, hms, offs, off_ts = [], [], [], []
    for lvl, s in enumerate(cfg.point_strides):
        score = outs["hm_tl"][lvl][..., 0].float()
        off = outs["off_tl"][lvl].float()
        hm_t, off_t = _contour_targets(gt_polys, gt_valid,
                                       tuple(score.shape[1:3]), s)
        scores.append(score.reshape(score.shape[0], -1))
        hms.append(hm_t)
        offs.append(off.reshape(off.shape[0], -1, 2))
        off_ts.append(off_t)
    sc, hm = torch.cat(scores, 1), torch.cat(hms, 1)
    of, oft = torch.cat(offs, 1), torch.cat(off_ts, 1)
    n_pos = hm.sum().clamp(min=1.0)
    losses["loss_cont_heatmap"] = gaussian_focal_loss(
        torch.sigmoid(sc), hm, torch.ones_like(hm),
        avg_factor=n_pos) * cfg.cont_loss_weight
    d = (of - oft).abs().sum(-1)
    losses["loss_cont_offset"] = ((d * hm).sum() / n_pos
                                  * cfg.cont_loss_weight)
    sem_map, sem_w = make_sem_targets(batch["gt_bboxes"], batch["gt_labels"],
                                      gt_valid, cfg.image_shape,
                                      cfg.num_classes)
    losses["loss_sem"] = sem_loss(outs["sem"], sem_map, sem_w,
                                  cfg.sem_loss_weight)
    return sum(losses.values()), losses


# ------------------------------------------------------------------ decode

class DensePointDetections(NamedTuple):
    """Padded detections with their point sets and per-point scores."""
    bboxes: torch.Tensor      # (B, K, 4)
    scores: torch.Tensor      # (B, K)
    labels: torch.Tensor      # (B, K) int32
    pts: torch.Tensor         # (B, K, 2P) xy-interleaved
    pts_scores: torch.Tensor  # (B, K, P)
    valid: torch.Tensor       # (B, K) bool


def dense_reppoints_decode(outs: Outs, img_shapes: torch.Tensor,
                           scale_factors: torch.Tensor, tcfg: TestConfig,
                           cfg: DenseRepPointsConfig, rescale: bool = True
                           ) -> DensePointDetections:
    """Class scores weighted by the mean of the point scores over 0.5,
    minmax boxes of the refined sets, each point's best class, class-wise
    greedy NMS carrying the point sets and their scores."""
    Pn, C = cfg.num_points, cfg.num_classes
    dev = outs["cls"][0].device
    points = P.multi_level_points(cfg.image_shape, cfg.point_strides, dev)
    cls = _flat(outs["cls"], C).float()
    pts = _pts_img(_flat(outs["pts_refine"], 2 * Pn).float(), points)
    pscore = torch.sigmoid(_flat(outs["pts_score"], Pn).float())
    boxes = minmax_bbox(pts)
    B = img_shapes.shape[0]
    shp = img_shapes.to(torch.float32)
    h, w = shp[:, 0].view(B, 1), shp[:, 1].view(B, 1)
    scores = torch.sigmoid(cls)
    over = (pscore > 0.5).float()
    mask_score = (over * pscore).sum(-1) / (over.sum(-1) + 1e-6)
    scores = scores * mask_score[..., None]
    b = torch.stack([torch.minimum(boxes[..., 0].clamp(min=0.0), w),
                     torch.minimum(boxes[..., 1].clamp(min=0.0), h),
                     torch.minimum(boxes[..., 2].clamp(min=0.0), w),
                     torch.minimum(boxes[..., 3].clamp(min=0.0), h)], -1)
    px = torch.minimum(pts[..., 0].clamp(min=0.0), w[..., None] - 1)
    py = torch.minimum(pts[..., 1].clamp(min=0.0), h[..., None] - 1)
    if rescale:
        sf = scale_factors.to(torch.float32)
        b = b / sf[:, None, :]
        px = px / sf[:, None, None, 0]
        py = py / sf[:, None, None, 1]
    smax, lbl = scores.amax(-1), scores.argmax(-1).to(torch.int32)
    cand = torch.where(smax > tcfg.score_thr, smax,
                       torch.full_like(smax, NEG_INF))
    top_s, top_i = _top_stable(cand, min(tcfg.nms_pre, cand.shape[1]))
    keep_idx, keep_s, keep_v = batched_nms(
        _take(b, top_i), top_s, torch.gather(lbl, 1, top_i), tcfg.nms_iou,
        tcfg.max_per_img)
    sel = torch.gather(top_i, 1, keep_idx)
    z = keep_v[..., None].to(b.dtype)
    ptsel = torch.stack([torch.gather(px, 1, sel[..., None].expand(
        -1, -1, Pn)), torch.gather(py, 1, sel[..., None].expand(-1, -1, Pn))],
        -1).flatten(-2)
    return DensePointDetections(
        _take(b, sel) * z, torch.where(keep_v, keep_s,
                                       torch.zeros_like(keep_s)),
        torch.gather(lbl, 1, sel) * keep_v.to(torch.int32), ptsel * z,
        _take(pscore, sel) * z, keep_v)


def dense_points_to_masks(dets, img_hw, pts_score_thr: float = 0.5
                          ) -> List[np.ndarray]:
    """Host-side point sets -> binary masks of one image (the reference
    ``dense_reppoints_detector.py``): linear interpolation of the point
    scores over the detection's box (``scipy.interpolate.griddata``),
    thresholded. ``dets``: one image's fields, (K, ...) tensors or
    arrays, as a ``DensePointDetections``."""
    import scipy.interpolate

    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    img_h, img_w = int(img_hw[0]), int(img_hw[1])
    bboxes, pts = arr(dets.bboxes), arr(dets.pts)
    ps, valid = arr(dets.pts_scores), arr(dets.valid)
    masks = []
    for i in range(bboxes.shape[0]):
        if not valid[i]:
            masks.append(np.zeros((img_h, img_w), np.uint8))
            continue
        bb = bboxes[i].astype(np.int32)
        w = max(bb[2] - bb[0], 1)
        h = max(bb[3] - bb[1], 1)
        p = pts[i].reshape(-1, 2).copy()
        p[:, 0] -= bb[0]
        p[:, 1] -= bb[1]
        corner = np.array([[0, 0], [h - 1, 0], [0, w - 1], [w - 1, h - 1]],
                          np.float32)
        allp = np.concatenate([p, corner], 0)
        alls = np.concatenate([ps[i], np.zeros(4, np.float32)], 0)
        grids = tuple(np.mgrid[0:w:1, 0:h:1])
        try:
            bm = scipy.interpolate.griddata(allp, alls, grids).T
        except Exception:
            bm = np.zeros((h, w), np.float32)
        bm = np.nan_to_num(bm, nan=0.0)
        im = np.zeros((img_h, img_w), np.uint8)
        y2 = min(bb[1] + h, img_h)
        x2 = min(bb[0] + w, img_w)
        if y2 > bb[1] and x2 > bb[0]:
            im[max(bb[1], 0):y2, max(bb[0], 0):x2] = (
                bm[:y2 - max(bb[1], 0), :x2 - max(bb[0], 0)]
                > pts_score_thr)
        masks.append(im)
    return masks
