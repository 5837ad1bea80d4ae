"""The port's own copy of ``lsnet_tpu/evalkit/tta.py`` (numpy, host side;
the device route of the vote is :mod:`lsnet_torch.ops.vote`, torch on the
card unless ``device`` says otherwise).

Test-time augmentation: multi-scale/flip merging + soft-voting.

Host-side (numpy) re-derivation of the reference TTA stack — it is
eval-only and inherently sequential:

* packed-detection flip maps (`mmdet/core/bbox/
  transforms.py:5-90`: bbox_flip, extreme_flip, polygon_flip with origin
  re-roll, kps_flip with left/right joint swap) and
  ``instance_mapping_back`` (:116-137);
* per-scale box-size filtering ``remove_boxes``
  (`models/detectors/lsnet.py:156-161`);
* IoU-weighted **soft voting** ``bboxes_vote``/``instances_vote``
  (`lsnet.py:163-299`): clusters at IoU>=0.66 merge into a
  score-weighted average box/landmark keeping the max score, with decayed
  ``score*(1-iou)`` leftovers re-entering above 0.05;
* the vote entry ``aug_test_vote`` (`lsnet.py:301-396`): per-class
  voting, top-1000 cap, small-area filtering for pose (area>1024).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

KEYPOINT_FLIP_IDX = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                     [13, 14], [15, 16]]


# ------------------------------------------------------------------ flip maps

def bbox_flip(bboxes: np.ndarray, img_shape) -> np.ndarray:
    out = bboxes.copy()
    w = img_shape[1]
    out[:, 0::4] = w - bboxes[:, 2::4]
    out[:, 2::4] = w - bboxes[:, 0::4]
    return out


def extreme_flip(extremes: np.ndarray, img_shape) -> np.ndarray:
    """Packed [xt,y1, x1,yl, xb,y2, x2,yr] horizontal flip."""
    e = extremes
    f = e.copy()
    w = img_shape[1]
    f[:, 0] = w - e[:, 0]
    f[:, 2] = w - e[:, 6]
    f[:, 3] = e[:, 7]
    f[:, 4] = w - e[:, 4]
    f[:, 6] = w - e[:, 2]
    f[:, 7] = e[:, 3]
    return f


def polygon_flip(polygons: np.ndarray, img_shape) -> np.ndarray:
    """x-mirror + cyclic point-order reversal (keeps clockwise + start)."""
    f = polygons.copy()
    f[:, 0::2] = img_shape[1] - f[:, 0::2]
    if f.shape[0] > 0:
        x = f.reshape(f.shape[0], -1, 2)
        rev = x[:, ::-1]
        new_x = np.zeros_like(x)
        new_x[:, 1:] = rev[:, :-1]
        new_x[:, 0] = rev[:, -1]
        f = new_x.reshape(f.shape[0], -1)
    return f


def kps_flip(kps: np.ndarray, img_shape) -> np.ndarray:
    f = kps.copy()
    if f.shape[0] > 0:
        f[:, 0::2] = img_shape[1] - f[:, 0::2]
        f3 = f.reshape(f.shape[0], -1, 2)
        for a, b in KEYPOINT_FLIP_IDX:
            f3[:, [a, b]] = f3[:, [b, a]]
        f = f3.reshape(f.shape[0], -1)
    return f


def instance_mapping_back(bboxes: np.ndarray, vectors: np.ndarray,
                          img_shape, scale_factor: np.ndarray, flip: bool,
                          task: str) -> Tuple[np.ndarray, np.ndarray]:
    """Augmented-image coords -> original-image coords."""
    bb = bbox_flip(bboxes, img_shape) if flip else bboxes
    bb = bb / np.asarray(scale_factor, np.float64)
    if flip:
        if task == "bbox":
            vectors = extreme_flip(vectors, img_shape)
        elif task == "segm":
            vectors = polygon_flip(vectors, img_shape)
        else:
            vectors = kps_flip(vectors, img_shape)
    sf2 = np.tile(np.asarray(scale_factor[:2], np.float64),
                  vectors.shape[1] // 2)
    return bb, vectors / sf2


# ------------------------------------------------------------------ voting

def remove_boxes(boxes: np.ndarray, min_scale: float, max_scale: float
                 ) -> np.ndarray:
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return np.flatnonzero((areas >= min_scale ** 2)
                          & (areas <= max_scale ** 2))


def instances_vote(boxes: np.ndarray, vectors: np.ndarray,
                   scores: np.ndarray, vote_thresh: float = 0.66):
    """Soft-voting cluster merge; returns (boxes, vectors, scores)."""
    eps = 1e-6
    P = vectors.shape[1]
    det = np.concatenate([boxes, scores.reshape(-1, 1), vectors], axis=1)
    if det.shape[0] <= 1:
        return (np.zeros((0, 4)), np.zeros((0, P)), np.zeros((0,)))
    det = det[np.argsort(-det[:, 4], kind="stable")]
    dets = None
    while det.shape[0] > 0:
        area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
        xx1 = np.maximum(det[0, 0], det[:, 0])
        yy1 = np.maximum(det[0, 1], det[:, 1])
        xx2 = np.minimum(det[0, 2], det[:, 2])
        yy2 = np.minimum(det[0, 3], det[:, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        union = np.maximum(area[0] + area - inter, eps)
        o = inter / union
        o[0] = 1
        merge_idx = np.flatnonzero(o >= vote_thresh)
        cluster = det[merge_idx]
        cluster_iou = o[merge_idx]
        det = np.delete(det, merge_idx, axis=0)
        if merge_idx.shape[0] <= 1:
            add = cluster
        else:
            soft = cluster.copy()
            soft[:, 4] *= (1 - cluster_iou)
            soft = soft[soft[:, 4] >= 0.05]
            weighted = cluster.copy()
            weighted[:, 0:4] *= cluster[:, 4:5]
            weighted[:, 5:] *= cluster[:, 4:5]
            merged = np.zeros((1, 5 + P))
            s = cluster[:, 4].sum()
            merged[0, 0:4] = weighted[:, 0:4].sum(axis=0) / s
            merged[0, 5:] = weighted[:, 5:].sum(axis=0) / s
            merged[0, 4] = cluster[:, 4].max()
            add = (np.concatenate([merged, soft], axis=0)
                   if soft.shape[0] else merged)
        dets = add if dets is None else np.concatenate([dets, add], axis=0)
    dets = dets[np.argsort(-dets[:, 4], kind="stable")]
    return dets[:, :4], dets[:, 5:], dets[:, 4]


def aug_test_vote(aug_results: Sequence[Dict], metas: Sequence[Dict],
                  scale_ranges: Sequence[Tuple[float, float]], *,
                  task: str = "bbox", num_classes: int = 80,
                  max_keep: int = 1000, pose_min_area: float = 1024.0,
                  vote_thresh: float = 0.66, use_device: bool = True,
                  device="cuda"):
    """Merge per-augmentation detections by per-class soft voting.

    Args:
      aug_results: per aug dicts with 'bboxes' (n,4), 'scores' (n,),
        'labels' (n,), 'vectors' (n, 2nv) — already NMS'd in aug coords.
      metas: per aug dicts with 'img_shape', 'scale_factor', 'flip'.
      scale_ranges: (min, max) sqrt-area keep range per *scale* (aug i uses
        scale_ranges[i // 2]: each scale appears with and without flip).

    Returns dict with merged 'bboxes', 'scores', 'labels', 'vectors' in
    original-image coordinates. With ``use_device`` the per-class votes
    run as one :func:`lsnet_torch.ops.vote.instances_vote_batch` call on
    ``device`` (the card by default); without, through the numpy
    :func:`instances_vote`, the oracle.
    """
    all_boxes, all_scores, all_labels, all_vectors = [], [], [], []
    for i, (res, meta) in enumerate(zip(aug_results, metas)):
        boxes = np.asarray(res["bboxes"], np.float64)
        scores = np.asarray(res["scores"], np.float64)
        labels = np.asarray(res["labels"], np.int64)
        vectors = np.asarray(res["vectors"], np.float64)
        keep = remove_boxes(boxes, *scale_ranges[i // 2])
        boxes, scores = boxes[keep], scores[keep]
        labels, vectors = labels[keep], vectors[keep]
        boxes, vectors = instance_mapping_back(
            boxes, vectors, meta["img_shape"], meta["scale_factor"],
            meta.get("flip", False), task)
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_labels.append(labels)
        all_vectors.append(vectors)
    boxes = np.concatenate(all_boxes)
    scores = np.concatenate(all_scores)
    labels = np.concatenate(all_labels)
    vectors = np.concatenate(all_vectors)

    out_b, out_v, out_s, out_l = [], [], [], []
    present = [j for j in range(num_classes)
               if np.any(labels == j)] if labels.size else []
    if use_device and present:
        # one batched device call over the present classes
        # (ops/vote.instances_vote_batch); numpy path is the oracle
        import torch

        from ..ops.vote import instances_vote_batch
        nv2 = vectors.shape[1]
        N = max(int(np.max([np.sum(labels == j) for j in present])), 2)
        K = len(present)
        pb = np.zeros((K, N, 4), np.float32)
        pv = np.zeros((K, N, nv2), np.float32)
        ps = np.zeros((K, N), np.float32)
        pm = np.zeros((K, N), bool)
        for kk, j in enumerate(present):
            idx = np.flatnonzero(labels == j)
            idx = idx[np.argsort(-scores[idx], kind="stable")]
            pb[kk, :idx.size] = boxes[idx]
            pv[kk, :idx.size] = vectors[idx]
            ps[kk, :idx.size] = scores[idx]
            pm[kk, :idx.size] = True
        ob, ov, os_, ok = (x.cpu().numpy() for x in instances_vote_batch(
            *(torch.from_numpy(a).to(device) for a in (pb, pv, ps, pm)),
            vote_thresh=vote_thresh))
        for kk, j in enumerate(present):
            m = ok[kk]
            if m.any():
                out_b.append(ob[kk][m])
                out_v.append(ov[kk][m])
                out_s.append(os_[kk][m])
                out_l.append(np.full(int(m.sum()), j, np.int64))
    else:
        for j in present:
            idx = np.flatnonzero(labels == j)
            bj, vj, sj = instances_vote(boxes[idx], vectors[idx],
                                        scores[idx], vote_thresh)
            if bj.shape[0]:
                out_b.append(bj)
                out_v.append(vj)
                out_s.append(sj)
                out_l.append(np.full(bj.shape[0], j, np.int64))
    if not out_b:
        nv2 = vectors.shape[1] if vectors.size else 8
        return dict(bboxes=np.zeros((0, 4)), scores=np.zeros(0),
                    labels=np.zeros(0, np.int64), vectors=np.zeros((0, nv2)))
    boxes = np.concatenate(out_b)
    vectors = np.concatenate(out_v)
    scores = np.concatenate(out_s)
    labels = np.concatenate(out_l)
    if boxes.shape[0] > max_keep:
        thr = np.partition(scores, boxes.shape[0] - max_keep)[
            boxes.shape[0] - max_keep]
        keep = scores >= thr
        boxes, vectors = boxes[keep], vectors[keep]
        scores, labels = scores[keep], labels[keep]
    if task.startswith("pose"):
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = areas > pose_min_area
        boxes, vectors = boxes[keep], vectors[keep]
        scores, labels = scores[keep], labels[keep]
    return dict(bboxes=boxes, scores=scores, labels=labels, vectors=vectors)
