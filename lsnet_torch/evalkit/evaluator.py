"""The port's own copy of ``lsnet_tpu/evalkit/evaluator.py`` (numpy, host side).

Detection-result packing + COCO metrics.

Host-side equivalent of the reference result/eval plumbing:
``bbox_extreme2result``/``bbox_poly2result``
(`mmdet/core/bbox/transforms.py:198-218`),
``encode_poly_results`` (`core/mask/utils.py:70-85`, polygon -> RLE),
``CocoDataset.evaluate`` (`datasets/coco.py:370-506`) and
``CocoPoseDataset._kps2json``/``evaluate`` (`datasets/coco_pose.py:226-247,
383-`), and the mask detectors' ``get_seg_masks`` paste and segm results
(:func:`paste_mask`, :func:`mask_detections_to_coco`).  Consumes the padded on-device :class:`Detections` and produces
COCO-format dicts for :mod:`lsnet_torch.evalkit.cocoeval`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cocoeval import COCOEval, EvalParams
from . import rle as maskUtils


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def detections_to_coco(det, img_ids: Sequence[int],
                       label_to_cat: Dict[int, int], task: str = "bbox",
                       img_sizes: Optional[Dict[int, Tuple[int, int]]] = None
                       ) -> List[Dict]:
    """Padded batched Detections -> COCO result dicts (host side).

    det fields are (B, K, ...) arrays: numpy, or the port's
    :class:`lsnet_torch.core.decode.Detections`, moved to host numpy here
    once per batch.
    """
    results: List[Dict] = []
    bboxes, scores, labels, lms, valid = (
        _host(det.bboxes), _host(det.scores), _host(det.labels),
        _host(det.landmarks), _host(det.valid))
    if task in ("pose_bbox", "pose_kbox"):
        # reference simple_test drops tiny pose detections
        # (`detectors/lsnet.py:85-92`: area must exceed 1024)
        areas = ((bboxes[..., 2] - bboxes[..., 0])
                 * (bboxes[..., 3] - bboxes[..., 1]))
        valid = valid & (areas > 1024.0)
    B = bboxes.shape[0]
    for b in range(B):
        img_id = int(img_ids[b])
        for k in np.flatnonzero(valid[b]):
            x1, y1, x2, y2 = bboxes[b, k]
            entry = {
                "image_id": img_id,
                "category_id": label_to_cat[int(labels[b, k])],
                "bbox": [float(x1), float(y1), float(x2 - x1),
                         float(y2 - y1)],
                "score": float(scores[b, k]),
                "area": float((x2 - x1) * (y2 - y1)),
            }
            if task == "segm":
                h, w = img_sizes[img_id]
                poly = lms[b, k].astype(np.float64)
                r = maskUtils.rle_from_polygon(poly, h, w)
                entry["segmentation"] = {
                    "size": [h, w], "counts": maskUtils.rle_to_string(r)}
                entry["area"] = float(maskUtils.area(r))
            elif task in ("pose_bbox", "pose_kbox"):
                kp = lms[b, k].reshape(-1, 2)
                kps = np.concatenate(
                    [kp, np.full((kp.shape[0], 1), 1.0)], axis=1).reshape(-1)
                entry["keypoints"] = [float(v) for v in kps]
            results.append(entry)
    return results


def coco_gt_from_annotations(coco_anns, task: str = "bbox") -> List[Dict]:
    """CocoAnnotations -> flat GT dicts for COCOEval."""
    gts = []
    aid = 0
    for info in coco_anns.img_infos:
        for ann in coco_anns.anns_by_img.get(info["id"], []):
            aid += 1
            g = {
                "id": ann.get("id", aid),
                "image_id": info["id"],
                "category_id": ann["category_id"],
                "bbox": ann["bbox"],
                "area": ann.get("area", ann["bbox"][2] * ann["bbox"][3]),
                "iscrowd": ann.get("iscrowd", 0),
            }
            if task == "segm":
                g["segmentation"] = ann.get("segmentation")
            if task.startswith("pose"):
                g["keypoints"] = ann.get("keypoints", [])
                g["num_keypoints"] = ann.get("num_keypoints", 0)
                if g["num_keypoints"] == 0:
                    g["ignore"] = 1
            gts.append(g)
    return gts


def evaluate_coco(gts: List[Dict], dts: List[Dict],
                  img_sizes: Dict[int, Tuple[int, int]],
                  iou_type: str = "bbox") -> Dict[str, float]:
    """Run COCOEval, return the named metric dict (reference log format)."""
    if not dts:
        return {f"{iou_type}_mAP": 0.0}
    params = (EvalParams.for_keypoints() if iou_type == "keypoints"
              else EvalParams(iou_type=iou_type))
    ev = COCOEval(gts, dts, img_sizes, params).evaluate()
    stats = ev.summarize()
    if iou_type == "keypoints":
        names = ["AP", "AP50", "AP75", "APm", "APl",
                 "AR", "AR50", "AR75", "ARm", "ARl"]
    else:
        names = ["mAP", "mAP_50", "mAP_75", "mAP_s", "mAP_m", "mAP_l",
                 "AR@1", "AR@10", "AR@100", "AR_s", "AR_m", "AR_l"]
    return {f"{iou_type}_{n}": float(v) for n, v in zip(names, stats)}



def paste_mask(mask28: np.ndarray, bbox: np.ndarray, img_hw,
               thr: float = 0.5) -> np.ndarray:
    """Paste an (oh, ow) mask probability crop into the full image frame
    (the reference ``FCNMaskHead.get_seg_masks``' bilinear paste): the
    crop resized to the box rounded to whole pixels, thresholded at
    ``thr``, the part inside the image kept. -> (H, W) uint8."""
    H, W = img_hw
    x1, y1, x2, y2 = bbox
    w = max(int(round(x2 - x1)), 1)
    h = max(int(round(y2 - y1)), 1)
    oh, ow = mask28.shape
    ys = (np.arange(h) + 0.5) * oh / h - 0.5
    xs = (np.arange(w) + 0.5) * ow / w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, oh - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, ow - 1)
    y1i = np.clip(y0 + 1, 0, oh - 1)
    x1i = np.clip(x0 + 1, 0, ow - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    m = (mask28[y0][:, x0] * (1 - wy) * (1 - wx)
         + mask28[y0][:, x1i] * (1 - wy) * wx
         + mask28[y1i][:, x0] * wy * (1 - wx)
         + mask28[y1i][:, x1i] * wy * wx)
    out = np.zeros((H, W), np.uint8)
    ox, oy = int(round(x1)), int(round(y1))
    sx1, sy1 = max(-ox, 0), max(-oy, 0)
    dx1, dy1 = max(ox, 0), max(oy, 0)
    dx2 = min(ox + w, W)
    dy2 = min(oy + h, H)
    if dx2 > dx1 and dy2 > dy1:
        out[dy1:dy2, dx1:dx2] = (
            m[sy1:sy1 + dy2 - dy1, sx1:sx1 + dx2 - dx1] >= thr)
    return out


def mask_detections_to_coco(det, masks, img_ids: Sequence[int],
                            label_to_cat: Dict[int, int],
                            img_sizes: Dict[int, Tuple[int, int]]
                            ) -> List[Dict]:
    """A mask detector's valid detections -> COCO segm results: each
    mask crop pasted into its image (:func:`paste_mask`) and RLE-encoded
    with the package's codec. ``det`` and ``masks`` (B, K, oh, ow) as
    numpy or the port's tensors."""
    bboxes, scores, labels, valid = (_host(det.bboxes), _host(det.scores),
                                     _host(det.labels), _host(det.valid))
    masks = _host(masks)
    dts: List[Dict] = []
    for b in range(bboxes.shape[0]):
        img_id = int(img_ids[b])
        H, W = img_sizes[img_id]
        for k in range(bboxes.shape[1]):
            if not valid[b, k]:
                continue
            full = paste_mask(masks[b, k], bboxes[b, k], (H, W))
            r = maskUtils.encode_mask(full)
            x1, y1, x2, y2 = np.asarray(bboxes[b, k], np.float64)
            dts.append(dict(
                image_id=img_id,
                category_id=label_to_cat[int(labels[b, k])],
                bbox=[x1, y1, x2 - x1, y2 - y1],
                score=float(scores[b, k]),
                segmentation=dict(size=[int(H), int(W)],
                                  counts=maskUtils.rle_to_string(r))))
    return dts
