"""The port's own copy of ``lsnet_tpu/utils/visualize.py`` (numpy + PIL,
host side).

Result visualization (PIL-based; no cv2).

Equivalents of the reference visualizers
(`mmcv/mmcv/visualization/image.py:164-330`):
``imshow_extremes`` (detection: box + 4 extreme points),
``imshow_polygons`` (instance seg contours), ``imshow_pose`` (COCO
skeleton).  Draw onto a numpy RGB image; return the annotated array and
optionally save to disk.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

COCO_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]

_PALETTE = [
    (255, 99, 71), (60, 179, 113), (65, 105, 225), (255, 215, 0),
    (186, 85, 211), (0, 206, 209), (255, 140, 0), (154, 205, 50),
]


def _color(i: int) -> Tuple[int, int, int]:
    return _PALETTE[i % len(_PALETTE)]


def _draw(img: np.ndarray):
    from PIL import Image, ImageDraw
    pil = Image.fromarray(img.astype(np.uint8))
    return pil, ImageDraw.Draw(pil)


def imshow_extremes(img: np.ndarray, bboxes: np.ndarray,
                    extremes: np.ndarray, labels: np.ndarray,
                    scores: Optional[np.ndarray] = None,
                    score_thr: float = 0.3,
                    class_names: Optional[Sequence[str]] = None,
                    out_file: Optional[str] = None) -> np.ndarray:
    """Boxes + extreme-point crosses.  extremes packed
    [xt,y1, x1,yl, xb,y2, x2,yr]."""
    pil, d = _draw(img)
    for i in range(len(bboxes)):
        if scores is not None and scores[i] < score_thr:
            continue
        c = _color(int(labels[i]))
        x1, y1, x2, y2 = bboxes[i][:4]
        d.rectangle([x1, y1, x2, y2], outline=c, width=2)
        pts = extremes[i].reshape(4, 2)
        for px, py in pts:
            d.ellipse([px - 3, py - 3, px + 3, py + 3], fill=c)
        tag = (class_names[int(labels[i])] if class_names
               else str(int(labels[i])))
        if scores is not None:
            tag += f" {scores[i]:.2f}"
        d.text((x1, max(y1 - 12, 0)), tag, fill=c)
    out = np.asarray(pil)
    if out_file:
        pil.save(out_file)
    return out


def imshow_polygons(img: np.ndarray, bboxes: np.ndarray,
                    polygons: np.ndarray, labels: np.ndarray,
                    scores: Optional[np.ndarray] = None,
                    score_thr: float = 0.3,
                    out_file: Optional[str] = None) -> np.ndarray:
    """Contour polygons (xy-interleaved, nv points)."""
    pil, d = _draw(img)
    for i in range(len(polygons)):
        if scores is not None and scores[i] < score_thr:
            continue
        c = _color(int(labels[i]))
        pts = [tuple(p) for p in polygons[i].reshape(-1, 2)]
        d.polygon(pts, outline=c)
    out = np.asarray(pil)
    if out_file:
        pil.save(out_file)
    return out


def imshow_pose(img: np.ndarray, bboxes: np.ndarray, keypoints: np.ndarray,
                scores: Optional[np.ndarray] = None, score_thr: float = 0.3,
                out_file: Optional[str] = None) -> np.ndarray:
    """17-keypoint skeletons (xy-interleaved)."""
    pil, d = _draw(img)
    for i in range(len(keypoints)):
        if scores is not None and scores[i] < score_thr:
            continue
        kp = keypoints[i].reshape(-1, 2)
        for j, (px, py) in enumerate(kp):
            d.ellipse([px - 2, py - 2, px + 2, py + 2], fill=_color(j % 5))
        for a, b in COCO_SKELETON:
            if a < len(kp) and b < len(kp):
                d.line([tuple(kp[a]), tuple(kp[b])], fill=_color(a), width=2)
    out = np.asarray(pil)
    if out_file:
        pil.save(out_file)
    return out
