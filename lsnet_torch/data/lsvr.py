"""The port's own copy of ``lsnet_tpu/data/lsvr.py`` (numpy, host side).

LSVR annotation preprocessing (host-side numpy).

Library re-implementations of the reference's offline/load-time landmark
machinery:

* :func:`get_extreme_points` — the ExtremeNet 2%-band extreme-point
  extraction (`tools/gen_coco_lsvr.py:21-78`), run as
  a library function instead of an offline json rewrite, so plain COCO
  ``instances_*.json`` works directly.
* :func:`uniform_sample` — snake-style contour resampling
  (`code/mmdet/datasets/pipelines/loading.py:314-376`).
* :func:`unify_polygon` — filter tiny / resample to ``nv`` points /
  clockwise / origin at top-center (`loading.py:396-441`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def get_extreme_points(pts: np.ndarray, thresh: float = 0.02) -> np.ndarray:
    """Extreme points (t, l, b, r) of a point set with band averaging.

    pts: (P, 2) polygon vertices (x, y). Returns (4, 2) [[tx,ty],[lx,ly],
    [bx,by],[rx,ry]] — same convention and integer // 2 midpoints as the
    reference so generated targets agree bit-for-bit.
    """
    l, t = pts[:, 0].min(), pts[:, 1].min()
    r, b = pts[:, 0].max(), pts[:, 1].max()
    w = r - l + 1
    h = b - t + 1
    ext = np.concatenate([pts[-1:], pts, pts[:1]], axis=0)

    def band(axis: int, sign: int, lim: float, span: float):
        """indices within thresh*span of the argmin/argmax along axis."""
        vals = ext[:, axis]
        idx = int(np.argmin(vals)) if sign < 0 else int(np.argmax(vals))
        idxs = [idx]
        tmp = idx + 1
        while tmp < ext.shape[0] and sign * (vals[tmp] - vals[idx]) <= thresh * span:
            idxs.append(tmp)
            tmp += 1
        tmp = idx - 1
        while tmp >= 0 and sign * (vals[tmp] - vals[idx]) <= thresh * span:
            idxs.append(tmp)
            tmp -= 1
        other = ext[idxs, 1 - axis]
        return (other.max() + other.min()) // 2

    tt = [band(1, -1, t, h), t]
    bb = [band(1, +1, b, h), b]
    ll = [l, band(0, -1, l, w)]
    rr = [r, band(0, +1, r, w)]
    return np.array([tt, ll, bb, rr], dtype=np.float64)


def extreme_points_with_center(pts: np.ndarray, bbox: np.ndarray) -> np.ndarray:
    """-> (10,) [tx,ty, lx,ly, bx,by, rx,ry, cx,cy] (cx/cy from bbox center,
    `gen_coco_lsvr.py:108-111`)."""
    ep = get_extreme_points(pts).reshape(-1)
    cx = (bbox[0] + bbox[2]) / 2.0
    cy = (bbox[1] + bbox[3]) / 2.0
    return np.concatenate([ep, [cx, cy]]).astype(np.float32)


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area, (P, 2)."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def is_clockwise(poly: np.ndarray) -> bool:
    """'Clockwise' in the reference's sense: shapely ``is_ccw`` False
    (standard signed shoelace area <= 0)."""
    x, y = poly[:, 0], poly[:, 1]
    # s = -2 * standard signed area
    s = np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1))
    return s >= 0


def uniform_sample(poly: np.ndarray, new_num: int) -> np.ndarray:
    """Resample a closed contour to ``new_num`` points (snake algorithm):
    drop shortest edges when shrinking, distribute points along edges
    proportionally to length when growing."""
    pnum = poly.shape[0]
    nxt = poly[(np.arange(pnum) + 1) % pnum]
    edge_len = np.sqrt(((nxt - poly) ** 2).sum(axis=1))
    order = np.argsort(edge_len)

    if pnum > new_num:
        keep = np.sort(order[pnum - new_num:])
        return poly[keep]

    counts = np.round(edge_len * new_num / max(edge_len.sum(), 1e-12)).astype(np.int64)
    counts = np.maximum(counts, 1)
    excess = counts.sum() - new_num
    if excess > 0:
        i = -1
        while excess > 0:
            e = order[i]
            take = min(excess, counts[e] - 1)
            counts[e] -= take
            excess -= take
            i -= 1
    elif excess < 0:
        counts[order[-1]] += -excess
    assert counts.sum() == new_num

    out = []
    for i in range(pnum):
        k = counts[i]
        t = (np.arange(k, dtype=np.float64) / k)[:, None]
        out.append(poly[i:i + 1] * (1 - t) + nxt[i:i + 1] * t)
    return np.concatenate(out, axis=0)


def unify_origin(poly: np.ndarray) -> np.ndarray:
    """Roll so the first point is nearest the top-center of the extent."""
    tcx = (poly[:, 0].min() + poly[:, 0].max()) / 2.0
    tcy = poly[:, 1].min()
    d = (poly[:, 0] - tcx) ** 2 + (poly[:, 1] - tcy) ** 2
    return np.roll(poly, -int(d.argmin()), axis=0)


def unify_polygon(polygons: Sequence[np.ndarray], gt_bbox: np.ndarray, *,
                  num_points: int = 36, spline_num: int = 10) -> np.ndarray:
    """Instance polygon components -> one (num_points, 2) normalized contour.

    Picks the max-area component (the reference defers that choice to
    ``process_polygons`` at loss time, `lsnet_head.py:1727-1737`; we do it
    here once), resamples to ``num_points*spline_num`` then strides down,
    makes it clockwise, and sets the origin near top-center.  Falls back to
    the bbox rectangle when every component is tiny (`loading.py:422-430`).
    """
    polys = [np.asarray(p, np.float64).reshape(-1, 2) for p in polygons]
    polys = [p for p in polys
             if (p.shape[0] >= 3
                 and p[:, 0].max() - p[:, 0].min() >= 1
                 and p[:, 1].max() - p[:, 1].min() >= 1
                 and polygon_area(p) > 5)]
    if not polys:
        x1, y1, x2, y2 = gt_bbox[:4]
        polys = [np.array([[x1, y1], [x1, y2], [x2, y2], [x2, y1]],
                          np.float64)]
    areas = [polygon_area(p) for p in polys]
    poly = polys[int(np.argmax(areas))]
    sampled = uniform_sample(poly, num_points * spline_num)
    sub = sampled[::spline_num]
    if not is_clockwise(sub):
        sub = sub[::-1]
    return unify_origin(sub).astype(np.float32)
