"""The port's own copy of ``lsnet_tpu/evalkit/rle.py`` (numpy, host side).

COCO-compatible RLE mask backend.

Clean-room re-derivation of the vendored pycocotools C core
(`cocoapi/pycocotools/common/maskApi.c`, 231 LoC):
column-major run-length masks with the same polygon rasterization
(5x supersampled boundary walk + column-crossing parity, ``rleFrPoly``
:162-202), IoU (``rleIou``), area, merge, and the 6-bit LEB128-style string
codec (``rleToString``/``rleFrString`` :204-232).  Matching the original
rasterization bit-for-bit keeps segm AP comparable with published numbers.

The reference ships this as C+Cython; here the hot paths (IoU matrices over
run-length pairs) are vectorized numpy. The JAX package's optional ctypes
C++ kernel (``native_rle.py``, built at import) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


@dataclass
class RLE:
    h: int
    w: int
    cnts: np.ndarray  # uint32 run lengths, starting with background


# ---------------------------------------------------------------- encode/decode

def encode_mask(mask: np.ndarray) -> RLE:
    """Binary (h, w) mask -> RLE (column-major runs)."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).reshape(-1, order="F")
    if flat.size == 0:
        return RLE(h, w, np.zeros(0, np.uint32))
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    idx = np.concatenate([[0], change, [flat.size]])
    cnts = np.diff(idx).astype(np.uint32)
    if flat[0]:  # must start with a background run
        cnts = np.concatenate([[np.uint32(0)], cnts])
    return RLE(h, w, cnts)


def decode_mask(r: RLE) -> np.ndarray:
    total = r.h * r.w
    vals = np.zeros(total, bool)
    pos = 0
    v = False
    for c in r.cnts:
        c = int(c)
        if v:
            vals[pos:pos + c] = True
        pos += c
        v = not v
    return vals.reshape((r.h, r.w), order="F")


def area(r: RLE) -> int:
    return int(r.cnts[1::2].sum())


def to_bbox(r: RLE) -> np.ndarray:
    """RLE -> [x, y, w, h] tight box (maskApi ``rleToBbox``)."""
    m = decode_mask(r)
    ys, xs = np.nonzero(m)
    if ys.size == 0:
        return np.zeros(4, np.float64)
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1], np.float64)


# ---------------------------------------------------------------- string codec

def rle_to_string(r: RLE) -> str:
    """6-bit LEB128-with-delta codec (ascii 48..111)."""
    s = []
    cnts = r.cnts.astype(np.int64)
    for i, c in enumerate(cnts):
        x = int(c)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            sign = ch & 0x10
            more = not (x == 0 and not sign or x == -1 and sign)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return "".join(s)


def rle_from_string(s: Union[str, bytes], h: int, w: int) -> RLE:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            ch = ord(s[i]) - 48
            x |= (ch & 0x1F) << (5 * k)
            more = bool(ch & 0x20)
            if not more and (ch & 0x10):
                x |= -1 << (5 * k + 5)
            i += 1
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return RLE(h, w, np.asarray(cnts, np.uint32))


# ---------------------------------------------------------------- from polygon

def rle_from_polygon(xy: Sequence[float], h: int, w: int) -> RLE:
    """Polygon (flat [x0,y0,x1,y1,...]) -> RLE, exactly the reference
    ``rleFrPoly`` algorithm (5x supersample boundary walk, column-crossing
    parity, column-major runs)."""
    xy = np.asarray(xy, np.float64).reshape(-1, 2)
    k = xy.shape[0]
    scale = 5.0
    x = np.round(scale * xy[:, 0]).astype(np.int64)
    y = np.round(scale * xy[:, 1]).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    # dense boundary points via DDA along each edge
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs_, xe, ys_, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs_), abs(ys_ - ye)
        flip = (dx >= dy and xs_ > xe) or (dx < dy and ys_ > ye)
        if flip:
            xs_, xe = xe, xs_
            ys_, ye = ye, ys_
        if dx >= dy:
            s = (ye - ys_) / dx if dx else 0.0
            d = np.arange(dx + 1)
            t = (dx - d) if flip else d
            us.append(t + xs_)
            vs.append(np.floor(ys_ + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs_) / dy if dy else 0.0
            d = np.arange(dy + 1)
            t = (dy - d) if flip else d
            vs.append(t + ys_)
            us.append(np.floor(xs_ + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # column crossings, downsampled to pixel grid
    du = u[1:] != u[:-1]
    uj, ujm1 = u[1:][du], u[:-1][du]
    vj, vjm1 = v[1:][du], v[:-1][du]
    xd = np.where(uj < ujm1, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    ok = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    xd = xd[ok]
    yd = np.minimum(vj, vjm1)[ok].astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.clip(yd, 0, h)
    yd = np.ceil(yd)

    a = (xd.astype(np.int64) * h + yd.astype(np.int64)).astype(np.uint32)
    a = np.sort(np.append(a, np.uint32(h * w)))
    # successive difference -> toggle runs; merge zero-diffs (double
    # crossings cancel)
    diffs = np.empty_like(a)
    diffs[0] = a[0]
    diffs[1:] = a[1:] - a[:-1]
    b: List[int] = [int(diffs[0])]
    j = 1
    n = len(diffs)
    while j < n:
        if diffs[j] > 0:
            b.append(int(diffs[j]))
            j += 1
        else:
            j += 1
            if j < n:
                b[-1] += int(diffs[j])
                j += 1
    return RLE(h, w, np.asarray(b, np.uint32))


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    """Union/intersection of masks (maskApi ``rleMerge``)."""
    if not rles:
        return RLE(0, 0, np.zeros(0, np.uint32))
    m = decode_mask(rles[0])
    for r in rles[1:]:
        m = (m & decode_mask(r)) if intersect else (m | decode_mask(r))
    return encode_mask(m)


def _runs_to_intervals(cnts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """RLE counts -> (starts, ends) of foreground runs in flat F-order."""
    ends = np.cumsum(cnts.astype(np.int64))
    starts = ends - cnts.astype(np.int64)
    return starts[1::2], ends[1::2]


def rle_intersection(a: RLE, b: RLE) -> int:
    """|A ∩ B| via interval sweep over foreground runs."""
    sa, ea = _runs_to_intervals(a.cnts)
    sb, eb = _runs_to_intervals(b.cnts)
    if sa.size == 0 or sb.size == 0:
        return 0
    i = j = 0
    inter = 0
    while i < sa.size and j < sb.size:
        lo = max(sa[i], sb[j])
        hi = min(ea[i], eb[j])
        if hi > lo:
            inter += hi - lo
        if ea[i] < eb[j]:
            i += 1
        else:
            j += 1
    return int(inter)


def iou(dt: Sequence[Union[RLE, np.ndarray]], gt: Sequence[Union[RLE, np.ndarray]],
        iscrowd: Sequence[bool]) -> np.ndarray:
    """maskApi ``rleIou``/``bbIou``: (D, G) IoU matrix; crowd GT uses
    |D∩G| / |D|."""
    D, G = len(dt), len(gt)
    out = np.zeros((D, G), np.float64)
    if D == 0 or G == 0:
        return out
    if isinstance(dt[0], np.ndarray):  # bbox mode: [x, y, w, h]
        for d in range(D):
            xd, yd_, wd, hd = dt[d]
            ad = wd * hd
            for g in range(G):
                xg, yg, wg, hg = gt[g]
                iw = min(xd + wd, xg + wg) - max(xd, xg)
                ih = min(yd_ + hd, yg + hg) - max(yd_, yg)
                if iw <= 0 or ih <= 0:
                    continue
                inter = iw * ih
                union = ad if iscrowd[g] else ad + wg * hg - inter
                out[d, g] = inter / union if union > 0 else 0.0
        return out
    for d in range(D):
        ad = area(dt[d])
        for g in range(G):
            inter = rle_intersection(dt[d], gt[g])
            union = ad if iscrowd[g] else ad + area(gt[g]) - inter
            out[d, g] = inter / union if union > 0 else 0.0
    return out


def frPyObjects(obj, h: int, w: int):
    """pycocotools.mask.frPyObjects equivalent for polygons / rle dicts /
    uncompressed counts lists."""
    if isinstance(obj, dict):
        if isinstance(obj["counts"], (list, np.ndarray)):
            return RLE(h, w, np.asarray(obj["counts"], np.uint32))
        return rle_from_string(obj["counts"], obj["size"][0], obj["size"][1])
    if isinstance(obj, (list, np.ndarray)) and len(obj) and not np.isscalar(obj[0]):
        return [rle_from_polygon(p, h, w) for p in obj]
    return rle_from_polygon(obj, h, w)


def segm_to_rle(segm, h: int, w: int) -> RLE:
    """Any COCO segmentation payload -> single merged RLE."""
    if isinstance(segm, list):
        rles = [rle_from_polygon(p, h, w) for p in segm]
        return merge(rles) if len(rles) > 1 else rles[0]
    return frPyObjects(segm, h, w)
