"""The port's own copy of ``lsnet_tpu/data/transforms.py`` (numpy, host side).

Deterministic geometric augmentation for images + landmark fields.

Host-side numpy twin of the reference pipeline transforms
(`mmdet/datasets/pipelines/transforms.py`): keep-ratio
Resize (:185-241), horizontal RandomFlip with landmark-aware index remaps
(extremes :354-388 — t/b mirror x and keep y, l<->r swap; keypoints
:390-403 — x mirror + left/right joint swap; polygons — mirror + reverse to
stay clockwise), Normalize, Pad-to-divisor.

Everything takes and returns a plain ``sample`` dict; the random decisions
are passed in (drawn by the loader) so transforms stay pure and testable.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# COCO person keypoint left/right pairs (reference `transforms.py:322`)
KEYPOINT_FLIP_IDX = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                     [13, 14], [15, 16]]


def rescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """Keep-ratio target size for (max_long, max_short) scale (mmcv
    ``rescale_size`` semantics)."""
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def _as_scale_list(img_scale) -> list:
    """Normalize an img_scale spec (one (l,s) tuple or a list of them) to a
    list of tuples."""
    if isinstance(img_scale, (list, tuple)) and len(img_scale) and \
            isinstance(img_scale[0], (list, tuple, np.ndarray)):
        return [tuple(int(v) for v in s) for s in img_scale]
    return [tuple(int(v) for v in img_scale)]


def sample_scale(img_scale, multiscale_mode: str = "range",
                 ratio_range: Optional[Tuple[float, float]] = None,
                 rng: Optional[np.random.RandomState] = None
                 ) -> Tuple[int, int]:
    """Draw one concrete scale for a training sample.

    Reference semantics (`mmdet/datasets/pipelines/
    transforms.py:79-176`):

    * ``ratio_range`` given (single base scale): uniform ratio in range,
      scale = (int(l*r), int(s*r))  — ``random_sample_ratio``.
    * two scales + ``multiscale_mode='range'``: long edge ~ U[min_l, max_l],
      short edge ~ U[min_s, max_s] independently — ``random_sample``.
    * list + ``multiscale_mode='value'``: pick one — ``random_select``.
    * single scale: returned as-is.
    """
    rng = rng if rng is not None else np.random
    scales = _as_scale_list(img_scale)
    if ratio_range is not None:
        if len(scales) != 1:
            raise ValueError("ratio_range requires a single base img_scale")
        lo, hi = ratio_range
        r = rng.random_sample() * (hi - lo) + lo
        return (int(scales[0][0] * r), int(scales[0][1] * r))
    if len(scales) == 1:
        return scales[0]
    if multiscale_mode == "range":
        if len(scales) != 2:
            raise ValueError("'range' mode needs exactly 2 img_scales")
        longs = [max(s) for s in scales]
        shorts = [min(s) for s in scales]
        long_edge = int(rng.randint(min(longs), max(longs) + 1))
        short_edge = int(rng.randint(min(shorts), max(shorts) + 1))
        return (long_edge, short_edge)
    if multiscale_mode == "value":
        return scales[int(rng.randint(len(scales)))]
    raise ValueError(f"unknown multiscale_mode {multiscale_mode!r}")


def scale_bounds(img_scale,
                 ratio_range: Optional[Tuple[float, float]] = None
                 ) -> Tuple[int, int]:
    """(max_long, max_short) over every scale the spec can produce."""
    scales = _as_scale_list(img_scale)
    max_long = max(max(s) for s in scales)
    max_short = max(min(s) for s in scales)
    if ratio_range is not None:
        max_long = int(max_long * ratio_range[1])
        max_short = int(max_short * ratio_range[1])
    return max_long, max_short


def canvas_for_scale(img_scale, *, portrait: bool = False, divisor: int = 32,
                     ratio_range: Optional[Tuple[float, float]] = None
                     ) -> Tuple[int, int]:
    """Static canvas (H, W) covering every keep-ratio resize under the spec.

    Landscape inputs (w >= h) resize to h <= max_short, w <= max_long;
    portrait is the transpose. Two canvases (one per orientation) replace the
    reference's aspect-ratio GroupSampler
    (`code/mmdet/datasets/samplers/group_sampler.py`)."""
    max_long, max_short = scale_bounds(img_scale, ratio_range)
    hw = (max_long, max_short) if portrait else (max_short, max_long)
    return pad_divisor_shape(*hw, divisor)


def resize_image(img: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize (pure numpy; cv2-free). img (H, W, C) uint8/float."""
    H, W = img.shape[:2]
    nh, nw = new_hw
    if (nh, nw) == (H, W):
        return img.astype(np.float32)
    # align with cv2.resize: pixel-center sampling
    ys = (np.arange(nh) + 0.5) * H / nh - 0.5
    xs = (np.arange(nw) + 0.5) * W / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    im = img.astype(np.float32)
    out = (im[y0][:, x0] * (1 - wy) * (1 - wx) + im[y0][:, x1] * (1 - wy) * wx
           + im[y1][:, x0] * wy * (1 - wx) + im[y1][:, x1] * wy * wx)
    return out


def resize_sample(sample: Dict, scale: Tuple[int, int],
                  keep_ratio: bool = True) -> Dict:
    """Resize of image + all landmark fields; ``keep_ratio=False`` resizes
    to exactly ``scale`` (reference Resize keep_ratio=False — the SSD
    square-input recipe)."""
    img = sample["image"]
    H, W = img.shape[:2]
    if keep_ratio:
        nh, nw = rescale_size(H, W, scale)
    else:
        nh, nw = min(scale), max(scale)
        if H > W:                      # portrait keeps the long side on H
            nh, nw = max(scale), min(scale)
    w_scale, h_scale = nw / W, nh / H
    out = dict(sample)
    out["image"] = resize_image(img, (nh, nw))
    out["img_shape"] = (nh, nw)
    sf = np.array([w_scale, h_scale, w_scale, h_scale], np.float32)
    out["scale_factor"] = sf
    if "gt_bboxes" in sample and len(sample["gt_bboxes"]):
        bb = sample["gt_bboxes"] * sf
        bb[:, 0::2] = np.clip(bb[:, 0::2], 0, nw)
        bb[:, 1::2] = np.clip(bb[:, 1::2], 0, nh)
        out["gt_bboxes"] = bb
    if "gt_extremes" in sample and len(sample["gt_extremes"]):
        ex = sample["gt_extremes"] * np.tile(sf[:2], 5)
        ex[:, 0::2] = np.clip(ex[:, 0::2], 0, nw)
        ex[:, 1::2] = np.clip(ex[:, 1::2], 0, nh)
        out["gt_extremes"] = ex
    if "gt_keypoints_vs" in sample and len(sample["gt_keypoints_vs"]):
        kp = sample["gt_keypoints_vs"].copy()
        kp[:, 0::3] = np.clip(kp[:, 0::3] * sf[0], 0, nw)
        kp[:, 1::3] = np.clip(kp[:, 1::3] * sf[1], 0, nh)
        out["gt_keypoints_vs"] = kp
    if "gt_polygons" in sample and len(sample["gt_polygons"]):
        pg = sample["gt_polygons"].copy()
        pg[:, 0::2] = pg[:, 0::2] * sf[0]
        pg[:, 1::2] = pg[:, 1::2] * sf[1]
        out["gt_polygons"] = pg
    return out


def hflip_sample(sample: Dict) -> Dict:
    """Horizontal flip of image + all landmark fields."""
    img = sample["image"]
    w = sample["img_shape"][1] if "img_shape" in sample else img.shape[1]
    out = dict(sample)
    out["image"] = img[:, ::-1].copy()
    out["flip"] = True
    if "gt_bboxes" in sample and len(sample["gt_bboxes"]):
        bb = sample["gt_bboxes"].copy()
        bb[:, 0::4] = w - sample["gt_bboxes"][:, 2::4]
        bb[:, 2::4] = w - sample["gt_bboxes"][:, 0::4]
        out["gt_bboxes"] = bb
    if "gt_extremes" in sample and len(sample["gt_extremes"]):
        e = sample["gt_extremes"]
        f = e.copy()
        # layout: [tx,ty, lx,ly, bx,by, rx,ry, cx,cy] (ref :354-388)
        f[:, 0] = w - e[:, 0]          # top mirrors x
        f[:, 2] = w - e[:, 6]          # left <- right
        f[:, 3] = e[:, 7]
        f[:, 4] = w - e[:, 4]          # bottom mirrors x
        f[:, 6] = w - e[:, 2]          # right <- left
        f[:, 7] = e[:, 3]
        f[:, 8] = w - e[:, 8]          # center mirrors x
        out["gt_extremes"] = f
    if "gt_keypoints_vs" in sample and len(sample["gt_keypoints_vs"]):
        kp = sample["gt_keypoints_vs"].copy()
        kp[:, 0::3] = w - kp[:, 0::3]
        kp3 = kp.reshape(kp.shape[0], -1, 3)
        for a, b in KEYPOINT_FLIP_IDX:
            kp3[:, [a, b]] = kp3[:, [b, a]]
        out["gt_keypoints_vs"] = kp3.reshape(kp.shape[0], -1)
    if "gt_polygons" in sample and len(sample["gt_polygons"]):
        pg = sample["gt_polygons"].copy()
        pg[:, 0::2] = w - pg[:, 0::2]
        # mirroring reverses orientation; reverse point order to stay
        # clockwise (ref PolygonMasks.flip keep_poly_clockwise)
        p2 = pg.reshape(pg.shape[0], -1, 2)[:, ::-1, :]
        out["gt_polygons"] = p2.reshape(pg.shape[0], -1)
    return out


# --------------------------------------------------------------------------
# Training augmentation suite (reference transforms.py RandomCrop :508,
# PhotoMetricDistortion :644, Expand :739, MinIoURandomCrop :812).  All pure
# functions over the sample dict taking an explicit rng; landmark fields
# (extremes / keypoints / polygons) are kept consistent — the reference only
# handles bboxes/masks because the LSNet recipes never crop, but this
# framework's pipelines carry landmark GT everywhere.

def _rgb2hsv(img: np.ndarray) -> np.ndarray:
    """float32 RGB (0-255) -> HSV with H in degrees (cv2 full-range
    convention used by mmcv.bgr2hsv on float images)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = np.max(img, axis=-1)
    mn = np.min(img, axis=-1)
    diff = mx - mn
    safe = np.where(diff == 0, 1.0, diff)
    h = np.zeros_like(mx)
    h = np.where(mx == r, (60.0 * (g - b) / safe) % 360.0, h)
    h = np.where((mx == g) & (mx != r), 60.0 * (b - r) / safe + 120.0, h)
    h = np.where((mx == b) & (mx != r) & (mx != g),
                 60.0 * (r - g) / safe + 240.0, h)
    h = np.where(diff == 0, 0.0, h)
    s = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
    return np.stack([h, s, mx], axis=-1)


def _hsv2rgb(img: np.ndarray) -> np.ndarray:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    h = (h % 360.0) / 60.0
    i = np.floor(h)
    f = h - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def photometric_distortion(sample: Dict, rng: np.random.RandomState,
                           brightness_delta: float = 32,
                           contrast_range: Tuple[float, float] = (0.5, 1.5),
                           saturation_range: Tuple[float, float] = (0.5, 1.5),
                           hue_delta: float = 18) -> Dict:
    """Reference PhotoMetricDistortion (:644-737): each step applied with
    p=0.5; contrast either before or after the HSV block; final random
    channel swap. Operates on the float RGB image pre-normalization."""
    img = sample["image"].astype(np.float32)
    if rng.randint(2):
        img = img + rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.randint(2)
    if mode == 1 and rng.randint(2):
        img = img * rng.uniform(*contrast_range)
    hsv = _rgb2hsv(np.clip(img, 0, 255))
    if rng.randint(2):
        hsv[..., 1] *= rng.uniform(*saturation_range)
    if rng.randint(2):
        hsv[..., 0] += rng.uniform(-hue_delta, hue_delta)
        hsv[..., 0][hsv[..., 0] > 360] -= 360
        hsv[..., 0][hsv[..., 0] < 0] += 360
    img = _hsv2rgb(hsv)
    if mode == 0 and rng.randint(2):
        img = img * rng.uniform(*contrast_range)
    if rng.randint(2):
        img = img[..., rng.permutation(3)]
    out = dict(sample)
    out["image"] = img
    return out


def _shift_fields(sample: Dict, dx: float, dy: float) -> Dict:
    """Translate every landmark field by (dx, dy) in place of a copy."""
    out = dict(sample)
    if "gt_bboxes" in sample and len(sample["gt_bboxes"]):
        out["gt_bboxes"] = sample["gt_bboxes"] + np.asarray(
            [dx, dy, dx, dy], np.float32)
    if "gt_extremes" in sample and len(sample["gt_extremes"]):
        e = sample["gt_extremes"].copy()
        e[:, 0::2] += dx
        e[:, 1::2] += dy
        out["gt_extremes"] = e
    if "gt_keypoints_vs" in sample and len(sample["gt_keypoints_vs"]):
        kp = sample["gt_keypoints_vs"].copy()
        vis = kp[:, 2::3] > 0
        kp[:, 0::3] += dx * vis
        kp[:, 1::3] += dy * vis
        out["gt_keypoints_vs"] = kp
    if "gt_polygons" in sample and len(sample["gt_polygons"]):
        pg = sample["gt_polygons"].copy()
        pg[:, 0::2] += dx
        pg[:, 1::2] += dy
        out["gt_polygons"] = pg
    return out


def expand_sample(sample: Dict, rng: np.random.RandomState,
                  mean: Tuple[float, float, float] = (123.675, 116.28,
                                                      103.53),
                  ratio_range: Tuple[float, float] = (1, 4),
                  prob: float = 0.5) -> Dict:
    """Reference Expand (:739-825): place the image on a mean-filled canvas
    of ratio x size at a random offset; all GT fields translate."""
    if rng.uniform(0, 1) > prob:
        return sample
    img = sample["image"]
    h, w, c = img.shape
    ratio = rng.uniform(*ratio_range)
    eh, ew = int(h * ratio), int(w * ratio)
    canvas = np.full((eh, ew, c), np.asarray(mean, np.float32),
                     dtype=np.float32)
    left = int(rng.uniform(0, ew - w))
    top = int(rng.uniform(0, eh - h))
    canvas[top:top + h, left:left + w] = img
    out = _shift_fields(sample, left, top)
    out["image"] = canvas
    out["img_shape"] = (eh, ew)
    return out


def _select_instances(sample: Dict, keep: np.ndarray) -> Dict:
    out = dict(sample)
    for key in ("gt_bboxes", "gt_labels", "gt_extremes", "gt_keypoints_vs",
                "gt_polygons"):
        if key in sample and len(sample[key]):
            out[key] = sample[key][keep]
    return out


def _clip_fields(sample: Dict, h: int, w: int) -> Dict:
    out = dict(sample)
    if "gt_bboxes" in sample and len(sample["gt_bboxes"]):
        bb = sample["gt_bboxes"].copy()
        bb[:, 0::2] = np.clip(bb[:, 0::2], 0, w)
        bb[:, 1::2] = np.clip(bb[:, 1::2], 0, h)
        out["gt_bboxes"] = bb
    if "gt_extremes" in sample and len(sample["gt_extremes"]):
        e = sample["gt_extremes"].copy()
        e[:, 0::2] = np.clip(e[:, 0::2], 0, w)
        e[:, 1::2] = np.clip(e[:, 1::2], 0, h)
        out["gt_extremes"] = e
    if "gt_keypoints_vs" in sample and len(sample["gt_keypoints_vs"]):
        kp = sample["gt_keypoints_vs"].copy()
        # keypoints that land outside the crop become invisible (v=0),
        # matching COCO semantics for out-of-frame joints
        oob = ((kp[:, 0::3] < 0) | (kp[:, 0::3] > w)
               | (kp[:, 1::3] < 0) | (kp[:, 1::3] > h))
        kp[:, 2::3] = np.where(oob, 0.0, kp[:, 2::3])
        kp[:, 0::3] = np.clip(kp[:, 0::3], 0, w)
        kp[:, 1::3] = np.clip(kp[:, 1::3], 0, h)
        out["gt_keypoints_vs"] = kp
    if "gt_polygons" in sample and len(sample["gt_polygons"]):
        pg = sample["gt_polygons"].copy()
        pg[:, 0::2] = np.clip(pg[:, 0::2], 0, w)
        pg[:, 1::2] = np.clip(pg[:, 1::2], 0, h)
        out["gt_polygons"] = pg
    return out


def random_crop_sample(sample: Dict, crop_size: Tuple[int, int],
                       rng: np.random.RandomState) -> Optional[Dict]:
    """Reference RandomCrop (:508-616): fixed-size crop at a random offset;
    instances whose clipped box degenerates are dropped; returns ``None``
    when every GT is lost (the reference skips the image)."""
    img = sample["image"]
    margin_h = max(img.shape[0] - crop_size[0], 0)
    margin_w = max(img.shape[1] - crop_size[1], 0)
    offset_h = rng.randint(0, margin_h + 1)
    offset_w = rng.randint(0, margin_w + 1)
    y1, y2 = offset_h, offset_h + crop_size[0]
    x1, x2 = offset_w, offset_w + crop_size[1]
    out = _shift_fields(sample, -offset_w, -offset_h)
    out["image"] = img[y1:y2, x1:x2]
    h, w = out["image"].shape[:2]
    out["img_shape"] = (h, w)
    out = _clip_fields(out, h, w)
    if "gt_bboxes" in out and len(out["gt_bboxes"]):
        bb = out["gt_bboxes"]
        keep = (bb[:, 2] > bb[:, 0]) & (bb[:, 3] > bb[:, 1])
        if not keep.any():
            return None
        out = _select_instances(out, keep)
    return out


def _iou_patch(patch: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    ix1 = np.maximum(patch[0], boxes[:, 0])
    iy1 = np.maximum(patch[1], boxes[:, 1])
    ix2 = np.minimum(patch[2], boxes[:, 2])
    iy2 = np.minimum(patch[3], boxes[:, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    a1 = (patch[2] - patch[0]) * (patch[3] - patch[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-6)


def min_iou_random_crop(sample: Dict, rng: np.random.RandomState,
                        min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                        min_crop_size: float = 0.3,
                        max_outer_tries: int = 20) -> Dict:
    """Reference MinIoURandomCrop (:812-933): sample a mode (1 = no crop /
    min-IoU value / 0), then up to 50 random patches with aspect in
    [0.5, 2] whose IoU with every GT >= mode; keep instances whose box
    CENTER lies in the patch.  The reference's ``while True`` is bounded
    here (``max_outer_tries``, then no-crop) — a pipeline worker must not
    loop forever on a degenerate image."""
    boxes = sample.get("gt_bboxes", np.zeros((0, 4), np.float32))
    img = sample["image"]
    h, w = img.shape[:2]
    sample_mode = (1, *min_ious, 0)
    for _ in range(max_outer_tries):
        mode = sample_mode[rng.randint(len(sample_mode))]
        if mode == 1:
            return sample
        min_iou = mode
        for _ in range(50):
            new_w = rng.uniform(min_crop_size * w, w)
            new_h = rng.uniform(min_crop_size * h, h)
            if new_h / new_w < 0.5 or new_h / new_w > 2:
                continue
            left = rng.uniform(0, w - new_w)
            top = rng.uniform(0, h - new_h)
            patch = np.array([int(left), int(top), int(left + new_w),
                              int(top + new_h)])
            if patch[2] == patch[0] or patch[3] == patch[1]:
                continue
            if len(boxes):
                overlaps = _iou_patch(patch, boxes)
                if overlaps.min() < min_iou:
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                keep = ((centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                        & (centers[:, 0] < patch[2])
                        & (centers[:, 1] < patch[3]))
                if not keep.any():
                    continue
                out = _select_instances(sample, keep)
            else:
                out = dict(sample)
            out = _shift_fields(out, -patch[0], -patch[1])
            out["image"] = img[patch[1]:patch[3], patch[0]:patch[2]]
            ch, cw = out["image"].shape[:2]
            out["img_shape"] = (ch, cw)
            return _clip_fields(out, ch, cw)
    return sample


def build_aug_pipeline(specs):
    """[{'type': 'PhotoMetricDistortion', ...}, ...] -> callable
    (sample, rng) -> sample|None, reference pipeline order preserved."""
    steps = []
    for spec in specs or ():
        spec = dict(spec)
        kind = spec.pop("type")
        if kind == "PhotoMetricDistortion":
            steps.append(lambda s, rng, kw=spec: photometric_distortion(
                s, rng, **kw))
        elif kind == "Expand":
            kw = {k: v for k, v in spec.items()
                  if k in ("mean", "ratio_range", "prob")}
            steps.append(lambda s, rng, kw=kw: expand_sample(s, rng, **kw))
        elif kind == "MinIoURandomCrop":
            kw = {k: v for k, v in spec.items()
                  if k in ("min_ious", "min_crop_size")}
            steps.append(lambda s, rng, kw=kw: min_iou_random_crop(
                s, rng, **kw))
        elif kind == "RandomCrop":
            cs = tuple(spec["crop_size"])
            steps.append(lambda s, rng, cs=cs: random_crop_sample(s, cs, rng))
        elif kind == "Corrupt":
            # reference Corrupt (`transforms.py:1030-1062`); backed by the
            # in-tree numpy corruption suite (data/corruptions.py) since
            # the imagecorruptions package is absent here
            name = spec["corruption"]
            sev = int(spec.get("severity", 1))
            steps.append(lambda s, rng, name=name, sev=sev: corrupt_sample(
                s, name, sev))
        else:
            raise KeyError(f"unknown augmentation {kind!r}")

    def run(sample, rng):
        for step in steps:
            nxt = step(sample, rng)
            if nxt is None:
                return None
            sample = nxt
        return sample

    return run if steps else None


def corrupt_sample(sample: Dict, corruption: str, severity: int = 1
                   ) -> Dict:
    """Apply a named corruption to the sample's image (pixels only; boxes/
    landmarks untouched — reference Corrupt semantics)."""
    from .corruptions import corrupt
    out = dict(sample)
    img = np.asarray(sample["image"])
    as_float = img.dtype != np.uint8
    u8 = np.uint8(np.clip(img, 0, 255)) if as_float else img
    cor = corrupt(u8, corruption, severity)
    out["image"] = cor.astype(img.dtype) if as_float else cor
    return out


def normalize_image(img: np.ndarray,
                    mean=(123.675, 116.28, 103.53),
                    std=(58.395, 57.12, 57.375)) -> np.ndarray:
    """Reference img_norm_cfg (RGB order)."""
    return ((img - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)


def pad_to_shape(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    H, W = img.shape[:2]
    ch, cw = canvas_hw
    out = np.zeros((ch, cw) + img.shape[2:], img.dtype)
    out[:H, :W] = img
    return out


def pad_divisor_shape(h: int, w: int, divisor: int = 32) -> Tuple[int, int]:
    return (-(-h // divisor) * divisor, -(-w // divisor) * divisor)
