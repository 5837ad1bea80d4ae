"""The port's own copy of ``lsnet_tpu/utils/image.py`` (numpy, host side).

Host-side image utility surface (the mmcv.image API).

Rebuild of the reference image library
(`code/mmcv/mmcv/image/{geometric,photometric,colorspace}.py`) without
cv2: geometric ops run through PIL or a pure-numpy inverse-mapped
bilinear warp, colorspace/photometric ops are the standard formulas.
These are *host preprocessing* utilities — the on-device pipeline
(`lsnet_torch/data/transforms.py`) stays the training hot path.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np

Number = Union[int, float]


# ---------------------------------------------------------------- geometric

def imresize(img: np.ndarray, size: Tuple[int, int], return_scale=False,
             interpolation: str = "bilinear"):
    """Resize to ``size`` (w, h) (reference `geometric.py:29-56`)."""
    from PIL import Image

    modes = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
             "bicubic": Image.BICUBIC, "lanczos": Image.LANCZOS}
    h, w = img.shape[:2]
    pil = Image.fromarray(img)
    out = np.asarray(pil.resize(size, modes[interpolation]))
    if not return_scale:
        return out
    return out, size[0] / w, size[1] / h


def imresize_like(img, dst_img, return_scale=False,
                  interpolation="bilinear"):
    h, w = dst_img.shape[:2]
    return imresize(img, (w, h), return_scale, interpolation)


def rescale_size(old_size: Tuple[int, int], scale,
                 return_scale: bool = False):
    """(w, h) + scale(float | (long, short)) -> new (w, h) (reference
    `geometric.py:76-110`)."""
    w, h = old_size
    if isinstance(scale, (float, int)):
        if scale <= 0:
            raise ValueError(f"Invalid scale {scale}, must be positive.")
        scale_factor = scale
    elif isinstance(scale, tuple):
        max_long, max_short = max(scale), min(scale)
        scale_factor = min(max_long / max(h, w), max_short / min(h, w))
    else:
        raise TypeError(f"Scale must be a number or tuple of int, "
                        f"but got {type(scale)}")
    new_size = (int(w * scale_factor + 0.5), int(h * scale_factor + 0.5))
    if return_scale:
        return new_size, scale_factor
    return new_size


def imrescale(img, scale, return_scale=False, interpolation="bilinear"):
    h, w = img.shape[:2]
    new_size, scale_factor = rescale_size((w, h), scale, return_scale=True)
    out = imresize(img, new_size, interpolation=interpolation)
    if return_scale:
        return out, scale_factor
    return out


def imflip(img: np.ndarray, direction: str = "horizontal") -> np.ndarray:
    assert direction in ("horizontal", "vertical")
    return (np.flip(img, axis=1) if direction == "horizontal"
            else np.flip(img, axis=0))


def _rotation_matrix(center, angle, scale):
    """cv2.getRotationMatrix2D: 2x3 forward affine, positive angle =
    counter-clockwise."""
    a = math.radians(angle)
    alpha = scale * math.cos(a)
    beta = scale * math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def _warp_affine(img: np.ndarray, matrix: np.ndarray, out_wh,
                 border_value=0) -> np.ndarray:
    """cv2.warpAffine default semantics: M is the forward map, inverted
    internally; bilinear sampling; constant border."""
    w, h = out_wh
    M = np.vstack([matrix, [0, 0, 1]])
    inv = np.linalg.inv(M)
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    H, W = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    dx = sx - x0
    dy = sy - y0
    chn = img if img.ndim == 3 else img[..., None]
    acc = np.zeros((h, w, chn.shape[2]), np.float64)
    wsum = np.zeros((h, w, 1), np.float64)
    for m in (0, 1):
        for n in (0, 1):
            xi = x0 + n
            yi = y0 + m
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            wgt = (np.abs(1 - n - dx) * np.abs(1 - m - dy) * valid)
            g = chn[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
            acc += g * wgt[..., None]
            wsum += wgt[..., None]
    bv = np.asarray(border_value, np.float64).reshape(1, 1, -1)
    out = acc + (1.0 - wsum) * bv
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), np.iinfo(img.dtype).min,
                      np.iinfo(img.dtype).max)
    out = out.astype(img.dtype)
    return out[..., 0] if img.ndim == 2 else out


def imrotate(img: np.ndarray, angle: float,
             center: Optional[Tuple[float, float]] = None,
             scale: float = 1.0, border_value: Number = 0,
             auto_bound: bool = False) -> np.ndarray:
    """Rotate (positive angle = clockwise), reference
    `geometric.py:172-214` semantics incl. auto_bound growth."""
    if center is not None and auto_bound:
        raise ValueError("`auto_bound` conflicts with `center`")
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    assert isinstance(center, tuple)
    matrix = _rotation_matrix(center, -angle, scale)
    if auto_bound:
        cos = np.abs(matrix[0, 0])
        sin = np.abs(matrix[0, 1])
        new_w = h * sin + w * cos
        new_h = h * cos + w * sin
        matrix[0, 2] += (new_w - w) * 0.5
        matrix[1, 2] += (new_h - h) * 0.5
        w = int(np.round(new_w))
        h = int(np.round(new_h))
    return _warp_affine(img, matrix, (w, h), border_value)


def bbox_clip(bboxes: np.ndarray, img_shape) -> np.ndarray:
    """Clip (..., 4k) boxes to [0, w-1] x [0, h-1] (reference
    `geometric.py:216-231`)."""
    assert bboxes.shape[-1] % 4 == 0
    cmin = np.empty(bboxes.shape[-1], dtype=bboxes.dtype)
    cmin[0::2] = img_shape[1] - 1
    cmin[1::2] = img_shape[0] - 1
    return np.maximum(np.minimum(bboxes, cmin), 0)


def bbox_scaling(bboxes: np.ndarray, scale: float,
                 clip_shape=None) -> np.ndarray:
    """Scale boxes about their centers (reference `geometric.py:234-257`)."""
    if float(scale) == 1.0:
        scaled = bboxes.copy()
    else:
        w = bboxes[..., 2] - bboxes[..., 0] + 1
        h = bboxes[..., 3] - bboxes[..., 1] + 1
        dw = (w * (scale - 1)) * 0.5
        dh = (h * (scale - 1)) * 0.5
        scaled = bboxes + np.stack((-dw, -dh, dw, dh), axis=-1)
    if clip_shape is not None:
        return bbox_clip(scaled, clip_shape)
    return scaled


def imcrop(img: np.ndarray, bboxes: np.ndarray, scale: float = 1.0,
           pad_fill=None):
    """Crop patches; optional out-of-image padding (reference
    `geometric.py:260-311`)."""
    chn = 1 if img.ndim == 2 else img.shape[2]
    if pad_fill is not None:
        if isinstance(pad_fill, (int, float)):
            pad_fill = [pad_fill] * chn
        assert len(pad_fill) == chn
    _bboxes = bboxes[None, ...] if bboxes.ndim == 1 else bboxes
    scaled = bbox_scaling(_bboxes, scale).astype(np.int32)
    clipped = bbox_clip(scaled, img.shape)
    patches = []
    for i in range(clipped.shape[0]):
        x1, y1, x2, y2 = tuple(clipped[i, :])
        if pad_fill is None:
            patch = img[y1:y2 + 1, x1:x2 + 1, ...]
        else:
            _x1, _y1, _x2, _y2 = tuple(scaled[i, :])
            shape = ((_y2 - _y1 + 1, _x2 - _x1 + 1) if chn == 1
                     else (_y2 - _y1 + 1, _x2 - _x1 + 1, chn))
            patch = (np.array(pad_fill, dtype=img.dtype)
                     * np.ones(shape, dtype=img.dtype))
            xs = 0 if _x1 >= 0 else -_x1
            ys_ = 0 if _y1 >= 0 else -_y1
            wp = x2 - x1 + 1
            hp = y2 - y1 + 1
            patch[ys_:ys_ + hp, xs:xs + wp, ...] = img[y1:y1 + hp,
                                                       x1:x1 + wp, ...]
        patches.append(patch)
    return patches[0] if bboxes.ndim == 1 else patches


def impad(img: np.ndarray, shape, pad_val=0) -> np.ndarray:
    """Bottom/right-pad to ``shape`` (h, w) (reference
    `geometric.py:314-336`)."""
    if not isinstance(pad_val, (int, float)):
        assert len(pad_val) == img.shape[-1]
    if len(shape) < len(img.shape):
        shape = tuple(shape) + (img.shape[-1],)
    assert len(shape) == len(img.shape)
    for s, img_s in zip(shape, img.shape):
        assert s >= img_s
    pad = np.empty(shape, dtype=img.dtype)
    pad[...] = pad_val
    pad[:img.shape[0], :img.shape[1], ...] = img
    return pad


def impad_to_multiple(img: np.ndarray, divisor: int,
                      pad_val=0) -> np.ndarray:
    pad_h = int(np.ceil(img.shape[0] / divisor)) * divisor
    pad_w = int(np.ceil(img.shape[1] / divisor)) * divisor
    return impad(img, (pad_h, pad_w), pad_val)


# --------------------------------------------------------------- colorspace

def bgr2rgb(img: np.ndarray) -> np.ndarray:
    return img[..., ::-1]


rgb2bgr = bgr2rgb


def bgr2gray(img: np.ndarray, keepdim: bool = False) -> np.ndarray:
    out = (0.114 * img[..., 0] + 0.587 * img[..., 1]
           + 0.299 * img[..., 2])
    out = out.astype(img.dtype)
    return out[..., None] if keepdim else out


def rgb2gray(img: np.ndarray, keepdim: bool = False) -> np.ndarray:
    return bgr2gray(img[..., ::-1], keepdim)


def gray2bgr(img: np.ndarray) -> np.ndarray:
    img = img[..., None] if img.ndim == 2 else img
    return np.repeat(img, 3, axis=-1)


gray2rgb = gray2bgr


def rgb2hsv(img: np.ndarray) -> np.ndarray:
    """uint8/float RGB -> float32 HSV with H in [0, 360) (cv2 float
    convention)."""
    x = img.astype(np.float32)
    if img.dtype == np.uint8:
        x = x / 255.0
    mx = x.max(-1)
    mn = x.min(-1)
    d = mx - mn
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.zeros_like(mx)
    m = d > 0
    idx = m & (mx == r)
    h[idx] = (60 * (g - b) / d % 360)[idx]
    idx = m & (mx == g) & (mx != r)
    h[idx] = (60 * (b - r) / d + 120)[idx]
    idx = m & (mx == b) & (mx != r) & (mx != g)
    h[idx] = (60 * (r - g) / d + 240)[idx]
    s = np.where(mx > 0, d / np.maximum(mx, 1e-12), 0.0)
    return np.stack([h, s, mx], axis=-1).astype(np.float32)


def hsv2rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    c = v * s
    hp = (h / 60.0) % 6
    xfac = c * (1 - np.abs(hp % 2 - 1))
    z = np.zeros_like(c)
    combos = [(c, xfac, z), (xfac, c, z), (z, c, xfac),
              (z, xfac, c), (xfac, z, c), (c, z, xfac)]
    idx = np.floor(hp).astype(np.int64) % 6
    r = np.choose(idx, [cb[0] for cb in combos])
    g = np.choose(idx, [cb[1] for cb in combos])
    b = np.choose(idx, [cb[2] for cb in combos])
    m = v - c
    return np.stack([r + m, g + m, b + m], axis=-1).astype(np.float32)


def bgr2hsv(img: np.ndarray) -> np.ndarray:
    return rgb2hsv(img[..., ::-1])


def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    return hsv2rgb(hsv)[..., ::-1]


def imconvert(img: np.ndarray, src: str, dst: str) -> np.ndarray:
    fn = globals().get(f"{src.lower()}2{dst.lower()}")
    if fn is None:
        raise ValueError(f"unsupported conversion {src}->{dst}")
    return fn(img)


# -------------------------------------------------------------- photometric

def imnormalize(img: np.ndarray, mean, std, to_rgb: bool = True):
    img = img.astype(np.float32)
    if to_rgb:
        img = img[..., ::-1]
    return (img - np.asarray(mean, np.float32)) / np.asarray(
        std, np.float32)


def imdenormalize(img: np.ndarray, mean, std, to_bgr: bool = True):
    out = img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    if to_bgr:
        out = out[..., ::-1]
    return out


def iminvert(img: np.ndarray) -> np.ndarray:
    """255 - img (reference `photometric.py:55-64`)."""
    return np.full_like(img, 255) - img


def solarize(img: np.ndarray, thr: int = 128) -> np.ndarray:
    """Invert pixels >= thr (reference `photometric.py:67-78`)."""
    return np.where(img < thr, img, 255 - img)


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """Keep the top ``bits`` bits (reference `photometric.py:81-93`)."""
    shift = 8 - bits
    return np.left_shift(np.right_shift(img, shift), shift)
