"""Numpy/PIL image corruptions for the robustness benchmark (counterpart
of ``lsnet_tpu/data/corruptions.py``, kept as the port's own copy).

The reference ``Corrupt`` pipeline step and corruption benchmark depend on
the external ``imagecorruptions`` package. This module implements the 14
corruptions of the benchmark and holdout sets that need nothing beyond
numpy, scipy and PIL (``UNAVAILABLE`` lists the five that need per-pixel
shuffling loops or bundled weather images). The severity tables follow
the published benchmark; the noise is drawn from a RandomState seeded by
the image's content (``_rng``), so an image gives the same corrupted bytes
on every pass and in both packages.

All functions take/return uint8 HxWx3 arrays; ``severity`` is 1..5.
"""

from __future__ import annotations

import io
from typing import Callable, Dict, List

import numpy as np


def _as_float(img: np.ndarray) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return np.uint8(np.clip(x, 0, 1) * 255.0 + 0.5)


def _rng(img: np.ndarray) -> np.random.RandomState:
    # deterministic per-image noise: keyed on content so repeated eval
    # passes see identical corrupted pixels (reproducible benchmarks)
    return np.random.RandomState(
        np.uint32(np.asarray(img, np.uint64).sum() & 0xFFFFFFFF))


# ---------------------------------------------------------------- noise --

def gaussian_noise(img, severity=1):
    c = [0.08, 0.12, 0.18, 0.26, 0.38][severity - 1]
    x = _as_float(img)
    return _to_uint8(x + _rng(img).normal(size=x.shape, scale=c))


def shot_noise(img, severity=1):
    c = [60, 25, 12, 5, 3][severity - 1]
    x = _as_float(img)
    return _to_uint8(_rng(img).poisson(x * c) / float(c))


def impulse_noise(img, severity=1):
    """Salt & pepper: a fraction of pixels forced to 0 or 1."""
    c = [0.03, 0.06, 0.09, 0.17, 0.27][severity - 1]
    x = _as_float(img).copy()
    rng = _rng(img)
    m = rng.rand(*x.shape)
    x[m < c / 2] = 0.0
    x[m > 1 - c / 2] = 1.0
    return _to_uint8(x)


def speckle_noise(img, severity=1):
    c = [0.15, 0.2, 0.35, 0.45, 0.6][severity - 1]
    x = _as_float(img)
    return _to_uint8(x + x * _rng(img).normal(size=x.shape, scale=c))


# ----------------------------------------------------------------- blur --

def _filter2d(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    from scipy.ndimage import convolve
    out = np.empty_like(x)
    for ch in range(x.shape[2]):
        out[..., ch] = convolve(x[..., ch], kernel, mode="reflect")
    return out


def gaussian_blur(img, severity=1):
    from scipy.ndimage import gaussian_filter
    c = [1, 2, 3, 4, 6][severity - 1]
    x = _as_float(img)
    return _to_uint8(gaussian_filter(x, sigma=(c, c, 0)))


def defocus_blur(img, severity=1):
    """Disk point-spread function."""
    radius, alias = [(3, 0.1), (4, 0.5), (6, 0.5), (8, 0.5),
                     (10, 0.5)][severity - 1]
    from scipy.ndimage import gaussian_filter
    L = np.arange(-radius, radius + 1)
    yy, xx = np.meshgrid(L, L, indexing="ij")
    disk = ((yy ** 2 + xx ** 2) <= radius ** 2).astype(np.float32)
    disk = gaussian_filter(disk, sigma=alias)
    disk /= disk.sum()
    return _to_uint8(_filter2d(_as_float(img), disk))


def motion_blur(img, severity=1):
    """Linear motion PSF at a random angle (Gaussian-weighted line)."""
    radius, sigma = [(10, 3), (15, 5), (15, 8), (15, 12),
                     (20, 15)][severity - 1]
    rng = _rng(img)
    angle = rng.uniform(-np.pi / 4, np.pi / 4)
    n = 2 * radius + 1
    k = np.zeros((n, n), np.float32)
    t = np.arange(-radius, radius + 1, dtype=np.float32)
    w = np.exp(-t ** 2 / (2.0 * sigma ** 2))
    ys = np.clip(np.round(radius + t * np.sin(angle)), 0, n - 1).astype(int)
    xs = np.clip(np.round(radius + t * np.cos(angle)), 0, n - 1).astype(int)
    for yi, xi, wi in zip(ys, xs, w):
        k[yi, xi] += wi
    k /= k.sum()
    return _to_uint8(_filter2d(_as_float(img), k))


def zoom_blur(img, severity=1):
    """Average of progressively zoomed center crops."""
    c = [1.11, 1.16, 1.21, 1.26, 1.31][severity - 1]
    from PIL import Image
    x = _as_float(img)
    h, w = x.shape[:2]
    acc = x.copy()
    zooms = np.arange(1.0, c, 0.01)
    im = Image.fromarray(np.uint8(x * 255))
    for z in zooms[1:]:
        zw, zh = int(np.ceil(w * z)), int(np.ceil(h * z))
        big = np.asarray(im.resize((zw, zh), Image.BILINEAR),
                         np.float32) / 255.0
        oy, ox = (zh - h) // 2, (zw - w) // 2
        acc += big[oy:oy + h, ox:ox + w]
    return _to_uint8(acc / (len(zooms[1:]) + 1))


# -------------------------------------------------------------- weather --

def _plasma(shape, rng, wibbledecay):
    """Diamond-square plasma fractal (numpy) — the fog field."""
    size = 1
    while size < max(shape):
        size *= 2
    arr = np.zeros((size + 1, size + 1), np.float32)
    step = size
    wibble = 100.0
    while step > 1:
        half = step // 2
        # diamond
        blk = arr[0:size:step, 0:size:step]
        sq = (blk + np.roll(blk, -1, 0) + np.roll(blk, -1, 1)
              + np.roll(np.roll(blk, -1, 0), -1, 1)) / 4.0
        arr[half:size:step, half:size:step] = (
            sq + rng.uniform(-wibble, wibble, sq.shape))
        # square
        for (oy, ox) in ((0, half), (half, 0)):
            blk = arr[oy:size + oy:step, ox:size + ox:step]
            nbr = (np.roll(blk, 1, 0) + np.roll(blk, -1, 0)
                   + np.roll(blk, 1, 1) + np.roll(blk, -1, 1)) / 4.0
            arr[oy:size:step, ox:size:step] = (
                nbr + rng.uniform(-wibble, wibble, nbr.shape))[
                    :len(range(oy, size, step)), :len(range(ox, size, step))]
        step = half
        wibble *= wibbledecay
    arr -= arr.min()
    arr /= max(arr.max(), 1e-6)
    return arr[:shape[0], :shape[1]]


def fog(img, severity=1):
    scale, decay = [(1.5, 2.0), (2.0, 2.0), (2.5, 1.7), (2.5, 1.5),
                    (3.0, 1.4)][severity - 1]
    x = _as_float(img)
    top = x.max()
    field = _plasma(x.shape[:2], _rng(img), 1.0 / decay)
    x = x + scale * field[..., None]
    return _to_uint8(x * top / max(top + scale, 1e-6))


def brightness(img, severity=1):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    return _to_uint8(_as_float(img) + c)


# -------------------------------------------------------------- digital --

def contrast(img, severity=1):
    c = [0.4, 0.3, 0.2, 0.1, 0.05][severity - 1]
    x = _as_float(img)
    mean = x.mean(axis=(0, 1), keepdims=True)
    return _to_uint8((x - mean) * c + mean)


def saturate(img, severity=1):
    scale, shift = [(0.3, 0.0), (0.1, 0.0), (2.0, 0.0), (5.0, 0.1),
                    (20.0, 0.2)][severity - 1]
    x = _as_float(img)
    gray = x.mean(axis=2, keepdims=True)
    return _to_uint8(gray + (x - gray) * scale + shift)


def pixelate(img, severity=1):
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    from PIL import Image
    h, w = img.shape[:2]
    im = Image.fromarray(np.asarray(img, np.uint8))
    small = im.resize((max(1, int(w * c)), max(1, int(h * c))), Image.BOX)
    return np.asarray(small.resize((w, h), Image.NEAREST))


def jpeg_compression(img, severity=1):
    c = [25, 18, 15, 10, 7][severity - 1]
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8)).save(
        buf, format="JPEG", quality=int(c))
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGB"))


CORRUPTIONS: Dict[str, Callable] = {
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "speckle_noise": speckle_noise,
    "gaussian_blur": gaussian_blur,
    "defocus_blur": defocus_blur,
    "motion_blur": motion_blur,
    "zoom_blur": zoom_blur,
    "fog": fog,
    "brightness": brightness,
    "contrast": contrast,
    "saturate": saturate,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
}

# reference benchmark set intersected with what is implementable without
# external assets/packages (see module docstring)
BENCHMARK: List[str] = [
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur",
    "motion_blur", "zoom_blur", "fog", "brightness", "contrast",
    "pixelate", "jpeg_compression",
]
HOLDOUT: List[str] = ["speckle_noise", "gaussian_blur", "saturate"]
UNAVAILABLE: List[str] = ["glass_blur", "snow", "frost",
                          "elastic_transform", "spatter"]


def corrupt(img: np.ndarray, corruption: str, severity: int = 1
            ) -> np.ndarray:
    """Apply a named corruption (uint8 HxWx3 in/out, severity 1..5)."""
    if corruption in UNAVAILABLE:
        raise NotImplementedError(
            f"{corruption} needs external assets/packages not present in "
            "this environment (see lsnet_torch/data/corruptions.py)")
    if corruption not in CORRUPTIONS:
        raise KeyError(f"unknown corruption {corruption!r}; available: "
                       f"{sorted(CORRUPTIONS)}")
    if not 1 <= int(severity) <= 5:
        raise ValueError(f"severity must be 1..5, got {severity}")
    return CORRUPTIONS[corruption](np.asarray(img, np.uint8), int(severity))
