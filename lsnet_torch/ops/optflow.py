"""Optical-flow utilities: warp, (de)quantize, .flo IO (counterpart of
``lsnet_tpu/ops/optflow.py``).

The reference's per-pixel C++ warp loop (mmcv ``video/optflow.py`` and
``optflow_warp/flow_warp.cpp``) becomes one batched gather on the tensor's
device: two index maps (nearest) or four weighted taps (bilinear). The
quantisation and the ``.flo`` / quantised-image IO are host numpy, the
JAX package's own code.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def flow_warp(img: torch.Tensor, flow: torch.Tensor,
              filling_value: float = 0,
              interpolate_mode: str = "nearest") -> torch.Tensor:
    """Warp ``img`` by ``flow`` (reference ``optflow.py flow_warp``).

    img: (H, W, C) or (B, H, W, C); flow: matching (..., H, W, 2) with
    flow[..., 0] the horizontal (w) and flow[..., 1] the vertical (h)
    displacement. A pixel whose sample point falls outside
    [0, H-1) x [0, W-1) is set to ``filling_value`` (reference
    ``flow_warp.cpp``: the upper bound at H-1 / W-1 is EXCLUSIVE). The
    arithmetic is in ``img``'s dtype promoted to at least f32, the result
    in ``img``'s dtype, on ``img``'s device.
    """
    if interpolate_mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown interpolate_mode {interpolate_mode!r}")
    batched = img.dim() == 4
    if not batched:
        img = img[None]
        flow = flow[None]
    B, H, W, C = img.shape
    dt = torch.promote_types(img.dtype, torch.float32)
    dev = img.device
    x = (torch.arange(H, dtype=dt, device=dev)[None, :, None]
         + flow[..., 1].to(dt))                         # vertical
    y = (torch.arange(W, dtype=dt, device=dev)[None, None, :]
         + flow[..., 0].to(dt))                         # horizontal
    invalid = (x < 0) | (x >= H - 1) | (y < 0) | (y >= W - 1)

    flat = img.reshape(B, H * W, C).to(dt)

    def take(xi, yi):
        idx = (xi * W + yi).reshape(B, -1, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, H, W, C)

    if interpolate_mode == "nearest":
        # reference NNInterpolate: round-half-up via int(x + 0.5)
        xi = torch.floor(x + 0.5).to(torch.int64).clamp(0, H - 1)
        yi = torch.floor(y + 0.5).to(torch.int64).clamp(0, W - 1)
        out = take(xi, yi)
    else:
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        dx = (x - x0).clamp(0.0, 1.0)
        dy = (y - y0).clamp(0.0, 1.0)
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        out = torch.zeros((B, H, W, C), dtype=dt, device=dev)
        for m in (0, 1):
            for n in (0, 1):
                w = (torch.abs(1 - m - dx) * torch.abs(1 - n - dy))[..., None]
                out = out + take((x0i + m).clamp(0, H - 1),
                                 (y0i + n).clamp(0, W - 1)) * w
    out = torch.where(invalid[..., None],
                      torch.tensor(filling_value, dtype=dt, device=dev), out)
    out = out.to(img.dtype)
    return out if batched else out[0]


def quantize_flow(flow: np.ndarray, max_val: float = 0.02,
                  norm: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Flow -> two uint8 maps (reference `optflow.py:89-114`; 255 levels
    so 0 survives the round trip)."""
    h, w, _ = flow.shape
    dx = flow[..., 0] / w if norm else flow[..., 0]
    dy = flow[..., 1] / h if norm else flow[..., 1]
    outs = []
    for d in (dx, dy):
        # mmcv.arraymisc.quantize(d, -max_val, max_val, 255, uint8):
        # clip -> floor(levels * (d - min) / range) capped at levels-1
        d = np.clip(d, -max_val, max_val) + max_val
        outs.append(np.minimum(
            np.floor(255 * d / (2 * max_val)), 254).astype(np.uint8))
    return tuple(outs)


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 0.02,
                    denorm: bool = True) -> np.ndarray:
    """Inverse of :func:`quantize_flow` (reference `optflow.py:117-138`)."""
    assert dx.shape == dy.shape
    # mmcv.arraymisc.dequantize: (q + 0.5) * range / levels + min
    dx, dy = [(d.astype(np.float64) + 0.5) * 2 * max_val / 255 - max_val
              for d in (dx, dy)]
    if denorm:
        dx = dx * dx.shape[1]
        dy = dy * dy.shape[0]
    return np.dstack((dx, dy)).astype(np.float32)


def flowread(flow_or_path, quantize: bool = False, concat_axis: int = 0,
             *args, **kwargs) -> np.ndarray:
    """Read a .flo file / pass through an array (reference
    `optflow.py:10-57`)."""
    if isinstance(flow_or_path, np.ndarray):
        if flow_or_path.ndim != 3 or flow_or_path.shape[-1] != 2:
            raise ValueError(
                f"invalid flow with shape {flow_or_path.shape}")
        return flow_or_path
    if not quantize:
        with open(flow_or_path, "rb") as f:
            header = f.read(4).decode("utf-8", errors="replace")
            if header != "PIEH":
                raise IOError(f"invalid flow file: {flow_or_path}")
            w = int(np.fromfile(f, np.int32, 1)[0])
            h = int(np.fromfile(f, np.int32, 1)[0])
            flow = np.fromfile(f, np.float32, w * h * 2).reshape(h, w, 2)
        return flow
    assert concat_axis in (0, 1)
    from PIL import Image
    cat = np.asarray(Image.open(flow_or_path))
    if cat.ndim != 2:
        raise IOError(f"{flow_or_path} is not a quantized flow file")
    assert cat.shape[concat_axis] % 2 == 0
    dx, dy = np.split(cat, 2, axis=concat_axis)
    return dequantize_flow(dx, dy, *args, **kwargs)


def flowwrite(flow: np.ndarray, filename: str, quantize: bool = False,
              concat_axis: int = 0, *args, **kwargs) -> None:
    """Write flow as .flo (lossless) or a concatenated quantized image
    (reference `optflow.py:60-86`)."""
    if not quantize:
        with open(filename, "wb") as f:
            f.write(b"PIEH")
            np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
        return
    assert concat_axis in (0, 1)
    dx, dy = quantize_flow(flow, *args, **kwargs)
    from PIL import Image
    Image.fromarray(np.concatenate((dx, dy), axis=concat_axis)).save(
        filename)
