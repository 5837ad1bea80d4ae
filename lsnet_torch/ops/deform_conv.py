"""Per-level deformable convolutions, plain PyTorch (counterpart of
``lsnet_tpu/ops/deform_conv.py``): the independent oracle for the flat
multi-level engine and its kernel.

Reference semantics (``mmdet/ops/dcn/src/cuda/deform_conv_cuda_kernel.cu``):

* ``deform_conv`` (DCNv1): the same sampling with no mask;
* ``modulated_deform_conv`` (DCNv2): for output pixel (h, w) and tap (i, j)
  sample the input at ``y = h*stride - pad + i*dil + off_y`` with
  zero-padded bilinear interpolation, multiply by the tap's mask and
  contract with the conv weight.
* ``pyramid_deform_conv`` (LSNet): the output grid is the offset's grid and
  the base position is scaled into the input's resolution,
  ``y = (h*stride - pad + i*dil) * scale_h + off_y``.

Each bilinear corner outside the map contributes zero. Layout is NHWC,
weights HWIO (``(kh, kw, Cin/groups, cout)`` with group-major channels when
``groups`` > 1), offsets ``[y0, x0, y1, x1, ...]`` on the last axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def tent(d: torch.Tensor, corner: int) -> torch.Tensor:
    """The bilinear tent weight ``1 - |d|`` of corner 0 or 1 at distance
    ``d = ys - floor(ys) - corner``: ``1 - d`` for corner 0 (d >= 0) and
    ``1 + d`` for corner 1 (d < 0), the same values as ``1 - |d|``.

    Written without ``abs``, its derivative at d = 0 is -1, as ``jnp.abs``
    (derivative +1 at 0) gives it in the JAX package: at a sample on the
    lattice (a zero offset, as every DCN starts from its zero-initialised
    ``conv_offset``) the offset gradient is the one-sided difference toward
    the next corner, the reference CUDA's. ``torch.abs``'s derivative at 0
    is 0, which drops the sampled corner's term there."""
    return 1.0 - d if corner == 0 else 1.0 + d


def bilinear_gather(feat: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sampling: feat (B,H,W,C), ys/xs (B,P) -> (B,P,C)."""
    B, H, W, C = feat.shape
    boffs = (torch.arange(B, device=feat.device) * (H * W)).view(B, 1)
    return bilinear_gather_rows(feat.reshape(B * H * W, C), boffs, H, W,
                                ys, xs)


def _clip(v: torch.Tensor, hi) -> torch.Tensor:
    """``v`` clipped to [0, hi], ``hi`` an int or a tensor."""
    return (v.clamp(0, hi) if isinstance(hi, int)
            else torch.minimum(v.clamp(min=0), hi))


def bilinear_gather_rows(rows: torch.Tensor, base: torch.Tensor, h, w,
                         ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """:func:`bilinear_gather` on row-major maps inside one table: rows
    (R, C); sample set n reads the map of ``h[n]`` x ``w[n]`` rows (ints,
    or (N, 1) tensors) whose row (0, 0) is ``base[n]`` ((N, 1)); ys/xs
    (N, P) -> (N, P, C)."""
    ys = ys.float()
    xs = xs.float()
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y0i = y0.long()
    x0i = x0.long()
    N, C = ys.shape[0], rows.shape[1]
    out = None
    for dy in (0, 1):
        yi = y0i + dy
        wy = tent(ys - y0 - dy, dy)
        yvalid = (yi >= 0) & (yi < h)
        for dx in (0, 1):
            xi = x0i + dx
            wx = tent(xs - x0 - dx, dx)
            valid = yvalid & (xi >= 0) & (xi < w)
            flat = _clip(yi, h - 1) * w + _clip(xi, w - 1) + base
            wt = (wy * wx * valid).to(rows.dtype).unsqueeze(-1)
            v = rows[flat.reshape(-1)].reshape(N, -1, C) * wt
            out = v if out is None else out + v
    return out


def _sample_patches(x: torch.Tensor, offset: torch.Tensor,
                    kernel_size: Tuple[int, int], stride, padding, dilation,
                    scale: Optional[Tuple[float, float]] = None
                    ) -> torch.Tensor:
    """(B, Ho, Wo, K, C) deformable patches of x (coordinates in f32)."""
    B, H, W, C = x.shape
    _, Ho, Wo, _ = offset.shape
    kh, kw = kernel_size
    K = kh * kw
    f32 = torch.float32
    dev = x.device
    off = offset.reshape(B, Ho, Wo, K, 2).to(f32)
    hs = (torch.arange(Ho, dtype=f32, device=dev) * stride[0]
          - padding[0]).view(1, Ho, 1, 1)
    ws = (torch.arange(Wo, dtype=f32, device=dev) * stride[1]
          - padding[1]).view(1, 1, Wo, 1)
    dyy = (torch.arange(kh, dtype=f32, device=dev)
           * dilation[0]).repeat_interleave(kw)
    dxx = (torch.arange(kw, dtype=f32, device=dev) * dilation[1]).repeat(kh)
    base_y = hs + dyy.view(1, 1, 1, K)
    base_x = ws + dxx.view(1, 1, 1, K)
    if scale is not None:
        base_y = base_y * scale[0]
        base_x = base_x * scale[1]
    ys = (base_y + off[..., 0]).reshape(B, -1)
    xs = (base_x + off[..., 1]).reshape(B, -1)
    return bilinear_gather(x, ys, xs).reshape(B, Ho, Wo, K, C)


def _contract(patches: torch.Tensor, weight: torch.Tensor,
              groups: int = 1) -> torch.Tensor:
    """(B,Ho,Wo,K,C) x (kh,kw,C/groups,cout) -> (B,Ho,Wo,cout), f32
    accumulate; grouped: group-major channels and cout."""
    B, Ho, Wo, K, C = patches.shape
    cout = weight.shape[-1]
    if groups == 1:
        w = weight.reshape(K * C, cout).float()
        out = patches.reshape(B * Ho * Wo, K * C).float() @ w
        return out.reshape(B, Ho, Wo, cout).to(patches.dtype)
    cg = C // groups
    pg = patches.reshape(B, Ho * Wo, K, groups, cg).float()
    wg = weight.reshape(K, cg, groups, cout // groups).float()
    out = torch.einsum("bpkgc,kcgo->bpgo", pg, wg)
    return out.reshape(B, Ho, Wo, cout).to(patches.dtype)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                *, stride=1, padding=0, dilation=1,
                groups: int = 1) -> torch.Tensor:
    """DCNv1. x (B,H,W,Cin), offset (B,Ho,Wo,2K), weight
    (kh,kw,Cin/groups,cout)."""
    ks = (weight.shape[0], weight.shape[1])
    patches = _sample_patches(x, offset, ks, _pair(stride), _pair(padding),
                              _pair(dilation))
    return _contract(patches, weight, groups)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *, stride=1,
                          padding=0, dilation=1,
                          groups: int = 1) -> torch.Tensor:
    """DCNv2. mask (B,Ho,Wo,K) already sigmoid-ed; weight
    (kh,kw,Cin/groups,cout)."""
    ks = (weight.shape[0], weight.shape[1])
    patches = _sample_patches(x, offset, ks, _pair(stride), _pair(padding),
                              _pair(dilation))
    patches = patches * mask.unsqueeze(-1).to(patches.dtype)
    out = _contract(patches, weight, groups)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def pyramid_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                        weight: torch.Tensor, scale_h: float, scale_w: float,
                        *, stride=1, padding=0, dilation=1,
                        groups: int = 1) -> torch.Tensor:
    """LSNet cross-level deformable conv (output grid = offset's grid)."""
    ks = (weight.shape[0], weight.shape[1])
    patches = _sample_patches(x, offset, ks, _pair(stride), _pair(padding),
                              _pair(dilation), scale=(scale_h, scale_w))
    return _contract(patches, weight, groups)
