"""Flattened multi-level deformable sampling (counterpart of
``lsnet_tpu/ops/flat_deform.py``).

Every level of a branch is packed into one (B * sum(H_l W_l), C) row buffer;
all sampling jobs of a call become one tap-major table of corner rows and
weights, (nc, K, px); one launch of :func:`deform_gather_contract` then
gathers, weights and contracts without writing the patch tensor.

Semantics are those of :mod:`lsnet_torch.ops.deform_conv` (zero-padded
bilinear, the reference CUDA parity): out-of-range corners carry weight 0
and read a clipped, in-bounds row.

Sampling is an explicit argument per call: ``"bilinear"`` (4 corner reads
per tap), ``"nearest"`` (one rounded read, round half to even as
``jnp.round``) or ``"nearest_ste"`` (straight-through nearest, for
nearest-aware training: the value, and the gradients of the features, the
weight and the mask, are those of ``"nearest"``; the offsets take the
gradient the bilinear tent weights would give them). There is no
process-wide sampling state. The models take
a read-only mapping from sampling site to mode at call time:
``TRAIN_SAMPLING`` (bilinear everywhere, the JAX package without
``inference_sampling()``) or ``INFERENCE_SAMPLING`` (the shipped inference
default of ``lsnet_tpu/ops/flat_deform.py:178``, ``backbone=nearest``).

The mapping may also carry a refine tap subset under ``REFINE_TAPS``
(:func:`with_refine_taps`, the JAX package's ``LSNET_REFINE_TAPS``): the
3x3 refine-site gathers then sample only the kept taps, e.g. the plus
``(1, 3, 4, 5, 7)``, and the weight's dropped taps get a zero gradient.
Only the entry points read the environment variable; the layers read
the mapping.

Every step from offsets and masks to the corner weights is differentiable
torch code (``floor``, ``round`` and the range compares pass no gradient,
the tent weights ``1 - |ys - y0 - dy|`` do, as in JAX); the contraction is
a ``torch.autograd.Function`` with hand-written backward kernels.

Grouped calls (``groups`` > 1, the ResNeXt backbone DCN) contract with the
compact (K, C/G, cout) weight through
:func:`lsnet_torch.ops.grouped.deform_gather_grouped_contract`.
"""

from __future__ import annotations

import math
from types import MappingProxyType
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from .deform_conv import tent
from .deform_gather import deform_gather_contract
from .grouped import deform_gather_grouped_contract

# The sampling of an ops call unless its caller says otherwise.
DEFAULT_SAMPLING = "bilinear"
SAMPLING_MODES = ("bilinear", "nearest", "nearest_ste")

# Sampling sites: the backbone DCN stages, the head's tower DCN blocks, the
# pyramid refine with its paired cls gather.
SITES = ("backbone", "tower", "refine")
# Training and reference parity: bilinear at every site.
TRAIN_SAMPLING = MappingProxyType({s: "bilinear" for s in SITES})
# The shipped inference default: nearest at the backbone sites (one read
# per tap), bilinear at tower and refine.
INFERENCE_SAMPLING = MappingProxyType(
    {"backbone": "nearest", "tower": "bilinear", "refine": "bilinear"})

# The key of a sampling mapping that holds the refine tap subset (row-major
# indices into the 3x3 grid), absent for all nine taps.
REFINE_TAPS = "refine_taps"
# The plus-shaped subset of ``LSNET_REFINE_TAPS=5``: the centre and the
# four edge centres (``lsnet_tpu/ops/flat_deform.py`` ``_PLUS_TAPS``).
_PLUS_TAPS = (1, 3, 4, 5, 7)


def _parse_spec(spec: Optional[str]) -> Tuple[str, dict]:
    """(default mode, {listed site: mode}) of a JAX sampling spec string
    (``lsnet_tpu/ops/flat_deform.py`` ``_parse_sampling``)."""
    spec = (spec or DEFAULT_SAMPLING).strip()
    if "=" not in spec:
        return spec, {}
    listed = {}
    for part in spec.split(","):
        site, _, mode = part.partition("=")
        listed[site.strip()] = mode.strip() or "nearest"
    return DEFAULT_SAMPLING, listed


def sampling_from_spec(spec: Optional[str]) -> Mapping[str, str]:
    """A spec string (``"nearest_ste"``, or ``"site=mode,..."`` with the
    unlisted sites bilinear; None is bilinear) -> a read-only site->mode
    mapping."""
    default, listed = _parse_spec(spec)
    modes = {**dict.fromkeys(SITES, default), **listed}
    bad = {s: m for s, m in modes.items()
           if s not in SITES or m not in SAMPLING_MODES}
    if bad:
        raise ValueError(f"sampling spec {spec!r}: unknown {bad}")
    return MappingProxyType(modes)


def sampling_spec(spec: Optional[str]) -> str:
    """The string the JAX package records for a train spec
    (``current_sampling_spec`` after ``set_sampling(spec)``): one mode, or
    the listed ``site=mode`` entries sorted by site."""
    sampling_from_spec(spec)            # validate
    default, listed = _parse_spec(spec)
    if not listed:
        return default
    return ",".join(f"{s}={m}" for s, m in sorted(listed.items()))


def parse_refine_taps(spec: Optional[str]) -> Optional[Tuple[int, ...]]:
    """The kept taps of a ``LSNET_REFINE_TAPS`` spec: ``"5"`` the plus
    taps, ``"9"``, empty or None all nine (None), ``"i,j,..."`` the listed
    row-major indices (JAX's ``_refine_taps``)."""
    spec = (spec or "").strip()
    if not spec or spec == "9":
        return None
    if spec == "5":
        return _PLUS_TAPS
    taps = tuple(int(t) for t in spec.split(","))
    if not taps or any(not 0 <= t < 9 for t in taps):
        raise ValueError(f"refine taps {spec!r}: want 5, 9 or indices "
                         "0..8 of the 3x3 grid")
    return taps


def with_refine_taps(sampling: Mapping[str, str],
                     spec: Optional[str]) -> Mapping[str, str]:
    """``sampling`` with the refine taps of ``spec`` (None or ``"9"``: all
    nine, the key dropped; a mapping without taps comes back as it is)."""
    taps = parse_refine_taps(spec)
    if taps is None and REFINE_TAPS not in sampling:
        return sampling
    out = {k: v for k, v in sampling.items() if k != REFINE_TAPS}
    if taps is not None:
        out[REFINE_TAPS] = taps
    return MappingProxyType(out)


def refine_taps(sampling: Mapping[str, str]) -> Optional[Tuple[int, ...]]:
    """The refine tap subset a sampling mapping carries, or None."""
    return sampling.get(REFINE_TAPS)


class FlatLevels(NamedTuple):
    """Concatenated multi-level feature buffer + static level metadata."""
    flat: torch.Tensor               # (B * sum(HW_l), C)
    B: int
    shapes: Tuple[Tuple[int, int], ...]
    offsets: Tuple[int, ...]         # start row of each level (per image)
    total: int                       # sum(HW_l)


def pack_levels(feats: Sequence[torch.Tensor]) -> FlatLevels:
    """[(B,H,W,C)...] -> row-major concat (B*N, C) with per-level offsets.

    Layout: image-major, rows [b*N + off_l + y*W_l + x]."""
    B = feats[0].shape[0]
    C = feats[0].shape[-1]
    shapes = tuple((int(f.shape[1]), int(f.shape[2])) for f in feats)
    sizes = [h * w for h, w in shapes]
    offs = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    total = sum(sizes)
    flat = torch.cat([f.reshape(B, -1, C) for f in feats],
                     dim=1).reshape(B * total, C)
    return FlatLevels(flat, B, shapes, offs, total)


class SampleJob(NamedTuple):
    """One deformable sampling job: offset field -> samples in one level."""
    src_level: int
    offset: torch.Tensor             # (B, Ho, Wo, 2K) [y,x] interleaved
    mask: Optional[torch.Tensor]     # (B, Ho, Wo, K) or None
    scale: Tuple[float, float]       # base-coordinate scale (pyramid)
    stride: Tuple[int, int]
    padding: Tuple[int, int]
    dilation: Tuple[int, int]
    # a tap subset (kh, kw, row-major indices kept): the offset and mask
    # hold only the kept taps, whose base displacements come from the full
    # (kh, kw) grid
    taps: Optional[Tuple[int, int, Tuple[int, ...]]] = None


def _job_coords(job: SampleJob, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tap-major sample coordinates (B, K*Ho*Wo) in the source level's
    pixel units, always f32. The pyramid scale multiplies the base grid,
    not the offset."""
    B, Ho, Wo, _ = job.offset.shape
    if job.taps is not None:
        kh, kw, sel = job.taps
    else:
        kh = kw = math.isqrt(K)
        sel = None
    f32 = torch.float32
    dev = job.offset.device
    off = job.offset.reshape(B, Ho, Wo, K, 2).to(f32)
    hs = (torch.arange(Ho, dtype=f32, device=dev) * job.stride[0]
          - job.padding[0]).view(1, Ho, 1, 1)
    ws = (torch.arange(Wo, dtype=f32, device=dev) * job.stride[1]
          - job.padding[1]).view(1, 1, Wo, 1)
    dyy = (torch.arange(kh, dtype=f32, device=dev)
           * job.dilation[0]).repeat_interleave(kw)
    dxx = (torch.arange(kw, dtype=f32, device=dev)
           * job.dilation[1]).repeat(kh)
    if sel is not None:
        dyy, dxx = dyy[list(sel)], dxx[list(sel)]
    base_y = (hs + dyy.view(1, 1, 1, K)) * job.scale[0]
    base_x = (ws + dxx.view(1, 1, 1, K)) * job.scale[1]
    ys = (base_y + off[..., 0]).permute(0, 3, 1, 2)
    xs = (base_x + off[..., 1]).permute(0, 3, 1, 2)
    return ys.reshape(B, -1), xs.reshape(B, -1)


def _corner_data(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int,
                 base_row: torch.Tensor, sampling: str
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Flat row indices + weights for samples in one level: 4 corners
    (bilinear tent weights) or 1 (nearest). Indices are clipped into the
    level, so every read is in bounds; out-of-range corners weigh 0."""
    if sampling == "nearest":
        yi = torch.round(ys).to(torch.int32)
        xi = torch.round(xs).to(torch.int32)
        v = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)) + base_row
        return [idx], [v.to(torch.float32)]
    if sampling != "bilinear":
        raise ValueError(f"sampling {sampling!r}: want one of "
                         f"{SAMPLING_MODES} (nearest_ste is split into its "
                         "two tables by _corner_tables)")
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    y0i = y0.to(torch.int32)
    x0i = x0.to(torch.int32)
    idxs, wts = [], []
    for dy in (0, 1):
        yi = y0i + dy
        wy = tent(ys - y0 - dy, dy)
        yv = (yi >= 0) & (yi < H)
        for dx in (0, 1):
            xi = x0i + dx
            wx = tent(xs - x0 - dx, dx)
            v = yv & (xi >= 0) & (xi < W)
            idxs.append((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
                        + base_row)
            wts.append(wy * wx * v.to(torch.float32))
    return idxs, wts


def _gather_indices_tap(levels: FlatLevels, jobs: Sequence[SampleJob],
                        K: int, sampling: str):
    """Tap-major corner table for all jobs.

    Returns (idx (nc, K, totpx) int32, w (nc, K, totpx) f32) with pixel
    order (job, b, y, x); the mask is folded into ``w``."""
    B = levels.B
    dev = levels.flat.device
    img_base = (torch.arange(B, dtype=torch.int32, device=dev)
                * levels.total).view(B, 1)
    all_idx, all_w = [], []
    for job in jobs:
        H, W = levels.shapes[job.src_level]
        ys, xs = _job_coords(job, K)
        base_row = img_base + levels.offsets[job.src_level]
        idxs, wts = _corner_data(ys, xs, H, W, base_row, sampling)
        if job.mask is not None:
            m = job.mask.permute(0, 3, 1, 2).reshape(B, -1).to(torch.float32)
            wts = [w * m for w in wts]
        hw = ys.shape[1] // K
        nc = len(idxs)
        all_idx.append(torch.stack(idxs).reshape(nc, B, K, hw)
                       .permute(0, 2, 1, 3).reshape(nc, K, -1))
        all_w.append(torch.stack(wts).reshape(nc, B, K, hw)
                     .permute(0, 2, 1, 3).reshape(nc, K, -1))
    return (torch.cat(all_idx, dim=2).contiguous(),
            torch.cat(all_w, dim=2).contiguous())


def _corner_tables(levels: FlatLevels, jobs: Sequence[SampleJob], K: int,
                   sampling: str):
    """(idx, w, ste) of a call: the table that is sampled, and for
    ``nearest_ste`` under autograd the straight-through table ``ste`` =
    (idx, w) of the bilinear corners, else None.

    ``nearest_ste`` is the JAX package's mode of that name
    (``lsnet_tpu/ops/flat_deform.py`` ``_corner_data``), which reads the
    nearest row plus the bilinear corners at weights ``+w`` and
    ``-stop_gradient(w)``, nine reads per tap. Here the nearest table is
    sampled (one read) and the bilinear table only takes its ``d_w`` in
    the backward. Its mask is detached: in the JAX sum the two bilinear
    terms cancel in the mask's gradient, which so follows the nearest
    table, and leave the tent slopes to the offsets."""
    if sampling != "nearest_ste":
        return (*_gather_indices_tap(levels, jobs, K, sampling), None)
    idx, w = _gather_indices_tap(levels, jobs, K, "nearest")
    if not (torch.is_grad_enabled()
            and any(j.offset.requires_grad for j in jobs)):
        return idx, w, None
    held = [j._replace(mask=None if j.mask is None else j.mask.detach())
            for j in jobs]
    return idx, w, _gather_indices_tap(levels, held, K, "bilinear")


def _apply_refine_taps(jobs: Sequence[SampleJob],
                       weights: Sequence[torch.Tensor],
                       taps: Optional[Sequence[int]]):
    """Jobs and HWIO weights cut to the refine tap subset ``taps``
    (JAX's ``_apply_refine_taps``): the offsets and masks keep the listed
    taps, each weight becomes a (1, T, C, cout) kernel of them. A no-op
    without a subset or for a kernel that is not 3x3."""
    kh, kw = weights[0].shape[:2]
    K = kh * kw
    if taps is None or K != 9:
        return list(jobs), list(weights)
    sel = list(taps)
    T = len(sel)
    out_jobs = []
    for j in jobs:
        B, Ho, Wo, _ = j.offset.shape
        off = j.offset.reshape(B, Ho, Wo, K, 2)[:, :, :, sel, :]
        out_jobs.append(j._replace(
            offset=off.reshape(B, Ho, Wo, 2 * T),
            mask=None if j.mask is None else j.mask[..., sel],
            taps=(kh, kw, tuple(sel))))
    out_w = [w.reshape(K, *w.shape[2:])[sel].reshape(1, T, *w.shape[2:])
             for w in weights]
    return out_jobs, out_w


def _tap_weight(weight: torch.Tensor, dtype) -> torch.Tensor:
    """HWIO (kh, kw, C/G, cout) -> (K, C/G, cout)."""
    kh, kw, cin, cout = weight.shape
    return weight.reshape(kh * kw, cin, cout).to(dtype).contiguous()


def _split_jobs(out: torch.Tensor, jobs: Sequence[SampleJob],
                B: int) -> List[torch.Tensor]:
    """(total_px, cout) -> per-job (B, Ho, Wo, cout)."""
    outs, row = [], 0
    for job in jobs:
        _, Ho, Wo, _ = job.offset.shape
        n_px = B * Ho * Wo
        outs.append(out[row:row + n_px].reshape(B, Ho, Wo, out.shape[-1]))
        row += n_px
    return outs


def batched_deform_matmul(levels: FlatLevels, jobs: Sequence[SampleJob],
                          weight: torch.Tensor,
                          sampling: str = DEFAULT_SAMPLING,
                          groups: int = 1,
                          taps: Optional[Sequence[int]] = None
                          ) -> List[torch.Tensor]:
    """Run all jobs through one corner table and one kernel launch.

    weight: HWIO (kh, kw, C/groups, cout), group-major cout when grouped.
    ``taps``: the refine tap subset of an ungrouped 3x3 call, or None.
    Returns per-job (B, Ho, Wo, cout)."""
    if groups == 1:
        jobs, (weight,) = _apply_refine_taps(jobs, [weight], taps)
    K = weight.shape[0] * weight.shape[1]
    idx, w, ste = _corner_tables(levels, jobs, K, sampling)
    flat = levels.flat.contiguous()
    wk = _tap_weight(weight, flat.dtype)
    if groups == 1:
        out = deform_gather_contract(flat, idx, w, wk, ste)
    else:
        out = deform_gather_grouped_contract(flat, idx, w, wk, groups, ste)
    return _split_jobs(out, jobs, levels.B)


def multilevel_modulated_dcn(feats: Sequence[torch.Tensor],
                             offsets: Sequence[torch.Tensor],
                             masks: Sequence[torch.Tensor],
                             weight: torch.Tensor,
                             bias: Optional[torch.Tensor] = None, *,
                             stride: int = 1, padding: int = 1,
                             dilation: int = 1, groups: int = 1,
                             sampling: str = DEFAULT_SAMPLING
                             ) -> List[torch.Tensor]:
    """DCNv2 on every level with shared weights (NHWC in and out, weight
    HWIO (kh, kw, C/groups, cout), masks already sigmoid-ed): one kernel
    launch for all levels."""
    levels = pack_levels(feats)
    jobs = [SampleJob(i, offsets[i], masks[i], (1.0, 1.0),
                      (stride, stride), (padding, padding),
                      (dilation, dilation))
            for i in range(len(feats))]
    outs = batched_deform_matmul(levels, jobs, weight, sampling, groups)
    if bias is not None:
        outs = [o + bias.to(o.dtype) for o in outs]
    return outs


def multilevel_pyramid_dcn(feats: Sequence[torch.Tensor],
                           jobs: Sequence[SampleJob], weight: torch.Tensor,
                           sampling: str = DEFAULT_SAMPLING,
                           taps: Optional[Sequence[int]] = None
                           ) -> List[torch.Tensor]:
    """PyramidDeformConv for a whole branch (all output levels x all source
    levels): one kernel launch, at the refine tap subset ``taps`` when
    given."""
    return batched_deform_matmul(pack_levels(feats), jobs, weight, sampling,
                                 taps=taps)


def dual_pyramid_dcn(feats_a: Sequence[torch.Tensor],
                     feats_b: Sequence[torch.Tensor],
                     jobs: Sequence[SampleJob], weight_a: torch.Tensor,
                     weight_b: torch.Tensor,
                     sampling: str = DEFAULT_SAMPLING,
                     taps: Optional[Sequence[int]] = None
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Two branches sampled at identical positions (the refine and cls
    branches share one offset field): one corner table, two launches
    (autograd sums the two launches' gradients of the table); both at the
    refine tap subset ``taps`` when given."""
    if [f.shape[1:3] for f in feats_a] != [f.shape[1:3] for f in feats_b]:
        raise ValueError("dual_pyramid_dcn: branches differ in level shapes")
    jobs, (weight_a, weight_b) = _apply_refine_taps(
        jobs, [weight_a, weight_b], taps)
    lv_a = pack_levels(feats_a)
    lv_b = pack_levels(feats_b)
    K = weight_a.shape[0] * weight_a.shape[1]
    idx, w, ste = _corner_tables(lv_a, jobs, K, sampling)
    out_a = deform_gather_contract(lv_a.flat.contiguous(), idx, w,
                                   _tap_weight(weight_a, lv_a.flat.dtype),
                                   ste)
    out_b = deform_gather_contract(lv_b.flat.contiguous(), idx, w,
                                   _tap_weight(weight_b, lv_b.flat.dtype),
                                   ste)
    return _split_jobs(out_a, jobs, lv_a.B), _split_jobs(out_b, jobs, lv_b.B)
