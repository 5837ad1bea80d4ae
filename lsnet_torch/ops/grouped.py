"""Fused deformable gather + grouped contraction: the kernel of the grouped
backbone DCN sites (ResNeXt conv2 in stages c3-c5); counterpart of
``lsnet_tpu/ops/pallas_grouped.py``.

``deform_gather_grouped_contract`` computes, for ``groups`` = G,

    v[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
    out[p, n]  = sum_k sum_{i < Cg} v[k, p, g(n) * Cg + i] * weight[k, i, n]

with g(n) = n // outG, for ``flat`` (R, C) with group-major channels
(C = G * Cg), ``idx``/``w`` (nc, K, px) as built by
``flat_deform._gather_indices_tap`` and ``weight`` (K, Cg, cout) the compact
grouped weight with group-major cout (outG = cout / G). It accumulates in
f32 and returns (px, cout) in ``flat``'s dtype.

On a CUDA tensor it launches the hand-written kernel
``csrc/grouped_deform_contract.cu`` or raises; on a CPU tensor it runs the
plain version ``deform_gather_grouped_contract_ref``.
"""

from __future__ import annotations

import torch

from .. import _build

_ALIGN = 16
TILE = 64          # the kernel's cout tile; outG must divide it


def deform_gather_grouped_contract_ref(flat: torch.Tensor, idx: torch.Tensor,
                                       w: torch.Tensor, weight: torch.Tensor,
                                       groups: int) -> torch.Tensor:
    """Plain PyTorch version: gather and weight the corner rows in f32, then
    one grouped einsum over (K, px, G, Cg) x (K, Cg, G, outG)."""
    nc, K, px = idx.shape
    f = flat.float()
    vals = f[idx[0].long()] * w[0].unsqueeze(-1)
    for c in range(1, nc):
        vals = vals + f[idx[c].long()] * w[c].unsqueeze(-1)
    Cg, cout = weight.shape[1], weight.shape[2]
    out = torch.einsum("kpgc,kcgj->pgj",
                       vals.view(K, px, groups, Cg),
                       weight.float().view(K, Cg, groups, cout // groups))
    return out.reshape(px, cout).to(flat.dtype)


def _check_shapes(flat, idx, w, weight, groups):
    """The function's own shape rules (every device)."""
    if flat.dim() != 2 or idx.dim() != 3 or w.shape != idx.shape \
            or weight.dim() != 3:
        raise ValueError(
            f"shapes flat {tuple(flat.shape)}, idx {tuple(idx.shape)}, "
            f"w {tuple(w.shape)}, weight {tuple(weight.shape)}: want "
            "(R, C), (nc, K, px), (nc, K, px), (K, Cg, cout)")
    K, Cg, cout = weight.shape
    C = flat.shape[1]
    if groups < 1 or C != groups * Cg or cout % groups:
        raise ValueError(f"groups={groups} does not split C={C} into "
                         f"Cg={Cg} and cout={cout}")
    if idx.shape[1] != K:
        raise ValueError(f"weight has K={K} taps, idx {idx.shape[1]}")
    if flat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flat dtype {flat.dtype}: want float32 or bfloat16")
    if weight.dtype != flat.dtype:
        raise TypeError(f"weight dtype {weight.dtype} != flat {flat.dtype}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx {idx.dtype} / w {w.dtype}: want int32 / float32")


def _check_kernel_limits(flat, idx, w, weight, groups):
    """The shapes the CUDA kernel takes: 1..4 corners, outG dividing the
    64-wide cout tile, cout a multiple of it, each tile's channel slice
    (64 / outG * Cg) a multiple of the kernel's channel chunk (32 bf16, 16
    f32), every tensor on flat's device, contiguous and 16-byte aligned."""
    nc = idx.shape[0]
    _, Cg, cout = weight.shape
    outG = cout // groups
    if not 1 <= nc <= 4:
        raise ValueError(f"nc={nc}: want 1..4 corners per tap")
    if TILE % outG or cout % TILE:
        raise ValueError(f"outG={outG} must divide {TILE} and cout={cout} "
                         f"be a multiple of {TILE}")
    chunk = 32 if flat.dtype == torch.bfloat16 else 16
    if (TILE // outG * Cg) % chunk:
        raise ValueError(f"channel slice {TILE // outG * Cg} of a cout tile "
                         f"is not a multiple of {chunk}")
    for name, t in (("flat", flat), ("idx", idx), ("w", w),
                    ("weight", weight)):
        if t.device != flat.device:
            raise ValueError(f"{name} on {t.device}, flat on {flat.device}")
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def deform_gather_grouped_contract(flat: torch.Tensor, idx: torch.Tensor,
                                   w: torch.Tensor, weight: torch.Tensor,
                                   groups: int) -> torch.Tensor:
    """(px, cout) in flat's dtype; the kernel on CUDA, the plain version on
    the CPU."""
    _check_shapes(flat, idx, w, weight, groups)
    if flat.device.type == "cpu":
        return deform_gather_grouped_contract_ref(flat, idx, w, weight,
                                                  groups)
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    _check_kernel_limits(flat, idx, w, weight, groups)
    nc, K, px = idx.shape
    _, Cg, cout = weight.shape
    out = torch.empty((px, cout), dtype=flat.dtype, device=flat.device)
    if px == 0:
        return out
    lib = _build.load("grouped_deform_contract")
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lsnet_grouped_deform_contract(
            flat.data_ptr(), idx.data_ptr(), w.data_ptr(), weight.data_ptr(),
            out.data_ptr(), flat.shape[1], Cg, cout // groups, nc, K, px,
            cout, int(flat.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"grouped_deform_contract launch failed: CUDA "
                           f"error {rc}")
    deform_gather_grouped_contract.launches += 1
    return out


# launches of the CUDA kernel since the count was last set to 0
deform_gather_grouped_contract.launches = 0


def grouped_deform_contract(vals: torch.Tensor, weight: torch.Tensor, K: int,
                            groups: int) -> torch.Tensor:
    """The JAX signature (``pallas_grouped.grouped_deform_contract``): vals
    (px, K*C) already gathered, channel index k*C + ch; weight (K, Cg,
    cout). The fused function on an identity table: row p*K + k of
    ``vals.reshape(px*K, C)`` with weight 1, one corner."""
    px = vals.shape[0]
    C = vals.shape[1] // K
    idx = torch.arange(px * K, dtype=torch.int32, device=vals.device)
    idx = idx.view(px, K).t().contiguous().unsqueeze(0)
    w = torch.ones(1, K, px, dtype=torch.float32, device=vals.device)
    return deform_gather_grouped_contract(vals.reshape(px * K, C).contiguous(),
                                          idx, w, weight, groups)
