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

It is a ``torch.autograd.Function`` (the same as
:func:`lsnet_torch.ops.deform_gather.deform_gather_contract`, with the
grouped functions): with G[k, p, ch] = sum over the n of ch's group of
dout[p, n] * weight[k, ch % Cg, n],

    d_flat[idx[c, k, p], :] += w[c, k, p] * G[k, p, :]
    d_w[c, k, p]             = flat[idx[c, k, p], :] . G[k, p, :]
    d_weight[k, i, n]        = sum_p v[k, p, g(n) * Cg + i] * dout[p, n]

On CUDA tensors forward and backward launch the hand-written kernels
``csrc/grouped_deform_contract.cu``,
``csrc/grouped_deform_contract_bwd_data.cu`` (counterpart of
``pallas_grouped._make_dv_kernel``) and
``csrc/grouped_deform_contract_bwd_weight.cu`` (counterpart of
``pallas_grouped._make_dw_kernel`` and the pull-back to the compact
layout) or raise; on CPU tensors they run the plain versions
``deform_gather_grouped_contract_ref`` / ``*_bwd_data_ref`` /
``*_bwd_weight_ref``. The backward kernels add into f32 buffers with
atomics, so their sums' order, and the last bits, change from run to run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .deform_gather import (ContractOps, GatherContract, check_dout,
                            gathered_rows, launch, px_splits,
                            scatter_rows_ref, sm_count, wave_px_splits)

_ALIGN = 16
TILE = 64          # the kernel's cout tile; outG must divide it
# the bf16 bwd-weight kernel gdw_bf16 takes Cg == outG of these widths, TAPS
# taps a block (csrc/grouped_deform_contract_bwd_weight.cu)
GDW_CG = (8, 16, 32)
GDW_TAPS = 3


def deform_gather_grouped_contract_ref(flat: torch.Tensor, idx: torch.Tensor,
                                       w: torch.Tensor, weight: torch.Tensor,
                                       groups: int) -> torch.Tensor:
    """Plain PyTorch version: gather and weight the corner rows in f32, then
    one grouped einsum over (K, px, G, Cg) x (K, Cg, G, outG)."""
    _, K, px = idx.shape
    Cg, cout = weight.shape[1], weight.shape[2]
    out = torch.einsum("kpgc,kcgj->pgj",
                       gathered_rows(flat, idx, w).view(K, px, groups, Cg),
                       weight.float().view(K, Cg, groups, cout // groups))
    return out.reshape(px, cout).to(flat.dtype)


def deform_gather_grouped_contract_bwd_data_ref(flat, idx, w, weight, dout,
                                                groups, need_flat=True,
                                                need_w=True):
    """Plain PyTorch version of the backward w.r.t. (flat, w)."""
    _, K, px = idx.shape
    Cg, cout = weight.shape[1], weight.shape[2]
    G = torch.einsum("pgj,kcgj->kpgc",
                     dout.float().view(px, groups, cout // groups),
                     weight.float().view(K, Cg, groups, cout // groups))
    return scatter_rows_ref(flat, idx, w, G.reshape(K, px, groups * Cg),
                            need_flat, need_w)


def deform_gather_grouped_contract_bwd_weight_ref(flat, idx, w, dout,
                                                  groups):
    """Plain PyTorch version of the backward w.r.t. the compact weight:
    (K, Cg, cout) in flat's dtype."""
    _, K, px = idx.shape
    cout = dout.shape[1]
    Cg = flat.shape[1] // groups
    d_weight = torch.einsum(
        "kpgc,pgj->kcgj", gathered_rows(flat, idx, w).view(K, px, groups, Cg),
        dout.float().view(px, groups, cout // groups))
    return d_weight.reshape(K, Cg, cout).to(flat.dtype)


def deform_gather_grouped_contract_bwd_ref(flat, idx, w, weight, dout,
                                           groups):
    """(d_flat, d_w, d_weight) of the plain versions."""
    d_flat, d_w = deform_gather_grouped_contract_bwd_data_ref(
        flat, idx, w, weight, dout, groups)
    return d_flat, d_w, deform_gather_grouped_contract_bwd_weight_ref(
        flat, idx, w, dout, groups)


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
    f32), every tensor on flat's device, contiguous and 16-byte aligned.
    The bf16 kernel's shared memory, which grows with nc x K, is checked by
    its C entry: a table past the card's limit (nc x K above about 300)
    makes the launch raise."""
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


def _check_bwd_limits(weight, groups):
    """The backward kernels build G and d_weight in 64-channel tiles, one
    per cout tile: the channel slice of a cout tile must be 64 wide."""
    _, Cg, cout = weight.shape
    if TILE // (cout // groups) * Cg != TILE:
        raise ValueError(f"backward kernels need a {TILE}-channel slice per "
                         f"cout tile (Cg == outG); got Cg={Cg}, "
                         f"outG={cout // groups}")


def _forward(flat, idx, w, weight, groups):
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
    launch("grouped_deform_contract", "lsnet_grouped_deform_contract", flat,
           flat.data_ptr(), idx.data_ptr(), w.data_ptr(), weight.data_ptr(),
           out.data_ptr(), flat.shape[1], Cg, cout // groups, nc, K, px,
           cout, int(flat.dtype == torch.bfloat16))
    deform_gather_grouped_contract.launches += 1
    return out


def deform_gather_grouped_contract_bwd_data(flat, idx, w, weight, dout,
                                            groups, need_flat=True,
                                            need_w=True):
    """(d_flat (R, C) in flat's dtype, d_w (nc, K, px) f32), None where
    not needed; the kernel on CUDA, the plain version on the CPU."""
    _check_shapes(flat, idx, w, weight, groups)
    if flat.device.type == "cpu":
        return deform_gather_grouped_contract_bwd_data_ref(
            flat, idx, w, weight, dout, groups, need_flat, need_w)
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    _check_kernel_limits(flat, idx, w, weight, groups)
    _check_bwd_limits(weight, groups)
    nc, K, px = idx.shape
    _, Cg, cout = weight.shape
    vec = _ALIGN // flat.element_size()
    if (cout // groups) % vec:
        # the kernel loads a row's own group 16 bytes at a time
        raise ValueError(f"bwd-data needs outG={cout // groups} to be a "
                         f"multiple of {vec} for {flat.dtype}")
    dout = check_dout(dout, flat, px, cout)
    d_flat = (torch.zeros(flat.shape, dtype=torch.float32,
                          device=flat.device) if need_flat else None)
    d_w = torch.zeros_like(w) if need_w else None
    if px and (need_flat or need_w):
        launch("grouped_deform_contract_bwd_data",
               "lsnet_grouped_deform_contract_bwd_data", flat,
               flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
               weight.data_ptr(), dout.data_ptr(),
               d_flat.data_ptr() if need_flat else None,
               d_w.data_ptr() if need_w else None, flat.shape[1], Cg,
               cout // groups, nc, K, px, cout,
               int(flat.dtype == torch.bfloat16))
        deform_gather_grouped_contract_bwd_data.launches += 1
    return (d_flat.to(flat.dtype) if need_flat else None), d_w


def bwd_weight_splits(dtype, sms, K, Cg, cout, px):
    """nsplit of the bwd-weight launch: the px shares of ``gdw_bf16`` (bf16
    with Cg == outG in GDW_CG, every X-101 stage: blocks of GDW_TAPS taps,
    two an SM, ``wave_px_splits``); of the generic kernel (every other
    shape, and f32: a block a tap, about four an SM, ``px_splits``)
    otherwise. ``_check_bwd_limits`` has already asked Cg == outG."""
    if dtype == torch.bfloat16 and Cg in GDW_CG:
        # 2 blocks an SM: gdw_bf16 takes 88 KB of shared memory at nc = 4
        return wave_px_splits(sms, cout // TILE * -(-K // GDW_TAPS), px,
                              2, GDW_TAPS)
    return px_splits(sms, cout // TILE * K, px)


def deform_gather_grouped_contract_bwd_weight(flat, idx, w, weight, dout,
                                              groups):
    """d_weight (K, Cg, cout) in flat's dtype (``weight`` gives the shape;
    its values are not read); the kernel on CUDA (``gdw_bf16`` in bf16
    where Cg == outG is 8, 16 or 32, the generic kernel for every other
    shape and for f32, by the rule of ``bwd_weight_splits``), the plain
    version on the CPU."""
    _check_shapes(flat, idx, w, weight, groups)
    if flat.device.type == "cpu":
        return deform_gather_grouped_contract_bwd_weight_ref(flat, idx, w,
                                                             dout, groups)
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    _check_kernel_limits(flat, idx, w, weight, groups)
    _check_bwd_limits(weight, groups)
    nc, K, px = idx.shape
    _, Cg, cout = weight.shape
    dout = check_dout(dout, flat, px, cout)
    d_weight = torch.zeros((K, Cg, cout), dtype=torch.float32,
                           device=flat.device)
    if px:
        launch("grouped_deform_contract_bwd_weight",
               "lsnet_grouped_deform_contract_bwd_weight", flat,
               flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
               dout.data_ptr(), d_weight.data_ptr(), flat.shape[1], Cg,
               cout // groups, nc, K, px, cout,
               bwd_weight_splits(flat.dtype, sm_count(flat.device), K, Cg,
                                 cout, px),
               int(flat.dtype == torch.bfloat16))
        deform_gather_grouped_contract_bwd_weight.launches += 1
    return d_weight.to(flat.dtype)


def _ops(groups: int) -> ContractOps:
    return ContractOps(
        lambda flat, idx, w, weight: _forward(flat, idx, w, weight, groups),
        lambda flat, idx, w, weight, dout, need_flat, need_w:
            deform_gather_grouped_contract_bwd_data(
                flat, idx, w, weight, dout, groups, need_flat, need_w),
        lambda flat, idx, w, weight, dout:
            deform_gather_grouped_contract_bwd_weight(flat, idx, w, weight,
                                                      dout, groups))


def deform_gather_grouped_contract(flat: torch.Tensor, idx: torch.Tensor,
                                   w: torch.Tensor, weight: torch.Tensor,
                                   groups: int,
                                   ste: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]] = None
                                   ) -> torch.Tensor:
    """(px, cout) in flat's dtype; kernels on CUDA, plain versions on the
    CPU, differentiable on both. ``ste``: a straight-through table, see
    :class:`lsnet_torch.ops.deform_gather.GatherContract`."""
    ste_idx, ste_w = ste if ste is not None else (None, None)
    return GatherContract.apply(_ops(groups), flat, idx, w, weight, ste_idx,
                                ste_w)


# launches of each CUDA kernel since its count was last set to 0
deform_gather_grouped_contract.launches = 0
deform_gather_grouped_contract_bwd_data.launches = 0
deform_gather_grouped_contract_bwd_weight.launches = 0


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
