"""Fused deformable gather + contraction: the kernel of every DCN site.

``deform_gather_contract`` computes

    out[p, :] = sum_k sum_c w[c, k, p] * flat[idx[c, k, p], :] @ weight[k]

for ``flat`` (R, C), ``idx`` (nc, K, px) int32, ``w`` (nc, K, px) f32 (corner
weights with the DCNv2 mask folded in; nc = 4 bilinear, 1 nearest) and
``weight`` (K, C, cout). It accumulates in f32 and returns (px, cout) in
``flat``'s dtype.

On a CUDA tensor it launches the hand-written kernel
``csrc/deform_gather_contract.cu`` (the Hopper counterpart of
``lsnet_tpu/ops/pallas_dma_gather.py`` ``dma_quad_contract``) or raises; on a
CPU tensor it runs the plain version ``deform_gather_contract_ref``.
"""

from __future__ import annotations

import torch

from .. import _build

_ALIGN = 16


def deform_gather_contract_ref(flat: torch.Tensor, idx: torch.Tensor,
                               w: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, weight, einsum (f32 arithmetic)."""
    nc = idx.shape[0]
    f = flat.float()
    vals = f[idx[0].long()] * w[0].unsqueeze(-1)
    for c in range(1, nc):
        vals = vals + f[idx[c].long()] * w[c].unsqueeze(-1)
    out = torch.einsum("kpc,kco->po", vals, weight.float())
    return out.to(flat.dtype)


def _check(flat, idx, w, weight):
    if flat.dim() != 2 or idx.dim() != 3 or w.shape != idx.shape \
            or weight.dim() != 3:
        raise ValueError(
            f"shapes flat {tuple(flat.shape)}, idx {tuple(idx.shape)}, "
            f"w {tuple(w.shape)}, weight {tuple(weight.shape)}: want "
            "(R, C), (nc, K, px), (nc, K, px), (K, C, cout)")
    nc, K, _ = idx.shape
    C = flat.shape[1]
    if not 1 <= nc <= 4:
        raise ValueError(f"nc={nc}: want 1..4 corners per tap")
    if weight.shape[0] != K or weight.shape[1] != C:
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"K={K}, C={C}")
    if flat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flat dtype {flat.dtype}: want float32 or bfloat16")
    if weight.dtype != flat.dtype:
        raise TypeError(f"weight dtype {weight.dtype} != flat {flat.dtype}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx {idx.dtype} / w {w.dtype}: want int32 / float32")
    chunk = 32 if flat.dtype == torch.bfloat16 else 16
    if C % chunk or weight.shape[2] % 8:
        raise ValueError(f"C={C} must be a multiple of {chunk} and "
                         f"cout={weight.shape[2]} of 8")
    for name, t in (("flat", flat), ("idx", idx), ("w", w),
                    ("weight", weight)):
        if t.device != flat.device:
            raise ValueError(f"{name} on {t.device}, flat on {flat.device}")
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def deform_gather_contract(flat: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor,
                           weight: torch.Tensor) -> torch.Tensor:
    """(px, cout) in flat's dtype; the kernel on CUDA, the plain version on
    the CPU."""
    if flat.device.type == "cpu":
        return deform_gather_contract_ref(flat, idx, w, weight)
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    _check(flat, idx, w, weight)
    nc, K, px = idx.shape
    C = flat.shape[1]
    cout = weight.shape[2]
    out = torch.empty((px, cout), dtype=flat.dtype, device=flat.device)
    if px == 0:
        return out
    lib = _build.load("deform_gather_contract")
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lsnet_deform_gather_contract(
            flat.data_ptr(), idx.data_ptr(), w.data_ptr(), weight.data_ptr(),
            out.data_ptr(), C, nc, K, px, cout,
            int(flat.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"deform_gather_contract launch failed: CUDA "
                           f"error {rc}")
    deform_gather_contract.launches += 1
    return out


# launches of the CUDA kernel since the count was last set to 0
deform_gather_contract.launches = 0
