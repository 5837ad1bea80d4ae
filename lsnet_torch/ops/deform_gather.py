"""Fused deformable gather + contraction: the kernel of every DCN site.

``deform_gather_contract`` computes

    out[p, :] = sum_k sum_c w[c, k, p] * flat[idx[c, k, p], :] @ weight[k]

for ``flat`` (R, C), ``idx`` (nc, K, px) int32, ``w`` (nc, K, px) f32 (corner
weights with the DCNv2 mask folded in; nc = 4 bilinear, 1 nearest) and
``weight`` (K, C, cout). It accumulates in f32 and returns (px, cout) in
``flat``'s dtype.

It is a ``torch.autograd.Function``. With G[k, p, :] = dout[p, :] @
weight[k]^T and V[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :] its
backward is

    d_flat[idx[c, k, p], :] += w[c, k, p] * G[k, p, :]
    d_w[c, k, p]             = flat[idx[c, k, p], :] . G[k, p, :]
    d_weight[k]              = V[k]^T @ dout

(``d_w`` carries the gradient to the offsets and the mask, which build
``w`` in differentiable torch code).

On CUDA tensors forward and backward launch the hand-written kernels
``csrc/deform_gather_contract.cu`` (the Hopper counterpart of
``lsnet_tpu/ops/pallas_dma_gather.py`` ``dma_quad_contract``),
``csrc/deform_gather_contract_bwd_data.cu`` and
``csrc/deform_gather_contract_bwd_weight.cu`` (the counterparts of its XLA
backward ``_bwd``) or raise; on CPU tensors they run the plain versions
``deform_gather_contract_ref`` / ``*_bwd_data_ref`` / ``*_bwd_weight_ref``.
The bf16 routes of the forward and bwd-weight kernels take blocks of all
256 output columns (``csrc/k1_wgmma.cuh``: wgmma products on chunks that
TMA brings in); the f32 routes, kept for exact checks, 64 x 64 tiles.
The backward kernels add into f32 buffers with atomics, so their sums'
order, and the last bits, change from run to run.

The kernels take C in multiples of 32 (bf16) or 16 (f32) and cout in
multiples of 8 (16-byte rows for ``cp.async`` and the TMA strides). The
three wrappers take any C and cout: they zero-pad ``flat``'s rows and the
weight to those multiples (:func:`pad_channels`, a copy of ``flat`` per
call: Res2Net's 52 / 104 / 208 channels become 64 / 128 / 224 in bf16,
CPV's 262-channel refine 288), the backward ones ``dout``'s columns too,
and slice the outputs. :func:`deform_gather_contract` pads once, before
the autograd function, on CUDA tensors: the function then saves the
padded operands for its backward, whose wrappers find nothing left to
pad, and autograd slices the gradients of the padding away (the padded
``dout`` comes from the backward of the output's slice).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

_ALIGN = 16


def deform_gather_contract_ref(flat: torch.Tensor, idx: torch.Tensor,
                               w: torch.Tensor,
                               weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, weight, einsum (f32 arithmetic)."""
    out = torch.einsum("kpc,kco->po", gathered_rows(flat, idx, w),
                       weight.float())
    return out.to(flat.dtype)


def channel_multiples(dtype: torch.dtype) -> Tuple[int, int]:
    """(C, cout) multiples the kernels take for ``dtype``."""
    return (32 if dtype == torch.bfloat16 else 16), 8


def pad_channels(flat: torch.Tensor, weight: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flat`` (R, C) and ``weight`` (K, C, cout) zero-padded to C and
    cout multiples of :func:`channel_multiples` (the inputs themselves
    where they are already): the zero channels add nothing to the sums,
    the zero columns give output columns that are sliced away."""
    mc, mo = channel_multiples(flat.dtype)
    C, cout = flat.shape[1], weight.shape[2]
    pc, po = -C % mc, -cout % mo
    if pc:
        flat = F.pad(flat, (0, pc))
    if pc or po:
        weight = F.pad(weight, (0, po, 0, pc))
    return flat, weight


def pad_dout(dout: torch.Tensor, cout: int) -> torch.Tensor:
    """``dout`` (px, cout') zero-padded to ``cout`` columns (itself where
    it has them)."""
    return dout if dout.shape[1] == cout else F.pad(
        dout, (0, cout - dout.shape[1]))


def _check(flat, idx, w, weight, channels=True):
    """Raise unless the kernels take these operands; ``channels=False``
    leaves out the rule on C and cout (for the padding wrappers)."""
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
    chunk, mo = channel_multiples(flat.dtype)
    if channels and (C % chunk or weight.shape[2] % mo):
        raise ValueError(f"C={C} must be a multiple of {chunk} and "
                         f"cout={weight.shape[2]} of {mo}")
    for name, t in (("flat", flat), ("idx", idx), ("w", w),
                    ("weight", weight)):
        if t.device != flat.device:
            raise ValueError(f"{name} on {t.device}, flat on {flat.device}")
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def gathered_rows(flat: torch.Tensor, idx: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """V (K, px, C) f32: the weighted corner rows of every tap."""
    f = flat.float()
    vals = f[idx[0].long()] * w[0].unsqueeze(-1)
    for c in range(1, idx.shape[0]):
        vals = vals + f[idx[c].long()] * w[c].unsqueeze(-1)
    return vals


def scatter_rows_ref(flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                     G: torch.Tensor, need_flat: bool, need_w: bool
                     ) -> Tuple[Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """(d_flat, d_w) from G (K, px, C) f32, the gradient of the gathered
    rows: the plain scatter-add and row dot products of both bwd-data
    functions."""
    d_flat = d_w = None
    if need_flat:
        acc = torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
        for c in range(idx.shape[0]):
            acc.index_add_(0, idx[c].reshape(-1).long(),
                           (w[c].unsqueeze(-1) * G).reshape(-1, G.shape[-1]))
        d_flat = acc.to(flat.dtype)
    if need_w:
        f = flat.float()
        d_w = torch.stack([(f[idx[c].long()] * G).sum(-1)
                           for c in range(idx.shape[0])])
    return d_flat, d_w


def deform_gather_contract_bwd_data_ref(flat, idx, w, weight, dout,
                                        need_flat=True, need_w=True):
    """Plain PyTorch version of the backward w.r.t. (flat, w)."""
    G = torch.einsum("po,kco->kpc", dout.float(), weight.float())
    return scatter_rows_ref(flat, idx, w, G, need_flat, need_w)


def deform_gather_contract_bwd_weight_ref(flat, idx, w, dout):
    """Plain PyTorch version of the backward w.r.t. weight: (K, C, cout)
    in flat's dtype."""
    d_weight = torch.einsum("kpc,po->kco", gathered_rows(flat, idx, w),
                            dout.float())
    return d_weight.to(flat.dtype)


def deform_gather_contract_bwd_ref(flat, idx, w, weight, dout):
    """(d_flat, d_w, d_weight) of the plain versions."""
    d_flat, d_w = deform_gather_contract_bwd_data_ref(flat, idx, w, weight,
                                                      dout)
    return d_flat, d_w, deform_gather_contract_bwd_weight_ref(flat, idx, w,
                                                              dout)


def check_dout(dout: torch.Tensor, flat: torch.Tensor, px: int,
               cout: int) -> torch.Tensor:
    """dout as the backward kernels take it: (px, cout) in flat's dtype on
    flat's device, contiguous, 16-byte aligned (copied if it is not)."""
    if tuple(dout.shape) != (px, cout) or dout.dtype != flat.dtype \
            or dout.device != flat.device:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device}: want ({px}, {cout}) {flat.dtype} "
                         f"on {flat.device}")
    dout = dout.contiguous()
    return dout.clone() if dout.data_ptr() % _ALIGN else dout


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def px_splits(sms: int, tiles: int, px: int) -> int:
    """How many shares of the 64-px tiles a bwd-weight launch of 64 x 64
    output tiles (``tiles`` of them over all taps) takes to put about four
    blocks on every one of ``sms`` SMs: the grouped kernel and the f32
    route of K1."""
    return max(1, min(-(-px // 64), -(-4 * sms // tiles)))


@functools.lru_cache(maxsize=256)
def wave_px_splits(sms: int, tiles: int, px: int, per_sm: int = 1,
                   taps: int = 1) -> int:
    """nsplit of a bwd-weight kernel that runs ``per_sm`` blocks an SM, of
    ``tiles`` blocks x nsplit, each block ``taps`` steps per 64-px tile of
    its share: the bf16 K1 kernel (one block an SM; a tile is a (tap,
    128-channel, 256-cout) block) and the bf16 grouped kernel ``gdw_bf16``
    (two blocks an SM; a tile is a (cout tile, group of taps) block). The
    split with the fewest step times per block slot, waves x (steps per
    share + 2), the 2 for a block's start and its atomic epilogue; the
    smallest such split. Splits up to 8 waves are tried."""
    ntile = -(-px // 64)
    slots = per_sm * sms
    best, best_cost = 1, None
    for ns in range(1, min(ntile, 8 * -(-slots // tiles)) + 1):
        per = -(-ntile // ns)
        used = -(-ntile // per)              # shares that own a tile
        cost = -(-tiles * used // slots) * (per * taps + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = ns, cost
    return best


def launch(name: str, entry: str, flat: torch.Tensor, *args) -> None:
    """Call C entry ``entry`` of ``csrc/<name>.cu`` on flat's device and
    current stream (the stream is appended to ``args``); raise on a launch
    error."""
    lib = _build.load(name)
    with torch.cuda.device(flat.device):
        rc = getattr(lib, entry)(
            *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _forward(flat, idx, w, weight):
    if flat.device.type == "cpu":
        return deform_gather_contract_ref(flat, idx, w, weight)
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    _check(flat, idx, w, weight, channels=False)
    cout = weight.shape[2]
    flat, weight = pad_channels(flat, weight)
    nc, K, px = idx.shape
    C, cpad = flat.shape[1], weight.shape[2]
    out = torch.empty((px, cpad), dtype=flat.dtype, device=flat.device)
    if px == 0:
        return out[:, :cout]
    launch("deform_gather_contract", "lsnet_deform_gather_contract", flat,
           flat.data_ptr(), idx.data_ptr(), w.data_ptr(), weight.data_ptr(),
           out.data_ptr(), C, nc, K, px, cpad,
           int(flat.dtype == torch.bfloat16))
    deform_gather_contract.launches += 1
    return out if cpad == cout else out[:, :cout].contiguous()


def deform_gather_contract_bwd_data(flat, idx, w, weight, dout,
                                    need_flat=True, need_w=True):
    """(d_flat (R, C) in flat's dtype, d_w (nc, K, px) f32), None where
    not needed; the kernel on CUDA, the plain version on the CPU."""
    if flat.device.type == "cpu":
        return deform_gather_contract_bwd_data_ref(flat, idx, w, weight,
                                                   dout, need_flat, need_w)
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    _check(flat, idx, w, weight, channels=False)
    nc, K, px = idx.shape
    C = flat.shape[1]
    dout = check_dout(dout, flat, px, weight.shape[2])
    flat, weight = pad_channels(flat, weight)
    cpad = weight.shape[2]
    dout = pad_dout(dout, cpad)
    d_flat = (torch.zeros(flat.shape, dtype=torch.float32,
                          device=flat.device) if need_flat else None)
    d_w = torch.zeros_like(w) if need_w else None
    if px and (need_flat or need_w):
        launch("deform_gather_contract_bwd_data",
               "lsnet_deform_gather_contract_bwd_data", flat,
               flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
               weight.data_ptr(), dout.data_ptr(),
               d_flat.data_ptr() if need_flat else None,
               d_w.data_ptr() if need_w else None, flat.shape[1], nc, K,
               px, cpad, int(flat.dtype == torch.bfloat16))
        deform_gather_contract_bwd_data.launches += 1
    return (d_flat[:, :C].to(flat.dtype) if need_flat else None), d_w


def deform_gather_contract_bwd_weight(flat, idx, w, weight, dout):
    """d_weight (K, C, cout) in flat's dtype (``weight`` gives the shape;
    its values are not read); the kernel on CUDA, the plain version on the
    CPU."""
    if flat.device.type == "cpu":
        return deform_gather_contract_bwd_weight_ref(flat, idx, w, dout)
    if flat.device.type != "cuda":
        raise ValueError(f"no kernel for device {flat.device}")
    _check(flat, idx, w, weight, channels=False)
    C0, cout0 = flat.shape[1], weight.shape[2]
    nc, K, px = idx.shape
    dout = check_dout(dout, flat, px, cout0)
    flat, weight = pad_channels(flat, weight)
    C, cout = flat.shape[1], weight.shape[2]
    dout = pad_dout(dout, cout)
    d_weight = torch.zeros((K, C, cout), dtype=torch.float32,
                           device=flat.device)
    if px:
        bf16 = flat.dtype == torch.bfloat16
        if bf16:      # blocks of 128 channels x 256 cout, one per SM
            nsplit = wave_px_splits(sm_count(flat.device),
                                    -(-C // 128) * -(-cout // 256) * K, px)
        else:         # 64 x 64 tiles, four blocks per SM
            nsplit = px_splits(sm_count(flat.device),
                               -(-C // 64) * -(-cout // 64) * K, px)
        launch("deform_gather_contract_bwd_weight",
               "lsnet_deform_gather_contract_bwd_weight", flat,
               flat.data_ptr(), idx.data_ptr(), w.data_ptr(),
               dout.data_ptr(), d_weight.data_ptr(), C, nc, K, px, cout,
               nsplit, int(bf16))
        deform_gather_contract_bwd_weight.launches += 1
    return d_weight[:, :C0, :cout0].to(flat.dtype)


class ContractOps(NamedTuple):
    """The three functions of one fused contraction, each dispatching by
    device: forward(flat, idx, w, weight), bwd_data(flat, idx, w, weight,
    dout, need_flat, need_w), bwd_weight(flat, idx, w, weight, dout)."""
    forward: Callable
    bwd_data: Callable
    bwd_weight: Callable


class GatherContract(torch.autograd.Function):
    """out = ops.forward(flat, idx, w, weight), differentiable in flat, w
    and weight through ops.bwd_data / ops.bwd_weight.

    With a straight-through table (``ste_idx``, ``ste_w``) the value and
    the gradients of flat, w and weight are still those of (idx, w), and
    ``ste_w`` receives the d_w of its own table: the gradient the output
    would send to those corner weights if it had been sampled with them."""

    @staticmethod
    def forward(ctx, ops, flat, idx, w, weight, ste_idx, ste_w):
        ctx.ops = ops
        ctx.save_for_backward(flat, idx, w, weight, ste_idx, ste_w)
        return ops.forward(flat, idx, w, weight)

    @staticmethod
    def backward(ctx, dout):
        flat, idx, w, weight, ste_idx, ste_w = ctx.saved_tensors
        ops = ctx.ops
        _, need_flat, _, need_w, need_weight, _, need_ste = \
            ctx.needs_input_grad
        d_flat = d_w = d_weight = d_ste = None
        if need_flat or need_w:
            d_flat, d_w = ops.bwd_data(flat, idx, w, weight, dout, need_flat,
                                       need_w)
        if need_ste:
            _, d_ste = ops.bwd_data(flat, ste_idx, ste_w, weight, dout,
                                    False, True)
        if need_weight:
            d_weight = ops.bwd_weight(flat, idx, w, weight, dout)
        return None, d_flat, None, d_w, d_weight, None, d_ste


_OPS = ContractOps(_forward, deform_gather_contract_bwd_data,
                   deform_gather_contract_bwd_weight)


def deform_gather_contract(flat: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor, weight: torch.Tensor,
                           ste: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                           ) -> torch.Tensor:
    """(px, cout) in flat's dtype; kernels on CUDA, plain versions on the
    CPU, differentiable on both. ``ste`` = (idx, w) of a second table
    whose ``w`` takes its gradient straight through (see
    :class:`GatherContract`)."""
    ste_idx, ste_w = ste if ste is not None else (None, None)
    cout = weight.shape[2]
    if flat.is_cuda:
        flat, weight = pad_channels(flat, weight)
    out = GatherContract.apply(_OPS, flat, idx, w, weight, ste_idx, ste_w)
    return out if out.shape[1] == cout else out[:, :cout].contiguous()


# launches of each CUDA kernel since its count was last set to 0
deform_gather_contract.launches = 0
deform_gather_contract_bwd_data.launches = 0
deform_gather_contract_bwd_weight.launches = 0
