"""The four primitive probes of the fused gather kernel, as kernels.

Each asks one question of the machine's toolchain, the ones the fused
gather + contraction is built from (counterparts of
``lsnet_tpu/ops/pallas_dma_gather.py`` ``probe`` and ``tools/probe_dma2.py``
``probe_a`` / ``probe_b`` / ``probe_c``):

* :func:`probe_row_copy`: an engine-driven asynchronous copy of one row
  from device memory to shared memory (``cp.async.bulk`` completing on an
  ``mbarrier``), a wait, and the row written back by the same engine;
* :func:`probe_block_gather`: the same for whole 8-row blocks selected by
  an index the kernel reads from device memory (a persistent ring of
  bulk copies, the indices read a chunk ahead);
* :func:`probe_subrow_sum`: the f32 sum over the sub-row views
  ``x[:, j, :]`` of a (P, 8, 128) bf16 tile resident in shared memory
  (a persistent ring of whole tiles, each one bulk copy);
* :func:`probe_subrow_dot`: ``sum_j x[:, j, :] @ w[j]`` on the tensor cores
  straight from those views, f32 accumulation.

On CUDA tensors each function launches its hand-written kernel
(``csrc/probe_*.cu``) or raises; on CPU tensors it runs the plain version
``*_ref`` beside it. Nothing here catches a failed build or launch: only
``lsnet_torch.tools.probe`` turns a failure into a named line.
:func:`probe_inputs` makes the inputs the JAX probes make, with numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .deform_gather import launch

_ALIGN = 16
_MAX_COPY_BYTES = 16384          # the copy kernels' shared buffer
BLOCK_ROWS = 8                   # rows of one gathered block
SUBROWS, SUBROW = 8, 128         # the (P, 8, 128) tile of the sub-row probes
PROBES = ("probe_row_copy", "probe_block_gather", "probe_subrow_sum",
          "probe_subrow_dot")


def probe_inputs(name: str) -> Tuple[torch.Tensor, ...]:
    """The inputs of the JAX probe that ``name`` replaces, on the CPU:
    ``arange`` reshaped and cast for the two copies and the sum,
    ``RandomState(0)`` normals for the dot."""
    if name == "probe_row_copy":
        x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
        return (torch.from_numpy(x),)
    if name == "probe_block_gather":
        x = np.arange(32 * 8 * 128, dtype=np.float32).reshape(32 * 8, 128)
        return (torch.from_numpy(x).to(torch.bfloat16),
                torch.from_numpy(np.asarray([5], np.int32)))
    if name == "probe_subrow_sum":
        x = np.arange(16 * SUBROWS * SUBROW, dtype=np.float32)
        return (torch.from_numpy(x.reshape(16, SUBROWS, SUBROW)).to(
            torch.bfloat16),)
    if name == "probe_subrow_dot":
        rng = np.random.RandomState(0)
        x = rng.randn(16, SUBROWS, SUBROW)
        w = rng.randn(SUBROWS, SUBROW, 128) / 16
        return (torch.from_numpy(x).to(torch.bfloat16),
                torch.from_numpy(w).to(torch.bfloat16))
    raise ValueError(f"unknown probe {name!r}: want one of {PROBES}")


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    one; any other device has no kernel."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def _check_buffers(**tensors: torch.Tensor) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device}, expected {first.device}")
        if not t.is_contiguous() or t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_copy_bytes(what: str, nbytes: int) -> None:
    if nbytes % _ALIGN or not _ALIGN <= nbytes <= _MAX_COPY_BYTES:
        raise ValueError(f"{what} of {nbytes} bytes: want a multiple of "
                         f"{_ALIGN} in [{_ALIGN}, {_MAX_COPY_BYTES}]")


# ---------------------------------------------------------------- row copy
def probe_row_copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: row 0 of x (rows, cols) as (1, cols)."""
    return x[:1].clone()


def probe_row_copy(x: torch.Tensor) -> torch.Tensor:
    """(1, cols): row 0 of x (rows, cols), through shared memory by one
    bulk asynchronous copy."""
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x {tuple(x.shape)}: want (rows >= 1, cols)")
    if not _on_card(x):
        return probe_row_copy_ref(x)
    _check_buffers(x=x)
    row_bytes = x.shape[1] * x.element_size()
    _check_copy_bytes("a row", row_bytes)
    out = torch.empty((1, x.shape[1]), dtype=x.dtype, device=x.device)
    launch("probe_row_copy", "lsnet_probe_row_copy", x, x.data_ptr(),
           out.data_ptr(), row_bytes)
    probe_row_copy.launches += 1
    return out


# ------------------------------------------------------------ block gather
def _check_block_gather(x: torch.Tensor, idx: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[0] % BLOCK_ROWS or x.shape[0] < BLOCK_ROWS:
        raise ValueError(f"x {tuple(x.shape)}: want (nblocks * {BLOCK_ROWS}, "
                         "cols)")
    if idx.dim() != 1 or idx.dtype != torch.int32 or idx.numel() < 1:
        raise TypeError(f"idx {tuple(idx.shape)} {idx.dtype}: want (n >= 1,) "
                        "int32")
    return x.shape[0] // BLOCK_ROWS


def probe_block_gather_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the 8-row blocks x[i*8 : i*8+8] for i in idx
    (clamped to the blocks x has), stacked: (n * 8, cols)."""
    nblocks = _check_block_gather(x, idx)
    blocks = x.reshape(nblocks, BLOCK_ROWS, x.shape[1])
    return blocks[idx.long().clamp(0, nblocks - 1)].reshape(-1, x.shape[1])


def probe_block_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n * 8, cols): for each i of idx (n,) int32, read on the device, the
    block x[i*8 : i*8+8], copied asynchronously through shared memory."""
    nblocks = _check_block_gather(x, idx)
    if not _on_card(x):
        return probe_block_gather_ref(x, idx)
    _check_buffers(x=x, idx=idx)
    block_bytes = BLOCK_ROWS * x.shape[1] * x.element_size()
    _check_copy_bytes("a block", block_bytes)
    n = idx.numel()
    out = torch.empty((n * BLOCK_ROWS, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    launch("probe_block_gather", "lsnet_probe_block_gather", x, x.data_ptr(),
           idx.data_ptr(), out.data_ptr(), n, nblocks, block_bytes)
    probe_block_gather.launches += 1
    return out


# ------------------------------------------------------- sub-row sum / dot
def _check_tile(x: torch.Tensor) -> None:
    if x.dim() != 3 or tuple(x.shape[1:]) != (SUBROWS, SUBROW) \
            or x.shape[0] < 1:
        raise ValueError(f"x {tuple(x.shape)}: want (P >= 1, {SUBROWS}, "
                         f"{SUBROW})")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x dtype {x.dtype}: want bfloat16")


def probe_subrow_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the f32 sum over the middle axis."""
    return x.float().sum(dim=1)


def probe_subrow_sum(x: torch.Tensor) -> torch.Tensor:
    """(P, 128) f32: sum_j x[:, j, :] of x (P, 8, 128) bf16, read as
    sub-row views of a tile in shared memory."""
    _check_tile(x)
    if not _on_card(x):
        return probe_subrow_sum_ref(x)
    _check_buffers(x=x)
    out = torch.empty((x.shape[0], SUBROW), dtype=torch.float32,
                      device=x.device)
    launch("probe_subrow_sum", "lsnet_probe_subrow_sum", x, x.data_ptr(),
           out.data_ptr(), x.shape[0])
    probe_subrow_sum.launches += 1
    return out


def _check_dot(x: torch.Tensor, w: torch.Tensor) -> None:
    _check_tile(x)
    if tuple(w.shape) != (SUBROWS, SUBROW, 128) or w.dtype != torch.bfloat16:
        raise ValueError(f"w {tuple(w.shape)} {w.dtype}: want ({SUBROWS}, "
                         f"{SUBROW}, 128) bfloat16")


def probe_subrow_dot_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: sum_j x[:, j, :] @ w[j] in f32."""
    return torch.einsum("pjc,jcn->pn", x.float(), w.float())


def probe_subrow_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(P, 128) f32: sum_j x[:, j, :] @ w[j] for x (P, 8, 128) and w
    (8, 128, 128), bf16, on the tensor cores from the sub-row views."""
    _check_dot(x, w)
    if not _on_card(x):
        return probe_subrow_dot_ref(x, w)
    _check_buffers(x=x, w=w)
    out = torch.empty((x.shape[0], 128), dtype=torch.float32, device=x.device)
    launch("probe_subrow_dot", "lsnet_probe_subrow_dot", x, x.data_ptr(),
           w.data_ptr(), out.data_ptr(), x.shape[0])
    probe_subrow_dot.launches += 1
    return out


# launches of each CUDA kernel since its count was last set to 0
probe_row_copy.launches = 0
probe_block_gather.launches = 0
probe_subrow_sum.launches = 0
probe_subrow_dot.launches = 0
