"""Rate of the fused gather kernel on the card, beside the library route
and the copy-only rate.

    python3 -m lsnet_torch.tools.bench_gather [--px 16384] [--rows 32768]
        [--C 256] [--cout 256] [--K 9] [--iters 20]

Counterpart of ``tools/bench_dma_gather.py``. At the flagship shape (C=256
bf16 rows, cout=256, K=9 taps, 4 corners) it times, with CUDA events:

* ``kernel``: ``deform_gather_contract`` (gather + corner weighting +
  contraction in one hand-written kernel);
* ``library``: the same function through PyTorch calls (index the rows,
  weight the corners, ``torch.einsum``), which writes the gathered patch
  tensor to device memory;
* ``copy``: ``probe_block_gather`` at ``n = K * px`` random 2,048-byte
  blocks (one logical row of 4 corners x 256 channels), the rate of the
  row fetch alone.

Parity of kernel and library first, then ms per call and gathered GB/s for
each, the card's name and power limit, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ops.deform_gather import deform_gather_contract
from ..ops.probes import BLOCK_ROWS, probe_block_gather

NC = 4                            # bilinear corners


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean device time of fn() over iters calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_gather_contract(flat: torch.Tensor, idx: torch.Tensor,
                            w: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """The function of ``deform_gather_contract`` through PyTorch calls in
    the working type: gather, weight the corners, one einsum."""
    rows = flat[idx.long()] * w.unsqueeze(-1).to(flat.dtype)
    return torch.einsum("kpc,kco->po", rows.sum(dim=0), weight)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit unknown"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--px", type=int, default=16384)
    ap.add_argument("--rows", type=int, default=32768)
    ap.add_argument("--C", type=int, default=256)
    ap.add_argument("--cout", type=int, default=256)
    ap.add_argument("--K", type=int, default=9)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_gather: no CUDA device (rates are the card's only)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    flat = torch.from_numpy(rng.randn(args.rows, args.C).astype(np.float32)
                            ).to(dev, torch.bfloat16)
    idx = torch.from_numpy(rng.randint(
        0, args.rows, (NC, args.K, args.px)).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.rand(NC, args.K, args.px).astype(np.float32)
                         ).to(dev)
    weight = torch.from_numpy(
        (rng.randn(args.K, args.C, args.cout) / np.sqrt(NC * args.C)
         ).astype(np.float32)).to(dev, torch.bfloat16)
    card = card_line()
    print(f"device: {card}", flush=True)
    print(f"shape: rows={args.rows} C={args.C} corners={NC} K={args.K} "
          f"px={args.px} cout={args.cout} bf16", flush=True)

    def kernel():
        return deform_gather_contract(flat, idx, w, weight)

    def library():
        return library_gather_contract(flat, idx, w, weight)

    a, b = kernel().float(), library().float()
    torch.cuda.synchronize()
    err = ((a - b).abs().max() / (b.abs().max() + 1e-6)).item()
    print(f"parity: max rel err {err:.2e}", flush=True)

    gathered = NC * args.K * args.px * args.C * flat.element_size()
    results = {}
    for name, fn in (("library", library), ("kernel", kernel)):
        ms = cuda_ms(fn, args.iters)
        results[name] = dict(ms=ms, GBps=gathered / ms / 1e6)
        print(f"{name}: {ms:8.3f} ms   {results[name]['GBps']:7.1f} GB/s "
              f"gathered", flush=True)

    # copy only: one 8-row block of 128 bf16 per logical row (the same
    # bytes as NC corner rows of C channels at C = 256)
    block_cols = NC * args.C // BLOCK_ROWS
    table = torch.from_numpy(rng.randn(
        args.rows * BLOCK_ROWS, block_cols).astype(np.float32)
    ).to(dev, torch.bfloat16)
    rows_idx = torch.from_numpy(rng.randint(
        0, args.rows, args.K * args.px).astype(np.int32)).to(dev)
    ms = cuda_ms(lambda: probe_block_gather(table, rows_idx), args.iters)
    copied = rows_idx.numel() * BLOCK_ROWS * block_cols * table.element_size()
    results["copy"] = dict(ms=ms, GBps=copied / ms / 1e6, n=rows_idx.numel())
    print(f"copy: {ms:8.3f} ms   {results['copy']['GBps']:7.1f} GB/s "
          f"gathered ({rows_idx.numel()} blocks of "
          f"{copied // rows_idx.numel()} bytes)", flush=True)

    ratio = results["library"]["ms"] / results["kernel"]["ms"]
    print(f"kernel speedup over library: {ratio:.2f}x", flush=True)
    print(json.dumps({"card": card, "px": args.px, "rows": args.rows,
                      "C": args.C, "corners": NC, "K": args.K,
                      "cout": args.cout, "parity_relerr": err, **results,
                      "speedup": ratio}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
