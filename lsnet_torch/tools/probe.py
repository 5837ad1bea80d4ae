"""Does this machine's toolchain give the fused gather kernel its
primitives?

    python3 -m lsnet_torch.tools.probe [--device cuda]

Counterpart of ``tools/probe_dma.py`` and ``tools/probe_dma2.py``. Builds
and runs the four probe kernels of :mod:`lsnet_torch.ops.probes` on the
JAX probes' own inputs and holds each against its plain PyTorch version at
the JAX probes' tolerances, one line each:

    probe_row_copy: OK | WRONG RESULT | FAIL (<error>) <message>

then the full fused kernel ``deform_gather_contract`` at rows=1000, C=256,
K=9, px=256, cout=256 in bf16 against ``deform_gather_contract_ref`` (max
abs error below 0.5, the JAX tool's limit). Exits 0 iff every line is OK.
With ``--device cpu`` the wrappers run their plain versions, which checks
the tool and not the toolchain.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import probes
from ..ops.deform_gather import (deform_gather_contract,
                                 deform_gather_contract_ref)

# (rtol, atol) of each probe against its plain version; None = exact
TOLERANCES: Dict[str, Optional[Tuple[float, float]]] = {
    "probe_row_copy": None,
    "probe_block_gather": None,
    "probe_subrow_sum": (1e-2, 1.0),
    "probe_subrow_dot": (5e-2, 0.5),
}
FULL_KERNEL_LIMIT = 0.5


def check_probe(name: str, device: torch.device) -> Tuple[bool, float]:
    """Run probe ``name`` on ``device`` -> (within tolerance, max abs
    error against the plain version on the same inputs)."""
    args = [a.to(device) for a in probes.probe_inputs(name)]
    got = getattr(probes, name)(*args)
    want = getattr(probes, name + "_ref")(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, float("inf")
    err = (got.double() - want.double()).abs().max().item()
    tol = TOLERANCES[name]
    if tol is None:
        return bool(torch.equal(got, want)), err
    return bool(torch.allclose(got, want, rtol=tol[0], atol=tol[1])), err


def full_kernel_inputs(device: torch.device) -> List[torch.Tensor]:
    """(flat, idx, w, weight) of the full-kernel check: 1,000 rows of 256
    bf16 channels, 4 corners x 9 taps x 256 pixels, a (9, 256, 256)
    weight, from ``RandomState(0)``."""
    rng = np.random.RandomState(0)
    rows, C, K, px, cout, nc = 1000, 256, 9, 256, 256, 4
    flat = torch.from_numpy(rng.randn(rows, C).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, rows, (nc, K, px)).astype(np.int32))
    w = torch.from_numpy(rng.rand(nc, K, px).astype(np.float32))
    weight = torch.from_numpy((rng.randn(K, C, cout) / 32).astype(np.float32))
    return [flat.to(device, torch.bfloat16), idx.to(device), w.to(device),
            weight.to(device, torch.bfloat16)]


def check_full_kernel(device: torch.device) -> Tuple[bool, float]:
    """The fused gather + contraction against its plain version."""
    args = full_kernel_inputs(device)
    got = deform_gather_contract(*args).float()
    want = deform_gather_contract_ref(*args).float()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = (got - want).abs().max().item()
    return bool(torch.isfinite(got).all()) and err < FULL_KERNEL_LIMIT, err


def run_checks(device: torch.device, emit: Callable[[str], None]) -> bool:
    """All five checks, one line each through ``emit``; True iff all pass.
    A check that raises is reported as FAIL and the others still run."""
    checks = [(name, lambda n=name: check_probe(n, device))
              for name in probes.PROBES]
    checks.append(("deform_gather_contract",
                   lambda: check_full_kernel(device)))
    all_ok = True
    for name, fn in checks:
        try:
            ok, err = fn()
        except Exception as ex:     # the tool's boundary: name the failure
            first = (str(ex).splitlines() or [""])[0][:160]
            emit(f"{name}: FAIL ({type(ex).__name__}) {first}")
            all_ok = False
            continue
        emit(f"{name}: {'OK' if ok else 'WRONG RESULT'} "
             f"(max abs err {err:.4g})")
        all_ok = all_ok and ok
    return all_ok


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("probe: no CUDA device; pass --device cpu to check the "
                  "tool on the plain versions", file=sys.stderr)
            return 1
        kind = torch.cuda.get_device_name(device)
    else:
        kind = "plain versions"
    print(f"device: {device} ({kind})", file=sys.stderr)
    return 0 if run_checks(device, print) else 1


if __name__ == "__main__":
    sys.exit(main())
