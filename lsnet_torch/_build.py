"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library ``build/lsnet_torch/lib<name>.so`` (beside the package, at the
repository root) the first time it is needed, and again whenever the
source, or any shared header ``csrc/*.cuh``, is newer than the library.
The sources expose plain C entry
points: pointers and the stream are passed as ``c_void_p``, and each entry
returns ``cudaGetLastError()`` after its launch.

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` (the CPU tests), where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "lsnet_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# argtypes of each source's C entry points
SIGNATURES = {
    "deform_gather_contract": {
        "lsnet_deform_gather_contract":
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    },
    "grouped_deform_contract": {
        "lsnet_grouped_deform_contract":
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    },
    # flat, idx, w, W, dout, d_flat, d_w | C, nc, K, px, cout, is_bf16
    "deform_gather_contract_bwd_data": {
        "lsnet_deform_gather_contract_bwd_data":
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    },
    # flat, idx, w, dout, d_W | C, nc, K, px, cout, nsplit, is_bf16
    "deform_gather_contract_bwd_weight": {
        "lsnet_deform_gather_contract_bwd_weight":
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    },
    # ... | C, Cg, outG, nc, K, px, cout, is_bf16
    "grouped_deform_contract_bwd_data": {
        "lsnet_grouped_deform_contract_bwd_data":
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    },
    # ... | C, Cg, outG, nc, K, px, cout, nsplit, is_bf16
    "grouped_deform_contract_bwd_weight": {
        "lsnet_grouped_deform_contract_bwd_weight":
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    },
    # x, out | row_bytes
    "probe_row_copy": {
        "lsnet_probe_row_copy":
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p],
    },
    # x, idx, out | n, nblocks, block_bytes
    "probe_block_gather": {
        "lsnet_probe_block_gather":
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    },
    # x, out | P
    "probe_subrow_sum": {
        "lsnet_probe_subrow_sum":
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p],
    },
    # x, w, out | P
    "probe_subrow_dot": {
        "lsnet_probe_subrow_dot":
            [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of lsnet_torch "
                           "build only where the CUDA toolkit is installed")
    return found


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or any
    shared header (a stale header would load an old kernel)."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    srcs = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs)


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile the given sources, one ``nvcc`` each, all started together.

    Returns each source's compiler output (register and shared-memory use
    from ``-Xptxas -v``). Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        if not _stale(name):
            continue
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs: Dict[str, str] = {}
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib
