"""Tests that need the card: the CUDA kernels against their plain versions.

They skip where there is no CUDA device. On a machine with the card run
``python -m pytest -m cuda tests/test_torch_cuda.py``; this file imports
neither JAX nor the JAX package, so it runs where they are not installed.
"""

import numpy as np
import pytest
import torch

from lsnet_torch.ops.deform_gather import (deform_gather_contract,
                                           deform_gather_contract_ref)
from lsnet_torch.ops.grouped import (deform_gather_grouped_contract,
                                     deform_gather_grouped_contract_ref,
                                     grouped_deform_contract)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the H100 only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,rel", [
    (torch.float32, 4, 1e-4), (torch.float32, 1, 1e-4),
    # bf16 inputs, weighted rows and output carry 8 bits of mantissa
    (torch.bfloat16, 4, 2e-2), (torch.bfloat16, 1, 2e-2)])
def test_kernel_matches_plain_version(cuda_device, dtype, nc, rel):
    rng = np.random.RandomState(nc)
    K, R, px, C, cout = 9, 700, 333, 256, 136     # ragged px and cout tiles
    flat = torch.from_numpy(rng.randn(R, C).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, R, (nc, K, px)).astype(np.int32))
    w = torch.from_numpy(rng.rand(nc, K, px).astype(np.float32))
    wk = torch.from_numpy((rng.randn(K, C, cout) / 48).astype(np.float32))
    args = [flat.to(cuda_device, dtype), idx.to(cuda_device),
            w.to(cuda_device), wk.to(cuda_device, dtype)]
    before = deform_gather_contract.launches
    got = deform_gather_contract(*args).float()
    want = deform_gather_contract_ref(*args).float()
    torch.cuda.synchronize()
    assert deform_gather_contract.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda_device):
    flat = torch.zeros(10, 20, device=cuda_device)           # C % 16 != 0
    idx = torch.zeros(4, 9, 5, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(4, 9, 5, device=cuda_device)
    with pytest.raises(ValueError):
        deform_gather_contract(flat, idx, w,
                               torch.zeros(9, 20, 8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,rel", [
    (torch.float32, 4, 1e-4), (torch.float32, 1, 1e-4),
    (torch.bfloat16, 4, 2e-2), (torch.bfloat16, 1, 2e-2)])
@pytest.mark.parametrize("G,Cg", [(64, 8), (32, 16), (16, 32)])
def test_grouped_kernel_matches_plain_version(cuda_device, dtype, nc, rel, G,
                                              Cg):
    """Cg = outG = 8, 16, 32: the X-101 c3, c4 and c5 group widths, with a
    ragged pixel tile."""
    rng = np.random.RandomState(nc + G)
    K, R, px = 9, 700, 333
    C = cout = G * Cg
    flat = torch.from_numpy(rng.randn(R, C).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, R, (nc, K, px)).astype(np.int32))
    w = torch.from_numpy(rng.rand(nc, K, px).astype(np.float32))
    wk = torch.from_numpy((rng.randn(K, Cg, cout) / 12).astype(np.float32))
    args = [flat.to(cuda_device, dtype), idx.to(cuda_device),
            w.to(cuda_device), wk.to(cuda_device, dtype)]
    before = deform_gather_grouped_contract.launches
    got = deform_gather_grouped_contract(*args, G).float()
    want = deform_gather_grouped_contract_ref(*args, G).float()
    torch.cuda.synchronize()
    assert deform_gather_grouped_contract.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_grouped_identity_table_matches_einsum(cuda_device):
    rng = np.random.RandomState(0)
    px, K, G, Cg = 200, 9, 64, 16
    vals = torch.from_numpy(rng.randn(px, K * G * Cg).astype(np.float32))
    wk = torch.from_numpy((0.05 * rng.randn(K, Cg, G * Cg)).astype(
        np.float32))
    got = grouped_deform_contract(vals.to(cuda_device), wk.to(cuda_device),
                                  K, G).cpu()
    want = torch.einsum("pkgc,kcgj->pgj", vals.view(px, K, G, Cg).double(),
                        wk.view(K, Cg, G, Cg).double()).reshape(px, -1)
    assert (got.double() - want).abs().max().item() <= 1e-4 * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
def test_grouped_wrapper_rejects_bad_input(cuda_device):
    flat = torch.zeros(10, 256, device=cuda_device)
    idx = torch.zeros(1, 9, 5, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(1, 9, 5, device=cuda_device)
    with pytest.raises(ValueError):                 # outG = 128 > 64
        deform_gather_grouped_contract(
            flat, idx, w, torch.zeros(9, 128, 256, device=cuda_device), 2)
