"""Tests that need the card: the CUDA kernels against their plain versions.

They skip where there is no CUDA device. On a machine with the card run
``python -m pytest -m cuda tests/test_torch_cuda.py``; this file imports
neither JAX nor the JAX package, so it runs where they are not installed.
"""

import numpy as np
import pytest
import torch

from lsnet_torch.ops import deform_gather as dg
from lsnet_torch.ops import grouped as gr
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


def _bwd_inputs(rng, dev, dtype, nc, C, Cg, cout, px, R=700, K=9):
    """(flat, idx, w, weight (K, Cg, cout), dout); two pixels share every
    corner row so that the scatter has collisions, and a few corners weigh
    exactly 0 as clipped ones do."""
    flat = torch.from_numpy(rng.randn(R, C).astype(np.float32))
    idx = rng.randint(0, R, (nc, K, px)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]
    w = rng.rand(nc, K, px).astype(np.float32)
    w[rng.rand(nc, K, px) < 0.1] = 0.0
    wk = torch.from_numpy((rng.randn(K, Cg, cout) / 12).astype(np.float32))
    dout = torch.from_numpy(rng.randn(px, cout).astype(np.float32))
    return (flat.to(dev, dtype), torch.from_numpy(idx).to(dev),
            torch.from_numpy(w).to(dev), wk.to(dev, dtype),
            dout.to(dev, dtype))


def _close(got, want, rel):
    """Relative to max(1, max|want|); the kernels' f32 atomics sum in an
    order that changes from run to run, and the bf16 route rounds the
    weighted rows to 8 bits of mantissa."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,rel", [
    (torch.float32, 4, 1e-4), (torch.float32, 1, 1e-4),
    (torch.bfloat16, 4, 2e-2), (torch.bfloat16, 1, 2e-2)])
def test_backward_kernels_match_plain_versions(cuda_device, dtype, nc, rel):
    """K1's two backward kernels, ragged px, channel and cout tiles."""
    rng = np.random.RandomState(10 + nc)
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, dtype, nc, 224,
                                         224, 136, 333)
    n_data = dg.deform_gather_contract_bwd_data.launches
    n_weight = dg.deform_gather_contract_bwd_weight.launches
    d_flat, d_w = dg.deform_gather_contract_bwd_data(flat, idx, w, wk, dout)
    d_weight = dg.deform_gather_contract_bwd_weight(flat, idx, w, wk, dout)
    torch.cuda.synchronize()
    assert dg.deform_gather_contract_bwd_data.launches == n_data + 1
    assert dg.deform_gather_contract_bwd_weight.launches == n_weight + 1
    want = dg.deform_gather_contract_bwd_ref(flat, idx, w, wk, dout)
    for got, ref in zip((d_flat, d_w, d_weight), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, ref, rel)
    # one output at a time: the other is skipped, the result the same
    only_flat, none = dg.deform_gather_contract_bwd_data(
        flat, idx, w, wk, dout, True, False)
    none2, only_w = dg.deform_gather_contract_bwd_data(
        flat, idx, w, wk, dout, False, True)
    assert none is None and none2 is None
    _close(only_flat, want[0], rel)
    _close(only_w, want[1], rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,rel", [
    (torch.float32, 4, 1e-4), (torch.float32, 1, 1e-4),
    (torch.bfloat16, 4, 2e-2), (torch.bfloat16, 1, 2e-2)])
@pytest.mark.parametrize("G,Cg", [(64, 8), (32, 16), (16, 32)])
def test_grouped_backward_kernels_match_plain_versions(cuda_device, dtype, nc,
                                                       rel, G, Cg):
    rng = np.random.RandomState(20 + nc + G)
    C = G * Cg
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, dtype, nc, C, Cg,
                                         C, 333)
    n_data = gr.deform_gather_grouped_contract_bwd_data.launches
    n_weight = gr.deform_gather_grouped_contract_bwd_weight.launches
    d_flat, d_w = gr.deform_gather_grouped_contract_bwd_data(
        flat, idx, w, wk, dout, G)
    d_weight = gr.deform_gather_grouped_contract_bwd_weight(flat, idx, w,
                                                            wk, dout, G)
    torch.cuda.synchronize()
    assert gr.deform_gather_grouped_contract_bwd_data.launches == n_data + 1
    assert gr.deform_gather_grouped_contract_bwd_weight.launches == \
        n_weight + 1
    want = gr.deform_gather_grouped_contract_bwd_ref(flat, idx, w, wk, dout,
                                                     G)
    for got, ref in zip((d_flat, d_w, d_weight), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, ref, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 8])
def test_functions_differentiate_on_the_card(cuda_device, groups):
    """gradcheck-style: autograd through the Functions on the card (the
    kernels) against autograd of the plain forward on the CPU in f64, tiny
    f32 shape; and the result carries a grad_fn."""
    rng = np.random.RandomState(groups)
    C, px = 64, 70
    flat, idx, w, wk, dout = _bwd_inputs(
        rng, torch.device("cpu"), torch.float32, 4, C, C // groups, C, px,
        R=90)
    leaves = [t.clone().to(cuda_device).requires_grad_()
              for t in (flat, w, wk)]
    if groups == 1:
        out = deform_gather_contract(leaves[0], idx.to(cuda_device),
                                     leaves[1], leaves[2])
    else:
        out = deform_gather_grouped_contract(
            leaves[0], idx.to(cuda_device), leaves[1], leaves[2], groups)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, dout.to(cuda_device))
    ref_leaves = [t.double().requires_grad_() for t in (flat, w, wk)]
    vals = sum(ref_leaves[0][idx[c].long()] * ref_leaves[1][c].unsqueeze(-1)
               for c in range(4))
    K = idx.shape[1]
    Cg = C // groups
    ref = torch.einsum("kpgc,kcgj->pgj", vals.view(K, px, groups, Cg),
                       ref_leaves[2].view(K, Cg, groups, C // groups))
    want = torch.autograd.grad(ref.reshape(px, C), ref_leaves, dout.double())
    for g_, r_ in zip(got, want):
        _close(g_.cpu(), r_, 1e-4)


@pytest.mark.cuda
def test_straight_through_table_on_the_card(cuda_device):
    """The ste table takes its own d_w; value and the other gradients
    follow the sampled table."""
    rng = np.random.RandomState(3)
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, torch.float32, 1,
                                         64, 64, 64, 100, R=90)
    _, idx4, w4, _, _ = _bwd_inputs(rng, cuda_device, torch.float32, 4, 64,
                                    64, 64, 100, R=90)
    w4.requires_grad_()
    flat.requires_grad_()
    out = deform_gather_contract(flat, idx, w, wk, (idx4, w4))
    _close(out, deform_gather_contract_ref(flat, idx, w, wk), 1e-4)
    d_flat, d_w4 = torch.autograd.grad(out, (flat, w4), dout)
    want_flat, _ = dg.deform_gather_contract_bwd_data_ref(
        flat.detach(), idx, w, wk, dout, True, False)
    _, want_w4 = dg.deform_gather_contract_bwd_data_ref(
        flat.detach(), idx4, w4.detach(), wk, dout, False, True)
    _close(d_flat, want_flat, 1e-4)
    _close(d_w4, want_w4, 1e-4)
