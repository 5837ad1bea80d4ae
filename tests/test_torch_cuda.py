"""Tests that need the card: the CUDA kernels against their plain versions.

They skip where there is no CUDA device. On a machine with the card run
``python -m pytest -m cuda tests/test_torch_cuda.py``; this file imports
neither JAX nor the JAX package, so it runs where they are not installed.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from lsnet_torch.ops import deform_gather as dg
from lsnet_torch.ops import grouped as gr
from lsnet_torch.ops import probes
from lsnet_torch.ops.deform_gather import (deform_gather_contract,
                                           deform_gather_contract_ref)
from lsnet_torch.ops.grouped import (deform_gather_grouped_contract,
                                     deform_gather_grouped_contract_ref,
                                     grouped_deform_contract)
from lsnet_torch.tools import probe as probe_tool


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
    """C % 16 != 0: all three wrappers pad it; a strided flat, or a dout
    of the wrong shape, raises."""
    flat = torch.zeros(10, 20, device=cuda_device)
    idx = torch.zeros(4, 9, 5, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(4, 9, 5, device=cuda_device)
    weight = torch.zeros(9, 20, 8, device=cuda_device)
    dout = torch.zeros(5, 8, device=cuda_device)
    d_flat, d_w = dg.deform_gather_contract_bwd_data(flat, idx, w, weight,
                                                     dout)
    assert d_flat.shape == (10, 20) and d_w.shape == (4, 9, 5)
    assert dg.deform_gather_contract_bwd_weight(
        flat, idx, w, weight, dout).shape == (9, 20, 8)
    strided = torch.zeros(10, 40, device=cuda_device)[:, :20]
    with pytest.raises(ValueError):
        deform_gather_contract(strided, idx, w, weight)
    with pytest.raises(ValueError):
        dg.deform_gather_contract_bwd_data(strided, idx, w, weight, dout)
    with pytest.raises(ValueError):
        dg.deform_gather_contract_bwd_weight(flat, idx, w, weight,
                                             dout[:, :4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("C", [52, 104, 208])
def test_kernel_pads_res2net_channels(cuda_device, dtype, rel, nc, C):
    """Res2Net's 3x3 widths (C = cout = 52, 104, 208): the forward pads
    C and cout to the kernel's multiples and agrees with the plain
    version on the unpadded operands."""
    rng = np.random.RandomState(C + nc)
    K, R, px = 9, 700, 333
    args = [torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(
                cuda_device, dtype),
            torch.from_numpy(rng.randint(0, R, (nc, K, px)).astype(
                np.int32)).to(cuda_device),
            torch.from_numpy(rng.rand(nc, K, px).astype(np.float32)).to(
                cuda_device),
            torch.from_numpy((rng.randn(K, C, C) / 48).astype(
                np.float32)).to(cuda_device, dtype)]
    got = deform_gather_contract(*args)
    want = deform_gather_contract_ref(*args).float()
    assert got.shape == (px, C) and got.is_contiguous()
    err = (got.float() - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,rel", [
    (torch.float32, 4, 1e-4), (torch.float32, 1, 1e-4),
    (torch.bfloat16, 4, 2e-2), (torch.bfloat16, 1, 2e-2)])
@pytest.mark.parametrize("G,Cg,cout,px,R", [
    (64, 8, 512, 333, 700), (32, 16, 512, 333, 700),
    (16, 32, 512, 333, 700),
    (32, 8, 512, 333, 700), (16, 32, 256, 333, 700),
    (64, 16, 1024, 37, 700), (64, 16, 1024, 2100, 8400)])
def test_grouped_kernel_matches_plain_version(cuda_device, dtype, nc, rel, G,
                                              Cg, cout, px, R):
    """Cg = outG = 8, 16, 32: the X-101 c3, c4 and c5 group widths, with a
    ragged pixel tile; channel slices of 32 (outG = 16, Cg = 8) and 128
    (two slices, outG = 16, Cg = 32) a cout tile; px below one tile; a
    table of stride-2 size (an input map of 4 px rows)."""
    rng = np.random.RandomState(nc + G)
    K = 9
    C = G * Cg
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
def test_grouped_kernel_refuses_oversized_table(cuda_device):
    """nc x K past a block's shared memory: the bf16 launch raises, and the
    next call runs."""
    flat = torch.zeros(10, 1024, device=cuda_device, dtype=torch.bfloat16)
    weight = torch.zeros(200, 16, 1024, device=cuda_device,
                         dtype=torch.bfloat16)
    idx = torch.zeros(4, 200, 5, device=cuda_device, dtype=torch.int32)
    w = torch.zeros(4, 200, 5, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        deform_gather_grouped_contract(flat, idx, w, weight, 64)
    got = deform_gather_grouped_contract(flat, idx[:, :9].contiguous(),
                                         w[:, :9].contiguous(),
                                         weight[:9].contiguous(), 64)
    torch.cuda.synchronize()
    assert got.shape == (5, 1024) and not got.float().abs().max().item()


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
    idx[:, :, 1:2] = idx[:, :, 0:1]
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
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("C,cout", [(262, 256), (52, 52), (104, 104),
                                    (208, 208)])
def test_backward_kernels_pad_channels(cuda_device, dtype, rel, nc, C,
                                       cout):
    """CPV's 262-channel refine and Res2Net's 3x3 widths: the backward
    wrappers pad C and cout to the kernels' multiples (288 / 272 and 256;
    64 / 64 and 56, ...) and agree with the plain versions on the
    unpadded operands; so does the autograd route, which pads once before
    the function and saves the padded operands."""
    rng = np.random.RandomState(C + nc)
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, dtype, nc, C, C,
                                         cout, 333)
    d_flat, d_w = dg.deform_gather_contract_bwd_data(flat, idx, w, wk, dout)
    d_weight = dg.deform_gather_contract_bwd_weight(flat, idx, w, wk, dout)
    want = dg.deform_gather_contract_bwd_ref(flat, idx, w, wk, dout)
    for got, ref in zip((d_flat, d_w, d_weight), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, ref, rel)

    def grads(f, wt, weight):
        leaves = [x.clone().requires_grad_() for x in (f, wt, weight)]
        out = deform_gather_contract(leaves[0], idx, leaves[1], leaves[2])
        (out.float() * dout.float()).sum().backward()
        return [x.grad for x in leaves]

    on_cpu = grads(*(x.cpu() for x in (flat, w, wk)))
    for got, ref in zip(grads(flat, w, wk), on_cpu):
        assert got.shape == ref.shape
        _close(got.cpu(), ref, rel)


@pytest.mark.cuda
def test_cpv_head_on_the_card_matches_the_cpu(cuda_device):
    """A narrow LSCPVHead (DCN towers, f32, bilinear): every output map
    on the card within 1e-4 of the CPU's, and its launches: 3 tower
    blocks (cls, bbox, shared) and the paired gather's 2 contractions."""
    from lsnet_torch.apis import random_weights_
    from lsnet_torch.models.heads.lscpv_head import LSCPVHead
    head = random_weights_(LSCPVHead(4, 32, 32, 32, stacked_convs=1,
                                     corner_dim=16, conv_module_type="dcn",
                                     norm_groups=8), 0).eval()
    gen = torch.Generator().manual_seed(0)
    feats = [torch.randn(2, 32, h, h, generator=gen) for h in (16, 8, 4, 2,
                                                               1)]
    with torch.no_grad():
        want = head(feats)
        before = deform_gather_contract.launches
        got = head.to(cuda_device)([f.to(cuda_device) for f in feats])
    assert deform_gather_contract.launches == before + 5
    for key, maps in want.items():
        for g, w_ in zip(got[key], maps):
            _close(g.cpu(), w_, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("C", [32, 96, 256])
@pytest.mark.parametrize("cout", [8, 72, 256, 264])
@pytest.mark.parametrize("px", [1, 63, 65, 44800])
def test_k1_bf16_kernels_at_ragged_shapes(cuda_device, px, cout, C, nc):
    """The bf16 routes of K1 forward and bwd-weight (wgmma, 128-px and
    (tap, 128-channel) blocks of 256 cout): a lone pixel, ragged px, cout
    below, at and past one 256-wide tile, channels that end half way into
    a 64-deep chunk; one launch each, 2e-2 of max(1, max|ref|)."""
    rng = np.random.RandomState(px + cout + C + nc)
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, torch.bfloat16,
                                         nc, C, C, cout, px)
    n_fwd = deform_gather_contract.launches
    n_weight = dg.deform_gather_contract_bwd_weight.launches
    out = deform_gather_contract(flat, idx, w, wk)
    d_weight = dg.deform_gather_contract_bwd_weight(flat, idx, w, wk, dout)
    torch.cuda.synchronize()
    assert deform_gather_contract.launches == n_fwd + 1
    assert dg.deform_gather_contract_bwd_weight.launches == n_weight + 1
    _close(out, deform_gather_contract_ref(flat, idx, w, wk), 2e-2)
    want = dg.deform_gather_contract_bwd_weight_ref(flat, idx, w, dout)
    assert d_weight.dtype == want.dtype and d_weight.shape == want.shape
    _close(d_weight, want, 2e-2)


@pytest.mark.cuda
def test_k1_bf16_kernels_propagate_a_nan_in_a_clipped_row(cuda_device):
    """A clipped corner (weight 0) on a row that holds a NaN: the kernels
    read it and multiply, so the NaN reaches the same outputs as in the
    plain versions (and XLA); everything else matches."""
    rng = np.random.RandomState(7)
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, torch.bfloat16,
                                         4, 256, 256, 256, 333)
    flat[5, 3] = float("nan")
    idx[2, 1, 9] = 5
    w[2, 1, 9] = 0.0
    for got, want in (
            (deform_gather_contract(flat, idx, w, wk),
             deform_gather_contract_ref(flat, idx, w, wk)),
            (dg.deform_gather_contract_bwd_weight(flat, idx, w, wk, dout),
             dg.deform_gather_contract_bwd_weight_ref(flat, idx, w, dout))):
        torch.cuda.synchronize()
        nan = want.isnan()
        assert nan.any() and torch.equal(got.isnan(), nan)
        _close(got.float().nan_to_num(), want.float().nan_to_num(), 2e-2)


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
@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("Cg", [8, 16, 32])
@pytest.mark.parametrize("px,K", [(1, 9), (37, 9), (333, 9), (8400, 9),
                                  (200, 4)])
def test_grouped_bf16_bwd_weight_at_x101_widths(cuda_device, px, K, Cg, nc):
    """The bf16 grouped bwd-weight kernel (``gdw_bf16``) at the three X-101
    group widths (G = 64, C = cout = 64 Cg): a lone pixel, px below one
    tile, ragged px, a c4-sized px, a last group of one tap (K = 4); one
    launch counted each call, 2e-2 of max(1, max|ref|)."""
    rng = np.random.RandomState(px + K + Cg + nc)
    C = 64 * Cg
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, torch.bfloat16,
                                         nc, C, Cg, C, px, K=K)
    before = gr.deform_gather_grouped_contract_bwd_weight.launches
    got = gr.deform_gather_grouped_contract_bwd_weight(flat, idx, w, wk,
                                                       dout, 64)
    torch.cuda.synchronize()
    assert gr.deform_gather_grouped_contract_bwd_weight.launches == before + 1
    want = gr.deform_gather_grouped_contract_bwd_weight_ref(flat, idx, w,
                                                            dout, 64)
    assert got.dtype == want.dtype and got.shape == want.shape
    _close(got, want, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Cg", [8, 16, 32])
def test_grouped_bf16_bwd_weight_nan_rows(cuda_device, Cg):
    """A NaN in flat row 0, which no live corner reads, at a ragged px (the
    padded pixels' table points at row 0): d_W finite and equal to the plain
    version. Then a NaN in a clipped row (weight 0) that a live pixel reads:
    NaN where the plain version has it, the rest equal."""
    rng = np.random.RandomState(40 + Cg)
    C = 64 * Cg
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, torch.bfloat16, 4,
                                         C, Cg, C, 333)
    idx.clamp_(min=1)
    flat[0] = float("nan")

    def both():
        got = gr.deform_gather_grouped_contract_bwd_weight(flat, idx, w, wk,
                                                           dout, 64)
        want = gr.deform_gather_grouped_contract_bwd_weight_ref(
            flat, idx, w, dout, 64)
        torch.cuda.synchronize()
        return got, want

    got, want = both()
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    _close(got, want, 2e-2)
    flat[5, 3] = float("nan")
    idx[idx == 5] = 6
    idx[2, 1, 9] = 5
    w[2, 1, 9] = 0.0
    got, want = both()
    nan = want.isnan()
    assert nan.any() and torch.equal(got.isnan(), nan)
    _close(got.float().nan_to_num(), want.float().nan_to_num(), 2e-2)


def _adversarial_table(kind, nc, K, px, R):
    """Corner tables that stress the bwd-data scatter: every corner on one
    row (each add meets every other), every corner on a row of its own
    (none meet), neighbouring pixels on the same few rows as a 3x3
    deformable conv sends them, and rows at both ends of flat."""
    rng = np.random.RandomState(len(kind))
    if kind == "one_row":
        idx = np.full((nc, K, px), R // 2)
    elif kind == "distinct":
        idx = np.arange(nc * K * px).reshape(nc, K, px) % R
    elif kind == "neighbours":
        idx = (np.arange(px)[None, None] // 3 + rng.randint(0, 4, (nc, K, px))
               ) % R
    else:
        idx = rng.choice([0, R - 1], (nc, K, px))
    return torch.from_numpy(idx.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("groups", [1, 32])
@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("kind", ["one_row", "distinct", "neighbours",
                                  "ends"])
def test_bwd_data_kernels_on_adversarial_tables(cuda_device, dtype, rel,
                                                groups, nc, kind):
    """Both bwd-data kernels against their plain versions, both outputs
    together and one at a time, ragged px (333), one launch counted each
    time."""
    rng = np.random.RandomState(30 + nc + groups)
    C, px, R = 512, 333, 700
    flat, _, w, wk, dout = _bwd_inputs(rng, cuda_device, dtype, nc, C,
                                       C // groups, C, px, R=R)
    idx = _adversarial_table(kind, nc, 9, px, R).to(cuda_device)
    if groups == 1:
        fn, ref, extra = (dg.deform_gather_contract_bwd_data,
                          dg.deform_gather_contract_bwd_data_ref, ())
    else:
        fn, ref, extra = (gr.deform_gather_grouped_contract_bwd_data,
                          gr.deform_gather_grouped_contract_bwd_data_ref,
                          (groups,))
    want = ref(flat, idx, w, wk, dout, *extra)
    before = fn.launches
    for need in ((True, True), (True, False), (False, True)):
        got = fn(flat, idx, w, wk, dout, *extra, *need)
        torch.cuda.synchronize()
        for g_, r_, asked in zip(got, want, need):
            assert (g_ is not None) == asked
            if asked:
                assert g_.dtype == r_.dtype and g_.shape == r_.shape
                _close(g_, r_, rel)
    assert fn.launches == before + 3


@pytest.mark.cuda
def test_grouped_bwd_data_rejects_narrow_groups(cuda_device):
    """outG = 4 in bf16: a 16-byte vector would straddle two groups."""
    rng = np.random.RandomState(0)
    flat, idx, w, wk, dout = _bwd_inputs(rng, cuda_device, torch.bfloat16, 1,
                                         256, 4, 256, 70, R=90)
    with pytest.raises(ValueError, match="outG"):
        gr.deform_gather_grouped_contract_bwd_data(flat, idx, w, wk, dout, 64)


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", probes.PROBES)
def test_probe_kernels_match_plain_versions(cuda_device, name):
    """Each probe kernel on the JAX probes' inputs at the JAX probes'
    tolerances (the two copies exactly), one launch counted."""
    args = [a.to(cuda_device) for a in probes.probe_inputs(name)]
    fn = getattr(probes, name)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = getattr(probes, name + "_ref")(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = probe_tool.TOLERANCES[name]
    if tol is None:
        assert torch.equal(got, want)
    else:
        assert torch.allclose(got, want, rtol=tol[0], atol=tol[1])


@pytest.mark.cuda
def test_probe_kernels_at_other_sizes(cuda_device):
    """Ragged pixel tiles of the sub-row kernels (the dot in both launch
    shapes, one tile and many, a ragged last tile in each; the sum's ring
    from one tile to many tiles a CTA: two launches equal bit for bit, no
    atomics), the block gather's ring around its stage count, at many
    clamped indices and at 16-byte, 2 KB and 16 KB blocks, the row copy
    from the smallest to the largest row its bulk copies take."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy((rng.randn(8, 128, 128) / 16).astype(np.float32)
                         ).to(cuda_device, torch.bfloat16)
    for P in (1, 16, 17, 37, 64, 129, 8449, 16384):   # 8449: large shape
        x = torch.from_numpy(rng.randn(P, 8, 128).astype(np.float32)).to(
            cuda_device, torch.bfloat16)
        got = probes.probe_subrow_dot(x, w)
        _close(got, probes.probe_subrow_dot_ref(x, w), 1e-5)
        assert torch.equal(got, probes.probe_subrow_dot(x, w)), P
    for P in (1, 15, 16, 17, 37, 8449, 65536):
        x = torch.randn(P, 8, 128, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(P)
                        ).to(torch.bfloat16)
        got = probes.probe_subrow_sum(x)
        _close(got, probes.probe_subrow_sum_ref(x), 1e-5)
        assert torch.equal(got, probes.probe_subrow_sum(x)), P
    src = (pathlib.Path(__file__).resolve().parents[1] / "lsnet_torch"
           / "csrc" / "probe_block_gather.cu").read_text()
    ring, most = (int(re.search(rf"\b{k} = (\d+);", src).group(1))
                  for k in ("RING_BYTES", "MAX_STAGES"))
    # (cols, dtype): 8-row blocks of 16 bytes, 2 KB and 16 KB
    for cols, dtype in ((1, torch.bfloat16), (128, torch.bfloat16),
                        (512, torch.float32)):
        nblocks = 300
        table = torch.randn(nblocks * 8, cols, device=cuda_device,
                            generator=torch.Generator(cuda_device
                                                      ).manual_seed(cols)
                            ).to(dtype)
        stages = min(most, ring // (8 * cols * table.element_size()))
        for n in sorted({1, 2, max(1, stages - 1), stages, stages + 1, 1000,
                         147456}):
            idx = torch.from_numpy(rng.randint(-5, nblocks + 5, n).astype(
                np.int32)).to(cuda_device)
            assert torch.equal(probes.probe_block_gather(table, idx),
                               probes.probe_block_gather_ref(table, idx)), \
                (cols, n)
    for cols in (4, 128, 4096):                       # 16 B, 512 B, 16 KB
        row = torch.from_numpy(rng.randn(3, cols).astype(np.float32)).to(
            cuda_device)
        assert torch.equal(probes.probe_row_copy(row), row[:1]), cols
    with pytest.raises(ValueError, match="bytes"):
        probes.probe_row_copy(torch.zeros(2, 6, device=cuda_device))


@pytest.mark.cuda
def test_probe_tool_on_the_card(cuda_device, capsys):
    assert probe_tool.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and all(": OK" in ln for ln in lines)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["segm", "pose_bbox", "pose_kbox"])
def test_task_forward_on_the_card(cuda_device, task):
    """A narrow X-101-shaped detector of each task: the card (kernels)
    against the CPU (plain versions), f32, and the launch counts of one
    forward (2 or 3 towers of one block, the paired refine's two
    contractions, pose_bbox's own bbox refine)."""
    from lsnet_torch import configs
    from lsnet_torch.apis import init_model
    torch.backends.cudnn.allow_tf32 = False
    cfg = getattr(configs, f"x101_{task}_cfg")(feat=64, stacked=1)
    cfg["backbone"].update(depth=50, groups=8)
    cfg["bbox_head"]["num_classes"] = 3
    images = torch.randn(2, 96, 128, 3,
                         generator=torch.Generator().manual_seed(1))
    outs = {}
    for device in ("cpu", "cuda"):
        model = init_model(cfg, device=device, seed=1)
        deform_gather_contract.launches = 0
        with torch.inference_mode():
            outs[device] = model(images.to(device))
    towers = 3 if task == "pose_bbox" else 2
    assert deform_gather_contract.launches == towers + 2 + (
        task == "pose_bbox")
    for key, maps in outs["cpu"].items():
        for got, want in zip(outs["cuda"][key], maps):
            _close(got.cpu(), want, 1e-3)


@pytest.mark.cuda
def test_runner_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """chip_smoke.py's phase 6a: the narrow ResNeXt-shaped bbox model
    through ``train_detector`` for 2 iterations (f32) and
    ``evaluate_detector`` on the card and on the CPU: the losses to 1e-3
    relative, the metrics to 0.01 absolute."""
    import chip_smoke
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.check_narrow_runner(str(tmp_path))


@pytest.mark.cuda
def test_batch_to_device_on_the_card(cuda_device, tmp_path):
    from lsnet_torch.data import coco
    from lsnet_torch.tools.shapes import make_shapes_coco
    ann, img = make_shapes_coco(str(tmp_path), 2, seed=0)
    ds = coco.CocoDataset(coco.DatasetConfig(ann_file=ann, img_prefix=img,
                                             img_scale=(160, 128)))
    batch = next(coco.DataLoader(ds, 2, prefetch=0).epoch(0))
    moved = coco.batch_to_device(batch, cuda_device)
    assert list(moved) == list(batch)
    assert isinstance(moved["img_id"], np.ndarray)
    for k, v in batch.items():
        if k != "img_id":
            assert moved[k].device.type == "cuda"
            np.testing.assert_array_equal(moved[k].cpu().numpy(), v)
            assert moved[k].cpu().numpy().dtype == v.dtype, k
    with pytest.raises(RuntimeError):
        coco.batch_to_device(batch, f"cuda:{torch.cuda.device_count()}")


def _paired_mask_free_inputs(dev, dtype, C, cout, levels, B=2, seed=0):
    """(flat, idx, w, weight) of RepPoints' paired gather: each job reads
    its own level at scale 1, stride 1, with no mask (plain DeformConv),
    offsets a few pixels around the 3x3 taps."""
    from lsnet_torch.ops import flat_deform as fd
    gen = torch.Generator().manual_seed(seed)
    feats = [torch.randn(B, h, w, C, generator=gen).to(dev, dtype)
             for h, w in levels]
    lv = fd.pack_levels(feats)
    jobs = [fd.SampleJob(i, (2.0 * torch.randn(B, h, w, 18, generator=gen)
                             ).to(dev), None, (1.0, 1.0), (1, 1), (1, 1),
                         (1, 1)) for i, (h, w) in enumerate(levels)]
    idx, w = fd._gather_indices_tap(lv, jobs, 9, "bilinear")
    weight = (0.05 * torch.randn(9, C, cout, generator=gen)).to(dev, dtype)
    return lv.flat.contiguous(), idx, w, weight


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("C", [256, 262])
def test_k1_at_the_paired_mask_free_shape(cuda_device, dtype, rel, C):
    """K1's forward, bwd-data and bwd-weight on RepPoints' paired gather
    (v1 C = 256, v2 C = 262 through the wrappers' padding) at a 128x192
    canvas's five levels, against the plain versions."""
    levels = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    flat, idx, w, wk = _paired_mask_free_inputs(cuda_device, dtype, C, 256,
                                                levels)
    dout = torch.randn(idx.shape[2], 256, device=cuda_device).to(dtype)
    _close(deform_gather_contract(flat, idx, w, wk),
           deform_gather_contract_ref(flat, idx, w, wk), rel)
    got = (*dg.deform_gather_contract_bwd_data(flat, idx, w, wk, dout),
           dg.deform_gather_contract_bwd_weight(flat, idx, w, wk, dout))
    for g, ref in zip(got, dg.deform_gather_contract_bwd_ref(flat, idx, w,
                                                             wk, dout)):
        assert g.dtype == ref.dtype and g.shape == ref.shape
        _close(g, ref, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_reppoints_heads_on_the_card_match_the_cpu(cuda_device, version):
    """A narrow RepPoints v1 / v2 head (f32, bilinear): every output on the
    card within 1e-4 of the CPU's, the gradients of its parameters too,
    and 2 K1 launches a forward (the paired gather's two contractions),
    each backward kernel twice a backward."""
    from lsnet_torch.apis import random_weights_
    from lsnet_torch.models.heads.reppoints import (RepPointsHead,
                                                    RepPointsV2Head)
    kind = RepPointsV2Head if version == "v2" else RepPointsHead
    extra = dict(corner_dim=16) if version == "v2" else {}
    head = random_weights_(kind(4, 64, 64, 64, stacked_convs=1,
                                norm_groups=8, **extra), 0)
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(2, 64, h, h, generator=gen) for h in (16, 8, 4, 2,
                                                               2)]

    def run(dev):
        head.to(dev).zero_grad()
        outs = head([f.to(dev) for f in feats])
        total = sum((m.float() ** 2).mean() for k, v in outs.items()
                    for m in ([v] if k == "moment" else v))
        total.backward()
        # clones: moving the module later moves the gradients it holds
        return outs, {n: p.grad.detach().clone().cpu()
                      for n, p in head.named_parameters()}

    want, want_g = run("cpu")
    counters = (deform_gather_contract, dg.deform_gather_contract_bwd_data,
                dg.deform_gather_contract_bwd_weight)
    before = [c.launches for c in counters]
    got, got_g = run(cuda_device)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2]
    for key, maps in want.items():
        for g, w_ in zip([got[key]] if key == "moment" else got[key],
                         [maps] if key == "moment" else maps):
            _close(g.detach().cpu(), w_.detach(), 1e-4)
    for n, g in want_g.items():
        _close(got_g[n], g, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["GARetinaHead", "GARPNHead"])
def test_guided_anchoring_heads_on_the_card_match_the_cpu(cuda_device,
                                                          kind):
    """A narrow GA-RetinaNet / GA-RPN head from its training init with
    the adaption offsets moved off the lattice (f32, bilinear): every map
    on the card within 1e-4 of the CPU's and every parameter's gradient
    too; K1 runs the mask-free adaption once a branch (2 / 1 launches a
    forward, as many of each backward kernel a backward), and the offset
    gradient reaches ``adaption_offset*`` but not ``conv_shape`` through
    the adaption (the shape loss is left out)."""
    from lsnet_torch.models.heads.dense import GARetinaHead, GARPNHead
    from lsnet_torch.models.init import init_weights_
    head = (GARetinaHead(4, 64, 64, stacked_convs=1)
            if kind == "GARetinaHead" else GARPNHead(64, 64))
    init_weights_(head, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.startswith("adaption_offset"):
                p.normal_(0.0, 0.3, generator=torch.Generator()
                          .manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn(2, 64, h, h + 3, generator=gen)
             for h in (16, 8, 4, 2, 1)]
    calls = 2 if kind == "GARetinaHead" else 1

    def run(dev):
        head.to(dev).zero_grad()
        outs = head([f.to(dev) for f in feats])
        total = sum((m.float() ** 2).mean() for k in ("cls", "reg")
                    for m in outs[k])
        total.backward()
        return outs, {n: None if p.grad is None
                      else p.grad.detach().clone().cpu()
                      for n, p in head.named_parameters()}

    want, want_g = run("cpu")
    counters = (deform_gather_contract, dg.deform_gather_contract_bwd_data,
                dg.deform_gather_contract_bwd_weight)
    before = [c.launches for c in counters]
    got, got_g = run(cuda_device)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [calls] * 3
    for key, maps in want.items():
        for g, w_ in zip(got[key], maps):
            _close(g.detach().cpu(), w_.detach(), 1e-4)
    assert want_g["conv_shape.weight"] is None
    assert got_g["conv_shape.weight"] is None
    for n, g in want_g.items():
        if g is not None:
            _close(got_g[n], g, 1e-4)
    assert all(got_g[n].abs().max() > 0 for n in got_g
               if n.startswith("adaption"))
