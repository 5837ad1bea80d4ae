"""The bwd-data kernels' decomposition, on the CPU.

``csrc/deform_bwd.cuh`` ``bwd_data_kernel`` gives one block 64 pixels and
one 64-channel tile, and builds G = dout_tile x W[k]^T from 16-byte vectors
of the weight as it lies in memory: row n of the transposed B chunk is
channel n's weights, and in the grouped kernel a row keeps only the vectors
whose columns are its own group's (the rest are zeros). d_w is the sum of
the channel tiles' partial dot products. This file repeats that index
arithmetic in plain torch and holds it against the plain versions
(``*_bwd_data_ref``), 1e-5 of max(1, max|ref|): f32 sums in another order.
"""

import numpy as np
import pytest
import torch

from lsnet_torch.ops import deform_gather as dg
from lsnet_torch.ops import grouped as gr

K, TILE = 9, 64


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(rng, nc, R, px, C, Cg, cout):
    flat = t(rng.randn(R, C).astype(np.float32))
    idx = t(rng.randint(0, R, (nc, K, px)).astype(np.int32))
    w = t(rng.rand(nc, K, px).astype(np.float32))
    weight = t((0.1 * rng.randn(K, Cg, cout)).astype(np.float32))
    dout = t(rng.randn(px, cout).astype(np.float32))
    return flat, idx, w, weight, dout


def _g_tile(dout, weight, k, tile, C, Cg, outG, vec, grouped):
    """G (px, 64) of channel tile ``tile`` as a block builds it."""
    cout = weight.shape[2]
    klo, khi = (tile * TILE, tile * TILE + TILE) if grouped else (0, cout)
    ch0 = klo // outG * Cg if grouped else tile * TILE
    bt = torch.zeros(TILE, khi - klo)                  # B transposed
    for n in range(TILE):
        wrow = n % Cg if grouped else ch0 + n
        if not grouped and wrow >= C:
            continue
        for kv in range(0, khi - klo, vec):
            col = kv - n // Cg * outG                  # column in its group
            if grouped and not 0 <= col < outG:
                continue
            bt[n, kv:kv + vec] = weight[k, wrow, klo + kv:klo + kv + vec]
    return ch0, dout[:, klo:khi] @ bt.t()


def _emulate(flat, idx, w, weight, dout, groups, vec):
    """(d_flat, d_w) summed tile by tile as the kernel's grid does."""
    nc, _, px = idx.shape
    C = flat.shape[1]
    _, Cg, cout = weight.shape
    outG = cout // groups
    grouped = groups > 1
    d_flat = torch.zeros_like(flat)
    d_w = torch.zeros(nc, K, px)
    tiles = cout // TILE if grouped else -(-C // TILE)
    for tile in range(tiles):
        for k in range(K):
            ch0, g = _g_tile(dout, weight, k, tile, C, Cg, outG, vec, grouped)
            width = min(TILE, C - ch0)
            for c in range(nc):
                rows = idx[c, k].long()
                d_w[c, k] += (flat[rows, ch0:ch0 + width]
                              * g[:, :width]).sum(-1)
                d_flat[:, ch0:ch0 + width].index_add_(
                    0, rows, w[c, k].unsqueeze(-1) * g[:, :width])
    return d_flat, d_w


def _close(got, want):
    lim = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= lim


@pytest.mark.parametrize("vec", [4, 8])
@pytest.mark.parametrize("Cg", [8, 16, 32])
@pytest.mark.parametrize("nc", [1, 4])
def test_grouped_tiles_match_plain_version(vec, Cg, nc):
    """Cg = outG = 8, 16, 32 (X-101 c3, c4, c5) with the f32 and bf16
    vector widths; two cout tiles."""
    rng = np.random.RandomState(vec + Cg + nc)
    groups = 2 * TILE // Cg
    C = groups * Cg
    args = _inputs(rng, nc, 50, 37, C, Cg, C)
    want_flat, want_w = gr.deform_gather_grouped_contract_bwd_data_ref(
        *args, groups)
    d_flat, d_w = _emulate(*args, groups, vec)
    _close(d_flat, want_flat)
    _close(d_w, want_w)


@pytest.mark.parametrize("vec", [4, 8])
@pytest.mark.parametrize("C,cout", [(64, 64), (96, 40), (160, 72)])
def test_ungrouped_tiles_match_plain_version(vec, C, cout):
    """K1: ragged last channel tile (C = 96, 160) and cout no multiple of
    the chunk."""
    rng = np.random.RandomState(vec + C)
    args = _inputs(rng, 4, 50, 37, C, C, cout)
    want_flat, want_w = dg.deform_gather_contract_bwd_data_ref(*args)
    d_flat, d_w = _emulate(*args, 1, vec)
    _close(d_flat, want_flat)
    _close(d_w, want_w)


def test_a_vector_wider_than_a_group_is_wrong():
    """outG = 4 with 8-wide vectors: a vector straddles two groups, which
    is why the wrapper refuses such shapes on the card."""
    rng = np.random.RandomState(0)
    Cg, groups = 4, 32
    args = _inputs(rng, 1, 50, 37, groups * Cg, Cg, groups * Cg)
    want_flat, _ = gr.deform_gather_grouped_contract_bwd_data_ref(*args,
                                                                  groups)
    d_flat, _ = _emulate(*args, groups, 8)
    assert (d_flat - want_flat).abs().max().item() > 1e-2
