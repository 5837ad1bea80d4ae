"""The bf16 K1 kernels' decomposition, on the CPU.

``csrc/k1_wgmma.cuh`` with ``deform_gather_contract.cu`` (forward) and
``deform_gather_contract_bwd_weight.cu`` (bwd-weight) cut the work into
tiles that this file repeats in plain torch:

* forward: blocks of 128 px x 256 cout; chunks of (tap, 64 channels); the
  A tile gathered and weighted (channels past C zero, pixels past px read
  row 0 with weight 0); the B chunk assembled from 64 x 64 boxes of W's
  (cout, C, K) tensor map, boxes past cout not loaded, box parts past C or
  cout filled with zeros; only pixels below px and columns below cout
  written out;
* bwd-weight: blocks of (tap, 128 channels, 256 cout, a share of the 64-px
  tiles: ``wave_px_splits`` picks the count, ``px_shares`` below repeats
  how a block finds its own); A the gathered tile (rows
  past px zero, their corners not read), B the dout box rows (zeros past px
  and cout); partial sums added into d_W;
* the 128-byte swizzle: where TMA puts a box element, where gather_tile
  puts an A element, and where wgmma reads each through the descriptors
  the kernels build (MN-major: LBO 8 KB, SBO 1 KB, 2 KB a 16-deep step;
  K-major: SBO 1 KB, 32 bytes a step), which agree only for tiles on a
  1 KB boundary.

The emulations are held against the plain versions, 1e-5 of max(1,
max|ref|) (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from lsnet_torch.ops import deform_gather as dg

K = 3
PX_BLOCK, NT, CHUNK, BOX = 128, 256, 64, 64


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(rng, nc, R, px, C, cout):
    flat = t(rng.randn(R, C).astype(np.float32))
    idx = t(rng.randint(0, R, (nc, K, px)).astype(np.int32))
    w = t(rng.rand(nc, K, px).astype(np.float32))
    weight = t((0.1 * rng.randn(K, C, cout)).astype(np.float32))
    dout = t(rng.randn(px, cout).astype(np.float32))
    return flat, idx, w, weight, dout


def px_shares(px, nsplit):
    """The 64-px tiles [lo, hi) of each of the ``nsplit`` shares as
    bwd_weight_kernel_wgmma assigns them: ceil(tiles / nsplit) to a share,
    the last shares short or empty."""
    ntile = -(-px // 64)
    per = -(-ntile // nsplit)
    return [(min(ntile, s * per), min(ntile, (s + 1) * per))
            for s in range(nsplit)]


def _box(mat, r0, c0):
    """A 64 x 64 box of a 2-D matrix at (r0, c0), zeros out of bounds."""
    out = torch.zeros(CHUNK, BOX)
    part = mat[r0:r0 + CHUNK, c0:c0 + BOX]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _boxes(cout, n0):
    return min(NT // BOX, -(-(cout - n0) // BOX))


def _gather(flat, idx, w, k, pixels, ch0, live):
    """Rows of V[k] for ``pixels`` (live ones only), channels ch0 ..
    ch0 + width, zero past C; a dead row is zero and reads nothing."""
    width = NT // 2 if live is not None else CHUNK
    C = flat.shape[1]
    tile = torch.zeros(len(pixels), width)
    hi = min(C, ch0 + width)
    for r, p in enumerate(pixels):
        if live is not None and not live[r]:
            continue
        for c in range(idx.shape[0]):
            tile[r, :hi - ch0] += w[c, k, p] * flat[idx[c, k, p], ch0:hi]
    return tile


def emulate_forward(flat, idx, w, weight):
    nc, _, px = idx.shape
    C, cout = flat.shape[1], weight.shape[2]
    out = torch.zeros(px, cout)
    # the corner table: pixels past px hold row 0 with weight 0
    pad = -px % PX_BLOCK
    idx_t = torch.cat([idx, torch.zeros(nc, K, pad, dtype=idx.dtype)], 2)
    w_t = torch.cat([w, torch.zeros(nc, K, pad)], 2)
    for p0 in range(0, px, PX_BLOCK):
        pixels = range(p0, p0 + PX_BLOCK)
        for n0 in range(0, cout, NT):
            acc = torch.zeros(PX_BLOCK, NT)
            for k in range(K):
                for c0 in range(0, C, CHUNK):
                    a = _gather(flat, idx_t, w_t, k, pixels, c0, None)
                    b = torch.zeros(CHUNK, NT)
                    for q in range(_boxes(cout, n0)):
                        b[:, q * BOX:(q + 1) * BOX] = _box(
                            weight[k], c0, n0 + q * BOX)
                    acc += a @ b
            rows, cols = min(PX_BLOCK, px - p0), min(NT, cout - n0)
            out[p0:p0 + rows, n0:n0 + cols] = acc[:rows, :cols]
    return out


def emulate_bwd_weight(flat, idx, w, dout, sms):
    _, _, px = idx.shape
    C, cout = flat.shape[1], dout.shape[1]
    ch_tile = NT // 2
    tiles = -(-C // ch_tile) * -(-cout // NT) * K
    nsplit = dg.wave_px_splits(sms, tiles, px)
    d_w = torch.zeros(K, C, cout)
    for ch0 in range(0, C, ch_tile):
        for n0 in range(0, cout, NT):
            for k in range(K):
                for lo, hi in px_shares(px, nsplit):
                    acc = torch.zeros(ch_tile, NT)
                    for tile in range(lo, hi):
                        p0 = tile * CHUNK
                        pixels = [min(p, px - 1)
                                  for p in range(p0, p0 + CHUNK)]
                        live = [p < px for p in range(p0, p0 + CHUNK)]
                        a = _gather(flat, idx, w, k, pixels, ch0, live)
                        b = torch.zeros(CHUNK, NT)
                        for q in range(_boxes(cout, n0)):
                            b[:, q * BOX:(q + 1) * BOX] = _box(
                                dout, p0, n0 + q * BOX)
                        acc += a.t() @ b
                    rows, cols = min(ch_tile, C - ch0), min(NT, cout - n0)
                    d_w[k, ch0:ch0 + rows, n0:n0 + cols] += acc[:rows, :cols]
    return d_w


def _close(got, want):
    lim = 1e-5 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= lim


@pytest.mark.parametrize("nc", [1, 4])
@pytest.mark.parametrize("cout", [8, 72, 264])
@pytest.mark.parametrize("C", [32, 96, 256])
def test_forward_tiles_match_plain_version(C, cout, nc):
    """Ragged px (two blocks, the second 2 px deep), channels (C = 32, 96:
    a half-empty last chunk) and cout (8, 72: boxes past cout not loaded;
    264: a second 256-wide block row)."""
    rng = np.random.RandomState(C + cout + nc)
    flat, idx, w, weight, _ = _inputs(rng, nc, 40, 130, C, cout)
    _close(emulate_forward(flat, idx, w, weight),
           dg.deform_gather_contract_ref(flat, idx, w, weight))


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("C,cout", [(32, 8), (96, 72), (256, 264)])
def test_bwd_weight_tiles_match_plain_version(C, cout, sms):
    """px = 333 (six 64-px tiles, the last 13 deep) over the shares of the
    split that ``wave_px_splits`` picks for ``sms`` SMs."""
    rng = np.random.RandomState(C + cout + sms)
    flat, idx, w, _, dout = _inputs(rng, 4, 40, 333, C, cout)
    _close(emulate_bwd_weight(flat, idx, w, dout, sms),
           dg.deform_gather_contract_bwd_weight_ref(flat, idx, w, dout))


def test_a_nan_in_a_clipped_row_propagates():
    """A clipped corner (weight 0) on a row holding a NaN makes its pixel's
    output NaN, as in XLA: the kernels read clipped rows and multiply."""
    rng = np.random.RandomState(0)
    flat, idx, w, weight, _ = _inputs(rng, 4, 40, 70, 64, 64)
    flat[5, 3] = float("nan")
    idx[2, 1, 9] = 5
    w[2, 1, 9] = 0.0
    got = emulate_forward(flat, idx, w, weight)
    want = dg.deform_gather_contract_ref(flat, idx, w, weight)
    assert torch.equal(got.isnan(), want.isnan())
    assert want[9].isnan().all() and not want[8].isnan().any()


@pytest.mark.parametrize("px", [1, 63, 64, 65, 333, 44800, 134400])
@pytest.mark.parametrize("tiles", [1, 9, 18, 36, 72])
@pytest.mark.parametrize("sms", [1, 132])
def test_px_shares_cover_every_tile_once(px, tiles, sms):
    ntile = -(-px // 64)
    nsplit = dg.wave_px_splits(sms, tiles, px)
    assert 1 <= nsplit <= ntile
    assert tiles * nsplit <= 65535          # grid z holds K x nsplit
    covered = [t_ for lo, hi in px_shares(px, nsplit)
               for t_ in range(lo, hi)]
    assert covered == list(range(ntile))


def test_wave_px_splits_fills_the_card():
    """The tower and refine calls of the head (9 taps x 2 channel tiles):
    at most one block per SM idle in the last wave, or the waves are
    within 5 % of the ideal."""
    for px in (44800, 134400):
        ntile = -(-px // 64)
        nsplit = dg.wave_px_splits(132, 18, px)
        per = -(-ntile // nsplit)
        waves = -(-18 * nsplit // 132)
        assert waves * per <= 1.05 * 18 * ntile / 132 + per


def _swz(addr):
    """The 128-byte swizzle on a shared-memory byte address: the 16-byte
    chunk bits 4-6 XOR the 128-byte row bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _mn_major_read(start, k, n, lbo=8 * 1024, sbo=1024):
    """Where wgmma reads element (k, n), 0 <= k < 16, of an MN-major
    operand (one 16-deep step) through a descriptor at ``start``."""
    return _swz(start + (n // 64) * lbo + (k // 8) * sbo + (k % 8) * 128
                + (n % 64) * 2)


def _k_major_read(start, m, k, sbo=1024):
    return _swz(start + (m // 8) * sbo + (m % 8) * 128 + k * 2)


@pytest.mark.parametrize("base", [0, 5 * 1024])
def test_tma_boxes_and_mn_major_descriptors_agree(base):
    """Four 64 x 64 boxes (TMA: row r of box q at base + 8 KB q + 128 r,
    swizzled) read back through the B descriptors of the four 16-deep
    steps (start + 2 KB a step): every element where it was put."""
    for s in range(CHUNK // 16):
        for k in range(16):
            for n in range(0, NT, 7):
                row, q = 16 * s + k, n // BOX
                put = _swz(base + q * 8 * 1024 + row * 128 + (n % BOX) * 2)
                assert _mn_major_read(base + 2048 * s, k, n) == put


@pytest.mark.parametrize("base,aligned", [(0, True), (3 * 1024, True),
                                          (512, False)])
def test_gathered_tile_and_k_major_descriptor_agree(base, aligned):
    """gather_tile puts element (r, col) at r * 128 + ((col / 8) ^ (r % 8))
    * 16 + (col % 8) * 2 of its tile; the forward's A descriptor reads
    (m, 16 s + k) at start + 32 s. They agree on a tile that starts on a
    1 KB boundary (smem_base), and not on one that does not."""
    same = True
    for r in range(64):
        for col in range(CHUNK):
            put = base + r * 128 + (((col // 8) ^ (r % 8)) * 16) \
                + (col % 8) * 2
            got = _k_major_read(base + 32 * (col // 16), r, col % 16)
            same = same and put == got
    assert same == aligned
