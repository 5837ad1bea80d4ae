"""The bf16 grouped bwd-weight kernel's decomposition, on the CPU.

``csrc/grouped_deform_contract_bwd_weight.cu`` (``gdw_bf16``, Cg == outG
in {8, 16, 32}) cuts a call into pieces that this file repeats in plain
torch, lane by lane:

* blocks (64-wide cout tile, group of TAPS taps, share of the 64-px
  tiles); the host's choice of shares (``grouped.bwd_weight_splits``);
  each (tap, px tile, cout tile) summed by exactly one block;
* steps (px tile, tap) in a ring: one cp.async group a step, holding the
  step's corner rows, the dout tile with a px tile's first tap and the
  table of the step STAGES - 1 ahead; one barrier a step; no slot refilled
  before every read of what it held, nothing read before its group landed;
* the 16-byte chunks of a 128-byte ring row swizzled so that ldmatrix
  reads 8 rows without bank conflicts;
* A = V^T from ``ldmatrix.trans`` of the raw corner rows, each half of a
  register pair weighted by its own pixel's corner weight;
* B = dout from ``ldmatrix.trans``; the columns of each warp fixed at
  compile time for Cg 8 / 16 / 32, only the diagonal blocks multiplied
  (for Cg 8 half of each m16n8 product dead and dropped);
* pixels past px zero in both operands (no byte read), even with a NaN in
  row 0; a clipped corner of a live pixel read and multiplied;
* the epilogue's compact rows d_W[k, ch % Cg, n] and its 8-byte adds.

The emulation is held against
``deform_gather_grouped_contract_bwd_weight_ref`` at 1e-5 of max(1,
max|ref|) (f32 sums in another order; the kernel's bf16 rounding of A is
left out, as the point is the decomposition), and at one small shape
against the JAX Pallas dweight, ``jax.vjp`` of
``pallas_grouped.grouped_deform_contract`` in interpret mode, at 2e-5.
"""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.ops import pallas_grouped as jpg
from lsnet_torch.ops import grouped as gr
from lsnet_torch.tools import bench_grouped, bench_grouped_bwd

torch.set_num_threads(1)

PXT = TILE = 64       # pixels of a step; cout (and channels) of a tile
WARPS = 4
STAGES = 2            # the kernel's ring depth
TSLOTS = 2 * STAGES - 1
SRC = (pathlib.Path(gr.__file__).resolve().parent.parent / "csrc"
       / "grouped_deform_contract_bwd_weight.cu")


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_constants_match_the_kernel():
    """TAPS, STAGES and TSLOTS here and in ``ops/grouped.py`` are the
    kernel's."""
    src = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TAPS") == gr.GDW_TAPS
    assert const("STAGES") == STAGES
    assert "constexpr int TSLOTS = 2 * STAGES - 1;" in src


@pytest.mark.parametrize("tool,name", [
    (tool, name) for tool in (bench_grouped, bench_grouped_bwd)
    for name in tool.SPLITS])
def test_bench_split_texts_are_in_the_sources(tool, name):
    """Every text that a split of ``bench_grouped`` (the forward) or
    ``bench_grouped_bwd`` patches is still in the file it names, once."""
    for fname, old, _ in tool.SPLITS[name]:
        src = (SRC.parent / fname).read_text()
        assert src.count(old) == 1, (fname, old)


def swz(r, j):
    """The kernel's swz<64>: chunk j of ring row r lies at chunk swz(r, j)."""
    return j ^ (r & 7)


def test_ring_swizzle():
    """Each 128-byte row's chunks are a permutation; the 8 rows that one
    ldmatrix matrix reads (8 consecutive pixels at one chunk: an A matrix
    of a corner, or a B matrix of the dout tile) fall in 8 different
    16-byte bank groups."""
    for r in range(4 * PXT):
        assert sorted(swz(r, j) for j in range(8)) == list(range(8))
    for r0 in range(0, 4 * PXT, 8):
        for j in range(8):
            assert len({swz(r, j) for r in range(r0, r0 + 8)}) == 8


# ------------------------------------------------------------ ring order
def ring_schedule(nj, nt, taps=gr.GDW_TAPS, stages=STAGES, tslots=TSLOTS):
    """The cp.async groups and barriers of one block of nj px tiles and nt
    live taps, step by step: which slot each copy writes and each read
    reads. Asserts that every read finds its own data landed, and that no
    copy overwrites a slot before every read of what it held. Returns the
    groups in commit order."""
    steps = nj * taps
    holder, last_read = {}, {}     # (kind, slot) -> item, iteration
    groups, landed = [], set()

    def write(kind, slot, item, it):
        key = (kind, slot)
        assert last_read.get(key, -2) < it, (kind, slot, item, it)
        holder[key] = item
        return (kind, slot, item)

    def read(kind, slot, item, it):
        key = (kind, slot)
        assert holder.get(key) == item, (kind, slot, item, holder.get(key))
        assert (kind, slot, item) in landed, (kind, slot, item)
        last_read[key] = it

    def table(v, it):
        if v < steps and v % taps < nt:
            return [write("table", v % tslots, v, it)]
        return []

    def issue(v, it):
        g = []
        if v < steps:
            j = v // taps
            if v % taps < nt:
                read("table", v % tslots, v, it)      # the rows' addresses
                g.append(write("rows", v % stages, v, it))
            if v % taps == 0:
                g.append(write("dout", j % stages, j, it))
        g += table(v + stages - 1, it)
        groups.append(g)

    prologue = []
    for u in range(stages - 1):
        prologue += table(u, -1)
    groups.append(prologue)
    landed.update(prologue)                  # wait_group 0, barrier
    for u in range(stages - 1):
        issue(u, -1)
    for u in range(steps):
        for g in groups[:len(groups) - (stages - 2)]:   # wait_group
            landed.update(g)
        issue(u + stages - 1, u)             # after the barrier
        if u % taps < nt:
            read("rows", u % stages, u, u)
            read("table", u % tslots, u, u)  # the corner weights
            read("dout", (u // taps) % stages, u // taps, u)
    return groups


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("taps,nt", [(3, 3), (3, 2), (3, 1), (1, 1)])
@pytest.mark.parametrize("nj", [1, 2, 5])
def test_ring_order(nj, taps, nt, stages):
    groups = ring_schedule(nj, nt, taps, stages, 2 * stages - 1)
    rows = [item for g in groups for kind, _, item in g if kind == "rows"]
    assert rows == [v for v in range(nj * taps) if v % taps < nt]
    douts = [item for g in groups for kind, _, item in g if kind == "dout"]
    assert douts == list(range(nj))
    assert len(groups) == 1 + stages - 1 + nj * taps   # one a step


def test_fewer_table_slots_would_race():
    """2 STAGES - 1 tables are needed: with STAGES of them a table is
    overwritten while its step still reads its weights."""
    with pytest.raises(AssertionError):
        ring_schedule(3, 3, 3, 3, 3)


# ------------------------------------------------------------ fragments
LANE = torch.arange(32)
G8, T4 = LANE >> 2, LANE & 3


def ldsm_x4_trans(smem, rows, chunks):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 of every warp: smem (rows,
    64) as stored, rows / chunks (W, 32) the row and stored chunk each lane
    points at (lanes 8 i .. 8 i + 7: matrix i). Returns (W, 32, 4, 2): lane
    t's register i holds rows 2 (t % 4) and 2 (t % 4) + 1 of matrix i at
    column t / 4, as the low and high half."""
    lines = smem.view(-1, 8, 8)[rows, chunks]              # (W, 32, 8)
    mats = lines.view(-1, 4, 8, 8)                         # (W, i, row, col)
    lo = mats[:, :, 2 * T4, G8]                            # (W, 4, 32)
    hi = mats[:, :, 2 * T4 + 1, G8]
    return torch.stack([lo, hi], -1).permute(0, 2, 1, 3)


def mma16816(a, b):
    """mma.sync m16n8k16 of every warp from its lanes' fragments: a (W, 32,
    4, 2), b (W, 32, 2, 2) -> (W, 32, 4): rows g8 | g8 + 8, columns 2 t4,
    2 t4 + 1."""
    W = a.shape[0]
    A = torch.zeros(W, 16, 16)
    B = torch.zeros(W, 16, 8)
    for e, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        for h in (0, 1):
            A[:, G8 + dr, 2 * T4 + dk + h] = a[:, :, e, h]
    for e in (0, 1):
        for h in (0, 1):
            B[:, 2 * T4 + 8 * e + h, G8] = b[:, :, e, h]
    D = A @ B
    return torch.stack([D[:, G8, 2 * T4], D[:, G8, 2 * T4 + 1],
                        D[:, G8 + 8, 2 * T4], D[:, G8 + 8, 2 * T4 + 1]], -1)


def warp_columns(CG):
    """First column of each warp's n8 tiles in the cout tile, and their
    count: fixed at compile time."""
    warp = torch.arange(WARPS)
    if CG == 32:
        return (warp >> 1) * 32, 4
    return warp * 16, 2


def emulate_gdw(flat, idx, w, dout, groups, sms=132, nsplit=None,
                check_zero=False):
    """d_W (K, Cg, cout) f32 the way gdw_bf16 computes it."""
    nc, K, px = idx.shape
    C, cout = flat.shape[1], dout.shape[1]
    Cg = C // groups
    assert Cg == cout // groups and Cg in gr.GDW_CG
    taps = gr.GDW_TAPS
    if nsplit is None:
        nsplit = gr.bwd_weight_splits(torch.bfloat16, sms, K, Cg, cout, px)
    ntile = -(-px // PXT)
    per = -(-ntile // nsplit)
    dW = torch.zeros(K, Cg, cout)
    summed = torch.zeros(K, ntile, cout // TILE, dtype=torch.int32)
    cb, NT = warp_columns(Cg)
    warp = torch.arange(WARPS)[:, None]
    lane = LANE[None]
    ra = (lane & 7) + ((lane >> 4) << 3)
    ja = 2 * warp + ((lane >> 3) & 1)
    rb = (lane & 7) + (((lane >> 3) & 1) << 3)
    for bx in range(cout // TILE):
        n0 = bx * TILE
        for by in range(-(-K // taps)):
            k0 = by * taps
            nt = min(taps, K - k0)
            for bz in range(nsplit):
                j0 = bz * per
                nj = min(ntile, j0 + per) - j0
                if nj <= 0:
                    continue
                ring_schedule(nj, nt)
                acc = torch.zeros(taps, WARPS, 32, NT, 4)
                for j in range(nj):
                    p0 = (j0 + j) * PXT
                    live = torch.arange(p0, p0 + PXT) < px
                    # the dout tile: 16-byte chunks at their swizzled
                    # places, zero fill past px
                    dsrc = torch.where(
                        live[:, None],
                        dout[torch.clamp(torch.arange(p0, p0 + PXT), max=px - 1),
                             n0:n0 + TILE], torch.zeros(()))
                    dt = place(dsrc)
                    for tau in range(nt):
                        k = k0 + tau
                        summed[k, j0 + j, bx] += 1
                        # the table: zero fill past px (row 0, weight 0)
                        pix = torch.clamp(torch.arange(p0, p0 + PXT),
                                          max=px - 1)
                        s_idx = torch.where(live, idx[:, k, pix], 0)
                        s_w = torch.where(live, w[:, k, pix], 0.0)
                        raw = torch.where(live[None, :, None],
                                          flat[s_idx.long(), n0:n0 + TILE],
                                          torch.zeros(()))
                        slot = place(raw.reshape(nc * PXT, TILE))
                        if check_zero:
                            dead = ~live
                            assert (raw[:, dead] == 0).all()
                            assert (dsrc[dead] == 0).all()
                        for kc in range(PXT // 16):
                            f = torch.zeros(WARPS, 32, 4, 2)
                            for c in range(nc):
                                cr = c * PXT + kc * 16 + ra
                                r = ldsm_x4_trans(slot, cr.expand(WARPS, 32),
                                                  swz(cr, ja))
                                # pixels 2 t4 (+ 8 for e >= 2) low, + 1 high
                                for e in range(4):
                                    p = kc * 16 + 2 * T4 + 8 * (e >= 2)
                                    f[:, :, e, 0] += s_w[c, p] * r[:, :, e, 0]
                                    f[:, :, e, 1] += (s_w[c, p + 1]
                                                      * r[:, :, e, 1])
                            if check_zero:
                                dead_p = ~live[kc * 16:(kc + 1) * 16]
                                for e in range(4):
                                    p = 2 * T4 + 8 * (e >= 2)
                                    assert (f[:, dead_p[p], e, 0] == 0).all()
                                    assert (f[:, dead_p[p + 1], e, 1]
                                            == 0).all()
                            pb = kc * 16 + rb
                            for h in range(0, NT, 2):
                                jb = cb[:, None] // 8 + h + (lane >> 4)
                                b = ldsm_x4_trans(dt, pb.expand(WARPS, 32),
                                                  swz(pb, jb))
                                acc[tau, :, :, h] += mma16816(f, b[:, :, 0:2])
                                acc[tau, :, :, h + 1] += mma16816(
                                    f, b[:, :, 2:4])
                epilogue(dW, acc, nt, k0, n0, Cg, cout)
    # every (tap, px tile, cout tile) summed by exactly one block
    assert (summed == 1).all()
    return dW


def place(rows):
    """Rows (r, 64) as the ring holds them: chunk j at chunk swz(r, j)."""
    n = rows.shape[0]
    out = torch.full((n, 8, 8), float("nan"))
    r = torch.arange(n)[:, None]
    out[r, swz(r, torch.arange(8)[None])] = rows.reshape(n, 8, 8)
    return out.reshape(n, 64)


def epilogue(dW, acc, nt, k0, n0, Cg, cout):
    """The warps' 8-byte adds into d_W[k, ch % Cg, n]: each kept
    accumulator's channel and column share a group; every diagonal entry of
    the tile is added exactly once a tap; the dropped halves (Cg 8) are the
    products of other groups."""
    cb, NT = warp_columns(Cg)
    for tau in range(nt):
        hits = torch.zeros(Cg, TILE, dtype=torch.int32)
        for wp in range(WARPS):
            for h in range(NT):
                n = cb[wp] + 8 * h + 2 * T4                  # tile columns
                for half in (0, 1):                           # row g8 | +8
                    ch = 16 * wp + G8 + 8 * half
                    keep = Cg != 8 or half == h
                    same = ch // Cg == n // Cg
                    assert (same.all() if keep else not same.any()), \
                        (Cg, wp, h, half)
                    if not keep:
                        continue
                    i = ch % Cg
                    assert (i == (G8 if Cg == 8 else 16 * wp % Cg + G8
                                  + 8 * half)).all()
                    for e in (0, 1):
                        dW[k0 + tau].index_put_(
                            (i, n0 + n + e), acc[tau, wp, :, h, 2 * half + e],
                            accumulate=True)
                        hits.index_put_((i, n + e),
                                        torch.ones(32, dtype=torch.int32),
                                        accumulate=True)
        assert (hits == 1).all()


# --------------------------------------------------------------- inputs
def _inputs(rng, nc, K, R, px, G, Cg, clipped=0.1):
    C = G * Cg
    flat = t(rng.randn(R, C).astype(np.float32))
    idx = rng.randint(0, R, (nc, K, px)).astype(np.int32)
    w = rng.rand(nc, K, px).astype(np.float32)
    w[rng.rand(nc, K, px) < clipped] = 0.0
    dout = t(rng.randn(px, C).astype(np.float32))
    return flat, t(idx), t(w), dout


def _close(got, want, rel):
    err = (got - want).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


SHAPES = [
    # (G, Cg): the X-101 group widths (c3 8, c4 16, c5 32) at one 64-wide
    # cout tile, and Cg 16 at two
    (8, 8), (4, 16), (2, 32), (8, 16)]


@pytest.mark.parametrize("G,Cg", SHAPES)
@pytest.mark.parametrize("nc,px,K", [(1, 100, 9), (4, 37, 9), (4, 130, 4)])
def test_emulation_matches_plain_version(G, Cg, nc, px, K):
    """Ragged px (100, 130), px below one tile (37), a last tap group of
    one tap (K = 4); the host's split for a 132-SM card."""
    rng = np.random.RandomState(G + Cg + nc + K)
    flat, idx, w, dout = _inputs(rng, nc, K, 90, px, G, Cg)
    got = emulate_gdw(flat, idx, w, dout, G, check_zero=True)
    want = gr.deform_gather_grouped_contract_bwd_weight_ref(flat, idx, w,
                                                            dout, G)
    assert torch.isfinite(got).all()
    _close(got, want, 1e-5)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7])
def test_px_shares(nsplit):
    """Any split sums each (tap, px tile, cout tile) once, shares that own
    no tile included (7 shares of 3 tiles)."""
    rng = np.random.RandomState(nsplit)
    flat, idx, w, dout = _inputs(rng, 4, 9, 90, 150, 4, 16)
    got = emulate_gdw(flat, idx, w, dout, 4, nsplit=nsplit)
    want = gr.deform_gather_grouped_contract_bwd_weight_ref(flat, idx, w,
                                                            dout, 4)
    _close(got, want, 1e-5)


def test_host_splits_at_the_x101_calls():
    """The px shares that the wrapper asks for at the six X-101 calls (B=2,
    800x1344) on a 132-SM H100, and that they fill two blocks an SM: at
    least one wave, each block at most a few dozen steps."""
    for px, cout in ((33600, 512), (8400, 1024), (2100, 2048)):
        Cg = cout // 64
        ns = gr.bwd_weight_splits(torch.bfloat16, 132, 9, Cg, cout, px)
        ntile = -(-px // PXT)
        per = -(-ntile // ns)
        blocks = cout // TILE * -(-9 // gr.GDW_TAPS) * -(-ntile // per)
        assert blocks >= 132 * 2 * 0.95, (px, ns, blocks)
        assert per * gr.GDW_TAPS <= 150, (px, ns)
        assert ns == 11, (px, ns)
    # f32, and a width gdw_bf16 does not take, keep the generic split
    assert gr.bwd_weight_splits(torch.float32, 132, 9, 16, 1024, 8400) == 4
    assert gr.bwd_weight_splits(torch.bfloat16, 132, 9, 4, 256, 8400) == \
        gr.px_splits(132, 4 * 9, 8400)


def test_padded_pixels_ignore_a_nan_in_row_0():
    """Pixels past px read row 0 in the table but copy no byte: a NaN there
    reaches no sum. No live corner reads row 0 here."""
    rng = np.random.RandomState(3)
    flat, idx, w, dout = _inputs(rng, 4, 9, 90, 70, 4, 16)
    idx = torch.clamp(idx, min=1)
    flat[0, :] = float("nan")
    got = emulate_gdw(flat, idx, w, dout, 4, check_zero=True)
    want = gr.deform_gather_grouped_contract_bwd_weight_ref(flat, idx, w,
                                                            dout, 4)
    assert torch.isfinite(want).all() and torch.isfinite(got).all()
    _close(got, want, 1e-5)


def test_clipped_row_of_a_live_pixel_propagates_a_nan():
    """A clipped corner (weight 0) of a live pixel on a row with a NaN: read
    and multiplied, so the NaN reaches the same entries as in the plain
    version, the columns of its channel's group."""
    rng = np.random.RandomState(4)
    flat, idx, w, dout = _inputs(rng, 4, 9, 90, 70, 8, 8)
    flat[5, 3] = float("nan")
    idx[idx == 5] = 6
    idx[2, 1, 9] = 5
    w[2, 1, 9] = 0.0
    got = emulate_gdw(flat, idx, w, dout, 8)
    want = gr.deform_gather_grouped_contract_bwd_weight_ref(flat, idx, w,
                                                            dout, 8)
    nan = want.isnan()
    assert nan.sum() == 8 and nan[1, 3, 0:8].all()
    assert torch.equal(got.isnan(), nan)
    _close(got.nan_to_num(), want.nan_to_num(), 1e-5)


def test_emulation_matches_pallas_dweight():
    """On the identity table of ``grouped_deform_contract`` (row p K + k of
    the gathered values, weight 1): the emulated kernel against the weight
    gradient of the Pallas kernel (``_make_dw_kernel`` and the pull-back to
    the compact layout), in interpret mode."""
    px, K, G, Cg = 70, 9, 16, 8
    C = G * Cg
    rng = np.random.RandomState(5)
    vals = rng.randn(px, K * C).astype(np.float32)
    wk = (0.05 * rng.randn(K, Cg, C)).astype(np.float32)
    dout = rng.randn(px, C).astype(np.float32)
    _, vjp = jax.vjp(
        lambda wt: jpg.grouped_deform_contract(jnp.asarray(vals), wt, K, G),
        jnp.asarray(wk))
    (want,) = vjp(jnp.asarray(dout))
    idx = torch.arange(px * K, dtype=torch.int32).view(px, K).t()
    got = emulate_gdw(t(vals).reshape(px * K, C), idx.contiguous()[None],
                      torch.ones(1, K, px), t(dout), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
