"""The bf16 grouped forward kernel's decomposition, on the CPU.

``csrc/grouped_deform_contract.cu`` (``gdc_bf16``) cuts a call into tiles
that this file repeats in plain torch:

* blocks of 64 px x 64 cout; a cout tile reads only its channel slice
  [ch0, ch0 + S), S = 64 / outG * Cg, ch0 = n0 / outG * Cg;
* steps (tap k, slice s of ``sw`` channels; ``plan`` repeats the C
  entry's ``bf16_plan``) in a ring of ``STAGES`` slots: one cp.async group
  a step, step t in slot t % stages, the group of step t + stages - 1
  issued after the barrier of step t;
* the block's corner table with zeros past px (row 0, weight 0), the A
  fragments weighted from the slot's corner rows, which lie swizzled in
  16-byte chunks so that ldmatrix reads them without bank conflicts;
* the compact weight rows of a step (the Cg rows of the groups, or the
  step's own rows where Cg > sw) and how a B fragment row finds its staged
  row; B's elements of other groups set to 0 (the block-diagonal weight);
* the 8-wide column blocks skipped per 16-deep step, and at 16 x 16 the
  live-fragment mask of the kernel this one replaced; where Cg == outG is
  8, 16 or 32 (every X-101 stage) the blocks and rows fixed at compile
  time, held against the general ones;
* warps of 16 px x 64 cout; only rows below px written.

The emulation is held against ``deform_gather_grouped_contract_ref`` at 1e-5
of max(1, max|ref|) (f32 sums in another order; the kernel's bf16 rounding
of the A tile is left out, as the point is the tiling), and at one small
shape against the JAX Pallas kernel ``pallas_grouped.grouped_deform_contract``
in interpret mode at 2e-5, as ``tests/test_torch_grouped.py`` holds the
plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.ops import pallas_grouped as jpg
from lsnet_torch.ops import grouped as gr

torch.set_num_threads(1)

TILE, PX_TILE, WARP_ROWS = gr.TILE, 64, 16
STAGES = 2            # the kernel's ring depth
LDS = TILE + 8        # row stride (elements) of staged weight rows
SMEM_LIMIT = 232448   # dynamic shared memory of an H100 block


def plan(nc, K, Cg, outG):
    """How the kernel cuts a call (``bf16_plan`` of
    ``csrc/grouped_deform_contract.cu``): ``sw`` channels a step (64, or 32
    where the tile's slice S = 64 / outG * Cg is no multiple of 64), ``wr``
    weight rows staged a step (the Cg rows of the groups, or the step's own
    sw rows where Cg > sw), ``cg`` the group width its products know at
    compile time (Cg where Cg == outG is 8, 16 or 32; 0: the general
    products) and the bytes of shared memory: the table (idx and w, nc x K
    x 64 each) and the ring of [corner rows nc x 64 x sw | weight rows wr x
    LDS], at least the 64 x LDS output tile that the epilogue stages
    there."""
    S = TILE // outG * Cg
    sw = 64 if S % 64 == 0 else 32
    wr = min(sw, Cg)
    ring = STAGES * (nc * PX_TILE * sw + wr * LDS) * 2
    return {"S": S, "sw": sw, "wr": wr,
            "cg": Cg if Cg == outG and Cg in (8, 16, 32) else 0,
            "smem": nc * K * PX_TILE * 8 + max(ring, PX_TILE * LDS * 2)}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(rng, nc, K, R, px, C, Cg, cout):
    flat = t(rng.randn(R, C).astype(np.float32))
    idx = t(rng.randint(0, R, (nc, K, px)).astype(np.int32))
    w = t(rng.rand(nc, K, px).astype(np.float32))
    weight = t((0.1 * rng.randn(K, Cg, cout)).astype(np.float32))
    return flat, idx, w, weight


def div_f(x, d):
    """The kernel's x / d: (x + 0.5) times the f32 reciprocal, truncated."""
    return int(np.float32(np.float32(x) + np.float32(0.5))
               * np.float32(np.float32(1.0) / np.float32(d)))


def ring_schedule(steps, stages):
    """(step, slot) of each cp.async group in the order the kernel commits
    them, with the waits: at step t it waits until at most stages - 2 of
    its groups are pending, then (after a barrier) commits the group of
    step t + stages - 1 (empty past the last step). Checks that step t's
    group has landed when it is read and that a slot is refilled only when
    the step it held was consumed."""
    groups = [(u, u % stages) if u < steps else (None, None)
              for u in range(stages - 1)]
    consumed, done = set(), 0
    slot_step = {slot: u for u, slot in groups if u is not None}
    for step in range(steps):
        done = max(done, len(groups) - (stages - 2))    # wait_group
        assert (step, step % stages) in groups[:done]
        nxt = step + stages - 1
        if nxt < steps:
            slot = nxt % stages
            held = slot_step.get(slot)
            assert held is None or held in consumed, (step, slot, held)
            slot_step[slot] = nxt
        groups.append((nxt, nxt % stages) if nxt < steps else (None, None))
        consumed.add(step)
        assert slot_step[step % stages] == step
    return groups


def staged_rows(cut, Cg, s):
    """The compact-weight rows i staged for slice s, in slot order."""
    sw, wr = cut["sw"], cut["wr"]
    wbase = s * sw if Cg > sw else 0
    return [(wbase + q) % Cg for q in range(wr)]


def staged_row_of(cut, Cg, s, qc):
    """The slot row that the B fragment row of slice channel qc reads."""
    sw = cut["sw"]
    return qc if Cg > sw else (s * sw + qc) % Cg


def live_n8(cut, Cg, outG, s, kk):
    """The 8-wide column blocks [nb_lo, nb_hi] that step kk of slice s
    multiplies: their groups meet those of the 16 channels."""
    r0 = s * cut["sw"] + kk
    rg_lo, rg_hi = div_f(r0, Cg), div_f(r0 + 15, Cg)
    return rg_lo * outG // 8, ((rg_hi + 1) * outG - 1) // 8


def fast_fragments(CG, kk):
    """The products of ``Cg == outG == CG`` (``plan``'s cg), fixed at
    compile time: for each 8-wide column block a 16-deep step multiplies,
    the staged weight row of each of its 16 B rows, None where the kernel
    puts a zero register instead."""
    if CG == 8:
        nb = kk // 8
        return {nb: list(range(8)) + [None] * 8,
                nb + 1: [None] * 8 + list(range(8))}
    first = kk // CG * (CG // 8)
    return {first + h: [kk % CG + e for e in range(16)]
            for h in range(CG // 8)}


def emulate_bf16(flat, idx, w, weight, groups):
    nc, K, px = idx.shape
    _, Cg, cout = weight.shape
    C = flat.shape[1]
    outG = cout // groups
    cut = plan(nc, K, Cg, outG)
    S, sw, stages = cut["S"], cut["sw"], STAGES
    NS = S // sw
    steps = K * NS
    ring_schedule(steps, stages)
    out = torch.full((px, cout), float("nan"))
    pad = -px % PX_TILE
    idx_t = torch.cat([idx, torch.zeros(nc, K, pad, dtype=idx.dtype)], 2)
    w_t = torch.cat([w, torch.zeros(nc, K, pad)], 2)
    for n0 in range(0, cout, TILE):
        ch0 = n0 // outG * Cg
        assert ch0 + S <= C
        col_group = torch.tensor([j // outG for j in range(TILE)])
        for p0 in range(0, px, PX_TILE):
            rows = slice(p0, p0 + PX_TILE)
            slots = [None] * stages
            acc = torch.zeros(PX_TILE, TILE)

            def issue(step):
                if step >= steps:
                    return
                k, s = divmod(step, NS)
                col = ch0 + s * sw
                raw = flat[idx_t[:, k, rows].long(), col:col + sw]
                wrows = weight[k, staged_rows(cut, Cg, s), n0:n0 + TILE]
                slots[step % stages] = (step, raw, wrows)

            for u in range(stages - 1):
                issue(u)
            for step in range(steps):
                issue(step + stages - 1)
                held, raw, wrows = slots[step % stages]
                assert held == step
                k, s = divmod(step, NS)
                a = (w_t[:, k, rows, None] * raw).sum(0)       # (64, sw)
                for warp in range(PX_TILE // WARP_ROWS):
                    wr_ = slice(warp * WARP_ROWS, (warp + 1) * WARP_ROWS)
                    for kk in range(0, sw, 16):
                        nb_lo, nb_hi = live_n8(cut, Cg, outG, s, kk)
                        ch = [s * sw + kk + e for e in range(16)]
                        rg = torch.tensor([div_f(c, Cg) for c in ch])
                        full = torch.stack([
                            weight[k, c % Cg, n0:n0 + TILE] for c in ch])
                        mask = rg[:, None] == col_group[None, :]
                        fast = (fast_fragments(cut["cg"], kk)
                                if cut["cg"] else None)
                        if fast is not None:
                            assert sorted(fast) == list(
                                range(nb_lo, nb_hi + 1))
                        for nb in range(TILE // 8):
                            cols = slice(nb * 8, nb * 8 + 8)
                            if not nb_lo <= nb <= nb_hi:
                                # a skipped block is all zero in B
                                assert not mask[:, cols].any()
                                continue
                            frag = torch.stack([
                                wrows[staged_row_of(cut, Cg, s, kk + e),
                                      cols] for e in range(16)])
                            torch.testing.assert_close(
                                frag, full[:, cols], rtol=0, atol=0)
                            frag = torch.where(mask[:, cols], frag,
                                               torch.zeros(()))
                            if fast is not None:
                                # the fixed rows give the masked fragment
                                rows_ = fast[nb]
                                fixed = torch.stack([
                                    torch.zeros(8) if q is None
                                    else wrows[q, cols] for q in rows_])
                                torch.testing.assert_close(fixed, frag,
                                                           rtol=0, atol=0)
                            acc[wr_, cols] += a[wr_, kk:kk + 16] @ frag
            n = min(PX_TILE, px - p0)
            out[p0:p0 + n, n0:n0 + TILE] = acc[:n]
    return out


SHAPES = [
    # (G, Cg, cout): X-101 c3, c4, c5 (Cg == outG, S = 64); S = 32 (two
    # wide column groups per channel group); S = 128 (two slices); Cg >
    # the 64-channel slice; S = 96 in 32-channel slices across a group
    (64, 8, 512), (64, 16, 1024), (32, 32, 1024), (32, 8, 512),
    (16, 32, 256), (2, 128, 128), (2, 96, 128)]


@pytest.mark.parametrize("G,Cg,cout", SHAPES)
@pytest.mark.parametrize("nc,px", [(1, 100), (4, 37)])
def test_emulation_matches_plain_version(G, Cg, cout, nc, px):
    """Ragged px edge (100) and px below one tile (37)."""
    rng = np.random.RandomState(G + Cg + nc)
    K, R = 3, 90
    args = _inputs(rng, nc, K, R, px, G * Cg, Cg, cout)
    got = emulate_bf16(*args, G)
    want = gr.deform_gather_grouped_contract_ref(*args, G)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("G,Cg,cout", SHAPES)
def test_live_blocks_cover_the_16x16_mask(G, Cg, cout):
    """Per 16-deep step, the 8-wide blocks multiplied make up exactly the
    16 x 16 fragments that the replaced kernel found live, split where a
    16-wide fragment holds a dead half."""
    outG = cout // G
    cut = plan(1, 9, Cg, outG)
    for s in range(cut["S"] // cut["sw"]):
        for kk in range(0, cut["sw"], 16):
            r0 = s * cut["sw"] + kk
            rg0, rg1 = r0 // Cg, (r0 + 15) // Cg
            nb_lo, nb_hi = live_n8(cut, Cg, outG, s, kk)
            for j in range(TILE // 16):
                live16 = (16 * j) // outG <= rg1 and rg0 <= (16 * j + 15) \
                    // outG
                halves = [nb_lo <= 2 * j + h <= nb_hi for h in (0, 1)]
                assert live16 == any(halves), (s, kk, j)
                for h in (0, 1):
                    c0 = 16 * j + 8 * h
                    live8 = c0 // outG <= rg1 and rg0 <= (c0 + 7) // outG
                    assert halves[h] == live8


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("steps", [1, 2, 9, 18])
def test_ring_order(stages, steps):
    groups = ring_schedule(steps, stages)
    issued = [g for g, _ in groups if g is not None]
    assert issued == list(range(steps))            # each step once, in order
    assert len(groups) == stages - 1 + steps       # one group an iteration


def swz(sw, r, j):
    """The kernel's swz<SW>: chunk j of ring row r is stored at chunk
    swz(r, j) of the row."""
    return j ^ ((r if sw == 64 else r >> 1) & (sw // 8 - 1))


@pytest.mark.parametrize("sw", [32, 64])
def test_ring_swizzle(sw):
    """Each ring row's chunks are a permutation; the 8 rows that one
    ldmatrix matrix reads (chunk j of rows r0 .. r0 + 7) fall in 8
    different 16-byte bank groups of the 128-byte bank window."""
    vpr = sw // 8
    for r in range(2 * PX_TILE):
        assert sorted(swz(sw, r, j) for j in range(vpr)) == list(range(vpr))
    for r0 in range(0, 2 * PX_TILE, 8):
        for j in range(vpr):
            groups = {((r * sw * 2) + swz(sw, r, j) * 16) % 128 // 16
                      for r in range(r0, r0 + 8)}
            assert len(groups) == 8


@pytest.mark.parametrize("d", [1, 3, 8, 16, 32, 96, 128])
def test_float_division(d):
    assert [div_f(x, d) for x in range(4096)] == [x // d
                                                  for x in range(4096)]


def test_plan_and_limits():
    """The cut at the X-101 stages and at the other slice widths, the
    shared memory of every model's calls (nc <= 4 corners, K = 9 taps)
    within a block's limit, and the wrapper's limits refused by name."""
    assert plan(1, 9, 16, 16) == {"S": 64, "sw": 64, "wr": 16, "cg": 16,
                                  "smem": 25600}
    assert plan(1, 9, 8, 8)["smem"] == 23296
    assert plan(1, 9, 32, 32)["smem"] == 30208
    assert plan(1, 9, 8, 16)["cg"] == 0
    # the epilogue's 64 x LDS output tile fits in the smallest ring
    assert plan(1, 9, 4, 8)["smem"] == 64 * 9 * 8 + 2 * (
        64 * 32 * 2 + 4 * LDS * 2) >= 64 * 9 * 8 + 64 * LDS * 2
    assert plan(1, 9, 8, 16)["sw"] == 32
    assert plan(1, 9, 128, 64)["wr"] == 64
    for nc in range(1, 5):
        for Cg in (8, 16, 32):
            assert plan(nc, 9, Cg, Cg)["smem"] <= SMEM_LIMIT
    # nc x K of a few hundred outgrows it; the C entry then fails to launch
    assert plan(4, 200, 16, 16)["smem"] > SMEM_LIMIT
    flat = torch.zeros(10, 1024, dtype=torch.bfloat16)
    idx = torch.zeros(5, 9, 5, dtype=torch.int32)
    w = torch.zeros(5, 9, 5)
    weight = torch.zeros(9, 16, 1024, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="corners"):
        gr._check_kernel_limits(flat, idx, w, weight, 64)
    with pytest.raises(ValueError, match="must divide"):
        gr._check_kernel_limits(flat, idx[:1], w[:1],
                                torch.zeros(9, 16, 96, dtype=torch.bfloat16),
                                1)
    with pytest.raises(ValueError, match="channel slice"):
        gr._check_kernel_limits(flat, idx[:1], w[:1],
                                torch.zeros(9, 2, 512, dtype=torch.bfloat16),
                                64)


def test_emulation_matches_pallas_kernel():
    """On the identity table of ``grouped_deform_contract`` (row p K + k
    with weight 1): the emulated tiling against the Pallas kernel."""
    px, K, G, Cg = 70, 9, 64, 8
    C = cout = G * Cg
    rng = np.random.RandomState(5)
    vals = rng.randn(px, K * C).astype(np.float32)
    wk = (0.05 * rng.randn(K, Cg, cout)).astype(np.float32)
    want = jpg.grouped_deform_contract(jnp.asarray(vals), jnp.asarray(wk), K,
                                       G)
    idx = torch.arange(px * K, dtype=torch.int32).view(px, K).t()
    got = emulate_bf16(t(vals).reshape(px * K, C), idx.contiguous()[None],
                       torch.ones(1, K, px), t(wk), G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
