"""The sub-row dot kernel's decomposition and the row copy's byte rule, on
the CPU.

``csrc/probe_subrow_dot.cu`` computes ``out = sum_j x[:, j, :] @ w[j]``
with one kernel body in two launch shapes <TP, NQ, JB, KS> (TP pixels a
tile, NQ column slices, JB sub-rows a block, CL = 8 / JB blocks a
cluster, KS depth slices across a block's warps).
This file repeats its layout in plain torch, in the kernel's order:

* the shape: the large one when its tiles give every SM a block, else the
  small one;
* block (t, q, rank) stages pixels [TP t, TP t + rows) of the views
  x[:, j, :] for j in [JB rank, JB rank + JB) (rows = min(TP, P - TP t))
  and columns [NB q, NB q + NB) of each w[j] (NB = 128 / NQ); the warps
  of depth slice k add the products of depth [128 k / KS, 128 (k + 1) /
  KS) into their f32 accumulators in the order of j, and the KS slices
  are summed in order into the block's partial tile; the last 16-pixel
  fragment's rows past P are zeros and fragments wholly past P are neither
  staged nor multiplied;
* rank r of the cluster sums pixels [lo_r, hi_r) of the tile over the CL
  partials in rank order (ceil(rows / CL) pixels a rank, the last ranks
  short or empty) and writes them out.

The constants are read from the source. The emulations are held against
the plain version at several P, 1e-5 of max(1, max|ref|) (f32 sums in
another order), and at the probe's own P = 16 inputs against the sum the
JAX ``probe_c`` checks itself against in interpret mode (rtol 1e-3, atol
1e-4, as ``tests/test_torch_probes.py``).
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from lsnet_torch.ops import probes

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = (REPO / "lsnet_torch" / "csrc" / "probe_subrow_dot.cu").read_text()


def _constant(name):
    return int(re.search(rf"\b{name} = (\d+)[,;]", SOURCE).group(1))


J, C, N = _constant("J"), _constant("C"), _constant("N")
THREADS = _constant("THREADS")
SHAPES = {size: tuple(_constant(f"{size.upper()}_{k}")
                      for k in ("TP", "NQ", "JB", "KS"))
          for size in ("small", "large")}
LARGE_STAGES = _constant("LARGE_STAGES")
LD_PAD = 8                       # LD = C + 8, LDW = NB + 8 in the source
FRAG = 16                        # pixels of a WMMA fragment
PIECE = 16                       # bytes of a cp.async copy
H100_SMS = 132
SIZES = (1, 16, 17, 37, 100, 129)


LARGE_MIN_PX = _constant("LARGE_MIN_PX")


def shape_for(P, sms=H100_SMS):
    """The launch shape lsnet_probe_subrow_dot picks."""
    return SHAPES["large" if -(-P // LARGE_MIN_PX) >= sms else "small"]


def tiles(P, tp):
    """(p0, rows) of each px tile."""
    return [(p0, min(tp, P - p0)) for p0 in range(0, P, tp)]


def rank_rows(rows, cl):
    """[lo, hi) of the tile's pixels that each cluster rank sums."""
    per = -(-rows // cl)
    out = []
    for r in range(cl):
        lo = min(rows, r * per)
        out.append((lo, min(rows, lo + per)))
    return out


def staged_view(x, p0, rows, j):
    """The staged view of x[:, j, :] as the product reads it: the tile's
    fragments holding a pixel, pixels past P zero."""
    frags = -(-rows // FRAG)
    xs = torch.zeros(frags * FRAG, C, dtype=x.dtype)
    xs[:rows] = x[p0:p0 + rows, j, :]
    return xs


def emulate(x, w, shape):
    tp, nq, jb, ks = shape
    cl, nb, depth = J // jb, N // nq, C // ks
    P = x.shape[0]
    out = torch.full((P, N), float("nan"))
    for p0, rows in tiles(P, tp):
        for q in range(nq):
            cols = slice(q * nb, q * nb + nb)
            parts = []
            for rank in range(cl):
                accs = [torch.zeros(-(-rows // FRAG) * FRAG, nb)
                        for _ in range(ks)]
                for j in range(rank * jb, rank * jb + jb):
                    xs = staged_view(x, p0, rows, j).float()
                    for k in range(ks):
                        d = slice(k * depth, k * depth + depth)
                        accs[k] = accs[k] + xs[:, d] @ w[j][d, cols].float()
                part = accs[0]
                for k in range(1, ks):
                    part = part + accs[k]
                parts.append(part)
            for lo, hi in rank_rows(rows, cl):
                s = parts[0][lo:hi]
                for r in range(1, cl):
                    s = s + parts[r][lo:hi]
                out[p0 + lo:p0 + hi, cols] = s
    return out


def _inputs(P, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(P, J, C).astype(np.float32))
    w = torch.from_numpy((rng.randn(J, C, N) / 16).astype(np.float32))
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.parametrize("size", ["small", "large"])
def test_shapes_fit_the_card(size):
    tp, nq, jb, ks = SHAPES[size]
    assert (J, C, N, THREADS) == (8, 128, 128, 256)
    assert J % jb == 0 and N % (16 * nq) == 0 and tp % FRAG == 0
    assert C % (16 * ks) == 0
    nb = N // nq
    strips, warps = nb // 16, THREADS // 32
    assert warps % (strips * ks) == 0
    phases = warps // strips // ks
    assert (tp // FRAG) % phases == 0
    ld, ldw = C + LD_PAD, nb + LD_PAD
    stage = (tp * ld + C * ldw) * 2
    smem = stage * (LARGE_STAGES if jb > 1 else 1)
    # the KS f32 partials reuse the ring; the opt-in allows 227 KB a block
    assert ks * tp * nb * 4 <= smem <= 232448
    # 16-byte copies land on 16-byte rows; WMMA fragments and the w tile
    # start on 32-byte boundaries
    for row in (ld, ldw):
        assert (row * 2) % PIECE == 0 and (FRAG * row * 2) % 32 == 0
    assert (tp * ld * 2) % 32 == 0 and stage % 32 == 0


def test_shape_choice():
    assert shape_for(16) == SHAPES["small"] == (16, 8, 1, 8)
    assert shape_for(16384) == SHAPES["large"] == (128, 1, 8, 1)
    # the large shape once every SM gets 64 pixels: its 128-pixel tiles
    # then fill at least half the SMs
    assert shape_for(LARGE_MIN_PX * (H100_SMS - 1)) == SHAPES["small"]
    assert shape_for(LARGE_MIN_PX * (H100_SMS - 1) + 1) == SHAPES["large"]
    assert 2 * len(tiles(LARGE_MIN_PX * (H100_SMS - 1) + 1, 128)) \
        >= H100_SMS


@pytest.mark.parametrize("size", ["small", "large"])
@pytest.mark.parametrize("P", SIZES)
def test_emulation_matches_plain_version(size, P):
    x, w = _inputs(P)
    got = emulate(x, w, SHAPES[size])
    want = probes.probe_subrow_dot_ref(x, w)
    assert torch.isfinite(got).all()                  # every pixel written
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("P", SIZES + (16384,))
def test_ranks_cover_every_pixel_once(P):
    tp, nq, jb, _ = shape_for(P)
    cl = J // jb
    for p0, rows in tiles(P, tp):
        shares = rank_rows(rows, cl)
        covered = [p for lo, hi in shares for p in range(lo, hi)]
        assert covered == list(range(rows))
        assert max(hi - lo for lo, hi in shares) <= -(-tp // cl)


def test_grid_and_copies_at_the_probes_sizes():
    # P = 16: one tile in 8 column slices x 8 sub-rows: 64 blocks, each
    # with 16 pixels of one view and a 128 x 16 slice of w[j] in flight at
    # once, one 16-deep step a warp, and 2 pixels of 16 columns to sum from
    # its cluster
    tp, nq, jb, ks = shape_for(16)
    assert C // ks == 16
    (p0, rows), = tiles(16, tp)
    assert (p0, rows, len(tiles(16, tp)) * nq * (J // jb)) == (0, 16, 64)
    x_bytes, w_bytes = rows * C * 2, C * (N // nq) * 2
    assert (x_bytes, w_bytes) == (4096, 4096)
    assert (x_bytes + w_bytes) // PIECE <= THREADS * 2
    assert rank_rows(16, J // jb) == [(2 * r, 2 * r + 2) for r in range(J)]
    # P = 16,384: 128 tiles of 128 pixels, one block each taking all of j
    # in a two-stage ring; w read from L2 once per tile
    tp, nq, jb, _ = shape_for(16384)
    assert (len(tiles(16384, tp)) * nq, J // jb) == (128, 1)
    assert len(tiles(16384, tp)) * J * C * N * 2 == 128 * 256 * 1024


@pytest.mark.parametrize("P", [1, 17, 100, 129])
def test_rows_past_p_are_zeros(P):
    x, _ = _inputs(P)
    for size in SHAPES:
        tp = SHAPES[size][0]
        p0, rows = tiles(P, tp)[-1]
        for j in range(J):
            xs = staged_view(x, p0, rows, j)
            assert xs.shape[0] % FRAG == 0 and xs.shape[0] - rows < FRAG
            assert torch.equal(xs[:rows], x[p0:p0 + rows, j])
            assert not xs[rows:].any()


def test_probe_inputs_against_the_jax_probe():
    """At the probe's own inputs the emulation of the shape the kernel
    takes there meets the sum that the JAX probe_c is checked against,
    and the JAX probe passes in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "probe_dma2", REPO / "tools" / "probe_dma2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.probe_c()
    x, w = probes.probe_inputs("probe_subrow_dot")
    assert x.shape == (16, J, C)
    got = emulate(x, w, shape_for(16))
    xf, wf = x.float().numpy(), w.float().numpy()
    want = sum(xf[:, j, :] @ wf[j] for j in range(J))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("nbytes,ok", [
    (16, True), (32, True), (512, True), (16384, True),
    (0, False), (8, False), (24, False), (16400, False), (32768, False)])
def test_row_copy_byte_rule(nbytes, ok):
    """cp.async.bulk moves multiples of 16 bytes, and the row copy's shared
    buffer holds 16 KB: the wrapper refuses anything else before a
    launch."""
    if ok:
        probes._check_copy_bytes("a row", nbytes)
    else:
        with pytest.raises(ValueError, match="bytes"):
            probes._check_copy_bytes("a row", nbytes)
