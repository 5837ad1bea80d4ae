"""The schedules of the block gather's and the sub-row sum's rings, on the
CPU.

``csrc/probe_block_gather.cu`` copies the one block of n = 1 in a CTA of
its own; at any other n it runs a persistent grid of single-warp CTAs,
each with a ring of ``stages`` blocks in shared memory: CTA c owns n /
grid contiguous outputs (one more for the first n % grid CTAs); lane 0
starts the first ``stages - lag`` bulk loads, then for each output waits
for its load, stores it by a bulk store, waits until at most ``lag``
stores still read the ring and loads the output ``stages - lag`` further
on into the stage that was read out. The warp reads the indices IDX_CHUNK
at a time, one chunk ahead, clamped.

``csrc/probe_subrow_sum.cu`` runs a persistent grid whose CTA b takes the
tiles b, b + grid, ... of TP pixels through a ring of STAGES tiles: a
producer lane copies a tile (only its rows) once the stage's empty barrier
says the consumers released it, and THREADS consumer threads, each on 8
columns of one pixel, wait for the stage's full barrier, sum the eight
views in f32 in the order j = 0..7 and write their pixel's columns.

This file replays both in plain torch in the kernels' order, with the
mbarriers' phase parity as the hardware reads it, and holds the replays
against the plain versions: the gather exactly, the sum at 1e-5 of max(1,
max|ref|) (and bit for bit against a sum in the kernel's order). At the
probes' own inputs it also holds them against what the JAX ``probe_a`` and
``probe_b`` check themselves against, with both JAX probes run in
interpret mode. The constants are read from the sources; H100_SMS = 132.
"""

import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from lsnet_torch.ops import probes
from lsnet_torch.tools import bench_probes

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "lsnet_torch" / "csrc"
GATHER = (CSRC / "probe_block_gather.cu").read_text()
SUM = (CSRC / "probe_subrow_sum.cu").read_text()
H100_SMS = 132


def _constant(src, name):
    return int(re.search(rf"\b{name} = (\d+);", src).group(1))


RING_BYTES, MAX_STAGES, STORE_DIV, IDX_CHUNK, G_CTAS = (
    _constant(GATHER, k) for k in ("RING_BYTES", "MAX_STAGES", "STORE_DIV",
                                   "IDX_CHUNK", "CTAS_PER_SM"))
TP, J, C, VEC, THREADS, STAGES, S_CTAS = (
    _constant(SUM, k) for k in ("TP", "J", "C", "VEC", "THREADS", "STAGES",
                                "CTAS_PER_SM"))
ROW_BYTES = J * C * 2


class Barrier:
    """An mbarrier as the kernels use it: ``completed`` phases so far;
    ``try_wait.parity(q)`` is true while the current phase's parity is
    not q (the phase of parity q has completed)."""

    def __init__(self):
        self.completed = 0

    def ready(self, parity):
        return (self.completed & 1) != parity


# ------------------------------------------------------------ block gather
def gather_stages(block_bytes):
    return min(MAX_STAGES, RING_BYTES // block_bytes)


def gather_grid(n, sms=H100_SMS):
    return min(math.ceil(n / IDX_CHUNK), sms * G_CTAS)


def gather_owned(n, grid):
    """[lo, hi) of the outputs of each CTA."""
    per, extra = divmod(n, grid)
    los = [c * per + min(c, extra) for c in range(grid + 1)]
    return list(zip(los, los[1:]))


def replay_gather(x, idx, sms=H100_SMS):
    """out (n * 8, cols) as the kernel writes it, and how many times each
    output was stored."""
    nblocks = x.shape[0] // probes.BLOCK_ROWS
    blocks = x.contiguous().view(torch.uint8).reshape(nblocks, -1)
    block_bytes = blocks.shape[1]
    n = idx.numel()
    out = torch.full((n, block_bytes), 0xAB, dtype=torch.uint8)
    stores = [0] * n
    if n == 1:                              # the shape of its own
        b = int(idx[0].clamp(0, nblocks - 1))
        return x[b * probes.BLOCK_ROWS:(b + 1) * probes.BLOCK_ROWS], [1]
    stages = gather_stages(block_bytes)
    lag = stages // STORE_DIV
    ahead = stages - lag
    for lo, hi in gather_owned(n, gather_grid(n, sms)):
        count = hi - lo
        assert count >= 1
        bars = [Barrier() for _ in range(min(stages, count))]
        ring = [None] * stages          # (output, bytes) of each stage
        pending = []                    # stages read by stores in flight

        def chunk(c):
            i = lo + IDX_CHUNK * c + torch.arange(IDX_CHUNK)
            b = torch.where(i < hi, idx[i.clamp(max=n - 1)].long(),
                            torch.zeros_like(i))
            return b.clamp(0, nblocks - 1)

        regs = {"cur": chunk(0), "nxt": chunk(1)}

        def load(j):
            if j % IDX_CHUNK == 0 and j > 0:
                regs["cur"], regs["nxt"] = regs["nxt"], chunk(
                    j // IDX_CHUNK + 1)
            b = int(regs["cur"][j % IDX_CHUNK])
            s = j % stages
            assert s not in pending, "a stage refilled while a store reads it"
            ring[s] = (j, blocks[b].clone())
            bars[s].completed += 1        # the bulk load's bytes arrive

        for j in range(min(ahead, count)):
            load(j)
        for k in range(count):
            s = k % stages
            assert bars[s].ready((k // stages) & 1)
            assert ring[s][0] == k          # the stage holds output k's block
            out[lo + k] = ring[s][1]
            stores[lo + k] += 1
            pending.append(s)
            if k + ahead < count:
                del pending[:max(0, len(pending) - lag)]   # wait_group.read
                load(k + ahead)
        assert all(r is None or r[0] < count for r in ring)
    return out.view(x.dtype).reshape(n * probes.BLOCK_ROWS, -1), stores


def _table(nblocks, block_bytes, seed=0):
    """x (nblocks * 8, cols) with blocks of block_bytes: bf16 but f32 at
    16 KB, values unique per element."""
    dtype = torch.float32 if block_bytes == 16384 else torch.bfloat16
    cols = block_bytes // (probes.BLOCK_ROWS * (4 if block_bytes == 16384
                                                else 2))
    g = torch.Generator().manual_seed(seed)
    return torch.randn(nblocks * probes.BLOCK_ROWS, cols, generator=g
                       ).to(dtype)


def _indices(n, nblocks, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(-3, nblocks + 3, n).astype(np.int32))


def test_gather_ring_sizes():
    # a stage per block up to MAX_STAGES, one at the largest block; the
    # ring with its barriers under the 48 KB a launch gets without the
    # opt-in, and CTAS_PER_SM of them in the 228 KB of an SM (1 KB
    # reserved a CTA), at every block size
    assert gather_stages(2048) == 12 and gather_stages(16384) == 1
    assert gather_stages(16) == MAX_STAGES == 32
    for bb in range(16, 16385, 16):
        stages = gather_stages(bb)
        lag = stages // STORE_DIV
        assert stages >= 1 and stages - lag >= 1 and lag <= MAX_STAGES
        assert stages * (bb + 8) <= 48 * 1024
        assert G_CTAS * (stages * (bb + 8) + 1024) <= 228 * 1024
    # loads in flight an SM at 2 KB blocks: at least the ~25 KB Little's
    # law asks at 3.35 TB/s and ~1 us, and the 48 KB aimed at
    stages = gather_stages(2048)
    assert (stages - stages // STORE_DIV) * 2048 * G_CTAS >= 48 * 1024


@pytest.mark.parametrize("n", [2, 31, 32, 33, 1056 * 32, 1056 * 32 + 1,
                               147456])
def test_gather_grid_owns_each_output_once(n):
    grid = gather_grid(n)
    assert grid == min(math.ceil(n / IDX_CHUNK), H100_SMS * G_CTAS)
    owned = gather_owned(n, grid)
    assert owned[0][0] == 0 and owned[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))
    sizes = {hi - lo for lo, hi in owned}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    if n == 147456:                 # phase 2e: 1,056 CTAs of 139 or 140
        assert grid == 1056 and sizes == {139, 140}


@pytest.mark.parametrize("block_bytes", [16, 2048, 16384])
@pytest.mark.parametrize("around", [-1, 0, 1])
def test_gather_replay_around_the_stage_count(block_bytes, around):
    """n = stages - 1, stages, stages + 1 in one CTA, and again past the
    ring's wrap in several CTAs (2 SMs: the grid's cap)."""
    stages = gather_stages(block_bytes)
    x = _table(40, block_bytes)
    for n, sms in ((max(1, stages + around), H100_SMS),
                   (3 * stages + around + 70, 1)):
        idx = _indices(n, 40, seed=n)
        got, stores = replay_gather(x, idx, sms=sms)
        assert stores == [1] * n
        assert torch.equal(got, probes.probe_block_gather_ref(x, idx))


@pytest.mark.parametrize("n,sms", [(1, H100_SMS), (65, H100_SMS),
                                   (1000, 2), (1000, H100_SMS)])
def test_gather_replay_ragged_chunks_and_clamping(n, sms):
    x = _table(37, 2048, seed=1)
    idx = _indices(n, 37, seed=2)
    assert (idx < 0).any() or (idx >= 37).any() or n == 1
    got, stores = replay_gather(x, idx, sms=sms)
    assert stores == [1] * n
    assert torch.equal(got, probes.probe_block_gather_ref(x, idx))


# ------------------------------------------------------------ sub-row sum
def sum_grid(P, sms=H100_SMS):
    return min(math.ceil(P / TP), sms * S_CTAS)


def thread_slices():
    """(pixel, first column) of each consumer thread."""
    return [(t // (C // VEC), (t % (C // VEC)) * VEC) for t in range(THREADS)]


def replay_sum(x, sms=H100_SMS, seed=0):
    """out (P, 128) f32 as the kernel writes it. The producer and the
    consumers of each CTA advance in a seeded random order that the
    barriers allow; a stage keeps whatever bytes it held before."""
    P = x.shape[0]
    tiles = math.ceil(P / TP)
    grid = sum_grid(P, sms)
    rng = np.random.RandomState(seed)
    out = torch.full((P, C), float("nan"))
    for b in range(grid):
        mine = len(range(b, tiles, grid))
        full = [Barrier() for _ in range(STAGES)]
        empty = [Barrier() for _ in range(STAGES)]
        ring = torch.full((STAGES, TP, J, C), float("nan"),
                          dtype=torch.bfloat16)
        loaded = [-1] * STAGES
        prod = cons = 0
        while cons < mine:
            s_p = prod % STAGES
            can_load = prod < mine and (
                prod < STAGES or empty[s_p].ready((prod // STAGES - 1) & 1))
            s_c = cons % STAGES
            can_sum = full[s_c].ready((cons // STAGES) & 1)
            assert can_load or can_sum, "the ring deadlocks"
            if can_load and (not can_sum or rng.rand() < 0.5):
                p0 = (b + prod * grid) * TP
                rows = min(TP, P - p0)
                ring[s_p, :rows] = x[p0:p0 + rows]       # rows * 2 KB only
                loaded[s_p] = prod
                full[s_p].completed += 1
                prod += 1
                continue
            assert loaded[s_c] == cons      # the stage holds this tile
            p0 = (b + cons * grid) * TP
            rows = min(TP, P - p0)
            acc = torch.zeros(TP, C)
            for j in range(J):              # the views, in the order of j
                acc = acc + ring[s_c, :, j, :].float()
            out[p0:p0 + rows] = acc[:rows]
            empty[s_c].completed += 1       # every consumer warp arrived
            cons += 1
    return out


def _sum_input(P, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(P, J, C).astype(np.float32)).to(
        torch.bfloat16)


def _in_order(x):
    """The f32 sum over j taken in the order j = 0..7 (numpy)."""
    xf = x.float().numpy()
    acc = np.zeros(xf[:, 0].shape, np.float32)
    for j in range(J):
        acc = acc + xf[:, j]
    return acc


def test_sum_thread_map_covers_the_tile_once():
    assert THREADS == TP * C // VEC and THREADS % 32 == 0
    seen = torch.zeros(TP, C, dtype=torch.int32)
    for p, c0 in thread_slices():
        seen[p, c0:c0 + VEC] += 1
    assert bool((seen == 1).all())
    # a quarter-warp's 16-byte reads of a view: 128 contiguous bytes
    for q in range(0, THREADS, 8):
        addrs = [p * ROW_BYTES + c0 * 2 for p, c0 in thread_slices()[q:q + 8]]
        assert addrs == list(range(addrs[0], addrs[0] + 128, 16))
    # the ring: STAGES tiles and their two barriers each, opted in above
    # 48 KB, CTAS_PER_SM of them in the 228 KB of an SM (1 KB reserved
    # a CTA)
    smem = STAGES * TP * ROW_BYTES + 2 * STAGES * 8
    assert 2 <= STAGES <= 4 or STAGES == 1
    assert S_CTAS * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("P,sms", [(1, H100_SMS), (15, H100_SMS),
                                   (16, H100_SMS), (17, H100_SMS),
                                   (37, 1), (8449, H100_SMS), (200, 2)])
def test_sum_replay_matches_plain_version(P, sms):
    x = _sum_input(P, seed=P)
    got = replay_sum(x, sms=sms, seed=P)
    want = probes.probe_subrow_sum_ref(x)
    assert torch.isfinite(got).all()                  # every pixel written
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(1.0, want.abs().max().item()), err
    np.testing.assert_array_equal(got.numpy(), _in_order(x))


@pytest.mark.parametrize("P", [1, 16, 17, 65536])
def test_sum_tiles_per_cta(P):
    tiles = math.ceil(P / TP)
    grid = sum_grid(P)
    per = [len(range(b, tiles, grid)) for b in range(grid)]
    assert sum(per) == tiles and max(per) - min(per) <= 1
    if P <= TP:                    # the probe's P = 16: one CTA, one stage
        assert (grid, per) == (1, [1])
    if P == 65536:                 # 4,096 tiles over 396 CTAs
        assert grid == H100_SMS * S_CTAS == 396 and set(per) == {10, 11}
    # the ragged last tile copies rows * 2 KB, a multiple of 16 bytes
    rows = P - (tiles - 1) * TP
    assert 1 <= rows <= TP and rows * ROW_BYTES % 16 == 0


def test_replays_at_the_probes_inputs_against_the_jax_probes():
    """At the probes' own inputs the replays give what the JAX probe_a
    and probe_b check themselves against, and both JAX probes pass in
    interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "probe_dma2", REPO / "tools" / "probe_dma2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.probe_a() and mod.probe_b()
    x, idx = probes.probe_inputs("probe_block_gather")
    got, stores = replay_gather(x, idx)
    assert stores == [1] and torch.equal(got, x[40:48])
    (x,) = probes.probe_inputs("probe_subrow_sum")
    got = replay_sum(x)
    np.testing.assert_allclose(got.numpy(), x.float().numpy().sum(axis=1),
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", sorted(
    n for n in bench_probes.SPLITS if n.startswith(("gather_", "sum_"))))
def test_split_texts_are_in_the_sources(name):
    """bench_probes' split copies patch texts of the two sources: each
    must still be there once, or the tool raises on the card."""
    for fname, old, new in bench_probes.SPLITS[name]:
        src = (CSRC / fname).read_text()
        assert src.count(old) == 1 and old != new, (name, old)
