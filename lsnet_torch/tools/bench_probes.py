"""Device time of the four probe kernels, for one or more checkouts, with
split readings.

    python3 -m lsnet_torch.tools.bench_probes [--roots DIR ...]
        [--split [NAME ...]]

Times each probe kernel of ``lsnet_torch.ops.probes`` at the JAX probes'
inputs, and at sizes where bytes set the time: ``probe_block_gather`` at
``chip_smoke.COPY_RATE_ROWS`` (147,456) random 2,048-byte blocks of a
64 MB table, warm and with the L2 cold before each call
(``chip_smoke.cold_device_us``: the lines kept by evict_last policies
reset, then 256 MB written), ``probe_subrow_sum`` at P = 65,536 and
``probe_subrow_dot`` at P = 16,384 (seeded normals, the inputs of
``chip_smoke.py``'s phase 2e), each beside one PyTorch call that computes
the same function on the same inputs (``chip_smoke.probe_library_call``:
``torch.narrow_copy``, ``torch.index_select``, ``torch.sum``,
``torch.mm(out_dtype=f32)``). Device times come from the profiler
(``chip_smoke.kernel_device_us``, the kernels whose name the row gives,
20 calls), since at the probes' own sizes CUDA events around the calls
time the host's launch rate. Every round times every row once; each row
prints the median, the smallest and the largest of 5 rounds. Each result
is held against the plain version: the copies exactly, the dot at the
probe tool's tolerance and the two large sub-row rows at 1e-5 of max(1,
max|ref|) with two launches equal bit for bit, and the row copy once
more over 1,000 launches of different rows.

Each root is a directory holding ``lsnet_torch/`` (this checkout by
default), timed in a process of its own by this checkout's measuring code
(``tools/bench_roots.py``), so that two versions compare inside one call
on one card: unpack the parent with ``git archive <commit> lsnet_torch |
tar -x -C build/parent`` and give ``--roots build/parent . .
build/parent``.

``--split`` also times patched copies of this checkout (all of them, or
the ones named), made under ``build/probe_split/<name>/``. Of the row
copy: ``proxy_fence`` (the barrier's init fenced by
``fence.proxy.async.shared::cta``), ``no_init_fence`` (no fence after the
init), ``warp_store`` (the row written out by 16-byte stores of the warp
instead of the bulk store), ``lane0_only`` (lanes 1 to 31 leave at once),
``full_store_wait`` (``wait_group 0`` instead of ``wait_group.read 0``),
``no_bulk_store`` (nothing written out) and ``no_bulk_load`` (no copy in,
the barrier expects no bytes). Of the block gather's ring:
``gather_no_policy`` (no L2 cache hints on the loads and stores),
``gather_one_stage`` (one stage: each load waits for the last store's
read), ``gather_no_bulk_store`` (nothing written out) and
``gather_no_index_prefetch`` (lane 0 reads each index from device memory
right before its load), ``gather_ring32_ctas4``,
``gather_ring32_ctas2`` and ``gather_ring16_ctas12`` (other ring sizes and
CTAs an SM) and ``gather_no_one_shape`` (n = 1 through the ring). Of the
sub-row sum's ring: ``sum_one_stage`` (one tile in shared memory: copy
and sums in turn), ``sum_scalar_reads`` (the views read as 2-byte
scalars) and ``sum_evict_first`` (x loaded with an L2 evict_first
policy). Of the dot's
launch shapes: ``small_tp128`` (128-pixel tiles and no depth slices in
the small shape), ``small_nq4`` (4 column slices, 4 depth slices),
``small_only`` (the small shape at every P), ``large_tp64`` (64-pixel
tiles in the large shape, two blocks an SM), ``large_stages3`` (a
three-stage ring, with the wait it needs). Of the dot's parts:
``no_x_copy`` and ``no_w_copy`` (x or w not staged), ``no_product`` (no
WMMA product), ``no_reduce`` (each rank sums its own partial 8 times, no
distributed shared memory read) and ``no_cluster_wait`` (a block barrier
in place of the cluster barrier before the reads). ``no_bulk_store``,
``no_bulk_load``, ``gather_no_bulk_store`` and the dot's parts are wrong
by design: only their times are read.

Prints one JSON line per root, the card's name and power limit, and last
one JSON line with every root's rows.
"""

import statistics
import sys

if __package__:
    from lsnet_torch.tools import bench_roots
else:   # the --one process of a root, run as a file so that the lsnet_torch
    import bench_roots      # it imports is the root's

ITERS = 20
ROUNDS = 5
# name -> (file under csrc/, text, replacement)
SPLITS = {
    "proxy_fence": [("probe_row_copy.cu",
                     "fence.mbarrier_init.release.cluster;",
                     "fence.proxy.async.shared::cta;")],
    "no_init_fence": [("probe_row_copy.cu",
                       'asm volatile("fence.mbarrier_init.release.cluster;'
                       '\\n" ::: "memory");', "")],
    "warp_store": [("probe_row_copy.cu",
                    "  if (threadIdx.x == 0) {\n"
                    "    // Only the async proxy",
                    "  for (int i = threadIdx.x * 16; i < row_bytes; "
                    "i += 32 * 16)\n"
                    "    *reinterpret_cast<uint4*>(out + i) =\n"
                    "        *reinterpret_cast<const uint4*>(row + i);\n"
                    "  if (false) {\n"
                    "    // Only the async proxy")],
    "lane0_only": [("probe_row_copy.cu",
                    "  __syncwarp();                 // the other lanes",
                    "  if (threadIdx.x) return;  // the other lanes")],
    "full_store_wait": [("probe_row_copy.cu",
                         "cp.async.bulk.wait_group.read 0;",
                         "cp.async.bulk.wait_group 0;")],
    "no_bulk_store": [("probe_row_copy.cu",
                       "    bulk_copy_s2g(out, smem_addr(row), row_bytes);",
                       "")],
    "no_bulk_load": [("probe_row_copy.cu",
                      "    mbar_arrive_expect(bar, row_bytes);\n"
                      "    bulk_copy_g2s(smem_addr(row), x, row_bytes, bar);",
                      "    mbar_arrive_expect(bar, 0);")],
    "gather_no_policy": [
        ("probe_block_gather.cu",
         '".L2::cache_hint [%0], [%1], %2, [%3], %4;\\n"',
         '" [%0], [%1], %2, [%3];\\n"'),
        ("probe_block_gather.cu",
         '"cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"\n'
         '      " [%0], [%1], %2, %3;\\n"',
         '"cp.async.bulk.global.shared::cta.bulk_group"\n'
         '      " [%0], [%1], %2;\\n"')],
    "gather_one_stage": [("probe_block_gather.cu", "MAX_STAGES = 32;",
                          "MAX_STAGES = 1;")],
    "gather_no_bulk_store": [
        ("probe_block_gather.cu",
         "      bulk_store(out + static_cast<size_t>(lo + k) * block_bytes,\n"
         "                 ring0 + s * block_bytes, block_bytes, stream);\n",
         "")],
    "gather_no_index_prefetch": [
        ("probe_block_gather.cu",
         "const int b = __shfl_sync(0xffffffffu, cur, at++);",
         "const int b =\n"
         "        min(max(idx[lo + IDX_CHUNK * c + at++], 0), nblocks - 1);")],
    "gather_ring32_ctas4": [("probe_block_gather.cu", "RING_BYTES = 24576;",
                             "RING_BYTES = 32768;"),
                            ("probe_block_gather.cu", "CTAS_PER_SM = 8;",
                             "CTAS_PER_SM = 4;")],
    "gather_ring32_ctas2": [("probe_block_gather.cu", "RING_BYTES = 24576;",
                             "RING_BYTES = 32768;"),
                            ("probe_block_gather.cu", "CTAS_PER_SM = 8;",
                             "CTAS_PER_SM = 2;")],
    "gather_ring16_ctas12": [("probe_block_gather.cu", "RING_BYTES = 24576;",
                              "RING_BYTES = 16384;"),
                             ("probe_block_gather.cu", "CTAS_PER_SM = 8;",
                              "CTAS_PER_SM = 12;")],
    "gather_no_one_shape": [("probe_block_gather.cu", "  if (n == 1) {",
                             "  if (false) {")],
    "sum_evict_first": [
        ("probe_subrow_sum.cu",
         '"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"'
         '\n      " [%0], [%1], %2, [%3];\\n"',
         '"{\\n.reg .b64 pol;\\n"\n'
         '      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"\n'
         '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::'
         'bytes"\n'
         '      ".L2::cache_hint [%0], [%1], %2, [%3], pol;\\n}\\n"')],
    "sum_one_stage": [("probe_subrow_sum.cu", "STAGES = 2;",
                       "STAGES = 1;")],
    "sum_scalar_reads": [
        ("probe_subrow_sum.cu",
         "  return *reinterpret_cast<const uint4*>(v);",
         "  const volatile unsigned short* h =\n"
         "      reinterpret_cast<const volatile unsigned short*>(v);\n"
         "  uint32_t w[4];\n"
         "  for (int i = 0; i < 4; ++i)\n"
         "    w[i] = h[2 * i] | (static_cast<uint32_t>(h[2 * i + 1]) << 16);\n"
         "  return make_uint4(w[0], w[1], w[2], w[3]);")],
    "small_tp128": [("probe_subrow_dot.cu", "SMALL_TP = 16, SMALL_NQ = 8, "
                     "SMALL_JB = 1, SMALL_KS = 8;", "SMALL_TP = 128, "
                     "SMALL_NQ = 8, SMALL_JB = 1, SMALL_KS = 1;")],
    "small_nq4": [("probe_subrow_dot.cu", "SMALL_NQ = 8, SMALL_JB = 1, "
                   "SMALL_KS = 8;", "SMALL_NQ = 4, SMALL_JB = 1, "
                   "SMALL_KS = 4;")],
    "small_only": [("probe_subrow_dot.cu",
                    "if ((P + LARGE_MIN_PX - 1) / LARGE_MIN_PX >= sms)",
                    "if (false)")],
    "large_tp64": [("probe_subrow_dot.cu", "LARGE_TP = 128,",
                    "LARGE_TP = 64,")],
    "large_stages3": [("probe_subrow_dot.cu", "LARGE_STAGES = 2;",
                       "LARGE_STAGES = 3;"),
                      ("probe_subrow_dot.cu", "  if (pending == 1)\n",
                       "  if (pending >= 2)\n    asm volatile("
                       "\"cp.async.wait_group 2;\\n\" ::: \"memory\");\n"
                       "  else if (pending == 1)\n")],
    "no_x_copy": [("probe_subrow_dot.cu",
                   "i < rows * XP; i += THREADS)\n    copy16(xs",
                   "i < 0; i += THREADS)\n    copy16(xs")],
    "no_w_copy": [("probe_subrow_dot.cu",
                   "i < C * WP; i += THREADS)", "i < 0; i += THREADS)")],
    "no_product": [("probe_subrow_dot.cu",
                    "wmma::mma_sync(acc[k], fa, fb, acc[k]);", "(void)fa;")],
    "no_reduce": [("probe_subrow_dot.cu", "v[r] = peer[r][i];",
                   "v[r] = reinterpret_cast<const float4*>(part)[i];")],
    "no_cluster_wait": [("probe_subrow_dot.cu",
                         "cluster.sync();                         "
                         "// every partial", "__syncthreads();  // every "
                         "partial")],
}


def spread(values):
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "rounds": values}


def time_root(root):
    """The rows of one checkout (run in a process of its own)."""
    cs = bench_roots.import_root(root)
    import torch
    from lsnet_torch import _build
    from lsnet_torch.ops import probes
    from lsnet_torch.tools import probe as probe_tool

    torch.backends.cuda.matmul.allow_tf32 = False
    logs = _build.build(probes.PROBES)
    dev = torch.device("cuda")
    # (label, probe, inputs, held to: None exact, "large" 1e-5 of max(1,
    # max|ref|) and a bit repeat, "tool" the probe tool's tolerance)
    cases = [(name, name, [a.to(dev) for a in probes.probe_inputs(name)],
              "tool") for name in probes.PROBES]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, P in (("probe_subrow_dot", cs.LARGE_DOT_P),
                    ("probe_subrow_sum", cs.LARGE_SUM_P)):
        cases.append((f"{name} P={P}", name,
                      cs.large_probe_inputs(name, P, gen), "large"))
    rate = cs.copy_rate_inputs(torch.Generator(device="cuda").manual_seed(4))
    rate_label = f"probe_block_gather n={cs.COPY_RATE_ROWS}"
    cases.append((rate_label, "probe_block_gather", rate, None))

    rows = {}
    for label, name, args, held in cases:
        fn = getattr(probes, name)
        got = fn(*args)
        want = getattr(probes, name + "_ref")(*args)
        tol = probe_tool.TOLERANCES[name]
        if held == "large":
            scale = max(1.0, want.abs().max().item())
            ok = ((got - want).abs().max().item() <= 1e-5 * scale
                  and torch.equal(got, fn(*args)))
        elif held is None or tol is None:
            ok = torch.equal(got, want)
        else:
            ok = torch.allclose(got, want, rtol=tol[0], atol=tol[1])
        rows[label] = {"ok": bool(ok), "kernel": [], "library": []}
        del got, want
    rows[rate_label].update(cold=[], library_cold=[])
    # the row copy over 1,000 launches, each of another row
    many = torch.randn(1000, 2, 128, device=dev, generator=gen)
    outs = torch.stack([probes.probe_row_copy(many[i]) for i in range(1000)])
    rows["probe_row_copy"]["ok_1000_launches"] = bool(
        torch.equal(outs[:, 0], many[:, 0]))

    for _ in range(ROUNDS):
        for label, name, args, _ in cases:
            fn = getattr(probes, name)
            library = cs.probe_library_call(name, args)
            row = rows[label]
            row["kernel"].append(cs.kernel_device_us(
                lambda: fn(*args), f"{name}_kernel", ITERS))
            # the library call on its own L2 lines, not on the table lines
            # the block gather's evict_last loads leave behind
            cs.reset_persisting_l2()
            row["library"].append(cs.kernel_device_us(library, "", ITERS))
            if label == rate_label:
                row["cold"].append(cs.cold_device_us(
                    lambda: fn(*args), f"{name}_kernel", ITERS))
                row["library_cold"].append(cs.cold_device_us(
                    library, "", ITERS))
    for row in rows.values():
        row["device_us"] = spread(row.pop("kernel"))
        row["library_device_us"] = spread(row.pop("library"))
        if "cold" in row:
            row["cold_device_us"] = spread(row.pop("cold"))
            row["library_cold_device_us"] = spread(row.pop("library_cold"))
    # the host records of every profile that lost its device records and
    # was taken again (chip_smoke.kernel_device_us)
    rows["lost_profiles"] = cs.LOST_PROFILES
    rows["ptxas"] = {name: [ln.strip() for ln in out.splitlines()
                            if "registers" in ln or "spill" in ln]
                     for name, out in logs.items()}
    return rows


def main(argv=None):
    return bench_roots.main(__file__, __doc__, time_root, SPLITS,
                            "probe_split", argv)


if __name__ == "__main__":
    sys.exit(main())
