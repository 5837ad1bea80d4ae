"""Device time of the bf16 grouped backbone DCN forward at the X-101 shapes,
for one or more checkouts, with split readings.

    python3 -m lsnet_torch.tools.bench_grouped [--roots DIR ...] [--split]

Times ``deform_gather_grouped_contract`` (the kernel ``gdc_bf16`` of
``csrc/grouped_deform_contract.cu``) in bf16 at the six calls of
X-101-64x4d-DCN (stages c3, c4, c5 at stride 1 and the stride-2 first
block; ``chip_smoke.grouped_inputs``, B=2 at 800x1344, G=64), nearest
(inference) and bilinear (training). Device times come from the profiler
(``chip_smoke.kernel_device_us``, 20 calls); every round times every case
once, and each case prints the median, smallest and largest of 5 rounds,
then one reading with the L2 cold: a write of 256 MB before each call (the
write's own kernel is not counted). Beside each case: the error against
the plain version (relative to max(1, max|ref|)) and the byte bound; per
stage, the library yardstick, one ``einsum("pkgc,kcgj->pgj")`` on an
already gathered patch tensor as phase 2b of ``chip_smoke.py`` times it;
and the sums per forward (per stage one stride-2 call and n - 1 stride-1
calls, 30 in all): nearest is the inference forward, bilinear the train
step's.

Each root is a directory holding ``lsnet_torch/`` (this checkout by
default), timed in a process of its own by this checkout's measuring code
(``tools/bench_roots.py``), so that two versions compare inside one call
on one card: unpack the parent with ``git archive <commit> lsnet_torch |
tar -x -C build/parent`` and give ``--roots build/parent . .
build/parent``.

``--split`` also times patched copies of this checkout, made under
``build/grouped_split/<name>/``. Parts taken away, which read wrong by
design (only their times count): ``no_gather`` (no corner row copied: the
ring's rows stay as they are), ``no_a_load`` (the A fragments not read
from the ring, weighted all the same), ``no_b`` (no weight row copied),
``no_product`` (no product issued, and with it no A weighting) and
``no_store`` (the output tile not written out). Other designs, which read right: ``generic`` (the general
products, which find the groups at run time, in place of those fixed for
Cg == outG), ``stages3`` and ``stages4`` (a ring of three or four steps
instead of two), ``cg`` (the corner rows copied past L1,
``cp.async.cg``), ``blocks5`` (registers capped for five blocks an SM),
``w_once`` (every step's weight rows copied once at block start, not
through the ring) and ``px128`` (128-px blocks of 8 warps).

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
FLUSH_BYTES = 256 << 20          # larger than the H100's 50 MB L2
KERNEL = "gdc_bf16"
GDC = "grouped_deform_contract.cu"
ASYNC = "async_mma.cuh"            # cp.async, ldmatrix, mma of both kernels
# name -> [(file under csrc/, text, replacement)]
SPLITS = {
    "no_gather": [(GDC, "cp_async16(slot + cr * SW + swz<SW>(cr, j) * 8,\n"
                   "                   src + (size_t)row * C + j * 8);",
                   "(void)row;")],
    "no_a_load": [(GDC, "ldsm_x4(r, slot + (c * PX + row) * SW + "
                   "swz<SW>(c * PX + row, j) * 8);",
                   "r[0] = r[1] = r[2] = r[3] = lane;")],
    "no_b": [(GDC, "cp_async16(dst + q * LDS + j * 8,\n"
              "                 W + ((size_t)k * Cg + (wbase + q) % Cg) * cout"
              " + n0 + j * 8);", "(void)wbase;")],
    "no_product": [(ASYNC, '  asm volatile("mma.sync.aligned.m16n8k16',
                    '  if (false) asm volatile("mma.sync.aligned.m16n8k16')],
    "generic": [(GDC, "p.cg = Cg == outG && (Cg == 8 || Cg == 16 || Cg == 32)"
                 " ? Cg : 0;", "p.cg = 0;")],
    "no_store": [(GDC, "if (p < px)\n      *reinterpret_cast<uint4*>(out",
                  "if (p < px && acc[0][0] == 1.2345e30f)\n"
                  "      *reinterpret_cast<uint4*>(out")],
    **{f"stages{n}": [(GDC, "constexpr int STAGES = 2;",
                        f"constexpr int STAGES = {n};")] for n in (3, 4)},
    "cg": [(ASYNC, "cp.async.ca.shared.global [%0], [%1], 16;",
            "cp.async.cg.shared.global [%0], [%1], 16;")],
    "blocks5": [(GDC, "__global__ void __launch_bounds__(GT)\ngdc_bf16",
                 "__global__ void __launch_bounds__(GT, 5)\ngdc_bf16")],
    # every step's weight rows copied once, at block start, into a region
    # of their own after the ring (all K taps where the tile is one slice)
    "w_once": [
        (GDC, "const int slot_elems = rows_elems + WR * LDS;",
         "const int slot_elems = rows_elems;"),
        (GDC, "      copy_w(t, slot + rows_elems);\n", ""),
        (GDC, "  for (int u = 0; u < STAGES - 1; ++u) issue(u);",
         "  for (int u = 0; u < steps; ++u)\n"
         "    copy_w(u, ring + STAGES * slot_elems + u * WR * LDS);\n"
         "  for (int u = 0; u < STAGES - 1; ++u) issue(u);"),
        (GDC, "const __nv_bfloat16* wrow = slot + rows_elems;",
         "const __nv_bfloat16* wrow = ring + STAGES * slot_elems"
         " + t * WR * LDS;"),
        (GDC, "const size_t ring = (size_t)STAGES * (nc * PX * p.sw + p.wr * "
         "LDS) * 2;",
         "const size_t ring = ((size_t)STAGES * nc * PX * p.sw\n"
         "                      + (size_t)K * (S / p.sw) * p.wr * LDS) * 2;"),
    ],
    # 128 px a block, 8 warps
    "px128": [(GDC, "constexpr int PX = BM;", "constexpr int PX = 128;")],
}


def spread(values):
    return {"median": statistics.median(values), "min": min(values),
            "max": max(values), "rounds": values}


def time_root(root):
    """The rows of one checkout (run in a process of its own)."""
    cs = bench_roots.import_root(root)
    import torch
    from lsnet_torch import _build
    from lsnet_torch.ops import flat_deform as fd
    from lsnet_torch.ops import grouped as gr

    logs = _build.build(["grouped_deform_contract"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, stage_n, library = {}, {}, {}
    rows = {}
    for stage, out_hw, C, n in cs.X101_STAGES:
        stage_n[stage] = n
        for stride in (1, 2):
            levels, job, weight32 = cs.grouped_inputs(gen, out_hw, C, stride)
            flat = levels.flat.to(torch.bfloat16).contiguous()
            weight = weight32.to(torch.bfloat16).contiguous()
            for sampling in ("nearest", "bilinear"):
                idx, w = fd._gather_indices_tap(levels, [job], cs.K,
                                                sampling)
                args = (flat, idx, w, weight, cs.GROUPS)
                got = gr.deform_gather_grouped_contract(*args).float()
                want = gr.deform_gather_grouped_contract_ref(*args).float()
                label = f"{stage} s{stride} {sampling}"
                rows[label] = {
                    "rel_err": ((got - want).abs().max().item()
                                / max(1.0, want.abs().max().item())),
                    "finite": bool(torch.isfinite(got).all()),
                    "bound_ms": cs.bound_ms(args)[0], "px": idx.shape[2],
                    "kernel": []}
                del got, want
                cases[label] = args
            del levels, job, weight32
        px = cs.B * out_hw[0] * out_hw[1]
        cg = C // cs.GROUPS
        vals = torch.randn(px, cs.K, cs.GROUPS, cg, device="cuda",
                           generator=gen, dtype=torch.bfloat16)
        wg = torch.randn(cs.K, cg, cs.GROUPS, cg, device="cuda",
                         generator=gen, dtype=torch.bfloat16)
        library[stage] = (vals, wg)
        rows[f"{stage} library"] = {"kernel": []}
    torch.cuda.empty_cache()

    for _ in range(ROUNDS):
        for label, args in cases.items():
            rows[label]["kernel"].append(cs.kernel_device_us(
                lambda: gr.deform_gather_grouped_contract(*args), KERNEL,
                ITERS))
        for stage, (vals, wg) in library.items():
            rows[f"{stage} library"]["kernel"].append(cs.kernel_device_us(
                lambda: torch.einsum("pkgc,kcgj->pgj", vals, wg), "",
                ITERS))
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    for label, args in cases.items():
        def cold():
            flush.zero_()
            return gr.deform_gather_grouped_contract(*args)
        rows[label]["cold_device_us"] = cs.kernel_device_us(cold, KERNEL,
                                                            ITERS)
    for row in rows.values():
        row["device_us"] = spread(row.pop("kernel"))

    def per_forward(sampling, key="median"):
        """ms of the 30 calls of one forward: one stride-2 call and n - 1
        stride-1 calls per stage."""
        def us(stage, stride):
            row = rows[f"{stage} s{stride} {sampling}"]
            return row["cold_device_us"] if key == "cold" \
                else row["device_us"][key]
        return sum(us(st, 2) + (n - 1) * us(st, 1)
                   for st, n in stage_n.items()) / 1e3

    rows["per_forward_ms"] = {
        f"{sampling} {key}": per_forward(sampling, key)
        for sampling in ("nearest", "bilinear")
        for key in ("median", "min", "max", "cold")}
    rows["per_forward_ms"]["bound"] = sum(
        rows[f"{st} s2 nearest"]["bound_ms"]
        + (n - 1) * rows[f"{st} s1 nearest"]["bound_ms"]
        for st, n in stage_n.items())
    rows["per_forward_ms"]["library"] = sum(
        n * rows[f"{st} library"]["device_us"]["median"]
        for st, n in stage_n.items()) / 1e3
    rows["ptxas"] = cs.ptxas_summary(
        logs.get("grouped_deform_contract", ""), KERNEL)
    rows["lost_profiles"] = cs.LOST_PROFILES
    return rows


def main(argv=None):
    return bench_roots.main(__file__, __doc__, time_root, SPLITS,
                            "grouped_split", argv)


if __name__ == "__main__":
    sys.exit(main())
