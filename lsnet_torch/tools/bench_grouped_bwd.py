"""Device time of the bf16 grouped backbone DCN bwd-weight at the X-101
shapes, for one or more checkouts, with split readings.

    python3 -m lsnet_torch.tools.bench_grouped_bwd [--roots DIR ...] [--split]

Times ``deform_gather_grouped_contract_bwd_weight`` (the kernel
``gdw_bf16`` of ``csrc/grouped_deform_contract_bwd_weight.cu``; in a
checkout from before it, the generic ``bwd_weight_kernel`` of
``csrc/deform_bwd.cuh``) in bf16 at the six calls
of X-101-64x4d-DCN that ``bench_grouped`` times (stages c3, c4, c5 at
stride 1 and the stride-2 first block), bilinear only (the train step; no
training path samples nearest), with a random bf16 dout. As
``bench_grouped``: the median, smallest and largest of 5 rounds of 20
calls of profiler device time, one reading with the L2 cold, the error
against the plain version (relative to max(1, max|ref|)) and the byte
bound (``chip_smoke.work_bwd_weight``); per stage the library yardstick,
one ``einsum("pkgc,pgj->kcgj")`` on an already gathered patch tensor as
phase 2d of ``chip_smoke.py`` times it; and the sums per train step (per
stage one stride-2 call and n - 1 stride-1 calls, 30 in all).

Roots as in ``bench_grouped`` (``tools/bench_roots.py``): ``--roots
build/parent . . build/parent`` compares a parent with this checkout in
one call. ``--split`` also times patched copies of this checkout, made
under ``build/grouped_bwd_split/<name>/``. Parts taken away, which read
wrong by design (only their times count): ``no_rows`` (no corner row
copied), ``no_dout`` (no dout tile copied), ``no_product`` (no weighting
and no product) and ``no_atomics`` (no add into d_W). Other designs, which
read right: ``taps1`` (one tap a block, each dout tile copied per tap, in
place of three), ``stages3`` (a ring of three steps), ``cg`` (rows and
dout copied past L1, ``cp.async.cg``) and ``one_wave`` (px shares chosen
for one block an SM, fewer shares and adds).

Prints one JSON line per root, the card's name and power limit, and last
one JSON line with every root's rows.
"""

import os
import sys

if __package__:
    from lsnet_torch.tools import bench_grouped as bg, bench_roots
else:   # the --one process of a root, run as a file so that the lsnet_torch
    import bench_grouped as bg      # it imports is the root's
    import bench_roots

KERNEL = "gdw_bf16"
GENERIC = "bwd_weight_kernel"    # the only bf16 route before gdw_bf16
BWD = "grouped_deform_contract_bwd_weight.cu"
# name -> [(file under csrc/, text, replacement)]
SPLITS = {
    "no_rows": [(BWD, "cp_async16z(slot + cr * BN + swz<64>(cr, ch) * 8,\n"
                 "                      flat + (size_t)s_idx[cr] * C + n0 + "
                 "ch * 8,\n                      p0 + cr % PXT < px);",
                 "(void)s_idx;")],
    "no_dout": [(BWD, "cp_async16z(dst + r * BN + swz<64>(r, ch) * 8,",
                 "if (false) cp_async16z(dst + r * BN + swz<64>(r, ch) * 8,")],
    "no_product": [(BWD, "mma16816(acc[tau][h], a, b0);\n"
                    "          mma16816(acc[tau][h + 1], a, b1);",
                    "(void)b0;\n          (void)b1;")],
    "no_atomics": [(BWD, "  atomicAdd(reinterpret_cast<float2*>(p), "
                    "make_float2(x, y));",
                    "  if (x == 1.2345e30f)\n"
                    "    atomicAdd(reinterpret_cast<float2*>(p), "
                    "make_float2(x, y));")],
    "taps1": [(BWD, "constexpr int TAPS = 3;", "constexpr int TAPS = 1;"),
              ("../ops/grouped.py", "GDW_TAPS = 3", "GDW_TAPS = 1")],
    "stages3": [(BWD, "constexpr int STAGES = 2;         // steps of the ring",
                 "constexpr int STAGES = 3;         // steps of the ring")],
    "cg": [(bg.ASYNC, "cp.async.ca.shared.global [%0], [%1], 16, %2;",
            "cp.async.cg.shared.global [%0], [%1], 16, %2;")],
    "one_wave": [("../ops/grouped.py", "px,\n                              2, "
                  "GDW_TAPS)", "px,\n                              1, "
                  "GDW_TAPS)")],
}


def time_root(root):
    """The rows of one checkout (run in a process of its own)."""
    cs = bench_roots.import_root(root)
    import torch
    from lsnet_torch import _build
    from lsnet_torch.ops import flat_deform as fd
    from lsnet_torch.ops import grouped as gr

    logs = _build.build(["grouped_deform_contract_bwd_weight"])
    with open(os.path.join(root, "lsnet_torch", "csrc", BWD)) as f:
        kernel = KERNEL if KERNEL in f.read() else GENERIC
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, stage_n, library, rows = {}, {}, {}, {}
    for stage, out_hw, C, n in cs.X101_STAGES:
        stage_n[stage] = n
        for stride in (1, 2):
            levels, job, weight32 = cs.grouped_inputs(gen, out_hw, C, stride)
            flat = levels.flat.to(torch.bfloat16).contiguous()
            weight = weight32.to(torch.bfloat16).contiguous()
            idx, w = fd._gather_indices_tap(levels, [job], cs.K, "bilinear")
            px = idx.shape[2]
            dout = torch.randn(px, C, device="cuda", generator=gen).to(
                torch.bfloat16)
            args = (flat, idx, w, weight, dout, cs.GROUPS)
            got = gr.deform_gather_grouped_contract_bwd_weight(*args).float()
            want = gr.deform_gather_grouped_contract_bwd_weight_ref(
                flat, idx, w, dout, cs.GROUPS).float()
            label = f"{stage} s{stride} bilinear"
            rows[label] = {
                "rel_err": ((got - want).abs().max().item()
                            / max(1.0, want.abs().max().item())),
                "finite": bool(torch.isfinite(got).all()),
                "bound_ms": cs.bound_ms(args[:4], cs.work_bwd_weight)[0],
                "px": px, "kernel": []}
            del got, want, levels, job, weight32
            cases[label] = args
        px = cs.B * out_hw[0] * out_hw[1]
        cg = C // cs.GROUPS
        vals = torch.randn(px, cs.K, cs.GROUPS, cg, device="cuda",
                           generator=gen, dtype=torch.bfloat16)
        dout = torch.randn(px, cs.GROUPS, cg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        library[stage] = (vals, dout)
        rows[f"{stage} library"] = {"kernel": []}
    torch.cuda.empty_cache()

    for _ in range(bg.ROUNDS):
        for label, args in cases.items():
            rows[label]["kernel"].append(cs.kernel_device_us(
                lambda: gr.deform_gather_grouped_contract_bwd_weight(*args),
                kernel, bg.ITERS))
        for stage, (vals, dout) in library.items():
            rows[f"{stage} library"]["kernel"].append(cs.kernel_device_us(
                lambda: torch.einsum("pkgc,pgj->kcgj", vals, dout), "",
                bg.ITERS))
    flush = torch.empty(bg.FLUSH_BYTES // 4, device="cuda")
    for label, args in cases.items():
        def cold():
            flush.zero_()
            return gr.deform_gather_grouped_contract_bwd_weight(*args)
        rows[label]["cold_device_us"] = cs.kernel_device_us(cold, kernel,
                                                            bg.ITERS)
    for row in rows.values():
        row["device_us"] = bg.spread(row.pop("kernel"))

    def per_step(key):
        """ms of the 30 calls of one train step: one stride-2 call and
        n - 1 stride-1 calls per stage."""
        def us(stage, stride):
            row = rows[f"{stage} s{stride} bilinear"]
            return row["cold_device_us"] if key == "cold" \
                else row["device_us"][key]
        return sum(us(st, 2) + (n - 1) * us(st, 1)
                   for st, n in stage_n.items()) / 1e3

    rows["per_step_ms"] = {key: per_step(key)
                           for key in ("median", "min", "max", "cold")}
    rows["per_step_ms"]["bound"] = sum(
        rows[f"{st} s2 bilinear"]["bound_ms"]
        + (n - 1) * rows[f"{st} s1 bilinear"]["bound_ms"]
        for st, n in stage_n.items())
    rows["per_step_ms"]["library"] = sum(
        n * rows[f"{st} library"]["device_us"]["median"]
        for st, n in stage_n.items()) / 1e3
    rows["kernel"] = kernel
    rows["ptxas"] = cs.ptxas_summary(
        logs.get("grouped_deform_contract_bwd_weight", ""), kernel)
    rows["lost_profiles"] = cs.LOST_PROFILES
    return rows


def main(argv=None):
    return bench_roots.main(__file__, __doc__, time_root, SPLITS,
                            "grouped_bwd_split", argv)


if __name__ == "__main__":
    sys.exit(main())
