"""Device time of the bf16 K1 kernels at the head's shapes, for one or more
checkouts, with split readings.

    python3 -m lsnet_torch.tools.bench_k1 [--roots DIR ...] [--split]

Times ``deform_gather_contract`` (forward) and its bwd-weight kernel in
bf16 at the tower and refine calls of the main path (``chip_smoke.py``'s
``main_path_inputs``: B=2 at 800x1344, C = cout = 256, K = 9), bilinear
and nearest: CUDA events around 20 / 10 calls and the profiler's device
time of the kernel, beside the error against the plain version.

Each root is a directory holding ``lsnet_torch/`` (this checkout by
default), timed in a process of its own by this checkout's measuring code
(``tools/bench_roots.py``), so that two versions compare inside one call
on one card: unpack the parent with ``git archive <commit> lsnet_torch |
tar -x -C build/parent`` and give ``--roots build/parent . .
build/parent``.

``--split`` also times patched copies of this checkout, made under
``build/k1_split/<name>/``: ``no_gather`` (the A tiles built from zeros,
no corner row read), ``no_tma`` (no W / dout chunk copied), ``no_wgmma``
(no product issued) and ``stages4`` (four stages instead of three). Their
results are wrong by design (except ``stages4``); only their times are
read: what each part of a call costs when the others run alone.

Prints one JSON line per root, the card's name and power limit, and last
one JSON line with every root's rows.
"""

import sys

if __package__:
    from lsnet_torch.tools import bench_roots
else:   # the --one process of a root, run as a file so that the lsnet_torch
    import bench_roots      # it imports is the root's

K1_SOURCES = ("deform_gather_contract.cu",
              "deform_gather_contract_bwd_weight.cu")
# name -> (file under csrc/, text, replacement)
SPLITS = {
    "no_gather": [("k1_wgmma.cuh",
                   "raw[j][c] = __ldg(reinterpret_cast<const uint4*>(\n"
                   "            flat + (size_t)tidx[c * tbl_rows + trow0 + r]"
                   " * C + ch));",
                   "raw[j][c] = make_uint4("
                   "tidx[c * tbl_rows + trow0 + r], 0u, 0u, 0u);")],
    "no_tma": [(f, old, new) for f in K1_SOURCES for old, new in (
        ("mbar_expect(bar_, boxes * BOX_BYTES);", "mbar_expect(bar_, 0);"),
        ("for (int q = 0; q < boxes; ++q)", "for (int q = 0; q < 0; ++q)"))],
    "no_wgmma": [("k1_wgmma.cuh",
                  "wgmma_m64n256k16<A_MN ? 1 : 0, 1>(acc, da, db);",
                  "(void)da; (void)db;")],
    "stages4": [("k1_wgmma.cuh", "constexpr int STAGES = 3;",
                 "constexpr int STAGES = 4;")],
}


def time_root(root):
    """The rows of one checkout (run in a process of its own)."""
    cs = bench_roots.import_root(root)
    import torch
    from lsnet_torch import _build
    from lsnet_torch.ops import deform_gather as dg

    _build.build(["deform_gather_contract",
                  "deform_gather_contract_bwd_weight"])
    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for sampling in ("bilinear", "nearest"):
        for site, args in zip(("tower", "refine"),
                              cs.main_path_inputs(torch.bfloat16, gen,
                                                  sampling)):
            flat, idx, w, weight = args
            dout = torch.randn(idx.shape[2], weight.shape[2], device="cuda",
                               generator=cgen).to(flat.dtype)

            def fwd():
                return dg.deform_gather_contract(*args)

            def wgt():
                return dg.deform_gather_contract_bwd_weight(
                    flat, idx, w, weight, dout)

            row = {}
            for key, fn, ref, kernel, iters in (
                    ("fwd", fwd,
                     lambda: dg.deform_gather_contract_ref(*args), "dgc_",
                     20),
                    ("bwd_weight", wgt,
                     lambda: dg.deform_gather_contract_bwd_weight_ref(
                         flat, idx, w, dout), "bwd_weight_kernel", 10)):
                got, want = fn().float(), ref().float()
                row[f"{key}_rel_err"] = ((got - want).abs().max().item()
                                         / max(1.0, want.abs().max().item()))
                del got, want
                row[f"{key}_ms"] = cs.cuda_ms(fn, iters)
                row[f"{key}_device_ms"] = cs.kernel_device_us(
                    fn, kernel, 5) / 1e3
            rows[f"{site} {sampling}"] = row
            del args, flat, idx, w, weight, dout
            torch.cuda.empty_cache()
    return rows


def main(argv=None):
    return bench_roots.main(__file__, __doc__, time_root, SPLITS,
                            "k1_split", argv)


if __name__ == "__main__":
    sys.exit(main())
