"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. build every CUDA kernel of the port from ``lsnet_torch/csrc`` (one
   ``nvcc`` per source, started together), timed;
2. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it (f32 with TF32 off, and bf16; nearest and bilinear),
   and time both: (a) ``deform_gather_contract`` at the head's tower and
   refine calls, (b) ``deform_gather_grouped_contract`` at the three
   grouped DCN stages of X-101-64x4d (stride 1 and the stride-2 first
   block), (c) and (d) the bwd-data and bwd-weight kernels of each at the
   same shapes; beside each, as a yardstick, one PyTorch einsum on the
   already gathered patch tensor (for bwd-data: G alone); with the
   bwd-data kernels' split readings (both outputs,
   one output at a time, a table without and with full contention, the
   memset and cast around the launch), (e) the four probe kernels at the
   probes' own inputs and tolerances, kernel, plain version and library
   call also by device time, each launch under a host-side time limit,
   ``probe_block_gather`` also at 147,456 random rows with its byte bound,
   then the checks of ``lsnet_torch.tools.probe`` in-process with the
   probes' launch counts read around them;
3. check the port on the card against the port on the CPU on small inputs
   (a narrow R50-shaped model, and a narrow ResNeXt-shaped model for each
   of the four tasks, f32): (a) the head outputs, (b) the training loss
   and every parameter's gradient (ResNeXt-shaped, each task);
4. drive the main paths, each with the kernels' launch counts set to 0
   just before and read just after: (a) ``inference_detector`` (forward +
   decode + NMS, the shipped inference sampling) on a batch of two
   800x1344 images, seeded random bf16 weights, for the full-width
   LSNet-R50 flagship and the full-width LSNet X-101-64x4d-DCN in the
   bbox, segm and pose_bbox tasks; (b) train steps of the full-width
   X-101-64x4d-DCN, bbox and pose_bbox, on the same batch size and canvas
   (bf16 over f32 master weights, bilinear at every site, 20 seeded
   instances per image: boxes, 36-point contours, 17 keypoints with
   visibility), asserting the launch counts per step, a finite loss, that
   trainable parameters moved and frozen ones did not;
5. profile one forward + decode of each, and one train step of each, for
   the device time by kernel.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
(all ten kernels) and, last, ``{"ok": true, "device": {...}}``; the
card's clocks, power draw and temperature are logged before and after
phases 2c, 2d and the profiled train steps. ``python3 chip_smoke.py --only
backward`` builds, runs phases 2c and 2d alone and prints no result line
(for work on the backward kernels). With
``CHIP_SMOKE_LOG=<path>`` in the environment it also writes every line it
prints to that file. It needs the repository
around it and a CUDA device, and runs no JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from lsnet_torch import _build  # noqa: E402
from lsnet_torch.apis import (inference_detector, init_detector,  # noqa: E402
                              train_detector_step)
from lsnet_torch import configs  # noqa: E402
from lsnet_torch.configs import (flagship_r50_cfg,  # noqa: E402
                                 x101_flagship_cfg)
from lsnet_torch.core.decode import TestConfig, lsnet_decode  # noqa: E402
from lsnet_torch.core.loss import LossConfig, lsnet_loss  # noqa: E402
from lsnet_torch.models.heads.ls_head import branch_pyramid_jobs  # noqa: E402
from lsnet_torch.models.layers import FrozenBatchNorm  # noqa: E402
from lsnet_torch.ops import deform_gather as dg  # noqa: E402
from lsnet_torch.ops import flat_deform as fd  # noqa: E402
from lsnet_torch.ops import grouped as gr  # noqa: E402
from lsnet_torch.ops import probes  # noqa: E402
from lsnet_torch.tools import probe as probe_tool  # noqa: E402
from lsnet_torch.ops.deform_gather import (  # noqa: E402
    deform_gather_contract, deform_gather_contract_ref)
from lsnet_torch.ops.grouped import (  # noqa: E402
    deform_gather_grouped_contract, deform_gather_grouped_contract_ref)

B, H, W = 2, 800, 1344
LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
FEAT = 256
K = 9
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them,
# HBM3 bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# main-path launches of deform_gather_contract per forward: 3 DCN blocks
# per tower (cls and one tower per regression branch), then the two
# contractions of the refine gather that the main branch shares with cls;
# pose_bbox has a third tower and its bbox branch's own refine gather
K1_PER_FORWARD = {"bbox": 2 * 3 + 2, "segm": 2 * 3 + 2,
                  "pose_bbox": 3 * 3 + 2 + 1, "pose_kbox": 2 * 3 + 2}
# X-101-64x4d grouped DCN stages at B=2, 800x1344: output map, C = cout,
# calls per forward (blocks of the stage); the first block of each stage
# samples at stride 2 from a map twice the size
X101_STAGES = [("c3", (100, 168), 512, 4), ("c4", (50, 84), 1024, 23),
               ("c5", (25, 42), 2048, 3)]
GROUPS = 64
GROUPED_PER_FORWARD = sum(n for *_, n in X101_STAGES)            # 30
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max(1, max|ref|)
ITERS = 5                        # timed runs of each main path
TRAIN_WARMUP, TRAIN_STEPS = 2, 3
NUM_GT = 20
NUM_VECTORS = {"bbox": 4, "segm": 36, "pose_bbox": 17, "pose_kbox": 17}
PROBE_TIME_LIMIT = 30.0          # seconds a probe launch may take
COPY_RATE_ROWS = 9 * 16384       # block gathers of the copy-rate timing


LOG_PATH = os.environ.get("CHIP_SMOKE_LOG")    # optional copy of the log


def log(msg):
    print(msg, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(msg + "\n")


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(event):
    """Device time of a profiler event, in microseconds."""
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0.0))


def kernel_device_us(fn, kernel="", iters=10):
    """Mean device time per call of fn() of the kernels whose name contains
    ``kernel`` (all of fn's kernels by default), from the profiler: for
    work so short that CUDA events around the calls time the host's launch
    rate instead."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    return sum(dev_us(e) for e in prof.key_averages()
               if kernel in e.key and e.device_type == on_device) / iters


def card_state(label):
    """Log the card's SM clock, power draw and temperature; a failure of
    nvidia-smi is logged and changes nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as ex:
        out = f"nvidia-smi failed: {ex}"
    log(f"card state {label}: {out}")


def main_path_inputs(dtype, gen, sampling):
    """(flat, idx, w, weight) of one tower call and of one refine
    contraction, built by the port's own index code from random level maps
    and offsets of the main path's shapes."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    feats = [rnd(B, h, w, FEAT).to(dtype) for h, w in LEVELS]
    levels = fd.pack_levels(feats)
    weight = rnd(K, FEAT, FEAT, scale=0.02).to(dtype).contiguous()
    tower_jobs = [fd.SampleJob(i, rnd(B, h, w, 2 * K, scale=2.0),
                               torch.rand(B, h, w, K, generator=gen).to(dev),
                               (1.0, 1.0), (1, 1), (1, 1), (1, 1))
                  for i, (h, w) in enumerate(LEVELS)]
    idx, w = fd._gather_indices_tap(levels, tower_jobs, K, sampling)
    tower = (levels.flat.contiguous(), idx, w, weight)
    offs = [rnd(B, h, w, 2 * K, scale=2.0) for h, w in LEVELS]
    refine_jobs = branch_pyramid_jobs(LEVELS, offs, 3)
    idx, w = fd._gather_indices_tap(levels, refine_jobs, K, sampling)
    refine = (levels.flat.contiguous(), idx, w, weight)
    return tower, refine


def work(args):
    """(operations, bytes) the function needs for these inputs: the corner
    weighting, and the products of each output with its (K, C/G) inputs
    (weight (K, C/G, cout); G = 1 for deform_gather_contract)."""
    flat, idx, w, weight = args[:4]
    nc, k, px = idx.shape
    C = flat.shape[1]
    cin, cout = weight.shape[1], weight.shape[2]
    ops = 2 * k * px * cin * cout + 2 * nc * k * px * C
    nbytes = (flat.numel() * flat.element_size() + idx.numel() * 4
              + w.numel() * 4 + weight.numel() * weight.element_size()
              + px * cout * flat.element_size())
    return ops, nbytes


def work_bwd_data(args):
    """bwd-data: the forward's product once (G = dout @ W^T), two passes
    over the corners (the d_w dot products and the weighted scatter); it
    reads flat, the table, the weight and dout and writes d_flat in f32
    and d_w."""
    flat, idx, w, weight = args[:4]
    nc, k, px = idx.shape
    C = flat.shape[1]
    cin, cout = weight.shape[1], weight.shape[2]
    ops = 2 * k * px * cin * cout + 2 * (2 * nc * k * px * C)
    nbytes = (flat.numel() * flat.element_size() + idx.numel() * 4
              + w.numel() * 4 + weight.numel() * weight.element_size()
              + px * cout * flat.element_size()
              + flat.numel() * 4 + w.numel() * 4)
    return ops, nbytes


def work_bwd_weight(args):
    """bwd-weight: the product once (V^T @ dout) and the corner weighting;
    it reads flat, the table and dout and writes d_weight."""
    flat, idx, w, weight = args[:4]
    nc, k, px = idx.shape
    C = flat.shape[1]
    cin, cout = weight.shape[1], weight.shape[2]
    ops = 2 * k * px * cin * cout + 2 * nc * k * px * C
    nbytes = (flat.numel() * flat.element_size() + idx.numel() * 4
              + w.numel() * 4 + px * cout * flat.element_size()
              + weight.numel() * weight.element_size())
    return ops, nbytes


def bound_ms(args, work=work):
    ops, nbytes = work(args)
    t_ops = ops / PEAK_OPS[args[0].dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_kernel():
    """Phase 2a: deform_gather_contract vs its plain version at the
    head's shapes."""
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    per_fwd = {}
    for dtype in (torch.float32, torch.bfloat16):
        for sampling in ("bilinear", "nearest"):
            for site, args in zip(("tower", "refine"),
                                  main_path_inputs(dtype, gen, sampling)):
                got = deform_gather_contract(*args).float()
                want = deform_gather_contract_ref(*args).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                lim = TOL[dtype] * max(1.0, want.abs().max().item())
                ok = bool(torch.isfinite(got).all()) and err <= lim
                del got, want
                ms = cuda_ms(lambda: deform_gather_contract(*args), 20)
                plain = cuda_ms(lambda: deform_gather_contract_ref(*args), 3)
                bnd, by = bound_ms(args)
                row = dict(site=site, dtype=str(dtype).split(".")[-1],
                           sampling=sampling, px=args[1].shape[2],
                           nc=args[1].shape[0], max_abs_err=err, limit=lim,
                           ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                           tflops=work(args)[0] / ms / 1e9)
                log("kernel " + json.dumps(row))
                if not ok:
                    raise AssertionError(f"kernel disagrees: {row}")
                if dtype == torch.bfloat16 and sampling == "bilinear":
                    # yardstick: one PyTorch call on the already gathered
                    # (K, px, C) patch tensor
                    vals = dg.gathered_rows(*args[:3]).to(dtype)
                    row["library_ms"] = cuda_ms(
                        lambda: torch.einsum("kpc,kco->po", vals, args[3]),
                        10)
                    del vals
                    log(f"kernel library {site}: einsum "
                        f"{row['library_ms']:.4f} ms")
                    per_fwd[site] = row
                    max_err = max(max_err, err)
                del args
            torch.cuda.empty_cache()
    # one forward = 6 tower calls + 2 refine contractions (bf16, bilinear)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    fwd = {key: 6 * per_fwd["tower"][key] + 2 * per_fwd["refine"][key]
           for key in keys}
    fwd["bound_by"] = max(per_fwd.values(),
                          key=lambda r: r["bound_ms"])["bound_by"]
    fwd["per_call"] = {site: {key: row[key] for key in keys}
                       for site, row in per_fwd.items()}
    return fwd, max_err


def grouped_inputs(gen, out_hw, C, stride):
    """(levels, job, weight) of one grouped backbone DCN call, f32: a
    random input map (twice the output size at stride 2), random offsets
    and masks, a compact (K, C/G, C) weight."""
    dev = torch.device("cuda")
    h, w = out_hw
    feat = torch.randn(B, h * stride, w * stride, C, device=dev,
                       generator=gen)
    job = fd.SampleJob(
        0, 2.0 * torch.randn(B, h, w, 2 * K, device=dev, generator=gen),
        torch.rand(B, h, w, K, device=dev, generator=gen), (1.0, 1.0),
        (stride, stride), (1, 1), (1, 1))
    weight = 0.05 * torch.randn(K, C // GROUPS, C, device=dev, generator=gen)
    return fd.pack_levels([feat]), job, weight


def check_grouped_kernel():
    """Phase 2b: deform_gather_grouped_contract vs its plain version at the
    X-101 stages, stride 1 and 2, nearest and bilinear, f32 and bf16; the
    PyTorch grouped einsum on the same contraction as the yardstick."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}                    # (stage, stride) -> bf16 nearest row
    library = {}
    max_err = 0.0
    for stage, out_hw, C, _ in X101_STAGES:
        for stride in (1, 2):
            levels, job, weight32 = grouped_inputs(gen, out_hw, C, stride)
            for sampling in ("nearest", "bilinear"):
                idx, w = fd._gather_indices_tap(levels, [job], K, sampling)
                for dtype in (torch.float32, torch.bfloat16):
                    args = (levels.flat.to(dtype).contiguous(), idx, w,
                            weight32.to(dtype).contiguous(), GROUPS)
                    got = deform_gather_grouped_contract(*args).float()
                    want = deform_gather_grouped_contract_ref(*args).float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    lim = TOL[dtype] * max(1.0, want.abs().max().item())
                    ok = bool(torch.isfinite(got).all()) and err <= lim
                    del got, want
                    ms = cuda_ms(
                        lambda: deform_gather_grouped_contract(*args), 20)
                    plain = cuda_ms(
                        lambda: deform_gather_grouped_contract_ref(*args), 3)
                    bnd, by = bound_ms(args)
                    row = dict(stage=stage, stride=stride,
                               dtype=str(dtype).split(".")[-1],
                               sampling=sampling, px=idx.shape[2], C=C,
                               nc=idx.shape[0], max_abs_err=err, limit=lim,
                               ms=ms, plain_ms=plain, bound_ms=bnd,
                               bound_by=by,
                               gbytes_s=work(args)[1] / ms / 1e6)
                    log("grouped " + json.dumps(row))
                    if not ok:
                        raise AssertionError(f"grouped kernel disagrees: "
                                             f"{row}")
                    if dtype == torch.bfloat16 and sampling == "nearest":
                        main[stage, stride] = row
                        max_err = max(max_err, err)
                    del args
            del levels, job, weight32
            torch.cuda.empty_cache()
        # yardstick: one PyTorch call computing the grouped contraction of
        # an already gathered (px, K, G, C/G) patch tensor
        px = B * out_hw[0] * out_hw[1]
        cg = C // GROUPS
        vals = torch.randn(px, K, GROUPS, cg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        wg = torch.randn(K, cg, GROUPS, cg, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
        library[stage] = cuda_ms(
            lambda: torch.einsum("pkgc,kcgj->pgj", vals, wg), 10)
        log(f"grouped library {stage}: einsum {library[stage]:.4f} ms")
        del vals, wg
    # one forward: per stage one stride-2 call + (n - 1) stride-1 calls,
    # bf16, nearest (the shipped backbone sampling)
    fwd = {key: sum(main[st, 2][key] + (n - 1) * main[st, 1][key]
                    for st, _, _, n in X101_STAGES)
           for key in ("ms", "plain_ms", "bound_ms")}
    fwd["bound_by"] = max(main.values(),
                          key=lambda r: r["bound_ms"])["bound_by"]
    fwd["library_ms"] = sum(n * library[st] for st, _, _, n in X101_STAGES)
    log("grouped per forward " + json.dumps(fwd))
    return fwd, max_err


def split_readings(data, flat, idx):
    """Where a bwd-data call's time goes (ms): both outputs, one at a
    time, the same call on a table that sends every corner to another row
    (no two adds meet) and on one that sends all to one row (every add
    meets), and the f32 memset and the cast around the launch."""
    rows = flat.shape[0]
    distinct = (torch.arange(idx.numel(), device=idx.device) % rows).to(
        torch.int32).view(idx.shape)
    one_row = torch.full_like(idx, rows // 2)

    def zero_cast():
        return torch.zeros(flat.shape, dtype=torch.float32,
                           device=flat.device).to(flat.dtype)

    return {"both": cuda_ms(data, 5),
            "d_w_only": cuda_ms(lambda: data(need_flat=False), 5),
            "d_flat_only": cuda_ms(lambda: data(need_w=False), 5),
            "distinct_rows": cuda_ms(lambda: data(table=distinct), 5),
            "one_row": cuda_ms(lambda: data(table=one_row), 2),
            "zero_and_cast": cuda_ms(zero_cast, 5)}


def check_backward_call(label, args, groups, gen, splits=False,
                        library=False):
    """Both backward kernels of one call against their plain versions;
    returns the log row. Tolerance as the forward's, relative to
    max(1, max|ref|) of each gradient: the kernels sum with f32 atomics in
    an order that changes from run to run, and the bf16 route rounds the
    weighted rows and G's inputs to 8 bits of mantissa. With ``splits``
    the row also gets the bwd-data kernel's split readings; with
    ``library`` (K1 only) the PyTorch calls on the already gathered (K, px,
    C) patch tensor: d_weight, and G alone for bwd-data (no PyTorch call
    gives its scatter and d_w)."""
    flat, idx, w, weight = args
    px, cout = idx.shape[2], weight.shape[2]
    dout = torch.randn(px, cout, device="cuda", generator=gen).to(flat.dtype)
    if groups:
        def data(table=idx, need_flat=True, need_w=True):
            return gr.deform_gather_grouped_contract_bwd_data(
                flat, table, w, weight, dout, groups, need_flat, need_w)

        def wgt():
            return gr.deform_gather_grouped_contract_bwd_weight(
                flat, idx, w, weight, dout, groups)

        def data_ref():
            return gr.deform_gather_grouped_contract_bwd_data_ref(
                flat, idx, w, weight, dout, groups)

        def wgt_ref():
            return gr.deform_gather_grouped_contract_bwd_weight_ref(
                flat, idx, w, dout, groups)
    else:
        def data(table=idx, need_flat=True, need_w=True):
            return dg.deform_gather_contract_bwd_data(
                flat, table, w, weight, dout, need_flat, need_w)

        def wgt():
            return dg.deform_gather_contract_bwd_weight(flat, idx, w, weight,
                                                        dout)

        def data_ref():
            return dg.deform_gather_contract_bwd_data_ref(flat, idx, w,
                                                          weight, dout)

        def wgt_ref():
            return dg.deform_gather_contract_bwd_weight_ref(flat, idx, w,
                                                            dout)

    row = dict(label, dtype=str(flat.dtype).split(".")[-1], px=px,
               nc=idx.shape[0])
    ok = True
    errs = {}
    for name, got, want in zip(
            ("d_flat", "d_w", "d_weight"), (*data(), wgt()),
            (*data_ref(), wgt_ref())):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lim = TOL[flat.dtype] * max(1.0, want.float().abs().max().item())
        ok = ok and bool(torch.isfinite(got).all()) and err <= lim
        errs[name] = err
        row[f"err_{name}"] = err
        row[f"limit_{name}"] = lim
        del got, want
    row["data_err"] = max(errs["d_flat"], errs["d_w"])
    row["weight_err"] = errs["d_weight"]
    for key, fn, ref, wk in (("data", data, data_ref, work_bwd_data),
                             ("weight", wgt, wgt_ref, work_bwd_weight)):
        row[f"{key}_ms"] = cuda_ms(fn, 10)
        row[f"{key}_plain_ms"] = cuda_ms(ref, 2)
        row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound_ms(args, wk)
    if splits:
        row["data_split_ms"] = split_readings(data, flat, idx)
    if library:
        vals = dg.gathered_rows(flat, idx, w).to(flat.dtype)
        row["weight_library_ms"] = cuda_ms(
            lambda: torch.einsum("kpc,po->kco", vals, dout), 10)
        del vals
        row["data_einsum_g_only_ms"] = cuda_ms(
            lambda: torch.einsum("po,kco->kpc", dout, weight), 10)
    log("backward " + json.dumps(row))
    if not ok:
        raise AssertionError(f"backward kernel disagrees: {row}")
    return row


BWD_KEYS = ("ms", "plain_ms", "bound_ms")


def sum_rows(weighted_rows, kind):
    """Per-step totals of one backward kernel (kind "data" or "weight")
    from (count, row) pairs."""
    tot = {key: sum(n * r[f"{kind}_{key}"] for n, r in weighted_rows)
           for key in BWD_KEYS}
    tot["bound_by"] = max((r for _, r in weighted_rows),
                          key=lambda r: r[f"{kind}_bound_ms"]
                          )[f"{kind}_bound_by"]
    tot["max_abs_err"] = max(r[f"{kind}_err"] for _, r in weighted_rows)
    return tot


def check_backward_kernels():
    """Phase 2c: the two backward kernels of deform_gather_contract at the
    head's tower and refine shapes."""
    gen = torch.Generator().manual_seed(2)
    cgen = torch.Generator(device="cuda").manual_seed(2)
    main = {}
    card_state("before phase 2c")
    for dtype in (torch.float32, torch.bfloat16):
        for sampling in ("bilinear", "nearest"):
            for site, args in zip(("tower", "refine"),
                                  main_path_inputs(dtype, gen, sampling)):
                is_main = dtype == torch.bfloat16 and sampling == "bilinear"
                row = check_backward_call(
                    dict(site=site, sampling=sampling), args, 0, cgen,
                    splits=is_main, library=is_main)
                if is_main:
                    main[site] = row
                del args
            torch.cuda.empty_cache()
    card_state("after phase 2c")
    # one step = 6 tower calls + 2 refine contractions (bf16, bilinear)
    rows = [(6, main["tower"]), (2, main["refine"])]
    out = {kind: sum_rows(rows, kind) for kind in ("data", "weight")}
    lib = {"weight": "weight_library_ms", "data": "data_einsum_g_only_ms"}
    for kind in out:
        out[kind]["per_call"] = {
            site: {key: row[f"{kind}_{key}"] for key in BWD_KEYS}
            for site, row in main.items()}
        for site, row in main.items():
            out[kind]["per_call"][site][lib[kind]] = row[lib[kind]]
    out["weight"]["library_ms"] = sum(n * r["weight_library_ms"]
                                      for n, r in rows)
    out["data"]["library_ms"] = None
    out["data"]["einsum_g_only_ms"] = sum(n * r["data_einsum_g_only_ms"]
                                          for n, r in rows)
    log("backward per step " + json.dumps(out))
    return out


def check_grouped_backward_kernels():
    """Phase 2d: the two backward kernels of
    deform_gather_grouped_contract at the X-101 stages, stride 1 and 2;
    the PyTorch transposed einsums on an already gathered patch tensor as
    the yardstick. Also the forward's bilinear (training) time."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    main = {}
    fwd_train = {}
    library = {"data": {}, "weight": {}}
    card_state("before phase 2d")
    for stage, out_hw, C, _ in X101_STAGES:
        for stride in (1, 2):
            levels, job, weight32 = grouped_inputs(gen, out_hw, C, stride)
            for sampling in ("bilinear", "nearest"):
                idx, w = fd._gather_indices_tap(levels, [job], K, sampling)
                for dtype in (torch.float32, torch.bfloat16):
                    args = (levels.flat.to(dtype).contiguous(), idx, w,
                            weight32.to(dtype).contiguous())
                    is_main = (dtype == torch.bfloat16
                               and sampling == "bilinear")
                    row = check_backward_call(
                        dict(stage=stage, stride=stride, sampling=sampling,
                             C=C), args, GROUPS, gen, splits=is_main)
                    if is_main:
                        main[stage, stride] = row
                        fwd_train[stage, stride] = cuda_ms(
                            lambda: deform_gather_grouped_contract(
                                *args, GROUPS), 20)
                    del args
            del levels, job, weight32
            torch.cuda.empty_cache()
        px = B * out_hw[0] * out_hw[1]
        cg = C // GROUPS
        vals = torch.randn(px, K, GROUPS, cg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        wg = torch.randn(K, cg, GROUPS, cg, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
        dout = torch.randn(px, GROUPS, cg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        library["data"][stage] = cuda_ms(
            lambda: torch.einsum("pgj,kcgj->pkgc", dout, wg), 10)
        library["weight"][stage] = cuda_ms(
            lambda: torch.einsum("pkgc,pgj->kcgj", vals, dout), 10)
        del vals, wg, dout
    rows = []
    for st, _, _, n in X101_STAGES:
        rows += [(1, main[st, 2]), (n - 1, main[st, 1])]
    out = {kind: sum_rows(rows, kind) for kind in ("data", "weight")}
    # no PyTorch call computes bwd-data's whole function: the einsum gives
    # G alone (no scatter, no d_w) and is logged as such
    lib = {kind: sum(n * library[kind][st] for st, _, _, n in X101_STAGES)
           for kind in library}
    out["weight"]["library_ms"] = lib["weight"]
    out["data"]["library_ms"] = None
    out["data"]["einsum_g_only_ms"] = lib["data"]
    out["forward_bilinear_ms"] = sum(
        fwd_train[st, 2] + (n - 1) * fwd_train[st, 1]
        for st, _, _, n in X101_STAGES)
    card_state("after phase 2d")
    log("grouped backward per step " + json.dumps(out))
    return out


def within_time_limit(fn, what):
    """fn() (which launches on the current stream), then wait for the
    device under a host-side time limit: a kernel that hangs (a barrier
    that never completes) ends the run with a message instead of holding
    the card."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > PROBE_TIME_LIMIT:
            log(f"chip_smoke: {what} did not finish within "
                f"{PROBE_TIME_LIMIT:.0f} s (a hung kernel); giving up")
            os._exit(1)
        time.sleep(0.001)
    return out


def probe_work(name, args):
    """(operations, their peak rate, bytes) of one probe call: each input
    the function needs read once (of a gathered table only the blocks the
    indices name), the output written once."""
    x = args[0]
    if name == "probe_row_copy":
        row = x.shape[1] * x.element_size()
        return 0, PEAK_OPS[torch.float32], 2 * row
    if name == "probe_block_gather":
        block = probes.BLOCK_ROWS * x.shape[1] * x.element_size()
        idx = args[1]
        return (0, PEAK_OPS[torch.float32],
                (idx.unique().numel() + idx.numel()) * block
                + idx.numel() * 4)
    P = x.shape[0]
    out_bytes = P * 128 * 4
    if name == "probe_subrow_sum":
        return (x.numel(), PEAK_OPS[torch.float32],
                x.numel() * x.element_size() + out_bytes)
    w = args[1]
    return (2 * x.numel() * w.shape[2], PEAK_OPS[torch.bfloat16],
            (x.numel() + w.numel()) * x.element_size() + out_bytes)


def probe_bound_ms(name, args):
    ops, rate, nbytes = probe_work(name, args)
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def probe_library_call(name, args):
    """One PyTorch call that computes the probe's function on the same
    inputs (a yardstick only; the port never calls it)."""
    x = args[0]
    if name == "probe_row_copy":
        return lambda: torch.narrow_copy(x, 0, 0, 1)
    if name == "probe_block_gather":
        blocks = x.view(-1, probes.BLOCK_ROWS * x.shape[1])
        return lambda: torch.index_select(blocks, 0, args[1])
    if name == "probe_subrow_sum":
        return lambda: torch.sum(x, dim=1, dtype=torch.float32)
    a, b = x.view(x.shape[0], -1), args[1].view(-1, args[1].shape[2])
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


def check_probe_kernels():
    """Phase 2e: the four probe kernels against their plain versions at
    the JAX probes' inputs and tolerances, every first launch under the
    host-side time limit; the block gather's copy rate at COPY_RATE_ROWS
    random rows of a 64 MB table; then the probe tool's own checks
    in-process, with the probes' launch counts set to 0 just before and
    read just after. Returns the probes' entries of the kernels line."""
    dev = torch.device("cuda")
    replaces = {
        "probe_row_copy": "lsnet_tpu/ops/pallas_dma_gather.py:220",
        "probe_block_gather": "tools/probe_dma2.py:33",
        "probe_subrow_sum": "tools/probe_dma2.py:69",
        "probe_subrow_dot": "tools/probe_dma2.py:98"}
    entries = {}
    for name in probes.PROBES:
        fn = getattr(probes, name)
        ref = getattr(probes, name + "_ref")
        args = [a.to(dev) for a in probes.probe_inputs(name)]
        got = within_time_limit(lambda: fn(*args), name)
        want = ref(*args)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        tol = probe_tool.TOLERANCES[name]
        ok = (torch.equal(got, want) if tol is None
              else torch.allclose(got, want, rtol=tol[0], atol=tol[1]))
        bnd, by = probe_bound_ms(name, args)
        entry = {"name": name, "route": "cuda",
                 "source": f"lsnet_torch/csrc/{name}.cu",
                 "replaces": replaces[name], "max_abs_err": err,
                 "ms": cuda_ms(lambda: fn(*args), 50),
                 "plain_ms": cuda_ms(lambda: ref(*args), 20),
                 "bound_ms": bnd, "bound_by": by,
                 "device_us": kernel_device_us(lambda: fn(*args),
                                               f"{name}_kernel")}
        # ms, plain_ms and library_ms are CUDA events around the calls: at
        # these sizes the wrappers' launch rate on the host. The *_device_us
        # keys compare kernel with kernel.
        entry["plain_device_us"] = kernel_device_us(lambda: ref(*args))
        try:
            library = probe_library_call(name, args)
            entry["library_ms"] = cuda_ms(library, 20)
            entry["library_device_us"] = kernel_device_us(library)
        except (TypeError, RuntimeError) as ex:
            # an older PyTorch without mm(out_dtype=): no yardstick
            log(f"probe {name}: no library call here ({ex})")
            entry["library_ms"] = entry["library_device_us"] = None
        log("probe " + json.dumps(dict(entry, tolerance=tol, ok=bool(ok))))
        if not ok or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"probe kernel disagrees: {entry}")
        entries[name] = entry

    # the copy-only rate of the gather: random 2,048-byte blocks of a
    # 64 MB table (larger than the 50 MB L2)
    gen = torch.Generator(device="cuda").manual_seed(4)
    table = torch.randn(32768 * probes.BLOCK_ROWS, 128, device=dev,
                        generator=gen).to(torch.bfloat16)
    rows = torch.randint(0, 32768, (COPY_RATE_ROWS,), device=dev,
                         generator=gen, dtype=torch.int32)
    args = [table, rows]
    got = within_time_limit(lambda: probes.probe_block_gather(*args),
                            "probe_block_gather at many rows")
    if not torch.equal(got, probes.probe_block_gather_ref(*args)):
        raise AssertionError("probe_block_gather disagrees at "
                             f"{COPY_RATE_ROWS} rows")
    del got
    ms = cuda_ms(lambda: probes.probe_block_gather(*args), 20)
    bnd, by = probe_bound_ms("probe_block_gather", args)
    rate = {"rows": COPY_RATE_ROWS, "ms": ms,
            "plain_ms": cuda_ms(
                lambda: probes.probe_block_gather_ref(*args), 5),
            "library_ms": cuda_ms(
                probe_library_call("probe_block_gather", args), 10),
            "bound_ms": bnd, "bound_by": by,
            "device_us": kernel_device_us(
                lambda: probes.probe_block_gather(*args),
                "probe_block_gather_kernel"),
            "library_device_us": kernel_device_us(
                probe_library_call("probe_block_gather", args)),
            "gathered_gbytes_s": COPY_RATE_ROWS * 2048 / ms / 1e6}
    log("probe_block_gather copy rate " + json.dumps(rate))
    entries["probe_block_gather"]["copy_rate"] = rate
    del table, rows, args

    # the entry point: lsnet_torch.tools.probe's checks, in-process
    for name in probes.PROBES:
        getattr(probes, name).launches = 0
    deform_gather_contract.launches = 0
    if not within_time_limit(
            lambda: probe_tool.run_checks(dev, lambda m: log("tool " + m)),
            "lsnet_torch.tools.probe"):
        raise AssertionError("lsnet_torch.tools.probe reports a failure")
    for name in probes.PROBES:
        entries[name]["launches"] = getattr(probes, name).launches
        if entries[name]["launches"] < 1:
            raise AssertionError(f"the probe tool never launched {name}")
    if deform_gather_contract.launches != 1:
        raise AssertionError("the probe tool's full-kernel check launched "
                             f"{deform_gather_contract.launches} times")
    return entries


def unit_bn_scales_(model):
    """FrozenBatchNorm scales to 1: at random 0.03 * N(0, 1) scales every
    residual branch, the backbone DCN included, is ~1e-5 of its shortcut
    and a comparison would not see it."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
    return model


def narrow_task_cfg(task):
    """A narrow X-101-shaped model of ``task``: ResNeXt-50, G=8, feat 64,
    two stacked DCN blocks, the task's own landmark count."""
    cfg = {"bbox": x101_flagship_cfg, "segm": configs.x101_segm_cfg,
           "pose_bbox": configs.x101_pose_bbox_cfg,
           "pose_kbox": configs.x101_pose_kbox_cfg}[task](feat=64, stacked=2)
    cfg["backbone"].update(depth=50, groups=8)
    return cfg


def check_small_against_cpu():
    """Phase 3: narrow models on the card vs the same models on the CPU
    (where the plain versions run), f32, TF32 off, bilinear sampling (the
    nearest rounding would amplify the card's ~1e-6 differences): an
    R50-shaped bbox model and a ResNeXt-shaped model of each task."""
    cases = [("R50-shaped", flagship_r50_cfg(feat=64, stacked=2))]
    for task in NUM_VECTORS:
        cases.append((f"ResNeXt-shaped {task}", narrow_task_cfg(task)))
    for label, cfg in cases:
        cfg["bbox_head"]["num_classes"] = 8
        cpu = unit_bn_scales_(init_detector(cfg, device="cpu", seed=1))
        gpu = unit_bn_scales_(init_detector(cfg, device="cuda", seed=1))
        images = torch.randn(2, 96, 128, 3,
                             generator=torch.Generator().manual_seed(1))
        with torch.inference_mode():
            want = cpu(images)
            got = gpu(images.cuda())
        worst = 0.0
        for key in want:
            for g, w_ in zip(got[key], want[key]):
                err = (g.float().cpu() - w_).abs().max().item()
                worst = max(worst, err / max(1.0, w_.abs().max().item()))
        log(f"small {label} model, card vs CPU: max rel err {worst:.3g}")
        if worst > 1e-3:
            raise AssertionError(f"{label}: card disagrees with CPU: {worst}")


def drive_main_path(label, cfg, grouped_per_forward, task="bbox"):
    """Phase 4: a full-width model end to end, B=2 at 800x1344, bf16, with
    the task's own test settings."""
    t0 = time.perf_counter()
    model = init_detector(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(B, H, W, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    img_shapes = torch.tensor([[H, W]] * B, device="cuda")
    sfs = torch.ones(B, 4, device="cuda")
    tcfg = TestConfig(image_shape=(H, W), **configs.TEST_SETTINGS[task])
    log(f"{label} model built in {time.perf_counter() - t0:.1f}s")

    def run():
        return inference_detector(model, images, img_shapes, sfs, tcfg)

    for _ in range(2):                      # warm-up
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        det = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    img_s = B * ITERS / dt
    n_valid = det.valid.sum(dim=1).tolist()
    log(f"{label} e2e: {img_s:.3f} img/s ({dt / ITERS * 1e3:.2f} ms per "
        f"batch of {B}), peak memory {peak / 2 ** 30:.2f} GiB, launches "
        f"{launches} over {ITERS} runs, valid {n_valid}")
    want = dict.fromkeys(launches, 0)
    want.update({
        "deform_gather_contract": K1_PER_FORWARD[task] * ITERS,
        "deform_gather_grouped_contract": grouped_per_forward * ITERS})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    for name, x in det._asdict().items():
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    shapes = (tuple(det.bboxes.shape), tuple(det.landmarks.shape))
    if shapes != ((B, tcfg.max_per_img, 4),
                  (B, tcfg.max_per_img, 2 * tcfg.num_vectors)) \
            or min(n_valid) < 1:
        raise AssertionError(f"{label}: bad detections: {shapes}, valid "
                             f"{n_valid}")
    # host-clock split of one batch: forward alone, decode + NMS alone
    with torch.inference_mode():
        t0 = time.perf_counter()
        for _ in range(ITERS):
            outs = model(images, fd.INFERENCE_SAMPLING)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) / ITERS * 1e3
        t0 = time.perf_counter()
        for _ in range(ITERS):
            lsnet_decode(outs, img_shapes, sfs, tcfg)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) / ITERS * 1e3
    log(f"{label} split per batch: forward {fwd_ms:.2f} ms, decode+NMS "
        f"{dec_ms:.2f} ms")
    return run, img_s, launches, peak


def synthetic_batch(batch, hw, num_gt, num_classes, seed, device):
    """A seeded training batch: random images, ``num_gt`` boxes per image
    with corners uniform in [0, min(hw)/2) and at least 8 px a side (the
    recipe of tools/bench_train.py); for the segm task a 36-point contour
    on an ellipse inside each box, for the pose tasks 17 keypoints inside
    each box with visibility 0 / 1 / 2 (invisible ones at (0, 0))."""
    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    bb = torch.rand(batch, num_gt, 4, generator=gen) * (min(h, w) / 2)
    bb = torch.cat([torch.minimum(bb[..., :2], bb[..., 2:]),
                    torch.maximum(bb[..., :2], bb[..., 2:]) + 8], dim=-1)
    out = {
        "image": torch.randn(batch, h, w, 3, generator=gen),
        "pad_shape": torch.tensor([[h, w]] * batch, dtype=torch.int32),
        "gt_bboxes": bb,
        "gt_labels": torch.randint(0, num_classes, (batch, num_gt),
                                   generator=gen),
        "gt_valid": torch.ones(batch, num_gt, dtype=torch.bool),
    }
    lo, wh = bb[..., None, :2], (bb[..., 2:] - bb[..., :2])[..., None, :]
    ang = torch.arange(36) * (2 * torch.pi / 36)
    radius = wh / 2 * (0.6 + 0.4 * torch.rand(batch, num_gt, 1, 1,
                                              generator=gen))
    out["gt_polygons"] = (lo + wh / 2 + radius * torch.stack(
        [ang.cos(), ang.sin()], dim=-1)).flatten(-2)
    vs = torch.randint(0, 3, (batch, num_gt, 17, 1), generator=gen).float()
    vs[..., 0, :] = 2.0               # every instance has a visible keypoint
    kxy = (lo + torch.rand(batch, num_gt, 17, 2, generator=gen) * wh) \
        * (vs > 0)
    out["gt_keypoints_vs"] = torch.cat([kxy, vs], dim=-1).flatten(-2)
    return {k: v.to(device) for k, v in out.items()}


def loss_config(task, hw, num_classes):
    return LossConfig(image_shape=hw, num_classes=num_classes, task=task,
                      num_vectors=NUM_VECTORS[task],
                      **configs.LOSS_WEIGHTS[task])


def check_small_gradients(task):
    """Phase 3b: the training loss and every parameter's gradient of a
    narrow ResNeXt-shaped model of ``task`` on the card (the kernels, forward and
    backward) against the same model on the CPU (the plain versions), f32,
    TF32 off. Tolerance 2e-3 of each gradient's largest entry (floored at
    1e-3 of the largest gradient of all): the convolutions and the
    kernels' atomics sum in another order than the CPU."""
    cfg = narrow_task_cfg(task)
    cfg["bbox_head"]["num_classes"] = 8
    hw = (96, 128)
    lcfg = loss_config(task, hw, 8)
    grads = {}
    for device in ("cpu", "cuda"):
        model = unit_bn_scales_(init_detector(cfg, device=device, seed=1,
                                              train=True))
        batch = synthetic_batch(2, hw, 4, 8, 1, device)
        outs = model(batch["image"], fd.TRAIN_SAMPLING)
        total, _ = lsnet_loss(outs, batch, lcfg)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        got = torch.autograd.grad(
            total, [p for p in model.parameters() if p.requires_grad])
        grads[device] = (total.item(),
                         {n: g.cpu() for n, g in zip(names, got)})
    (loss_c, g_c), (loss_g, g_g) = grads["cpu"], grads["cuda"]
    top = max(g.abs().max().item() for g in g_c.values())
    worst, worst_name = 0.0, ""
    for n, ref in g_c.items():
        rel = ((g_g[n] - ref).abs().max().item()
               / max(ref.abs().max().item(), 1e-3 * top))
        if rel > worst:
            worst, worst_name = rel, n
    log(f"small ResNeXt-shaped {task} model gradients, card vs CPU: loss "
        f"{loss_g:.6f} vs {loss_c:.6f}, {len(g_c)} gradients, max rel err "
        f"{worst:.3g} ({worst_name})")
    if abs(loss_g - loss_c) > 1e-4 * abs(loss_c) or worst > 2e-3:
        raise AssertionError(f"{task}: card gradients disagree with the "
                             "CPU")


def launch_counts():
    return {
        "deform_gather_contract": deform_gather_contract.launches,
        "deform_gather_contract_bwd_data":
            dg.deform_gather_contract_bwd_data.launches,
        "deform_gather_contract_bwd_weight":
            dg.deform_gather_contract_bwd_weight.launches,
        "deform_gather_grouped_contract":
            deform_gather_grouped_contract.launches,
        "deform_gather_grouped_contract_bwd_data":
            gr.deform_gather_grouped_contract_bwd_data.launches,
        "deform_gather_grouped_contract_bwd_weight":
            gr.deform_gather_grouped_contract_bwd_weight.launches,
    }


def zero_launch_counts():
    for fn in (deform_gather_contract, dg.deform_gather_contract_bwd_data,
               dg.deform_gather_contract_bwd_weight,
               deform_gather_grouped_contract,
               gr.deform_gather_grouped_contract_bwd_data,
               gr.deform_gather_grouped_contract_bwd_weight):
        fn.launches = 0


def drive_train_path(task, cfg):
    """Phase 4b: train steps of the full-width X-101-64x4d-DCN in
    ``task``, B=2 at 800x1344, bf16 compute over f32 master weights."""
    label = f"X-101 {task} train"
    num_classes = cfg["bbox_head"]["num_classes"]
    t0 = time.perf_counter()
    model = init_detector(cfg, device="cuda", seed=0, train=True)
    step = train_detector_step(
        model, loss_config(task, (H, W), num_classes), base_lr=0.01)
    batch = synthetic_batch(B, (H, W), NUM_GT, num_classes, 0, "cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    log(f"{label}er built in {time.perf_counter() - t0:.1f}s")
    for _ in range(TRAIN_WARMUP):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    history = [step(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    history = [{k: v.item() for k, v in m.items()} for m in history]
    img_s = B * TRAIN_STEPS / dt
    log(f"{label}: {img_s:.3f} img/s ({dt / TRAIN_STEPS * 1e3:.2f} ms "
        f"per step of {B}), peak memory {peak / 2 ** 30:.2f} GiB, launches "
        f"{launches} over {TRAIN_STEPS} steps")
    for m in history:
        log("  step " + json.dumps(m))
    want = {
        "deform_gather_contract": K1_PER_FORWARD[task],
        "deform_gather_contract_bwd_data": K1_PER_FORWARD[task],
        "deform_gather_contract_bwd_weight": K1_PER_FORWARD[task],
        "deform_gather_grouped_contract": GROUPED_PER_FORWARD,
        "deform_gather_grouped_contract_bwd_data": GROUPED_PER_FORWARD,
        "deform_gather_grouped_contract_bwd_weight": GROUPED_PER_FORWARD}
    want = {k: v * TRAIN_STEPS for k, v in want.items()}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    for m in history:
        for key, x in m.items():
            if not x == x or abs(x) == float("inf"):
                raise AssertionError(f"{label}: non-finite {key}: {m}")
    moved = frozen_moved = 0
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if p.requires_grad and same:
            raise AssertionError(f"{label}: trainable {n} did not move")
        if not p.requires_grad and not same:
            frozen_moved += 1
        moved += p.requires_grad
    if frozen_moved or moved == 0:
        raise AssertionError(f"{label}: {frozen_moved} frozen parameters "
                             f"moved, {moved} trainable ones")
    log(f"{label}: {moved} trainable parameters moved, "
        f"{len(before) - moved} frozen ones unchanged")
    return (lambda: step(batch)), img_s, launches, peak


def profile(label, run, batch_ms):
    """Phase 5: device time by kernel over one forward + decode, and the
    device's idle share of the measured batch time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernel events only: an operator's event, or a device-side copy of a
    # user annotation (the optimizer's step), repeats its kernels' time
    on_device = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if dev_us(e) > 0 and e.device_type == on_device
               and not e.key.startswith("Optimizer.")]
    total = sum(dev_us(e) for e in kernels)
    dgc = sum(dev_us(e) for e in kernels if "dgc_" in e.key)
    gdc = sum(dev_us(e) for e in kernels if "gdc_" in e.key)
    bwd = {}
    for e in kernels:
        for name in ("bwd_data_kernel", "bwd_weight_kernel"):
            if name in e.key:
                grouped = "true>" in e.key or "(bool)1>" in e.key
                key = ("grouped " if grouped else "") + name
                bwd[key] = bwd.get(key, 0.0) + dev_us(e)
    log(f"{label} profile: device kernel time {total / 1e3:.3f} ms per "
        f"batch, deform_gather_contract {dgc / 1e3:.3f} ms, "
        f"deform_gather_grouped_contract {gdc / 1e3:.3f} ms; device idle "
        f"{1.0 - total / 1e3 / batch_ms:.3f} of the {batch_ms:.2f} ms batch")
    if bwd:
        log(f"{label} profile, backward kernels: " + ", ".join(
            f"{k} {v / 1e3:.3f} ms" for k, v in sorted(bwd.items()))
            + f"; {sum(bwd.values()) / total:.3f} of the device time")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["backward"], default=None,
                        help="run phases 2c and 2d alone; no result line")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if LOG_PATH:
        os.makedirs(os.path.dirname(os.path.abspath(LOG_PATH)), exist_ok=True)
        open(LOG_PATH, "w").close()
    t_start = t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(_build.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, out in logs.items():
        log(f"nvcc {name}:\n{out.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    # f32 checks need full f32: TF32 off for matmuls and cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if opts.only == "backward":
        check_backward_kernels()
        check_grouped_backward_kernels()
        log(f"partial run (--only backward) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0

    fwd, max_err = check_kernel()
    gfwd, gmax_err = check_grouped_kernel()
    bwd = check_backward_kernels()
    gbwd = check_grouped_backward_kernels()
    probe_entries = check_probe_kernels()
    check_small_against_cpu()
    for task in NUM_VECTORS:
        check_small_gradients(task)

    # every path is driven with the launch counts set to 0 just before it
    # and read just after; by_path keeps each path's counts per batch or
    # step
    e2e, peaks, by_path = {}, {}, {}
    for label, cfg, grouped, task in (
            ("R50", flagship_r50_cfg(), 0, "bbox"),
            ("X-101-64x4d-DCN", x101_flagship_cfg(), GROUPED_PER_FORWARD,
             "bbox"),
            ("X-101-64x4d-DCN segm", configs.x101_segm_cfg(),
             GROUPED_PER_FORWARD, "segm"),
            ("X-101-64x4d-DCN pose_bbox", configs.x101_pose_bbox_cfg(),
             GROUPED_PER_FORWARD, "pose_bbox")):
        run, img_s, launches, peak = drive_main_path(label, cfg, grouped,
                                                     task)
        profile(label, run, B / img_s * 1e3)
        e2e[label], peaks[label] = img_s, peak
        by_path[label] = {k: v // ITERS for k, v in launches.items()}
        del run
        torch.cuda.empty_cache()

    for task, cfg in (("bbox", x101_flagship_cfg()),
                      ("pose_bbox", configs.x101_pose_bbox_cfg())):
        label = f"X-101-64x4d-DCN {task} train"
        run, img_s, launches, peak = drive_train_path(task, cfg)
        card_state(f"before the profiled {task} train step")
        profile(f"X-101 {task} train step", run, B / img_s * 1e3)
        card_state(f"after the profiled {task} train step")
        e2e[label], peaks[label] = img_s, peak
        by_path[label] = {k: v // TRAIN_STEPS for k, v in launches.items()}
        del run
        torch.cuda.empty_cache()
    for name, entry in probe_entries.items():
        by_path.setdefault("lsnet_torch.tools.probe", {})[name] = \
            entry["launches"]
    log("launches per batch or step " + json.dumps(by_path))

    # "launches": the counts of the heaviest path, the pose_bbox
    # train steps (TRAIN_STEPS steps through all six kernels), and of the
    # probe tool for the probes; the rows of every other path are in
    # launches_by_path. Forward times are per forward of the bbox
    # inference path as before (6 tower + 2 refine calls), backward times
    # per bbox train step; pose_bbox_ms is the same for pose_bbox (9 tower
    # + 3 refine calls).
    def path_counts(name):
        return {path: counts[name] for path, counts in by_path.items()
                if counts.get(name)}

    def pose_bbox_ms(per_call):
        return 9 * per_call["tower"]["ms"] + 3 * per_call["refine"]["ms"]

    def bwd_entry(name, source, replaces, row):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row.get("library_ms"),
                 "launches_by_path": path_counts(name)}
        if "einsum_g_only_ms" in row:
            entry["einsum_g_only_ms"] = row["einsum_g_only_ms"]
        if "per_call" in row:
            entry["pose_bbox_ms"] = pose_bbox_ms(row["per_call"])
            entry["per_call"] = row["per_call"]
        return entry

    kernels = [{
        "name": "deform_gather_contract", "route": "cuda",
        "source": "lsnet_torch/csrc/deform_gather_contract.cu",
        "replaces": "lsnet_tpu/ops/pallas_dma_gather.py:128",
        "launches": launches["deform_gather_contract"],
        "max_abs_err": max_err,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "pose_bbox_ms": pose_bbox_ms(fwd["per_call"]),
        "per_call": fwd["per_call"],
        "launches_by_path": path_counts("deform_gather_contract")}, {
        "name": "deform_gather_grouped_contract", "route": "cuda",
        "source": "lsnet_torch/csrc/grouped_deform_contract.cu",
        "replaces": "lsnet_tpu/ops/pallas_grouped.py:176",
        "launches": launches["deform_gather_grouped_contract"],
        "max_abs_err": gmax_err,
        "ms": gfwd["ms"], "plain_ms": gfwd["plain_ms"],
        "bound_ms": gfwd["bound_ms"], "bound_by": gfwd["bound_by"],
        "library_ms": gfwd["library_ms"],
        "train_forward_ms": gbwd["forward_bilinear_ms"],
        "launches_by_path": path_counts("deform_gather_grouped_contract")},
        bwd_entry("deform_gather_contract_bwd_data",
                  "lsnet_torch/csrc/deform_gather_contract_bwd_data.cu",
                  "lsnet_tpu/ops/pallas_dma_gather.py:184", bwd["data"]),
        bwd_entry("deform_gather_contract_bwd_weight",
                  "lsnet_torch/csrc/deform_gather_contract_bwd_weight.cu",
                  "lsnet_tpu/ops/pallas_dma_gather.py:184", bwd["weight"]),
        bwd_entry("deform_gather_grouped_contract_bwd_data",
                  "lsnet_torch/csrc/grouped_deform_contract_bwd_data.cu",
                  "lsnet_tpu/ops/pallas_grouped.py:113", gbwd["data"]),
        bwd_entry("deform_gather_grouped_contract_bwd_weight",
                  "lsnet_torch/csrc/grouped_deform_contract_bwd_weight.cu",
                  "lsnet_tpu/ops/pallas_grouped.py:127", gbwd["weight"]),
        *probe_entries.values()]
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was never launched on "
                                 "its path")
    log(json.dumps({"e2e_img_per_s": e2e, "batch": B,
                    "image": [H, W], "dtype": "bfloat16",
                    "peak_memory_bytes": peaks, "card": smi,
                    "seconds": time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
