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
   block), with the bf16 kernel's device time per inference forward
   (nearest) and per train step (bilinear) and ptxas's registers and
   spills for it, (c) and (d) the bwd-data and bwd-weight kernels of each
   at the same shapes; beside each, as a yardstick, one PyTorch einsum on the
   already gathered patch tensor (for bwd-data: G alone); for the bf16
   grouped bwd-weight kernel its device time per call and per train step
   and ptxas's registers and spills; with the
   bwd-data kernels' split readings (both outputs,
   one output at a time, a table without and with full contention, the
   memset and cast around the launch), (e) the four probe kernels at the
   probes' own inputs and tolerances, kernel, plain version and library
   call also by device time, each launch under a host-side time limit,
   ``probe_block_gather`` also at 147,456 random rows with its byte bound,
   ``probe_subrow_dot`` also at P = 16,384 (1e-5 of max(1, max|ref|), two
   launches equal bit for bit) beside ``torch.mm`` and its bound, then the
   checks of ``lsnet_torch.tools.probe`` in-process with the
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
   the device time by kernel;
6. the runner: (a) the phase-3 ResNeXt-shaped bbox model through
   ``train_detector`` (2 iterations, f32) and ``evaluate_detector`` on 4
   procedural 128x160 images, on the card and on the CPU (losses to 1e-3
   relative, metrics to 0.01 absolute); (b) the shipped
   ``lsnet_bbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py`` at full width
   (``with_cp``, ``frozen_stages=1``, multi-scale train range, 3 classes)
   through ``lsnet_torch.tools.train`` on 8 procedural images (6 landscape
   768x1280, 2 portrait) for 2 epochs of 4 steps with an ``EvalHook`` each
   epoch on 4 more (run A), ``lsnet_torch.tools.test`` on A's
   ``step_8.pt``, and a run B resumed from A's ``step_4.pt``: asserting
   the logged losses, ``grad_norm`` and learning rates, the six kernels'
   launches on every step (the same each step) and K1 and the grouped
   forward in each eval, the checkpoint bit for bit with its meta and
   deploy sampling, the test's metrics within 1e-4 of the EvalHook's, and
   B's steps 5 to 8; it prints the train seconds per iteration, eval
   images per second, checkpoint bytes and save / restore seconds, the
   metrics and peak memory beside the card's name and power limit. Run
   A starts from ``model.pretrained``: the same file's backbone, drawn
   from another seed and written in the reference's (mmdet) key names by
   chip_smoke's own writer, which must be the backbone A starts from,
   tensor for tensor (the grouped G = 64 DCN weights included);
7. a short ``lsnet_torch.tools.accuracy_run``: --task bbox --dcn (R50,
   DCN in c3-c5 and in the head towers) for 2 epochs of 10 steps (80
   procedural 128x160 images, batch 8), then --eval-only at
   ``backbone=nearest`` on its last checkpoint: both logged losses finite
   and the last below the first, COCO metric keys, and K1's launches
   (forward, bwd-data, bwd-weight) 19 on every train step (13 backbone
   DCN blocks, 4 tower blocks, 2 refine contractions; read after each
   step by a hook) and 19 forward an eval batch, no other kernel; the
   eval-only metrics equal the run's own last evaluation (the same
   sampling) within 0.01. The arguments of every K1 call of the first
   train step (bf16: R50's c3-c5 DCN at 128-512 channels, the stride-2
   first blocks, the 64-channel towers and refine) and of the first eval
   batch (f32) are kept, and each call's kernel is held against its plain
   version on them at phase 2's tolerance.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
(all ten kernels) and, last, ``{"ok": true, "device": {...}}``; the
card's clocks, power draw and temperature are logged before and after
phases 2c, 2d and the profiled train steps. ``python3 chip_smoke.py --only
backward`` builds, runs phases 2c and 2d alone and prints no result line
(for work on the backward kernels); ``--only probes`` does the same for
phase 2e, ``--only accuracy`` for phase 7. With
``CHIP_SMOKE_LOG=<path>`` in the environment it also writes every line it
prints to that file. It needs the repository
around it and a CUDA device, and runs no JAX.
"""

import argparse
import json
import math
import os
import re
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
from lsnet_torch.models import build_backbone  # noqa: E402
from lsnet_torch.models.heads.ls_head import branch_pyramid_jobs  # noqa: E402
from lsnet_torch.models.init import init_weights_  # noqa: E402
from lsnet_torch.models.layers import (  # noqa: E402
    FrozenBatchNorm, ModulatedDeformConvPack)
from lsnet_torch.ops import deform_gather as dg  # noqa: E402
from lsnet_torch.ops import flat_deform as fd  # noqa: E402
from lsnet_torch.ops import grouped as gr  # noqa: E402
from lsnet_torch.ops import probes  # noqa: E402
from lsnet_torch.tools import accuracy_run as accuracy_tool  # noqa: E402
from lsnet_torch.tools import probe as probe_tool  # noqa: E402
from lsnet_torch.ops.deform_gather import (  # noqa: E402
    deform_gather_contract, deform_gather_contract_ref)
from lsnet_torch.ops.grouped import (  # noqa: E402
    deform_gather_grouped_contract, deform_gather_grouped_contract_ref)
from lsnet_torch.tools import test as test_tool  # noqa: E402
from lsnet_torch.tools import train as train_tool  # noqa: E402
from lsnet_torch.tools.shapes import make_shapes_coco  # noqa: E402
from lsnet_torch.train import checkpoint as ckpt  # noqa: E402
from lsnet_torch.train import hooks as runner_hooks  # noqa: E402
from lsnet_torch.train import loop as runner_loop  # noqa: E402
from lsnet_torch.train import step as runner_step  # noqa: E402
from lsnet_torch.train.optim import build_lr_schedule  # noqa: E402
from lsnet_torch.utils.config import Config  # noqa: E402

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
LARGE_DOT_P = 16384              # pixels of the sub-row dot's large run
PROFILE_TRIES = 4                # profiles that may lose their device records
LOST_PROFILES = []               # host records of each profile that did
# phase 6: the shipped X-101-64x4d-DCN bbox config through the runner, on
# procedural sets of 768x1280 landscape and 1280x768 portrait images
# (aspect 5:3, so the multi-scale range (1333, 480)-(1333, 960) keeps every
# resize inside the config's (800, 1344) canvas)
RUNNER_CONFIG = os.path.join(REPO, "configs", "lsnet",
                             "lsnet_bbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py")
LAND, PORT = (768, 1280), (1280, 768)
RUNNER_TRAIN_HW = [LAND, LAND, LAND, PORT] * 2          # 6 + 2 images
RUNNER_VAL_HW = [LAND, LAND, LAND, PORT]
RUNNER_EPOCHS, RUNNER_STEPS = 2, 4                      # steps per epoch
PRETRAINED_SEED = 1          # the runner's own init draws from seed 0
# phase 7: a short accuracy_run, R50-DCN bbox, 10 steps an epoch (the
# tool logs a loss record every 10 iterations of an epoch)
ACC_EPOCHS, ACC_TRAIN, ACC_VAL, ACC_BATCH = 2, 80, 16, 8
# K1 launches a train step (forward, and each backward kernel): the 13
# DCN blocks of R50's c3-c5 (4 + 6 + 3), 2 DCN tower blocks for each of
# the 2 branches, the 2 contractions of the paired refine gather
ACC_K1_PER_STEP = 13 + 2 * 2 + 2


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
    rate instead. Raises AssertionError when PROFILE_TRIES profiles in a
    row lack ``kernel``'s device records, or hold a number of them that is
    no whole multiple of ``iters``.

    A profile can lose every device record while it keeps the host's (the
    launches): on the H100 with PyTorch 2.11 / CUDA 12.8 it happened to a
    probe kernel and to ``torch.mm`` alike, cluster launch or not, rarely
    and sometimes for two profiles in a row, each time with an "Activity
    Buffer Request" span (CUPTI asking the profiler for a new record
    buffer) over the first launch. A profile can also lose only some of
    them: the named kernel's records missing beside those of other kernels,
    or fewer of them than a whole number per call. Such a profile is taken
    again and its records kept in LOST_PROFILES (``bench_probes`` and
    ``bench_grouped`` report them); it is never read as 0 or as a part of
    the calls."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    on_device = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        events = [e for e in averages if e.device_type == on_device]
        mine = [e for e in events if kernel in e.key]
        launches = sum(e.count for e in mine)
        # each call launches the named kernel a whole number of times
        if mine and (not kernel or launches % iters == 0):
            break
        LOST_PROFILES.append([f"{e.key} x{e.count}" for e in averages])
        log(f"kernel_device_us: the profile of {kernel!r} lost device "
            f"records; records {LOST_PROFILES[-1]}")
    else:
        raise AssertionError(f"kernel_device_us: {PROFILE_TRIES} profiles "
                             f"of {kernel!r} in a row without all its "
                             "device records")
    return sum(dev_us(e) for e in mine) / iters


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


def ptxas_summary(log, kernel):
    """Registers, spill bytes and shared memory of each entry whose name
    holds ``kernel``, from the ``-Xptxas -v`` output of one source."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = None
            if kernel in line:
                cur = {"entry": line.split("'")[1]}
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in line.replace(",", " ").split()
                    if x.isdigit()]
            cur["stack_bytes"], cur["spill_store_bytes"], \
                cur["spill_load_bytes"] = nums[:3]
        elif cur is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                cur["static_smem_bytes"] = int(words[words.index("smem") - 2])
    return out


def check_grouped_kernel(ptxas_log=""):
    """Phase 2b: deform_gather_grouped_contract vs its plain version at the
    X-101 stages, stride 1 and 2, nearest and bilinear, f32 and bf16; the
    PyTorch grouped einsum on the same contraction as the yardstick; the
    bf16 kernel's device time (profiler) per call, summed per inference
    forward (nearest) and per train step (bilinear), beside ptxas's
    registers and spills for it (from ``ptxas_log``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}                    # (stage, stride) -> bf16 nearest row
    device_us = {}               # (stage, stride, sampling) -> bf16 us
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
                    if dtype == torch.bfloat16:
                        device_us[stage, stride, sampling] = \
                            kernel_device_us(
                                lambda: deform_gather_grouped_contract(
                                    *args), "gdc_bf16", 10)
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
    for key, sampling in (("device_ms", "nearest"),
                          ("train_device_ms", "bilinear")):
        fwd[key] = sum(device_us[st, 2, sampling]
                       + (n - 1) * device_us[st, 1, sampling]
                       for st, _, _, n in X101_STAGES) / 1e3
    fwd["device_us_per_call"] = {f"{st} s{stride} {sampling}": us for
                                 (st, stride, sampling), us in
                                 device_us.items()}
    fwd["ptxas_gdc_bf16"] = ptxas_summary(ptxas_log, "gdc_bf16")
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
                        library=False, weight_kernel=None):
    """Both backward kernels of one call against their plain versions;
    returns the log row. Tolerance as the forward's, relative to
    max(1, max|ref|) of each gradient: the kernels sum with f32 atomics in
    an order that changes from run to run, and the bf16 route rounds the
    weighted rows and G's inputs to 8 bits of mantissa. With ``splits``
    the row also gets the bwd-data kernel's split readings; with
    ``library`` (K1 only) the PyTorch calls on the already gathered (K, px,
    C) patch tensor: d_weight, and G alone for bwd-data (no PyTorch call
    gives its scatter and d_w). With ``weight_kernel`` the row also gets
    the profiler's device time of that bwd-weight kernel per call."""
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
    if weight_kernel:
        row["weight_device_us"] = kernel_device_us(wgt, weight_kernel, 10)
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


def check_grouped_backward_kernels(ptxas_log=""):
    """Phase 2d: the two backward kernels of
    deform_gather_grouped_contract at the X-101 stages, stride 1 and 2;
    the PyTorch transposed einsums on an already gathered patch tensor as
    the yardstick. Also the forward's bilinear (training) time, and the
    bf16 bwd-weight kernel's (``gdw_bf16``) device time (profiler) per
    call and per train step beside ptxas's registers and spills for it
    (from ``ptxas_log``)."""
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
                             C=C), args, GROUPS, gen, splits=is_main,
                        weight_kernel="gdw_bf16" if is_main else None)
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
    out["weight"]["device_ms"] = sum(
        n * r["weight_device_us"] for n, r in rows) / 1e3
    out["weight"]["device_us_per_call"] = {
        f"{st} s{stride}": r["weight_device_us"]
        for (st, stride), r in main.items()}
    out["weight"]["ptxas"] = ptxas_summary(ptxas_log, "gdw_bf16")
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


def check_large_dot(gen):
    """probe_subrow_dot at P = LARGE_DOT_P seeded normals (x 32 MB, w
    256 KB, out 8 MB): the kernel against its plain version (1e-5 of
    max(1, max|ref|), f32 sums in another order), two launches equal bit
    for bit, and the kernel, plain version and torch.mm by device time
    beside the bound."""
    dev = torch.device("cuda")
    args = [torch.randn(LARGE_DOT_P, probes.SUBROWS, probes.SUBROW,
                        device=dev, generator=gen).to(torch.bfloat16),
            (torch.randn(probes.SUBROWS, probes.SUBROW, 128, device=dev,
                         generator=gen) / 16).to(torch.bfloat16)]
    fn = probes.probe_subrow_dot

    def ref():
        return probes.probe_subrow_dot_ref(*args)

    got = within_time_limit(lambda: fn(*args),
                            f"probe_subrow_dot at P = {LARGE_DOT_P}")
    want = ref()
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    repeats = torch.equal(got, fn(*args))
    bnd, by = probe_bound_ms("probe_subrow_dot", args)
    library = probe_library_call("probe_subrow_dot", args)
    large = {"P": LARGE_DOT_P, "max_abs_err": err, "tolerance": 1e-5 * scale,
             "bit_repeat": repeats, "ms": cuda_ms(lambda: fn(*args), 20),
             "plain_ms": cuda_ms(ref, 5), "library_ms": cuda_ms(library, 20),
             "bound_ms": bnd, "bound_by": by,
             "device_us": kernel_device_us(lambda: fn(*args),
                                           "probe_subrow_dot_kernel"),
             "plain_device_us": kernel_device_us(ref),
             "library_device_us": kernel_device_us(library)}
    log("probe_subrow_dot large P " + json.dumps(large))
    if err > 1e-5 * scale or not repeats \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"probe_subrow_dot disagrees at P = "
                             f"{LARGE_DOT_P}: {large}")
    return large


def check_probe_kernels():
    """Phase 2e: the four probe kernels against their plain versions at
    the JAX probes' inputs and tolerances, every first launch under the
    host-side time limit; the block gather's copy rate at COPY_RATE_ROWS
    random rows of a 64 MB table; the sub-row dot at LARGE_DOT_P; then the
    probe tool's own checks in-process, with the probes' launch counts set
    to 0 just before and read just after. Returns the probes' entries of
    the kernels line."""
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
    entries["probe_subrow_dot"]["large_p"] = check_large_dot(gen)

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
        for name in ("bwd_data_kernel", "bwd_weight_kernel", "gdw_bf16"):
            if name in e.key:
                # gdw_bf16: the bf16 grouped bwd-weight kernel
                grouped = (name == "gdw_bf16" or "true>" in e.key
                           or "(bool)1>" in e.key)
                key = (("grouped " if grouped else "")
                       + name.replace("gdw_bf16", "bwd_weight_kernel"))
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


@runner_hooks.HOOKS.register_module()
class LaunchCountHook(runner_hooks.Hook):
    """Phase 6: the kernels' launch counts, read after each train step and
    after each epoch's evaluation (it runs after ``EvalHook``), each read
    setting them to 0; set to 0 before the run, when the backbone the run
    starts from is copied too."""
    priority = 95
    steps, evals = [], []
    start_backbone = {}

    def before_train(self, ctx):
        LaunchCountHook.start_backbone = {
            k: v.detach().cpu().clone()
            for k, v in ctx.model.backbone.state_dict().items()}
        zero_launch_counts()

    def after_iter(self, ctx):
        LaunchCountHook.steps.append(launch_counts())
        zero_launch_counts()

    def after_epoch(self, ctx):
        LaunchCountHook.evals.append(launch_counts())
        zero_launch_counts()


def f32_train_step(*args, **kwargs):
    """The runner's ``make_train_step`` with ``mixed_precision=False``."""
    return runner_step.make_train_step(*args, **{**kwargs,
                                                 "mixed_precision": False})


def narrow_runner_cfg(root):
    """Phase 6a: the phase-3 ResNeXt-shaped bbox model (3 classes) in the
    shipped R50 file's recipe, on 4 procedural images at 128x160."""
    ann, img = make_shapes_coco(root, 4, seed=0, hw=(128, 160))
    cfg = Config.fromfile(os.path.join(
        REPO, "configs", "lsnet", "lsnet_bbox_r50_fpn_1x_coco.py")).to_dict()
    cfg["model"] = narrow_task_cfg("bbox")
    cfg["model"]["bbox_head"]["num_classes"] = 3
    data = dict(ann_file=ann, img_prefix=img, img_scale=(160, 128))
    cfg.update(data=dict(samples_per_gpu=2, train=data, val=data),
               canvas_shape=(128, 160), log_interval=1,
               lr_config=dict(warmup_iters=2, step=[8]),
               test_cfg=dict(cfg["test_cfg"], score_thr=0.008))
    return Config(cfg)


def log_records(work_dir, mode):
    import glob
    (path,) = glob.glob(os.path.join(work_dir, "*.log.json"))
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["mode"] == mode]


def narrow_runner(device, root):
    """``train_detector`` for 2 iterations (one epoch of 2 steps), f32,
    then ``evaluate_detector``: the log's losses and the metrics."""
    cfg = narrow_runner_cfg(os.path.join(root, "data"))
    work = os.path.join(root, f"work_{device}")
    saved = runner_loop.make_train_step
    runner_loop.make_train_step = f32_train_step
    try:
        res = runner_loop.train_detector(cfg, work, total_epochs=1,
                                         eval_interval=100, device=device)
    finally:
        runner_loop.make_train_step = saved
    metrics = runner_loop.evaluate_detector(
        cfg, res["model"], (128, 160), sampling=runner_loop.eval_sampling())
    return [r["loss"] for r in log_records(work, "train")], metrics


def check_narrow_runner(root):
    """Phase 6a: the narrow runner on the card against the CPU: each
    iteration's loss to 1e-3 relative, the metrics to 0.01 absolute."""
    (loss_c, met_c), (loss_g, met_g) = (narrow_runner(d, root)
                                        for d in ("cpu", "cuda"))
    log(f"runner narrow, card vs CPU: losses {loss_g} vs {loss_c}; "
        f"metrics {json.dumps(met_g)} vs {json.dumps(met_c)}")
    if len(loss_g) != 2 or len(loss_c) != 2 or any(
            abs(g - c) > 1e-3 * abs(c) for g, c in zip(loss_g, loss_c)):
        raise AssertionError("runner narrow: card losses disagree")
    if met_g.keys() != met_c.keys() or any(
            abs(met_g[k] - met_c[k]) > 0.01 for k in met_c):
        raise AssertionError("runner narrow: card metrics disagree")


def reference_backbone_state(backbone):
    """Phase 6b: a port backbone's state dict in the reference's (mmdet)
    key names: ``backbone.layerS.B.*``, ``downsample.{0,1}``,
    ``running_mean`` / ``running_var``, a DCN weight as (cout, cin/G, kh,
    kw). chip_smoke's own writer, apart from the loader it checks."""
    dcn = {n for n, m in backbone.named_modules()
           if isinstance(m, ModulatedDeformConvPack)}
    out = {}
    for key, t in backbone.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if mod in dcn and leaf == "weight":
            t = t.permute(3, 2, 0, 1)
        leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        mod = re.sub(r"^layer(\d+)_(\d+)", r"layer\1.\2", mod)
        mod = mod.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1")
        out[f"backbone.{mod}.{leaf}"] = t.contiguous().clone()
    return out


def pretrained_backbone_file(path):
    """Phase 6b: the runner file's X-101-64x4d-DCN backbone at full width,
    drawn by the training init from ``PRETRAINED_SEED``, with seeded
    FrozenBatchNorm statistics and DCN offset convs (which the init
    leaves at 0), saved as a reference checkpoint ``{"state_dict": ...}``.
    Returns its state dict in the port's names."""
    backbone = build_backbone(Config.fromfile(RUNNER_CONFIG)
                              .model.backbone.to_dict())
    gen = torch.Generator().manual_seed(PRETRAINED_SEED)
    init_weights_(backbone, gen)
    with torch.no_grad():
        for name, m in backbone.named_modules():
            if isinstance(m, FrozenBatchNorm):
                m.mean.copy_(0.01 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(1.0 + 0.05 * torch.randn(
                    m.var.shape, generator=gen).abs())
            elif name.endswith("conv_offset"):
                m.weight.copy_(1e-3 * torch.randn(m.weight.shape,
                                                  generator=gen))
    torch.save({"state_dict": reference_backbone_state(backbone)}, path)
    return {k: v.clone() for k, v in backbone.state_dict().items()}


def runner_options(train_root, val_root, train_ann, val_ann):
    """(--options of tools.test, and the more of tools.train): the
    procedural sets, 3 classes, a score threshold under the focal prior
    (0.01, where a model 8 steps from its init still scores), and for
    training 2 images a step, a log record and an eval every epoch, and
    the launch-count hook."""
    test = [f"data.val.ann_file={val_ann}",
            f"data.val.img_prefix={os.path.join(val_root, 'imgs')}",
            "model.bbox_head.num_classes=3", "test_cfg.score_thr=0.005"]
    return test, test + [
        f"data.train.ann_file={train_ann}",
        f"data.train.img_prefix={os.path.join(train_root, 'imgs')}",
        "data.samples_per_gpu=2", "log_interval=1", "evaluation.interval=1",
        "custom_hooks=[{'type': 'LaunchCountHook'}]"]


def check_runner(root):
    """Phase 6b: the shipped X-101-64x4d-DCN bbox config at full width
    through ``lsnet_torch.tools.train`` (run A: 2 epochs of 4 steps; run B:
    resumed from A's step_4.pt) and ``lsnet_torch.tools.test`` on A's
    step_8.pt. Returns the numbers of the printed line and the launch
    counts per train step and per eval batch."""
    train_root, val_root = (os.path.join(root, n) for n in ("train", "val"))
    train_ann, _ = make_shapes_coco(train_root, len(RUNNER_TRAIN_HW), seed=1,
                                    hw=RUNNER_TRAIN_HW)
    val_ann, _ = make_shapes_coco(val_root, len(RUNNER_VAL_HW), seed=2,
                                  hw=RUNNER_VAL_HW)
    test_opts, opts = runner_options(train_root, val_root, train_ann,
                                     val_ann)
    # run A starts from a reference-keyed backbone file (model.pretrained)
    pretrained = os.path.join(root, "x101_dcn_backbone.pth")
    t0 = time.perf_counter()
    want = pretrained_backbone_file(pretrained)
    write_s = time.perf_counter() - t0
    work_a, work_b = (os.path.join(root, n) for n in ("A", "B"))
    torch.cuda.reset_peak_memory_stats()
    LaunchCountHook.steps.clear()
    LaunchCountHook.evals.clear()
    res = train_tool.main([RUNNER_CONFIG, "--work-dir", work_a,
                           "--total-epochs", str(RUNNER_EPOCHS),
                           "--options", *opts,
                           f"model.pretrained={pretrained}"])
    steps, evals = list(LaunchCountHook.steps), list(LaunchCountHook.evals)
    got = LaunchCountHook.start_backbone
    n_dcn = sum(k.endswith("conv_offset.weight") for k in want)
    if got.keys() != want.keys() or any(
            not torch.equal(got[k], v) for k, v in want.items()):
        raise AssertionError("runner A: the backbone it started from is "
                             "not the model.pretrained file")
    log(f"runner A started from model.pretrained: {len(want)} tensors "
        f"({n_dcn} DCN packs, G = {GROUPS}), "
        f"{os.path.getsize(pretrained)} bytes written in {write_s:.1f}s, "
        "equal tensor for tensor")
    del want, got
    LaunchCountHook.start_backbone = {}
    train = log_records(work_a, "train")
    val = log_records(work_a, "val")
    cfg = Config.fromfile(RUNNER_CONFIG)
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer.lr,
                                 RUNNER_STEPS, RUNNER_EPOCHS)
    for r in train:
        step = (r["epoch"] - 1) * RUNNER_STEPS + r["iter"]
        log("runner A " + json.dumps(r))
        if not all(math.isfinite(r[k]) for k in ("loss", "grad_norm")) or \
                r["lr"] != round(schedule(step), 6):
            raise AssertionError(f"runner A: bad record at step {step}: {r}")
    if len(train) != RUNNER_EPOCHS * RUNNER_STEPS or len(val) != 2 \
            or res["step"] != RUNNER_EPOCHS * RUNNER_STEPS:
        raise AssertionError(f"runner A: {len(train)} train and {len(val)} "
                             f"val records, step {res['step']}")
    log(f"runner launches per train step {json.dumps(steps[0])}, per "
        f"eval {json.dumps(evals[0])}")
    if len(steps) != len(train) or any(s != steps[0] for s in steps) or \
            min(steps[0].values()) < 1:
        raise AssertionError(f"runner A: launches per step {steps}")
    fwd = ("deform_gather_contract", "deform_gather_grouped_contract")
    if len(evals) != RUNNER_EPOCHS or any(
            e[k] < 1 for e in evals for k in fwd) or any(
            e[k] for e in evals for k in e if k not in fwd):
        raise AssertionError(f"runner A: launches per eval {evals}")

    # the saved state, bit for bit, and its meta
    path_a = os.path.join(work_a, "ckpts", f"step_{res['step']}.pt")
    raw = ckpt.load_checkpoint(path_a)
    model, opt = res["model"], res["optimizer"]
    sd, osd = model.state_dict(), opt.state_dict()
    if raw["step"] != res["step"] or raw["model"].keys() != sd.keys() or \
            any(not torch.equal(raw["model"][k], v.cpu())
                for k, v in sd.items()) or \
            raw["optimizer"]["count"] != osd["count"] or any(
                not torch.equal(a, b.cpu()) for a, b in
                zip(raw["optimizer"]["momentum"], osd["momentum"])):
        raise AssertionError("runner A: step_8.pt differs from the state")
    if raw["meta"] != {"dcn_sampling_train": "bilinear"} or \
            dict(ckpt.deploy_sampling(raw["meta"])) != \
            dict(fd.INFERENCE_SAMPLING):
        raise AssertionError(f"runner A: meta {raw['meta']}")
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(os.path.join(root, "timed"), model, opt,
                                res["step"], raw["meta"])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(path, model, opt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(path_a)
    del model, opt, res, sd, osd
    torch.cuda.empty_cache()

    # tools.test on A's step_8.pt, its evaluation timed
    timed = []
    evaluate = runner_loop.evaluate_detector

    def timed_evaluate(*a, **k):
        t0 = time.perf_counter()
        out = evaluate(*a, **k)
        timed.append(time.perf_counter() - t0)
        return out
    runner_loop.evaluate_detector = timed_evaluate
    try:
        metrics = test_tool.main([RUNNER_CONFIG, path_a, "--eval", "bbox",
                                  "--options", *test_opts])
    finally:
        runner_loop.evaluate_detector = evaluate
    hook_metrics = {k: v for k, v in val[-1].items()
                    if k not in ("mode", "epoch")}
    log(f"runner tools.test metrics {json.dumps(metrics)}; EvalHook epoch "
        f"2 {json.dumps(hook_metrics)}")
    if metrics.keys() != hook_metrics.keys() or len(metrics) != 12 or any(
            not -1.0 <= v <= 1.0 or abs(v - hook_metrics[k]) > 1e-4
            for k, v in metrics.items()):
        raise AssertionError("runner: tools.test metrics disagree with "
                             "the EvalHook's")

    # run B, resumed from A's step_4.pt
    path_4 = os.path.join(work_a, "ckpts", f"step_{RUNNER_STEPS}.pt")
    res_b = train_tool.main([RUNNER_CONFIG, "--work-dir", work_b,
                             "--total-epochs", str(RUNNER_EPOCHS),
                             "--resume-from", path_4, "--options", *opts])
    train_b = log_records(work_b, "train")
    first = (train_b[0]["epoch"] - 1) * RUNNER_STEPS + train_b[0]["iter"]
    if first != RUNNER_STEPS + 1 or len(train_b) != RUNNER_STEPS or any(
            not math.isfinite(r["loss"]) for r in train_b) or \
            not os.path.exists(os.path.join(
                work_b, "ckpts", f"step_{res_b['step']}.pt")) or \
            res_b["step"] != RUNNER_EPOCHS * RUNNER_STEPS:
        raise AssertionError(f"runner B: first step {first}, records "
                             f"{train_b}")
    log(f"runner B resumed at step {first}: losses "
        f"{[r['loss'] for r in train_b]}")
    del res_b
    n_val = len(RUNNER_VAL_HW)
    numbers = {
        "train_s_per_iter": sorted(r["time"] for r in train)[len(train) // 2],
        "eval_img_per_s": n_val / timed[0],
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s, "metrics": metrics,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    eval_batches = 2                 # 3 landscape images, 1 portrait
    return numbers, steps[0], {k: v // eval_batches
                               for k, v in evals[0].items()}


def capture_k1_calls(limit):
    """Phase 7: put in place of ``deform_gather``'s ops functions that keep
    a clone of the arguments of the first ``limit`` calls of each K1
    wrapper (forward, bwd-data, bwd-weight) and then call it. Returns the
    calls by wrapper and a function that puts the wrappers back."""
    calls = {name: [] for name in dg.ContractOps._fields}
    saved = dg._OPS

    def keep(name, fn):
        def call(*args):
            if len(calls[name]) < limit:
                calls[name].append(tuple(
                    a.detach().clone() if torch.is_tensor(a) else a
                    for a in args))
            return fn(*args)
        return call

    dg._OPS = dg.ContractOps(*(keep(name, fn) for name, fn in
                               zip(dg.ContractOps._fields, saved)))

    def undo():
        dg._OPS = saved
    return calls, undo


K1_CALLS = {       # wrapper -> (its kernel, its plain version) on the args
    "forward": (lambda a: (dg._forward(*a),),
                lambda a: (deform_gather_contract_ref(*a),)),
    "bwd_data": (lambda a: dg.deform_gather_contract_bwd_data(*a),
                 lambda a: dg.deform_gather_contract_bwd_data_ref(*a)),
    "bwd_weight": (lambda a: (dg.deform_gather_contract_bwd_weight(*a),),
                   lambda a: (dg.deform_gather_contract_bwd_weight_ref(
                       *a[:3], a[4]),))}


def check_k1_calls(label, calls):
    """Phase 7: each captured K1 call's kernel against its plain version
    on the same card tensors, at phase 2's tolerance (TOL of the call's
    dtype x max(1, max|ref|) for every output). Returns the log rows."""
    rows = {}
    for name, args_list in calls.items():
        if not args_list:
            continue
        kernel, plain = K1_CALLS[name]
        worst, ratio, shapes, ok = 0.0, 0.0, set(), True
        for args in args_list:
            flat, idx, weight = args[0], args[1], args[3]
            shapes.add((flat.shape[1], weight.shape[2], idx.shape[2]))
            for got, want in zip(kernel(args), plain(args)):
                if got is None:
                    continue
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                lim = TOL[flat.dtype] * max(
                    1.0, want.float().abs().max().item())
                ok = ok and bool(torch.isfinite(got).all()) and err <= lim
                worst, ratio = max(worst, err), max(ratio, err / lim)
        rows[name] = dict(calls=len(args_list),
                          dtype=str(args_list[0][0].dtype).split(".")[-1],
                          max_abs_err=worst, max_err_over_limit=ratio,
                          c_cout_px=sorted(shapes))
        log(f"accuracy_run {label} K1 {name} " + json.dumps(rows[name]))
        if not ok:
            raise AssertionError(f"accuracy_run {label}: K1 {name} "
                                 f"disagrees: {rows[name]}")
    return rows


def check_accuracy_run(root):
    """Phase 7: ``lsnet_torch.tools.accuracy_run`` --task bbox --dcn for
    ``ACC_EPOCHS`` epochs on ``ACC_TRAIN`` images, then --eval-only at
    ``backbone=nearest`` on its last checkpoint: finite, falling losses,
    COCO metric keys, the K1 launches of every step (``LaunchCountHook``)
    and of the eval-only run; the K1 calls of the first train step (bf16)
    and of the first eval batch (f32) held against their plain versions.
    Returns the launches per train step and per eval batch, and the
    phase's numbers."""
    flags = ["--task", "bbox", "--dcn", "--train", str(ACC_TRAIN),
             "--val", str(ACC_VAL), "--batch", str(ACC_BATCH)]
    out = os.path.join(root, "bbox")
    steps = ACC_EPOCHS * -(-ACC_TRAIN // ACC_BATCH)
    eval_batches = -(-ACC_VAL // ACC_BATCH)          # all landscape
    none = {k: 0 for k in launch_counts()}
    per_step = {**none, "deform_gather_contract": ACC_K1_PER_STEP,
                "deform_gather_contract_bwd_data": ACC_K1_PER_STEP,
                "deform_gather_contract_bwd_weight": ACC_K1_PER_STEP}
    per_eval = {**none, "deform_gather_contract":
                ACC_K1_PER_STEP * eval_batches}

    real_train = runner_loop.train_detector

    def train_counted(cfg, *args, **kwargs):
        cfg.custom_hooks = [dict(type="LaunchCountHook")]
        return real_train(cfg, *args, **kwargs)

    LaunchCountHook.steps.clear()
    LaunchCountHook.evals.clear()
    runner_loop.train_detector = train_counted
    calls, undo = capture_k1_calls(ACC_K1_PER_STEP)
    try:
        t0 = time.perf_counter()
        res = accuracy_tool.main(flags + ["--epochs", str(ACC_EPOCHS),
                                          "--out", out])
        train_s = time.perf_counter() - t0
        # the hook read and zeroed the counts after every step and epoch:
        # what is left is the closing evaluation's
        step_counts = list(LaunchCountHook.steps)
        epoch_counts = list(LaunchCountHook.evals)
        closing = launch_counts()
    finally:
        runner_loop.train_detector = real_train
        undo()
        LaunchCountHook.start_backbone = {}
    losses, metrics = res["losses"], res["metrics"]
    log(f"accuracy_run bbox --dcn, {ACC_EPOCHS} epochs of "
        f"{steps // ACC_EPOCHS} steps: losses {losses}, metrics "
        f"{json.dumps(metrics)}, launches a step "
        f"{json.dumps(step_counts[0] if step_counts else None)}, closing "
        f"evaluation {json.dumps(closing)} in {train_s:.1f}s")
    if len(step_counts) != steps or any(c != per_step for c in step_counts):
        raise AssertionError(f"accuracy_run: launches a step {step_counts},"
                             f" want {steps} x {per_step}")
    if any(c != none for c in epoch_counts) or closing != per_eval:
        raise AssertionError(f"accuracy_run: launches after the epochs "
                             f"{epoch_counts}, in the closing evaluation "
                             f"{closing}, want {per_eval}")
    if len(losses) != ACC_EPOCHS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"accuracy_run: losses {losses}")
    if "bbox_mAP" not in metrics or any(
            not k.startswith("bbox_") for k in metrics):
        raise AssertionError(f"accuracy_run: metrics {metrics}")
    train_calls = check_k1_calls("train step 1", calls)

    ckpt_path = os.path.join(out, "ckpts", f"step_{steps}.pt")
    calls, undo = capture_k1_calls(ACC_K1_PER_STEP)
    zero_launch_counts()
    try:
        t0 = time.perf_counter()
        near = accuracy_tool.main(flags + [
            "--out", os.path.join(root, "near"), "--eval-only", ckpt_path,
            "--sampling", "backbone=nearest"])
        eval_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        undo()
    log(f"accuracy_run --eval-only backbone=nearest: metrics "
        f"{json.dumps(near['metrics'])}, launches {json.dumps(counts)} in "
        f"{eval_s:.1f}s")
    if counts != per_eval or near["sampling"] != "backbone=nearest":
        raise AssertionError(f"accuracy_run --eval-only: launches {counts},"
                             f" sampling {near['sampling']}")
    # the run's own last evaluation is at the same (shipped) sampling
    if near["metrics"].keys() != metrics.keys() or any(
            abs(near["metrics"][k] - v) > 0.01 for k, v in metrics.items()):
        raise AssertionError("accuracy_run --eval-only: metrics differ from "
                             "the run's own evaluation")
    eval_calls = check_k1_calls("eval batch 1", calls)
    return step_counts[0], {k: v // eval_batches for k, v in counts.items()}, {
        "train_and_eval_s": train_s, "eval_only_s": eval_s,
        "losses": losses, "metrics": metrics, "card": res["card"],
        "k1_calls_checked": {"train step 1": train_calls,
                             "eval batch 1": eval_calls}}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["backward", "probes", "accuracy"],
                        default=None,
                        help="run phases 2c and 2d, phase 2e, or phase 7 "
                        "alone; no result line")
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
        check_grouped_backward_kernels(
            logs.get("grouped_deform_contract_bwd_weight", ""))
        log(f"partial run (--only backward) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "probes":
        check_probe_kernels()
        log(f"partial run (--only probes) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "accuracy":
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            *_, acc = check_accuracy_run(root)
        log(f"{smi}: accuracy_run R50-DCN bbox " + json.dumps(acc))
        log(f"partial run (--only accuracy) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0

    fwd, max_err = check_kernel()
    gfwd, gmax_err = check_grouped_kernel(
        logs.get("grouped_deform_contract", ""))
    bwd = check_backward_kernels()
    gbwd = check_grouped_backward_kernels(
        logs.get("grouped_deform_contract_bwd_weight", ""))
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
    # phase 6: the runner
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        check_narrow_runner(os.path.join(root, "narrow"))
        numbers, by_path["runner train"], by_path["runner eval"] = \
            check_runner(os.path.join(root, "full"))
        log(f"{smi}: runner X-101-64x4d-DCN bbox " + json.dumps(numbers)
            + f" (phase 6 in {time.perf_counter() - t0:.1f}s)")
        # phase 7: a short accuracy run
        t0 = time.perf_counter()
        (by_path["accuracy_run train"], by_path["accuracy_run eval"],
         acc) = check_accuracy_run(os.path.join(root, "accuracy"))
        log(f"{smi}: accuracy_run R50-DCN bbox " + json.dumps(acc)
            + f" (phase 7 in {time.perf_counter() - t0:.1f}s)")
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
        for key in ("einsum_g_only_ms", "device_ms", "ptxas"):
            if key in row:
                entry[key] = row[key]
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
        "replaces": "lsnet_tpu/ops/pallas_grouped.py:98",
        "launches": launches["deform_gather_grouped_contract"],
        "max_abs_err": gmax_err,
        "ms": gfwd["ms"], "plain_ms": gfwd["plain_ms"],
        "bound_ms": gfwd["bound_ms"], "bound_by": gfwd["bound_by"],
        "library_ms": gfwd["library_ms"],
        "train_forward_ms": gbwd["forward_bilinear_ms"],
        "device_ms": gfwd["device_ms"],
        "train_device_ms": gfwd["train_device_ms"],
        "ptxas": gfwd["ptxas_gdc_bf16"],
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
                    "profiles_taken_again": len(LOST_PROFILES),
                    "seconds": time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
