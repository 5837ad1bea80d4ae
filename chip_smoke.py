"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. build every CUDA kernel of the port from ``lsnet_torch/csrc`` (one
   ``nvcc`` per source, started together), timed;
2. hold each kernel against its plain PyTorch version at the shapes the
   main path gives it (f32 with TF32 off, and bf16), and time both;
3. check the port on the card against the port on the CPU on a small
   input (a narrow model, f32);
4. drive the main path: the full-width LSNet-R50 flagship with seeded
   random bf16 weights, ``inference_detector`` (forward + decode + NMS) on
   a batch of two 800x1344 images, with the kernels' launch counts set to
   0 just before and read just after;
5. profile one forward + decode for the device time by kernel.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. It needs the repository
around it and a CUDA device, and runs no JAX.
"""

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from lsnet_torch import _build  # noqa: E402
from lsnet_torch.apis import inference_detector, init_detector  # noqa: E402
from lsnet_torch.configs import flagship_r50_cfg  # noqa: E402
from lsnet_torch.core.decode import TestConfig, lsnet_decode  # noqa: E402
from lsnet_torch.models.heads.ls_head import branch_pyramid_jobs  # noqa: E402
from lsnet_torch.ops import flat_deform as fd  # noqa: E402
from lsnet_torch.ops.deform_gather import (  # noqa: E402
    deform_gather_contract, deform_gather_contract_ref)

B, H, W = 2, 800, 1344
LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
FEAT = 256
K = 9
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them,
# HBM3 bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# main-path launches of deform_gather_contract per forward: 2 towers x 3
# DCN blocks, then the refine and cls contractions of the shared refine
# gather
LAUNCHES_PER_FORWARD = 2 * 3 + 2
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max(1, max|ref|)


def log(msg):
    print(msg, flush=True)


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
    """(operations, bytes) the function needs for these inputs."""
    flat, idx, w, weight = args
    nc, k, px = idx.shape
    C, cout = weight.shape[1], weight.shape[2]
    ops = 2 * k * px * C * cout + 2 * nc * k * px * C
    nbytes = (flat.numel() * flat.element_size() + idx.numel() * 4
              + w.numel() * 4 + weight.numel() * weight.element_size()
              + px * cout * flat.element_size())
    return ops, nbytes


def bound_ms(args):
    ops, nbytes = work(args)
    t_ops = ops / PEAK_OPS[args[0].dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_kernel():
    """Phase 2: kernel vs plain version at the main-path shapes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
                    per_fwd[site] = row
                    max_err = max(max_err, err)
                del args
            torch.cuda.empty_cache()
    # one forward = 6 tower calls + 2 refine contractions (bf16, bilinear)
    fwd = {key: 6 * per_fwd["tower"][key] + 2 * per_fwd["refine"][key]
           for key in ("ms", "plain_ms", "bound_ms")}
    fwd["bound_by"] = max(per_fwd.values(),
                          key=lambda r: r["bound_ms"])["bound_by"]
    return fwd, max_err


def check_small_against_cpu():
    """Phase 3: a narrow model on the card vs the same model on the CPU
    (where the plain versions run), f32, TF32 off."""
    cfg = flagship_r50_cfg(feat=64, stacked=2)
    cfg["bbox_head"]["num_classes"] = 8
    cpu = init_detector(cfg, device="cpu", seed=1)
    gpu = init_detector(cfg, device="cuda", seed=1)
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
    log(f"small model, card vs CPU: max rel err {worst:.3g}")
    if worst > 1e-3:
        raise AssertionError(f"card disagrees with CPU: {worst}")


def drive_main_path():
    """Phase 4: the R50 flagship end to end, B=2 at 800x1344, bf16."""
    cfg = flagship_r50_cfg()
    t0 = time.perf_counter()
    model = init_detector(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(B, H, W, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    img_shapes = torch.tensor([[H, W]] * B, device="cuda")
    sfs = torch.ones(B, 4, device="cuda")
    tcfg = TestConfig(image_shape=(H, W), num_classes=80, task="bbox",
                      nms_pre=1000, score_thr=0.05, nms_iou=0.6,
                      max_per_img=100)
    log(f"R50 flagship built in {time.perf_counter() - t0:.1f}s")

    def run():
        return inference_detector(model, images, img_shapes, sfs, tcfg)

    for _ in range(2):                      # warm-up
        run()
    torch.cuda.synchronize()
    iters = 5
    deform_gather_contract.launches = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        det = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = deform_gather_contract.launches
    img_s = B * iters / dt
    n_valid = det.valid.sum(dim=1).tolist()
    log(f"e2e: {img_s:.3f} img/s ({dt / iters * 1e3:.2f} ms per batch of "
        f"{B}), launches {launches} over {iters} runs, valid {n_valid}")
    if launches != LAUNCHES_PER_FORWARD * iters:
        raise AssertionError(f"deform_gather_contract launched {launches} "
                             f"times, want {LAUNCHES_PER_FORWARD * iters}")
    for name, x in det._asdict().items():
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    if tuple(det.bboxes.shape) != (B, 100, 4) or min(n_valid) < 1:
        raise AssertionError(f"bad detections: {det.bboxes.shape}, "
                             f"valid {n_valid}")
    # host-clock split of one batch: forward alone, decode + NMS alone
    with torch.inference_mode():
        t0 = time.perf_counter()
        for _ in range(iters):
            outs = model(images)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) / iters * 1e3
        t0 = time.perf_counter()
        for _ in range(iters):
            lsnet_decode(outs, img_shapes, sfs, tcfg)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) / iters * 1e3
    log(f"split per batch: forward {fwd_ms:.2f} ms, decode+NMS "
        f"{dec_ms:.2f} ms")
    return run, img_s, launches


def profile(run, batch_ms):
    """Phase 5: device time by kernel over one forward + decode, and the
    device's idle share of the measured batch time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    kernels = [e for e in events if dev_us(e) > 0 and "aten::" not in e.key]
    total = sum(dev_us(e) for e in kernels)
    ours = sum(dev_us(e) for e in kernels if "dgc_" in e.key)
    log(f"profile: device kernel time {total / 1e3:.3f} ms per batch, "
        f"deform_gather_contract {ours / 1e3:.3f} ms; device idle "
        f"{1.0 - total / 1e3 / batch_ms:.3f} of the {batch_ms:.2f} ms batch")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
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

    fwd, max_err = check_kernel()
    check_small_against_cpu()
    run, img_s, launches = drive_main_path()
    profile(run, B / img_s * 1e3)

    log(json.dumps({"kernels": [{
        "name": "deform_gather_contract", "route": "cuda",
        "source": "lsnet_torch/csrc/deform_gather_contract.cu",
        "replaces": "lsnet_tpu/ops/pallas_dma_gather.py:128",
        "launches": launches, "max_abs_err": max_err,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"e2e_img_per_s": img_s, "batch": B,
                    "image": [H, W], "dtype": "bfloat16", "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
