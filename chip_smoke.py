"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. build every CUDA kernel of the port from ``lsnet_torch/csrc`` (one
   ``nvcc`` per source, started together), timed;
2. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it (f32 with TF32 off, and bf16; nearest and bilinear),
   and time both: ``deform_gather_contract`` at the head's tower and
   refine calls, ``deform_gather_grouped_contract`` at the three grouped
   DCN stages of X-101-64x4d (stride 1 and the stride-2 first block);
3. check the port on the card against the port on the CPU on small inputs
   (a narrow R50-shaped and a narrow ResNeXt-shaped model, f32);
4. drive the main paths, each with the kernels' launch counts set to 0
   just before and read just after: the full-width LSNet-R50 flagship and
   the full-width LSNet X-101-64x4d-DCN, seeded random bf16 weights,
   ``inference_detector`` (forward + decode + NMS, the shipped inference
   sampling) on a batch of two 800x1344 images;
5. profile one forward + decode of each for the device time by kernel.

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
from lsnet_torch.configs import (flagship_r50_cfg,  # noqa: E402
                                 x101_flagship_cfg)
from lsnet_torch.core.decode import TestConfig, lsnet_decode  # noqa: E402
from lsnet_torch.models.heads.ls_head import branch_pyramid_jobs  # noqa: E402
from lsnet_torch.models.layers import FrozenBatchNorm  # noqa: E402
from lsnet_torch.ops import flat_deform as fd  # noqa: E402
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
# main-path launches of deform_gather_contract per forward: 2 towers x 3
# DCN blocks, then the refine and cls contractions of the shared refine
# gather
LAUNCHES_PER_FORWARD = 2 * 3 + 2
# X-101-64x4d grouped DCN stages at B=2, 800x1344: output map, C = cout,
# calls per forward (blocks of the stage); the first block of each stage
# samples at stride 2 from a map twice the size
X101_STAGES = [("c3", (100, 168), 512, 4), ("c4", (50, 84), 1024, 23),
               ("c5", (25, 42), 2048, 3)]
GROUPS = 64
GROUPED_PER_FORWARD = sum(n for *_, n in X101_STAGES)            # 30
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max(1, max|ref|)
ITERS = 5                        # timed runs of each main path


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


def bound_ms(args):
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


def unit_bn_scales_(model):
    """FrozenBatchNorm scales to 1: at random 0.03 * N(0, 1) scales every
    residual branch, the backbone DCN included, is ~1e-5 of its shortcut
    and a comparison would not see it."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
    return model


def check_small_against_cpu():
    """Phase 3: narrow models on the card vs the same models on the CPU
    (where the plain versions run), f32, TF32 off, bilinear sampling (the
    nearest rounding would amplify the card's ~1e-6 differences)."""
    r50 = flagship_r50_cfg(feat=64, stacked=2)
    resnext = x101_flagship_cfg(feat=64, stacked=2)
    resnext["backbone"].update(depth=50, groups=8)
    for label, cfg in (("R50-shaped", r50), ("ResNeXt-shaped", resnext)):
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


def drive_main_path(label, cfg, grouped_per_forward):
    """Phase 4: a flagship end to end, B=2 at 800x1344, bf16."""
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
    log(f"{label} flagship built in {time.perf_counter() - t0:.1f}s")

    def run():
        return inference_detector(model, images, img_shapes, sfs, tcfg)

    for _ in range(2):                      # warm-up
        run()
    torch.cuda.synchronize()
    deform_gather_contract.launches = 0
    deform_gather_grouped_contract.launches = 0
    t0 = time.perf_counter()
    for _ in range(ITERS):
        det = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"deform_gather_contract": deform_gather_contract.launches,
                "deform_gather_grouped_contract":
                    deform_gather_grouped_contract.launches}
    img_s = B * ITERS / dt
    n_valid = det.valid.sum(dim=1).tolist()
    log(f"{label} e2e: {img_s:.3f} img/s ({dt / ITERS * 1e3:.2f} ms per "
        f"batch of {B}), launches {launches} over {ITERS} runs, valid "
        f"{n_valid}")
    want = {"deform_gather_contract": LAUNCHES_PER_FORWARD * ITERS,
            "deform_gather_grouped_contract": grouped_per_forward * ITERS}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    for name, x in det._asdict().items():
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    if tuple(det.bboxes.shape) != (B, 100, 4) or min(n_valid) < 1:
        raise AssertionError(f"bad detections: {det.bboxes.shape}, "
                             f"valid {n_valid}")
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
    return run, img_s, launches


def profile(label, run, batch_ms):
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
    dgc = sum(dev_us(e) for e in kernels if "dgc_" in e.key)
    gdc = sum(dev_us(e) for e in kernels if "gdc_" in e.key)
    log(f"{label} profile: device kernel time {total / 1e3:.3f} ms per "
        f"batch, deform_gather_contract {dgc / 1e3:.3f} ms, "
        f"deform_gather_grouped_contract {gdc / 1e3:.3f} ms; device idle "
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
    # f32 checks need full f32: TF32 off for matmuls and cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    fwd, max_err = check_kernel()
    gfwd, gmax_err = check_grouped_kernel()
    check_small_against_cpu()
    e2e = {}
    for label, cfg, grouped in (
            ("R50", flagship_r50_cfg(), 0),
            ("X-101-64x4d-DCN", x101_flagship_cfg(), GROUPED_PER_FORWARD)):
        run, img_s, launches = drive_main_path(label, cfg, grouped)
        profile(label, run, B / img_s * 1e3)
        e2e[label] = img_s
        del run
        torch.cuda.empty_cache()

    # launches: the X-101 main path's run, which goes through both kernels
    log(json.dumps({"kernels": [{
        "name": "deform_gather_contract", "route": "cuda",
        "source": "lsnet_torch/csrc/deform_gather_contract.cu",
        "replaces": "lsnet_tpu/ops/pallas_dma_gather.py:128",
        "launches": launches["deform_gather_contract"],
        "max_abs_err": max_err,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": None}, {
        "name": "deform_gather_grouped_contract", "route": "cuda",
        "source": "lsnet_torch/csrc/grouped_deform_contract.cu",
        "replaces": "lsnet_tpu/ops/pallas_grouped.py:176",
        "launches": launches["deform_gather_grouped_contract"],
        "max_abs_err": gmax_err,
        "ms": gfwd["ms"], "plain_ms": gfwd["plain_ms"],
        "bound_ms": gfwd["bound_ms"], "bound_by": gfwd["bound_by"],
        "library_ms": gfwd["library_ms"]}]}))
    log(json.dumps({"e2e_img_per_s": e2e, "batch": B,
                    "image": [H, W], "dtype": "bfloat16", "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
