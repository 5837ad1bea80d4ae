"""Forward breakdown of LSNet-CPV X-101-64x4d-DCN on the card (the port's
``tools/bench_cpv.py``).

    python3 -m lsnet_torch.tools.bench_cpv [--batch 1] [--iters 10]

Builds the model of
``configs/lsnet/lsnet_bbox_cpv_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py``
with seeded random weights in bf16 and times nested prefixes of the
pipeline on seeded 800x1344 images at the shipped inference sampling
(``backbone=nearest``); the difference of two prefixes is a part's cost:

  A  backbone + neck
  B  + the cls, bbox and shared towers (the stacked DCN blocks)
  C  + the hem branches (semantic embedding, corner pools, score and
     offset convolutions)
  D  the whole forward (+ the init fields, the paired refine / cls gather
     and the fuse tails)
  E  + ``lscpv_decode`` and NMS (``apis.detect``)

For each prefix: host ms per image (mean of ``--iters`` calls after two
warm-up calls, closed by a synchronise), the device kernel time per image
and the device's idle share (1 - device / host time) from one
``torch.profiler`` trace. One JSON line per prefix, each with the card's
name and power limit; it raises when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, List

import torch

from ..ops.flat_deform import INFERENCE_SAMPLING

CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "configs", "lsnet",
    "lsnet_bbox_cpv_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py")
H, W = 800, 1344


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def prefixes(model, images, sampling) -> Dict[str, Callable[[], object]]:
    """The nested prefixes A-E as functions of no argument."""
    from ..apis import detect
    from ..core.decode import TestConfig

    head = model.head

    def backbone_neck():
        return list(model.neck(model.backbone(images.permute(0, 3, 1, 2),
                                              sampling)))

    def towers():
        feats = backbone_neck()
        bbox_t = head._tower("bbox", feats, sampling)
        return (head._tower("cls", feats, sampling), bbox_t,
                head._shared(bbox_t, sampling))

    def hem():
        _, _, shared_t = towers()
        outs = []
        for sf in shared_t:
            hf = sf + head.sem_embedding(sf)
            tl, br = head.hem_tl(hf), head.hem_br(hf)
            outs.append((head.sem_out(sf), head.hem_tl_score_out(tl),
                         head.hem_br_score_out(br),
                         head.hem_tl_offset_out(tl),
                         head.hem_br_offset_out(br)))
        return outs

    n = images.shape[0]
    tcfg = TestConfig(image_shape=(H, W),
                      num_classes=head.pts_cls_out.out_channels)
    shapes = torch.tensor([[H, W]] * n, device=images.device)
    sfs = torch.ones(n, 4, device=images.device)
    return {"A backbone+neck": backbone_neck, "B +towers": towers,
            "C +hem branches": hem,
            "D full forward": lambda: model(images, sampling),
            "E +decode+NMS": lambda: detect(model, images, shapes, sfs,
                                            tcfg, sampling)}


def device_ms(fn: Callable[[], object]) -> float:
    """Device kernel time of one call of fn, from the profiler."""
    from torch.profiler import ProfilerActivity, profile
    on_device = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0.0)
               for e in prof.key_averages()
               if e.device_type == on_device) / 1e3


def main(argv: List[str] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bench_cpv needs a CUDA device")
    from ..apis import init_model
    from ..utils.config import Config

    model = init_model(Config.fromfile(CONFIG).model.to_dict(), "cuda",
                       seed=0, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(args.batch, H, W, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    name = card()
    rows = []
    with torch.inference_mode():
        for part, fn in prefixes(model, images, INFERENCE_SAMPLING).items():
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / args.iters
            dev = device_ms(fn)
            row = {"part": part, "host_ms_per_image":
                   host * 1e3 / args.batch,
                   "device_ms_per_image": dev / args.batch,
                   "idle_share": 1.0 - dev / (host * 1e3),
                   "batch": args.batch, "image": [H, W], "dtype": "bfloat16",
                   "sampling": "backbone=nearest", "card": name}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
