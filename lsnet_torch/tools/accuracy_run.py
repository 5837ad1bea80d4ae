"""Short-schedule accuracy run on the procedural shapes set (the port's
``tools/accuracy_run.py``): train LSNet from its seeded init on the
3-class shapes set of :mod:`lsnet_torch.tools.shapes` (128x160 images;
160 train and 40 val by default), then score it with the package's own
COCO evaluation. The recipe is the reference one (SGD, warm-up, step
decay, clip 35) scaled to the run, key for key the JAX tool's.

    python3 -m lsnet_torch.tools.accuracy_run
        [--task bbox|segm|pose|pose_kbox|cpv]
        [--out DIR] [--epochs 12] [--train 160] [--val 40] [--batch 8]
        [--dcn] [--seed 0] [--device cuda|cpu]
    python3 -m lsnet_torch.tools.accuracy_run --eval-only DIR/ckpts/step_N.pt
        [--sampling SPEC] [same model flags]

A training run writes ``OUT/*.log.json`` (a record every 10 iterations),
``OUT/ckpts/step_N.pt`` (one per epoch) and ``OUT/result.json``:
``metrics`` (COCO, at the checkpoint's deployed sampling, the shipped
``backbone=nearest`` for a bilinear-trained model), ``losses``,
``epochs``, ``train_images``, ``val_images``, ``seed``, ``sampling``,
``card`` (``nvidia-smi``'s name and power limit, or ``cpu``) and the
wall-clock ``seconds`` of training and evaluation. ``--eval-only``
restores a checkpoint from any work dir and evaluates it at the sampling
``SPEC`` (the grammar of ``ops.flat_deform.sampling_from_spec``, e.g.
``bilinear`` or ``backbone=nearest,refine=nearest``; by default the
checkpoint's deployed sampling). ``--seed`` seeds the model's init; the
data are always the train set of seed 0 and the val set of seed 1. It
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Mapping

import numpy as np

from .shapes import HW, make_shapes_coco

IMG_H, IMG_W = HW

TASK_HEADS = {
    "bbox": dict(type="LSHead", task="bbox", num_vectors=4, num_classes=3),
    "segm": dict(type="LSHead", task="segm", num_vectors=36, num_classes=3),
    "pose": dict(type="LSHead", task="pose_bbox", num_vectors=17,
                 num_classes=1),
    "pose_kbox": dict(type="LSHead", task="pose_kbox", num_vectors=17,
                      num_classes=1),
    "cpv": dict(type="LSCPVHead", num_classes=3, num_points=9,
                shared_stacked_convs=1, corner_dim=16),
}


def accuracy_cfg(args, train_ann: str, train_dir: str, val_ann: str,
                 val_dir: str):
    """The run's ``Config``: model, train and test settings, data and
    schedule. ``args`` needs ``task``, ``dcn``, ``batch``, ``epochs``,
    ``train`` and ``seed``."""
    from ..utils.config import Config

    pose = args.task in ("pose", "pose_kbox")
    return Config(dict(
        model=dict(
            type="LSCPVDetector" if args.task == "cpv" else "LSDetector",
            # --dcn uses R50: a BasicBlock (R18) carries no DCN
            backbone=dict(type="ResNet", depth=50 if args.dcn else 18,
                          num_stages=4,
                          out_indices=(0, 1, 2, 3), frozen_stages=-1,
                          stage_with_dcn=((False, True, True, True)
                                          if args.dcn
                                          else (False,) * 4)),
            neck=dict(type="FPN", out_channels=64, start_level=1,
                      add_extra_convs="on_input", num_outs=5,
                      norm_cfg=dict(type="GN", num_groups=16)),
            bbox_head=dict(in_channels=64, feat_channels=64,
                           point_feat_channels=64, stacked_convs=2,
                           norm_cfg=dict(type="GN", num_groups=16),
                           conv_module_type="dcn" if args.dcn else "norm",
                           **TASK_HEADS[args.task])),
        train_cfg=dict(
            init=dict(assigner=dict(type="CentroidAssigner", scale=4,
                                    pos_num=1, iou_type="center")),
            refine=dict(assigner=dict(type="ATSSAssigner", topk=9)),
            heatmap=dict(assigner=dict(type="PointHMAssigner",
                                       gaussian_bump=True,
                                       gaussian_iou=0.7))),
        test_cfg=dict(nms_pre=500, score_thr=0.05,
                      nms=dict(type="nms", iou_thr=0.6), max_per_img=50),
        data=dict(samples_per_gpu=args.batch,
                  # pose: no flip; the shapes look the same mirrored, so a
                  # flip would give mirrored keypoint targets on
                  # indistinguishable objects
                  train=dict(ann_file=train_ann, img_prefix=train_dir,
                             img_scale=(IMG_W, IMG_H),
                             flip_ratio=0.0 if pose else 0.5),
                  val=dict(ann_file=val_ann, img_prefix=val_dir,
                           img_scale=(IMG_W, IMG_H))),
        optimizer=dict(lr=0.01, momentum=0.9, weight_decay=1e-4),
        optimizer_config=dict(grad_clip=dict(max_norm=35)),
        # the reference's 500-iteration warm-up scaled to the run: at 20
        # iterations an epoch it would cover the whole schedule
        lr_config=dict(policy="step",
                       step=[int(args.epochs * 2 / 3),
                             int(args.epochs * 11 / 12)],
                       warmup_iters=min(
                           500, max(1, args.epochs * int(np.ceil(
                               args.train / args.batch)) // 10))),
        evaluation=dict(interval=100),     # one evaluation, at the end
        max_instances=8,
        log_interval=10,
        total_epochs=args.epochs,
        seed=args.seed,
    ))


def sampling_name(sampling: Mapping[str, str]) -> str:
    """A sampling mapping's sites as a spec string that
    ``sampling_from_spec`` reads back: ``bilinear``, or the sites that
    are not bilinear as sorted ``site=mode``."""
    from ..ops.flat_deform import SITES
    listed = [f"{s}={sampling[s]}" for s in sorted(SITES)
              if sampling[s] != "bilinear"]
    return ",".join(listed) or "bilinear"


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def train_losses(work_dir: str) -> List[float]:
    """The ``loss`` of every train record of the run's json logs."""
    losses = []
    for path in sorted(glob.glob(os.path.join(work_dir, "*.log.json"))):
        with open(path) as f:
            losses += [round(r["loss"], 4) for r in map(json.loads, f)
                       if r.get("mode") == "train"]
    return losses


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--task", default="bbox",
                    choices=["bbox", "segm", "pose", "pose_kbox", "cpv"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--train", type=int, default=160)
    ap.add_argument("--val", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dcn", action="store_true",
                    help="R50 with DCN in c3-c5 and DCN head towers: every "
                    "sampling site (backbone, tower, refine) is live")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the model's init")
    ap.add_argument("--eval-only", default=None, metavar="CKPT",
                    help="no training: evaluate this step_N.pt")
    ap.add_argument("--sampling", default=None, metavar="SPEC",
                    help="the sampling of an --eval-only run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.sampling is not None and args.eval_only is None:
        raise ValueError("--sampling is for an --eval-only run; a training "
                         "run samples as its config's "
                         "train_cfg.dcn_sampling")
    if args.out is None:
        args.out = f"work/accuracy_torch_{args.task}"
    return args


def main(argv=None) -> Dict[str, Any]:
    args = parse_args(argv)

    from ..models import build_detector
    from ..ops.flat_deform import sampling_from_spec
    from ..train.checkpoint import refine_taps_env, restore_eval_state
    from ..train.loop import (eval_sampling, evaluate_detector,
                              runner_device, train_detector)

    device = runner_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    pose = args.task in ("pose", "pose_kbox")
    train_ann, train_dir = make_shapes_coco(
        os.path.join(args.out, "data_train"), args.train, seed=0, pose=pose)
    val_ann, val_dir = make_shapes_coco(
        os.path.join(args.out, "data_val"), args.val, seed=1, pose=pose)
    cfg = accuracy_cfg(args, train_ann, train_dir, val_ann, val_dir)
    explicit = (sampling_from_spec(args.sampling) if args.sampling
                else None)
    result: Dict[str, Any] = {}
    t0 = time.perf_counter()
    if args.eval_only:
        model = build_detector(cfg.model.to_dict())
        state, meta = restore_eval_state(args.eval_only)
        model.load_state_dict(state, strict=True)
        model.to(device)
        result["eval_only"] = args.eval_only
        train_s = 0.0
    else:
        out = train_detector(cfg, args.out, total_epochs=args.epochs,
                             eval_interval=10 ** 9, device=device)
        model, meta = out["model"], None
        train_s = time.perf_counter() - t0
    sampling = eval_sampling(explicit, meta, refine_taps_env())
    t1 = time.perf_counter()
    metrics = evaluate_detector(cfg, model, (IMG_H, IMG_W),
                                batch_size=args.batch, sampling=sampling)
    eval_s = time.perf_counter() - t1
    print("FINAL METRICS:", json.dumps(metrics), flush=True)
    result.update(metrics=metrics)
    if not args.eval_only:
        result.update(losses=train_losses(args.out), epochs=args.epochs,
                      train_images=args.train)
    result.update(val_images=args.val, task=args.task, dcn=args.dcn,
                  seed=args.seed, sampling=sampling_name(sampling),
                  card=card_name(device),
                  seconds=dict(train=train_s, eval=eval_s))
    path = os.path.join(args.out, "result.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print("wrote", path, flush=True)
    return result


if __name__ == "__main__":
    main()
