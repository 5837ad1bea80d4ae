"""Evaluate a checkpoint on the val split (the port's ``tools/test.py``).

    python3 -m lsnet_torch.tools.test CONFIG CHECKPOINT [--eval bbox] \
        [--max-images N] [--out metrics.json] \
        [--options key.sub=value ...] [--device cuda|cpu]

The model is built from the config, takes the checkpoint's f32 master
weights and runs with the sampling the checkpoint deploys with (its
meta), at the refine taps it trained on unless ``LSNET_REFINE_TAPS`` is
set. ``--eval`` names the metric (bbox, segm or keypoints); it must be
the task's own. ``--options`` overrides the config as in
``lsnet_torch.tools.train`` (the JAX ``tools/test.py`` has no such
option), so a run and its test can share the same overrides. It runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="Test a detector")
    parser.add_argument("config")
    parser.add_argument("checkpoint")
    parser.add_argument("--eval", nargs="+", default=None)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--options", nargs="+",
                        help="override config: key.subkey=value")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..models import build_detector
    from ..train.checkpoint import refine_taps_env, restore_eval_state
    from ..train.loop import (IOU_TYPE, check_runnable, eval_sampling,
                              evaluate_detector, head_cfg, runner_device)
    from ..utils.config import Config
    from .train import parse_options

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    check_runnable(cfg)
    iou_type = IOU_TYPE[head_cfg(cfg).get("task", "bbox")]
    if args.eval and args.eval != [iou_type]:
        raise ValueError(f"--eval {args.eval}: this config's task is "
                         f"scored by {iou_type!r}")
    device = runner_device(args.device)
    model = build_detector(cfg.model.to_dict())
    state, meta = restore_eval_state(args.checkpoint)
    model.load_state_dict(state, strict=True)
    model.to(device)
    # the landscape canvas: the config's, as the JAX tool reads it
    canvas = tuple(cfg.get("canvas_shape") or (800, 1344))
    metrics = evaluate_detector(cfg, model, canvas,
                                max_images=args.max_images,
                                sampling=eval_sampling(meta=meta,
                                                       taps=refine_taps_env()))
    print(json.dumps(metrics, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
