"""Train a detector from a config file (the port's ``tools/train.py``).

    python3 -m lsnet_torch.tools.train configs/lsnet/<cfg>.py \
        [--work-dir DIR] [--resume-from DIR/ckpts/step_N.pt] [--seed S] \
        [--max-iters-per-epoch N] [--total-epochs E] \
        [--options key.sub=value ...] [--device cuda|cpu] \
        [--launcher none|pytorch]

It runs on the card unless ``--device cpu`` is given, and raises when
there is no CUDA device. ``--launcher pytorch`` joins ``torchrun``'s
process group (NCCL on the card, gloo with ``--device cpu``), each rank on
the card its ``LOCAL_RANK`` names, and trains on the global batch of
``samples_per_gpu`` x ranks (``lsnet_torch/tools/dist_train.sh``); it
raises without torchrun's environment. The default is one process. The
work dir receives the ``*.log.json`` records and ``ckpts/step_N.pt``
checkpoints.
"""

from __future__ import annotations

import argparse
import ast
import os


def parse_options(pairs):
    out = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        try:
            out[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            out[key] = val
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a detector")
    parser.add_argument("config")
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--resume-from", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max-iters-per-epoch", type=int, default=None)
    parser.add_argument("--total-epochs", type=int, default=None)
    parser.add_argument("--options", nargs="+",
                        help="override config: key.subkey=value")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--launcher", choices=("none", "pytorch"),
                        default="none")
    args = parser.parse_args(argv)

    from ..parallel import init_launcher
    from ..train.loop import train_detector
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_dict(parse_options(args.options))
    if args.seed is not None:
        cfg.seed = args.seed
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    init_launcher(args.launcher, args.device)
    return train_detector(
        cfg, work_dir, resume_from=args.resume_from,
        total_epochs=args.total_epochs,
        max_iters_per_epoch=args.max_iters_per_epoch,
        eval_interval=cfg.get("evaluation", {}).get("interval", 1),
        device=args.device)


if __name__ == "__main__":
    main()
