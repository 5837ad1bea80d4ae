"""Corruption-robustness benchmark: evaluate a checkpoint across
corruptions x severities (the port's ``tools/test_robustness.py``).

    python3 -m lsnet_torch.tools.test_robustness CONFIG CHECKPOINT \
        [--out robust.json] \
        [--corruptions benchmark|noise|blur|weather|digital|holdout|all|NAME..] \
        [--severities 0 1 2 3 4 5] [--max-images N] [--device cuda|cpu]

For every corruption and severity the val split is evaluated again with
the corruption applied right after each image is loaded
(``cfg.data.val.corruption``, :mod:`lsnet_torch.data.corruptions`).
Severity 0 is the clean pass: evaluated once and stored under every
corruption. The json, ``{corruption: {severity: metrics}}``, is written
again after each corruption; ``lsnet_torch.tools.robustness_eval`` reads
it (P / mPC / rPC).

The model takes the checkpoint's f32 master weights and runs with the
sampling the checkpoint deploys with (its meta), at the refine taps it
trained on unless ``LSNET_REFINE_TAPS`` is set. It runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

GROUPS = {
    "noise": ["gaussian_noise", "shot_noise", "impulse_noise"],
    "blur": ["defocus_blur", "motion_blur", "zoom_blur"],
    "weather": ["fog", "brightness"],
    "digital": ["contrast", "pixelate", "jpeg_compression"],
}


def pick_corruptions(spec):
    """The corruptions of ``--corruptions``: one group name, or names."""
    from ..data.corruptions import BENCHMARK, CORRUPTIONS, HOLDOUT
    groups = {"benchmark": BENCHMARK, "holdout": HOLDOUT,
              "all": sorted(CORRUPTIONS), **GROUPS}
    if len(spec) == 1 and spec[0] in groups:
        return groups[spec[0]]
    for name in spec:
        if name not in CORRUPTIONS:
            raise SystemExit(f"unknown corruption {name!r}; available: "
                             f"{sorted(CORRUPTIONS)} or groups "
                             f"{sorted(groups)}")
    return list(spec)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Robustness benchmark")
    ap.add_argument("config")
    ap.add_argument("checkpoint")
    ap.add_argument("--out", default="robustness_results.json")
    ap.add_argument("--corruptions", nargs="+", default=["benchmark"])
    ap.add_argument("--severities", type=int, nargs="+",
                    default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..models import build_detector
    from ..train.checkpoint import refine_taps_env, restore_eval_state
    from ..train.loop import (check_runnable, eval_sampling,
                              evaluate_detector, runner_device)
    from ..utils.config import Config

    corruptions = pick_corruptions(args.corruptions)
    cfg = Config.fromfile(args.config)
    check_runnable(cfg)
    device = runner_device(args.device)
    canvas = tuple(cfg.get("canvas_shape") or (800, 1344))
    model = build_detector(cfg.model.to_dict())
    state, meta = restore_eval_state(args.checkpoint)
    model.load_state_dict(state, strict=True)
    model.to(device)
    sampling = eval_sampling(meta=meta, taps=refine_taps_env())

    def run(corruption):
        if corruption is not None:
            cfg.data.val["corruption"] = list(corruption)
        else:
            cfg.data.val.pop("corruption", None)
        return evaluate_detector(cfg, model, canvas,
                                 max_images=args.max_images,
                                 sampling=sampling)

    results = {c: {} for c in corruptions}
    clean = None
    for corruption in corruptions:
        for severity in args.severities:
            if severity == 0:
                if clean is None:
                    print("[robustness] clean pass", flush=True)
                    clean = run(None)
                results[corruption][severity] = clean
                continue
            print(f"[robustness] {corruption} severity {severity}",
                  flush=True)
            results[corruption][severity] = run((corruption, severity))
        with open(args.out, "w") as f:    # progress after each corruption
            json.dump(results, f, indent=1)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
