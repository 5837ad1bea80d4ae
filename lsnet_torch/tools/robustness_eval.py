"""Aggregate robustness-benchmark results into P / mPC / rPC (the port's
``tools/robustness_eval.py``).

    python3 -m lsnet_torch.tools.robustness_eval RESULT_JSON \
        [--task bbox|segm|keypoints] [--metric KEY ..] \
        [--prints P mPC rPC all] [--aggregate benchmark|all]

Reads the json of ``lsnet_torch.tools.test_robustness``
(``{corruption: {severity: {metric: value}}}``, severity 0 = clean) and
prints, per metric,

  P    performance on clean data          (severity 0)
  mPC  mean performance under corruption  (severities 1..5)
  rPC  mPC / P

``--aggregate benchmark`` averages over the published benchmark set
(``data.corruptions.BENCHMARK``) only; ``--aggregate all`` over every
corruption in the file. Host only: it needs no device.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# metric keys of the evaluator's result dicts, per task
DEFAULT_METRICS = {
    "bbox": ["bbox_mAP", "bbox_mAP_50", "bbox_mAP_75",
             "bbox_mAP_s", "bbox_mAP_m", "bbox_mAP_l"],
    "segm": ["segm_mAP", "segm_mAP_50", "segm_mAP_75",
             "segm_mAP_s", "segm_mAP_m", "segm_mAP_l"],
    "keypoints": ["keypoints_AP", "keypoints_AP50", "keypoints_AP75"],
}


def get_results(filename, metrics=None, task="bbox", prints=("mPC",),
                aggregate="benchmark", echo=print):
    """{metric: {"P": x, "mPC": y, "rPC": z}}, with the tables printed."""
    from ..data.corruptions import BENCHMARK

    with open(filename) as f:
        eval_output = json.load(f)
    if metrics is None:
        metrics = DEFAULT_METRICS[task]

    distortions = list(eval_output)
    if aggregate == "benchmark":
        distortions = [d for d in distortions if d in BENCHMARK]

    P = {}
    for sev_map in eval_output.values():
        clean = sev_map.get("0") or sev_map.get(0)
        if clean:
            P = {m: float(clean.get(m, 0.0)) for m in metrics}
            break

    corr = {m: [] for m in metrics}
    for d in distortions:
        for sev, res in eval_output[d].items():
            if int(sev) == 0:
                continue
            for m in metrics:
                corr[m].append(float(res.get(m, 0.0)))

    out = {}
    for m in metrics:
        mpc = float(np.mean(corr[m])) if corr[m] else float("nan")
        p = P.get(m, float("nan"))
        out[m] = {"P": p, "mPC": mpc,
                  "rPC": mpc / p if p else float("nan")}

    echo(f"\nmodel: {os.path.basename(filename)}   "
         f"({len(distortions)} corruptions, aggregate={aggregate})")
    if "P" in prints:
        echo(f"Performance on Clean Data [P] ({task})")
        for m in metrics:
            echo(f"  {m:16} = {out[m]['P']:.3f}")
    if "mPC" in prints:
        echo(f"Mean Performance under Corruption [mPC] ({task})")
        for m in metrics:
            echo(f"  {m:16} = {out[m]['mPC']:.3f}")
    if "rPC" in prints:
        echo(f"Relative Performance under Corruption [rPC] ({task})")
        for m in metrics:
            echo(f"  {m:16} = {out[m]['rPC'] * 100:.1f} %")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Corruption result analysis")
    ap.add_argument("filename", help="test_robustness output json")
    ap.add_argument("--task", choices=sorted(DEFAULT_METRICS),
                    default="bbox")
    ap.add_argument("--metric", nargs="+", default=None,
                    help="explicit metric keys (default: task set)")
    ap.add_argument("--prints", nargs="+", default=["mPC"],
                    choices=["P", "mPC", "rPC", "all"])
    ap.add_argument("--aggregate", choices=["benchmark", "all"],
                    default="benchmark")
    args = ap.parse_args(argv)
    prints = (("P", "mPC", "rPC") if "all" in args.prints
              else tuple(args.prints))
    return get_results(args.filename, metrics=args.metric, task=args.task,
                       prints=prints, aggregate=args.aggregate)


if __name__ == "__main__":
    main()
