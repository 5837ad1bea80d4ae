"""Analyse the runner's json logs (the port's ``tools/analyze_logs.py``):
the mean iteration time, or a plot of loss curves.

    python3 -m lsnet_torch.tools.analyze_logs cal_train_time WORK_DIR/X.log.json
    python3 -m lsnet_torch.tools.analyze_logs plot_curve WORK_DIR/X.log.json \
        [--keys loss ...] [--out curve.png]

The records are those of ``lsnet_torch.utils.logging.JsonLogger``, the
JAX package's: one json object a line, ``mode`` "train" with ``time``
per logged iteration. ``plot_curve`` imports matplotlib when it runs.
Host only: it needs no device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load_log(path):
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def cal_train_time(records):
    """Print and return (slowest, fastest, mean, std) of the train
    iterations' ``time``, or None without timing records."""
    times = [r["time"] for r in records if r.get("mode") == "train"
             and "time" in r]
    if not times:
        print("no timing records")
        return None
    arr = np.asarray(times)
    print(f"slowest iter: {arr.max():.4f}s, fastest: {arr.min():.4f}s, "
          f"mean: {arr.mean():.4f}s +/- {arr.std():.4f}")
    return float(arr.max()), float(arr.min()), float(arr.mean()), \
        float(arr.std())


def plot_curve(records, keys, out):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    train = [r for r in records if r.get("mode") == "train"]
    for key in keys:
        xs = [i for i, r in enumerate(train) if key in r]
        ys = [r[key] for r in train if key in r]
        plt.plot(xs, ys, label=key)
    plt.xlabel("log step")
    plt.legend()
    plt.savefig(out)
    print(f"saved {out}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="task", required=True)
    p1 = sub.add_parser("plot_curve")
    p1.add_argument("json_log")
    p1.add_argument("--keys", nargs="+", default=["loss"])
    p1.add_argument("--out", default="curve.png")
    p2 = sub.add_parser("cal_train_time")
    p2.add_argument("json_log")
    args = parser.parse_args(argv)

    records = load_log(args.json_log)
    if args.task == "plot_curve":
        return plot_curve(records, args.keys, args.out)
    return cal_train_time(records)


if __name__ == "__main__":
    main()
