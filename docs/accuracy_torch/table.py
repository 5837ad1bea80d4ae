"""The port's accuracy runs beside the JAX records: each run's COCO
metric, the logged loss at fixed iterations beside the JAX log's, the
run's seconds, and each number's verdict against the tolerance of
``PERF.md`` section 6 (PR 13), whose values are written below.

    python3 docs/accuracy_torch/table.py

Reads ``docs/accuracy_torch/<run>/result.json`` and ``*.log.json`` (what
``run.sh`` brings back from the card) and the JAX records
``docs/accuracy/r5/*.json`` and ``train_*.log``. Prints markdown. A run
that is not there is left out.
"""

import glob
import json
import os
import re
import statistics

HERE = os.path.dirname(os.path.abspath(__file__))
JAX = os.path.join(HERE, "..", "accuracy", "r5")
ITERS = (10, 240, 480, 720)
# the tolerance, as written before the first full run
EACH_RUN, MEAN = 2.5, 1.5          # bbox bilinear mAP from JAX's
CONVERGED = 60.0                   # bbox mAP at least
DELTA = 0.5                        # deploy deltas from JAX's, same sign
SEGM, KBOX = 2.5, 0.05             # segm mAP, pose_kbox OKS AP
# bbox R50-DCN 36e runs: run dir, prefix of its --eval-only dirs (None:
# none made), seed, train dtype, run.sh part (one chip call each)
BBOX = [("bbox_dcn36_s0", "ev_", 0, "bf16", "bbox"),
        ("bbox_dcn36_s1", None, 1, "bf16", "more"),
        ("bbox_dcn36_s0b", "ev_s0b_", 0, "bf16", "again"),
        ("bbox_dcn36_s1b", "ev_s1b_", 1, "bf16", "again"),
        ("bbox_dcn36_s0c", "ev_s0c_", 0, "bf16", "trace"),
        ("bbox_dcn36_s0d", "ev_s0d_", 0, "bf16", "trace"),
        ("bbox_dcn36_s0e", "ev_s0e_", 0, "bf16", "trace"),
        ("bbox_dcn36_s0_f32", "ev_s0_f32_", 0, "f32", "trace")]
# run dir -> (metric, JAX record at the same sampling, JAX train log)
RUNS = {**{run: ("bbox_mAP", "ev2_b_near.json", "train_dcn36b.log")
           for run, *_ in BBOX},
        "segm48": ("segm_mAP", "segm48.json", "train_segm48.log"),
        "kbox36": ("keypoints_AP", "kbox36.json", "train_kbox36.log")}
DEPLOYS = ("bilinear", "backbone_nearest", "backbone_nearest_refine_nearest")
JAX_DEPLOY = {"bilinear": "ev2_bilinear.json",
              "backbone_nearest": "ev2_b_near.json",
              "backbone_nearest_refine_nearest": "ev2_refnear.json"}


def load(path):
    with open(path) as f:
        return json.load(f)


def port_losses(run):
    """{iteration: loss} of a run's train records."""
    (path,) = glob.glob(os.path.join(HERE, run, "*.log.json"))
    out = {}
    with open(path) as f:
        for r in map(json.loads, f):
            if r["mode"] == "train":
                out[len(out) * 10 + 10] = r["loss"]
    return out


def jax_losses(log):
    out = {}
    with open(os.path.join(JAX, log)) as f:
        for line in f:
            m = re.search(r"mode: train, .* loss: ([\d.]+)", line)
            if m:
                out[len(out) * 10 + 10] = float(m.group(1))
    return out


def metric(path, key):
    """COCO mAP in percent; OKS AP as the fraction the JAX records
    give."""
    v = load(path)["metrics"][key]
    return v if key == "keypoints_AP" else 100 * v


def fmt(v, key):
    return f"{v:.4f}" if key == "keypoints_AP" else f"{v:.2f}"


def verdict(ok):
    return "within" if ok else "**missed**"


def deploy_rows():
    """{run: (seed, dtype, part, [mAP at each of DEPLOYS])} of the bbox
    runs with all three eval-only deploys."""
    rows = {}
    for run, prefix, seed, dtype, part in BBOX:
        if prefix is None:
            continue
        paths = [os.path.join(HERE, prefix + d, "result.json")
                 for d in DEPLOYS]
        if all(map(os.path.exists, paths)):
            rows[run] = (seed, dtype, part,
                         [metric(p, "bbox_mAP") for p in paths])
    return rows


def main():
    print("| run | metric (deployed sampling) | JAX | verdict | card |"
          " train s | loss at " + " / ".join(map(str, ITERS))
          + " and the last iteration (JAX) |")
    print("|---|---|---|---|---|---|---|")
    for run, (key, jrec, jlog) in RUNS.items():
        res = os.path.join(HERE, run, "result.json")
        if not os.path.exists(res):
            continue
        r = load(res)
        pl, jl = port_losses(run), jax_losses(jlog)
        its = sorted(set(ITERS) | {max(pl)})
        losses = " / ".join(f"{pl.get(i, float('nan')):.4f} "
                            f"({jl.get(i, float('nan')):.4f})"
                            for i in its)
        got = metric(res, key)
        want = metric(os.path.join(JAX, jrec), key)
        ok = {"bbox_mAP": got >= CONVERGED,
              "segm_mAP": abs(got - want) <= SEGM,
              "keypoints_AP": abs(got - want) <= KBOX}[key]
        what = ("converged" if key == "bbox_mAP" else
                f"{got - want:+.4g}") + f", {verdict(ok)}"
        print(f"| {run} | {fmt(got, key)} {r['sampling']} | "
              f"{fmt(want, key)} | {what} | {r['card']} | "
              f"{r['seconds']['train']:.1f} | {losses} |")

    jax_row = [metric(os.path.join(JAX, JAX_DEPLOY[d]), "bbox_mAP")
               for d in DEPLOYS]
    jax_deltas = [v - jax_row[0] for v in jax_row[1:]]
    print()
    print("| checkpoint | seed | train | run.sh part | " + " | ".join(DEPLOYS)
          + " | bilinear from JAX (each within 2.5) | deltas from "
          "bilinear (JAX's sign, within 0.5 of JAX's) |")
    print("|---|---|---|---|---|---|---|---|---|")
    print("| JAX dcn36b | 0 | bf16 | — | " + " | ".join(
        f"{v:.2f}" for v in jax_row) + " | — | " + ", ".join(
        f"{d:+.2f}" for d in jax_deltas) + " |")
    rows = deploy_rows()
    for run, (seed, dtype, part, vals) in rows.items():
        off = vals[0] - jax_row[0]
        deltas = [v - vals[0] for v in vals[1:]]
        dv = ", ".join(
            f"{d:+.2f} {verdict(d * j > 0 and abs(d - j) <= DELTA)}"
            for d, j in zip(deltas, jax_deltas))
        print(f"| {run} | {seed} | {dtype} | {part} | "
              + " | ".join(f"{v:.2f}" for v in vals)
              + f" | {off:+.2f} {verdict(abs(off) <= EACH_RUN)} | {dv} |")

    print()
    print("Means of the bilinear mAP (tolerance: within 1.5 of JAX's "
          f"{jax_row[0]:.2f}); every bf16 run that has a bilinear eval, "
          "none left out:")
    print()
    groups = {"all bf16 runs": [v[3][0] for v in rows.values()
                                if v[1] == "bf16"]}
    for seed in sorted({v[0] for v in rows.values()}):
        groups[f"seed {seed}, bf16"] = [v[3][0] for v in rows.values()
                                        if v[1] == "bf16" and v[0] == seed]
    bf16 = [v[3] for v in rows.values() if v[1] == "bf16"]
    if bf16:
        means = [statistics.fmean(r[i] - r[0] for r in bf16)
                 for i in (1, 2)]
        print("- deploy deltas of the bf16 runs, mean: " + ", ".join(
            f"{d} {m:+.3f} (JAX {j:+.2f})"
            for d, m, j in zip(DEPLOYS[1:], means, jax_deltas)))
    for name, vals in groups.items():
        if not vals:
            continue
        mean = statistics.fmean(vals)
        spread = (f", sample std {statistics.stdev(vals):.2f}"
                  if len(vals) > 1 else "")
        print(f"- {name}: n = {len(vals)}, mean {mean:.2f} "
              f"({mean - jax_row[0]:+.2f}, "
              f"{verdict(abs(mean - jax_row[0]) <= MEAN)}), range "
              f"{min(vals):.2f}-{max(vals):.2f}{spread}")


if __name__ == "__main__":
    main()
