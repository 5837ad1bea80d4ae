"""Per-category COCO error analysis: progressively relaxed PR curves (the
port's ``tools/coco_error_analysis.py``).

    python3 -m lsnet_torch.tools.coco_error_analysis RESULT_JSON OUT_DIR \
        --ann ANN_JSON [--types bbox segm] [--max-cats N] \
        [--areas all small medium large]

From a COCO-format detection result json and the annotation json it
computes, per category and overall, the 7 analysis bands

  C75  precision at IoU .75
  C50  precision at IoU .50
  Loc  precision at IoU .10 (localization errors forgiven)
  Sim  + supercategory confusions forgiven (same-supercategory GT ignored)
  Oth  + all class confusions forgiven (all other-category GT ignored)
  BG   + background false positives removed
  FN   + missed detections removed (1 by construction)

plots one figure per category and area (``makeplot``, which imports
matplotlib when it runs) and writes each band's mean precision to
``OUT_DIR/analysis.json``. :func:`analyze_files` computes the bands and
that summary without plotting. The evaluator is the port's COCOEval
(:mod:`lsnet_torch.evalkit.cocoeval`); the Sim and Oth passes re-run it
with the other categories' GT relabelled into the target class with
``ignore=1``. Host only: it needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

# Band fills: the first five are the validated adjacent categorical order
# (docs: dataviz reference palette slots 1-5); BG/FN are neutrals separated
# by lightness. Identity is carried by the legend (name + AP), never color
# alone; 2px white edges separate adjacent fills.
BAND_COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4",
               "#8a8878", "#dcdad2"]
BAND_NAMES = ["C75", "C50", "Loc", "Sim", "Oth", "BG", "FN"]


def _load_ann(ann_file):
    with open(ann_file) as f:
        data = json.load(f)
    img_sizes = {im["id"]: (im["height"], im["width"])
                 for im in data["images"]}
    cats = {c["id"]: c for c in data["categories"]}
    gts = []
    for a in data["annotations"]:
        g = dict(image_id=a["image_id"], category_id=a["category_id"],
                 bbox=a["bbox"], area=a.get(
                     "area", a["bbox"][2] * a["bbox"][3]),
                 iscrowd=a.get("iscrowd", 0), ignore=a.get("ignore", 0))
        if "segmentation" in a:
            g["segmentation"] = a["segmentation"]
        if "keypoints" in a:
            g["keypoints"] = a["keypoints"]
        gts.append(g)
    return gts, img_sizes, cats


def _eval_precision(gts, dts, img_sizes, iou_type, iou_thrs, cat_ids=None):
    """precision[T, R, K, A] at max_dets=100 for the requested categories."""
    from ..evalkit.cocoeval import COCOEval, EvalParams

    params = EvalParams(iou_type=iou_type,
                        iou_thrs=np.asarray(iou_thrs, np.float64),
                        max_dets=(100,))
    ev = COCOEval(gts, dts, img_sizes, params).evaluate()
    prec = ev.eval["precision"][..., 0]          # (T, R, K, A)
    if cat_ids is None:
        return prec, ev.cat_ids
    # re-order/pad to the requested category axis
    out = -np.ones(prec.shape[:2] + (len(cat_ids),) + prec.shape[3:])
    for j, c in enumerate(cat_ids):
        if c in ev.cat_ids:
            out[:, :, j] = prec[:, :, ev.cat_ids.index(c)]
    return out, list(cat_ids)


def analyze_results(gts, dts, img_sizes, cats, iou_type="bbox",
                    max_cats=None, progress=print):
    """Build the (7, R, K, A) analysis tensor (reference `analyze_results`).

    Returns (ps, rec_thrs, cat_ids). Band order: C75 C50 Loc Sim Oth BG FN.
    """
    cat_ids = sorted({d["category_id"] for d in dts} & set(cats))
    if max_cats:
        cat_ids = cat_ids[:max_cats]
    base, cat_ids = _eval_precision(
        gts, dts, img_sizes, iou_type, [0.75, 0.5, 0.1], cat_ids)
    T, R, K, A = base.shape
    ps = -np.ones((7, R, K, A))
    ps[:3] = base

    gts_by_cat = defaultdict(list)
    for g in gts:
        gts_by_cat[g["category_id"]].append(g)
    dts_by_cat = defaultdict(list)
    for d in dts:
        dts_by_cat[d["category_id"]].append(d)

    for k, cid in enumerate(cat_ids):
        super_of = cats[cid].get("supercategory")
        progress(f"  [{k + 1}/{len(cat_ids)}] {cats[cid].get('name', cid)}")
        own = gts_by_cat[cid]
        sim_ig, oth_ig = [], []
        for oc, og in gts_by_cat.items():
            if oc == cid:
                continue
            relab = [dict(g, category_id=cid, ignore=1) for g in og]
            oth_ig.extend(relab)
            if cats.get(oc, {}).get("supercategory") == super_of:
                sim_ig.extend(relab)
        dk = dts_by_cat[cid]
        for band, extra in ((3, sim_ig), (4, oth_ig)):
            prec, _ = _eval_precision(own + extra, dk, img_sizes,
                                      iou_type, [0.1], [cid])
            ps[band, :, k] = prec[0, :, 0]
    # fill-in bands (reference: `ps[ps==-1]=0; ps[5]=ps[4]>0; ps[6]=1`)
    ps[ps == -1] = 0.0
    ps[5] = (ps[4] > 0).astype(np.float64)
    ps[6] = 1.0
    rec_thrs = np.linspace(0.0, 1.0, R)
    return ps, rec_thrs, cat_ids


def makeplot(rec_thrs, ps_k, out_path, title):
    """One analysis figure: nested bands filled down to the next curve."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5.2, 4.4), dpi=120)
    lower = np.zeros_like(rec_thrs)
    aps = ps_k.mean(axis=1)
    for i in range(len(BAND_NAMES)):
        band = ps_k[i]
        ax.fill_between(rec_thrs, lower, band, color=BAND_COLORS[i],
                        edgecolor="white", linewidth=1.2, zorder=2,
                        label=f"[{aps[i]:.3f}] {BAND_NAMES[i]}")
        lower = band
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_xlabel("recall", color="#52514e")
    ax.set_ylabel("precision", color="#52514e")
    ax.set_title(title, color="#0b0b0b")
    ax.grid(True, color="#e6e4de", linewidth=0.6, zorder=0)
    for s in ax.spines.values():
        s.set_color("#b9b7b0")
    ax.legend(loc="lower left", fontsize=8, framealpha=0.9)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def analyze_files(result, ann, types=("bbox",), max_cats=None,
                  progress=print):
    """``analyze_results`` of a COCO result json against an annotation
    json for each of ``types``. Returns ({iou_type: (ps, rec_thrs,
    cat_ids)}, the categories by id, the summary ``{iou_type: {band: mean
    precision at area all}}`` that ``main`` writes)."""
    gts, img_sizes, cats = _load_ann(ann)
    with open(result) as f:
        dts = json.load(f)
    analyses, summary = {}, {}
    for iou_type in types:
        g, d = gts, dts
        if iou_type == "segm":
            # cocoeval converts raw polygons/RLE dicts itself (segm_to_rle)
            g = [x for x in g if x.get("segmentation") is not None]
            d = [x for x in d if x.get("segmentation") is not None]
        ps, rec_thrs, cat_ids = analyze_results(
            g, d, img_sizes, cats, iou_type, max_cats, progress)
        analyses[iou_type] = (ps, rec_thrs, cat_ids)
        summary[iou_type] = {
            BAND_NAMES[i]: float(ps[i, :, :, 0].mean())
            for i in range(len(BAND_NAMES))}
    return analyses, cats, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description="COCO error analysis")
    ap.add_argument("result", help="COCO-format detection result json")
    ap.add_argument("out_dir")
    ap.add_argument("--ann", required=True, help="annotation json")
    ap.add_argument("--types", nargs="+", default=["bbox"],
                    choices=["bbox", "segm"])
    ap.add_argument("--max-cats", type=int, default=None,
                    help="analyze only the first N categories (smoke runs)")
    ap.add_argument("--areas", nargs="+", default=["all"],
                    choices=["all", "small", "medium", "large"])
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    analyses, cats, summary = analyze_files(
        args.result, args.ann, args.types, args.max_cats)
    area_ix = {"all": 0, "small": 1, "medium": 2, "large": 3}
    for iou_type, (ps, rec_thrs, cat_ids) in analyses.items():
        for area in args.areas:
            a = area_ix[area]
            for k, cid in enumerate(cat_ids):
                name = cats[cid].get("name", str(cid))
                makeplot(rec_thrs, ps[:, :, k, a],
                         os.path.join(args.out_dir,
                                      f"{iou_type}-{area}-{name}.png"),
                         f"{name} ({iou_type}, {area})")
            makeplot(rec_thrs, ps[:, :, :, a].mean(axis=2),
                     os.path.join(args.out_dir,
                                  f"{iou_type}-{area}-allclass.png"),
                     f"all classes ({iou_type}, {area})")
    with open(os.path.join(args.out_dir, "analysis.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
