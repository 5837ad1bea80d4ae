"""The port's own copy of ``lsnet_tpu/evalkit/cocoeval.py`` (numpy, host side).

COCO-style evaluation (bbox / segm / keypoints) in pure numpy.

Functional re-implementation of the vendored evaluator
(`cocoapi/pycocotools/pycocotools/cocoeval.py`, 607
LoC): per-(image, category) greedy IoU matching honoring iscrowd and
ignore regions, accumulation into the precision[T,R,K,A,M] tensor and the
12-number summary (6 for keypoints).  Keypoint similarity is the standard
OKS with the 17 COCO sigmas (`cocoeval.py:218-247`).

The image's pycocotools is absent, so this module *is* the eval backend —
the RLE layer (:mod:`lsnet_torch.evalkit.rle`) reproduces the reference mask
rasterization so segm numbers stay comparable.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import rle as maskUtils

OKS_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


@dataclass
class EvalParams:
    iou_type: str = "bbox"
    iou_thrs: np.ndarray = field(default_factory=lambda: np.linspace(
        0.5, 0.95, 10))
    rec_thrs: np.ndarray = field(default_factory=lambda: np.linspace(
        0.0, 1.00, 101))
    max_dets: Tuple[int, ...] = (1, 10, 100)
    area_rng: Tuple[Tuple[float, float], ...] = (
        (0, 1e10), (0, 32 ** 2), (32 ** 2, 96 ** 2), (96 ** 2, 1e10))
    area_lbl: Tuple[str, ...] = ("all", "small", "medium", "large")
    kpt_sigmas: np.ndarray = field(default_factory=lambda: OKS_SIGMAS.copy())

    @staticmethod
    def for_keypoints() -> "EvalParams":
        return EvalParams(
            iou_type="keypoints", max_dets=(20,),
            area_rng=((32 ** 2, 1e10), (32 ** 2, 96 ** 2), (96 ** 2, 1e10)),
            area_lbl=("all", "medium", "large"))


class COCOEval:
    """Evaluate detections against GT.

    gts / dts: lists of dicts with keys
      image_id, category_id, bbox [x,y,w,h], score (dt), area, iscrowd (gt),
      segmentation (segm mode), keypoints (kpt mode), ignore (optional).
    """

    def __init__(self, gts: Sequence[Dict], dts: Sequence[Dict],
                 img_sizes: Dict[int, Tuple[int, int]],
                 params: Optional[EvalParams] = None):
        self.p = params or EvalParams()
        self.img_sizes = img_sizes
        self.cat_ids = sorted({g["category_id"] for g in gts}
                              | {d["category_id"] for d in dts})
        self.img_ids = sorted({g["image_id"] for g in gts}
                              | {d["image_id"] for d in dts})
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for g in gts:
            self._gts[g["image_id"], g["category_id"]].append(g)
        for d in dts:
            self._dts[d["image_id"], d["category_id"]].append(d)
        self.eval: Dict = {}
        self.stats = np.zeros(0)

    # ------------------------------------------------------------- IoU

    def _compute_iou(self, img_id, cat_id) -> np.ndarray:
        p = self.p
        gts = self._gts[img_id, cat_id]
        dts = sorted(self._dts[img_id, cat_id],
                     key=lambda d: -d["score"])[: p.max_dets[-1]]
        if not gts or not dts:
            return np.zeros((0, 0))
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        if p.iou_type == "bbox":
            d = [np.asarray(x["bbox"], np.float64) for x in dts]
            g = [np.asarray(x["bbox"], np.float64) for x in gts]
            return maskUtils.iou(d, g, iscrowd)
        if p.iou_type == "segm":
            h, w = self.img_sizes[img_id]
            d = [maskUtils.segm_to_rle(x["segmentation"], h, w) for x in dts]
            g = [maskUtils.segm_to_rle(x["segmentation"], h, w) for x in gts]
            return maskUtils.iou(d, g, iscrowd)
        return self._compute_oks(dts, gts)

    def _compute_oks(self, dts, gts) -> np.ndarray:
        sig = self.p.kpt_sigmas
        var = (sig * 2) ** 2
        k = len(sig)
        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.asarray(gt["keypoints"], np.float64)
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = int((vg > 0).sum())
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.asarray(dt["keypoints"], np.float64)
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx, dy = xd - xg, yd - yg
                else:
                    z = np.zeros(k)
                    dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                    dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
                e = (dx ** 2 + dy ** 2) / var / (gt["area"] + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0
        return ious

    # ------------------------------------------------------------- match

    def _pack_category(self, cat):
        """Pad one category's per-image gts/dts into dense arrays so the
        greedy matching vectorizes ACROSS images (the reference matches in
        a per-(img, cat) python loop — `cocoeval.py:218-247` — which is
        the 5k-image wall; this runs the same greedy recurrence once per
        det rank over (n_imgs, T, G) tensors)."""
        p = self.p
        # pad to the category's ACTUAL maxima, not the nominal max_dets —
        # a COCO category typically has ~1-5 dets/image, not 100
        imgs = [i for i in self.img_ids
                if self._gts[i, cat] or self._dts[i, cat]]
        if not imgs:
            return None
        n = len(imgs)
        maxD = min(max(p.max_dets),
                   max(1, max(len(self._dts[i, cat]) for i in imgs)))
        G = max(1, max(len(self._gts[i, cat]) for i in imgs))
        iou_p = np.zeros((n, maxD, G))
        gt_crowd = np.zeros((n, G), bool)
        gt_base_ig = np.zeros((n, G), bool)
        gt_area = np.zeros((n, G))
        gt_valid = np.zeros((n, G), bool)
        dt_score = np.full((n, maxD), -np.inf)
        dt_area = np.zeros((n, maxD))
        dt_valid = np.zeros((n, maxD), bool)
        for ii, i in enumerate(imgs):
            gts = self._gts[i, cat]
            dts = sorted(self._dts[i, cat],
                         key=lambda d: -d["score"])[:maxD]
            for j, g in enumerate(gts):
                gt_crowd[ii, j] = bool(g.get("iscrowd", 0))
                gt_base_ig[ii, j] = bool(g.get("ignore", 0)
                                         or g.get("iscrowd", 0))
                gt_area[ii, j] = g.get("area",
                                       g["bbox"][2] * g["bbox"][3])
                gt_valid[ii, j] = True
            for j, d in enumerate(dts):
                dt_score[ii, j] = d["score"]
                dt_area[ii, j] = d.get("area",
                                       d["bbox"][2] * d["bbox"][3])
                dt_valid[ii, j] = True
            iou = self._ious[i, cat]
            if iou.size:
                iou_p[ii, :iou.shape[0], :iou.shape[1]] = iou
        return dict(n=n, G=G, iou=iou_p, crowd=gt_crowd, base_ig=gt_base_ig,
                    gt_area=gt_area, gt_valid=gt_valid, dt_score=dt_score,
                    dt_area=dt_area, dt_valid=dt_valid)

    def _match_category(self, pk, area_rng):
        """Vectorized greedy matching for one (category, area range).

        Exact reference semantics (`cocoeval.py evaluateImg`): per det in
        score order, best available non-ignored GT with IoU >= thr (last
        of equals), else best ignored GT; crowd GTs stay claimable."""
        p = self.p
        thr0 = np.minimum(np.asarray(p.iou_thrs, np.float64), 1 - 1e-10)
        T = len(thr0)
        n, G = pk["n"], pk["G"]
        maxD = pk["iou"].shape[1]
        gt_ig = (pk["base_ig"] | (pk["gt_area"] < area_rng[0])
                 | (pk["gt_area"] > area_rng[1])) | ~pk["gt_valid"]
        gtm = np.zeros((n, T, G), bool)
        dt_matched = np.zeros((n, T, maxD), bool)
        dt_igm = np.zeros((n, T, maxD), bool)
        crowd3 = pk["crowd"][:, None, :]
        valid3 = pk["gt_valid"][:, None, :]
        ig3 = gt_ig[:, None, :]
        g_rev = np.arange(G)[::-1]
        rows = np.arange(n)[:, None]
        for d in range(maxD):
            iou_d = pk["iou"][:, d, :][:, None, :]
            avail = (~gtm | crowd3) & valid3
            cand = np.where(avail, iou_d, -1.0)
            nonig = np.where(~ig3, cand, -1.0)
            igc = np.where(ig3, cand, -1.0)
            b1 = nonig.max(-1)
            m1 = G - 1 - np.argmax(nonig[:, :, g_rev], -1)
            b2 = igc.max(-1)
            m2 = G - 1 - np.argmax(igc[:, :, g_rev], -1)
            use1 = b1 >= thr0[None, :]
            use2 = ~use1 & (b2 >= thr0[None, :])
            m = np.where(use1, m1, np.where(use2, m2, -1))
            ok = (m >= 0) & pk["dt_valid"][:, d][:, None]
            midx = np.maximum(m, 0)
            hit = (np.arange(G)[None, None, :] == m[:, :, None]) \
                & ok[:, :, None]
            gtm |= hit
            dt_matched[:, :, d] = ok
            dt_igm[:, :, d] = ok & gt_ig[rows, midx]
        dt_out = ((pk["dt_area"] < area_rng[0])
                  | (pk["dt_area"] > area_rng[1]))
        dt_igm |= ~dt_matched & dt_out[:, None, :]
        num_gt = int((~gt_ig & pk["gt_valid"]).sum())
        return dt_matched, dt_igm, num_gt

    # ------------------------------------------------------------- run

    def evaluate(self):
        p = self.p
        self._ious = {(i, c): self._compute_iou(i, c)
                      for i in self.img_ids for c in self.cat_ids}
        T = len(p.iou_thrs)
        R = len(p.rec_thrs)
        K = len(self.cat_ids)
        A = len(p.area_rng)
        M = len(p.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat in enumerate(self.cat_ids):
            pk = self._pack_category(cat)
            if pk is None:
                continue
            for a, arng in enumerate(p.area_rng):
                dt_matched, dt_igm, npig = self._match_category(pk, arng)
                if npig == 0:
                    continue
                for m, max_det in enumerate(p.max_dets):
                    sc = pk["dt_score"][:, :max_det].reshape(-1)
                    vmask = pk["dt_valid"][:, :max_det].reshape(-1)
                    dtm = dt_matched[:, :, :max_det].transpose(1, 0, 2) \
                        .reshape(T, -1)[:, vmask]
                    dt_ig = dt_igm[:, :, :max_det].transpose(1, 0, 2) \
                        .reshape(T, -1)[:, vmask]
                    sc = sc[vmask]
                    order = np.argsort(-sc, kind="mergesort")
                    sorted_scores = sc[order]
                    dtm = dtm[:, order]
                    dt_ig = dt_ig[:, order]
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(~dtm, np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if rc.size else 0
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        # monotone envelope (reference's backward fix-up
                        # loop, vectorized)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, p.rec_thrs, side="left")
                        inside = inds < len(pr)
                        q[inside] = pr[inds[inside]]
                        ss[inside] = sorted_scores[inds[inside]]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {"precision": precision, "recall": recall,
                     "scores": scores}
        return self

    # ------------------------------------------------------------- summary

    def _summarize(self, ap=1, iou_thr=None, area="all", max_dets=100):
        p = self.p
        aind = [i for i, l in enumerate(p.area_lbl) if l == area]
        mind = [i for i, d in enumerate(p.max_dets) if d == max_dets]
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                t = np.where(np.isclose(p.iou_thrs, iou_thr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                t = np.where(np.isclose(p.iou_thrs, iou_thr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> np.ndarray:
        p = self.p
        if p.iou_type == "keypoints":
            md = p.max_dets[0]
            stats = np.array([
                self._summarize(1, max_dets=md),
                self._summarize(1, 0.5, max_dets=md),
                self._summarize(1, 0.75, max_dets=md),
                self._summarize(1, area="medium", max_dets=md),
                self._summarize(1, area="large", max_dets=md),
                self._summarize(0, max_dets=md),
                self._summarize(0, 0.5, max_dets=md),
                self._summarize(0, 0.75, max_dets=md),
                self._summarize(0, area="medium", max_dets=md),
                self._summarize(0, area="large", max_dets=md),
            ])
        else:
            stats = np.array([
                self._summarize(1),
                self._summarize(1, 0.5),
                self._summarize(1, 0.75),
                self._summarize(1, area="small"),
                self._summarize(1, area="medium"),
                self._summarize(1, area="large"),
                self._summarize(0, max_dets=p.max_dets[0]),
                self._summarize(0, max_dets=p.max_dets[1]),
                self._summarize(0, max_dets=p.max_dets[2]),
                self._summarize(0, area="small"),
                self._summarize(0, area="medium"),
                self._summarize(0, area="large"),
            ])
        self.stats = stats
        return stats
