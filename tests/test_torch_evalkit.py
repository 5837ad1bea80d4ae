"""The port's COCO evaluation (``lsnet_torch.evalkit``) against the JAX
package's on the same seeded detections and ground truth: the
``COCOEval.summarize()`` numbers of bbox, segm and keypoints (1e-12: the
same numpy code), the polygon rasterisation ``rle_from_polygon``, and
``detections_to_coco`` from the port's ``Detections`` (torch tensors)
against the JAX one from the same arrays, for the four tasks.
"""

import numpy as np
import pytest
import torch

from lsnet_tpu.core.decode import Detections as JDetections
from lsnet_tpu.evalkit import cocoeval as jce
from lsnet_tpu.evalkit import evaluator as jev
from lsnet_tpu.evalkit import rle as jrle
from lsnet_torch.core.decode import Detections as PDetections
from lsnet_torch.evalkit import cocoeval as pce
from lsnet_torch.evalkit import evaluator as pev
from lsnet_torch.evalkit import rle as prle

N_IMG, H, W = 6, 96, 128


def _poly(rng, x, y, w, h, n=12):
    t = np.sort(rng.rand(n)) * 2 * np.pi
    return [float(v) for a in t for v in
            (x + w / 2 * (1 + np.cos(a)), y + h / 2 * (1 + np.sin(a)))]


def _kps(rng, x, y, w, h):
    out = []
    for _ in range(17):
        out += [float(x + rng.rand() * w), float(y + rng.rand() * h),
                int(rng.randint(0, 3))]
    return out


def _gt_and_dt(seed, iou_type):
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    aid = 0
    for img in range(N_IMG):
        for _ in range(rng.randint(1, 5)):
            w, h = 20 + rng.rand() * 60, 20 + rng.rand() * 50
            x, y = rng.rand() * (W - w), rng.rand() * (H - h)
            aid += 1
            g = dict(id=aid, image_id=img, category_id=int(rng.randint(1, 4)),
                     bbox=[x, y, w, h], area=w * h,
                     iscrowd=int(rng.rand() < 0.1))
            if iou_type == "segm":
                g["segmentation"] = [_poly(rng, x, y, w, h)]
            if iou_type == "keypoints":
                g["category_id"] = 1
                g["keypoints"] = _kps(rng, x, y, w, h)
                g["num_keypoints"] = sum(v > 0 for v in g["keypoints"][2::3])
            gts.append(g)
            for _ in range(rng.randint(0, 3)):
                j = rng.randn(4) * 4
                d = dict(image_id=img, category_id=g["category_id"],
                         bbox=[x + j[0], y + j[1], w + j[2], h + j[3]],
                         score=float(rng.rand()))
                d["area"] = d["bbox"][2] * d["bbox"][3]
                if iou_type == "segm":
                    d["segmentation"] = [_poly(rng, *d["bbox"])]
                if iou_type == "keypoints":
                    d["keypoints"] = [v + (rng.randn() * 2 if i % 3 < 2
                                           else 0.0)
                                      for i, v in enumerate(g["keypoints"])]
                dts.append(d)
    return gts, dts


@pytest.mark.parametrize("iou_type", ["bbox", "segm", "keypoints"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cocoeval_summaries_are_equal(iou_type, seed):
    gts, dts = _gt_and_dt(seed, iou_type)
    sizes = {i: (H, W) for i in range(N_IMG)}
    out = []
    for m in (jce, pce):
        params = (m.EvalParams.for_keypoints() if iou_type == "keypoints"
                  else m.EvalParams(iou_type=iou_type))
        out.append(np.asarray(m.COCOEval(gts, dts, sizes,
                                         params).evaluate().summarize()))
    assert out[0].shape == out[1].shape and len(out[0]) in (10, 12)
    assert np.isfinite(out[0]).all() and out[0].max() > 0
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=1e-12)
    assert jev.evaluate_coco(gts, dts, sizes, iou_type) == \
        pev.evaluate_coco(gts, dts, sizes, iou_type)


@pytest.mark.parametrize("seed", range(3))
def test_rle_from_polygon_is_equal(seed):
    rng = np.random.RandomState(seed)
    xy = _poly(rng, 10, 5, 60 + seed * 10, 40, n=5 + seed * 10)
    a, b = jrle.rle_from_polygon(xy, H, W), prle.rle_from_polygon(xy, H, W)
    assert (a.h, a.w) == (b.h, b.w)
    np.testing.assert_array_equal(a.cnts, b.cnts)
    assert jrle.rle_to_string(a) == prle.rle_to_string(b)
    np.testing.assert_array_equal(jrle.decode_mask(a), prle.decode_mask(b))


@pytest.mark.parametrize("task,nv", [("bbox", 4), ("segm", 36),
                                     ("pose_bbox", 17), ("pose_kbox", 17)])
def test_detections_to_coco_is_equal(task, nv):
    rng = np.random.RandomState(3)
    B, K = 2, 7
    xy = rng.rand(B, K, 2) * 50
    wh = 10 + rng.rand(B, K, 2) * 40
    arrays = dict(
        bboxes=np.concatenate([xy, xy + wh], -1).astype(np.float32),
        scores=rng.rand(B, K).astype(np.float32),
        labels=rng.randint(0, 3, (B, K)).astype(np.int32),
        landmarks=(rng.rand(B, K, 2 * nv) * 60).astype(np.float32),
        valid=rng.rand(B, K) < 0.7)
    img_ids = np.array([4, 9])
    label_to_cat = {0: 1, 1: 2, 2: 3}
    sizes = {4: (H, W), 9: (H, W)}
    want = jev.detections_to_coco(JDetections(**arrays), img_ids,
                                  label_to_cat, task=task, img_sizes=sizes)
    got = pev.detections_to_coco(
        PDetections(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
        img_ids, label_to_cat, task=task, img_sizes=sizes)
    assert len(want) > 0 and got == want
