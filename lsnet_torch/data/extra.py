"""The port's own copy of ``lsnet_tpu/data/extra.py`` (numpy, host side):
the non-COCO datasets, VOC / WIDER Face (XML-style) and Cityscapes / LVIS /
DeepFashion (COCO-style), the ``DATASET_TYPES`` registry with its eight
keys and ``build_dataset``, and the VOC mAP evaluator ``eval_map``.

Re-derivations of the reference dataset zoo (mmdet's
``datasets/{voc,xml_style,wider_face,cityscapes,lvis,deepfashion}.py``
and ``core/evaluation/mean_ap.py``) over the sample-dict pipeline of
:mod:`lsnet_torch.data.coco`: every dataset duck-types ``CocoDataset``
(``img_infos`` / ``get_sample`` / ``cfg``) so the grouped static-canvas
``DataLoader`` takes it unchanged. ``CocoPoseDataset`` (the pose files'
type) is ``CocoDataset``: the person-only filter follows
``DatasetConfig.task``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .coco import CocoDataset, DatasetConfig
from .lsvr import extreme_points_with_center
from .transforms import (hflip_sample, normalize_image, resize_sample,
                         sample_scale)

VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")

CITYSCAPES_CLASSES = ("person", "rider", "car", "truck", "bus", "train",
                      "motorcycle", "bicycle")

DEEPFASHION_CLASSES = ("top", "skirt", "leggings", "dress", "outer",
                       "pants", "bag", "neckwear", "headwear", "eyeglass",
                       "belt", "footwear", "hair", "skin", "face")


class XmlDataset:
    """VOC-style dataset: an imageset list file + per-image XML annotations
    (reference ``XMLDataset``, `xml_style.py`). bbox task only; extreme
    points fall back to the bbox rectangle (reference behavior for datasets
    without segmentation)."""

    CLASSES: Tuple[str, ...] = ()

    def __init__(self, cfg: DatasetConfig, test_mode: bool = False):
        self.cfg = cfg
        self.test_mode = test_mode
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        self.img_infos = self._load(cfg.ann_file)
        if not test_mode and cfg.filter_empty:
            self.img_infos = [i for i in self.img_infos if i["_n_anns"] > 0]

    # -- XML layout hooks (overridden by WiderFace) --------------------
    def _img_path(self, img_id: str, root: ET.Element) -> str:
        return os.path.join(self.cfg.img_prefix, "JPEGImages",
                            f"{img_id}.jpg")

    def _xml_path(self, img_id: str) -> str:
        return os.path.join(self.cfg.img_prefix, "Annotations",
                            f"{img_id}.xml")

    def _load(self, ann_file: str) -> List[Dict]:
        with open(ann_file) as f:
            img_ids = [ln.strip() for ln in f if ln.strip()]
        infos = []
        for idx, img_id in enumerate(img_ids):
            tree = ET.parse(self._xml_path(img_id))
            root = tree.getroot()
            size = root.find("size")
            w = int(size.find("width").text) if size is not None else 0
            h = int(size.find("height").text) if size is not None else 0
            n = len([o for o in root.findall("object")
                     if o.find("name").text in self.cat2label])
            infos.append(dict(id=idx, img_id=img_id, width=w, height=h,
                              _n_anns=n))
        return infos

    def __len__(self) -> int:
        return len(self.img_infos)

    def _parse_objects(self, img_id: str):
        root = ET.parse(self._xml_path(img_id)).getroot()
        bboxes, labels = [], []
        for obj in root.findall("object"):
            name = obj.find("name").text
            if name not in self.cat2label:
                continue
            diff = obj.find("difficult")
            if diff is not None and int(diff.text) == 1 and not self.test_mode:
                continue
            bb = obj.find("bndbox")
            # VOC boxes are 1-based inclusive
            x1 = float(bb.find("xmin").text) - 1
            y1 = float(bb.find("ymin").text) - 1
            x2 = float(bb.find("xmax").text) - 1
            y2 = float(bb.find("ymax").text) - 1
            if self.cfg.min_size and (x2 - x1 < 1 or y2 - y1 < 1):
                continue
            bboxes.append([x1, y1, x2, y2])
            labels.append(self.cat2label[name])
        return (np.asarray(bboxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int32))

    def get_sample(self, idx: int,
                   rng: Optional[np.random.RandomState] = None) -> Dict:
        info = self.img_infos[idx]
        from PIL import Image
        root = ET.parse(self._xml_path(info["img_id"])).getroot()
        with Image.open(self._img_path(info["img_id"], root)) as im:
            img = np.asarray(im.convert("RGB"))
        bboxes, labels = self._parse_objects(info["img_id"])
        extremes = (np.stack([extreme_points_with_center(
            np.array([[b[0], b[1]], [b[2], b[1]], [b[2], b[3]],
                      [b[0], b[3]]], np.float32), b) for b in bboxes])
            if len(bboxes) else np.zeros((0, 10), np.float32))
        sample = {"image": img, "img_id": info["id"], "gt_bboxes": bboxes,
                  "gt_labels": labels, "gt_extremes": extremes}
        if self.test_mode or rng is None:
            scale = self.cfg.test_scale()
        else:
            scale = sample_scale(self.cfg.img_scale, self.cfg.multiscale_mode,
                                 self.cfg.ratio_range, rng)
        sample = resize_sample(sample, scale)
        if (not self.test_mode and rng is not None
                and rng.rand() < self.cfg.flip_ratio):
            sample = hflip_sample(sample)
        sample["image"] = normalize_image(sample["image"])
        return sample


class VOCDataset(XmlDataset):
    """Pascal VOC (reference `voc.py`)."""
    CLASSES = VOC_CLASSES

    def __init__(self, cfg: DatasetConfig, test_mode: bool = False):
        super().__init__(cfg, test_mode)
        if "VOC2007" in cfg.img_prefix:
            self.year = 2007
        elif "VOC2012" in cfg.img_prefix:
            self.year = 2012
        else:
            self.year = 2012


class WiderFaceDataset(XmlDataset):
    """WIDER Face (reference `wider_face.py`): images live in per-event
    folders recorded in the XML ``folder`` tag."""
    CLASSES = ("face",)

    def _img_path(self, img_id: str, root: ET.Element) -> str:
        folder = root.find("folder")
        sub = folder.text if folder is not None else ""
        return os.path.join(self.cfg.img_prefix, "WIDER_train", "images",
                            sub, f"{img_id}.jpg")


class CityscapesDataset(CocoDataset):
    """Cityscapes instance segmentation in COCO json form
    (reference `cityscapes.py` — it too consumes cocostyle jsons)."""
    CLASSES = CITYSCAPES_CLASSES


class DeepFashionDataset(CocoDataset):
    CLASSES = DEEPFASHION_CLASSES


class LVISDataset(CocoDataset):
    """LVIS v0.5/v1 (reference `lvis.py`): COCO-like json where images may
    carry ``coco_url`` instead of ``file_name`` and annotations have no
    ``iscrowd``. Evaluation reuses the COCO backend (fixed-AP extensions
    are out of scope for LSNet parity)."""

    def __init__(self, cfg: DatasetConfig, test_mode: bool = False):
        super().__init__(cfg, test_mode)
        for info in self.coco.img_infos:
            if "file_name" not in info and "coco_url" in info:
                # http://images.cocodataset.org/train2017/xxx.jpg
                info["file_name"] = "/".join(
                    info["coco_url"].split("/")[-2:])


DATASET_TYPES = {
    "CocoDataset": CocoDataset,
    "CocoPoseDataset": CocoDataset,   # person_only switch lives in cfg.task
    "VOCDataset": VOCDataset,
    "WIDERFaceDataset": WiderFaceDataset,
    "CityscapesDataset": CityscapesDataset,
    "DeepFashionDataset": DeepFashionDataset,
    "LVISDataset": LVISDataset,
    "LVISV1Dataset": LVISDataset,
}


def dataset_class(type_name: str):
    """The registry's class of ``type_name``; an unknown type raises
    ``KeyError``."""
    if type_name not in DATASET_TYPES:
        raise KeyError(f"unknown dataset type {type_name!r}; "
                       f"known: {sorted(DATASET_TYPES)}")
    return DATASET_TYPES[type_name]


def build_dataset(type_name: str, cfg: DatasetConfig, test_mode: bool = False):
    """Registry-style dataset construction (reference ``build_dataset``);
    an unknown type raises ``KeyError``."""
    return dataset_class(type_name)(cfg, test_mode=test_mode)


# ------------------------------------------------------------ VOC mAP -----

def _voc_ap(recall: np.ndarray, precision: np.ndarray,
            use_07_metric: bool = False) -> float:
    """AP from a PR curve (reference ``average_precision``,
    `core/evaluation/mean_ap.py`): 'area' mode, or the VOC2007 11-point."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = precision[recall >= t].max() if (recall >= t).any() else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def eval_map(det_results: Sequence[Sequence[np.ndarray]],
             annotations: Sequence[Dict], *, iou_thr: float = 0.5,
             use_07_metric: bool = False) -> Tuple[float, List[Dict]]:
    """VOC-protocol mean AP (reference ``eval_map``).

    Args:
      det_results: per-image list of per-class (n, 5) [x1 y1 x2 y2 score].
      annotations: per-image dicts with 'bboxes' (m, 4) and 'labels' (m,).
    Returns (mAP, per-class results).
    """
    num_classes = len(det_results[0])
    cls_results = []
    for c in range(num_classes):
        tp_fp: List[Tuple[float, int, int]] = []   # score, tp, fp
        n_gt = 0
        for dets_img, ann in zip(det_results, annotations):
            gt = ann["bboxes"][ann["labels"] == c]
            n_gt += len(gt)
            dets = dets_img[c]
            if len(dets) == 0:
                continue
            order = np.argsort(-dets[:, 4])
            dets = dets[order]
            matched = np.zeros(len(gt), bool)
            for d in dets:
                if len(gt):
                    ixmin = np.maximum(gt[:, 0], d[0])
                    iymin = np.maximum(gt[:, 1], d[1])
                    ixmax = np.minimum(gt[:, 2], d[2])
                    iymax = np.minimum(gt[:, 3], d[3])
                    iw = np.maximum(ixmax - ixmin, 0)
                    ih = np.maximum(iymax - iymin, 0)
                    inter = iw * ih
                    uni = ((d[2] - d[0]) * (d[3] - d[1])
                           + (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
                           - inter)
                    ious = inter / np.maximum(uni, 1e-10)
                    best = int(np.argmax(ious))
                    if ious[best] >= iou_thr and not matched[best]:
                        matched[best] = True
                        tp_fp.append((d[4], 1, 0))
                        continue
                tp_fp.append((d[4], 0, 1))
        if not tp_fp:
            cls_results.append(dict(num_gts=n_gt, num_dets=0, ap=0.0))
            continue
        arr = np.asarray(sorted(tp_fp, key=lambda t: -t[0]), np.float64)
        tp = np.cumsum(arr[:, 1])
        fp = np.cumsum(arr[:, 2])
        recall = tp / max(n_gt, 1)
        precision = tp / np.maximum(tp + fp, 1e-10)
        ap = _voc_ap(recall, precision, use_07_metric) if n_gt else 0.0
        cls_results.append(dict(num_gts=n_gt, num_dets=len(arr), ap=ap))
    aps = [r["ap"] for r in cls_results if r["num_gts"] > 0]
    return (float(np.mean(aps)) if aps else 0.0), cls_results
