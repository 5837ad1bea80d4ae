"""The port's own copy of ``lsnet_tpu/data/coco.py`` (numpy, host side).

COCO dataset + static-shape batch assembly (host side).

Replaces the reference data layer (`mmdet/datasets/coco.py`,
`coco_pose.py` and the dataset factory) the TPU way: variable image sizes
become a *static padded canvas* per batch (replacing the aspect-ratio
GroupSampler with shape bucketing), GT is padded to ``max_instances`` with a
validity mask, and per-host sharding replaces DistributedGroupSampler.

Annotation parsing is json-direct (no pycocotools dependency): extreme
points are computed on the fly from segmentation polygons
(:mod:`lsnet_torch.data.lsvr`), matching the offline ``gen_coco_lsvr.py``
output the reference expects (`coco.py:159-183`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .lsvr import extreme_points_with_center, unify_polygon
from .transforms import (canvas_for_scale, hflip_sample, normalize_image,
                         pad_divisor_shape, pad_to_shape, resize_sample,
                         sample_scale)


@dataclass
class CocoAnnotations:
    """Parsed COCO index (images, anns by image, category remap)."""
    img_infos: List[Dict]
    anns_by_img: Dict[int, List[Dict]]
    cat_to_label: Dict[int, int]

    @staticmethod
    def load(ann_file: str, person_only: bool = False) -> "CocoAnnotations":
        with open(ann_file) as f:
            data = json.load(f)
        cats = sorted(c["id"] for c in data["categories"])
        if person_only:
            cats = [c for c in cats if c == 1]
        cat_to_label = {c: i for i, c in enumerate(cats)}
        anns_by_img: Dict[int, List[Dict]] = {}
        for ann in data["annotations"]:
            if ann.get("iscrowd", 0):
                continue
            if person_only and ann["category_id"] != 1:
                continue
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        img_infos = [im for im in data["images"]]
        return CocoAnnotations(img_infos, anns_by_img, cat_to_label)


@dataclass
class DatasetConfig:
    ann_file: str
    img_prefix: str
    task: str = "bbox"               # bbox | segm | pose
    num_vectors: int = 4
    # one (long, short) tuple, or a list of tuples for multi-scale training
    # (reference Resize `multiscale_mode` semantics, transforms.py:79-176)
    img_scale: Tuple[int, int] = (1333, 800)
    multiscale_mode: str = "range"   # 'range' | 'value'
    ratio_range: Optional[Tuple[float, float]] = None
    flip_ratio: float = 0.5
    max_instances: int = 100
    size_divisor: int = 32
    filter_empty: bool = True
    min_size: int = 32               # reference `coco.py` _filter_imgs
    # training augmentation pipeline (reference transforms.py :508-933):
    # list of dicts, e.g. (dict(type='PhotoMetricDistortion'),
    # dict(type='Expand'), dict(type='MinIoURandomCrop')).  A
    # dict(type='Resize') entry marks the resize position — augs before it
    # run on the raw image, augs after it (e.g. RandomCrop with a
    # crop_size in resized pixels) run post-resize.
    augmentations: Tuple = ()
    keep_ratio: bool = True          # False: exact img_scale resize (SSD)
    # robustness benchmark: (corruption_name, severity) applied to the raw
    # loaded image, the reference Corrupt-after-LoadImage position
    # (`tools/test_robustness.py` pipeline patch)
    corruption: Optional[Tuple[str, int]] = None

    def test_scale(self) -> Tuple[int, int]:
        """Deterministic scale for test mode (first scale of the spec)."""
        s = self.img_scale
        if isinstance(s, (list, tuple)) and len(s) and \
                isinstance(s[0], (list, tuple)):
            return tuple(s[0])
        return tuple(s)


class CocoDataset:
    """Training/eval dataset producing per-sample dicts (numpy)."""

    def __init__(self, cfg: DatasetConfig, test_mode: bool = False):
        self.cfg = cfg
        self.test_mode = test_mode
        if cfg.corruption is not None:
            raise NotImplementedError(
                "image corruptions (data/corruptions.py) are not ported "
                "yet: ROADMAP Queue 1 \"Inherited zoo\"")
        if not test_mode:
            # validate the scale spec eagerly: a bad multiscale config must
            # fail at dataset construction, not minutes later in the first
            # batch (after model compile)
            sample_scale(cfg.img_scale, cfg.multiscale_mode, cfg.ratio_range,
                         np.random.RandomState(0))
        self.coco = CocoAnnotations.load(cfg.ann_file,
                                         person_only=cfg.task == "pose")
        self.img_infos = self._filter(self.coco.img_infos)
        from .transforms import build_aug_pipeline
        specs = list(cfg.augmentations or ())
        split = next((i for i, s in enumerate(specs)
                      if s.get("type") == "Resize"), len(specs))
        self._aug_pre = build_aug_pipeline(specs[:split])
        self._aug_post = build_aug_pipeline(specs[split + 1:])

    def _filter(self, infos: List[Dict]) -> List[Dict]:
        if self.test_mode or not self.cfg.filter_empty:
            return infos
        keep = []
        for im in infos:
            anns = self.coco.anns_by_img.get(im["id"], [])
            if anns and min(im["width"], im["height"]) >= self.cfg.min_size:
                keep.append(im)
        return keep

    def __len__(self) -> int:
        return len(self.img_infos)

    def _load_image(self, info: Dict) -> np.ndarray:
        path = os.path.join(self.cfg.img_prefix, info["file_name"])
        try:
            from PIL import Image
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"))
        except ImportError:
            import imageio.v3 as iio  # pragma: no cover
            return iio.imread(path)

    def get_sample(self, idx: int, rng: Optional[np.random.RandomState] = None
                   ) -> Dict:
        info = self.img_infos[idx]
        anns = self.coco.anns_by_img.get(info["id"], [])
        img = self._load_image(info)
        sample: Dict = {"image": img, "img_id": info["id"]}

        bboxes, labels = [], []
        extremes, polygons, kps = [], [], []
        for ann in anns:
            x, y, w, h = ann["bbox"]
            if w < 1 or h < 1:
                continue
            bbox = np.array([x, y, x + w, y + h], np.float32)
            bboxes.append(bbox)
            labels.append(self.coco.cat_to_label[ann["category_id"]])
            if self.cfg.task == "bbox":
                if "extreme_points" in ann:
                    extremes.append(np.asarray(ann["extreme_points"],
                                               np.float32))
                else:
                    seg = ann.get("segmentation")
                    if isinstance(seg, list) and seg:
                        pts = np.concatenate(
                            [np.asarray(s).reshape(-1, 2) for s in seg])
                    else:
                        pts = np.array([[x, y], [x + w, y], [x + w, y + h],
                                        [x, y + h]], np.float32)
                    extremes.append(extreme_points_with_center(pts, bbox))
            elif self.cfg.task == "segm":
                seg = ann.get("segmentation")
                comps = seg if isinstance(seg, list) else []
                polygons.append(
                    unify_polygon(comps, bbox,
                                  num_points=self.cfg.num_vectors).reshape(-1))
            elif self.cfg.task == "pose":
                kps.append(np.asarray(ann.get("keypoints",
                                              [0] * (self.cfg.num_vectors * 3)),
                                      np.float32))

        n = len(bboxes)
        sample["gt_bboxes"] = (np.stack(bboxes) if n else
                               np.zeros((0, 4), np.float32))
        sample["gt_labels"] = np.asarray(labels, np.int32)
        if self.cfg.task == "bbox":
            sample["gt_extremes"] = (np.stack(extremes) if n else
                                     np.zeros((0, 10), np.float32))
        elif self.cfg.task == "segm":
            sample["gt_polygons"] = (np.stack(polygons) if n else
                                     np.zeros((0, self.cfg.num_vectors * 2),
                                              np.float32))
        elif self.cfg.task == "pose":
            sample["gt_keypoints_vs"] = (np.stack(kps) if n else
                                         np.zeros((0, self.cfg.num_vectors * 3),
                                                  np.float32))

        if self.test_mode or rng is None:
            scale = self.cfg.test_scale()
        else:
            scale = sample_scale(self.cfg.img_scale, self.cfg.multiscale_mode,
                                 self.cfg.ratio_range, rng)

        def resize_and_post(s, r):
            s = resize_sample(s, scale, keep_ratio=self.cfg.keep_ratio)
            if self._aug_post is not None and r is not None:
                s = self._aug_post(s, r)
            return s

        if self.test_mode or rng is None or (self._aug_pre is None
                                             and self._aug_post is None):
            sample = resize_and_post(sample, rng)
        else:
            # augmentations can invalidate every GT (crop misses all boxes;
            # reference returns None and skips the image) — retry with fresh
            # randomness, falling back to the un-augmented sample
            out = None
            for _ in range(10):
                s = sample
                if self._aug_pre is not None:
                    s = self._aug_pre(s, rng)
                    if s is None:
                        continue
                s = resize_and_post(s, rng)
                if s is not None:
                    out = s
                    break
            sample = out if out is not None else resize_sample(
                sample, scale, keep_ratio=self.cfg.keep_ratio)
        if not self.test_mode and rng is not None and rng.rand() < self.cfg.flip_ratio:
            sample = hflip_sample(sample)
        sample["image"] = normalize_image(sample["image"])
        return sample


def collate_batch(samples: Sequence[Dict], canvas_hw: Tuple[int, int],
                  max_instances: int = 100, task: str = "bbox",
                  num_vectors: int = 4) -> Dict[str, np.ndarray]:
    """Pad samples onto a static canvas + fixed-M GT arrays with masks."""
    B = len(samples)
    H, W = canvas_hw
    batch: Dict[str, np.ndarray] = {
        "image": np.zeros((B, H, W, 3), np.float32),
        "pad_shape": np.zeros((B, 2), np.int32),
        "img_shape": np.zeros((B, 2), np.int32),
        "scale_factor": np.zeros((B, 4), np.float32),
        "gt_bboxes": np.zeros((B, max_instances, 4), np.float32),
        "gt_labels": np.zeros((B, max_instances), np.int32),
        "gt_valid": np.zeros((B, max_instances), bool),
        "img_id": np.zeros((B,), np.int64),
    }
    if task == "bbox":
        batch["gt_extremes"] = np.zeros((B, max_instances, 10), np.float32)
    elif task == "segm":
        batch["gt_polygons"] = np.zeros((B, max_instances, num_vectors * 2),
                                        np.float32)
    elif task == "pose":
        batch["gt_keypoints_vs"] = np.zeros(
            (B, max_instances, num_vectors * 3), np.float32)

    for i, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        batch["image"][i] = pad_to_shape(s["image"], canvas_hw)
        ph, pw = pad_divisor_shape(h, w)
        batch["pad_shape"][i] = (ph, pw)
        batch["img_shape"][i] = (h, w)
        batch["scale_factor"][i] = s.get("scale_factor", np.ones(4, np.float32))
        batch["img_id"][i] = s.get("img_id", 0)
        m = min(len(s["gt_bboxes"]), max_instances)
        if m:
            batch["gt_bboxes"][i, :m] = s["gt_bboxes"][:m]
            batch["gt_labels"][i, :m] = s["gt_labels"][:m]
            batch["gt_valid"][i, :m] = True
            for key in ("gt_extremes", "gt_polygons", "gt_keypoints_vs"):
                if key in s and key in batch and len(s[key]):
                    batch[key][i, :m] = s[key][:m]
    return batch


class DataLoader:
    """Epoch iterator: shuffled, per-host sharded, orientation-grouped
    static canvases, optional background prefetch.

    Replaces the reference GroupSampler/DistributedGroupSampler
    (`code/mmdet/datasets/samplers/group_sampler.py`): batches are grouped
    by image orientation (the reference's aspect-ratio flag,
    `custom.py:158-168`) so each group pads onto one static canvas —
    landscape images onto (short, long), portrait onto (long, short) —
    keeping the number of compiled shapes at two.
    """

    def __init__(self, dataset: CocoDataset, batch_size: int,
                 canvas_hw: Optional[Tuple[int, int]] = None, *,
                 seed: int = 0, num_hosts: int = 1, host_id: int = 0,
                 drop_last: bool = True, prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        cfg = dataset.cfg
        if canvas_hw is not None:
            land = tuple(canvas_hw)
        else:
            land = canvas_for_scale(cfg.img_scale, portrait=False,
                                    divisor=cfg.size_divisor,
                                    ratio_range=cfg.ratio_range)
        self.canvases = {"landscape": land, "portrait": (land[1], land[0])}
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = drop_last
        self.prefetch = prefetch
        # orientation flag per dataset index (reference aspect-ratio group)
        self._portrait = np.array(
            [info["height"] > info["width"] for info in dataset.img_infos],
            bool)

    @property
    def canvas_hw(self) -> Tuple[int, int]:
        return self.canvases["landscape"]

    def steps_per_epoch(self) -> int:
        n = 0
        for flag in (False, True):
            g = int((self._portrait == flag).sum()) // self.num_hosts
            n += (g // self.batch_size if self.drop_last
                  else -(-g // self.batch_size))
        return n

    def _batches(self, epoch_idx: int):
        """Yield (indices, canvas) batches, grouped by orientation,
        epoch-seeded shuffle (reference DistributedGroupSampler)."""
        rng = np.random.RandomState(self.seed + epoch_idx)
        plan = []
        for flag, key in ((False, "landscape"), (True, "portrait")):
            idxs = np.nonzero(self._portrait == flag)[0]
            idxs = rng.permutation(idxs)[self.host_id::self.num_hosts]
            nb = (len(idxs) // self.batch_size if self.drop_last
                  else -(-len(idxs) // self.batch_size))
            for b in range(nb):
                plan.append((idxs[b * self.batch_size:
                                  (b + 1) * self.batch_size],
                             self.canvases[key]))
        order = rng.permutation(len(plan))
        for i in order:
            yield plan[i]

    def _make_batch(self, idxs, canvas, rng):
        samples = [self.ds.get_sample(int(i), rng) for i in idxs]
        return collate_batch(samples, canvas, self.ds.cfg.max_instances,
                             self.ds.cfg.task, self.ds.cfg.num_vectors)

    def epoch(self, epoch_idx: int):
        rng = np.random.RandomState(self.seed + epoch_idx + 10_007)
        if self.prefetch <= 0:
            for idxs, canvas in self._batches(epoch_idx):
                yield self._make_batch(idxs, canvas, rng)
            return
        # Background producer thread: overlaps host-side decode/augment with
        # device compute (VERDICT r1 'async input pipeline').
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        SENTINEL = object()

        def producer():
            try:
                for idxs, canvas in self._batches(epoch_idx):
                    if stop.is_set():
                        return
                    q.put(self._make_batch(idxs, canvas, rng))
            except BaseException as e:  # surface errors to the consumer
                q.put(e)
                return
            q.put(SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer unblocks and exits
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A collated numpy batch -> torch tensors on ``device`` under the same
    keys and dtypes (the keys :func:`lsnet_torch.core.loss.lsnet_loss`
    reads). ``img_id`` stays a host numpy array."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("batch_to_device: no CUDA device")
    return {k: v if k == "img_id" else
            torch.from_numpy(np.ascontiguousarray(v)).to(device,
                                                         non_blocking=True)
            for k, v in batch.items()}
