"""Save the data pipeline's samples with their ground truth drawn on
them (the port's ``tools/browse_dataset.py``).

    python3 -m lsnet_torch.tools.browse_dataset CONFIG --output-dir DIR \
        [--number 20] [--val] [--seed 0]

The dataset runs as training sees it (resize, augmentations, flip; the
test-mode pipeline with ``--val``) and each sample is written as a PNG
with the task's annotations: boxes and extreme points, contour polygons
or keypoint skeletons. Host only: it needs no device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def denormalize(img: np.ndarray) -> np.ndarray:
    return np.clip(img * IMG_STD + IMG_MEAN, 0, 255).astype(np.uint8)


def draw_sample(sample, out_file):
    """The sample's image with its annotations, written to ``out_file``;
    returns the drawn uint8 image."""
    from ..utils.visualize import imshow_extremes, imshow_polygons, imshow_pose

    img = denormalize(np.asarray(sample["image"], np.float32))
    bboxes = sample.get("gt_bboxes", np.zeros((0, 4), np.float32))
    labels = sample.get("gt_labels", np.zeros((0,), np.int32))
    if "gt_extremes" in sample:
        # 4 extreme points + the centre (10 floats): the drawer takes the 4
        ext = np.asarray(sample["gt_extremes"])[:, :8]
        return imshow_extremes(img, bboxes, ext, labels, out_file=out_file)
    if "gt_polygons" in sample:
        return imshow_polygons(img, bboxes, np.asarray(sample["gt_polygons"]),
                               labels, out_file=out_file)
    if "gt_keypoints_vs" in sample:
        kps = np.asarray(sample["gt_keypoints_vs"]).reshape(
            len(bboxes), -1, 3)[..., :2].reshape(len(bboxes), -1)
        return imshow_pose(img, bboxes, kps, out_file=out_file)
    return imshow_extremes(img, bboxes, np.zeros((len(bboxes), 8)),
                           labels, out_file=out_file)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Browse the dataset pipeline")
    ap.add_argument("config")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--number", type=int, default=20)
    ap.add_argument("--val", action="store_true",
                    help="browse the val split (test-mode pipeline)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..data.coco import CocoDataset, DatasetConfig
    from ..train.loop import head_cfg, head_num_vectors
    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    task = {"bbox": "bbox", "segm": "segm", "pose_bbox": "pose",
            "pose_kbox": "pose"}[head_cfg(cfg).get("task", "bbox")]
    split = cfg.data.val if args.val else cfg.data.train
    ds = CocoDataset(DatasetConfig(
        ann_file=split.ann_file, img_prefix=split.img_prefix, task=task,
        num_vectors=head_num_vectors(cfg), filter_empty=not args.val,
        img_scale=tuple(split.get("img_scale", (1333, 800))),
        flip_ratio=float(split.get("flip_ratio", 0.5)),
        augmentations=tuple(split.get("augmentations", ()))),
        test_mode=args.val)

    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    n = min(args.number, len(ds)) if args.number > 0 else len(ds)
    written = []
    for i in range(n):
        sample = ds.get_sample(i, None if args.val else rng)
        out = os.path.join(args.output_dir,
                           f"{i:04d}_img{sample['img_id']}.png")
        draw_sample(sample, out)
        print("wrote", out, flush=True)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
