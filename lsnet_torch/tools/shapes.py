"""The procedural shapes set in COCO format (the port's copy of
``tools/accuracy_run.py`` ``make_shapes_coco``): three shape classes
(rectangle, ellipse, triangle) with analytic contour polygons, or with
17 keypoints for the pose tasks, drawn on textured backgrounds.

``hw`` is the image size, one (h, w) for every image or a sequence of
them taken in turn, so a set can mix orientations. At the default
128x160 the pixels and annotations equal the JAX tool's for the same
seed.

    python3 -m lsnet_torch.tools.shapes OUT_DIR [--n 16] [--seed 0]
        [--pose] [--hw 128 160]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence, Tuple, Union

import numpy as np

HW = (128, 160)


def _shape_polygon(cls, sw, sh, x1, y1):
    """Analytic contour polygon (clockwise, image coords) for one shape."""
    if cls == 0:      # rectangle
        pts = [(0, 0), (sw, 0), (sw, sh), (0, sh)]
    elif cls == 1:    # ellipse (24-point contour)
        t = np.linspace(0, 2 * np.pi, 24, endpoint=False)
        pts = [((1 + np.cos(a)) * sw / 2, (1 + np.sin(a)) * sh / 2)
               for a in t]
    else:             # triangle
        pts = [(sw, 0), (sw, sh), (0, sh)]
    return [(float(x1 + px), float(y1 + py)) for px, py in pts]


def _draw_shape(arr, cls, rng, want_kps=False):
    from PIL import Image, ImageDraw
    h, w = arr.shape[:2]
    if want_kps:
        # larger objects for pose: OKS tolerance is sigma * sqrt(area)
        sw = rng.randint(56, min(100, w - 1))
        sh = rng.randint(56, min(100, h - 1))
    else:
        sw = rng.randint(18, 56)
        sh = rng.randint(18, 56)
    x1 = rng.randint(0, w - sw)
    y1 = rng.randint(0, h - sh)
    color = tuple(int(c) for c in rng.randint(100, 255, 3))
    poly = _shape_polygon(cls, sw, sh, x1, y1)
    im = Image.fromarray(arr)
    ImageDraw.Draw(im).polygon(poly, fill=color)
    arr[:] = np.asarray(im)
    xs = [p[0] for p in poly]
    ys = [p[1] for p in poly]
    bx1, by1, bx2, by2 = min(xs), min(ys), max(xs), max(ys)
    bbox = [float(bx1), float(by1), float(bx2 - bx1), float(by2 - by1)]
    seg = [float(v) for p in poly for v in p]
    kps = None
    if want_kps:
        # 17 keypoints at distinct fractional positions of the box
        # (centre + 4x4 grid): every slot has its own target
        cx, cy = (bx1 + bx2) / 2, (by1 + by2) / 2
        fr = (0.125, 0.375, 0.625, 0.875)
        pts = [(cx, cy)] + [(bx1 + fx * (bx2 - bx1), by1 + fy * (by2 - by1))
                            for fy in fr for fx in fr]
        kps = []
        for px, py in pts:
            kps += [float(px), float(py), 2]
    return bbox, seg, kps


def make_shapes_coco(root: str, n_images: int, seed: int, pose: bool = False,
                     hw: Union[Tuple[int, int],
                               Sequence[Tuple[int, int]]] = HW
                     ) -> Tuple[str, str]:
    """Write ``root/imgs/*.png`` and ``root/ann.json``; return
    (ann_file, img_dir)."""
    from PIL import Image
    sizes = [tuple(hw)] if np.isscalar(hw[0]) else [tuple(s) for s in hw]
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    aid = 1
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        arr = (rng.rand(h, w, 3) * 60).astype(np.uint8)
        n_obj = rng.randint(1, 3) if pose else rng.randint(1, 5)
        for _ in range(n_obj):
            cls = rng.randint(0, 3)
            bbox, seg, kps = _draw_shape(arr, cls, rng, want_kps=pose)
            ann = dict(
                id=aid, image_id=i,
                category_id=1 if pose else cls + 1,
                bbox=bbox, area=bbox[2] * bbox[3], iscrowd=0,
                segmentation=[seg])
            if pose:
                ann["keypoints"] = kps
                ann["num_keypoints"] = 17
            annotations.append(ann)
            aid += 1
        Image.fromarray(arr).save(os.path.join(img_dir, f"{i:04d}.png"))
        images.append(dict(id=i, file_name=f"{i:04d}.png", width=w,
                           height=h))
    ann_file = os.path.join(root, "ann.json")
    with open(ann_file, "w") as f:
        cats = ([dict(id=1, name="person")] if pose else
                [dict(id=c + 1, name=n) for c, n in
                 enumerate(("rect", "ellipse", "triangle"))])
        json.dump(dict(images=images, annotations=annotations,
                       categories=cats), f)
    return ann_file, img_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pose", action="store_true")
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    args = ap.parse_args(argv)
    print(make_shapes_coco(args.out, args.n, args.seed, args.pose,
                           tuple(args.hw)))


if __name__ == "__main__":
    main()
