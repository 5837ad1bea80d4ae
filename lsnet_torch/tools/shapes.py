"""The procedural shapes set in COCO format (the port's copy of
``tools/accuracy_run.py`` ``make_shapes_coco``): three shape classes
(rectangle, ellipse, triangle) with analytic contour polygons, or with
17 keypoints for the pose tasks, drawn on textured backgrounds.

``hw`` is the image size, one (h, w) for every image or a sequence of
them taken in turn, so a set can mix orientations. At the default
128x160 the pixels and annotations equal the JAX tool's for the same
seed.

    python3 -m lsnet_torch.tools.shapes OUT_DIR [--n 16] [--seed 0]
        [--pose] [--hw 128 160] [--voc]

``make_shapes_voc`` (``--voc``) writes the same set in the Pascal VOC
layout, with a COCO json of the same images over VOC's 20 classes.
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


# the VOC names the three shape classes take in a VOC-layout set
VOC_NAMES = ("car", "dog", "person")


def make_shapes_voc(root: str, n_images: int, seed: int,
                    hw: Union[Tuple[int, int],
                              Sequence[Tuple[int, int]]] = HW,
                    names: Sequence[str] = VOC_NAMES,
                    split: str = "train") -> Tuple[str, str, str]:
    """The shapes set of ``make_shapes_coco`` in the Pascal VOC layout:
    ``root/JPEGImages/*.jpg``, ``root/Annotations/*.xml`` (1-based
    inclusive boxes, the shape classes named ``names``; the first object
    of the first image is ``difficult``) and
    ``root/ImageSets/Main/{split}.txt``; beside them ``root/val.json``,
    the same images and objects as COCO json over VOC's 20 classes (the
    difficult object ``iscrowd``), the val split's form. Returns
    (imageset file, img_prefix, COCO json)."""
    from PIL import Image

    voc = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
           "cat", "chair", "cow", "diningtable", "dog", "horse",
           "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
           "tvmonitor")
    ann_file, img_dir = make_shapes_coco(os.path.join(root, "shapes"),
                                         n_images, seed, hw=hw)
    with open(ann_file) as f:
        coco = json.load(f)
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    by_img = {}
    for a in coco["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a)
    ids, images, anns = [], [], []
    for im in coco["images"]:
        img_id = f"{im['id']:06d}"
        ids.append(img_id)
        Image.open(os.path.join(img_dir, im["file_name"])).convert(
            "RGB").save(os.path.join(root, "JPEGImages", f"{img_id}.jpg"),
                        quality=95)
        objs = []
        for j, a in enumerate(by_img.get(im["id"], [])):
            x, y, w, h = a["bbox"]
            x1, y1 = int(round(x)) + 1, int(round(y)) + 1
            x2, y2 = int(round(x + w)) + 1, int(round(y + h)) + 1
            name = names[a["category_id"] - 1]
            diff = int(im["id"] == coco["images"][0]["id"] and j == 0)
            objs.append(
                f"<object><name>{name}</name><difficult>{diff}</difficult>"
                f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin>"
                f"<xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>")
            anns.append(dict(
                id=len(anns) + 1, image_id=im["id"],
                category_id=voc.index(name) + 1,
                bbox=[x1 - 1.0, y1 - 1.0, float(x2 - x1), float(y2 - y1)],
                area=float((x2 - x1) * (y2 - y1)), iscrowd=diff))
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"),
                  "w") as f:
            f.write(f"<annotation><filename>{img_id}.jpg</filename><size>"
                    f"<width>{im['width']}</width><height>{im['height']}"
                    f"</height><depth>3</depth></size>{''.join(objs)}"
                    "</annotation>")
        images.append(dict(id=im["id"], file_name=f"{img_id}.jpg",
                           width=im["width"], height=im["height"]))
    set_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
    with open(set_file, "w") as f:
        f.write("\n".join(ids) + "\n")
    val_json = os.path.join(root, "val.json")
    with open(val_json, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=[
            dict(id=i + 1, name=n) for i, n in enumerate(voc)]), f)
    return set_file, root, val_json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pose", action="store_true")
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    ap.add_argument("--voc", action="store_true")
    args = ap.parse_args(argv)
    if args.voc:
        print(make_shapes_voc(args.out, args.n, args.seed, tuple(args.hw)))
        return
    print(make_shapes_coco(args.out, args.n, args.seed, args.pose,
                           tuple(args.hw)))


if __name__ == "__main__":
    main()
