"""Add ``extreme_points`` to every annotation of a COCO instances json
(the port's ``tools/gen_coco_lsvr.py``).

    python3 -m lsnet_torch.tools.gen_coco_lsvr ANN_FILE OUT_FILE

Each annotation gets its 4 extreme points and the box centre (10 floats,
:func:`lsnet_torch.data.lsvr.extreme_points_with_center`), from its
polygons, or from the box's corners where it has none (RLE or missing).
The pipeline computes the same points on the fly from the polygons, so
the tool is optional: it writes the ``instances_lsvr_*.json`` files the
reference workflows expect. Host only: it needs no device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    from ..data.lsvr import extreme_points_with_center

    parser = argparse.ArgumentParser()
    parser.add_argument("ann_file")
    parser.add_argument("out_file")
    args = parser.parse_args(argv)
    with open(args.ann_file) as f:
        data = json.load(f)
    n = 0
    for ann in data["annotations"]:
        x, y, w, h = ann["bbox"]
        bbox = np.array([x, y, x + w, y + h])
        seg = ann.get("segmentation")
        if isinstance(seg, list) and seg:
            pts = np.concatenate([np.asarray(s).reshape(-1, 2) for s in seg])
        else:  # RLE / missing: the box's corners
            pts = np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
        ann["extreme_points"] = [float(v) for v in
                                 extreme_points_with_center(pts, bbox)]
        n += 1
    with open(args.out_file, "w") as f:
        json.dump(data, f)
    print(f"wrote {args.out_file} ({n} annotations)")
    return n


if __name__ == "__main__":
    main()
