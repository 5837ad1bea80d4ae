"""The port's dataset registry and VOC mAP (``lsnet_torch/data/extra.py``)
against the JAX package's (``lsnet_tpu/data/extra.py``), on procedural
files in each dataset's layout.

* All eight ``DATASET_TYPES`` build through both packages'
  ``build_dataset`` from the same files and give the same ``img_infos``
  and the same first samples, array for array, in train mode (with an
  augmentation draw) and test mode: VOC (1-based boxes, a ``difficult``
  object dropped in train and kept in test, ``year`` from the prefix,
  ``min_size`` 0 and 32 with a sub-pixel box), WIDER Face (images under
  the XML ``folder``), COCO, COCO pose, Cityscapes, DeepFashion, LVIS and
  LVIS v1 (``coco_url`` in place of ``file_name``, no ``iscrowd``). An
  unknown type raises ``KeyError`` in both.
* ``eval_map`` equals JAX's to 1e-12 in both AP modes (area and VOC2007's
  11 points) on seeded detections, with a class that has no GT and one
  that has no detection, at two IoU thresholds.
"""

import json
import os
import shutil

import numpy as np
import pytest

from lsnet_torch.data import coco as p_coco
from lsnet_torch.data import extra as p_extra
from lsnet_torch.tools.shapes import make_shapes_coco, make_shapes_voc
from lsnet_tpu.data import coco as j_coco
from lsnet_tpu.data import extra as j_extra

HW = (96, 128)
SCALE = (160, 112)


def _wider(root, voc_root):
    """WIDER Face's layout from a VOC-layout set: images under
    ``WIDER_train/images/<folder>``, each XML naming its folder and every
    object a ``face``."""
    ids = [ln.strip() for ln in open(os.path.join(
        voc_root, "ImageSets", "Main", "train.txt")) if ln.strip()]
    os.makedirs(os.path.join(root, "Annotations"), exist_ok=True)
    for i, img_id in enumerate(ids):
        folder = f"{i % 2}--Event"
        os.makedirs(os.path.join(root, "WIDER_train", "images", folder),
                    exist_ok=True)
        shutil.copy(os.path.join(voc_root, "JPEGImages", f"{img_id}.jpg"),
                    os.path.join(root, "WIDER_train", "images", folder))
        xml = open(os.path.join(voc_root, "Annotations",
                                f"{img_id}.xml")).read()
        for name in ("car", "dog", "person"):
            xml = xml.replace(f"<name>{name}</name>", "<name>face</name>")
        xml = xml.replace("<annotation>",
                          f"<annotation><folder>{folder}</folder>")
        with open(os.path.join(root, "Annotations", f"{img_id}.xml"),
                  "w") as f:
            f.write(xml)
    set_file = os.path.join(root, "train.txt")
    with open(set_file, "w") as f:
        f.write("\n".join(ids))
    return set_file


def _lvis(root, ann_file, img_dir):
    """LVIS' json: ``coco_url`` (…/train2017/<name>) in place of
    ``file_name``, annotations without ``iscrowd``; the images under
    ``img_prefix/train2017``."""
    data = json.load(open(ann_file))
    os.makedirs(os.path.join(root, "train2017"), exist_ok=True)
    for im in data["images"]:
        shutil.copy(os.path.join(img_dir, im["file_name"]),
                    os.path.join(root, "train2017"))
        im["coco_url"] = ("http://images.cocodataset.org/train2017/"
                          + im.pop("file_name"))
    for a in data["annotations"]:
        a.pop("iscrowd")
    path = os.path.join(root, "lvis.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(type, ann_file, img_prefix, task) of every registry type."""
    root = str(tmp_path_factory.mktemp("extra"))
    voc_root = os.path.join(root, "VOC2007")
    voc_set, _, _ = make_shapes_voc(voc_root, 4, seed=2,
                                    hw=[HW, HW[::-1]])
    # a sub-pixel box in the last image: min_size drops it
    last = sorted(os.listdir(os.path.join(voc_root, "Annotations")))[-1]
    path = os.path.join(voc_root, "Annotations", last)
    xml = open(path).read().replace(
        "</annotation>", "<object><name>dog</name><bndbox><xmin>10</xmin>"
        "<ymin>10</ymin><xmax>10</xmax><ymax>30</ymax></bndbox></object>"
        "</annotation>")
    open(path, "w").write(xml)
    wider_set = _wider(os.path.join(root, "wider"), voc_root)
    ann, img = make_shapes_coco(os.path.join(root, "coco"), 4, seed=3,
                                hw=[HW, HW[::-1]])
    pose_ann, pose_img = make_shapes_coco(os.path.join(root, "pose"), 3,
                                          seed=4, pose=True, hw=HW)
    lvis = _lvis(os.path.join(root, "lvis"), ann, img)
    return {"VOCDataset": (voc_set, voc_root, "bbox"),
            "WIDERFaceDataset": (wider_set, os.path.join(root, "wider"),
                                 "bbox"),
            "CocoDataset": (ann, img, "segm"),
            "CocoPoseDataset": (pose_ann, pose_img, "pose"),
            "CityscapesDataset": (ann, img, "segm"),
            "DeepFashionDataset": (ann, img, "bbox"),
            "LVISDataset": (lvis, os.path.join(root, "lvis"), "bbox"),
            "LVISV1Dataset": (lvis, os.path.join(root, "lvis"), "bbox")}


def _build(pkg, kind, spec, test_mode, **kw):
    ann, prefix, task = spec
    coco, extra = {"torch": (p_coco, p_extra), "jax": (j_coco, j_extra)}[pkg]
    cfg = coco.DatasetConfig(ann_file=ann, img_prefix=prefix, task=task,
                             num_vectors={"segm": 36, "pose": 17}.get(
                                 task, 4),
                             img_scale=SCALE, max_instances=8, **kw)
    return extra.build_dataset(kind, cfg, test_mode=test_mode)


def _same_sample(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_registry_has_jax_types():
    assert set(p_extra.DATASET_TYPES) == set(j_extra.DATASET_TYPES)
    assert len(p_extra.DATASET_TYPES) == 8
    for build in (p_extra.build_dataset, j_extra.build_dataset):
        with pytest.raises(KeyError):
            build("NopeDataset", p_coco.DatasetConfig(ann_file="x",
                                                      img_prefix="y"))


@pytest.mark.parametrize("test_mode", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("kind", sorted(j_extra.DATASET_TYPES))
def test_dataset_matches_jax(files, kind, test_mode):
    got, want = (_build(pkg, kind, files[kind], test_mode)
                 for pkg in ("torch", "jax"))
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want) > 0
    assert got.img_infos == want.img_infos
    for i in range(len(want)):
        rng = None if test_mode else np.random.RandomState(i)
        _same_sample(got.get_sample(i, rng),
                     want.get_sample(i, None if test_mode
                                     else np.random.RandomState(i)))


def test_voc_difficult_year_and_min_size(files):
    spec = files["VOCDataset"]
    train, test = (_build("torch", "VOCDataset", spec, m)
                   for m in (False, True))
    assert train.year == test.year == 2007
    assert train.CLASSES[train.cat2label["dog"]] == "dog"
    # the first image's first object is difficult: dropped in train only
    b_train, _ = train._parse_objects(train.img_infos[0]["img_id"])
    b_test, _ = test._parse_objects(test.img_infos[0]["img_id"])
    assert len(b_test) == len(b_train) + 1
    # the sub-pixel box of the last image: dropped only with min_size
    last = train.img_infos[-1]["img_id"]
    for pkg in ("torch", "jax"):
        keep = _build(pkg, "VOCDataset", spec, False, min_size=0)
        drop = _build(pkg, "VOCDataset", spec, False)
        assert len(keep._parse_objects(last)[0]) == \
            len(drop._parse_objects(last)[0]) + 1
    got = _build("torch", "VOCDataset", spec, False, min_size=0)
    want = _build("jax", "VOCDataset", spec, False, min_size=0)
    _same_sample(got.get_sample(len(got) - 1, np.random.RandomState(9)),
                 want.get_sample(len(want) - 1, np.random.RandomState(9)))


def test_wider_face_reads_the_xml_folder(files):
    ds = _build("torch", "WIDERFaceDataset", files["WIDERFaceDataset"],
                True)
    assert ds.CLASSES == ("face",)
    import xml.etree.ElementTree as ET
    img_id = ds.img_infos[1]["img_id"]
    path = ds._img_path(img_id, ET.parse(ds._xml_path(img_id)).getroot())
    assert path.endswith(os.path.join("WIDER_train", "images", "1--Event",
                                      f"{img_id}.jpg"))
    assert os.path.exists(path)
    s = ds.get_sample(1)
    assert s["gt_bboxes"].shape[1] == 4 and (s["gt_labels"] == 0).all()


def test_lvis_names_its_files_from_coco_url(files):
    ds = _build("torch", "LVISDataset", files["LVISDataset"], True)
    assert all(i["file_name"].startswith("train2017/")
               for i in ds.coco.img_infos)


def _detections(rng, n_img, n_cls, gts):
    """Seeded detections: jittered copies of GTs and random boxes, the
    last class without any detection."""
    dets = []
    for g in gts:
        per = []
        for c in range(n_cls):
            if c == n_cls - 1:
                per.append(np.zeros((0, 5), np.float32))
                continue
            own = g["bboxes"][g["labels"] == c]
            jit = own + rng.uniform(-4, 4, own.shape)
            rand = rng.uniform(0, 60, (rng.randint(0, 4), 2))
            rand = np.concatenate([rand, rand + rng.uniform(5, 30,
                                                            rand.shape)], 1)
            boxes = np.concatenate([jit, rand]).astype(np.float32)
            scores = rng.rand(len(boxes), 1).astype(np.float32)
            per.append(np.concatenate([boxes, scores], 1))
        dets.append(per)
    return dets


@pytest.mark.parametrize("iou_thr", [0.5, 0.75])
@pytest.mark.parametrize("use_07", [False, True], ids=["area", "11points"])
def test_eval_map_matches_jax(iou_thr, use_07):
    rng = np.random.RandomState(7)
    n_img, n_cls = 6, 5
    gts = []
    for _ in range(n_img):
        m = rng.randint(1, 5)
        lo = rng.uniform(0, 60, (m, 2))
        # class 3 has no GT; class 4 (the last) no detection
        labels = rng.choice([0, 1, 2, 4], m)
        gts.append(dict(bboxes=np.concatenate(
            [lo, lo + rng.uniform(8, 40, (m, 2))], 1).astype(np.float32),
            labels=labels))
    dets = _detections(rng, n_img, n_cls, gts)
    got_map, got_cls = p_extra.eval_map(dets, gts, iou_thr=iou_thr,
                                        use_07_metric=use_07)
    want_map, want_cls = j_extra.eval_map(dets, gts, iou_thr=iou_thr,
                                          use_07_metric=use_07)
    assert abs(got_map - want_map) <= 1e-12 and 0 < want_map < 1
    assert len(got_cls) == len(want_cls) == n_cls
    for g, w in zip(got_cls, want_cls):
        assert g.keys() == w.keys()
        assert (g["num_gts"], g["num_dets"]) == (w["num_gts"], w["num_dets"])
        assert abs(g["ap"] - w["ap"]) <= 1e-12
    assert want_cls[3]["num_gts"] == 0 and want_cls[4]["num_dets"] == 0
    for kind in ("area", "11"):
        rec = np.sort(rng.rand(9))
        prec = rng.rand(9)
        assert abs(p_extra._voc_ap(rec, prec, kind == "11")
                   - j_extra._voc_ap(rec, prec, kind == "11")) <= 1e-12
