"""The port's host-side data pipeline (``lsnet_torch.data``,
``lsnet_torch.utils.image``, ``lsnet_torch.tools.shapes``) against the JAX
package's on the same seeded inputs. These are numpy copies, so every
comparison is exact: two epochs of both loaders, batch by batch and key by
key, in train mode (flip 0.5, multi-scale range) and in test mode; the
LSVR landmark helpers and each transform on random inputs; the procedural
shapes set at 128x160 against ``tools/accuracy_run.py``'s.
"""

import os
import sys

import numpy as np
import pytest
import torch

from lsnet_tpu.data import coco as jcoco
from lsnet_tpu.data import lsvr as jlsvr
from lsnet_tpu.data import transforms as jtf
from lsnet_tpu.utils import image as jimage
from lsnet_torch.data import coco as pcoco
from lsnet_torch.data import lsvr as plsvr
from lsnet_torch.data import transforms as ptf
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.utils import image as pimage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 6 landscape, 4 portrait
SIZES = [(64, 96)] * 3 + [(96, 64)] * 2 + [(72, 100)] * 3 + [(100, 72)] * 2


@pytest.fixture(scope="module")
def shapes_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapes"))
    return make_shapes_coco(root, len(SIZES), seed=7, hw=SIZES)


def _dataset_cfgs(ann_file, img_dir, task, **kw):
    nv = {"bbox": 4, "segm": 36, "pose": 17}[task]
    return [m.DatasetConfig(ann_file=ann_file, img_prefix=img_dir,
                            task=task, num_vectors=nv, min_size=8, **kw)
            for m in (jcoco, pcoco)]


def _assert_same_batches(jloader, ploader, epochs=(0, 1)):
    n = 0
    for e in epochs:
        jb, pb = list(jloader.epoch(e)), list(ploader.epoch(e))
        assert len(jb) == len(pb) > 0
        for a, b in zip(jb, pb):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n += 1
    return n


@pytest.mark.parametrize("task", ["bbox", "segm"])
def test_train_loaders_give_equal_batches(shapes_set, task):
    ann, img = shapes_set
    jcfg, pcfg = _dataset_cfgs(ann, img, task,
                               img_scale=[(100, 48), (120, 72)],
                               multiscale_mode="range", flip_ratio=0.5)
    jl = jcoco.DataLoader(jcoco.CocoDataset(jcfg), 2, seed=3)
    pl = pcoco.DataLoader(pcoco.CocoDataset(pcfg), 2, seed=3)
    assert jl.canvas_hw == pl.canvas_hw
    assert jl.steps_per_epoch() == pl.steps_per_epoch() == 5
    assert _assert_same_batches(jl, pl) == 10


def test_test_mode_loaders_give_equal_batches(shapes_set):
    ann, img = shapes_set
    jcfg, pcfg = _dataset_cfgs(ann, img, "bbox", img_scale=(96, 64),
                               filter_empty=False)
    jl = jcoco.DataLoader(jcoco.CocoDataset(jcfg, test_mode=True), 3,
                          drop_last=False, prefetch=0)
    pl = pcoco.DataLoader(pcoco.CocoDataset(pcfg, test_mode=True), 3,
                          drop_last=False, prefetch=0)
    assert _assert_same_batches(jl, pl) == 8


def test_pose_samples_are_equal(tmp_path):
    ann, img = make_shapes_coco(str(tmp_path), 3, seed=2, pose=True)
    jcfg, pcfg = _dataset_cfgs(ann, img, "pose", img_scale=(160, 128))
    jd, pd = jcoco.CocoDataset(jcfg), pcoco.CocoDataset(pcfg)
    for i in range(len(jd)):
        a = jd.get_sample(i, np.random.RandomState(i))
        b = pd.get_sample(i, np.random.RandomState(i))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_prefetch_error_reaches_the_consumer(shapes_set, monkeypatch):
    ann, img = shapes_set
    _, pcfg = _dataset_cfgs(ann, img, "bbox", img_scale=(96, 64))
    ds = pcoco.CocoDataset(pcfg)

    def broken(*_):
        raise OSError("unreadable image")
    monkeypatch.setattr(ds, "_load_image", broken)
    with pytest.raises(OSError, match="unreadable image"):
        list(pcoco.DataLoader(ds, 2).epoch(0))


def test_batch_to_device_keeps_keys_and_dtypes(shapes_set):
    ann, img = shapes_set
    _, pcfg = _dataset_cfgs(ann, img, "bbox", img_scale=(96, 64))
    batch = next(pcoco.DataLoader(pcoco.CocoDataset(pcfg), 2,
                                  prefetch=0).epoch(0))
    moved = pcoco.batch_to_device(batch, "cpu")
    assert list(moved) == list(batch)
    assert isinstance(moved["img_id"], np.ndarray)
    for k, v in batch.items():
        if k == "img_id":
            continue
        assert isinstance(moved[k], torch.Tensor)
        assert moved[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(moved[k].numpy(), v)


def test_corruptions_name_their_roadmap_item(shapes_set):
    """The val dataset's corruption hook and the ``Corrupt`` augmentation
    step give the JAX package's pixels (both corrupt the loaded image with
    the same seeded suite)."""
    ann, img = shapes_set
    jcfg, pcfg = _dataset_cfgs(ann, img, "bbox", corruption=(
        "gaussian_noise", 1))
    got = pcoco.CocoDataset(pcfg, test_mode=True).get_sample(0)["image"]
    want = jcoco.CocoDataset(jcfg, test_mode=True).get_sample(0)["image"]
    np.testing.assert_array_equal(got, want)
    raw = {"image": np.random.RandomState(0).randint(
        0, 256, (8, 8, 3)).astype(np.uint8)}
    np.testing.assert_array_equal(
        ptf.corrupt_sample(raw, "gaussian_noise")["image"],
        jtf.corrupt_sample(raw, "gaussian_noise")["image"])


def test_shapes_set_equals_the_jax_tool(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import accuracy_run
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    for pose in (False, True):
        a, b = tmp_path / f"jax{pose}", tmp_path / f"port{pose}"
        accuracy_run.make_shapes_coco(str(a), 4, 11, pose=pose)
        make_shapes_coco(str(b), 4, 11, pose=pose)
        assert (a / "ann.json").read_text() == (b / "ann.json").read_text()
        names = sorted(os.listdir(a / "imgs"))
        assert names == sorted(os.listdir(b / "imgs")) and len(names) == 4
        for n in names:
            assert (a / "imgs" / n).read_bytes() == \
                (b / "imgs" / n).read_bytes()


def _polygon(rng, n):
    t = np.sort(rng.rand(n)) * 2 * np.pi
    r = 10 + 5 * rng.rand(n)
    return np.stack([40 + r * np.cos(t), 30 + r * np.sin(t)], 1)


@pytest.mark.parametrize("seed", range(4))
def test_lsvr_helpers_are_equal(seed):
    rng = np.random.RandomState(seed)
    pts = _polygon(rng, 5 + seed * 7)
    np.testing.assert_array_equal(jlsvr.get_extreme_points(pts),
                                  plsvr.get_extreme_points(pts))
    bbox = np.array([*pts.min(0), *pts.max(0)], np.float32)
    np.testing.assert_array_equal(
        jlsvr.extreme_points_with_center(pts, bbox),
        plsvr.extreme_points_with_center(pts, bbox))
    comps = [pts.reshape(-1), _polygon(rng, 4).reshape(-1) * 0.1]
    for nv in (4, 36):
        np.testing.assert_array_equal(
            jlsvr.unify_polygon(comps, bbox, num_points=nv),
            plsvr.unify_polygon(comps, bbox, num_points=nv))


def _sample(rng, h=40, w=56, n=3):
    x1 = rng.rand(n) * (w / 2)
    y1 = rng.rand(n) * (h / 2)
    bb = np.stack([x1, y1, x1 + 4 + rng.rand(n) * w / 2,
                   y1 + 4 + rng.rand(n) * h / 2], 1).astype(np.float32)
    return {"image": (rng.rand(h, w, 3) * 255).astype(np.float32),
            "gt_bboxes": bb, "gt_labels": rng.randint(0, 3, n),
            "gt_extremes": (rng.rand(n, 10) * 30).astype(np.float32),
            "gt_polygons": (rng.rand(n, 8) * 30).astype(np.float32),
            "gt_keypoints_vs": np.concatenate(
                [rng.rand(n, 17, 2) * 30, rng.randint(0, 3, (n, 17, 1))],
                -1).reshape(n, -1).astype(np.float32)}


TRANSFORMS = {
    "resize": lambda m, s, r: m.resize_sample(s, (70, 30)),
    "resize_exact": lambda m, s, r: m.resize_sample(s, (70, 30),
                                                    keep_ratio=False),
    "hflip": lambda m, s, r: m.hflip_sample(s),
    "photometric": lambda m, s, r: m.photometric_distortion(s, r),
    "expand": lambda m, s, r: m.expand_sample(s, r, prob=1.0),
    "random_crop": lambda m, s, r: m.random_crop_sample(s, (24, 32), r),
    "min_iou_crop": lambda m, s, r: m.min_iou_random_crop(s, r),
    "pipeline": lambda m, s, r: m.build_aug_pipeline(
        [dict(type="PhotoMetricDistortion"), dict(type="Expand"),
         dict(type="MinIoURandomCrop")])(s, r),
    "normalize": lambda m, s, r: {"image": m.normalize_image(s["image"])},
    "pad": lambda m, s, r: {"image": m.pad_to_shape(s["image"], (64, 64))},
    "scale": lambda m, s, r: {"scale": np.array(m.sample_scale(
        [(100, 48), (120, 72)], "range", None, r)), "canvas": np.array(
        m.canvas_for_scale([(100, 48), (120, 72)], portrait=True))},
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_are_equal(name):
    fn = TRANSFORMS[name]
    for seed in range(3):
        a = fn(jtf, _sample(np.random.RandomState(seed)),
               np.random.RandomState(100 + seed))
        b = fn(ptf, _sample(np.random.RandomState(seed)),
               np.random.RandomState(100 + seed))
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


IMAGE_OPS = {
    "imrescale": lambda m, x: m.imrescale(x, 0.7),
    "imflip": lambda m, x: m.imflip(x, "vertical"),
    "imrotate": lambda m, x: m.imrotate(x, 30.0),
    "imcrop": lambda m, x: m.imcrop(x, np.array([2.0, 3.0, 20.0, 15.0])),
    "impad_to_multiple": lambda m, x: m.impad_to_multiple(x, 16),
    "rgb2hsv": lambda m, x: m.rgb2hsv(x),
    "imnormalize": lambda m, x: m.imnormalize(x, (1.0, 2.0, 3.0),
                                              (4.0, 5.0, 6.0)),
    "posterize": lambda m, x: m.posterize(x, 3),
}


@pytest.mark.parametrize("name", sorted(IMAGE_OPS))
def test_image_utils_are_equal(name):
    x = (np.random.RandomState(5).rand(24, 30, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(IMAGE_OPS[name](jimage, x),
                                  IMAGE_OPS[name](pimage, x))


def test_entry_points_raise_without_a_card(shapes_set, tmp_path):
    """Without ``device="cpu"`` (``--device cpu``) the runner's entry
    points want the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lsnet_torch.tools import test as test_tool
    from lsnet_torch.tools import train as train_tool
    from lsnet_torch.train.loop import runner_device
    ann, img = shapes_set
    batch = next(pcoco.DataLoader(pcoco.CocoDataset(_dataset_cfgs(
        ann, img, "bbox", img_scale=(96, 64))[1]), 2, prefetch=0).epoch(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcoco.batch_to_device(batch, "cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        runner_device("cuda")
    cfg = os.path.join(REPO, "configs", "lsnet", "lsnet_bbox_r50_fpn_1x_coco.py")
    opts = ["--options", f"data.train.ann_file={ann}",
            f"data.train.img_prefix={img}", f"data.val.ann_file={ann}",
            f"data.val.img_prefix={img}"]
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_tool.main([cfg, "--work-dir", str(tmp_path / "w"), *opts])
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_tool.main([cfg, str(tmp_path / "missing.pt"), *opts])
