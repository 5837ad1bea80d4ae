"""LSNet's pose files through the port's runner, against the JAX package,
on the CPU, in f32.

The six ``configs/lsnet/lsnet_pose_*.py`` files name the dataset type
``CocoPoseDataset``, which both packages' ``data.extra.build_dataset``
read as ``CocoDataset`` (the person-only filter follows the task). One
narrow copy of a pose_bbox file (the R50 one) and of a pose_kbox file
(the X-101-DCN one, whose backbone the copy swaps for R18: the copy's
``_delete_`` drops the ResNeXt and DCN keys) runs on 16 procedural
person images (64x96 and 60x96 on the 64x96 canvas, 17 keypoints each):
R18, FPN 32, one stacked head conv, ``frozen_stages=-1`` so that
``grad_norm`` counts the same tensors.

Each file goes through the port's ``tools.train`` (2 steps of 8 images,
the EvalHook) and ``tools.test`` (keypoints), resuming from the JAX
detector's minted variables (``mint_variables``, carried over by
``weights.from_jax_variables``) as ``step_0.pt``, f32 steps. The first
batch of both packages' loaders is asserted equal, and the runner's first
step's losses are held against the JAX loss (``lsnet_loss`` with the JAX
runner's ``loss_cfg_from``), jitted, on that batch from the same
variables, and the pose_bbox file's ``grad_norm`` against its gradient's:
what the JAX runner's ``make_train_step`` computes (the JAX runner itself compiles its step on
8 virtual devices in about 90 s a file on this CPU, and raises on the
pose_kbox file's ``loss_bbox_init=None``, ROADMAP Queue 3; its loss
config is read here on a copy without the None entries, as
``test_torch_configs.py`` does). The JAX package's sampling state is
pinned to bilinear, the port's training sampling.

Tolerances: each loss 1e-4 relative (of max(1, |ref|)), ``grad_norm``
1e-3 relative (a DCN gradient agrees to 1e-3 of its tensor's largest
entry, ``test_torch_train.py``); the EvalHook's metrics equal
tools.test's to 1e-5 (the log rounds to 5 decimals).
"""

import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core.loss import lsnet_loss
from lsnet_tpu.data import coco as j_coco
from lsnet_tpu.data import extra as j_extra
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch.data import coco as p_coco
from lsnet_torch.data import extra as p_extra
from lsnet_torch.models import build_detector
from lsnet_torch.tools import test as test_tool
from lsnet_torch.tools import train as train_tool
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import loop as ploop
from lsnet_torch.train import step as pstep
from lsnet_torch.train.checkpoint import save_checkpoint, train_meta
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import from_jax_variables
from torch_port_util import mint_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
JAX_DEVICES = 8
FILES = {"pose_bbox": "lsnet_pose_bbox_r50_fpn_1x_coco.py",
         "pose_kbox": "lsnet_pose_kbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py"}
# the files whose first step's grad_norm is held against JAX's: a JAX
# gradient of a pose head costs about 48 s of compile on this CPU; the
# pose_kbox loss's gradients are held against JAX's at head level in
# test_torch_task_loss.py
GRAD_FILES = ("pose_bbox",)
LOSS_KEYS = {"pose_bbox": ("loss_cls", "loss_bbox_init", "loss_bbox_refine",
                           "loss_pose_init", "loss_pose_refine"),
             "pose_kbox": ("loss_cls", "loss_pose_init", "loss_pose_refine")}


def _config(cls, root, name, samples_per_gpu):
    """The narrow copy of a pose file, read by ``cls``; (path, cfg)."""
    norm = dict(type="GN", num_groups=8)
    data = dict(ann_file=os.path.join(root, "ann.json"),
                img_prefix=os.path.join(root, "imgs"),
                img_scale=(HW[1], HW[0]))
    cfg = dict(
        _base_=os.path.join(REPO, "configs", "lsnet", FILES[name]),
        model=dict(
            pretrained=None,
            backbone=dict(_delete_=True, type="ResNet", depth=18,
                          num_stages=4, out_indices=(0, 1, 2, 3),
                          frozen_stages=-1),
            neck=dict(in_channels=[64, 128, 256, 512], out_channels=32,
                      norm_cfg=norm),
            bbox_head=dict(in_channels=32, feat_channels=32,
                           point_feat_channels=32, stacked_convs=1,
                           norm_cfg=norm)),
        data=dict(samples_per_gpu=samples_per_gpu, train=dict(data),
                  val=dict(data), test=dict(data)),
        canvas_shape=HW, max_instances=8, log_interval=1, total_epochs=1,
        checkpoint_config=dict(interval=1),
        lr_config=dict(warmup_iters=2, step=[1]), optimizer=dict(lr=0.01))
    path = os.path.join(root, f"{name}_{samples_per_gpu}.py")
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return path, cls.fromfile(path)


def _first_batch(cfg, loader_cls, build, config_cls):
    d = cfg.data.train
    ds = build(d.type, config_cls(
        ann_file=d.ann_file, img_prefix=d.img_prefix, task="pose",
        num_vectors=17, img_scale=tuple(d.img_scale),
        flip_ratio=d.get("flip_ratio", 0.5), max_instances=8))
    return next(iter(loader_cls(ds, JAX_DEVICES, HW).epoch(0)))


def _jax_first_step(jcfg, variables, batch, grad):
    """The JAX loss (terms, total) and, with ``grad``, its gradient's
    global norm on ``batch``, f32, bilinear sampling."""
    head = jcfg.model.bbox_head
    for k in [k for k, v in head.items() if v is None]:
        del head[k]
    lcfg = jloop.loss_cfg_from(jcfg, HW)
    model, _ = j_build(jcfg.model.to_dict())

    def f(params):
        outs = model.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           batch["image"])
        return lsnet_loss(outs, batch, lcfg)
    if not grad:
        total, terms = jax.jit(f)(variables["params"])
        return {"loss": float(total), **{k: float(v)
                                         for k, v in terms.items()}}
    (total, terms), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        variables["params"])
    out = {k: float(v) for k, v in terms.items()}
    out["loss"] = float(total)
    out["grad_norm"] = float(np.sqrt(sum(
        np.sum(np.square(np.asarray(g, np.float64)))
        for g in jax.tree.leaves(grads))))
    return out


def _recording_loader(base, seen):
    class Recording(base):
        def epoch(self, epoch_idx):
            for batch in super().epoch(epoch_idx):
                seen.append({k: np.array(v) for k, v in batch.items()})
                yield batch
    return Recording


def _log_records(work_dir, mode):
    (path,) = glob.glob(os.path.join(work_dir, "*.log.json"))
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["mode"] == mode]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pose_runner"))
    make_shapes_coco(root, 16, seed=3, hw=[HW, (60, 96)], pose=True)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's process-wide sampling state, pinned
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        mp.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        mp.setattr(ploop, "make_train_step", functools.partial(
            pstep.make_train_step, mixed_precision=False))
        for name in FILES:
            res = out[name] = {"seen": []}
            ppath, pcfg = _config(Config, root, name, JAX_DEVICES)
            _, jcfg = _config(JConfig, root, name, 1)
            res["pcfg"] = pcfg
            res["jbatch"] = _first_batch(jcfg, j_coco.DataLoader,
                                         j_extra.build_dataset,
                                         j_coco.DatasetConfig)
            jmodel, _ = j_build(jcfg.model.to_dict())
            v = mint_variables(jmodel, jnp.zeros((1, *HW, 3)), seed=2)
            res["jax"] = _jax_first_step(
                jcfg, v, {k: jnp.asarray(x)
                          for k, x in res["jbatch"].items()},
                grad=name in GRAD_FILES)
            init = build_detector(pcfg.model.to_dict())
            init.load_state_dict(from_jax_variables(v), strict=True)
            optimizer, _ = build_optimizer(init.parameters(), 0.01, 2, [1])
            start = save_checkpoint(os.path.join(root, f"init_{name}"),
                                    init, optimizer, 0, train_meta())
            work = os.path.join(root, f"port_{name}")
            mp.setattr(ploop, "DataLoader",
                       _recording_loader(p_coco.DataLoader, res["seen"]))
            res["step"] = train_tool.main(
                [ppath, "--work-dir", work, "--resume-from", start,
                 "--device", "cpu"])["step"]
            res["train"] = _log_records(work, "train")
            res["val"] = _log_records(work, "val")
            res["metrics"] = test_tool.main(
                [ppath, os.path.join(work, "ckpts", "step_2.pt"), "--eval",
                 "keypoints", "--device", "cpu"])
    return out


def test_dataset_registry_matches_jax(tmp_path):
    """The port's registry has the JAX registry's eight entries, each of
    the same class; its two COCO ones are ``CocoDataset``
    (``CocoPoseDataset`` is ``CocoDataset``) in both; an unknown type
    raises ``KeyError`` in both, and a pose set keeps the person images
    only, the same images as JAX's."""
    assert set(p_extra.DATASET_TYPES) == set(j_extra.DATASET_TYPES)
    for name, kind in p_extra.DATASET_TYPES.items():
        assert kind.__name__ == j_extra.DATASET_TYPES[name].__name__
    for name in ("CocoDataset", "CocoPoseDataset"):
        assert p_extra.DATASET_TYPES[name] is p_coco.CocoDataset
        assert j_extra.DATASET_TYPES[name] is j_coco.CocoDataset
    for build, cfg_cls in ((p_extra.build_dataset, p_coco.DatasetConfig),
                           (j_extra.build_dataset, j_coco.DatasetConfig)):
        with pytest.raises(KeyError):
            build("PoseDataset", cfg_cls(ann_file="", img_prefix=""))
    make_shapes_coco(str(tmp_path), 6, seed=1, hw=HW)      # 3 classes
    ann = os.path.join(str(tmp_path), "ann.json")
    with open(ann) as f:
        coco = json.load(f)
    for a in coco["annotations"]:            # category 1 is the person
        a["keypoints"] = [1.0, 1.0, 2] * 17
    with open(ann, "w") as f:
        json.dump(coco, f)
    people = [i["id"] for i in coco["images"] if any(
        a["image_id"] == i["id"] and a["category_id"] == 1
        for a in coco["annotations"])]
    assert people and {a["category_id"] for a in coco["annotations"]} \
        == {1, 2, 3}
    got, want = (build("CocoPoseDataset", cfg_cls(
        ann_file=ann, img_prefix=os.path.join(str(tmp_path), "imgs"),
        task="pose", num_vectors=17, img_scale=(96, 64)))
        for build, cfg_cls in ((p_extra.build_dataset, p_coco.DatasetConfig),
                               (j_extra.build_dataset, j_coco.DatasetConfig)))
    assert [i["id"] for i in got.img_infos] == [
        i["id"] for i in want.img_infos] == people
    assert {a["category_id"] for anns in got.coco.anns_by_img.values()
            for a in anns} == {1}


@pytest.mark.parametrize("kind", ["VOCDataset", "LVISDataset",
                                  "NopeDataset"])
def test_other_datasets_are_refused_with_their_roadmap_entry(kind):
    """The runner admits every type of the registry (the other datasets
    of ``data/extra.py`` are ported: no ROADMAP entry is named any more)
    in the train and the val split, and refuses a type the registry does
    not name with the registry's ``KeyError``."""
    cfg = Config.fromfile(os.path.join(REPO, "configs", "lsnet",
                                       FILES["pose_bbox"]))
    for split in ("train", "val"):
        cfg.merge_from_dict({f"data.{split}.type": kind})
        if kind in p_extra.DATASET_TYPES:
            ploop.check_runnable(cfg)
        else:
            with pytest.raises(KeyError, match="unknown dataset type"):
                ploop.check_runnable(cfg)


@pytest.mark.parametrize("name", sorted(FILES))
def test_both_loaders_cut_the_same_first_batch(runs, name):
    """The JAX loader's first batch of the pose set (``samples_per_gpu``
    x 8 devices) and the port runner's first: the same person images,
    boxes and keypoints."""
    jb, pb = runs[name]["jbatch"], runs[name]["seen"][0]
    assert jb.keys() == pb.keys() and "gt_keypoints_vs" in pb
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    assert pb["gt_valid"].any()


@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_trains_and_tests_each_file(runs, name):
    """tools.train: 2 steps with the task's loss terms finite; the
    EvalHook's keypoint metrics equal tools.test's on the step-2
    checkpoint (seeded weights: 0 is expected)."""
    res = runs[name]
    assert res["step"] == 2 and len(res["seen"]) == 2
    recs = res["train"]
    assert [(r["epoch"], r["iter"]) for r in recs] == [(1, 1), (1, 2)]
    for r in recs:
        assert set(LOSS_KEYS[name]) | {"loss", "grad_norm"} <= r.keys()
        assert all(np.isfinite(r[k]) for k in LOSS_KEYS[name])
    metrics = res["metrics"]
    assert "keypoints_AP" in metrics and all(
        -1.0 <= v <= 1.0 for v in metrics.values())
    hook = {k: v for k, v in res["val"][-1].items()
            if k not in ("mode", "epoch")}
    assert hook.keys() == metrics.keys()
    for k, v in metrics.items():
        assert abs(v - hook[k]) <= 1e-5, k


@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_first_step_matches_jax(runs, name):
    """The runner's first logged step against the JAX loss on the same
    batch from the same variables: each loss 1e-4 relative; pose_bbox's
    ``grad_norm`` against the JAX gradient's, 1e-3 relative."""
    want, got = runs[name]["jax"], runs[name]["train"][0]
    assert set(LOSS_KEYS[name]) <= want.keys()
    for k in LOSS_KEYS[name] + ("loss",):
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), \
            (k, got[k], want[k])
    assert ("grad_norm" in want) == (name in GRAD_FILES)
    if name in GRAD_FILES:
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            1e-3 * want["grad_norm"], (got["grad_norm"], want["grad_norm"])
