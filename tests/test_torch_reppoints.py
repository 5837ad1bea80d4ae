"""RepPoints v1 / v2 in the port against the JAX package, on the CPU.

Inputs are made with numpy from seeds; weights are the JAX modules'
minted variables (``torch_port_util.mint_variables``) loaded through
``weights.from_jax_variables`` (``moment_transfer`` included). The heads
are narrow: 32 channels, one stacked conv, 4 classes, GroupNorm of 8
groups, a 64x64 canvas. The JAX heads, losses, parameter gradients and
decodes run in one compiled function for the file; the small ops run
eagerly.

* ``max_iou_assign`` on random boxes, on forced ties (duplicate boxes, a
  box equal to a GT, two equal GTs, where the later one claims), with
  invalid points and GTs, on an image with no GT, with
  ``gt_max_assign_all`` off and with ``min_pos_iou``: ``gt_idx`` and
  ``ignore`` equal, ``max_overlaps`` 1e-6;
* DCNv1 ``deform_conv`` (stride, padding, dilation, groups): values and
  the gradients of input, offsets and weight 1e-4 of max(1, max|ref|);
* ``points2bbox`` in its three methods: values and gradients 1e-5;
* each head's outputs 1e-4; each loss's terms 1e-5 and the gradients of
  every head parameter 1e-4 of max(1, max|ref|), ``moment_transfer`` and
  the init branch (whose offsets reach the paired gather through the
  straight-through mix) included;
* each decode on the same random head outputs: the same valid mask and
  labels, boxes and scores 1e-5 of their scale;
* the runner: one narrow step and an evaluation of the v1 (moment and
  minmax) and v2 files through ``train_detector`` / ``evaluate_detector``
  (the loss and decode choice by head type), and the image-level API on
  a RepPoints bundle.
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

from lsnet_tpu.core import assign as jassign
from lsnet_tpu.core import reppoints as jrp
from lsnet_tpu.core.decode import TestConfig as JTestConfig
from lsnet_tpu.models.heads.reppoints import RepPointsHead as JRepPointsHead
from lsnet_tpu.models.heads.reppoints import \
    RepPointsV2Head as JRepPointsV2Head
from lsnet_tpu.ops.deform_conv import deform_conv as j_deform_conv
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch import apis
from lsnet_torch.core import assign, reppoints as rp
from lsnet_torch.core.decode import TestConfig
from lsnet_torch.models.heads.reppoints import RepPointsHead, RepPointsV2Head
from lsnet_torch.ops.deform_conv import deform_conv
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING
from lsnet_torch.ops.nms import box_iou
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import loop as ploop
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import (from_jax_variables, load_jax_variables,
                                 to_jax_variables)
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
B, C, M = 2, 4, 5
LEVELS = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
HEAD_KW = dict(num_classes=C, in_channels=32, feat_channels=32,
               point_feat_channels=32, stacked_convs=1, norm_groups=8)
HEADS = {"v1": (JRepPointsHead, RepPointsHead, HEAD_KW),
         "v2": (JRepPointsV2Head, RepPointsV2Head,
                dict(HEAD_KW, corner_dim=16))}
OUT_KEYS = {"v1": ("cls", "pts_init", "pts_refine"),
            "v2": ("cls", "pts_init", "pts_refine", "hem_score",
                   "hem_offset", "sem_score")}
TEST_KW = dict(image_shape=(H, W), num_classes=C, nms_pre=1000,
               score_thr=0.05, nms_iou=0.5, max_per_img=100)


def _rel(got, want, rel=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(1.0, abs(want)), (got, want)


# ------------------------------------------------------------ max_iou_assign

def _boxes(rng, n, lo=0.0, hi=64.0, size=(4.0, 30.0)):
    xy = rng.uniform(lo, hi - size[1], (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _assign_case(case):
    rng = np.random.RandomState(sum(map(ord, case)))
    N = 120
    boxes = np.stack([_boxes(rng, N) for _ in range(B)])
    gts = np.stack([_boxes(rng, M, size=(8.0, 30.0)) for _ in range(B)])
    valid = rng.rand(B, N) > 0.1
    gvalid = np.ones((B, M), bool)
    gvalid[1, 3:] = False
    kw = {}
    if case in ("ties", "best_only"):
        boxes[:, 7] = boxes[:, 3]            # duplicate boxes tie for a GT
        boxes[:, 11] = gts[:, 2]             # IoU exactly 1
        gts[:, 4] = gts[:, 1]                # two equal GTs: the later claims
        valid[:, [3, 7, 11]] = True
        kw = dict(gt_max_assign_all=case == "ties")
    elif case == "invalid_gts":
        gvalid[0, ::2] = False
    elif case == "empty":
        gvalid[:] = False
    elif case == "min_pos_iou":
        kw = dict(min_pos_iou=0.3, pos_iou_thr=0.6, neg_iou_thr=0.3)
    return boxes, valid, gts, gvalid, kw


@pytest.mark.parametrize("case", ["random", "ties", "best_only",
                                  "invalid_gts", "empty", "min_pos_iou"])
def test_max_iou_assign_matches_jax(case):
    boxes, valid, gts, gvalid, kw = _assign_case(case)
    want = jax.vmap(functools.partial(jassign.max_iou_assign, **kw))(
        jnp.asarray(boxes), jnp.asarray(valid), jnp.asarray(gts),
        jnp.asarray(gvalid))
    got = assign.max_iou_assign(t(boxes), t(valid), t(gts), t(gvalid), **kw)
    np.testing.assert_array_equal(got.gt_idx.numpy(),
                                  np.asarray(want.gt_idx))
    np.testing.assert_array_equal(got.ignore.numpy(),
                                  np.asarray(want.ignore))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), atol=1e-6)
    gi = got.gt_idx.numpy()
    if case == "empty":
        assert (gi == -1).all()
    else:
        assert (gi >= 0).any() and (gi == -1).any()
    if case == "ties":
        # the exact box is claimed, the duplicates alike; the best box of
        # the two equal GTs 1 and 4 goes to the later one
        assert (gi[:, 11] == 2).all()
        assert gi[0, 3] == gi[0, 7]
        iou = box_iou(t(boxes[0]), t(gts[0, 1:2]))[:, 0].numpy()
        assert gi[0, int(np.argmax(np.where(valid[0], iou, -1)))] == 4


# ------------------------------------------------------------ DCNv1

@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 1, 1, 1), (2, 1, 1, 2), (1, 2, 2, 1)])
def test_deform_conv_v1_matches_jax(stride, padding, dilation, groups):
    rng = np.random.RandomState(stride * 7 + dilation + groups)
    x = rng.randn(2, 9, 11, 8).astype(np.float32)
    Ho = (9 + 2 * padding - dilation * 2 - 1) // stride + 1
    Wo = (11 + 2 * padding - dilation * 2 - 1) // stride + 1
    off = (1.5 * rng.randn(2, Ho, Wo, 18)).astype(np.float32)
    w = (0.2 * rng.randn(3, 3, 8 // groups, 6)).astype(np.float32)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    probe = rng.randn(2, Ho, Wo, 6).astype(np.float32)

    def jf(*a):
        out = j_deform_conv(*a, **kw)
        return jnp.sum(out * probe), out

    (_, want), jgrads = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(w))
    tx, toff, tw = (t(a).requires_grad_() for a in (x, off, w))
    got = deform_conv(tx, toff, tw, **kw)
    (got * t(probe)).sum().backward()
    assert_close(got, np.asarray(want))
    for g, w_ in zip((tx, toff, tw), jgrads):
        assert_close(g.grad, np.asarray(w_))


# ------------------------------------------------------------ points2bbox

@pytest.mark.parametrize("method", ["minmax", "partial_minmax", "moment"])
def test_points2bbox_matches_jax(method):
    rng = np.random.RandomState(len(method))
    pts = (20 * rng.randn(3, 7, 9, 2) + 30).astype(np.float32)
    moment = (0.2 * rng.randn(2)).astype(np.float32)
    probe = rng.randn(3, 7, 4).astype(np.float32)

    def jf(p, m):
        out = jrp.points2bbox(p, method, m)
        return jnp.sum(out * probe), out

    (_, want), (gp, gm) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(pts), jnp.asarray(moment))
    tp, tm = t(pts).requires_grad_(), t(moment).requires_grad_()
    got = rp.points2bbox(tp, method, tm)
    (got * t(probe)).sum().backward()
    assert_close(got, np.asarray(want), rel=1e-5)
    assert_close(tp.grad, np.asarray(gp), rel=1e-5)
    # minmax and partial_minmax read no moment: no gradient, JAX's zeros
    assert_close(torch.zeros(2) if tm.grad is None else tm.grad,
                 np.asarray(gm), rel=1e-5)


# ------------------------------------------------------------ heads, losses

def _feats():
    rng = np.random.RandomState(3)
    return [rng.randn(B, h, w, 32).astype(np.float32) for h, w in LEVELS]


def _batch():
    rng = np.random.RandomState(4)
    boxes = np.stack([_boxes(rng, M, size=(10.0, 40.0)) for _ in range(B)])
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    valid = np.ones((B, M), bool)
    valid[1, 3:] = False
    return dict(gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
                pad_shape=np.array([[H, W], [H - 8, W - 16]], np.int32))


def _random_outputs(version):
    """Head-shaped outputs with many candidates on every level."""
    rng = np.random.RandomState(5 if version == "v1" else 6)
    dims = {"cls": C, "pts_refine": 18, "hem_score": 2, "hem_offset": 4}
    outs = {}
    for key, d in dims.items():
        if version == "v1" and key.startswith("hem"):
            continue
        outs[key] = [(rng.randn(B, h, w, d) + (1.5 if key == "cls" else 0))
                     .astype(np.float32) for h, w in LEVELS]
    outs["moment"] = (0.3 * rng.randn(2)).astype(np.float32)
    return outs


def _configs(version):
    kind = (rp.RepPointsV2Config, jrp.RepPointsConfig) if version == "v2" \
        else (rp.RepPointsConfig, jrp.RepPointsConfig)
    return (kind[0](image_shape=(H, W), num_classes=C),
            kind[1](image_shape=(H, W), num_classes=C))


DECODE_IN = dict(shapes=np.array([[H, W], [H - 10, W - 20]], np.int32),
                 sfs=np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]],
                              np.float32))


@pytest.fixture(scope="module")
def jax_results():
    """Every head's outputs, loss terms, parameter gradients and decode,
    from one compiled JAX function."""
    feats = _feats()
    jfeats = [jnp.asarray(f) for f in feats]
    variables = {v: mint_variables(jh(**kw), [f[:1] for f in jfeats],
                                   seed=11 + i)
                 for i, (v, (jh, _, kw)) in enumerate(HEADS.items())}
    fns = {"v1": (jrp.reppoints_loss, jrp.reppoints_decode),
           "v2": (jrp.reppoints_v2_loss, jrp.reppoints_v2_decode)}
    tcfg = JTestConfig(**TEST_KW)

    def run(variables, batch, rand, shapes, sfs):
        res = {}
        for v, (jh, _, kw) in HEADS.items():
            head, (loss_fn, decode_fn) = jh(**kw), fns[v]
            jcfg = _configs(v)[1]

            def f(params):
                outs = head.apply({"params": params}, jfeats)
                total, terms = loss_fn(outs, batch, jcfg)
                return total, (terms, outs)

            (total, (terms, outs)), grads = jax.value_and_grad(
                f, has_aux=True)(variables[v]["params"])
            det = decode_fn(rand[v], shapes, sfs, tcfg, jcfg)
            res[v] = dict(total=total, terms=terms, outs=outs,
                          grads=grads, det=det._asdict())
        return res

    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's process-wide sampling state, pinned
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        res = jax.jit(run)(
            to_jax(variables),
            {k: jnp.asarray(a) for k, a in _batch().items()},
            {v: jax.tree.map(jnp.asarray, _random_outputs(v))
             for v in HEADS},
            jnp.asarray(DECODE_IN["shapes"]), jnp.asarray(DECODE_IN["sfs"]))
    return jax.tree.map(np.asarray, res), variables, feats


@pytest.fixture(scope="module")
def port_results(jax_results):
    _, variables, feats = jax_results
    res = {}
    for v, (_, th, kw) in HEADS.items():
        head = th(**kw)
        load_jax_variables(head, variables[v])
        outs = head([t(f).permute(0, 3, 1, 2) for f in feats],
                    TRAIN_SAMPLING)
        loss_fn = rp.reppoints_v2_loss if v == "v2" else rp.reppoints_loss
        total, terms = loss_fn(outs, {k: t(a) for k, a in _batch().items()},
                               _configs(v)[0])
        total.backward()
        grads = to_jax_variables(head, {n: p.grad for n, p in
                                        head.named_parameters()})
        res[v] = dict(total=total, terms=terms, outs=outs, grads=grads,
                      head=head)
    return res


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_head_outputs_match_jax(jax_results, port_results, version):
    want, got = jax_results[0][version]["outs"], port_results[version]["outs"]
    assert set(got) == set(want) == {*OUT_KEYS[version], "moment"}
    for key in OUT_KEYS[version]:
        assert len(got[key]) == len(LEVELS)
        for g, w_ in zip(got[key], want[key]):
            assert tuple(g.shape) == w_.shape, key
            assert_close(g, w_, rel=1e-4)
    assert_close(got["moment"], want["moment"], rel=1e-6)
    if version == "v2":
        # the paired gather reads the 6 corner channels: C = 32 + 6
        assert port_results[version]["head"].cls_refine_dcn.weight_a.shape \
            == (3, 3, 38, 32)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_loss_terms_match_jax(jax_results, port_results, version):
    want, got = jax_results[0][version], port_results[version]
    # (JAX's dict comes back with its keys sorted)
    assert set(got["terms"]) == set(want["terms"])
    assert list(got["terms"])[:3] == ["loss_cls", "loss_pts_init",
                                      "loss_pts_refine"]
    _rel(got["total"], want["total"])
    for k, v in got["terms"].items():
        _rel(v, want["terms"][k])
        assert float(v) > 0, k


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_parameter_gradients_match_jax(jax_results, port_results, version):
    want = jax_results[0][version]["grads"]
    got = port_results[version]["grads"]["params"]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w_ in flat_w.items():
        assert_close(flat_g[path], w_, rel=1e-4)
    # the moment factors and the init branch's kernel take gradients
    assert np.abs(want["moment_transfer"]).max() > 0
    assert np.abs(want["pts_init_out"]["kernel"]).max() > 0


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_decode_matches_jax(jax_results, version):
    want = jax_results[0][version]["det"]
    decode = rp.reppoints_v2_decode if version == "v2" \
        else rp.reppoints_decode
    outs = {k: t(v) if k == "moment" else [t(x) for x in v]
            for k, v in _random_outputs(version).items()}
    got = decode(outs, t(DECODE_IN["shapes"]), t(DECODE_IN["sfs"]),
                 TestConfig(**TEST_KW), _configs(version)[0])
    valid = want["valid"]
    assert valid.sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), want["labels"])
    for name in ("bboxes", "scores", "landmarks"):
        assert_close(getattr(got, name), want[name], rel=1e-5)
    assert not got.landmarks.any()


def test_weights_bridge_carries_the_moment_factors():
    """``moment_transfer`` in both directions; a minmax head has none."""
    for transform, has in (("moment", True), ("minmax", False)):
        jhead = JRepPointsHead(transform_method=transform, **HEAD_KW)
        v = mint_variables(jhead, [jnp.zeros((1, h, w, 32))
                                   for h, w in LEVELS], seed=2)
        assert ("moment_transfer" in v["params"]) == has
        head = RepPointsHead(transform_method=transform, **HEAD_KW)
        load_jax_variables(head, v)
        back = to_jax_variables(head)["params"]
        assert jax.tree.structure(back) == jax.tree.structure(v["params"])
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v["params"])):
            np.testing.assert_array_equal(a, b)
        assert ("head.moment_transfer" in from_jax_variables(
            {"params": {"head": v["params"]}})) == has


# ------------------------------------------------------------ runner, API

RUNNER_FILES = ["reppoints_moment_r50_fpn_1x_coco.py",
                "reppoints_minmax_r50_fpn_1x_coco.py",
                "reppoints_v2_moment_r50_fpn_1x_coco.py"]
RUN_HW = (64, 96)


def narrow_options(root):
    """Config overrides: R18, feat 64, 3 classes, the procedural set at
    64x96, one epoch, an eval at its end. (The corner-pool packs' GroupNorm
    has 32 groups: at feat 32 a group of the 1x1 level holds one value,
    which ``F.group_norm`` refuses in a batch of one.)"""
    ann = os.path.join(root, "ann.json")
    img = os.path.join(root, "imgs")
    norm = dict(type="GN", num_groups=8)
    return {
        "model.pretrained": None,
        "model.backbone.depth": 18, "model.backbone.frozen_stages": -1,
        "model.neck.in_channels": [64, 128, 256, 512],
        "model.neck.out_channels": 64, "model.neck.norm_cfg": norm,
        "model.bbox_head.in_channels": 64,
        "model.bbox_head.feat_channels": 64,
        "model.bbox_head.point_feat_channels": 64,
        "model.bbox_head.stacked_convs": 1,
        "model.bbox_head.norm_cfg": norm,
        "model.bbox_head.num_classes": 3,
        "data.samples_per_gpu": 2,
        "data.train.ann_file": ann, "data.train.img_prefix": img,
        "data.train.img_scale": (96, 64),
        "data.val.ann_file": ann, "data.val.img_prefix": img,
        "data.val.img_scale": (96, 64),
        "canvas_shape": RUN_HW, "log_interval": 1, "total_epochs": 1,
        "checkpoint_config": dict(interval=100), "eval_max_images": 2,
        "lr_config": dict(warmup_iters=1, step=[1]),
        "test_cfg.score_thr": 0.0}


@pytest.fixture(scope="module")
def shapes_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reppoints_shapes"))
    make_shapes_coco(root, 4, seed=5, hw=RUN_HW)
    return root


@pytest.mark.parametrize("name", RUNNER_FILES)
def test_runner_step_and_eval(shapes_set, tmp_path, name):
    path = os.path.join(REPO, "configs", "reppoints", name)
    cfg = Config.fromfile(path)
    cfg.merge_from_dict(narrow_options(shapes_set))
    jcfg = JConfig.fromfile(path)
    jcfg.merge_from_dict(narrow_options(shapes_set))
    loss_cfg = ploop.train_loss_cfg(cfg, RUN_HW)
    want = jloop.reppoints_cfg_from(jcfg, RUN_HW)
    assert type(loss_cfg) is (rp.RepPointsV2Config if "v2" in name
                              else rp.RepPointsConfig)
    for f in want.__dataclass_fields__:
        assert getattr(loss_cfg, f) == getattr(want, f), f
    work = str(tmp_path / "work")
    res = ploop.train_detector(cfg, work, max_iters_per_epoch=1,
                               device="cpu")
    assert res["step"] == 1
    (log,) = glob.glob(os.path.join(work, "*.log.json"))
    with open(log) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["mode"] == "train"]
    val = [r for r in records if r["mode"] == "val"]
    assert len(train) == 1 and len(val) == 1
    terms = {"loss_cls", "loss_pts_init", "loss_pts_refine"}
    if "v2" in name:
        terms |= {"loss_heatmap", "loss_offset", "loss_sem"}
    assert terms <= set(train[0])
    assert all(np.isfinite(train[0][k]) for k in terms | {"loss"})
    assert "bbox_mAP" in val[0]
    decode = ploop.decode_for(res["model"], cfg)
    assert decode.__closure__ is not None      # the RepPoints decode
    if "minmax" in name:
        assert not hasattr(res["model"].head, "moment_transfer")


def test_api_serves_a_reppoints_bundle(shapes_set):
    """``init_detector`` / ``inference_detector`` / ``aug_test`` on the
    narrow v2 file (the CPU, seeded weights); ``aug_test_simple`` names
    what it serves."""
    path = os.path.join(REPO, "configs", "reppoints",
                        "reppoints_v2_moment_r50_fpn_1x_coco.py")
    cfg = Config.fromfile(path)
    cfg.merge_from_dict(narrow_options(shapes_set))
    cfg.merge_from_dict({"data.test.img_scale": (96, 64)})
    bundle = apis.init_detector(cfg, device="cpu")
    apis.random_weights_(bundle.model, 0)
    img = (np.random.RandomState(0).rand(48, 80, 3) * 255).astype(np.uint8)
    res = apis.inference_detector(bundle, img)
    again = apis.inference_detector(bundle, img)
    n = len(res["scores"])
    assert n > 0 and res["landmarks"].shape == (n, 8)
    np.testing.assert_array_equal(res["bboxes"], again["bboxes"])
    assert (res["bboxes"][:, 2] <= 80 + 1e-3).all()
    aug = apis.aug_test(bundle, img, scales=[(96, 64)], flip=True)
    assert len(aug["scores"]) > 0
    with pytest.raises(NotImplementedError, match="use aug_test"):
        apis.aug_test_simple(bundle, img)
