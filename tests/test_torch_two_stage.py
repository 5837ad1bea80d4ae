"""The two-stage slice (Faster R-CNN, Double-Head, Dynamic R-CNN) of the
port against the JAX package, on the CPU, in f32.

One narrow copy of each shipped file (R18, FPN 16, 32-wide FCs, one
Double-Head bottleneck, 3 classes, ``frozen_stages=-1`` so that
``grad_norm`` counts the same tensors; the RPN samples 64 anchors, 200
candidates give 32 proposals, 16 RoIs a image, 20 detections) on 16
procedural images (64x96 and 56x96 on the 64x96 canvas). The JAX detectors' variables are
minted with numpy (``mint_variables``, shapes from ``eval_shape``) and
carried to the port by ``weights.from_jax_variables``. The batch is the
first that both packages' loaders cut (asserted equal). Each JAX detector
computes its RPN maps, RoI head, loss and the loss's gradient in ONE
jitted function (Faster R-CNN's also its proposals, samples, each
stage's loss and its decodes), and Dynamic R-CNN's
loss, gradient and statistics in one more (the threshold and beta are
its arguments), in a module-scoped fixture.

The slice as a whole: each narrow file through the port's
``tools.train`` (2 steps of 8 images, the EvalHook) and ``tools.test``,
resuming from the minted variables as ``step_0.pt``, f32 steps. Its
first step's losses and ``grad_norm`` are held against the JAX step's
computation on the same batch from the same variables (the loss and its
gradient, which is what the JAX runner's ``make_train_step`` computes; the
JAX runner itself raises on all three shipped files, ROADMAP Queue 3, and
its compile costs more than this file's time budget). The port's config
has 8 times the JAX config's ``samples_per_gpu``: the JAX loader batches
it x 8 virtual devices.

Tolerances: tensors 1e-4 of max(1, max|ref|) (``assert_close``);
gradients 1e-4 of each tensor's largest entry, floored at 1e-6
(``grads_close``); losses 1e-4 relative, ``grad_norm`` 1e-3 relative;
proposals' validity, sampled labels, positives, validity and the
detections' validity and labels exactly, where each package computes
them from its own maps (a selection follows the order of scores and IoUs,
which agree to far more than their gaps on these inputs).
"""

import dataclasses
import functools
import glob
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core import two_stage as jts
from lsnet_tpu.data import coco as j_coco
from lsnet_tpu.data.extra import build_dataset as j_build_dataset
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models.heads import two_stage as jheads
from lsnet_tpu.ops import roi as jroi
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch.core import two_stage as pts
from lsnet_torch.data import coco as p_coco
from lsnet_torch.models import build_detector
from lsnet_torch.ops import roi as proi
from lsnet_torch.tools import test as test_tool
from lsnet_torch.tools import train as train_tool
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import loop as ploop
from lsnet_torch.train import step as pstep
from lsnet_torch.train.checkpoint import save_checkpoint, train_meta
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import from_jax_variables, to_jax_variables
from torch_port_util import assert_close, grads_close, mint_variables, t

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
STRIDES = (4, 8, 16, 32, 64)
JAX_DEVICES = 8
FILES = {"faster": "faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py",
         "double": "double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py",
         "dynamic": "dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py"}
# the two detectors (Dynamic R-CNN's is Faster R-CNN's)
MODELS = ("faster", "double")
# Dynamic R-CNN's (iou_thr, beta): the file's initial pair, and a
# threshold no candidate reaches (no positive: stat_beta is inf)
DYNAMIC = ((0.4, 1.0), (1.5, 0.5))


def _config(cls, root, name, samples_per_gpu):
    """The narrow copy of a shipped file, read by ``cls``; (path, cfg)."""
    data = dict(ann_file=os.path.join(root, "ann.json"),
                img_prefix=os.path.join(root, "imgs"),
                img_scale=(HW[1], HW[0]))
    bh = dict(num_classes=3, fc_out_channels=32)
    if name == "double":
        bh.update(conv_out_channels=32, num_convs=1)
    cfg = dict(
        _base_=os.path.join(REPO, "configs", FILES[name]),
        model=dict(pretrained=None,
                   backbone=dict(depth=18, frozen_stages=-1),
                   neck=dict(in_channels=[64, 128, 256, 512],
                             out_channels=16),
                   rpn_head=dict(in_channels=16, feat_channels=16),
                   roi_head=dict(bbox_head=bh)),
        train_cfg=dict(rpn=dict(sampler=dict(num=64)),
                       rpn_proposal=dict(nms_pre=200, max_per_img=32),
                       rcnn=dict(sampler=dict(num=16))),
        test_cfg=dict(rcnn=dict(max_per_img=20)),
        data=dict(samples_per_gpu=samples_per_gpu, train=dict(data),
                  val=dict(data), test=dict(data)),
        canvas_shape=HW, max_instances=8, log_interval=1, total_epochs=1,
        checkpoint_config=dict(interval=1),
        lr_config=dict(warmup_iters=2, step=[1]), optimizer=dict(lr=0.01),
        optimizer_config=dict(grad_clip=dict(max_norm=35)))
    path = os.path.join(root, f"{name}_{samples_per_gpu}.py")
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return path, cls.fromfile(path)


def _first_batch(cfg, loader_cls, dataset_fn, config_cls, batch_size):
    d = cfg.data.train
    ds = dataset_fn(d.type, config_cls(
        ann_file=d.ann_file, img_prefix=d.img_prefix, task="bbox",
        num_vectors=4, img_scale=tuple(d.img_scale),
        flip_ratio=d.get("flip_ratio", 0.5), max_instances=8))
    return next(iter(loader_cls(ds, batch_size, HW).epoch(0)))


def _rois():
    """RoIs (N, 5) of 8 to 900 px a side on images 0 to 7, so every level
    of the first four (the last by its clamp) takes some."""
    rng = np.random.RandomState(1)
    side = np.exp(rng.uniform(np.log(8), np.log(900), (24, 2)))
    xy = rng.uniform(-10, 80, (24, 2))
    b = rng.randint(0, 8, (24, 1))
    return np.concatenate([b, xy, xy + side], 1).astype(np.float32)


def _jax_pieces(model, fast_model, cfg, tcfg):
    """The JAX side of one detector in one jitted function: its RPN maps,
    RoI head, loss and gradient; with ``fast_model`` (Faster R-CNN) also
    the proposals, the sampled RoIs, the RPN and R-CNN losses alone, the
    decode and Fast R-CNN's decode of the proposals."""
    def fn(variables, fast_vars, batch, rois):
        feats = model.apply(variables, batch["image"], method="extract")
        rpn_outs = model.apply(variables, feats, method="rpn")

        def total(params):
            return jts.two_stage_loss(
                model, {"params": params,
                        "batch_stats": variables["batch_stats"]}, batch, cfg)
        (loss, terms), grads = jax.value_and_grad(total, has_aux=True)(
            variables["params"])
        sfs = batch["scale_factor"]
        out = {"rpn": rpn_outs, "roi": model.apply(variables, feats, rois,
                                                   method="roi_forward"),
               "loss": (loss, terms, grads)}
        if fast_model is None:
            return out
        props, pvalid = jts.rpn_proposals(rpn_outs, batch["img_shape"], cfg)
        sampled = jts.sample_rois(props, pvalid, batch["gt_bboxes"],
                                  batch["gt_valid"], batch["gt_labels"], cfg)
        rcnn_in = model.apply(variables, feats,
                              jts._rois_with_batch_idx(sampled[0]),
                              method="roi_forward")
        out.update({
            "props": (props, pvalid), "sampled": sampled,
            "rcnn_in": rcnn_in,
            "rpn_loss": jts.rpn_loss(rpn_outs, batch, cfg),
            "rcnn_loss": jts.rcnn_loss(*rcnn_in, *sampled[1:], cfg),
            "det": jts.two_stage_decode(
                model, variables, batch["image"], batch["img_shape"], sfs,
                cfg, tcfg),
            "fast_det": jts.fast_rcnn_decode(
                fast_model, fast_vars, batch["image"], props, pvalid,
                batch["img_shape"], sfs, cfg, tcfg)})
        return out
    return jax.jit(fn)


def _jax_dynamic(model, cfg):
    """Dynamic R-CNN's loss, its gradient and statistics, the threshold and
    beta traced."""
    def fn(variables, batch, thr, beta):
        def f(params):
            return jts.dynamic_rcnn_loss(
                model, {"params": params,
                        "batch_stats": variables["batch_stats"]},
                batch, cfg, thr, beta)
        (loss, terms), grads = jax.value_and_grad(f, has_aux=True)(
            variables["params"])
        return loss, terms, grads
    return jax.jit(fn)


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in jax.tree.leaves(tree))))


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
def slice_(tmp_path_factory):
    """The JAX results on the first batch, the port's models, and each
    file through the port's tools.train / tools.test."""
    root = str(tmp_path_factory.mktemp("two_stage"))
    make_shapes_coco(root, 16, seed=3, hw=[HW, (56, 96)])
    out = {"root": root, "rois": _rois()}
    _, jcfg = _config(JConfig, root, "faster", 1)
    _, pcfg = _config(Config, root, "faster", JAX_DEVICES)
    jb = _first_batch(jcfg, j_coco.DataLoader, j_build_dataset,
                      j_coco.DatasetConfig, JAX_DEVICES)
    pb = _first_batch(pcfg, p_coco.DataLoader, ploop.build_dataset,
                      p_coco.DatasetConfig, JAX_DEVICES)
    out["jbatch"], out["batch"] = jb, pb
    tscfg = jloop.two_stage_cfg_from(jcfg, HW)
    tcfg = jloop.test_cfg_from(jcfg, HW)
    out["ts"] = ploop.two_stage_cfg_from(pcfg, HW)
    out["test"] = ploop.test_cfg_from(pcfg, HW)
    for name in MODELS + ("dynamic",):
        res = out[name] = {}
        ppath, pcfg = _config(Config, root, name, JAX_DEVICES)
        _, jcfg = _config(JConfig, root, name, 1)
        jmodel, _ = j_build(jcfg.model.to_dict())
        v = mint_variables(jmodel, jnp.zeros((1, *HW, 3)), seed=2)
        res["variables"] = v
        model = build_detector(pcfg.model.to_dict())
        model.load_state_dict(from_jax_variables(v), strict=True)
        res["model"] = model
        if name == "dynamic":
            fn = _jax_dynamic(jmodel, tscfg)
            res["jax"] = [jax.tree.map(np.asarray, fn(v, jb, thr, beta))
                          for thr, beta in DYNAMIC]
        else:
            fast, fast_v = None, None
            if name == "faster":
                fast, _ = j_build(dict(jcfg.model.to_dict(),
                                       type="FastRCNN"))
                fast_v = {"params": {k: x for k, x in v["params"].items()
                                     if k != "rpn_head"},
                          "batch_stats": v["batch_stats"]}
                fmodel = build_detector(dict(pcfg.model.to_dict(),
                                             type="FastRCNN"))
                fmodel.load_state_dict(from_jax_variables(fast_v),
                                       strict=True)
                res["fast"] = fmodel
            res["jax"] = jax.tree.map(np.asarray, _jax_pieces(
                jmodel, fast, tscfg, tcfg)(v, fast_v, jb, out["rois"]))
        res.update(_port_run(root, name, ppath, pcfg, v))
    return out


def _port_run(root, name, path, cfg, variables):
    """The narrow file through tools.train (from ``variables``, f32 steps)
    and tools.test."""
    init = build_detector(cfg.model.to_dict())
    init.load_state_dict(from_jax_variables(variables), strict=True)
    optimizer, _ = build_optimizer(init.parameters(), 0.01, 2, [1])
    start = save_checkpoint(os.path.join(root, f"init_{name}"), init,
                            optimizer, 0, train_meta())
    work = os.path.join(root, f"port_{name}")
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ploop, "make_train_step", functools.partial(
            pstep.make_train_step, mixed_precision=False))
        mp.setattr(ploop, "DataLoader",
                   _recording_loader(p_coco.DataLoader, seen))
        res = train_tool.main([path, "--work-dir", work, "--resume-from",
                               start, "--device", "cpu"])
    metrics = test_tool.main([path, os.path.join(work, "ckpts",
                                                 "step_2.pt"),
                              "--eval", "bbox", "--device", "cpu"])
    return {"step": res["step"], "seen": seen,
            "train": _log_records(work, "train"),
            "val": _log_records(work, "val"), "metrics": metrics}


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


# ------------------------------------------------------------ RoI ops

def _feats(seed=3, c=8):
    return np.random.RandomState(seed).randn(2, 12, 16, c).astype(np.float32)


def _op_rois(seed=4, n=20):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-5, 50, (n, 2))
    wh = rng.uniform(1, 40, (n, 2))
    return np.concatenate([rng.randint(0, 2, (n, 1)), x1, x1 + wh],
                          1).astype(np.float32)


ROI_OPS = {"roi_align": dict(spatial_scale=0.25, sampling_ratio=2),
           "roi_pool": dict(spatial_scale=0.25),
           "deform_roi_pool": dict(spatial_scale=0.25, gamma=0.1,
                                   sample_per_part=4)}


@pytest.mark.parametrize("op", sorted(ROI_OPS))
def test_roi_ops_match_jax(op):
    """Forward and the gradient of sum(out * probe) with respect to the
    features (and deformable pooling's offsets): 1e-4 of max(1,
    max|ref|). RoIPool's equal maxima share their gradient in both."""
    feats, rois = _feats(), _op_rois()
    probe = np.random.RandomState(5).randn(20, 7, 7, 8).astype(np.float32)
    offs = np.random.RandomState(6).randn(20, 7, 7, 2).astype(np.float32)
    kw = ROI_OPS[op]
    deform = op == "deform_roi_pool"

    def jf(f, o):
        args = (f, rois, o) if deform else (f, rois)
        out = getattr(jroi, op)(*args, out_size=(7, 7), **kw)
        return jnp.sum(out * probe), out
    (_, want), (gf, go) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(feats, offs)
    tf = t(feats).requires_grad_()
    to = t(offs).requires_grad_()
    args = (tf, t(rois), to) if deform else (tf, t(rois))
    got = getattr(proi, op)(*args, out_size=(7, 7), **kw)
    (got * t(probe)).sum().backward()
    assert_close(got, want)
    assert_close(tf.grad, gf)
    if deform:
        assert_close(to.grad, go)


def test_multilevel_roi_align_routes_every_level():
    """RoIs on each of the first four levels (and above the last, clamped)
    against JAX's all-levels-then-mask form: the features and every
    level's gradient, 1e-4 of max(1, max|ref|)."""
    rng = np.random.RandomState(7)
    feats = [rng.randn(8, -(-HW[0] // s), -(-HW[1] // s), 8).astype(
        np.float32) for s in STRIDES]
    rois = _rois()
    lv = proi.roi_levels(t(rois), 4).numpy()
    assert set(lv) == {0, 1, 2, 3}
    probe = rng.randn(len(rois), 7, 7, 8).astype(np.float32)

    def jf(fs):
        out = jheads.multilevel_roi_align(fs, rois, STRIDES)
        return jnp.sum(out * probe), out
    (_, want), gw = jax.jit(jax.value_and_grad(jf, has_aux=True))(feats)
    tf = [t(f).requires_grad_() for f in feats]
    got = proi.multilevel_roi_align(tf, t(rois), STRIDES)
    (got * t(probe)).sum().backward()
    assert_close(got, want)
    for f, g in zip(tf, gw):
        assert_close(f.grad if f.grad is not None else torch.zeros_like(f),
                     g)


# ---------------------------------------------------- heads and stages

def test_both_loaders_cut_the_same_first_batch(slice_):
    """The JAX loader's first batch (``samples_per_gpu`` x 8 devices) and
    the port's, which the runner's first step also took; padded GT slots
    and an image under the canvas in it."""
    jb, pb = slice_["jbatch"], slice_["batch"]
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    for name in FILES:
        first = slice_[name]["seen"][0]
        for k in pb:
            np.testing.assert_array_equal(first[k], pb[k], err_msg=k)
    assert (~pb["gt_valid"]).any() and (pb["img_shape"][:, 0] < HW[0]).any()


@pytest.mark.parametrize("name", MODELS)
def test_rpn_maps_and_roi_head_match_jax(slice_, name):
    """The RPN maps and ``roi_forward`` (the Shared2FC / Double-Head bbox
    head on RoIs of every level) from the same variables."""
    model, jres = slice_[name]["model"], slice_[name]["jax"]
    with torch.no_grad():
        feats = model.extract(t(slice_["batch"]["image"]))
        rpn = model.rpn(feats)
        cls, reg = model.roi_forward(feats, t(slice_["rois"]))
    for key in ("rpn_cls", "rpn_reg"):
        for g, w_ in zip(rpn[key], jres["rpn"][key]):
            assert_close(g, w_)
    assert_close(cls, jres["roi"][0])
    assert_close(reg, jres["roi"][1])


def test_rpn_proposals_match_jax(slice_):
    """The proposals of the JAX RPN maps (top ``nms_pre`` decoded,
    clipped to each image, NMS-ed) through the port: the same validity,
    boxes 1e-4 of max(1, max|ref|); and from the port's own maps the
    same again."""
    jres = slice_["faster"]["jax"]
    cfg = slice_["ts"]
    shapes = t(slice_["batch"]["img_shape"])
    rpn = {k: [t(m) for m in v] for k, v in jres["rpn"].items()}
    props, pvalid = pts.rpn_proposals(rpn, shapes, cfg)
    np.testing.assert_array_equal(pvalid.numpy(), jres["props"][1])
    assert_close(props, jres["props"][0])
    assert pvalid.sum() > 8 * 10
    with torch.no_grad():
        own, own_v = pts.rpn_proposals(
            slice_["faster"]["model"](t(slice_["batch"]["image"])), shapes,
            cfg)
    np.testing.assert_array_equal(own_v.numpy(), jres["props"][1])
    assert_close(own, jres["props"][0])


def test_sample_rois_breaks_ties_as_jax():
    """Hand-made proposals: a row of boxes far from every GT (IoU 0
    ties), exact duplicates, invalid padded rows, padded GT slots, two
    GTs tied at IoU 1 with a proposal, and one image with fewer positives
    than the quota; the sampled boxes, labels, positives and validity
    equal JAX's, the deltas 1e-5 of max(1, max|ref|)."""
    cfg = dict(image_shape=HW, num_classes=4, rcnn_num_samples=24)
    props = np.zeros((2, 20, 4), np.float32)
    far = np.array([[70, 40, 90, 60]], np.float32)
    props[:, :8] = far + np.arange(8)[:, None] * [0.5, 0, 0.5, 0]
    props[:, 8:11] = [[8, 8, 40, 40], [10, 8, 40, 42], [10, 8, 40, 42]]
    props[:, 11:14] = [[0, 0, 10, 10], [20, 12, 58, 50], [19, 9, 61, 52]]
    pvalid = np.ones((2, 20), bool)
    pvalid[:, 14:] = False
    pvalid[1, 3:6] = False
    gt = np.zeros((2, 4, 4), np.float32)
    gt[0, :3] = [[8, 8, 40, 40], [20, 10, 60, 50], [50, 4, 90, 30]]
    gt[1, :2] = [[4, 6, 30, 44], [30, 20, 76, 52]]
    gvalid = np.zeros((2, 4), bool)
    gvalid[0, :3] = gvalid[1, :2] = True
    labels = np.array([[1, 2, 0, 0], [3, 1, 0, 0]], np.int32)
    j = jax.jit(lambda *a: jts.sample_rois(*a, jts.TwoStageConfig(**cfg)))(
        props, pvalid, gt, gvalid, labels)
    got = pts.sample_rois(t(props), t(pvalid), t(gt), t(gvalid), t(labels),
                          pts.TwoStageConfig(**cfg))
    for name, g, w_ in zip(("rois", "labels", "deltas", "pos", "valid"),
                           got, j):
        w_ = np.asarray(w_)
        if name == "deltas":
            assert_close(g, w_, rel=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), w_, err_msg=name)
    pos, valid = np.asarray(j[3]), np.asarray(j[4])
    assert pos[0].sum() == 6 > pos[1].sum() and (~pos & valid).any()


def test_degenerate_negative_keeps_loss_bbox_finite():
    """ROADMAP Queue 3: a valid proposal clipped to zero height at the
    image's edge, sampled as a negative, gets NaN deltas from JAX's
    ``sample_rois`` (log(0 / 0)), and JAX's ``rcnn_loss`` gives a NaN
    ``loss_bbox`` (NaN x 0); the port encodes every RoI but a positive as
    the unit box (zero deltas): its deltas equal JAX's elsewhere, and its
    losses equal JAX's on JAX's deltas with the NaN rows set to 0."""
    cfg = dict(image_shape=HW, num_classes=3, rcnn_num_samples=8)
    props = np.array([[[0, 0, 96, 0], [8, 8, 40, 40], [50, 30, 90, 60],
                       [10, 8, 41, 42]]], np.float32)
    pvalid = np.ones((1, 4), bool)
    gt = np.array([[[8, 8, 40, 40], [0, 0, 0, 0]]], np.float32)
    gvalid = np.array([[True, False]])
    labels = np.array([[2, 0]], np.int32)
    jcfg, pcfg = jts.TwoStageConfig(**cfg), pts.TwoStageConfig(**cfg)
    j = [np.asarray(x) for x in jax.jit(
        lambda *a: jts.sample_rois(*a, jcfg))(props, pvalid, gt, gvalid,
                                             labels)]
    got = pts.sample_rois(t(props), t(pvalid), t(gt), t(gvalid), t(labels),
                          pcfg)
    nan = np.isnan(j[2]).any(-1)
    assert nan.any() and not j[3][nan].any() and j[4][nan].all()
    assert np.isfinite(got[2].numpy()).all()
    np.testing.assert_array_equal(got[2].numpy()[nan], 0.0)
    assert_close(got[2][torch.from_numpy(~nan)], j[2][~nan], rel=1e-5)
    rng = np.random.RandomState(9)
    cls = rng.randn(8, 4).astype(np.float32)
    reg = rng.randn(8, 12).astype(np.float32)
    want = jts.rcnn_loss(cls, reg, j[1], j[2], j[3], j[4], jcfg)
    assert np.isnan(float(want[1]))
    want = jts.rcnn_loss(cls, reg, j[1], np.nan_to_num(j[2]), j[3], j[4],
                         jcfg)
    for g, w_ in zip(pts.rcnn_loss(t(cls), t(reg), got[1], got[2], got[3],
                                   got[4], pcfg), want):
        assert abs(g.item() - float(w_)) <= 1e-5 * abs(float(w_))


def test_rpn_and_rcnn_losses_match_jax(slice_):
    """``rpn_loss`` on the port's own RPN maps, ``rcnn_loss`` on JAX's
    sampled RoIs and logits: 1e-4 relative."""
    jres = slice_["faster"]["jax"]
    cfg = slice_["ts"]
    batch = _tbatch(slice_["batch"])
    with torch.no_grad():
        lc, lr = pts.rpn_loss(slice_["faster"]["model"](batch["image"]),
                              batch, cfg)
    assert_close(lc, jres["rpn_loss"][0])
    assert_close(lr, jres["rpn_loss"][1])
    cls, reg = jres["rcnn_in"]
    _, labels, deltas, pos, valid = jres["sampled"]
    got = pts.rcnn_loss(t(cls), t(reg), t(labels).long(), t(deltas), t(pos),
                        t(valid), cfg)
    for g, w_ in zip(got, jres["rcnn_loss"]):
        assert_close(g, w_)


def test_sampled_rois_match_jax(slice_):
    """``sample_rois`` on each package's own proposals: the same labels,
    positives and validity, boxes and deltas 1e-4 of max(1, max|ref|)."""
    model, jres = slice_["faster"]["model"], slice_["faster"]["jax"]
    batch = _tbatch(slice_["batch"])
    cfg = slice_["ts"]
    with torch.no_grad():
        props, pvalid = pts.rpn_proposals(model(batch["image"]),
                                          batch["img_shape"], cfg)
        sampled = pts.sample_rois(props, pvalid, batch["gt_bboxes"],
                                  batch["gt_valid"], batch["gt_labels"], cfg)
    for key, g, w_ in zip(("rois", "labels", "deltas", "pos", "valid"),
                          sampled, jres["sampled"]):
        if key in ("labels", "pos", "valid"):
            np.testing.assert_array_equal(g.numpy(), w_, err_msg=key)
        else:
            assert_close(g, w_)
    assert jres["sampled"][3].any() and (~jres["sampled"][3]
                                         & jres["sampled"][4]).any()


@pytest.mark.parametrize("name", MODELS)
def test_two_stage_loss_and_gradients_match_jax(slice_, name):
    """``two_stage_loss`` from each package's own maps: the four terms
    1e-4 relative, every parameter's gradient (``grads_close``)."""
    model, jres = slice_[name]["model"], slice_[name]["jax"]
    batch = _tbatch(slice_["batch"])
    cfg = slice_["ts"]
    total, terms = pts.two_stage_loss(model, batch, cfg)
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, params)
    want_total, want_terms, want_grads = jres["loss"]
    assert sorted(terms) == sorted(want_terms)
    for k, v in terms.items():
        assert abs(v.item() - want_terms[k]) <= 1e-4 * max(
            1.0, abs(want_terms[k])), k
    assert abs(total.item() - want_total) <= 1e-4 * abs(want_total)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    got = to_jax_variables(model, dict(zip(names, grads)))["params"]
    grads_close(got, want_grads, rel=1e-4, abs_=1e-6)


@pytest.mark.parametrize("case", range(len(DYNAMIC)))
def test_dynamic_rcnn_loss_and_statistics_match_jax(slice_, case):
    """``dynamic_rcnn_loss`` at the file's initial threshold and beta,
    and at a threshold no candidate reaches: the four terms, ``stat_iou``
    and ``stat_beta`` 1e-4 relative (``stat_beta`` ``inf`` in the second
    case, where no RoI is positive), every parameter's gradient
    (``grads_close``)."""
    res = slice_["dynamic"]
    model = res["model"]
    thr, beta = DYNAMIC[case]
    total, got = pts.dynamic_rcnn_loss(
        model, _tbatch(slice_["batch"]), slice_["ts"], torch.tensor(thr),
        torch.tensor(beta))
    want_total, want, want_grads = res["jax"][case]
    assert sorted(got) == sorted(want)
    for k, w_ in want.items():
        g = got[k].item()
        if np.isinf(w_):
            assert g == w_, k
        else:
            assert abs(g - w_) <= 1e-4 * max(1.0, abs(w_)), (k, g, w_)
    assert abs(total.item() - want_total) <= 1e-4 * abs(want_total)
    assert np.isinf(want["stat_beta"]) == (case == 1)
    assert want["stat_iou"] > 0
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, params)
    grads_close(to_jax_variables(model, dict(zip(names, grads)))["params"],
                want_grads, rel=1e-4, abs_=1e-6)


def test_dynamic_rcnn_schedule_over_one_interval():
    """The port's schedule and JAX's on the same statistics over two
    intervals of 4 steps (an inf ``stat_beta`` skipped): equal threshold
    and beta after every step."""
    rng = np.random.RandomState(8)
    stats = [(float(rng.uniform(0.3, 0.8)),
              float("inf") if i in (2, 5) else float(rng.uniform(0.05, 2)))
             for i in range(8)]
    j = jts.DynamicRCNNSchedule(0.4, 1.0, 4)
    p = pts.DynamicRCNNSchedule(0.4, 1.0, 4)
    seen = []
    for s in stats:
        want = j.update(*s)
        assert p.update(*s) == want
        seen.append(want)
    assert seen[2] == (0.4, 1.0) and seen[3] != (0.4, 1.0)


def _same_detections(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  want.labels[valid])
    mask = torch.from_numpy(valid.copy())
    assert_close(got.bboxes[mask], want.bboxes[valid])
    assert_close(got.scores[mask], want.scores[valid])


def test_two_stage_decode_matches_jax(slice_):
    """``two_stage_decode`` of Faster R-CNN (each package's own
    proposals, the batch's scale factors): the detections' validity and
    labels exactly, boxes and scores 1e-4 of max(1, max|ref|). The decode
    reads the RoI head only through ``roi_forward``, held against JAX for
    both heads above."""
    b = _tbatch(slice_["batch"])
    with torch.no_grad():
        got = pts.two_stage_decode(slice_["faster"]["model"], b["image"],
                                   b["img_shape"], b["scale_factor"],
                                   slice_["ts"], slice_["test"])
    _same_detections(got, slice_["faster"]["jax"]["det"])


def test_fast_rcnn_decode_matches_jax(slice_):
    """``fast_rcnn_decode`` on the JAX RPN's proposals, from the Faster
    R-CNN variables less the RPN."""
    jres = slice_["faster"]["jax"]
    b = _tbatch(slice_["batch"])
    props, pvalid = jres["props"]
    with torch.no_grad():
        got = pts.fast_rcnn_decode(
            slice_["faster"]["fast"], b["image"], t(props), t(pvalid),
            b["img_shape"], b["scale_factor"], slice_["ts"], slice_["test"])
    _same_detections(got, jres["fast_det"])


def test_weights_bridge_carries_the_dense_kernels(slice_):
    """flax ``nn.Dense`` kernels (in, out) land as ``nn.Linear`` weights
    (out, in) and come back equal through ``to_jax_variables``."""
    v = slice_["double"]["variables"]
    model = slice_["double"]["model"]
    k = v["params"]["bbox_head"]["fc_branch0"]["kernel"]
    assert k.shape == (16 * 49, 32)
    np.testing.assert_array_equal(
        model.bbox_head.fc_branch0.weight.detach().numpy(), k.T)
    back = to_jax_variables(model)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)


# flax's initializers of the two-stage heads, by leaf: the std of the
# distribution each draws from (LeCun normal: 1 / sqrt(fan_in))
HEAD_STD = {"rpn_conv": 0.01, "rpn_cls": 0.01, "rpn_reg": 0.01,
            "fc_cls": 0.01, "fc_reg": 0.001}


@pytest.mark.parametrize("name", MODELS)
def test_training_init_matches_the_jax_initializers(name):
    """``init_weights_`` of the RPN and bbox heads (64 wide) against the
    initializers of the JAX heads (``eval_shape`` for the names and
    shapes; ``two_stage.py``): every bias 0, FrozenBatchNorm scale 1; the
    RPN convs and ``fc_cls`` N(0, 0.01), ``fc_reg`` N(0, 0.001), the
    shared FCs and the Double-Head convs LeCun normal (1 / sqrt(fan_in)),
    each kernel's spread within 15 %."""
    from lsnet_torch.models.init import init_weights_
    head_kw = dict(num_classes=3)
    if name == "double":
        jhead = jheads.DoubleConvFCBBoxHead(num_convs=1, conv_channels=64,
                                            fc_channels=64, **head_kw)
        args = [jnp.zeros((2, 7, 7, 16))] * 2
        roi = dict(type="DoubleHeadRoIHead", bbox_head=dict(
            type="DoubleConvFCBBoxHead", num_convs=1, conv_out_channels=64,
            fc_out_channels=64, **head_kw))
    else:
        jhead = jheads.Shared2FCBBoxHead(fc_channels=64, **head_kw)
        args = [jnp.zeros((2, 7, 7, 16))]
        roi = dict(bbox_head=dict(fc_out_channels=64, **head_kw))
    jrpn = jheads.RPNHead(in_channels=16, feat_channels=64)
    model = build_detector(dict(
        type="FasterRCNN", backbone=dict(type="ResNet", depth=18),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                  out_channels=16, num_outs=5),
        rpn_head=dict(type="RPNHead", in_channels=16, feat_channels=64),
        roi_head=roi))
    init_weights_(model, torch.Generator().manual_seed(0))
    got = to_jax_variables(model)["params"]
    for key, head, a in (("rpn_head", jrpn, [jnp.zeros((1, 8, 8, 16))]),
                         ("bbox_head", jhead, args)):
        shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0),
                                                  *a))["params"]
        flat_w = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got[key])[0])
        assert flat_g.keys() == flat_w.keys()
        for path, w_ in flat_w.items():
            name_ = jax.tree_util.keystr(path)
            g = flat_g[path]
            assert g.shape == w_.shape, name_
            leaf = path[-1].key
            if leaf in ("bias", "scale"):
                np.testing.assert_array_equal(
                    g, np.full(w_.shape, float(leaf == "scale")),
                    err_msg=name_)
                continue
            std = HEAD_STD.get(path[0].key,
                               1.0 / np.sqrt(np.prod(w_.shape[:-1])))
            assert abs(g.std() / std - 1) < 0.15, name_


# --------------------------------------------------------------- files

@pytest.mark.parametrize("name", sorted(FILES))
def test_file_settings_match_the_jax_runner(name):
    """``two_stage_cfg_from`` and ``test_cfg_from`` of each shipped file
    against the JAX runner's, field by field, and the settings that the
    JAX runner leaves unread, which the port follows:

    * ``proposal_count`` is ``min(rpn_proposal.max_per_img, 512)``;
    * ``test_cfg.rpn`` is not read: the decode's proposals take
      ``train_cfg.rpn_proposal`` (nms_pre 2000, not 1000);
    * the file's RoIAlign ``sampling_ratio=0`` is dropped: the extractor
      samples 2 x 2 a bin;
    * Double-Head's loss weights 2.0 and its SmoothL1: ``rcnn_loss`` is
      unweighted CE plus SmoothL1 at beta 1.0;
    * the RPN assigner's ``min_pos_iou`` is ``rpn_neg_iou``;
    * Dynamic R-CNN's ``iou_topk`` / ``beta_topk`` are
      ``dynamic_rcnn_loss``'s defaults (the file's own values);
    * ``optimizer_config.grad_clip=None``: the JAX runner raises
      ``AttributeError`` on it; the port clips at 35, the JAX runner's
      default where a file sets no clip (ROADMAP Queue 3).
    """
    path = os.path.join(REPO, "configs", FILES[name])
    pc, jc = Config.fromfile(path), JConfig.fromfile(path)
    assert pc.to_dict() == jc.to_dict()
    ploop.check_runnable(pc)
    got = ploop.two_stage_cfg_from(pc, (800, 1344))
    want = jloop.two_stage_cfg_from(jc, (800, 1344))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    gt_, wt = ploop.test_cfg_from(pc, (800, 1344)), \
        jloop.test_cfg_from(jc, (800, 1344))
    assert dataclasses.asdict(gt_) == dataclasses.asdict(wt)
    assert got.proposal_count == 512 < pc.train_cfg.rpn_proposal.max_per_img
    assert got.nms_pre == 2000 != pc.test_cfg.rpn.nms_pre
    assert pc.model.roi_head.bbox_roi_extractor.roi_layer.sampling_ratio == 0
    sig = inspect.signature(proi.multilevel_roi_align).parameters
    assert sig["sampling_ratio"].default == 2
    assert inspect.signature(pts.rcnn_loss).parameters[
        "smoothl1_beta"].default == 1.0
    assert pc.train_cfg.rpn.assigner.min_pos_iou == got.rpn_neg_iou
    if name == "double":
        bh = pc.model.roi_head.bbox_head
        assert bh.loss_cls.loss_weight == bh.loss_bbox.loss_weight == 2.0
        assert bh.loss_bbox.type == "SmoothL1Loss"
    if name == "dynamic":
        dyn = pc.train_cfg.rcnn.dynamic_rcnn
        sig = inspect.signature(pts.dynamic_rcnn_loss).parameters
        assert (dyn.iou_topk, dyn.beta_topk) == (
            sig["iou_topk"].default, sig["beta_topk"].default)
        sched = ploop.dynamic_schedule(pc)
        assert (sched.iou_thr, sched.beta, sched.interval) == (
            0.4, 1.0, 100)
    else:
        assert ploop.dynamic_schedule(pc) is None
    assert pc.optimizer_config.grad_clip is None
    with pytest.raises(AttributeError):
        jc.get("optimizer_config", {}).get("grad_clip", {}).get(
            "max_norm", 35.0)
    assert ploop.clip_norm_from(pc) == 35.0


@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_trains_and_tests_each_file(slice_, name):
    """The port's tools.train (2 steps, the EvalHook) and tools.test on
    the narrow copy: the four loss terms finite and logged (Dynamic
    R-CNN's statistics popped), the EvalHook's 12 bbox metrics equal
    tools.test's on the step-2 checkpoint (1e-5: the log rounds to 5
    decimals)."""
    res = slice_[name]
    assert res["step"] == 2 and len(res["seen"]) == 2
    recs = res["train"]
    assert [(r["epoch"], r["iter"]) for r in recs] == [(1, 1), (1, 2)]
    for r in recs:
        assert {"loss", "loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                "loss_bbox", "grad_norm"} <= r.keys()
        assert not {"stat_iou", "stat_beta"} & r.keys()
        assert all(np.isfinite(v) for k, v in r.items()
                   if k.startswith("loss"))
    metrics = res["metrics"]
    assert len(metrics) == 12
    hook = {k: v for k, v in res["val"][-1].items()
            if k not in ("mode", "epoch")}
    assert hook.keys() == metrics.keys()
    for k, v in metrics.items():
        assert abs(v - hook[k]) <= 1e-5, k


@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_first_step_matches_jax(slice_, name):
    """The port runner's first logged step against JAX's loss and
    gradient on the same batch from the same variables (Dynamic R-CNN at
    the file's initial threshold 0.4 and beta 1.0): each loss 1e-4
    relative, ``grad_norm`` 1e-3 relative."""
    res = slice_[name]
    if name == "dynamic":
        total, terms, grads = res["jax"][0]
    else:
        total, terms, grads = res["jax"]["loss"]
    got = res["train"][0]
    want = {k: float(v) for k, v in terms.items()
            if not k.startswith("stat_")}
    want["loss"] = float(total)
    for k, w_ in want.items():
        assert abs(got[k] - w_) <= 1e-4 * max(1.0, abs(w_)), (k, got[k], w_)
    gn = _global_norm(grads)
    assert abs(got["grad_norm"] - gn) <= 1e-3 * gn, (got["grad_norm"], gn)


@pytest.mark.parametrize("name", ["dynamic", "faster"])
def test_jax_runner_raises_on_the_files(slice_, name, tmp_path):
    """ROADMAP Queue 3: the JAX runner raises ``AttributeError`` on a
    file's ``grad_clip=None`` (every shipped two-stage file; the narrow
    copy with it put back), and, with a clip set, ``ValueError`` on the
    Dynamic R-CNN file: its threshold and beta ride the batch, which the
    runner shards on the data axis, and a scalar cannot be. The port runs
    both (``test_runner_trains_and_tests_each_file``)."""
    import flax.linen as fnn
    _, jcfg = _config(JConfig, slice_["root"], name, 1)
    if name == "faster":
        jcfg.merge_from_dict({"optimizer_config.grad_clip": None})
    v = slice_[name]["variables"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init",
                   lambda self, *a, **k: jax.tree.map(jnp.asarray, v))
        with pytest.raises(AttributeError if name == "faster"
                           else ValueError) as err:
            jloop.train_detector(jcfg, str(tmp_path), eval_interval=100)
    if name == "dynamic":
        assert "dyn_" in str(err.value) and "sharding" in str(err.value)
