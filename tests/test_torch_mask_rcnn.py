"""The mask branch of the two-stage family (Mask R-CNN, Mask Scoring R-CNN,
PointRend) of the port against the JAX package, on the CPU, in f32.

One narrow copy of each shipped file (R18, FPN 16, 32-wide FCs, 16-wide
mask convs, 3 classes, ``frozen_stages=-1`` so that ``grad_norm`` counts
the same tensors; the RPN samples 64 anchors, 200 candidates give 32
proposals, 16 RoIs a image, 20 detections; the MaskIoU and point heads
keep their fixed widths, as JAX builds them) on 16 procedural images
(64x96 and 56x96 on the 64x96 canvas; 4 more to evaluate), the segm
pipeline's 36-point GT contours. The JAX detectors' variables are minted
with numpy (0.03 N(0, 1)) and carried to the port by
``weights.from_jax_variables``, conditioned so that no comparison turns on
f32 rounding (~1e-7 relative), which would decide a selection or a ReLU
between the two packages:

* the RPN's objectness kernel x 100: otherwise every anchor's score lies
  within 1e-5 of 0.0311, and rounding orders the anchors at the boundary
  of the RPN's hard-negative quota;
* the mask head's biases 0 and its ``mask_logits`` kernel x 1e5: with the
  minted biases a mask's 784 logits lie within 1e-3 of their mean and
  take some 515 distinct values, so rounding orders PointRend's
  uncertain points; now they spread over +-0.3 about 0;
* the MaskIoU head's convolutions' and the point head's hidden FCs'
  biases + 1: otherwise thousands of their pre-activations lie within
  1e-6 of 0, and a ReLU that one package opens and the other shuts moves
  a sum of cancelling gradients by percents.

The Mask R-CNN variables
are the MS R-CNN ones less ``maskiou_head`` (``MaskScoringRCNNDetector``
has every method of ``MaskRCNNDetector``). Each JAX detector computes its
heads, losses, gradients and decodes in ONE jitted function, in a
module-scoped fixture: the MS R-CNN one gives both ``mask_rcnn_loss``'s
gradient and ``mask_scoring_rcnn_loss``'s. The losses run on the loader's
first batch with image 0's second GT box set to its first (its own
contour and label kept: a tie that ``gt_of``'s argmax gives to the first
GT), beside padded GT slots.

The slice as a whole: each narrow file through the port's ``tools.train``
(2 steps of 8 images, the EvalHook) and ``tools.test --eval bbox segm``,
resuming from the minted variables as ``step_0.pt``, f32 steps; its first
step's losses and ``grad_norm`` against the JAX loss and gradient on the
loader's first batch (the JAX runner raises on the three shipped files:
``grad_clip=None``, ROADMAP Queue 3). The port's config has 8 times the
JAX config's ``samples_per_gpu``: the JAX loader batches it x 8 virtual
devices.

Tolerances: tensors 1e-4 of max(1, max|ref|) (``assert_close``);
gradients 1e-4 of each tensor's largest entry, floored at 1e-6
(``grads_close``); losses 1e-4 relative, ``grad_norm`` 1e-3 relative;
the rasterised targets exactly, except at cells whose centre lies within
1e-4 px of an edge crossing (counted); the selections (``gt_of``, the
uncertain points, the detections' validity and labels, the pasted masks'
RLE) exactly.
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

from lsnet_tpu.core import two_stage as jts
from lsnet_tpu.data import coco as j_coco
from lsnet_tpu.data.extra import build_dataset as j_build_dataset
from lsnet_tpu.evalkit import evaluator as jeval
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models.heads import two_stage as jheads
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch.core import two_stage as pts
from lsnet_torch.data import coco as p_coco
from lsnet_torch.evalkit import evaluator as peval
from lsnet_torch.models import build_detector
from lsnet_torch.models.heads import two_stage as pheads
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
JAX_DEVICES = 8
FILES = {"mask": "mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py",
         "ms": "ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py",
         "point_rend": "point_rend/point_rend_r50_caffe_fpn_1x_coco.py"}
LOSS_KEYS = {"mask": ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                      "loss_bbox", "loss_mask")}
LOSS_KEYS["ms"] = LOSS_KEYS["mask"] + ("loss_mask_iou",)
LOSS_KEYS["point_rend"] = LOSS_KEYS["mask"] + ("loss_point",)


def _config(cls, root, name, samples_per_gpu):
    """The narrow copy of a shipped file, read by ``cls``; (path, cfg)."""
    def data(split):
        return dict(ann_file=os.path.join(root, split, "ann.json"),
                    img_prefix=os.path.join(root, split, "imgs"),
                    img_scale=(HW[1], HW[0]))
    cfg = dict(
        _base_=os.path.join(REPO, "configs", FILES[name]),
        model=dict(pretrained=None,
                   backbone=dict(depth=18, frozen_stages=-1),
                   neck=dict(in_channels=[64, 128, 256, 512],
                             out_channels=16),
                   rpn_head=dict(in_channels=16, feat_channels=16),
                   roi_head=dict(
                       bbox_head=dict(num_classes=3, fc_out_channels=32),
                       mask_head=dict(num_classes=3,
                                      conv_out_channels=16))),
        train_cfg=dict(rpn=dict(sampler=dict(num=64)),
                       rpn_proposal=dict(nms_pre=200, max_per_img=32),
                       rcnn=dict(sampler=dict(num=16))),
        test_cfg=dict(rcnn=dict(max_per_img=20, score_thr=0.0)),
        data=dict(samples_per_gpu=samples_per_gpu, train=data("train"),
                  val=data("val"), test=data("val")),
        canvas_shape=HW, max_instances=8, log_interval=1, total_epochs=1,
        checkpoint_config=dict(interval=1),
        lr_config=dict(warmup_iters=2, step=[1]), optimizer=dict(lr=0.01),
        optimizer_config=dict(grad_clip=dict(max_norm=35)))
    path = os.path.join(root, f"{name}_{samples_per_gpu}.py")
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return path, cls.fromfile(path)


def _first_batch(cfg, loader_cls, dataset_fn, config_cls):
    d = cfg.data.train
    ds = dataset_fn(d.type, config_cls(
        ann_file=d.ann_file, img_prefix=d.img_prefix, task="segm",
        num_vectors=36, img_scale=tuple(d.img_scale),
        flip_ratio=d.get("flip_ratio", 0.5), max_instances=8))
    return next(iter(loader_cls(ds, JAX_DEVICES, HW).epoch(0)))


def _with_duplicate_gt(batch):
    """Image 0's second GT box set to its first (its contour and label
    kept)."""
    out = {k: np.array(v) for k, v in batch.items()}
    assert out["gt_valid"][0, :2].all()
    out["gt_bboxes"][0, 1] = out["gt_bboxes"][0, 0]
    return out


def _rois():
    """(24, 5) RoIs of 8 to 300 px a side on images 0 to 7, so every
    level of the first four takes some."""
    rng = np.random.RandomState(1)
    side = np.exp(rng.uniform(np.log(8), np.log(300), (24, 2)))
    xy = rng.uniform(-10, 80, (24, 2))
    b = rng.randint(0, 8, (24, 1))
    return np.concatenate([b, xy, xy + side], 1).astype(np.float32)


def _points(n=24, p=10, seed=2):
    """(n, p, 2) normalised points, a few outside [0, 1]."""
    return np.random.RandomState(seed).uniform(-0.1, 1.1, (n, p, 2)).astype(
        np.float32)


def _params_of(variables, params):
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _mint(model):
    """Minted variables (seed 2), conditioned as the module docstring
    says."""
    v = mint_variables(model, jnp.zeros((1, *HW, 3)), seed=2)
    p = v["params"]
    p["rpn_head"]["rpn_cls"]["kernel"] *= 100
    for layer in p["mask_head"].values():
        layer["bias"] = np.zeros_like(layer["bias"])
    p["mask_head"]["mask_logits"]["kernel"] *= 1e5
    for head in ("maskiou_head", "point_head"):
        for name, layer in p.get(head, {}).items():
            if name.startswith(("maskiou_conv", "fc")) and name != "fc_logits":
                layer["bias"] = layer["bias"] + 1.0
    return v


def _jax_ms(model, cfg, tcfg):
    """MS R-CNN's ``mask_forward`` and ``maskiou_forward`` on fixed RoIs,
    ``mask_rcnn_loss``'s and ``mask_scoring_rcnn_loss``'s terms and
    gradients (one forward: the mask R-CNN part is the total less
    ``loss_mask_iou``), and both decodes."""
    def fn(v, batch, rois):
        feats = model.apply(v, batch["image"], method="extract")
        logits = model.apply(v, feats, rois, method="mask_forward")
        out = {"mask_forward": logits,
               "maskiou_forward": model.apply(v, feats, rois, logits,
                                              method="maskiou_forward")}

        def rows(params):
            total, terms = jts.mask_scoring_rcnn_loss(
                model, _params_of(v, params), batch, cfg)
            return (total - terms["loss_mask_iou"], total), terms
        (mask_total, total), vjp, out["terms"] = jax.vjp(
            rows, v["params"], has_aux=True)
        one = jnp.ones((), mask_total.dtype)
        out["mask"] = (mask_total,) + vjp((one, jnp.zeros_like(one)))
        out["ms"] = (total,) + vjp((jnp.zeros_like(one), one))
        args = (batch["image"], batch["img_shape"], batch["scale_factor"],
                cfg, tcfg)
        out["mask_decode"] = jts.mask_rcnn_decode(model, v, *args)
        out["ms_decode"] = jts.mask_scoring_rcnn_decode(model, v, *args)
        return out
    return jax.jit(fn)


def _jax_point_rend(model, cfg, tcfg):
    """PointRend's ``point_forward`` (fixed RoIs and points, the coarse
    logits of ``mask_forward``), ``point_rend_loss``'s terms and gradient,
    and its decode."""
    def fn(v, batch, rois, points):
        feats = model.apply(v, batch["image"], method="extract")
        logits = model.apply(v, feats, rois, method="mask_forward")
        out = {"point_forward": model.apply(v, feats, rois, points, logits,
                                            method="point_forward")}

        def total(params):
            return jts.point_rend_loss(model, _params_of(v, params), batch,
                                       cfg)
        (loss, out["terms"]), grads = jax.value_and_grad(
            total, has_aux=True)(v["params"])
        out["point_rend"] = (loss, grads)
        out["point_rend_decode"] = jts.point_rend_decode(
            model, v, batch["image"], batch["img_shape"],
            batch["scale_factor"], cfg, tcfg)
        return out
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


def _without_maskiou(v):
    return {"params": {k: x for k, x in v["params"].items()
                       if k != "maskiou_head"},
            "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    """The JAX results on the first batch (with the duplicate GT, and as
    the loader cut it: ``jax_*`` and ``jax_*_plain``; one trace and
    compile each), the port's models, and each file through the port's
    tools.train / tools.test."""
    root = str(tmp_path_factory.mktemp("mask_rcnn"))
    make_shapes_coco(os.path.join(root, "train"), 16, seed=3,
                     hw=[HW, (56, 96)])
    make_shapes_coco(os.path.join(root, "val"), 4, seed=4,
                     hw=[HW, (56, 96)])
    out = {"root": root, "rois": _rois(), "points": _points()}
    _, jcfg = _config(JConfig, root, "ms", 1)
    _, pcfg = _config(Config, root, "ms", JAX_DEVICES)
    jb = _first_batch(jcfg, j_coco.DataLoader, j_build_dataset,
                      j_coco.DatasetConfig)
    pb = _first_batch(pcfg, p_coco.DataLoader, ploop.build_dataset,
                      p_coco.DatasetConfig)
    out["jbatch"], out["batch"] = jb, pb
    out["dup"] = _with_duplicate_gt(pb)
    tscfg = jloop.two_stage_cfg_from(jcfg, HW)
    tcfg = jloop.test_cfg_from(jcfg, HW)
    out["ts"] = ploop.two_stage_cfg_from(pcfg, HW)
    out["test"] = ploop.test_cfg_from(pcfg, HW)
    for name in ("ms", "point_rend"):
        _, jcfg = _config(JConfig, root, name, 1)
        jmodel, _ = j_build(jcfg.model.to_dict())
        v = _mint(jmodel)
        fn = (_jax_ms if name == "ms" else _jax_point_rend)(jmodel, tscfg,
                                                            tcfg)
        extra = (out["rois"],) if name == "ms" else (out["rois"],
                                                      out["points"])
        for key, batch in (("", out["dup"]), ("_plain", jb)):
            out[f"jax_{name}{key}"] = jax.tree.map(np.asarray,
                                                   fn(v, batch, *extra))
        out[name] = {"variables": v}
    out["mask"] = {"variables": _without_maskiou(out["ms"]["variables"])}
    for name in FILES:
        res = out[name]
        ppath, pcfg = _config(Config, root, name, JAX_DEVICES)
        model = build_detector(pcfg.model.to_dict())
        model.load_state_dict(from_jax_variables(res["variables"]),
                              strict=True)
        res["model"] = model
        res.update(_port_run(root, name, ppath, pcfg, res["variables"]))
    return out


def _port_run(root, name, path, cfg, variables):
    """The narrow file through tools.train (from ``variables``, f32 steps)
    and tools.test --eval bbox segm."""
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
                              "--eval", "bbox", "segm", "--device", "cpu"])
    return {"step": res["step"], "seen": seen,
            "train": _log_records(work, "train"),
            "val": _log_records(work, "val"), "metrics": metrics}


def _tbatch(batch):
    return {k: t(v) for k, v in batch.items()}


def _grads(model, total):
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, params)
    return to_jax_variables(model, dict(zip(names, grads)))["params"]


def _jax_loss(slice_, name, plain=False):
    """JAX's (total, gradient tree, terms) of a file's loss (Mask R-CNN's
    less ``maskiou_head``'s zero gradient and ``loss_mask_iou``), on the
    batch with the duplicate GT or on the plain one."""
    suffix = "_plain" if plain else ""
    if name == "point_rend":
        jres = slice_["jax_point_rend" + suffix]
        return (*jres["point_rend"], dict(jres["terms"]))
    jres = slice_["jax_ms" + suffix]
    total, (grads,) = jres[name][0], jres[name][1:]
    terms = dict(jres["terms"])
    if name == "mask":
        grads = {k: g for k, g in grads.items() if k != "maskiou_head"}
        terms.pop("loss_mask_iou")
    return total, grads, terms


# ------------------------------------------------------------ the bridge

class _Upsample(torch.nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.mask_upsample = torch.nn.ConvTranspose2d(cin, cout, 2, stride=2)


def test_conv_transpose_bridge_both_ways():
    """flax's ``nn.ConvTranspose`` (2x2, stride 2, the default
    ``transpose_kernel=False``) against ``nn.ConvTranspose2d`` from the
    same random (not symmetric) kernel through ``from_jax_variables``:
    1e-4 of max(1, max|ref|); the kernel laid out without the flip
    differs by far more; ``to_jax_variables`` gives the flax kernel back
    exactly."""
    import flax.linen as fnn

    class Up(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.ConvTranspose(6, (2, 2), strides=(2, 2),
                                     name="mask_upsample")(x)
    x = np.random.RandomState(0).randn(2, 5, 7, 4).astype(np.float32)
    v = mint_variables(Up(), jnp.asarray(x), seed=3)
    v["params"]["mask_upsample"]["kernel"] = np.random.RandomState(
        4).randn(2, 2, 4, 6).astype(np.float32)
    want = np.asarray(Up().apply(v, x))
    mod = _Upsample(4, 6)
    mod.load_state_dict(from_jax_variables({"params": v["params"]}),
                        strict=True)
    with torch.no_grad():
        got = mod.mask_upsample(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got, want)
    k = v["params"]["mask_upsample"]["kernel"]
    with torch.no_grad():
        mod.mask_upsample.weight.copy_(t(k).permute(2, 3, 0, 1))
        unflipped = mod.mask_upsample(t(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    assert np.abs(unflipped.numpy() - want).max() > 0.5
    mod.load_state_dict(from_jax_variables({"params": v["params"]}))
    back = to_jax_variables(mod)["params"]["mask_upsample"]
    np.testing.assert_array_equal(back["kernel"], k)
    np.testing.assert_array_equal(back["bias"],
                                  v["params"]["mask_upsample"]["bias"])


# -------------------------------------------------------------- the heads

def _mask_pred_with_ties(n, c, seed):
    """(n, 28, 28, c) logits whose class max is constant over 2x2 blocks
    in a quarter of the map (ties in the MaskIoU head's max pool)."""
    x = np.random.RandomState(seed).randn(n, 28, 28, c).astype(np.float32)
    x[:, :14, :14] = 0.25
    return x


HEAD_CASES = {
    "fcn_mask": lambda: (
        jheads.FCNMaskHead(num_classes=3, conv_channels=8, num_convs=2),
        pheads.FCNMaskHead(3, in_channels=5, conv_channels=8, num_convs=2),
        [(6, 14, 14, 5)]),
    "maskiou": lambda: (
        jheads.MaskIoUHead(num_classes=3, conv_channels=8, fc_channels=16),
        pheads.MaskIoUHead(3, in_channels=5, conv_channels=8,
                           fc_channels=16),
        [(6, 14, 14, 5), "mask_pred"]),
    "mask_point": lambda: (
        jheads.MaskPointHead(num_classes=3, num_fcs=2, fc_channels=8),
        pheads.MaskPointHead(3, in_channels=5, num_fcs=2, fc_channels=8),
        [(6, 10, 5), (6, 10, 3)]),
}


@pytest.mark.parametrize("name", sorted(HEAD_CASES))
def test_mask_heads_match_jax(name):
    """``FCNMaskHead``, ``MaskIoUHead`` (a mask prediction with ties in its
    max pool's windows) and ``MaskPointHead`` from the same minted
    variables: the output and the gradients of sum(out * probe) with
    respect to every parameter and input, 1e-4 of max(1, max|ref|)."""
    jhead, phead, shapes = HEAD_CASES[name]()
    rng = np.random.RandomState(5)
    xs = [_mask_pred_with_ties(6, 3, 6) if s == "mask_pred"
          else rng.randn(*s).astype(np.float32) for s in shapes]
    v = mint_variables(jhead, *[jnp.asarray(x) for x in xs], seed=7)
    want_out = jhead.apply(v, *xs)
    probe = rng.randn(*want_out.shape).astype(np.float32)

    def jf(params, *ins):
        return jnp.sum(jhead.apply({"params": params}, *ins) * probe)
    gp, *gx = jax.jit(jax.grad(jf, argnums=tuple(range(1 + len(xs)))))(
        v["params"], *xs)
    phead.load_state_dict(from_jax_variables(v), strict=True)
    tx = [t(x).requires_grad_() for x in xs]
    got = phead(*tx)
    assert_close(got, want_out)
    names = [n for n, _ in phead.named_parameters()]
    grads = torch.autograd.grad((got * t(probe)).sum(),
                                list(phead.parameters()) + tx)
    grads_close(to_jax_variables(phead, dict(zip(names, grads)))["params"],
                gp, rel=1e-4, abs_=1e-6)
    for g, w_ in zip(grads[len(names):], gx):
        assert_close(g, w_)


def test_point_sample_matches_jax():
    """``point_sample`` on a map with points inside and outside [0, 1]
    (the corners clamped into the map): the samples and the map's
    gradient, 1e-4 of max(1, max|ref|)."""
    rng = np.random.RandomState(8)
    feat = rng.randn(24, 9, 11, 4).astype(np.float32)
    pts_ = _points()
    probe = rng.randn(24, 10, 4).astype(np.float32)
    want, gw = jax.jit(lambda f: (jheads.point_sample(f, pts_), jax.grad(
        lambda x: jnp.sum(jheads.point_sample(x, pts_) * probe))(f)))(feat)
    tf = t(feat).requires_grad_()
    got = pheads.point_sample(tf, t(pts_))
    assert_close(got, want)
    (got * t(probe)).sum().backward()
    assert_close(tf.grad, gw)


@pytest.mark.parametrize("name,key", [("ms", "mask_forward"),
                                      ("ms", "maskiou_forward"),
                                      ("point_rend", "point_forward")])
def test_mask_methods_match_jax(slice_, name, key):
    """``mask_forward`` (the 14x14 RoIAlign of every level and the mask
    head), ``maskiou_forward`` and ``point_forward`` (P2's rows gathered by
    each RoI's image, the coarse logits sampled at the points) on fixed
    RoIs and points from the same variables: 1e-4 of max(1, max|ref|)."""
    model = slice_[name]["model"]
    rois = t(slice_["rois"])
    with torch.no_grad():
        feats = model.extract(t(slice_["dup"]["image"]))
        logits = model.mask_forward(feats, rois)
        got = {"mask_forward": lambda: logits,
               "maskiou_forward": lambda: model.maskiou_forward(
                   feats, rois, logits),
               "point_forward": lambda: model.point_forward(
                   feats, rois, t(slice_["points"]), logits)}[key]()
    want = slice_[f"jax_{name}"][key]
    assert_close(got, want)


# ------------------------------------------------------------- the targets

def _polygons(n, nv=36, seed=9):
    """n closed 36-point contours: stars of random radii around centres
    in a 60x60 frame, a few vertices on whole pixel rows, one horizontal
    edge each, and one padded all-zero contour."""
    rng = np.random.RandomState(seed)
    ang = np.arange(nv) * 2 * np.pi / nv
    c = rng.uniform(10, 50, (n, 1, 2))
    r = rng.uniform(4, 20, (n, nv, 1)) * (1 + 0.3 * np.sin(3 * ang))[:, None]
    xy = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
    xy[:, 5, 1] = np.round(xy[:, 5, 1])
    xy[:, 6, 1] = xy[:, 5, 1]                    # a horizontal edge
    xy[-1] = 0.0
    return xy.reshape(n, nv * 2).astype(np.float32)


def _target_rois(n, seed=10):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-5, 40, (n, 2))
    return np.concatenate([x1, x1 + rng.uniform(5, 40, (n, 2))],
                          1).astype(np.float32)


def _near_edge_cells(polys, rois, size, eps=1e-4):
    """Cells whose centre lies within ``eps`` px of an edge crossing of
    its row (f64): the cells a rounding of ``x1 + t (x2 - x1)`` can flip."""
    p = polys.astype(np.float64).reshape(len(polys), -1, 2)
    r = rois.astype(np.float64)
    frac = (np.arange(size) + 0.5) / size
    w = np.maximum(r[:, 2] - r[:, 0], 1e-3)
    h = np.maximum(r[:, 3] - r[:, 1], 1e-3)
    gx = r[:, 0, None] + frac * w[:, None]
    gy = r[:, 1, None] + frac * h[:, None]
    x1, y1 = p[..., 0][:, None], p[..., 1][:, None]
    x2, y2 = np.roll(x1, -1, -1), np.roll(y1, -1, -1)
    gyb = gy[:, :, None]
    cond = (y1 <= gyb) != (y2 <= gyb)
    dy = np.where(np.abs(y2 - y1) < 1e-9, 1e-9, y2 - y1)
    xint = x1 + (gyb - y1) / dy * (x2 - x1)                # (n, size, nv)
    near = cond[:, :, None, :] & (np.abs(
        xint[:, :, None, :] - gx[:, None, :, None]) < eps)
    return near.any(-1)


@pytest.mark.parametrize("size", [28, 56])
def test_rasterize_polygon_in_roi_matches_jax(size):
    """``rasterize_polygon_in_roi`` at 28 (the mask targets) and 56
    (PointRend's) on 40 star contours (vertices on whole rows, horizontal
    edges, a padded all-zero contour) in RoIs partly outside them: equal
    to JAX's cell for cell, except at cells within 1e-4 px of an edge
    crossing (counted; a fused multiply-add may round them either way);
    no NaN, the padded contour all zeros."""
    polys, rois = _polygons(40), _target_rois(40)
    want = np.asarray(jax.jit(functools.partial(
        jts.rasterize_polygon_in_roi, out_size=size))(polys, rois))
    got = pts.rasterize_polygon_in_roi(t(polys), t(rois), size).numpy()
    assert np.isfinite(got).all() and got[-1].sum() == 0
    near = _near_edge_cells(polys, rois, size)
    assert not ((got != want) & ~near).any()
    assert int(((got != want) & near).sum()) <= int(near.sum())
    assert 0.05 < want.mean() < 0.95


def _mask_inputs(seed=11):
    """12 RoIs' mask logits (3 classes), labels with background (3),
    positives, GT contours and each RoI's GT (-1 where none, and padded
    all-zero contours)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(12, 28, 28, 3).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 1, 0, 3, 2, 2, 1, 0, 3], np.int32)
    pos = labels < 3
    pos[4] = False
    polys = _polygons(6)
    gt_idx = np.array([0, 1, 2, -1, 3, 4, -1, 5, 0, 1, 5, 2], np.int32)
    return logits, _target_rois(12), labels, pos, polys, gt_idx


def test_mask_loss_and_iou_targets_match_jax():
    """``mask_loss`` (and its gradient) and ``mask_iou_targets`` on 12 RoIs
    with background labels, a negative, -1 GT indices and a padded
    contour: 1e-5 relative; finite."""
    logits, rois, labels, pos, polys, gt_idx = _mask_inputs()
    cfg = dict(image_shape=HW, num_classes=3)
    def jf(lg, *rest):
        return (jax.value_and_grad(lambda x: jts.mask_loss(
            x, *rest, jts.TwoStageConfig(**cfg)))(lg),
            jts.mask_iou_targets(lg, rest[0], rest[1], *rest[3:]))
    (want, gw), want_iou = jax.jit(jf)(logits, rois, labels, pos, polys,
                                       gt_idx)
    tl = t(logits).requires_grad_()
    got = pts.mask_loss(tl, t(rois), t(labels), t(pos), t(polys),
                        t(gt_idx), pts.TwoStageConfig(**cfg))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert_close(tl.grad, gw, rel=1e-5)
    iou = pts.mask_iou_targets(t(logits), t(rois), t(labels), t(polys),
                               t(gt_idx))
    assert_close(iou, want_iou, rel=1e-5)
    assert np.isfinite(iou.numpy()).all() and 0 < float(want_iou.max()) <= 1


def test_uncertain_points_break_ties_as_jax():
    """``_uncertain_points`` on maps with exact ties (whole constant
    regions, values of equal magnitude and opposite sign): the same points
    as ``lax.top_k``'s, in the same order."""
    rng = np.random.RandomState(12)
    m = np.round(rng.randn(5, 28, 28) * 4).astype(np.float32) / 4
    m[1] = 0.5
    m[2, ::2] *= -1
    want = np.asarray(jax.jit(lambda x: jts._uncertain_points(x, 196))(m))
    got = pts._uncertain_points(t(m), 196).numpy()
    np.testing.assert_array_equal(got, want)


def test_gt_of_gives_a_tie_to_the_first_gt():
    """Two identical GT boxes and a padded slot: each RoI's GT is the
    first of equal IoUs, as JAX's ``argmax``."""
    gts = np.array([[[4, 4, 30, 30], [4, 4, 30, 30], [40, 10, 60, 40],
                     [0, 0, 0, 0]]], np.float32)
    gvalid = np.array([[True, True, True, False]])
    rois = np.array([[[4, 4, 30, 30], [5, 4, 31, 30], [42, 12, 60, 40],
                      [70, 70, 80, 80]]], np.float32)

    def jgt(r, g, v):
        ious = jts.box_iou(r, g)
        return jnp.where(v[None, :], ious, -1.0).argmax(axis=1)
    want = np.asarray(jax.vmap(jgt)(rois, gts, gvalid))
    got = pts._gt_of(t(rois), t(gts), t(gvalid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == got[0, 1] == 0


# -------------------------------------------------------------- the losses

@pytest.mark.parametrize("name", sorted(FILES))
def test_mask_losses_and_gradients_match_jax(slice_, name):
    """``mask_rcnn_loss``, ``mask_scoring_rcnn_loss`` and
    ``point_rend_loss`` from each package's own maps, proposals, samples,
    GT assignment (a duplicate GT box, padded GT slots) and, for
    PointRend, uncertain points: every term 1e-4 relative, every
    parameter's gradient (``grads_close``)."""
    model = slice_[name]["model"]
    want_total, want_grads, want_terms = _jax_loss(slice_, name)
    fn = {"mask": pts.mask_rcnn_loss, "ms": pts.mask_scoring_rcnn_loss,
          "point_rend": pts.point_rend_loss}[name]
    total, terms = fn(model, _tbatch(slice_["dup"]), slice_["ts"])
    assert sorted(terms) == sorted(LOSS_KEYS[name]) == sorted(want_terms)
    for k, v in terms.items():
        assert abs(v.item() - want_terms[k]) <= 1e-4 * max(
            1.0, abs(want_terms[k])), (k, v.item(), want_terms[k])
    assert abs(total.item() - want_total) <= 1e-4 * abs(want_total)
    assert terms["loss_mask"].item() > 0
    grads_close(_grads(model, total), want_grads, rel=1e-4, abs_=1e-6)


# ------------------------------------------------------------- the decodes

def _same_detections(got, want):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  want.labels[valid])
    mask = torch.from_numpy(valid.copy())
    assert_close(got.bboxes[mask], want.bboxes[valid])
    assert_close(got.scores[mask], want.scores[valid])
    return mask, valid


def _boundary_gaps(model, b, ts, tc):
    """Each detection's smallest gap, over both subdivision steps, between
    the 784th and 785th uncertainty of its upsampled map, over its largest
    coarse |logit| (the port's own maps, which are JAX's to ~1e-6 of
    that)."""
    with torch.no_grad():
        feats = model.extract(b["image"], pts.INFERENCE_SAMPLING)
        det = pts.two_stage_decode(model, b["image"], b["img_shape"],
                                   b["scale_factor"], ts, tc)
        mo = pts.mask_outputs(model, feats, det, b["scale_factor"])
        cur = mo.sel
        scale = cur.abs().amax(dim=(1, 2)).clamp(min=1e-30)
        gaps = []
        for _ in range(2):
            up = pts.resize_bilinear_2x(cur).reshape(len(cur), -1)
            unc = torch.sort(-up.abs(), dim=1, descending=True).values
            gaps.append((unc[:, 783] - unc[:, 784]) / scale)
            cur = pts.point_rend_subdivide(model, feats, mo.rois, mo.logits,
                                           det.labels.reshape(-1), cur, 784)
    return torch.minimum(*gaps).reshape(det.labels.shape).numpy()


@pytest.mark.parametrize("name,key", [("mask", "mask_decode"),
                                      ("ms", "ms_decode"),
                                      ("point_rend", "point_rend_decode")])
def test_mask_decodes_match_jax(slice_, name, key):
    """``mask_rcnn_decode``, ``mask_scoring_rcnn_decode`` (scores times
    the predicted mask IoU) and ``point_rend_decode`` (two subdivision
    steps of 784 points, the 2x upsampling as ``jax.image.resize``'s) from
    each package's own maps: the detections' validity and labels exactly,
    boxes and scores 1e-4 of max(1, max|ref|), the valid detections' mask
    probabilities (28 x 28, 112 x 112) 1e-4. PointRend's masks are held
    where the uncertain points are a selection: at the detections whose
    784th and 785th uncertainties lie more than 4e-6 of the largest coarse
    |logit| apart at both steps (rounding moves a logit by up to ~1e-6 of
    it); the others, where the two packages may pick another of two
    near-equal cells, are counted and must be under a fifth."""
    model = slice_[name]["model"]
    b = _tbatch(slice_["dup"])
    fn = {"mask": pts.mask_rcnn_decode, "ms": pts.mask_scoring_rcnn_decode,
          "point_rend": pts.point_rend_decode}[name]
    with torch.no_grad():
        det, masks = fn(model, b["image"], b["img_shape"], b["scale_factor"],
                        slice_["ts"], slice_["test"])
    jres = slice_["jax_point_rend" if name == "point_rend" else "jax_ms"]
    want_det, want_masks = jres[key]
    want_det = jts.Detections(*want_det)
    mask, valid = _same_detections(det, want_det)
    side = 112 if name == "point_rend" else 28
    assert masks.shape == (*det.bboxes.shape[:2], side, side)
    if name == "point_rend":
        strict = _boundary_gaps(model, b, slice_["ts"], slice_["test"]) > 4e-6
        assert (valid & ~strict).sum() <= valid.sum() / 5
        valid = valid & strict
        mask = torch.from_numpy(valid)
    assert_close(masks[mask], want_masks[valid])


def test_resize_bilinear_2x_equals_jax():
    """``resize_bilinear_2x`` against ``jax.image.resize(..., "bilinear")``
    at 28 -> 56 (equal bit for bit on the CPU) and 56 -> 112 (1e-6 of
    max(1, max|ref|): the two matrix products sum in other blocks)."""
    x = np.random.RandomState(13).randn(7, 28, 28).astype(np.float32)
    for step in range(2):
        want = np.asarray(jax.jit(lambda a: jax.image.resize(
            a, (a.shape[0], a.shape[1] * 2, a.shape[2] * 2),
            "bilinear"))(x))
        got = pts.resize_bilinear_2x(t(x)).numpy()
        if step == 0:
            np.testing.assert_array_equal(got, want)
        assert_close(got, want, rel=1e-6)
        x = want


def test_paste_and_coco_results_match_jax():
    """``paste_mask`` and ``mask_detections_to_coco`` against the JAX
    evaluator's on the same detections (boxes partly outside the image,
    a sub-pixel box, an invalid slot; 28 x 28 and 112 x 112 crops): the
    same pasted masks and the same COCO results, RLE strings included."""
    rng = np.random.RandomState(14)
    boxes = np.array([[[5, 6, 40, 30], [-8, 10, 20, 70], [50, 40, 110, 66],
                       [10, 10, 10.4, 10.3]],
                      [[0, 0, 95, 63], [30, 5, 60, 25], [0, 0, 1, 1],
                       [2, 2, 9, 9]]], np.float32)
    valid = np.array([[True, True, True, True], [True, True, False, True]])
    det = jts.Detections(boxes, rng.rand(2, 4).astype(np.float32),
                         np.array([[0, 1, 2, 0], [2, 2, 1, 0]], np.int32),
                         np.zeros((2, 4, 8), np.float32), valid)
    sizes = {3: (64, 96), 8: (56, 96)}
    cats = {0: 1, 1: 2, 2: 3}
    for side in (28, 112):
        masks = rng.rand(2, 4, side, side).astype(np.float32)
        for b in range(2):
            for k in range(4):
                np.testing.assert_array_equal(
                    peval.paste_mask(masks[b, k], boxes[b, k], (64, 96)),
                    jeval.paste_mask(masks[b, k], boxes[b, k], (64, 96)))
        got = peval.mask_detections_to_coco(
            pts.Detections(*(t(x) for x in det)), t(masks), [3, 8], cats,
            sizes)
        want = jeval.mask_detections_to_coco(det, masks, [3, 8], cats, sizes)
        assert len(got) == len(want) == 7
        assert got == want


# -------------------------------------------------------- the training init

# the mask heads' flax initializers by leaf: the std of each distribution
# (LeCun normal: 1 / sqrt(fan_in))
MASK_STD = {"mask_conv0": 0.01, "mask_conv1": 0.01, "mask_logits": 0.001,
            "maskiou_conv0": 0.01, "maskiou_conv1": 0.01,
            "maskiou_conv2": 0.01, "maskiou_conv3": 0.01}


@pytest.mark.parametrize("name", ["ms", "point_rend"])
def test_mask_heads_training_init_matches_the_jax_initializers(name):
    """``init_weights_`` of the mask, MaskIoU and point heads against the
    JAX heads' initializers (``eval_shape`` for the names and shapes):
    every bias 0; ``mask_conv*`` and ``maskiou_conv*`` N(0, 0.01),
    ``mask_logits`` N(0, 0.001), ``mask_upsample`` and every FC LeCun
    normal (fan_in), each kernel's spread within 15 %."""
    from lsnet_torch.models.init import init_weights_
    model = build_detector(dict(
        type={"ms": "MaskScoringRCNN", "point_rend": "PointRend"}[name],
        backbone=dict(type="ResNet", depth=18),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                  out_channels=32, num_outs=5),
        rpn_head=dict(type="RPNHead", in_channels=32, feat_channels=32),
        roi_head=dict(bbox_head=dict(num_classes=3, fc_out_channels=32),
                      mask_head=dict(num_convs=2, conv_out_channels=64))))
    init_weights_(model, torch.Generator().manual_seed(0))
    got = to_jax_variables(model)["params"]
    heads = [("mask_head", jheads.FCNMaskHead(3, conv_channels=64,
                                              num_convs=2),
              [jnp.zeros((2, 14, 14, 32))])]
    if name == "ms":
        heads.append(("maskiou_head", jheads.MaskIoUHead(3),
                      [jnp.zeros((2, 14, 14, 32)),
                       jnp.zeros((2, 28, 28, 3))]))
    else:
        heads.append(("point_head", jheads.MaskPointHead(3),
                      [jnp.zeros((2, 9, 32)), jnp.zeros((2, 9, 3))]))
    for key, head, args in heads:
        shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0),
                                                  *args))["params"]
        flat_w = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got[key])[0])
        assert flat_g.keys() == flat_w.keys()
        for path, w_ in flat_w.items():
            name_ = jax.tree_util.keystr(path)
            g = flat_g[path]
            assert g.shape == w_.shape, name_
            if path[-1].key == "bias":
                np.testing.assert_array_equal(g, np.zeros(w_.shape))
                continue
            std = MASK_STD.get(path[0].key,
                               1.0 / np.sqrt(np.prod(w_.shape[:-1])))
            assert abs(g.std() / std - 1) < 0.15, name_


# --------------------------------------------------------------- the files

def test_both_loaders_cut_the_same_segm_batch(slice_):
    """The JAX loader's first batch of the segm pipeline (36-point
    contours) and the port's, which each runner's first step took; padded
    GT slots in it."""
    jb, pb = slice_["jbatch"], slice_["batch"]
    assert jb.keys() == pb.keys() and "gt_polygons" in pb
    assert pb["gt_polygons"].shape[-1] == 72
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    for name in FILES:
        first = slice_[name]["seen"][0]
        for k in pb:
            np.testing.assert_array_equal(first[k], pb[k], err_msg=k)
    assert (~pb["gt_valid"]).any()


@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_trains_and_scores_segm(slice_, name):
    """The port's tools.train (2 steps, the EvalHook) and ``tools.test
    --eval bbox segm`` on each narrow file: the loss terms finite and
    logged, the 12 ``bbox_*`` and the 12 ``segm_*`` metrics of tools.test
    equal to the EvalHook's on the step-2 checkpoint (1e-5: the log
    rounds to 5 decimals)."""
    res = slice_[name]
    assert res["step"] == 2 and len(res["seen"]) == 2
    recs = res["train"]
    assert [(r["epoch"], r["iter"]) for r in recs] == [(1, 1), (1, 2)]
    for r in recs:
        assert set(LOSS_KEYS[name]) | {"loss", "grad_norm"} <= r.keys()
        assert all(np.isfinite(v) for k, v in r.items()
                   if k.startswith("loss"))
    metrics = res["metrics"]
    assert len(metrics) == 24
    assert {k.split("_")[0] for k in metrics} == {"bbox", "segm"}
    hook = {k: v for k, v in res["val"][-1].items()
            if k not in ("mode", "epoch")}
    assert hook.keys() == metrics.keys()
    for k, v in metrics.items():
        assert abs(v - hook[k]) <= 1e-5, k


@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_first_step_matches_jax(slice_, name):
    """The port runner's first logged step against JAX's loss and
    gradient on the same (plain) batch from the same variables: each loss
    1e-4 relative, ``grad_norm`` 1e-3 relative."""
    total, grads, terms = _jax_loss(slice_, name, plain=True)
    got = slice_[name]["train"][0]
    want = {k: float(v) for k, v in terms.items()}
    want["loss"] = float(total)
    for k, w_ in want.items():
        assert abs(got[k] - w_) <= 1e-4 * max(1.0, abs(w_)), (k, got[k], w_)
    gn = _global_norm(grads)
    assert abs(got["grad_norm"] - gn) <= 1e-3 * gn, (got["grad_norm"], gn)


@pytest.mark.parametrize("name", sorted(FILES))
def test_jax_runner_raises_on_the_files(slice_, name, tmp_path):
    """ROADMAP Queue 3: the JAX runner raises ``AttributeError`` on the
    shipped files' ``grad_clip=None`` (the narrow copy with it put back);
    the port clips at 35 and runs them
    (``test_runner_trains_and_scores_segm``)."""
    import flax.linen as fnn
    _, jcfg = _config(JConfig, slice_["root"], name, 1)
    jcfg.merge_from_dict({"optimizer_config.grad_clip": None})
    v = slice_[name]["variables"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init",
                   lambda self, *a, **k: jax.tree.map(jnp.asarray, v))
        with pytest.raises(AttributeError):
            jloop.train_detector(jcfg, str(tmp_path), eval_interval=100)


@pytest.mark.parametrize("name", sorted(FILES))
def test_inference_detector_returns_masks(slice_, name):
    """``apis.init_detector`` on each narrow file and ``inference_detector``
    on a val image (the minted weights loaded): ``masks`` beside the boxes,
    one (28, 28) crop of probabilities a detection (112 x 112 for
    PointRend), as the JAX API returns them, equal to the valid slots of
    ``apis.detect``'s masks on the same padded image."""
    from PIL import Image
    from lsnet_torch import apis
    path, cfg = _config(Config, slice_["root"], name, JAX_DEVICES)
    bundle = apis.init_detector(path, device="cpu")
    bundle.model.load_state_dict(slice_[name]["model"].state_dict())
    img = os.path.join(slice_["root"], "val", "imgs", "0000.png")
    res = apis.inference_detector(bundle, img)
    side = 112 if name == "point_rend" else 28
    n = len(res["scores"])
    assert n > 0 and res["masks"].shape == (n, side, side)
    assert 0.0 <= res["masks"].min() <= res["masks"].max() <= 1.0
    det, masks = apis._dispatch(bundle, np.asarray(Image.open(img)))
    np.testing.assert_array_equal(res["masks"],
                                  masks[0][det.valid[0]].numpy())
