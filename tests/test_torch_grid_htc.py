"""Grid R-CNN and HTC (Hybrid Task Cascade) of the port against the JAX
package, on the CPU, in f32.

One narrow copy of each shipped file (R18, FPN 16, 32-wide FCs, 3
classes, ``frozen_stages=-1`` so that ``grad_norm`` counts the same
tensors; Grid R-CNN's grid head 2 convs of 9 x 8 channels; HTC's mask
heads 16 wide, as its information flow adds them to the 16-wide RoI
features, and its semantic head at the neck's width; the RPN samples 64
anchors, 200 candidates give 32 proposals, 16 RoIs a image, 20
detections) on 16 procedural images (64x96 and 56x96 on the 64x96
canvas; HTC on the segm pipeline's 36-point contours). The JAX detectors'
variables are minted with numpy (``mint_variables``) and carried to the
port by ``weights.from_jax_variables``, conditioned so that no selection
turns on f32 rounding:

* the RPN's objectness kernel x 100 (as in
  ``tests/test_torch_mask_rcnn.py``);
* HTC's stages' ``fc_cls`` kernels x 100 (as in
  ``tests/test_torch_cascade.py``: the decode's mean scores would lie
  within 1e-7 of each other and rounding would order the NMS);
* Grid R-CNN's ``fc_cls`` kernel x 100, and its ``deconv2_g*`` kernels
  x 300: otherwise a heatmap's 784 logits lie within 0.1 of each other,
  and most detections (160 of 160 on the batch) have a point whose two
  hottest cells lie within 1e-5 of each other; now the logits span about
  +-5 (no sigmoid reaches 1) and no two hottest cells lie that close
  (the vote's test counts them).

Each JAX detector computes its heads on fixed RoIs, its loss's terms and
gradient and its decode in ONE jitted function, in a module-scoped
fixture; HTC's runs on the loader's first batch with image 0's second GT
box set to its first (a tie that ``gt_of``'s argmax gives to the first
GT) and on the plain batch.

The slice as a whole: each narrow file through the port's ``tools.train``
(2 steps of 8 images, the EvalHook) and ``tools.test`` (HTC: ``--eval bbox
segm``), resuming from the minted variables as ``step_0.pt``, f32 steps;
its first step's losses and ``grad_norm`` against the JAX loss and
gradient on the same batch (the JAX runner raises on both shipped files:
``grad_clip=None``, ROADMAP Queue 3).

Tolerances: tensors 1e-4 of max(1, max|ref|) (``assert_close``);
gradients 1e-4 of each tensor's largest entry, floored at 1e-6
(``grads_close``); losses 1e-4 relative, ``grad_norm`` 1e-3 relative;
grid targets exactly, except where a point lies within 1e-4 of a cell's
edge (counted); semantic targets exactly; the detections' validity and
labels exactly.
"""

import functools
import glob
import json
import os
import re

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
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch.core import two_stage as pts
from lsnet_torch.data import coco as p_coco
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
FILES = {"grid": "grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py",
         "htc": "htc/htc_r50_fpn_1x_coco.py"}
TASK = {"grid": "bbox", "htc": "segm"}
RPN_KEYS = ("loss_rpn_cls", "loss_rpn_bbox")
LOSS_KEYS = {"grid": RPN_KEYS + ("loss_cls", "loss_bbox", "loss_grid"),
             "htc": RPN_KEYS + tuple(
                 f"s{s}.{k}" for s in range(3)
                 for k in ("loss_cls", "loss_bbox", "loss_mask"))
             + ("loss_semantic_seg",)}


def _config(cls, root, name, samples_per_gpu):
    """The narrow copy of a shipped file, read by ``cls``; (path, cfg)."""
    def data(split):
        return dict(ann_file=os.path.join(root, split, "ann.json"),
                    img_prefix=os.path.join(root, split, "imgs"),
                    img_scale=(HW[1], HW[0]))
    roi = dict(bbox_head=dict(num_classes=3, fc_out_channels=32))
    if name == "grid":
        roi["grid_head"] = dict(num_convs=2, point_feat_channels=8)
    else:
        roi["mask_head"] = dict(num_classes=3, conv_out_channels=16)
    cfg = dict(
        _base_=os.path.join(REPO, "configs", FILES[name]),
        model=dict(pretrained=None,
                   backbone=dict(depth=18, frozen_stages=-1),
                   neck=dict(in_channels=[64, 128, 256, 512],
                             out_channels=16),
                   rpn_head=dict(in_channels=16, feat_channels=16),
                   roi_head=roi),
        train_cfg=dict(rpn=dict(sampler=dict(num=64)),
                       rpn_proposal=dict(nms_pre=200, max_per_img=32),
                       rcnn=dict(sampler=dict(num=16))),
        test_cfg=dict(rcnn=dict(max_per_img=20)),
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


def _first_batch(cfg, task, loader_cls, dataset_fn, config_cls):
    d = cfg.data.train
    ds = dataset_fn(d.type, config_cls(
        ann_file=d.ann_file, img_prefix=d.img_prefix, task=task,
        num_vectors=36 if task == "segm" else 4,
        img_scale=tuple(d.img_scale), flip_ratio=d.get("flip_ratio", 0.5),
        max_instances=8))
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


def _params_of(variables, params):
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _mint(model):
    """Minted variables (seed 2), conditioned as the module docstring
    says."""
    v = mint_variables(model, jnp.zeros((1, *HW, 3)), seed=2)
    p = v["params"]
    p["rpn_head"]["rpn_cls"]["kernel"] *= 100
    for head in ("bbox_head", "bbox_head2", "bbox_head3"):
        if head in p:
            p[head]["fc_cls"]["kernel"] *= 100
    for k, layer in p.get("grid_head", {}).items():
        if k.startswith("deconv2_g"):
            layer["kernel"] = layer["kernel"] * 300
    return v


def _jax_grid(model, cfg, tcfg):
    """``grid_forward`` on fixed RoIs, ``grid_rcnn_loss``'s terms and
    gradient, and ``grid_rcnn_decode`` with its detections before the
    vote, in one function."""
    def fn(v, batch, rois):
        feats = model.apply(v, batch["image"], method="extract")
        out = {"grid_forward": model.apply(v, feats, rois,
                                           method="grid_forward")}

        def total(params):
            return jts.grid_rcnn_loss(model, _params_of(v, params), batch,
                                      cfg)
        (loss, out["terms"]), grads = jax.value_and_grad(
            total, has_aux=True)(v["params"])
        out["loss"] = (loss, grads)
        args = (batch["image"], batch["img_shape"], batch["scale_factor"],
                cfg, tcfg)
        out["decode"] = jts.grid_rcnn_decode(model, v, *args)
        out["unvoted"] = jts.two_stage_decode(model, v, *args,
                                              rescale=False)
        return out
    return jax.jit(fn)


def _jax_htc(model, cfg, tcfg):
    """HTC's semantic head, its three bbox stages and mask stages (each
    after the one before's features) on fixed RoIs, ``htc_loss``'s terms
    and gradient, and ``htc_decode``, in one function."""
    def fn(v, batch, rois):
        feats = model.apply(v, batch["image"], method="extract")
        sem_logits, sem_feat = model.apply(v, feats, method="semantic")
        out = {"semantic": (sem_logits, sem_feat)}
        last = None
        for s in range(3):
            out[f"stage{s}"] = model.apply(v, feats, rois, s, sem_feat,
                                           method="roi_forward_stage")
            m, last = model.apply(v, feats, rois, s, sem_feat, last,
                                  method="mask_forward_stage")
            out[f"mask{s}"] = (m, last)

        def total(params):
            return jts.htc_loss(model, _params_of(v, params), batch, cfg)
        (loss, out["terms"]), grads = jax.value_and_grad(
            total, has_aux=True)(v["params"])
        out["loss"] = (loss, grads)
        out["decode"] = jts.htc_decode(
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


@pytest.fixture(scope="module")
def slice_(tmp_path_factory):
    """The JAX results (one trace and compile a detector; HTC's on the
    batch with the duplicate GT and on the plain one), the port's models,
    and each file through the port's tools.train / tools.test."""
    root = str(tmp_path_factory.mktemp("grid_htc"))
    make_shapes_coco(os.path.join(root, "train"), 16, seed=3,
                     hw=[HW, (56, 96)])
    make_shapes_coco(os.path.join(root, "val"), 4, seed=4,
                     hw=[HW, (56, 96)])
    out = {"root": root, "rois": _rois()}
    for name in FILES:
        res = out[name] = {}
        ppath, pcfg = _config(Config, root, name, JAX_DEVICES)
        _, jcfg = _config(JConfig, root, name, 1)
        jb = _first_batch(jcfg, TASK[name], j_coco.DataLoader,
                          j_build_dataset, j_coco.DatasetConfig)
        pb = _first_batch(pcfg, TASK[name], p_coco.DataLoader,
                          ploop.build_dataset, p_coco.DatasetConfig)
        res["jbatch"], res["batch"] = jb, pb
        tscfg = jloop.two_stage_cfg_from(jcfg, HW)
        tcfg = jloop.test_cfg_from(jcfg, HW)
        res["ts"] = ploop.two_stage_cfg_from(pcfg, HW)
        res["test"] = ploop.test_cfg_from(pcfg, HW)
        jmodel, _ = j_build(jcfg.model.to_dict())
        v = _mint(jmodel)
        res["variables"] = v
        fn = (_jax_grid if name == "grid" else _jax_htc)(jmodel, tscfg,
                                                         tcfg)
        res["jax_plain"] = jax.tree.map(np.asarray, fn(v, jb, out["rois"]))
        res["loss_batch"] = jb
        if name == "htc":
            res["loss_batch"] = _with_duplicate_gt(pb)
            res["jax"] = jax.tree.map(np.asarray, fn(
                v, res["loss_batch"], out["rois"]))
        else:
            res["jax"] = res["jax_plain"]
        model = build_detector(pcfg.model.to_dict())
        model.load_state_dict(from_jax_variables(v), strict=True)
        res["model"] = model
        res.update(_port_run(root, name, ppath, pcfg, v))
    return out


def _port_run(root, name, path, cfg, variables):
    """The narrow file through tools.train (from ``variables``, f32 steps)
    and tools.test (HTC: --eval bbox segm)."""
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
    evals = ["bbox", "segm"] if name == "htc" else ["bbox"]
    metrics = test_tool.main([path, os.path.join(work, "ckpts",
                                                 "step_2.pt"),
                              "--eval", *evals, "--device", "cpu"])
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


# -------------------------------------------------------------- the heads

class _Deconv(torch.nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.deconv1_g3 = torch.nn.ConvTranspose2d(cin, cout, 4, stride=2,
                                                   padding=1)


def test_same_padded_conv_transpose_bridge_both_ways():
    """flax's ``nn.ConvTranspose`` (4x4, stride 2, ``"SAME"``, the default
    ``transpose_kernel=False``) against ``nn.ConvTranspose2d(4, stride 2,
    padding 1)`` from the same random kernel through
    ``from_jax_variables`` (a ``deconv1_g*`` name: flipped in both spatial
    axes): the output, (B, 2H, 2W, C), 1e-4 of max(1, max|ref|); the kernel
    laid out without the flip differs by far more; ``to_jax_variables``
    gives the flax kernel back exactly."""
    import flax.linen as fnn

    class Up(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.ConvTranspose(6, (4, 4), strides=(2, 2),
                                     padding="SAME", name="deconv1_g3")(x)
    x = np.random.RandomState(0).randn(2, 5, 7, 4).astype(np.float32)
    v = mint_variables(Up(), jnp.asarray(x), seed=3)
    v["params"]["deconv1_g3"]["kernel"] = np.random.RandomState(
        4).randn(4, 4, 4, 6).astype(np.float32)
    want = np.asarray(Up().apply(v, x))
    assert want.shape == (2, 10, 14, 6)
    mod = _Deconv(4, 6)
    mod.load_state_dict(from_jax_variables({"params": v["params"]}),
                        strict=True)
    with torch.no_grad():
        got = mod.deconv1_g3(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert_close(got, want)
        k = v["params"]["deconv1_g3"]["kernel"]
        mod.deconv1_g3.weight.copy_(t(k).permute(2, 3, 0, 1))
        unflipped = mod.deconv1_g3(t(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    assert np.abs(unflipped.numpy() - want).max() > 0.5
    mod.load_state_dict(from_jax_variables({"params": v["params"]}))
    back = to_jax_variables(mod)["params"]["deconv1_g3"]
    np.testing.assert_array_equal(back["kernel"], k)


HEAD_CASES = {
    "grid": lambda: (
        jheads.GridHead(grid_points=9, num_convs=2, point_feat_channels=4),
        pheads.GridHead(in_channels=6, grid_points=9, num_convs=2,
                        point_feat_channels=4),
        [(5, 14, 14, 6)]),
    "semantic": lambda: (
        jheads.FusedSemanticHead(num_classes=3, num_convs=2,
                                 conv_channels=8),
        pheads.FusedSemanticHead(3, in_channels=6, num_levels=5,
                                 num_convs=2, conv_channels=8),
        "levels"),
    "htc_mask": lambda: (
        jheads.HTCMaskHead(num_classes=3, conv_channels=6, num_convs=2),
        pheads.HTCMaskHead(3, in_channels=6, conv_channels=6, num_convs=2),
        [(5, 14, 14, 6)]),
    "htc_mask_res": lambda: (
        jheads.HTCMaskHead(num_classes=3, conv_channels=6, num_convs=2),
        pheads.HTCMaskHead(3, in_channels=6, conv_channels=6, num_convs=2,
                           with_res=True),
        [(5, 14, 14, 6), (5, 14, 14, 6)]),
}


def _head_inputs(name, rng):
    """The inputs of a head case: NHWC arrays for JAX and their port
    layouts (a level list, NCHW, for the semantic head; the previous
    stage's features NCHW for the HTC mask head)."""
    shapes = HEAD_CASES[name]()[2]
    if shapes == "levels":
        xs = [[rng.randn(2, h, w, 6).astype(np.float32)
               for h, w in ((16, 24), (8, 12), (4, 6), (2, 3), (1, 2))]]
        return xs, lambda txs: [[x.permute(0, 3, 1, 2) for x in txs[0]]]
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    return xs, lambda txs: [txs[0]] + [x.permute(0, 3, 1, 2)
                                       for x in txs[1:]]


def _flat(x):
    return jax.tree.leaves(x)


@pytest.mark.parametrize("name", sorted(HEAD_CASES))
def test_heads_match_jax(name):
    """``GridHead`` (the fused and unfused heatmaps, the transposed convs
    shared), ``FusedSemanticHead`` (five levels, the finest shrunk with
    antialiasing, the coarser grown) and ``HTCMaskHead`` without and with
    the previous stage's features, from the same minted variables: every
    output and the gradients of sum(out * probe) with respect to every
    parameter and input, 1e-4 of max(1, max|ref|)."""
    jhead, phead, _ = HEAD_CASES[name]()
    rng = np.random.RandomState(5)
    xs, to_port = _head_inputs(name, rng)
    v = mint_variables(jhead, *jax.tree.map(jnp.asarray, xs), seed=7)
    want = _flat(jax.tree.map(np.asarray, jhead.apply(v, *xs)))
    probes = [rng.randn(*w_.shape).astype(np.float32) for w_ in want]

    def jf(params, *ins):
        outs = _flat(jhead.apply({"params": params}, *ins))
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes))
    gp, *gx = jax.jit(jax.grad(jf, argnums=tuple(range(1 + len(xs)))))(
        v["params"], *xs)
    phead.load_state_dict(from_jax_variables(v), strict=True)
    txs = jax.tree.map(lambda a: t(a).requires_grad_(), xs)
    out = phead(*to_port(txs))
    if name.startswith("htc_mask"):
        out = (out[0], out[1].permute(0, 2, 3, 1))
    got = _flat(out)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert_close(g, w_)
    names = [n for n, _ in phead.named_parameters()]
    leaves = jax.tree.leaves(txs)
    grads = torch.autograd.grad(
        sum((g * t(p)).sum() for g, p in zip(got, probes)),
        list(phead.parameters()) + leaves)
    grads_close(to_jax_variables(phead, dict(zip(names, grads[:len(names)])))[
        "params"], gp, rel=1e-4, abs_=1e-6)
    for g, w_ in zip(grads[len(names):], jax.tree.leaves(gx)):
        assert_close(g, w_)


def test_grid_sub_regions_equal_jax():
    """Each point's half-size sub-region and the half size, at the grid's
    56 and at 28, for 9 and 4 points: equal."""
    for g in (9, 4):
        for whole in (56, 28):
            assert pts.grid_sub_regions(g, whole) == \
                jts._grid_sub_regions(g, whole)


def _near_cell_edge(rois, gts, whole=56, eps=1e-4):
    """(S, 9): whether point j of each GT lies within ``eps`` cells of a
    cell's edge of the RoI's grown grid (f64), where a rounding can move
    its floor."""
    r, g = rois.astype(np.float64), gts.astype(np.float64)
    w, h = r[:, 2] - r[:, 0], r[:, 3] - r[:, 1]
    x1, y1 = r[:, 0] - w / 2, r[:, 1] - h / 2
    near = []
    for j in range(9):
        fx, fy = 1 - (j // 3) / 2, 1 - (j % 3) / 2
        px = fx * g[:, 0] + (1 - fx) * g[:, 2]
        py = fy * g[:, 1] + (1 - fy) * g[:, 3]
        cx = (px - x1) / np.maximum(2 * w, 1e-6) * whole
        cy = (py - y1) / np.maximum(2 * h, 1e-6) * whole
        near.append((np.abs(cx - np.round(cx)) < eps)
                    | (np.abs(cy - np.round(cy)) < eps))
    return np.stack(near, -1)


def test_grid_targets_match_jax():
    """``grid_targets`` on 60 RoIs around their GTs (shifted, shrunk and
    grown; some under sqrt(G) px, whose targets are all zero; a few
    points on exact cell edges): equal to JAX's map for map, except the
    point maps whose point lies within 1e-4 of a cell's edge (counted;
    a rounding may move its floor); some targets set."""
    rng = np.random.RandomState(9)
    gts = np.concatenate([rng.uniform(0, 40, (60, 2)), np.zeros((60, 2))],
                         1)
    gts[:, 2:] = gts[:, :2] + rng.uniform(2, 40, (60, 2))
    rois = gts + rng.uniform(-6, 6, (60, 4))
    rois[:5, 2:] = rois[:5, :2] + 0.5
    rois[5:10] = gts[5:10]                      # points on cell edges
    gts, rois = gts.astype(np.float32), rois.astype(np.float32)
    want = np.asarray(jax.jit(jts.grid_targets)(rois, gts))
    got = pts.grid_targets(t(rois), t(gts)).numpy()
    assert got.shape == want.shape == (60, 28, 28, 9)
    differ = (got != want).any(axis=(1, 2))
    near = _near_cell_edge(rois, gts)
    assert not (differ & ~near).any()
    assert int(differ.sum()) <= int(near.sum())
    assert want[:5].sum() == 0 and want.sum() > 0


def test_semantic_targets_match_jax():
    """HTC's semantic class map: ``make_sem_targets`` at stride 8, the
    nearest resize (half-pixel centres) to the semantic logits' size —
    the same size (8x12) and others (4x6, 7x10, 16x24) — and the first
    class set at each cell, the background elsewhere: equal to the
    expression of JAX's ``htc_loss``; the CE times 0.2 1e-5 relative."""
    from lsnet_tpu.core.cpv import make_sem_targets
    rng = np.random.RandomState(10)
    boxes = np.sort(rng.uniform(0, 90, (2, 6, 2, 2)), axis=2)
    gtb = np.stack([boxes[..., 0, 0], boxes[..., 0, 1] * 0.7,
                    boxes[..., 1, 0], boxes[..., 1, 1] * 0.7], -1).astype(
                        np.float32)
    labels = rng.randint(0, 3, (2, 6)).astype(np.int32)
    valid = np.array([[True] * 5 + [False], [True] * 3 + [False] * 3])
    batch = {"gt_bboxes": gtb, "gt_labels": labels, "gt_valid": valid}
    cfg = pts.TwoStageConfig(image_shape=HW, num_classes=3)
    for h, w in ((8, 12), (4, 6), (7, 10), (16, 24)):
        logits = rng.randn(2, h, w, 4).astype(np.float32)

        def jf(lg):
            sem_map, _ = make_sem_targets(gtb, labels, valid, HW, 3)
            tgt = jax.image.resize(sem_map, (2, h, w, 3), method="nearest")
            cls_map = jnp.where(tgt.max(-1) > 0, tgt.argmax(-1), 3)
            logp = jax.nn.log_softmax(lg, -1)
            ce = -jnp.take_along_axis(logp, cls_map[..., None], -1)[..., 0]
            return cls_map, ce.mean() * 0.2
        want_map, want_loss = jax.jit(jf)(logits)
        got_map = pts.semantic_targets(_tbatch(batch), cfg, h, w)
        np.testing.assert_array_equal(got_map.numpy(), want_map)
        got = pts.semantic_loss(t(logits), _tbatch(batch), cfg).item()
        assert abs(got - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert (np.asarray(want_map) < 3).any() and (np.asarray(want_map)
                                                 == 3).any()


# ------------------------------------------------------------- the slice

def test_both_loaders_cut_the_same_first_batch(slice_):
    """The JAX loader's first batch and the port's (bbox for Grid R-CNN,
    the segm pipeline's 36-point contours for HTC), which each runner's
    first step took."""
    for name in FILES:
        jb, pb = slice_[name]["jbatch"], slice_[name]["batch"]
        assert jb.keys() == pb.keys()
        assert ("gt_polygons" in pb) == (name == "htc")
        for k in jb:
            np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
        first = slice_[name]["seen"][0]
        for k in pb:
            np.testing.assert_array_equal(first[k], pb[k], err_msg=k)


@pytest.mark.parametrize("key", ["grid_forward", "semantic", "stage0",
                                 "stage1", "stage2", "mask0", "mask1",
                                 "mask2"])
def test_methods_match_jax(slice_, key):
    """Grid R-CNN's ``grid_forward`` (14x14 RoIAlign, both heatmaps) and
    HTC's ``semantic``, ``roi_forward_stage`` (the semantic embedding's
    7x7 RoI features added) and ``mask_forward_stage`` (its 14x14 ones;
    each stage after the one before's features) on 24 fixed RoIs from
    the same variables: 1e-4 of max(1, max|ref|)."""
    name = "grid" if key == "grid_forward" else "htc"
    model = slice_[name]["model"]
    rois = t(slice_["rois"])
    with torch.no_grad():
        feats = model.extract(t(slice_[name]["loss_batch"]["image"]))
        if name == "grid":
            got = model.grid_forward(feats, rois)
        else:
            sem = model.semantic(feats)
            got, last = {"semantic": sem}, None
            for s in range(3):
                got[f"stage{s}"] = model.roi_forward_stage(feats, rois, s,
                                                           sem[1])
                m, last = model.mask_forward_stage(feats, rois, s, sem[1],
                                                   last)
                got[f"mask{s}"] = (m, last.permute(0, 2, 3, 1))
            got = got[key]
    want = slice_[name]["jax"][key]
    for g, w_ in zip(_flat(got), _flat(want)):
        assert_close(g, w_)


@pytest.mark.parametrize("name", sorted(FILES))
def test_losses_and_gradients_match_jax(slice_, name):
    """``grid_rcnn_loss`` and ``htc_loss`` (on the batch with a duplicate
    GT box and padded GT slots) from each package's own maps, proposals,
    samples, refined stages and GT assignment: every term 1e-4 relative,
    the total too, every parameter's gradient (``grads_close``)."""
    res = slice_[name]
    model = res["model"]
    want_total, want_grads = res["jax"]["loss"]
    want_terms = res["jax"]["terms"]
    fn = pts.grid_rcnn_loss if name == "grid" else pts.htc_loss
    total, terms = fn(model, _tbatch(res["loss_batch"]), res["ts"])
    assert sorted(terms) == sorted(LOSS_KEYS[name]) == sorted(want_terms)
    for k, v in terms.items():
        assert abs(v.item() - want_terms[k]) <= 1e-4 * max(
            1.0, abs(want_terms[k])), (k, v.item(), want_terms[k])
    assert abs(total.item() - want_total) <= 1e-4 * abs(want_total)
    key = "loss_grid" if name == "grid" else "s2.loss_mask"
    assert terms[key].item() > 0
    grads_close(_grads(model, total), want_grads, rel=1e-4, abs_=1e-6)


def _same_detections(got, want, boxes=True):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(got.labels.numpy()[valid],
                                  want.labels[valid])
    mask = torch.from_numpy(valid.copy())
    if boxes:
        assert_close(got.bboxes[mask], want.bboxes[valid])
    assert_close(got.scores[mask], want.scores[valid])
    return mask, valid


def _hot_gaps(model, feats, det):
    """Each detection's smallest gap, over its points, between the
    hottest and the next hottest cell of its fused heatmap (the port's
    own, which are JAX's to ~1e-7)."""
    with torch.no_grad():
        out = model.grid_forward(feats, pts.rois_with_batch_idx(det.bboxes))
    hm = torch.sigmoid(out["fused"]).permute(0, 3, 1, 2).flatten(2)
    top = torch.topk(hm, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).amin(-1).reshape(
        det.valid.shape).numpy()


def test_grid_decode_matches_jax(slice_):
    """``grid_rcnn_decode``: ``two_stage_decode``'s detections (not
    rescaled) equal to JAX's (validity and labels exactly, boxes and
    scores 1e-4 of max(1, max|ref|)), then the vote: each box's edges,
    clipped and rescaled, 1e-4 of max(1, max|ref|), at the detections
    whose points' hottest and next hottest cells lie more than 1e-5
    apart; the rest (where the packages may pick another of two near-equal
    cells) counted, under a fifth."""
    res = slice_["grid"]
    model = res["model"]
    b = _tbatch(res["loss_batch"])
    args = (b["image"], b["img_shape"], b["scale_factor"], res["ts"],
            res["test"])
    with torch.no_grad():
        feats, unvoted = pts._detect(model, *args[:-2], res["ts"],
                                     res["test"], False,
                                     pts.INFERENCE_SAMPLING)
        det = pts.grid_rcnn_decode(model, *args)
    _same_detections(unvoted, jts.Detections(*res["jax"]["unvoted"]))
    want = jts.Detections(*res["jax"]["decode"])
    mask, valid = _same_detections(det, want, boxes=False)
    strict = _hot_gaps(model, feats, unvoted) > 1e-5
    assert (valid & ~strict).sum() <= valid.sum() / 5
    held = torch.from_numpy(valid & strict)
    assert held.sum() > 0
    assert_close(det.bboxes[held], want.bboxes[valid & strict])
    np.testing.assert_array_equal(det.bboxes[~mask].numpy(), 0.0)


def test_htc_decode_matches_jax(slice_):
    """``htc_decode``: the cascade's detections with the semantic
    embedding (validity and labels exactly, boxes and scores 1e-4 of
    max(1, max|ref|)) and the mean of the three stages' mask
    probabilities on them, (B, K, 28, 28), 1e-4."""
    res = slice_["htc"]
    b = _tbatch(res["loss_batch"])
    with torch.no_grad():
        det, masks = pts.htc_decode(res["model"], b["image"], b["img_shape"],
                                    b["scale_factor"], res["ts"],
                                    res["test"])
    want_det, want_masks = res["jax"]["decode"]
    _, valid = _same_detections(det, jts.Detections(*want_det))
    assert masks.shape == (*det.bboxes.shape[:2], 28, 28)
    assert_close(masks[torch.from_numpy(valid.copy())], want_masks[valid])


@pytest.mark.parametrize("name", sorted(FILES))
def test_training_init_matches_the_jax_initializers(slice_, name):
    """``init_weights_`` of the new heads against the JAX initializers,
    their names and shapes from ``eval_shape`` of the narrow detector
    (the port's keys equal): ``GridHead`` and ``FusedSemanticHead``
    LeCun normal (1 / sqrt(fan_in): 25 for a depthwise 5x5), GroupNorm
    scale 1; ``HTCMaskHead`` ``mask_conv*`` N(0, 0.01), ``mask_logits``
    N(0, 0.001), ``conv_res`` and ``mask_upsample`` LeCun normal; every
    bias 0; the spread of the draws of each distribution (a layer, or a
    grid head's per-point or per-edge layers pooled) of 256 or more
    within 15 %."""
    from lsnet_torch.models.init import init_weights_
    path, pcfg = _config(Config, slice_["root"], name, JAX_DEVICES)
    model = build_detector(pcfg.model.to_dict())
    init_weights_(model, torch.Generator().manual_seed(0))
    got = to_jax_variables(model)["params"]
    shapes = slice_[name]["variables"]["params"]
    heads = (["grid_head"] if name == "grid" else
             ["semantic_head", "mask_head1", "mask_head2", "mask_head3"])
    pooled = {}
    for key in heads:
        flat_w = dict(jax.tree_util.tree_flatten_with_path(shapes[key])[0])
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got[key])[0])
        assert flat_g.keys() == flat_w.keys()
        for path_, w_ in flat_w.items():
            name_ = key + jax.tree_util.keystr(path_)
            g = flat_g[path_]
            assert g.shape == w_.shape, name_
            leaf = path_[-1].key
            if leaf in ("bias", "scale"):
                np.testing.assert_array_equal(g, float(leaf == "scale"),
                                              err_msg=name_)
                continue
            layer = path_[0].key
            std = {"mask_logits": 0.001}.get(layer, 0.01 if (
                layer.startswith("mask_conv")) else 1.0 / np.sqrt(
                    np.prod(w_.shape[:-1])))
            # the draws of one distribution: the per-point and per-edge
            # layers pooled (fo_0_1_dw and so_4_3_dw alike)
            kind = re.sub(r"_g\d+$|^(fo|so)_\d+_\d+_", "", layer)
            pooled.setdefault((key, kind, std), []).append(g.ravel())
    checked = 0
    for (key, kind, std), draws in pooled.items():
        g = np.concatenate(draws)
        if g.size >= 256:
            assert abs(g.std() / std - 1) < 0.15, (key, kind)
            checked += 1
    assert checked > 5


# --------------------------------------------------------------- the files

@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_trains_and_tests_each_file(slice_, name):
    """The port's tools.train (2 steps, the EvalHook) and tools.test
    (Grid R-CNN ``--eval bbox``, HTC ``--eval bbox segm``) on each narrow
    file: the loss terms finite and logged, the 12 ``bbox_*`` (and HTC's
    12 ``segm_*``) metrics of tools.test equal to the EvalHook's on the
    step-2 checkpoint (1e-5: the log rounds to 5 decimals)."""
    res = slice_[name]
    assert res["step"] == 2 and len(res["seen"]) == 2
    recs = res["train"]
    assert [(r["epoch"], r["iter"]) for r in recs] == [(1, 1), (1, 2)]
    for r in recs:
        assert set(LOSS_KEYS[name]) | {"loss", "grad_norm"} <= r.keys()
        assert all(np.isfinite(v) for k, v in r.items() if "loss" in k)
    metrics = res["metrics"]
    prefixes = {"bbox", "segm"} if name == "htc" else {"bbox"}
    assert len(metrics) == 12 * len(prefixes)
    assert {k.split("_")[0] for k in metrics} == prefixes
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
    total, grads = slice_[name]["jax_plain"]["loss"]
    got = slice_[name]["train"][0]
    want = {k: float(v) for k, v in
            slice_[name]["jax_plain"]["terms"].items()}
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
    (``test_runner_trains_and_tests_each_file``)."""
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
def test_inference_detector_serves_each_file(slice_, name):
    """``apis.init_detector`` on each narrow file and
    ``inference_detector`` on a val image (the minted weights loaded):
    HTC's ``masks`` beside the boxes, one (28, 28) crop of probabilities a
    detection, as the JAX API returns them; each equal to the valid slots
    of ``apis.detect``'s on the same padded image."""
    from PIL import Image
    from lsnet_torch import apis
    path, _ = _config(Config, slice_["root"], name, JAX_DEVICES)
    bundle = apis.init_detector(path, device="cpu")
    bundle.model.load_state_dict(slice_[name]["model"].state_dict())
    img = os.path.join(slice_["root"], "val", "imgs", "0000.png")
    res = apis.inference_detector(bundle, img)
    n = len(res["scores"])
    assert n > 0
    det = apis._dispatch(bundle, np.asarray(Image.open(img)))
    if name == "htc":
        det, masks = det
        assert res["masks"].shape == (n, 28, 28)
        assert 0.0 <= res["masks"].min() <= res["masks"].max() <= 1.0
        np.testing.assert_array_equal(res["masks"],
                                      masks[0][det.valid[0]].numpy())
    else:
        assert "masks" not in res
    np.testing.assert_array_equal(res["bboxes"],
                                  det.bboxes[0][det.valid[0]].numpy())
