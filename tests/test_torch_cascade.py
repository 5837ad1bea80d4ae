"""The cascade slice (Cascade R-CNN, DetectoRS) of the port against the JAX
package, on the CPU, in f32.

One narrow copy of each shipped file (Cascade R-CNN: R18; DetectoRS: its
SAC ResNet-50 at ``base_channels=16``, so that its bottlenecks carry the
Switchable Atrous Convolutions, and the RFP at two steps; FPN 16, 32-wide
FCs, 3 classes, ``frozen_stages=-1`` so that ``grad_norm`` counts the same
tensors; the RPN samples 64 anchors, 200 candidates give 32 proposals, 16
RoIs a image at every stage, 20 detections) on 16 procedural images
(64x96 and 56x96 on the 64x96 canvas). The JAX detectors' variables are
minted with numpy (``mint_variables``) and carried to the port by
``weights.from_jax_variables``, conditioned so that no selection turns
on f32 rounding:

* the RPN's objectness kernel x 100 (as in
  ``tests/test_torch_mask_rcnn.py``: otherwise every anchor's score lies
  within 1e-5 of the others', and rounding orders the RPN's hard
  negatives);
* each stage's ``fc_cls`` kernel x 100: otherwise the decode's mean
  scores of one class lie within 1e-7 of each other (about 0.253), and
  rounding orders the NMS (5 of 160 slots differed); now the top scores
  lie some 4e-6 apart, a hundred times the packages' difference.
 Each JAX detector computes the three stages' heads on fixed
RoIs, the cascade's samples at every stage, ``cascade_rcnn_loss``'s terms
and gradient and ``cascade_rcnn_decode`` in ONE jitted function, in a
module-scoped fixture, on the first batch both loaders cut.

The slice as a whole: each narrow file through the port's ``tools.train``
(2 steps of 8 images, the EvalHook) and ``tools.test``, resuming from the
minted variables as ``step_0.pt``, f32 steps; its first step's losses and
``grad_norm`` against the JAX loss and gradient on the same batch (the
JAX runner raises on both shipped files: ``grad_clip=None``, ROADMAP
Queue 3). The port's config has 8 times the JAX config's
``samples_per_gpu``: the JAX loader batches it x 8 virtual devices.

The batch is one on which JAX's terms are finite: the later stages'
proposals are refined boxes clipped to the canvas, and a zero-height one
sampled as a negative makes JAX's ``loss_bbox`` NaN (ROADMAP Queue 3;
the port encodes it as the unit box); ``test_cascade_samples_match_jax``
checks that JAX's terms are finite on it.

Tolerances: tensors 1e-4 of max(1, max|ref|) (``assert_close``);
gradients 1e-4 of each tensor's largest entry, floored at 1e-6
(``grads_close``); losses 1e-4 relative, ``grad_norm`` 1e-3 relative;
the samples' labels, positives and validity, and the detections' validity
and labels exactly.
"""

import copy
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
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models import layers as jlayers
from lsnet_tpu.models.necks import extra as jnecks
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch.core import two_stage as pts
from lsnet_torch.data import coco as p_coco
from lsnet_torch.models import build_detector
from lsnet_torch.models import layers as players
from lsnet_torch.models.necks import extra as pnecks
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
FILES = {"cascade": "cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py",
         "detectors": "detectors/detectors_cascade_rcnn_r50_1x_coco.py"}
LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_bbox") + tuple(
    f"s{s}.{k}" for s in range(3) for k in ("loss_cls", "loss_bbox"))


def _narrow(name):
    """The overrides that make the narrow copy of a shipped file: the
    cascade's lists of three heads and three RoI samplers, each narrowed
    (a list replaces the base's whole)."""
    base = JConfig.fromfile(os.path.join(REPO, "configs", FILES[name]))
    base = base.to_dict()
    heads = [dict(h, in_channels=16, fc_out_channels=32, num_classes=3)
             for h in base["model"]["roi_head"]["bbox_head"]]
    rcnn = [dict(r, sampler=dict(r["sampler"], num=16))
            for r in base["train_cfg"]["rcnn"]]
    backbone = dict(depth=18, frozen_stages=-1)
    neck = dict(in_channels=[64, 128, 256, 512], out_channels=16)
    if name == "detectors":
        backbone = dict(depth=50, base_channels=16, frozen_stages=-1)
    return backbone, neck, heads, rcnn


def _config(cls, root, name, samples_per_gpu):
    """The narrow copy of a shipped file, read by ``cls``; (path, cfg)."""
    data = dict(ann_file=os.path.join(root, "ann.json"),
                img_prefix=os.path.join(root, "imgs"),
                img_scale=(HW[1], HW[0]))
    backbone, neck, heads, rcnn = _narrow(name)
    cfg = dict(
        _base_=os.path.join(REPO, "configs", FILES[name]),
        model=dict(pretrained=None, backbone=backbone, neck=neck,
                   rpn_head=dict(in_channels=16, feat_channels=16),
                   roi_head=dict(bbox_head=heads)),
        train_cfg=dict(rpn=dict(sampler=dict(num=64)),
                       rpn_proposal=dict(nms_pre=200, max_per_img=32),
                       rcnn=rcnn),
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


def _first_batch(cfg, loader_cls, dataset_fn, config_cls):
    d = cfg.data.train
    ds = dataset_fn(d.type, config_cls(
        ann_file=d.ann_file, img_prefix=d.img_prefix, task="bbox",
        num_vectors=4, img_scale=tuple(d.img_scale),
        flip_ratio=d.get("flip_ratio", 0.5), max_instances=8))
    return next(iter(loader_cls(ds, JAX_DEVICES, HW).epoch(0)))


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
        p[head]["fc_cls"]["kernel"] *= 100
    return v


def _jax_samples(model, v, batch, cfg):
    """The cascade's samples at each stage, as ``cascade_rcnn_loss``
    draws them, and the stage's refined boxes."""
    feats = model.apply(v, batch["image"], method="extract")
    rpn_outs = model.apply(v, feats, method="rpn")
    props, pvalid = jts.rpn_proposals(rpn_outs, batch["img_shape"], cfg)
    B, S = props.shape[0], cfg.rcnn_num_samples
    out = []
    for s in range(3):
        scfg = jts.TwoStageConfig(**{**cfg.__dict__,
                                     "rcnn_pos_iou": jts.CASCADE_IOUS[s],
                                     "rcnn_stds": jts.CASCADE_STDS[s]})
        rois, labels, deltas, pos, valid = jts.sample_rois(
            props, pvalid, batch["gt_bboxes"], batch["gt_valid"],
            batch["gt_labels"], scfg)
        _, reg = model.apply(v, feats, jts._rois_with_batch_idx(rois),
                             stage=s, method="roi_forward_stage")
        props = jts.delta2bbox(rois.reshape(B * S, 4), reg,
                               stds=jts.CASCADE_STDS[s],
                               max_shape=cfg.image_shape).reshape(B, S, 4)
        pvalid = valid
        out.append({"rois": rois, "labels": labels, "deltas": deltas,
                    "pos": pos, "valid": valid, "refined": props})
    return out


def _jax_cascade(model, cfg, tcfg):
    """The neck's levels, the three stages' heads on fixed RoIs, the
    stages' samples, ``cascade_rcnn_loss``'s terms and gradient and
    ``cascade_rcnn_decode``, in one function."""
    def fn(v, batch, rois):
        feats = model.apply(v, batch["image"], method="extract")
        out = {"feats": feats}
        for s in range(3):
            out[f"stage{s}"] = model.apply(v, feats, rois, stage=s,
                                           method="roi_forward_stage")
        out["samples"] = _jax_samples(model, v, batch, cfg)

        def total(params):
            return jts.cascade_rcnn_loss(model, _params_of(v, params), batch,
                                         cfg)
        (loss, out["terms"]), grads = jax.value_and_grad(
            total, has_aux=True)(v["params"])
        out["loss"] = (loss, grads)
        out["decode"] = jts.cascade_rcnn_decode(
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
    """The JAX results on the first batch (one trace and compile a
    detector), the port's models, and each file through the port's
    tools.train / tools.test."""
    root = str(tmp_path_factory.mktemp("cascade"))
    make_shapes_coco(root, 16, seed=3, hw=[HW, (56, 96)])
    out = {"root": root, "rois": _rois()}
    _, jcfg = _config(JConfig, root, "cascade", 1)
    _, pcfg = _config(Config, root, "cascade", JAX_DEVICES)
    jb = _first_batch(jcfg, j_coco.DataLoader, j_build_dataset,
                      j_coco.DatasetConfig)
    pb = _first_batch(pcfg, p_coco.DataLoader, ploop.build_dataset,
                      p_coco.DatasetConfig)
    out["jbatch"], out["batch"] = jb, pb
    tscfg = jloop.two_stage_cfg_from(jcfg, HW)
    tcfg = jloop.test_cfg_from(jcfg, HW)
    out["ts"] = ploop.two_stage_cfg_from(pcfg, HW)
    out["test"] = ploop.test_cfg_from(pcfg, HW)
    for name in FILES:
        res = out[name] = {}
        ppath, pcfg = _config(Config, root, name, JAX_DEVICES)
        _, jcfg = _config(JConfig, root, name, 1)
        jmodel, _ = j_build(jcfg.model.to_dict())
        v = _mint(jmodel)
        res["variables"] = v
        res["jax"] = jax.tree.map(np.asarray, _jax_cascade(
            jmodel, tscfg, tcfg)(v, jb, out["rois"]))
        model = build_detector(pcfg.model.to_dict())
        model.load_state_dict(from_jax_variables(v), strict=True)
        res["model"] = model
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


def _grads(model, total):
    params = [p for p in model.parameters() if p.requires_grad]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, params)
    return to_jax_variables(model, dict(zip(names, grads)))["params"]


# ------------------------------------------------------ SAConv and the RFP

def test_reflect_pad_matches_jnp_pad():
    """``reflect_pad`` by 2 against ``jnp.pad(mode="reflect")`` on sides of
    1, 2, 3 and 5 (the short sides reflect again, as numpy's rule):
    equal."""
    for h, w in ((1, 2), (2, 3), (3, 5), (5, 1)):
        x = np.random.RandomState(h * 7 + w).randn(2, 3, h, w).astype(
            np.float32)
        want = np.asarray(jnp.pad(x, ((0, 0), (0, 0), (2, 2), (2, 2)),
                                  mode="reflect"))
        np.testing.assert_array_equal(players.reflect_pad(t(x), 2).numpy(),
                                      want)


# (groups, stride, input h x w): the backbone's shapes, and a map shorter
# than the 5x5 switch's reflect padding (the c5 map of a 64x96 image)
SAC_CASES = {"g1_s1": (1, 1, (9, 11)), "g1_s2": (1, 2, (9, 11)),
             "g2_s1": (2, 1, (9, 11)), "g2_s2": (2, 2, (9, 11)),
             "g1_s1_2x3": (1, 1, (2, 3))}


@pytest.mark.parametrize("case", sorted(SAC_CASES))
def test_saconv_matches_jax(case):
    """``SAConv`` at groups 1 and 2, stride 1 and 2, and on a 2x3 map,
    from the same minted variables (``aws_gamma`` 1 + minted, so the
    standardised weight has its scale): the output and the gradients of
    sum(out * probe) with respect to every parameter and the input, 1e-4
    of max(1, max|ref|); ``weight`` and ``weight_diff`` cross the bridge
    in HWIO, ``aws_*`` as (1, 1, 1, cout), and come back equal."""
    groups, stride, (h, w) = SAC_CASES[case]
    rng = np.random.RandomState(5)
    x = rng.randn(2, h, w, 8).astype(np.float32)
    jmod = jlayers.SAConv(out_channels=12, stride=stride, groups=groups)
    v = mint_variables(jmod, jnp.asarray(x), seed=7)
    v["params"]["aws_gamma"] = v["params"]["aws_gamma"] + 1.0
    want = np.asarray(jmod.apply(v, x))
    probe = rng.randn(*want.shape).astype(np.float32)

    def jf(params, xin):
        return jnp.sum(jmod.apply({"params": params}, xin) * probe)
    gp, gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(v["params"], x)
    pmod = players.SAConv(8, 12, 3, stride, 1, groups)
    pmod.load_state_dict(from_jax_variables(v), strict=True)
    assert tuple(pmod.weight.shape) == (3, 3, 8 // groups, 12)
    assert tuple(pmod.aws_gamma.shape) == (1, 1, 1, 12)
    tx = t(x).permute(0, 3, 1, 2).requires_grad_()
    got = pmod(tx)
    assert_close(got.permute(0, 2, 3, 1), want)
    names = [n for n, _ in pmod.named_parameters()]
    grads = torch.autograd.grad((got.permute(0, 2, 3, 1) * t(probe)).sum(),
                                list(pmod.parameters()) + [tx])
    grads_close(to_jax_variables(pmod, dict(zip(names, grads[:-1])))[
        "params"], gp, rel=1e-4, abs_=1e-6)
    assert_close(grads[-1].permute(0, 2, 3, 1), gx)
    back = to_jax_variables(pmod)["params"]
    for k in ("weight", "weight_diff", "aws_gamma", "aws_beta"):
        np.testing.assert_array_equal(back[k], v["params"][k])


@pytest.mark.parametrize("steps", [2, 3])
def test_rfp_matches_jax(steps):
    """``RFP`` at 2 (the file's) and 3 steps on four levels (widths 8 to
    32, 16x24 down to 2x3), from the same minted variables: the five
    outputs and the gradients of sum(out * probe) with respect to every
    parameter and input, 1e-4 of max(1, max|ref|)."""
    rng = np.random.RandomState(6)
    widths, sides = (8, 16, 24, 32), ((16, 24), (8, 12), (4, 6), (2, 3))
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for c, (h, w) in zip(widths, sides)]
    jmod = jnecks.RFP(out_channels=8, num_outs=5, rfp_steps=steps)
    v = mint_variables(jmod, [jnp.asarray(x) for x in xs], seed=8)
    want = [np.asarray(o) for o in jmod.apply(v, xs)]
    probes = [rng.randn(*o.shape).astype(np.float32) for o in want]

    def jf(params, ins):
        outs = jmod.apply({"params": params}, ins)
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes))
    gp, gx = jax.jit(jax.grad(jf, argnums=(0, 1)))(v["params"], xs)
    pmod = pnecks.RFP(list(widths), out_channels=8, num_outs=5,
                      rfp_steps=steps)
    pmod.load_state_dict(from_jax_variables(v), strict=True)
    tx = [t(x).permute(0, 3, 1, 2).requires_grad_() for x in xs]
    got = [o.permute(0, 2, 3, 1) for o in pmod(tx)]
    assert len(got) == 5
    for g, w_ in zip(got, want):
        assert_close(g, w_)
    names = [n for n, _ in pmod.named_parameters()]
    grads = torch.autograd.grad(
        sum((g * t(p)).sum() for g, p in zip(got, probes)),
        list(pmod.parameters()) + tx)
    grads_close(to_jax_variables(pmod, dict(zip(names, grads[:len(names)])))[
        "params"], gp, rel=1e-4, abs_=1e-6)
    for g, w_ in zip(grads[len(names):], gx):
        assert_close(g.permute(0, 2, 3, 1), w_)


def test_detectors_training_init_matches_the_jax_initializers():
    """``init_weights_`` of a narrow DetectoRS (SAC ResNet-50 at base 16,
    RFP 16 wide, 64-wide RoI FCs) against the JAX initializers, its
    names and shapes from ``eval_shape``: each SAConv's ``weight`` He
    normal over fan_out (k x k x cout), ``weight_diff``, ``aws_beta``,
    the context convs and the switch's kernel 0, ``aws_gamma`` and the
    switch's bias 1; the RFP's convolutions He normal over fan_out, biases
    0; the three stages' heads: ``fc_cls`` N(0, 0.01), ``fc_reg`` N(0,
    0.001), the shared FCs LeCun normal; the spread of each random kernel
    of 64 draws or more within 15 %."""
    from lsnet_torch.models.init import init_weights_
    backbone, neck, heads, _ = _narrow("detectors")
    model_cfg = JConfig.fromfile(os.path.join(
        REPO, "configs", FILES["detectors"])).to_dict()["model"]
    model_cfg["backbone"].update(backbone)
    model_cfg["neck"].update(neck)
    model_cfg["rpn_head"].update(in_channels=16, feat_channels=16)
    model_cfg["roi_head"]["bbox_head"] = [dict(h, fc_out_channels=64)
                                          for h in heads]
    model = build_detector(copy.deepcopy(model_cfg))
    init_weights_(model, torch.Generator().manual_seed(0))
    got = to_jax_variables(model)["params"]
    jdet, _ = j_build(model_cfg)
    shapes = jax.eval_shape(lambda: jdet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3))))["params"]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    n_sac = 0
    for path, w_ in flat_w.items():
        keys = [p.key for p in path]
        name_ = jax.tree_util.keystr(path)
        g = flat_g[path]
        assert g.shape == w_.shape, name_
        std = None
        if keys[0] == "backbone" and keys[-1] in (
                "weight", "weight_diff", "aws_gamma", "aws_beta"):
            n_sac += keys[-1] == "weight"
            fixed = {"weight_diff": 0.0, "aws_beta": 0.0, "aws_gamma": 1.0}
            if keys[-1] in fixed:
                np.testing.assert_array_equal(g, fixed[keys[-1]])
                continue
            if keys[-1] == "weight":
                std = np.sqrt(2.0 / (9 * w_.shape[-1]))
        elif keys[0] == "backbone" and keys[-2] in ("pre_context", "switch",
                                                    "post_context"):
            fill = float(keys[-2] == "switch" and keys[-1] == "bias")
            np.testing.assert_array_equal(g, fill, err_msg=name_)
            continue
        elif keys[0] == "neck" and keys[-1] == "kernel":
            std = np.sqrt(2.0 / (np.prod(w_.shape[:2]) * w_.shape[-1]))
        elif keys[0].startswith("bbox_head") and keys[-1] == "kernel":
            std = {"fc_cls": 0.01, "fc_reg": 0.001}.get(
                keys[1], 1.0 / np.sqrt(w_.shape[0]))
        elif keys[-1] == "bias" and keys[0] in ("neck", "bbox_head",
                                                "bbox_head2", "bbox_head3"):
            np.testing.assert_array_equal(g, 0.0, err_msg=name_)
            continue
        if std is not None and g.size >= 64:
            assert abs(g.std() / std - 1) < 0.15, name_
    assert n_sac == 13


# ------------------------------------------------------------- the slice

def test_both_loaders_cut_the_same_first_batch(slice_):
    """The JAX loader's first batch and the port's, which each runner's
    first step took; padded GT slots in it."""
    jb, pb = slice_["jbatch"], slice_["batch"]
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    for name in FILES:
        first = slice_[name]["seen"][0]
        for k in pb:
            np.testing.assert_array_equal(first[k], pb[k], err_msg=k)
    assert (~pb["gt_valid"]).any()


def test_narrow_files_keep_three_class_agnostic_stages(slice_):
    """The narrow copies read the same with both loaders: three bbox heads
    and three RoI samplers at IoU 0.5, 0.6, 0.7, and the port builds
    three class-agnostic heads (4 deltas) of 4 logits each."""
    for name in FILES:
        path, pc = _config(Config, slice_["root"], name, JAX_DEVICES)
        assert pc.to_dict() == JConfig.fromfile(path).to_dict()
        assert [r.assigner.pos_iou_thr for r in pc.train_cfg.rcnn] == \
            list(pts.CASCADE_IOUS)
        model = slice_[name]["model"]
        for s in range(3):
            head = model.stage_head(s)
            assert (head.fc_cls.out_features, head.fc_reg.out_features) \
                == (4, 4)


def test_detectors_neck_matches_jax(slice_):
    """DetectoRS' ``extract``: the SAC ResNet-50 and the two-step RFP on
    the batch, each of the five levels 1e-4 of max(1, max|ref|)."""
    model = slice_["detectors"]["model"]
    with torch.no_grad():
        feats = model.extract(t(slice_["batch"]["image"]))
    want = slice_["detectors"]["jax"]["feats"]
    assert len(feats) == len(want) == 5
    for g, w_ in zip(feats, want):
        assert_close(g.permute(0, 2, 3, 1), w_)


@pytest.mark.parametrize("name", sorted(FILES))
def test_stage_heads_match_jax(slice_, name):
    """``roi_forward_stage`` of each of the three stages on 24 fixed RoIs
    of every level: the logits and the class-agnostic deltas, 1e-4 of
    max(1, max|ref|)."""
    model = slice_[name]["model"]
    with torch.no_grad():
        feats = model.extract(t(slice_["batch"]["image"]))
        for s in range(3):
            cls, reg = model.roi_forward_stage(feats, t(slice_["rois"]), s)
            want_cls, want_reg = slice_[name]["jax"][f"stage{s}"]
            assert reg.shape == (24, 4)
            assert_close(cls, want_cls)
            assert_close(reg, want_reg)


@pytest.mark.parametrize("name", sorted(FILES))
def test_cascade_samples_match_jax(slice_, name):
    """Each stage's samples, from each package's own proposals and the
    stage before's refined boxes: the labels, positives and validity
    exactly, the RoIs, their targets and the refined boxes 1e-4 of
    max(1, max|ref|); the later stages sample more positives; no refined
    box is inverted, and JAX's terms are finite on this batch."""
    model = slice_[name]["model"]
    b = _tbatch(slice_["batch"])
    ts = slice_["ts"]
    with torch.no_grad():
        losses, feats, props, pvalid = pts.rpn_stage(
            model, b, ts, pts.TRAIN_SAMPLING)
        _, _, drawn = pts.cascade_stages(model, b, ts, feats, props, pvalid,
                                         torch.zeros(()))
    want = slice_[name]["jax"]["samples"]
    n_pos = []
    for s, ((st, refined), w_) in enumerate(zip(drawn, want)):
        for k in ("labels", "pos", "valid"):
            np.testing.assert_array_equal(getattr(st, k).numpy(), w_[k],
                                          err_msg=f"stage {s} {k}")
        assert_close(st.rois, w_["rois"])
        assert_close(st.deltas, w_["deltas"])
        assert_close(refined, w_["refined"])
        n_pos.append(int(w_["pos"].sum()))
        if s < 2:
            assert torch.equal(drawn[s + 1][0].props, refined)
    assert 0 < n_pos[0] <= n_pos[1] <= n_pos[2]
    flat = want[2]["refined"].reshape(-1, 4)
    flat_h = flat[:, 3] - flat[:, 1]
    assert (flat_h >= 0).all()
    assert np.isfinite(np.asarray(
        [float(v) for v in slice_[name]["jax"]["terms"].values()])).all()


@pytest.mark.parametrize("name", sorted(FILES))
def test_cascade_loss_and_gradients_match_jax(slice_, name):
    """``cascade_rcnn_loss`` from each package's own maps, proposals and
    stages: every term (the RPN's and each stage's weighted CE and
    SmoothL1) 1e-4 relative, the total too, every parameter's gradient
    (``grads_close``)."""
    model = slice_[name]["model"]
    want_total, want_grads = slice_[name]["jax"]["loss"]
    want_terms = slice_[name]["jax"]["terms"]
    total, terms = pts.cascade_rcnn_loss(model, _tbatch(slice_["batch"]),
                                         slice_["ts"])
    assert sorted(terms) == sorted(LOSS_KEYS) == sorted(want_terms)
    for k, v in terms.items():
        assert abs(v.item() - want_terms[k]) <= 1e-4 * max(
            1.0, abs(want_terms[k])), (k, v.item(), want_terms[k])
    assert abs(total.item() - want_total) <= 1e-4 * abs(want_total)
    assert all(terms[f"s{s}.loss_bbox"].item() > 0 for s in range(3))
    grads_close(_grads(model, total), want_grads, rel=1e-4, abs_=1e-6)


@pytest.mark.parametrize("name", sorted(FILES))
def test_cascade_decode_matches_jax(slice_, name):
    """``cascade_rcnn_decode`` (the three stages' mean scores on the
    refined boxes, clipped, rescaled, class-wise NMS) from each package's
    own maps: the detections' validity and labels exactly, boxes and
    scores 1e-4 of max(1, max|ref|)."""
    model = slice_[name]["model"]
    b = _tbatch(slice_["batch"])
    with torch.no_grad():
        det = pts.cascade_rcnn_decode(model, b["image"], b["img_shape"],
                                      b["scale_factor"], slice_["ts"],
                                      slice_["test"])
    want = jts.Detections(*slice_[name]["jax"]["decode"])
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(det.valid.numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(det.labels.numpy()[valid],
                                  want.labels[valid])
    mask = torch.from_numpy(valid.copy())
    assert_close(det.bboxes[mask], want.bboxes[valid])
    assert_close(det.scores[mask], want.scores[valid])


def test_weights_bridge_round_trips_the_detectors_variables(slice_):
    """DetectoRS' minted variables through ``from_jax_variables`` and
    back through ``to_jax_variables``: the same tree, every leaf equal
    (the SAConvs' HWIO ``weight`` / ``weight_diff`` and their ``aws_*``
    included)."""
    v = slice_["detectors"]["variables"]
    back = to_jax_variables(slice_["detectors"]["model"])
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)
    sac = v["params"]["backbone"]["layer2_0"]["conv2"]
    assert {"weight", "weight_diff", "aws_gamma", "aws_beta"} <= set(sac)


# --------------------------------------------------------------- the files

@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_trains_and_tests_each_file(slice_, name):
    """The port's tools.train (2 steps, the EvalHook) and ``tools.test
    --eval bbox`` on each narrow file: the loss terms finite and logged,
    the 12 ``bbox_*`` metrics of tools.test equal to the EvalHook's on the
    step-2 checkpoint (1e-5: the log rounds to 5 decimals)."""
    res = slice_[name]
    assert res["step"] == 2 and len(res["seen"]) == 2
    recs = res["train"]
    assert [(r["epoch"], r["iter"]) for r in recs] == [(1, 1), (1, 2)]
    for r in recs:
        assert set(LOSS_KEYS) | {"loss", "grad_norm"} <= r.keys()
        assert all(np.isfinite(v) for k, v in r.items()
                   if "loss" in k)
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
    gradient on the same batch from the same variables: each loss 1e-4
    relative, ``grad_norm`` 1e-3 relative."""
    total, grads = slice_[name]["jax"]["loss"]
    got = slice_[name]["train"][0]
    want = {k: float(v) for k, v in slice_[name]["jax"]["terms"].items()}
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
    ``inference_detector`` on an image of the set (the minted weights
    loaded): boxes inside the image, equal to the valid slots of
    ``apis.detect`` on the same padded image."""
    from PIL import Image
    from lsnet_torch import apis
    path, _ = _config(Config, slice_["root"], name, JAX_DEVICES)
    bundle = apis.init_detector(path, device="cpu")
    bundle.model.load_state_dict(slice_[name]["model"].state_dict())
    img = os.path.join(slice_["root"], "imgs", "0000.png")
    res = apis.inference_detector(bundle, img)
    n = len(res["scores"])
    assert n > 0 and "masks" not in res
    h, w = np.asarray(Image.open(img)).shape[:2]
    assert (res["bboxes"] >= 0).all()
    assert (res["bboxes"][:, [0, 2]] <= w + 1e-3).all()
    assert (res["bboxes"][:, [1, 3]] <= h + 1e-3).all()
    det = apis._dispatch(bundle, np.asarray(Image.open(img)))
    np.testing.assert_array_equal(res["scores"],
                                  det.scores[0][det.valid[0]].numpy())
