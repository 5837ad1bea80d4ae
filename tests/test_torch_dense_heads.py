"""The dense zoo's anchors, common losses, and RetinaNet, FCOS, ATSS and
GFL in the port against the JAX package, on the CPU.

Inputs are made with numpy from seeds. Tolerances, each stated at its
check:

* ``core/anchors.py``: the numpy grids (base, grid, SSD) equal; the
  valid flags equal; the coders' values 1e-5 and their gradients 1e-5 of
  max(1, max|ref|);
* ``models/losses/common.py``: every function's value 1e-5 and its
  gradients 1e-4 of max(1, max|ref|), in each reduction;
* each head from the shipped file's head config at a narrow width (two
  stacked convs, 32 channels, 3 classes) on FPN-level features of a
  64x96 canvas, from the JAX training init (``module.init``) and from
  minted weights (0.03 * N(0, 1)), with GT and with none: the head maps
  1e-4 of max(1, max|ref|), the loss and its terms 1e-4 relative, the
  gradient of every parameter within 1e-4 of its largest entry or 1e-5
  absolute (``grads_close``), but FCOS's first cls-tower conv kernel
  within 2e-5 absolute (``GRAD_LEAF_ABS``);
* each decode on random head-shaped outputs: the valid mask and the
  labels equal, boxes 1e-3 absolute, scores 1e-5;
* the files' loss and test settings against the JAX runner's, field by
  field (FCOS's ``assigner=None``, on which the JAX ``dense_cfg_from``
  raises, read as no settings);
* the port's training init against the JAX init's constants (the focal
  prior, zero biases, ``scales`` 1) and spreads;
* the runner: one narrow step and an evaluation of each file through
  ``train_detector`` / ``evaluate_detector``, and the image-level API on
  a RetinaNet bundle.

Each head kind's JAX forward, loss, parameter gradients and decode run in
one compiled function, called four times (two weight sets, two batches).
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core import anchors as janchors
from lsnet_tpu.core import dense_decode as jdd
from lsnet_tpu.core import dense_loss as jdl
from lsnet_tpu.core.decode import TestConfig as JTestConfig
from lsnet_tpu.models import build_head as j_build_head
from lsnet_tpu.models.losses import common as jcommon
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch import apis
from lsnet_torch.core import anchors, dense_decode as pdd, dense_loss as pdl
from lsnet_torch.core.decode import TestConfig
from lsnet_torch.models import build_head, head_cfg_of
from lsnet_torch.models.init import init_weights_
from lsnet_torch.models.losses import common
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import loop as ploop
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import load_jax_variables, to_jax_variables
from torch_port_util import (assert_close, grads_close, gt_batch,
                             level_feats, mint_variables, t)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
C = 3
FILES = {"retina": "retinanet/retinanet_r50_fpn_1x_coco.py",
         "fcos": "fcos/fcos_r50_fpn_1x_coco.py",
         "atss": "atss/atss_r50_fpn_1x_coco.py",
         "gfl": "gfl/gfl_r50_fpn_1x_coco.py"}
OUT_KEYS = {"retina": ("cls", "reg"), "fcos": ("cls", "reg", "centerness"),
            "atss": ("cls", "reg", "centerness"), "gfl": ("cls", "reg")}
TERMS = {"retina": {"loss_cls", "loss_bbox"},
         "fcos": {"loss_cls", "loss_bbox", "loss_centerness"},
         "atss": {"loss_cls", "loss_bbox", "loss_centerness"},
         "gfl": {"loss_cls", "loss_bbox", "loss_dfl"}}
TEST_KW = dict(image_shape=HW, num_classes=C, nms_pre=1000, score_thr=0.05,
               nms_iou=0.5, max_per_img=100)


def _rel(got, want, rel=1e-4):
    got, want = float(got.detach() if isinstance(got, torch.Tensor)
                      else got), float(want)
    assert abs(got - want) <= rel * max(1e-6, abs(want)), (got, want)


# ------------------------------------------------------------ anchors

ANCHOR_CFGS = [
    dict(),
    dict(ratios=(1.0,), octave_base_scale=8.0, scales_per_octave=1),
    dict(strides=(4, 8, 16), ratios=(0.5, 2.0), octave_base_scale=3.0,
         scales_per_octave=2, center_offset=0.5)]


@pytest.mark.parametrize("i", range(len(ANCHOR_CFGS)))
def test_anchor_grids_match_jax(i):
    """base / grid anchors equal (the same numpy); the valid flags of a
    batch equal JAX's per image; the device grid is built once."""
    jc = janchors.AnchorConfig(**ANCHOR_CFGS[i])
    pc = anchors.AnchorConfig(**ANCHOR_CFGS[i])
    assert pc.num_base_anchors == jc.num_base_anchors
    for s in pc.strides:
        np.testing.assert_array_equal(anchors.base_anchors(pc, s),
                                      janchors.base_anchors(jc, s))
    for hw in (HW, (100, 150)):
        got, counts = anchors.grid_anchors(pc, hw)
        want, wcounts = janchors.grid_anchors(jc, hw)
        np.testing.assert_array_equal(got, want)
        assert counts == wcounts
        on, on_counts = anchors.grid_anchors_on(pc, hw, "cpu")
        assert anchors.grid_anchors_on(pc, list(hw), "cpu")[0] is on
        np.testing.assert_array_equal(on.numpy(), want)
        assert on_counts == tuple(wcounts)
        shapes = np.array([[hw[0], hw[1]], [hw[0] - 20, hw[1] - 37],
                           [9, 17]], np.int32)
        flags = anchors.anchor_valid_flags(pc, hw, t(shapes))
        for b in range(3):
            np.testing.assert_array_equal(
                flags[b].numpy(), np.asarray(janchors.anchor_valid_flags(
                    jc, hw, jnp.asarray(shapes[b]))))
        assert 0 < flags[2].sum() < flags[1].sum() < flags[0].sum()


def _coder_inputs(seed=0, n=40):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (2, n, 2))
    wh = rng.uniform(2, 40, (2, n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gxy = xy + rng.uniform(-5, 5, (2, n, 2))
    gwh = wh * rng.uniform(0.5, 2, (2, n, 2))
    gts = np.concatenate([gxy, gxy + gwh], -1).astype(np.float32)
    deltas = rng.randn(2, n, 4).astype(np.float32)
    deltas[:, :3, 2:] = [[6.0, -7.0]]          # past the wh_ratio clamp
    dist = rng.uniform(0, 30, (2, n, 4)).astype(np.float32)
    shapes = np.array([[64, 96], [50, 70]], np.int32)
    return boxes, gts, deltas, dist, shapes


@pytest.mark.parametrize("coder", ["bbox2delta", "delta2bbox",
                                   "distance2bbox", "bbox2distance"])
def test_box_coders_match_jax(coder):
    """Each coder per image against JAX's, means / stds set, clipped to
    each image's shape (``max_shape``), ``max_dist``: values and the
    gradient of a random projection, 1e-5 of max(1, max|ref|)."""
    boxes, gts, deltas, dist, shapes = _coder_inputs()
    kw = dict(means=(0.1, -0.1, 0.05, 0.0), stds=(0.1, 0.1, 0.2, 0.2))
    ins = {"bbox2delta": (boxes, gts), "delta2bbox": (boxes, deltas),
           "distance2bbox": (boxes[..., :2], dist),
           "bbox2distance": (boxes[..., :2], gts)}[coder]
    probe = np.random.RandomState(1).randn(2, 40, 4).astype(np.float32)
    for b in range(2):
        extra = {"bbox2delta": kw,
                 "delta2bbox": dict(kw, max_shape=shapes[b]),
                 "distance2bbox": dict(max_shape=shapes[b]),
                 "bbox2distance": dict(max_dist=17.0)}[coder]

        def jf(x, y, extra=extra):
            out = getattr(janchors, coder)(x, y, **extra)
            return jnp.sum(out * probe[b]), out

        (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
            jnp.asarray(ins[0][b]), jnp.asarray(ins[1][b]))
        tx, ty = (t(a[b]).requires_grad_() for a in ins)
        pextra = dict(extra)
        if "max_shape" in pextra:
            pextra["max_shape"] = t(shapes[b])
        got = getattr(anchors, coder)(tx, ty, **pextra)
        (got * t(probe[b])).sum().backward()
        assert_close(got, np.asarray(want), rel=1e-5)
        assert_close(tx.grad, np.asarray(jg[0]), rel=1e-5)
        assert_close(ty.grad, np.asarray(jg[1]), rel=1e-5)
    if coder in ("delta2bbox", "distance2bbox"):
        # batched: one max_shape row per image
        got = getattr(anchors, coder)(t(ins[0]), t(ins[1]),
                                      **({} if coder == "distance2bbox"
                                         else kw), max_shape=t(shapes))
        assert (got[1, :, 2] <= 70).all() and (got[1, :, 3] <= 50).all()
        assert (got[0, :, 2] > 70).any()


@pytest.mark.parametrize("size,lo", [(300, 0.15), (300, 0.2), (512, 0.1),
                                     (512, 0.15)])
def test_ssd_anchors_match_jax(size, lo):
    strides = (8, 16, 32, 64, 100, 300) if size == 300 else \
        (8, 16, 32, 64, 128, 256, 512)
    ratios = ([2], [2, 3], [2, 3], [2, 3], [2], [2]) if size == 300 else \
        ([2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2])
    rng = (lo, 0.9)
    for g, w_ in zip(anchors.ssd_base_anchors(strides, ratios, rng, size),
                     janchors.ssd_base_anchors(strides, ratios, rng, size)):
        np.testing.assert_array_equal(g, w_)
    got = anchors.ssd_grid_anchors((size, size), strides, ratios, rng, size)
    want = janchors.ssd_grid_anchors((size, size), strides, ratios, rng,
                                     size)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == tuple(want[1:])
    with pytest.raises(ValueError, match="unsupported"):
        anchors.ssd_base_anchors(strides, ratios, (0.3, 0.9), size)


# ------------------------------------------------------------ common losses

def _loss_inputs(name, seed=2):
    rng = np.random.RandomState(seed)
    n = 30
    if name in ("iou", "giou", "diou", "ciou"):
        boxes, gts, *_ = _coder_inputs(seed, n)
        gts[0, :4] = gts[0, 4:8] + 500.0             # no overlap
        return boxes[0], gts[0]
    if name in ("smooth_l1", "l1"):
        return (rng.randn(n, 4).astype(np.float32),
                rng.randn(n, 4).astype(np.float32))
    if name == "cross_entropy":
        return (2 * rng.randn(n, 5)).astype(np.float32), \
            rng.randint(0, 5, n).astype(np.int32)
    if name in ("bce", "ghm_c"):
        return (2 * rng.randn(n, 5)).astype(np.float32), \
            (rng.rand(n, 5) > 0.7).astype(np.float32)
    if name == "ae":
        return rng.randn(8, 2).astype(np.float32), rng.rand(8) > 0.3
    return (10 * rng.rand(6, 9, 2)).astype(np.float32), \
        (10 * rng.rand(6, 7, 2)).astype(np.float32)              # chamfer


LOSS_NAMES = {"iou": "iou_loss", "giou": "giou_loss", "diou": "diou_loss",
              "ciou": "ciou_loss", "smooth_l1": "smooth_l1_loss",
              "l1": "l1_loss", "cross_entropy": "cross_entropy_loss",
              "bce": "binary_cross_entropy_loss", "ghm_c": "ghm_c_loss",
              "ae": "ae_loss", "chamfer": "chamfer_loss"}
REDUCTIONS = [("none", None), ("sum", None), ("mean", None),
              ("mean", 7.5)]


@pytest.mark.parametrize("name", sorted(LOSS_NAMES))
def test_common_losses_match_jax(name):
    """Every function of ``losses/common.py`` (and
    ``bbox_overlaps_aligned``): value 1e-5 and the gradient of the
    prediction 1e-4 of max(1, max|ref|), in each reduction, with a row
    weight and ``loss_weight`` where it takes them."""
    pred, target = _loss_inputs(name)
    n = pred.shape[0]
    weight = np.random.RandomState(5).rand(
        *((n, 1) if name in ("smooth_l1", "l1", "bce") else (n,))).astype(
            np.float32)
    cases = [dict()]
    if name not in ("ghm_c", "ae"):
        cases = [dict(reduction=r, avg_factor=a, loss_weight=1.5)
                 for r, a in REDUCTIONS]
    for kw in cases:
        takes_weight = name not in ("ghm_c", "ae")
        jfn = getattr(jcommon, LOSS_NAMES[name])
        pfn = getattr(common, LOSS_NAMES[name])
        if name == "ghm_c":
            args = (jnp.asarray(weight[:, None] > 0.3),)
            pargs = (t(weight[:, None] > 0.3),)
        elif takes_weight:
            args, pargs = (jnp.asarray(weight),), (t(weight),)
        else:
            args = pargs = ()
        jt, pt = jnp.asarray(target), t(target)

        def jf(p):
            out = jfn(p, jt, *args, **kw)
            return jnp.sum(out), out

        (_, want), jg = jax.value_and_grad(jf, has_aux=True)(
            jnp.asarray(pred))
        tp = t(pred).requires_grad_()
        got = pfn(tp, pt, *pargs, **kw)
        got.sum().backward()
        assert_close(got, np.asarray(want), rel=1e-5)
        assert_close(tp.grad, np.asarray(jg), rel=1e-4)
    if name in ("iou", "giou"):
        assert_close(common.bbox_overlaps_aligned(t(pred), t(target)),
                     np.asarray(jcommon.bbox_overlaps_aligned(
                         jnp.asarray(pred), jnp.asarray(target))), rel=1e-6)


# ------------------------------------------------------------ heads

def file_cfg(kind, package=Config):
    return package.fromfile(os.path.join(REPO, "configs", FILES[kind]))


def narrow_head_cfg(cfg, feat=32):
    """The file's head config at a narrow width: ``feat`` channels, two
    stacked convs, C classes."""
    model = cfg.to_dict()["model"]
    head = dict(head_cfg_of(model))
    head.update(in_channels=feat, feat_channels=feat)
    for k, v in (("stacked_convs", 2), ("num_classes", C)):
        if k in head:
            head[k] = v
    return head


def jax_loss_cfg(pcfg):
    """The JAX ``DenseLossConfig`` with the port config's fields."""
    fields = {f.name: getattr(pcfg, f.name)
              for f in dataclasses.fields(pcfg)}
    fields["anchor"] = janchors.AnchorConfig(
        **dataclasses.asdict(pcfg.anchor))
    return jdl.DenseLossConfig(**fields)


def levels_of(strides, hw=HW):
    return [(-(-hw[0] // s), -(-hw[1] // s)) for s in strides]


def random_outputs(kind, levels, channels, seed):
    """Head-shaped outputs with many candidates on every level."""
    rng = np.random.RandomState(seed)
    outs = {}
    for key, d in channels.items():
        shift = 1.5 if key == "cls" else 0.0
        # GFL's bins peak anywhere, so its boxes vary in size
        scale = {"reg": 3.0 if kind == "gfl" else 0.5,
                 "shape": 0.5}.get(key, 1.0)
        outs[key] = [(scale * rng.randn(2, h, w, d) + shift).astype(
            np.float32) for h, w in levels]
    if kind == "fcos":
        outs["reg"] = [np.exp(m) for m in outs["reg"]]
    return outs


DECODE_IN = dict(shapes=np.array([[HW[0], HW[1]], [HW[0] - 10, HW[1] - 20]],
                                 np.int32),
                 sfs=np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]],
                              np.float32))


def run_jax_cases(kind, jhead, jcfg, jtcfg, feats, batches, variables,
                  rand):
    """One compiled function: forward, loss, gradients and decode; called
    for every (weights, batch) pair."""
    def run(params, batch, rand_outs, shapes, sfs):
        def f(p):
            outs = jhead.apply({"params": p}, [jnp.asarray(x)
                                               for x in feats])
            total, terms = jdl.dense_loss(outs, batch, jcfg)
            return total, (terms, outs)

        (total, (terms, outs)), grads = jax.value_and_grad(
            f, has_aux=True)(params)
        det = jdd.dense_decode(rand_outs, shapes, sfs, jtcfg, jcfg)
        return dict(total=total, terms=terms, outs=outs, grads=grads,
                    det=det._asdict())

    fn = jax.jit(run)
    res = {}
    for wname, v in variables.items():
        for bname, batch in batches.items():
            res[wname, bname] = jax.tree.map(np.asarray, fn(
                v["params"], {k: jnp.asarray(a) for k, a in batch.items()},
                jax.tree.map(jnp.asarray, rand),
                jnp.asarray(DECODE_IN["shapes"]),
                jnp.asarray(DECODE_IN["sfs"])))
    return res


def run_port_cases(head_cfg, pcfg, feats, batches, variables):
    res = {}
    for wname, v in variables.items():
        for bname, batch in batches.items():
            head = build_head(head_cfg)
            load_jax_variables(head, v)
            outs = head([t(f).permute(0, 3, 1, 2) for f in feats],
                        TRAIN_SAMPLING)
            total, terms = pdl.dense_loss(
                outs, {k: t(a) for k, a in batch.items()}, pcfg)
            total.backward()
            grads = to_jax_variables(head, {n: p.grad for n, p in
                                            head.named_parameters()})
            res[wname, bname] = dict(total=total, terms=terms, outs=outs,
                                     grads=grads["params"])
    return res


def head_case(kind, file_cfg_fn, channels, feat=32, seed=0):
    """Both packages' results of one file's head: (jax results, port
    results, the port's loss config, the JAX test config, the random
    decode inputs)."""
    pc, jc = file_cfg_fn(Config), file_cfg_fn(JConfig)
    head_cfg = narrow_head_cfg(pc, feat)
    pcfg = dataclasses.replace(ploop.dense_cfg_from(pc, HW), num_classes=(
        C if "num_classes" in head_cfg else 1))
    jcfg = jax_loss_cfg(pcfg)
    jhead, _ = j_build_head(dict(narrow_head_cfg(jc, feat)))
    levels = levels_of(pcfg.strides)
    feats = level_feats(levels, feat, seed=3 + seed)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = {
        "init": jax.tree.map(np.asarray, jhead.init(
            jax.random.PRNGKey(seed), [f[:1] for f in jfeats])),
        "minted": mint_variables(jhead, [f[:1] for f in jfeats],
                                 seed=11 + seed)}
    batches = {"gt": gt_batch(HW, C, seed=4 + seed),
               "empty": gt_batch(HW, C, seed=4 + seed, empty=True)}
    tkw = dict(TEST_KW, num_classes=pcfg.num_classes)
    rand = random_outputs(kind, levels, channels, 5 + seed)
    jres = run_jax_cases(kind, jhead, jcfg, JTestConfig(**tkw), feats,
                         batches, variables, rand)
    pres = run_port_cases(head_cfg, pcfg, feats, batches, variables)
    return jres, pres, pcfg, TestConfig(**tkw), rand


# Leaves whose gradient gets its own absolute floor. FCOS's first cls-tower
# conv kernel comes back through GroupNorm's mean-subtracting backward,
# which cancels most of its terms: it differs by 1.04e-5 at a largest
# entry of 0.032 (3.3e-4 of it) from the JAX training init.
GRAD_LEAF_ABS = {"fcos": {"['_Tower_0']['cls_conv0']['kernel']": 2e-5}}


def check_case(jres, pres, out_keys, terms, leaf_abs=None):
    """The maps, the loss and its terms, and every parameter's gradient
    of each (weights, batch) pair; ``leaf_abs`` as ``grads_close``'s."""
    for key, want in jres.items():
        got = pres[key]
        for k in out_keys:
            assert len(got["outs"][k]) == len(want["outs"][k]) == 5
            for g, w_ in zip(got["outs"][k], want["outs"][k]):
                assert tuple(g.shape) == w_.shape, (key, k)
                assert_close(g, w_, rel=1e-4)
        assert set(got["terms"]) == set(want["terms"]) == terms
        _rel(got["total"], want["total"])
        for k, v in got["terms"].items():
            _rel(v, want["terms"][k])
        grads_close(got["grads"], want["grads"], leaf_abs=leaf_abs)
        if key[1] == "gt":
            assert float(got["total"].detach()) > 0


def check_decode(kind, jres, rand, pcfg, tcfg):
    want = jres["minted", "gt"]["det"]
    outs = {k: [t(x) for x in v] for k, v in rand.items()}
    got = pdd.dense_decode(outs, t(DECODE_IN["shapes"]),
                           t(DECODE_IN["sfs"]), tcfg, pcfg)
    valid = want["valid"]
    assert valid.sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), want["labels"])
    np.testing.assert_allclose(got.bboxes.numpy(), want["bboxes"], atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), want["scores"],
                               atol=1e-5)
    assert not got.landmarks.any()


CHANNELS = {"retina": {"cls": 9 * C, "reg": 36},
            "fcos": {"cls": C, "reg": 4, "centerness": 1},
            "atss": {"cls": C, "reg": 4, "centerness": 1},
            "gfl": {"cls": C, "reg": 68}}


@pytest.fixture(scope="module")
def cases():
    return {kind: head_case(kind, lambda pkg, k=kind: file_cfg(k, pkg),
                            CHANNELS[kind], seed=i)
            for i, kind in enumerate(FILES)}


@pytest.mark.parametrize("kind", sorted(FILES))
def test_head_loss_and_gradients_match_jax(cases, kind):
    """From the JAX training init and from minted weights, with GT and
    with none."""
    jres, pres, *_ = cases[kind]
    check_case(jres, pres, OUT_KEYS[kind], TERMS[kind],
               GRAD_LEAF_ABS.get(kind))
    if kind == "fcos":
        assert min(float(m.detach().min()) for m in
                   pres["minted", "gt"]["outs"]["reg"]) > 0
    if kind != "retina":
        # the per-level scales take gradients
        assert np.abs(jres["minted", "gt"]["grads"]["scales"]).max() > 0


@pytest.mark.parametrize("kind", sorted(FILES))
def test_decode_matches_jax(cases, kind):
    jres, _, pcfg, tcfg, rand = cases[kind]
    check_decode(kind, jres, rand, pcfg, tcfg)


@pytest.mark.parametrize("kind", sorted(FILES))
def test_file_settings_match_the_jax_runner(kind):
    """``dense_cfg_from`` and ``test_cfg_from`` of each file against the
    JAX runner's, field by field; JAX's ``dense_cfg_from`` raises on the
    FCOS file's ``assigner=None``, which the port reads as no settings
    (the JAX defaults, checked on a copy whose assigner is {})."""
    pc, jc = file_cfg(kind), file_cfg(kind, JConfig)
    got = ploop.dense_cfg_from(pc, (800, 1344))
    if kind == "fcos":
        with pytest.raises(AttributeError):
            jloop.dense_cfg_from(jc, (800, 1344))
        jc.merge_from_dict({"train_cfg.assigner": {}})
    want = jloop.dense_cfg_from(jc, (800, 1344))
    for f in dataclasses.fields(got):
        w_ = getattr(want, f.name)
        g = getattr(got, f.name)
        if f.name == "anchor":
            g, w_ = dataclasses.asdict(g), dataclasses.asdict(w_)
        assert g == w_, f.name
    wt, gt_ = jloop.test_cfg_from(jc, (800, 1344)), \
        ploop.test_cfg_from(pc, (800, 1344))
    for f in dataclasses.fields(gt_):
        assert getattr(gt_, f.name) == getattr(wt, f.name), f.name


def test_weights_bridge_carries_the_scales():
    """``scales`` in both directions through ``from_jax_variables`` /
    ``to_jax_variables``."""
    pc, jc = file_cfg("gfl"), file_cfg("gfl", JConfig)
    jhead, _ = j_build_head(dict(narrow_head_cfg(jc)))
    feats = [jnp.zeros((1, h, w, 32)) for h, w in levels_of(
        (8, 16, 32, 64, 128))]
    v = mint_variables(jhead, feats, seed=2)
    assert v["params"]["scales"].shape == (5,)
    head = build_head(narrow_head_cfg(pc))
    load_jax_variables(head, v)
    np.testing.assert_array_equal(head.scales.detach().numpy(),
                                  v["params"]["scales"])
    back = to_jax_variables(head)["params"]
    assert jax.tree.structure(back) == jax.tree.structure(v["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v["params"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(FILES))
def test_training_init_matches_the_jax_init(kind):
    """The port's ``init_weights_`` against the JAX ``module.init`` of the
    same head (feat 64): every bias and ``scales`` equal (the focal prior
    on the classifier, 0 elsewhere, 1), GroupNorm scale 1, each kernel's
    spread N(0, 0.01) within 15 %."""
    pc, jc = file_cfg(kind), file_cfg(kind, JConfig)
    jhead, _ = j_build_head(dict(narrow_head_cfg(jc, 64)))
    feats = [jnp.zeros((1, h, w, 64)) for h, w in levels_of(
        (8, 16, 32, 64, 128))]
    want = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(0),
                                               feats))["params"]
    head = build_head(narrow_head_cfg(pc, 64))
    init_weights_(head, torch.Generator().manual_seed(0))
    got = to_jax_variables(head)["params"]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w_ in flat_w.items():
        g = flat_g[path]
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            assert abs(g.std() / 0.01 - 1) < 0.15, path
        else:
            np.testing.assert_array_equal(g, w_)
    prior = want[f"{kind}_cls"]["bias"]
    assert np.allclose(prior, -np.log(99.0))


# ------------------------------------------------------------ runner, API

RUN_HW = (64, 96)


def narrow_options(root):
    """Config overrides: R18, feat 64 (GroupNorm(32) refuses a one-value
    group on a 1x1 level in a batch of one), two stacked convs, 3
    classes, the procedural set at 64x96, one epoch, an eval at its
    end."""
    ann = os.path.join(root, "ann.json")
    img = os.path.join(root, "imgs")
    return {
        "model.pretrained": None,
        "model.backbone.depth": 18, "model.backbone.frozen_stages": -1,
        "model.neck.in_channels": [64, 128, 256, 512],
        "model.neck.out_channels": 64,
        "data.samples_per_gpu": 2,
        "data.train.ann_file": ann, "data.train.img_prefix": img,
        "data.train.img_scale": (96, 64),
        "data.val.ann_file": ann, "data.val.img_prefix": img,
        "data.val.img_scale": (96, 64), "data.test.img_scale": (96, 64),
        "canvas_shape": RUN_HW, "log_interval": 1, "total_epochs": 1,
        "checkpoint_config": dict(interval=100), "eval_max_images": 2,
        "lr_config": dict(warmup_iters=1, step=[1]),
        "test_cfg.score_thr": 0.0}


def narrow_file(path, root):
    cfg = Config.fromfile(path)
    cfg.merge_from_dict(narrow_options(root))
    head = ploop.head_cfg(cfg)
    head.update(in_channels=64, feat_channels=64)
    for k, v in (("stacked_convs", 2), ("num_classes", C)):
        if k in head:
            head[k] = v
    return cfg


@pytest.fixture(scope="module")
def shapes_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dense_shapes"))
    make_shapes_coco(root, 4, seed=5, hw=RUN_HW)
    return root


def run_file(path, root, work, terms, **options):
    """One narrow step and an evaluation of the file through the runner
    (``options`` override the config further); -> (config, the trained
    model)."""
    cfg = narrow_file(path, root)
    cfg.merge_from_dict(options)
    res = ploop.train_detector(cfg, work, max_iters_per_epoch=1,
                               device="cpu")
    assert res["step"] == 1
    (log,) = glob.glob(os.path.join(work, "*.log.json"))
    with open(log) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["mode"] == "train"]
    val = [r for r in records if r["mode"] == "val"]
    assert len(train) == 1 and len(val) == 1
    assert terms <= set(train[0])
    assert all(np.isfinite(train[0][k]) for k in terms | {"loss"})
    assert "bbox_mAP" in val[0]
    return cfg, res["model"]


@pytest.mark.parametrize("kind", sorted(FILES))
def test_runner_step_and_eval(shapes_set, tmp_path, kind):
    cfg, model = run_file(os.path.join(REPO, "configs", FILES[kind]),
                          shapes_set, str(tmp_path / "work"), TERMS[kind])
    assert type(model.head).__name__ == ploop.head_cfg(cfg).type
    assert isinstance(ploop.train_loss_cfg(cfg, RUN_HW), pdl.DenseLossConfig)


def test_api_serves_a_retinanet_bundle(shapes_set):
    """``init_detector`` / ``inference_detector`` / ``aug_test`` on the
    narrow RetinaNet file (the CPU, seeded weights)."""
    cfg = narrow_file(os.path.join(REPO, "configs", FILES["retina"]),
                      shapes_set)
    bundle = apis.init_detector(cfg, device="cpu")
    apis.random_weights_(bundle.model, 0)
    img = (np.random.RandomState(0).rand(48, 80, 3) * 255).astype(np.uint8)
    res = apis.inference_detector(bundle, img)
    again = apis.inference_detector(bundle, img)
    n = len(res["scores"])
    assert n > 0 and res["landmarks"].shape == (n, 8)
    assert not res["landmarks"].any()
    np.testing.assert_array_equal(res["bboxes"], again["bboxes"])
    assert (res["bboxes"][:, 2] <= 80 + 1e-3).all()
    aug = apis.aug_test(bundle, img, scales=[(96, 64)], flip=True)
    assert len(aug["scores"]) > 0
    with pytest.raises(NotImplementedError, match="use aug_test"):
        apis.aug_test_simple(bundle, img)


@pytest.mark.parametrize("kind", ["retina", "fcos", "gfl"])
def test_tables_made_in_inference_mode_train(kind):
    """The anchor grid and the FCOS points are built once per canvas and
    kept: a decode under ``torch.inference_mode`` on a new canvas first,
    then a loss's backward on the same canvas (the order of a runner that
    evaluates before it trains, or of ``detect`` then a train step)."""
    hw = (40, 72)
    pc = file_cfg(kind)
    head = build_head(narrow_head_cfg(pc))
    pcfg = dataclasses.replace(ploop.dense_cfg_from(pc, hw), num_classes=C)
    feats = [t(f).permute(0, 3, 1, 2)
             for f in level_feats(levels_of(pcfg.strides, hw), 32)]
    tcfg = TestConfig(**dict(TEST_KW, image_shape=hw))
    with torch.inference_mode():
        pdd.dense_decode(head(feats), t(DECODE_IN["shapes"]),
                         t(DECODE_IN["sfs"]), tcfg, pcfg)
    total, _ = pdl.dense_loss(head(feats), {k: t(a) for k, a in gt_batch(
        hw, C).items()}, pcfg)
    total.backward()
    assert all(p.grad is not None for p in head.parameters())
