"""The dense zoo's second slice in the port against the JAX package, on the
CPU: FoveaBox, FSAF, FreeAnchor, PISA RetinaNet, SSD, PISA SSD and
RetinaSepBN heads with their losses and decodes, SSDVGG, the NAS-FCOS FPN,
and the seven shipped files through the runner.

Inputs are made with numpy from seeds; the helpers are those of
``test_torch_dense_heads.py``. Tolerances, each stated at its check:

* each head from the shipped file's head config at a narrow width (two
  stacked convs, 32 channels, 3 classes; SSD's six levels 32 wide on the
  300x300 canvas, the others on FPN levels of a 64x96 canvas; SepBN from
  a config dict), from the JAX training init and from minted weights,
  with GT and with none: the head maps 1e-4 of max(1, max|ref|), the
  loss and its terms 1e-5 relative, every parameter's gradient within
  1e-4 of its largest entry or 1e-5 absolute (``grads_close``);
* each decode on random head-shaped outputs: the valid mask and the labels
  equal, boxes 1e-3 absolute, scores 1e-5;
* the ties: FreeAnchor's bags on a grid where a small GT overlaps fewer
  anchors than a bag holds (IoU-0 ties), SSD's and PISA-SSD's hard-negative
  mining on equal logits, ``_rank_in_groups`` on equal keys: loss and
  gradients as above, ranks equal;
* SSDVGG at 300x300 (B = 1; VGG-16's widths are fixed) from the JAX init:
  its six maps 1e-4 of max(1, max|ref|), the gradient of
  ``l2_norm_scale_param`` as ``grads_close`` (every gradient in float64,
  marked ``slow``: in f32 the early convs' differ by up to about 2 %,
  ``test_ssdvgg_matches_jax`` says why); NASFCOSFPN on inputs where its
  bilinear resize shrinks (2x, and 10x15 -> 5x8), with GroupNorm cells,
  outputs and every gradient as above;
* the training init against the JAX init (RBG keys: the same flax
  initializers, compiled faster): biases, ``scales``,
  ``l2_norm_scale_param`` and norms equal, each kernel's spread within
  15 % of the JAX init's;
* every module loads the JAX variables strictly
  (``weights.load_jax_variables``: a missing, unused or misshapen entry
  raises);
* the files' settings against the JAX runner's field by field, and each
  file through ``tools.train`` (one narrow step) and ``tools.test``; the
  SSD file through ``init_detector`` / ``inference_detector``.

Each kind's JAX forward, loss, gradients and decode run in one compiled
function, called four times (two weight sets, two batches).
"""

import dataclasses
import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core import dense_decode as jdd
from lsnet_tpu.core import dense_loss as jdl
from lsnet_tpu.core.decode import TestConfig as JTestConfig
from lsnet_tpu.models import build_head as j_build_head
from lsnet_tpu.models.backbones.extra import SSDVGG as JSSDVGG
from lsnet_tpu.models.necks.extra import NASFCOSFPN as JNASFCOSFPN
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch import apis
from lsnet_torch.core import dense_decode as pdd, dense_loss as pdl
from lsnet_torch.core.decode import TestConfig
from lsnet_torch.models import build_head, head_cfg_of
from lsnet_torch.models.backbones.extra import SSDVGG
from lsnet_torch.models.init import init_weights_
from lsnet_torch.models.necks.extra import NASFCOSFPN
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING
from lsnet_torch.tools import test as test_tool
from lsnet_torch.tools import train as train_tool
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import loop as ploop
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import load_jax_variables, to_jax_variables
from test_torch_dense_heads import (C, REPO, _rel, jax_loss_cfg,
                                    narrow_options)
from torch_port_util import (assert_close, grads_close, gt_batch,
                             level_feats, mint_variables, t)

torch.set_num_threads(1)

HW = (64, 96)
SSD_HW = (300, 300)
FEAT = 32
FILES = {"fovea": "foveabox/fovea_r50_fpn_4x4_1x_coco.py",
         "fsaf": "fsaf/fsaf_r50_fpn_1x_coco.py",
         "free_anchor": "free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py",
         "pisa_retina": "pisa/pisa_retinanet_r50_fpn_1x_coco.py",
         "ssd": "ssd/ssd300_coco.py",
         "pisa_ssd": "pisa/pisa_ssd300_coco.py",
         "nas_fcos": "nas_fcos/nas_fcos_fcoshead_r50_fpn_1x_coco.py"}
SSD_KINDS = ("ssd", "pisa_ssd")
# RetinaSepBNHead ships in no file: the NAS-FPN recipes' head config
SEPBN_HEAD = dict(
    type="RetinaSepBNHead", num_classes=80, num_ins=5, in_channels=256,
    stacked_convs=4, feat_channels=256, norm_cfg=dict(type="BN"),
    anchor_generator=dict(type="AnchorGenerator", octave_base_scale=4,
                          scales_per_octave=3, ratios=[0.5, 1.0, 2.0],
                          strides=[8, 16, 32, 64, 128]),
    loss_cls=dict(type="FocalLoss", use_sigmoid=True, gamma=2.0, alpha=0.25,
                  loss_weight=1.0),
    loss_bbox=dict(type="L1Loss", loss_weight=1.0))
HEAD_KINDS = ("fovea", "fsaf", "free_anchor", "pisa_retina", "ssd",
              "pisa_ssd", "sepbn")
TERMS = {"fovea": {"loss_cls", "loss_bbox"},
         "fsaf": {"loss_cls", "loss_bbox"},
         "free_anchor": {"positive_bag_loss", "negative_bag_loss"},
         "pisa_retina": {"loss_cls", "loss_bbox", "loss_carl"},
         "ssd": {"loss_cls", "loss_bbox"},
         "pisa_ssd": {"loss_cls", "loss_bbox", "loss_carl"},
         "sepbn": {"loss_cls", "loss_bbox"},
         "nas_fcos": {"loss_cls", "loss_bbox", "loss_centerness"}}
SSD_ANCHORS = (4, 6, 6, 6, 4, 4)
TEST_KW = dict(num_classes=C, nms_pre=1000, score_thr=0.05, nms_iou=0.5,
               max_per_img=100)
# XLA's CPU compile of the parity functions at its lowest optimisation
# (the same operations, compiled in about half the time)
QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def init_key(seed):
    """The JAX init's key: the RBG generator, whose draws compile in half
    the time of threefry's (the flax initializers are the same)."""
    return jax.random.key(seed, impl="rbg")


def file_cfg(kind, package=Config):
    return package.fromfile(os.path.join(REPO, "configs", FILES[kind]))


def head_cfg(kind, package=Config, feat=FEAT):
    """The kind's head config at a narrow width: ``feat`` channels (SSD:
    each level ``feat`` wide), two stacked convs, C classes."""
    head = dict(SEPBN_HEAD if kind == "sepbn" else
                head_cfg_of(file_cfg(kind, package).to_dict()["model"]))
    if kind in SSD_KINDS:
        head["in_channels"] = (feat,) * 6
    else:
        head.update(in_channels=feat, feat_channels=feat, stacked_convs=2)
    head["num_classes"] = C
    return head


def loss_cfg(kind):
    """The port's loss config of the kind on its canvas (SepBN: RetinaNet's
    defaults)."""
    if kind == "sepbn":
        return pdl.DenseLossConfig(image_shape=HW, num_classes=C)
    return dataclasses.replace(ploop.dense_cfg_from(
        file_cfg(kind), SSD_HW if kind in SSD_KINDS else HW), num_classes=C)


def levels_of(cfg):
    return [(-(-cfg.image_shape[0] // s), -(-cfg.image_shape[1] // s))
            for s in cfg.strides]


def channels_of(kind, key):
    """Each level's width of the kind's output ``key``."""
    if kind in SSD_KINDS:
        return [a * (C + 1 if key == "cls" else 4) for a in SSD_ANCHORS]
    A = {"fsaf": 1, "fovea": 1}.get(kind, 9)
    return [A * (C if key == "cls" else 4)] * 5


def random_outputs(kind, levels, seed):
    """Head-shaped outputs with many candidates on every level."""
    rng = np.random.RandomState(seed)
    outs = {}
    for key in ("cls", "reg"):
        outs[key] = [(rng.randn(2, h, w, d) * (1.0 if key == "cls" else 0.5)
                      + (1.5 if key == "cls" and kind not in SSD_KINDS
                         else 0.0)).astype(np.float32)
                     for (h, w), d in zip(levels, channels_of(kind, key))]
    return outs


def decode_in(hw):
    return dict(shapes=np.array([[hw[0], hw[1]], [hw[0] - 10, hw[1] - 20]],
                                np.int32),
                sfs=np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]],
                             np.float32))


def run_jax(jhead, jcfg, jtcfg, feats, batches, variables, rand, din):
    """One compiled function: forward, loss, gradients and decode; called
    for every (weights, batch) pair."""
    def run(v, batch, rand_outs, shapes, sfs):
        rest = {k: x for k, x in v.items() if k != "params"}

        def f(p):
            outs = jhead.apply({"params": p, **rest},
                               [jnp.asarray(x) for x in feats])
            total, terms = jdl.dense_loss(outs, batch, jcfg)
            return total, (terms, outs)

        (total, (terms, outs)), grads = jax.value_and_grad(
            f, has_aux=True)(v["params"])
        det = jdd.dense_decode(rand_outs, shapes, sfs, jtcfg, jcfg)
        return dict(total=total, terms=terms, outs=outs, grads=grads,
                    det=det._asdict())

    fn = jax.jit(run, compiler_options=QUICK_COMPILE)
    return {(w, b): jax.tree.map(np.asarray, fn(
        jax.tree.map(jnp.asarray, v), jax.tree.map(jnp.asarray, batch),
        jax.tree.map(jnp.asarray, rand), jnp.asarray(din["shapes"]),
        jnp.asarray(din["sfs"])))
        for w, v in variables.items() for b, batch in batches.items()}


def run_port(head_c, pcfg, feats, batches, variables):
    res = {}
    for w, v in variables.items():
        for b, batch in batches.items():
            head = build_head(head_c)
            load_jax_variables(head, v)
            outs = head([t(f).permute(0, 3, 1, 2) for f in feats],
                        TRAIN_SAMPLING)
            total, terms = pdl.dense_loss(
                outs, {k: t(a) for k, a in batch.items()}, pcfg)
            total.backward()
            grads = to_jax_variables(head, {n: p.grad for n, p in
                                            head.named_parameters()})
            res[w, b] = dict(total=total, terms=terms, outs=outs,
                             grads=grads["params"])
    return res


def zoo_case(kind, seed):
    pcfg = loss_cfg(kind)
    jcfg = jax_loss_cfg(pcfg)
    hw = pcfg.image_shape
    jhead, _ = j_build_head(head_cfg(kind, JConfig))
    levels = levels_of(pcfg)
    feats = level_feats(levels, FEAT, seed=3 + seed)
    small = [jnp.asarray(f[:1]) for f in feats]
    variables = {
        "init": jax.tree.map(np.asarray, jax.jit(jhead.init)(
            init_key(seed), small)),
        "minted": mint_variables(jhead, small, seed=11 + seed)}
    batches = {"gt": gt_batch(hw, C, seed=4 + seed),
               "empty": gt_batch(hw, C, seed=4 + seed, empty=True)}
    tkw = dict(TEST_KW, image_shape=hw)
    rand = random_outputs(kind, levels, 5 + seed)
    din = decode_in(hw)
    jres = run_jax(jhead, jcfg, JTestConfig(**tkw), feats, batches,
                   variables, rand, din)
    pres = run_port(head_cfg(kind), pcfg, feats, batches, variables)
    return jres, pres, pcfg, TestConfig(**tkw), rand, din, variables["init"]


@pytest.fixture(scope="module", params=HEAD_KINDS)
def case(request):
    """One kind's results of both packages (one JAX compile a kind)."""
    kind = request.param
    return (kind,) + zoo_case(kind, seed=20 + HEAD_KINDS.index(kind))


def test_head_loss_and_gradients_match_jax(case):
    """From the JAX training init and from minted weights, with GT and
    with none."""
    kind, jres, pres, pcfg, *_ = case
    n_levels = len(pcfg.strides)
    for key, want in jres.items():
        got = pres[key]
        for k in ("cls", "reg"):
            assert len(got["outs"][k]) == len(want["outs"][k]) == n_levels
            for g, w_ in zip(got["outs"][k], want["outs"][k]):
                assert tuple(g.shape) == w_.shape, (key, k)
                assert_close(g, w_, rel=1e-4)
        assert set(got["terms"]) == set(want["terms"]) == TERMS[kind]
        _rel(got["total"], want["total"], rel=1e-5)
        for k, v in got["terms"].items():
            _rel(v, want["terms"][k], rel=1e-5)
        grads_close(got["grads"], want["grads"])
        if key[1] == "gt":
            assert float(got["total"].detach()) > 0
            assert all(float(v.detach()) > 0
                       for v in got["terms"].values()), (
                key, got["terms"])
    if kind == "fsaf":
        # the ReLU'd distances
        assert min(float(m.detach().min()) for m in
                   pres["minted", "gt"]["outs"]["reg"]) >= 0


def test_decode_matches_jax(case):
    """The valid mask and the labels equal, boxes 1e-3 absolute, scores
    1e-5."""
    _, jres, _, pcfg, tcfg, rand, din, _ = case
    want = jres["minted", "gt"]["det"]
    got = pdd.dense_decode({k: [t(x) for x in v] for k, v in rand.items()},
                           t(din["shapes"]), t(din["sfs"]), tcfg, pcfg)
    assert want["valid"].sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), want["valid"])
    np.testing.assert_array_equal(got.labels.numpy(), want["labels"])
    np.testing.assert_allclose(got.bboxes.numpy(), want["bboxes"],
                               atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), want["scores"],
                               atol=1e-5)
    assert not got.landmarks.any()


# ------------------------------------------------------------ ties

def _loss_on_outputs(pcfg, outs, batch):
    """Both packages' loss, terms and gradient of each output map."""
    jcfg = jax_loss_cfg(pcfg)

    def jf(o):
        total, terms = jdl.dense_loss(o, jax.tree.map(jnp.asarray, batch),
                                      jcfg)
        return total, terms

    (jtotal, jterms), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jax.tree.map(jnp.asarray, outs))
    touts = {k: [t(m).requires_grad_() for m in v] for k, v in outs.items()}
    total, terms = pdl.dense_loss(touts, {k: t(a) for k, a in batch.items()},
                                  pcfg)
    total.backward()
    _rel(total, jtotal, rel=1e-5)
    assert set(terms) == set(jterms)
    for k, v in terms.items():
        _rel(v, jterms[k], rel=1e-5)
    for k, maps in touts.items():
        for g, w_ in zip(maps, jg[k]):
            w_ = np.asarray(w_)
            assert np.abs(g.grad.numpy() - w_).max() <= max(
                1e-4 * np.abs(w_).max(), 1e-5), k
    return total, terms


def test_free_anchor_bags_with_iou_ties():
    """One 8-px anchor a cell at stride 8 on a 64x96 canvas: a 5-px GT
    overlaps 4 anchors, so its bag of 50 holds 46 at IoU 0, taken lowest
    index first (``jax.lax.top_k``'s order; the port sorts stably)."""
    from lsnet_torch.core.anchors import AnchorConfig
    pcfg = pdl.DenseLossConfig(
        image_shape=HW, num_classes=C, head="free_anchor", strides=(8,),
        anchor=AnchorConfig(strides=(8,), ratios=(1.0,),
                            octave_base_scale=1.0, scales_per_octave=1))
    rng = np.random.RandomState(3)
    outs = {"cls": [rng.randn(2, 8, 12, C).astype(np.float32)],
            "reg": [(0.3 * rng.randn(2, 8, 12, 4)).astype(np.float32)]}
    batch = gt_batch(HW, C, seed=9)
    batch["gt_bboxes"][:, 0] = [[21.0, 13.0, 26.0, 18.0],
                                [60.0, 30.0, 65.0, 34.0]]
    anchors = pdl._grid(pcfg.anchor, pcfg, "cpu")[0]
    from lsnet_torch.ops.nms import box_iou
    overlap = (box_iou(t(batch["gt_bboxes"][:, :1]), anchors[None]) > 0).sum(
        -1)
    assert 0 < overlap.max() < pdl.FREE_ANCHOR_TOPK
    _loss_on_outputs(pcfg, outs, batch)


@pytest.mark.parametrize("kind", SSD_KINDS)
def test_ssd_mining_with_equal_logits(kind):
    """Every logit 0 on five of the six levels: their negatives tie at the
    k-th mined CE and all are kept (``>=``), as JAX's rule keeps them."""
    pcfg = loss_cfg(kind)
    levels = levels_of(pcfg)
    outs = random_outputs(kind, levels, 31)
    for m in outs["cls"][1:]:
        m[:] = 0.0
    total, terms = _loss_on_outputs(pcfg, outs, gt_batch(SSD_HW, C, seed=6))
    assert float(terms["loss_cls"].detach()) > 0


def test_rank_in_groups_matches_jax():
    """Descending ranks within groups, equal keys ranked by index, the
    invalid rows in a group of their own."""
    rng = np.random.RandomState(2)
    keys = rng.randint(0, 4, (3, 40)).astype(np.float32) / 4
    groups = rng.randint(0, 5, (3, 40)).astype(np.int32)
    valid = rng.rand(3, 40) > 0.2
    got = pdl._rank_in_groups(t(keys), t(groups), t(valid))
    want = jax.jit(jax.vmap(jdl._rank_in_groups))(keys, groups, valid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ SSDVGG, NAS

def _spreads_and_constants(got, want):
    """Biases, scales and statistics equal; each kernel's spread within
    15 % of the JAX init's."""
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w_ in flat_w.items():
        g = flat_g[path]
        if jax.tree_util.keystr(path).endswith("['kernel']"):
            assert abs(g.std() / w_.std() - 1) < 0.15, path
        else:
            np.testing.assert_array_equal(g, w_, err_msg=str(path))


def _module_case(jmod, pmod, args, seed, init, only=None, x64=False):
    """A module's outputs and the gradient of every parameter (or of the
    top-level entries ``only`` names) of a random projection of them, both
    packages, from the JAX init (``init``) or minted weights; ``args``
    NHWC arrays or lists of them; with ``x64`` both run in float64 (JAX
    from its f32 init). Outputs 1e-4 of max(1, max|ref|), gradients as
    ``grads_close``. -> (the JAX variables, the JAX outputs)."""
    jargs = jax.tree.map(jnp.asarray, args)
    if init:
        variables = jax.tree.map(np.asarray, jax.jit(jmod.init)(
            init_key(seed), *jargs))
    else:
        variables = mint_variables(jmod, *jargs, seed=seed)
    dt = np.float64 if x64 else np.float32
    shapes = jax.eval_shape(lambda: jmod.apply(variables, *jargs))
    rng = np.random.RandomState(seed)
    probe = [rng.randn(*s.shape).astype(dt) for s in shapes]
    rest = {k: v for k, v in variables.items() if k != "params"}
    with jax.enable_x64(x64):
        cast = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, dt))

        def f(p):
            outs = jmod.apply({"params": p, **cast(rest)}, *cast(args))
            return sum(jnp.sum(o * q) for o, q in zip(outs, probe)), outs

        (_, want), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
            cast(variables["params"]))
        want, jg = jax.tree.map(np.asarray, (want, jg))
    load_jax_variables(pmod, variables)
    pmod.to(torch.float64 if x64 else torch.float32)
    got = pmod(*jax.tree.map(lambda x: t(x.astype(dt)).permute(0, 3, 1, 2),
                             args))
    sum((o * t(q).permute(0, 3, 1, 2)).sum()
        for o, q in zip(got, probe)).backward()
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1), w_, rel=1e-4)
    grads = to_jax_variables(pmod, {n: p.grad for n, p in
                                    pmod.named_parameters()})["params"]
    if only is not None:
        grads = {k: grads[k] for k in only}
        jg = {k: jg[k] for k in only}
    grads_close(grads, jg)
    return variables, want


def test_ssdvgg_matches_jax():
    """300x300, B = 1, from the JAX init: the six maps at 38, 19, 10, 5, 3
    and 1 px (conv4_3's L2-normalised and scaled) 1e-4 of max(1,
    max|ref|), and the gradient of ``l2_norm_scale_param``. The convs'
    f32 gradients differ by up to 2 % of their norm: at init a few ReLU
    and max-pool decisions in maps of up to 5.8 M values fall the other
    way of a rounding, and conv4_3's L2 norm divides by small norms;
    ``test_ssdvgg_gradients_in_float64`` holds every gradient. The port's
    training init against that JAX init: LeCun normal kernels,
    ``l2_norm_scale_param`` 20, biases 0."""
    img = np.random.RandomState(0).randn(1, 300, 300, 3).astype(np.float32)
    pmod = SSDVGG()
    variables, want = _module_case(JSSDVGG(), pmod, (img,), 0, init=True,
                                   only=("l2_norm_scale_param",))
    assert [w_.shape[1] for w_ in want] == [38, 19, 10, 5, 3, 1]
    assert pmod.l2_norm_scale_param.grad.abs().max() > 0
    init = init_weights_(SSDVGG(), torch.Generator().manual_seed(0))
    _spreads_and_constants(to_jax_variables(init)["params"],
                           variables["params"])


@pytest.mark.slow
def test_ssdvgg_gradients_in_float64():
    """SSDVGG's gradients in float64 on both sides, from the JAX init at
    300x300 (XLA's float64 convolutions on the CPU take minutes): every
    parameter's as ``grads_close``."""
    img = np.random.RandomState(0).randn(1, 300, 300, 3)
    _module_case(JSSDVGG(), SSDVGG(), (img,), 0, init=True, x64=True)


NAS_SIZES = {"halving": [(16, 24), (8, 12), (4, 6), (2, 3)],
             "odd": [(20, 30), (10, 15), (5, 8), (3, 4)]}


@pytest.mark.parametrize("sizes", sorted(NAS_SIZES))
def test_nasfcos_fpn_matches_jax(sizes):
    """Inputs at strides 4 to 32 (start_level 1 reads the last three),
    GroupNorm(8) cells, 16 channels, minted weights: the c36 branch's sum
    shrinks from C3's size to C4's through the antialiased bilinear resize
    (exactly 2x, and 10x15 -> 5x8)."""
    rng = np.random.RandomState(1)
    widths = (8, 16, 24, 32)
    xs = [rng.randn(2, h, w, c).astype(np.float32)
          for (h, w), c in zip(NAS_SIZES[sizes], widths)]
    norm = dict(type="GN", num_groups=8)
    jmod = JNASFCOSFPN(out_channels=16, num_outs=5, start_level=1,
                       norm_cfg=norm)
    pmod = NASFCOSFPN(widths, out_channels=16, num_outs=5, start_level=1,
                      norm_cfg=norm)
    _, want = _module_case(jmod, pmod, (xs,), 2, init=False)
    assert [w_.shape[1:3] for w_ in want[:3]] == NAS_SIZES[sizes][1:]


def test_nasfcos_bilinear_shrink_is_antialiased():
    """The plain bilinear resize would miss JAX's shrink by far: the
    antialiased one meets it at 1e-6."""
    from lsnet_torch.models.necks.extra import bilinear_to
    x = np.random.RandomState(4).randn(1, 10, 16, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 5, 8, 3),
                                       method="bilinear"))
    tx = t(x).permute(0, 3, 1, 2)
    got = bilinear_to(tx, 5, 8).permute(0, 2, 3, 1)
    assert_close(got, want, rel=1e-6)
    plain = torch.nn.functional.interpolate(tx, size=(5, 8),
                                            mode="bilinear")
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 0.05


# ------------------------------------------------------------ init, weights

def test_training_init_matches_the_jax_init(case):
    """The port's ``init_weights_`` against the JAX ``module.init`` of the
    same head (the parity case's init): the focal prior on the sigmoid
    classifiers (SSD's softmax one starts at 0), FSAF's 0.25 regression
    bias, FrozenBatchNorm and GroupNorm at 1 / 0, kernels N(0, 0.01)."""
    kind, want = case[0], case[-1]
    head = build_head(head_cfg(kind))
    init_weights_(head, torch.Generator().manual_seed(0))
    got = to_jax_variables(head)
    for coll in want:
        _spreads_and_constants(got[coll], want[coll])
    if kind == "fsaf":
        assert np.all(got["params"]["retina_reg"]["bias"] == 0.25)
    if kind == "fovea":
        assert np.allclose(got["params"]["fovea_cls"]["bias"],
                           -np.log(99.0))


def test_nasfcos_fpn_init_matches_the_jax_init():
    """NASFCOSFPN at 128 channels: LeCun normal bare convs, He normal
    ConvModules, GroupNorm and FrozenBatchNorm at 1 / 0, against the JAX
    init."""
    widths = (64, 128, 256, 512)
    xs = [jnp.zeros((1, s, s, c)) for s, c in zip((16, 8, 4, 2), widths)]
    norm = dict(type="GN", num_groups=32)
    nas = jax.jit(JNASFCOSFPN(out_channels=128, norm_cfg=norm).init)(
        init_key(0), xs)
    pnas = init_weights_(NASFCOSFPN(widths, out_channels=128, norm_cfg=norm),
                         torch.Generator().manual_seed(0))
    got = to_jax_variables(pnas)
    for coll in nas:
        _spreads_and_constants(got[coll], jax.tree.map(np.asarray,
                                                       nas[coll]))


# ------------------------------------------------------------ runner

@pytest.mark.parametrize("name", sorted(FILES))
def test_file_settings_match_the_jax_runner(name):
    """``dense_cfg_from`` and ``test_cfg_from`` of each file against the
    JAX runner's, field by field (NAS-FCOS inherits FCOS's
    ``assigner=None``, on which the JAX function raises: compared on a
    copy whose assigner is {})."""
    pc, jc = file_cfg(name), file_cfg(name, JConfig)
    canvas = SSD_HW if name in SSD_KINDS else (800, 1344)
    got = ploop.dense_cfg_from(pc, canvas)
    if name == "nas_fcos":
        with pytest.raises(AttributeError):
            jloop.dense_cfg_from(jc, canvas)
        jc.merge_from_dict({"train_cfg.assigner": {}})
    want = jloop.dense_cfg_from(jc, canvas)
    for f in dataclasses.fields(got):
        g, w_ = getattr(got, f.name), getattr(want, f.name)
        if f.name == "anchor":
            g, w_ = dataclasses.asdict(g), dataclasses.asdict(w_)
        assert g == w_, f.name
    wt, gt_ = jloop.test_cfg_from(jc, canvas), ploop.test_cfg_from(pc, canvas)
    for f in dataclasses.fields(gt_):
        assert getattr(gt_, f.name) == getattr(wt, f.name), f.name


def runner_options(name, root):
    """``--options`` of a narrow run: the FPN files on R18 with a 64-wide
    neck and head, two stacked convs (``narrow_options``); the SSD files
    on their own VGG-16 at 300x300, B = 1; 3 classes either way."""
    if name in SSD_KINDS:
        ann, img = os.path.join(root, "ann.json"), os.path.join(root, "imgs")
        opts = {"data.samples_per_gpu": 1,
                "data.train.ann_file": ann, "data.train.img_prefix": img,
                "data.val.ann_file": ann, "data.val.img_prefix": img,
                "log_interval": 1, "total_epochs": 1, "eval_max_images": 1,
                "lr_config": dict(warmup_iters=1, step=[1]),
                "test_cfg.score_thr": 0.0}
    else:
        opts = narrow_options(root)
        opts.update({"model.bbox_head.in_channels": 64,
                     "model.bbox_head.feat_channels": 64,
                     "model.bbox_head.stacked_convs": 2})
    opts.update({"model.bbox_head.num_classes": C,
                 "checkpoint_config": dict(interval=1),
                 "evaluation": dict(interval=100)})
    return [f"{k}={v!r}" for k, v in opts.items()]


@pytest.fixture(scope="module")
def ssd_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ssd_shapes"))
    make_shapes_coco(root, 2, seed=7, hw=[(240, 320), (300, 260)])
    return root


@pytest.fixture(scope="module")
def fpn_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zoo2_shapes"))
    make_shapes_coco(root, 4, seed=5, hw=HW)
    return root


@pytest.mark.parametrize("name", sorted(FILES))
def test_runner_trains_and_tests(name, ssd_set, fpn_set, tmp_path):
    """One narrow step through ``tools.train`` (its augmentations and
    300x300 canvas for the SSD files, no neck), then ``tools.test`` on the
    checkpoint: finite loss terms, bbox metrics."""
    root = ssd_set if name in SSD_KINDS else fpn_set
    path = os.path.join(REPO, "configs", FILES[name])
    work = str(tmp_path / "work")
    opts = runner_options(name, root)
    res = train_tool.main([path, "--work-dir", work, "--device", "cpu",
                           "--max-iters-per-epoch", "1", "--options", *opts])
    assert res["step"] == 1
    (log,) = glob.glob(os.path.join(work, "*.log.json"))
    with open(log) as f:
        train = [json.loads(line) for line in f]
    assert len(train) == 1 and TERMS.get(name, TERMS["fovea"]) <= set(
        train[0])
    assert all(np.isfinite(v) for k, v in train[0].items()
               if k.startswith(("loss", "positive", "negative")))
    metrics = test_tool.main([path, os.path.join(work, "ckpts", "step_1.pt"),
                              "--eval", "bbox", "--device", "cpu",
                              "--max-images", "1", "--options", *opts])
    assert "bbox_mAP" in metrics and all(-1 <= v <= 1
                                         for v in metrics.values())
    if name in SSD_KINDS:
        assert type(res["model"].backbone).__name__ == "SSDVGG"
        assert isinstance(res["model"].neck, torch.nn.Identity)


def test_api_serves_an_ssd_bundle(ssd_set):
    """``init_detector`` / ``inference_detector`` on the SSD file (seeded
    weights, 3 classes): the 320x320 bucket canvas gives VGG maps of 3x3
    and 1x1 at strides 100 and 300, and the anchors follow the maps."""
    cfg = file_cfg("ssd")
    cfg.merge_from_dict({"model.bbox_head.num_classes": C,
                         "test_cfg.score_thr": 0.0})
    bundle = apis.init_detector(cfg, device="cpu")
    apis.random_weights_(bundle.model, 0)
    img = (np.random.RandomState(0).rand(200, 260, 3) * 255).astype(np.uint8)
    res = apis.inference_detector(bundle, img)
    assert len(res["scores"]) > 0 and (res["labels"] < C).all()
    assert (res["bboxes"][:, 2] <= 260 + 1e-3).all()
