"""LSNet-CPV in the port against the JAX package, on the CPU, and K1's
padded backward.

Inputs are made with numpy from seeds; weights are the JAX modules'
minted variables (``torch_port_util.mint_variables``) loaded through
``weights.from_jax_variables``. Image-sized cases use 64x64 canvases and
feat 32 (one stacked block, 4 classes, GroupNorm of 8 groups).

* the focal losses ``sep_focal_loss`` / ``gaussian_focal_loss`` and
  ``smooth_l1``: values 1e-5, gradients 1e-4 of max(1, max|ref|);
* the four corner pools: values exact, gradients equal where no two
  inputs tie, and where ReLU zeros tie (their gradient is 0 through the
  ReLU); where positive values tie, the two packages send a tie's
  gradient to different inputs with the same total over the tie (the
  port's rule, ROADMAP Queue 3), which the test measures;
* ``gaussian_radius``, ``hm_targets`` (two GTs sharing a nearest grid
  point, padded GTs whose nearest point is a level's first), and
  ``make_sem_targets`` (nested boxes of one class, equal areas): equal
  to JAX's bit for bit, or within 1e-6 where an exp or sqrt rounds;
* ``LSCPVHead`` outputs (norm and DCN towers, bilinear and nearest,
  ``offset_scale_compat`` off) and LSHead's with the quirk off: 1e-4
  relative;
* ``lscpv_loss``: the six terms 1e-5, gradients of all six output maps
  1e-4 of max(1, max|ref|);
* ``lscpv_decode`` on the same head outputs, candidates on every level
  (so the corner snap runs): identical detections (valid mask, labels,
  boxes, scores and extreme points to 1e-5 of their scale);
* a narrow ResNeXt-shaped CPV detector (ResNeXt-50, G = 8, DCN c3-c5,
  DCN towers): outputs 1e-4, detections as a set 1e-3, one train step's
  loss 1e-5 and parameters 1e-4 of max(1, max|ref|);
* K1's backward through the padding the card route takes (pad C and
  cout, the plain kernel math, slice) equals the unpadded plain versions
  exactly at C = 262 (CPV's refine) and 52 / 104 / 208 (Res2Net), on
  inputs whose sums f32 holds exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _x101_flagship_cfg
from lsnet_tpu.core import cpv as jcpv
from lsnet_tpu.core import points as jpoints
from lsnet_tpu.core.decode import TestConfig as JTestConfig
from lsnet_tpu.core.loss import LossConfig as JLossConfig
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models.backbones.resnet import frozen_param_paths
from lsnet_tpu.models.heads.ls_head import LSHead as JLSHead
from lsnet_tpu.models.heads.lscpv_head import LSCPVHead as JLSCPVHead
from lsnet_tpu.ops.corner_pool import corner_pool as j_corner_pool
from lsnet_tpu.ops.corner_pool import left_pool as j_left_pool
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.ops import focal_loss as jfocal
from lsnet_tpu.train import optim as joptim
from lsnet_tpu.train.step import create_train_state
from lsnet_tpu.train.step import make_train_step as j_make_train_step
from lsnet_torch.configs import x101_cpv_cfg
from lsnet_torch.core import cpv
from lsnet_torch.core import points as P
from lsnet_torch.core.decode import TestConfig
from lsnet_torch.core.loss import LossConfig
from lsnet_torch.models import build_detector
from lsnet_torch.models.heads.ls_head import LSHead
from lsnet_torch.models.heads.lscpv_head import LSCPVHead
from lsnet_torch.ops import corner_pool as pool
from lsnet_torch.ops import deform_gather as dg
from lsnet_torch.ops import focal_loss as focal
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.train.step import make_train_step
from lsnet_torch.weights import load_jax_variables, to_jax_variables
from test_torch_x101 import _as_set
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

H = W = 64
B, C, M = 2, 4, 5
STRIDES = (8, 16, 32, 64, 128)
LEVELS = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
HEAD_KW = dict(num_classes=C, in_channels=32, feat_channels=32,
               point_feat_channels=32, stacked_convs=1, norm_groups=8)
CPV_KW = dict(HEAD_KW, corner_dim=16)
OUT_KEYS = ("cls", "bbox_init", "bbox_refine", "hem_score", "hem_offset",
            "sem_score")
OPTIM = dict(base_lr=0.02, steps_per_epoch=2, decay_epochs=[1],
             warmup_iters=2, warmup_ratio=0.1, clip_norm=2.0)
SITES = ("backbone", "tower", "refine")


@pytest.fixture
def pin_sampling(monkeypatch):
    """Pin the JAX package's process-wide sampling policy (another test
    file in the same worker may have set it); returns a setter."""
    def pin(mode):
        monkeypatch.setattr(jfd, "SAMPLING", [mode])
        monkeypatch.setattr(jfd, "SAMPLING_POLICY", {})
        return {s: mode for s in SITES}
    pin("bilinear")
    return pin


def _rel(got, want, rel=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(1.0, abs(want)), (got, want)


# ------------------------------------------------------------ losses

@pytest.mark.parametrize("weighted", [False, True])
def test_sep_focal_loss(weighted):
    rng = np.random.RandomState(1)
    pred = (3 * rng.randn(40, 3)).astype(np.float32)
    target = (rng.rand(40, 3) < 0.3).astype(np.float32)
    weight = rng.rand(40).astype(np.float32) if weighted else None
    kw = dict(avg_factor=7.0) if weighted else {}

    def jf(p):
        return jfocal.sep_focal_loss(
            p, jnp.asarray(target),
            None if weight is None else jnp.asarray(weight), **kw)

    want, jgrad = jax.value_and_grad(jf)(jnp.asarray(pred))
    p = t(pred).requires_grad_()
    got = focal.sep_focal_loss(p, t(target),
                               None if weight is None else t(weight), **kw)
    got.backward()
    _rel(got, want)
    assert_close(p.grad, jgrad)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_gaussian_focal_loss(reduction):
    rng = np.random.RandomState(2)
    prob = rng.uniform(0.01, 0.99, (2, 50)).astype(np.float32)
    target = rng.rand(2, 50).astype(np.float32)
    target[:, ::7] = 1.0                              # the bump centres
    weight = (rng.rand(2, 50) < 0.9).astype(np.float32)

    def jf(p):
        return jfocal.gaussian_focal_loss(
            p, jnp.asarray(target), jnp.asarray(weight), reduction=reduction,
            avg_factor=3.0 if reduction == "mean" else None)

    want, jgrad = jax.value_and_grad(jf)(jnp.asarray(prob))
    p = t(prob).requires_grad_()
    got = focal.gaussian_focal_loss(
        p, t(target), t(weight), reduction=reduction,
        avg_factor=3.0 if reduction == "mean" else None)
    got.backward()
    _rel(got, want)
    assert_close(p.grad, jgrad)


def test_smooth_l1_and_gaussian_radius():
    rng = np.random.RandomState(3)
    a, b = (rng.randn(100) * 0.3).astype(np.float32), np.zeros(100,
                                                                np.float32)
    np.testing.assert_array_equal(
        cpv.smooth_l1(t(a), t(b)).numpy(),
        np.asarray(jcpv.smooth_l1(jnp.asarray(a), jnp.asarray(b))))
    h, w = (rng.uniform(1, 300, (2, 60)).astype(np.float32)
            for _ in range(2))
    for iou in (0.7, 0.3):
        np.testing.assert_allclose(
            cpv.gaussian_radius(t(h), t(w), iou).numpy(),
            np.asarray(jcpv.gaussian_radius(jnp.asarray(h), jnp.asarray(w),
                                            iou)), rtol=1e-6)


# ------------------------------------------------------------ corner pools

@pytest.mark.parametrize("mode", ["top", "bottom", "left", "right"])
def test_corner_pool_values_and_gradients(mode):
    rng = np.random.RandomState(len(mode))
    x = rng.randn(2, 7, 9, 5).astype(np.float32)       # no two values tie
    probe = rng.randn(2, 7, 9, 5).astype(np.float32)
    want, jgrad = jax.value_and_grad(lambda v: (j_corner_pool(
        v, mode) * probe).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = pool.corner_pool(xt, mode)
    (got * t(probe)).sum().backward()
    np.testing.assert_array_equal(
        got.detach().numpy(), np.asarray(j_corner_pool(jnp.asarray(x),
                                                           mode)))
    assert_close(xt.grad, jgrad, rel=1e-6)


@pytest.mark.parametrize("mode", ["top", "left"])
def test_corner_pool_relu_zero_ties(mode):
    """After GN + ReLU, the ties are ReLU's zeros (more than half the
    entries here); the gradient through the ReLU is 0 at them, so the
    packages' different tie rules give the same gradient."""
    rng = np.random.RandomState(9)
    x = (rng.randn(2, 8, 8, 4) - 0.5).astype(np.float32)
    probe = rng.randn(2, 8, 8, 4).astype(np.float32)
    jgrad = jax.grad(lambda v: (j_corner_pool(
        jax.nn.relu(v), mode) * probe).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    (pool.corner_pool(torch.relu(xt), mode) * t(probe)).sum().backward()
    assert (x <= 0).mean() > 0.5
    assert_close(xt.grad, jgrad, rel=1e-6)


def test_corner_pool_positive_ties_keep_the_total():
    """Tied positive maxima (common in bf16): ``torch.cummax`` gives each
    output's gradient to one of the tied inputs, JAX's associative scan
    splits it over them by its tree; the values and the gradient summed
    over each tie agree, the split does not (ROADMAP Queue 3)."""
    x = np.array([0.5, 2.0, 1.0, 2.0, 2.0, 0.25, 2.0, 1.5], np.float32)
    x = x.reshape(1, 1, 8, 1)
    jgrad = np.asarray(jax.grad(lambda v: j_left_pool(v).sum())(
        jnp.asarray(x))).ravel()
    xt = t(x).requires_grad_()
    pool.left_pool(xt).sum().backward()
    got = xt.grad.numpy().ravel()
    tied = x.ravel() == 2.0
    assert got[tied].sum() == jgrad[tied].sum() == 7.0
    assert (got[~tied] == jgrad[~tied]).all()


# ------------------------------------------------------------ targets

def _gt(rng, shared=True):
    lo = rng.uniform(0, 30, (B, M, 2))
    wh = rng.uniform(6, 40, (B, M, 2))
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    valid = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)
    if shared:
        # two GTs whose corners have the same nearest grid point on every
        # level, with different offsets; a GT at the first point of each
        # level, then padded (all-zero, invalid) GTs, whose distances are
        # all 1e8 so that their nearest point is the level's first too
        boxes[0, 1] = [9.0, 10.0, 47.0, 45.0]
        boxes[0, 2] = [10.5, 8.5, 46.0, 47.5]
        boxes[1, 2] = [1.0, 0.5, 20.0, 24.0]
        boxes[1, 3:] = 0.0
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    return boxes, labels, valid


def test_hm_targets_match_jax():
    rng = np.random.RandomState(4)
    boxes, _, gvalid = _gt(rng)
    pad = np.array([[H, W], [H - 8, W - 24]], np.int32)
    points = jpoints.multi_level_points((H, W), STRIDES)
    nlp = jpoints.num_level_points((H, W), STRIDES)
    pvalid = jax.vmap(lambda ps: jpoints.valid_flags((H, W), STRIDES, ps))(
        jnp.asarray(pad))
    want = jax.jit(jax.vmap(lambda pv, gb, gv: jcpv.hm_targets_single(
        points, pv, nlp, gb, gv)))(pvalid, jnp.asarray(boxes),
                                   jnp.asarray(gvalid))
    got = cpv.hm_targets(P.multi_level_points((H, W), STRIDES),
                         P.valid_flags((H, W), STRIDES, t(pad)),
                         P.num_level_points((H, W), STRIDES), t(boxes),
                         t(gvalid))
    for name in cpv.HMTargets._fields:
        g, w_ = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w_.shape, name
        np.testing.assert_allclose(g, w_, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    # the two GTs of image 0 share their nearest points: one positive
    assert got.offset_tl_w[0].sum() < 5 * len(STRIDES)


def test_make_sem_targets_match_jax():
    rng = np.random.RandomState(5)
    boxes, labels, valid = _gt(rng, shared=False)
    boxes[0, 3] = [4.0, 4.0, 60.0, 60.0]      # a box around the others
    labels[0] = [1, 1, 2, 1, 1]
    boxes[1, 1] = boxes[1, 0] + 3.0            # equal areas, one class
    labels[1, :2] = 3
    want = jcpv.make_sem_targets(jnp.asarray(boxes), jnp.asarray(labels),
                                 jnp.asarray(valid), (H, W), C)
    got = cpv.make_sem_targets(t(boxes), t(labels), t(valid), (H, W), C)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[1].max() > 0 and got[0].sum() > 0
    resized = cpv._nearest_resize(got[1], (3, 5)).numpy()
    np.testing.assert_array_equal(
        resized, np.asarray(jcpv._nearest_resize(want[1], (3, 5))))


# ------------------------------------------------------------ the head

def _feats(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, h, w, 32).astype(np.float32) for h, w in LEVELS]


def _head_outputs(jhead, thead, feats, sampling, seed):
    v = mint_variables(jhead, [jnp.asarray(f[:1]) for f in feats], seed=seed)
    jouts = jax.jit(jhead.apply)(to_jax(v), [jnp.asarray(f) for f in feats])
    load_jax_variables(thead, v)
    with torch.no_grad():
        touts = thead.eval()([t(f).permute(0, 3, 1, 2) for f in feats],
                             sampling)
    return jax.tree.map(np.asarray, jouts), touts


@pytest.mark.parametrize("towers,mode,compat", [
    ("norm", "bilinear", True), ("dcn", "bilinear", True),
    ("norm", "nearest", True), ("dcn", "nearest", True),
    ("dcn", "bilinear", False)])
def test_cpv_head_matches_jax(pin_sampling, towers, mode, compat):
    sampling = pin_sampling(mode)
    jouts, touts = _head_outputs(
        JLSCPVHead(conv_module_type=towers, offset_scale_compat=compat,
                   **CPV_KW),
        LSCPVHead(conv_module_type=towers, offset_scale_compat=compat,
                  **CPV_KW), _feats(len(towers) + len(mode)), sampling,
        seed=7)
    assert set(touts) == set(jouts) == set(OUT_KEYS)
    for key in OUT_KEYS:
        for g, w_ in zip(touts[key], jouts[key]):
            assert tuple(g.shape) == w_.shape, key
            assert_close(g, w_, rel=1e-4)


def test_lshead_without_the_offset_scale_quirk(pin_sampling):
    kw = dict(HEAD_KW, conv_module_type="norm", offset_scale_compat=False)
    jouts, touts = _head_outputs(JLSHead(**kw), LSHead(**kw), _feats(11),
                                 pin_sampling("bilinear"), seed=8)
    for key in jouts:
        for g, w_ in zip(touts[key], jouts[key]):
            assert_close(g, w_, rel=1e-4)
    # the quirk changes the outputs: it is really off
    on = LSHead(**dict(kw, offset_scale_compat=True))
    _, on_outs = _head_outputs(JLSHead(**kw), on, _feats(11),
                               pin_sampling("bilinear"), seed=8)
    assert max(float((a - b).abs().max()) for a, b in zip(
        on_outs["bbox_refine"], touts["bbox_refine"])) > 1e-4


# ------------------------------------------------------------ loss, decode

def _random_outputs(rng):
    outs = {}
    for key, d in (("cls", C), ("bbox_init", 20), ("bbox_refine", 20),
                   ("hem_score", 2), ("hem_offset", 4), ("sem_score", C)):
        outs[key] = []
        for lvl, (h, w) in enumerate(LEVELS):
            x = rng.randn(B, h, w, d).astype(np.float32)
            if key.startswith("bbox"):      # softplus outputs, a few px
                x = np.abs(x) + 0.5
            if key == "cls" and lvl:        # strong candidates on levels > 0
                x = x + 2.0
            outs[key].append(x)
    return outs


def _batch(rng):
    boxes, labels, valid = _gt(rng)
    return dict(gt_bboxes=boxes, gt_labels=labels, gt_valid=valid,
                pad_shape=np.array([[H, W], [H - 8, W - 16]], np.int32))


def test_lscpv_loss_value_and_gradients():
    rng = np.random.RandomState(6)
    outs = _random_outputs(rng)
    batch = _batch(rng)
    kw = dict(image_shape=(H, W), num_classes=C)

    def jf(o):
        return jcpv.lscpv_loss(
            o, {k: jnp.asarray(v) for k, v in batch.items()},
            jcpv.CPVLossConfig(base=JLossConfig(**kw)))

    (want, jterms), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        {k: [jnp.asarray(x) for x in v] for k, v in outs.items()})
    touts = {k: [t(x).requires_grad_() for x in v] for k, v in outs.items()}
    got, terms = cpv.lscpv_loss(touts, {k: t(v) for k, v in batch.items()},
                                cpv.CPVLossConfig(base=LossConfig(**kw)))
    got.backward()
    _rel(got, want)
    assert list(terms) == sorted(jterms, key=list(terms).index) == [
        "loss_cls", "loss_bbox_init", "loss_bbox_refine", "loss_heatmap",
        "loss_offset", "loss_sem"]
    for k in terms:
        _rel(terms[k], jterms[k])
        assert float(terms[k]) > 0, k
    for k in OUT_KEYS:
        for g, w_ in zip(touts[k], jgrads[k]):
            assert_close(g.grad, w_)


def test_lscpv_decode_matches_jax():
    rng = np.random.RandomState(7)
    outs = _random_outputs(rng)
    shapes = np.array([[H, W], [H - 10, W - 20]], np.int32)
    sfs = np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]], np.float32)
    kw = dict(image_shape=(H, W), num_classes=C, nms_pre=1000,
              score_thr=0.05, nms_iou=0.6, max_per_img=100)
    want = jax.jit(jcpv.lscpv_decode, static_argnums=3)(
        jax.tree.map(jnp.asarray, outs), jnp.asarray(shapes),
        jnp.asarray(sfs), JTestConfig(**kw))
    got = cpv.lscpv_decode({k: [t(x) for x in v] for k, v in outs.items()},
                           t(shapes), t(sfs), TestConfig(**kw))
    valid = np.asarray(want.valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for name in ("bboxes", "scores", "landmarks"):
        assert_close(getattr(got, name), np.asarray(getattr(want, name)),
                     rel=1e-5)
    # the snap moved boxes: a kept box edge on the stride-8 lattice plus
    # an offset, not the unsnapped decode's
    lm = np.asarray(want.landmarks)[valid]
    box = np.asarray(want.bboxes)[valid]
    assert (np.abs(lm[:, 2] - box[:, 0]) > 1e-3).any()


# ------------------------------------------------------------ the detector

def _cpv_cfgs():
    jcfg = _x101_flagship_cfg(feat=32, stacked=1)
    jcfg["backbone"].update(depth=50, groups=8)
    head = dict(type="LSCPVHead", num_classes=C, in_channels=32,
                feat_channels=32, point_feat_channels=32, stacked_convs=1,
                corner_dim=16, norm_cfg=dict(type="GN", num_groups=8),
                conv_module_type="dcn")
    jcfg.update(type="LSCPVDetector", bbox_head=head)
    tcfg = x101_cpv_cfg(feat=32, stacked=1)
    tcfg["backbone"].update(depth=50, groups=8)
    tcfg["bbox_head"].update(num_classes=C, corner_dim=16,
                             norm_cfg=dict(type="GN", num_groups=8))
    return jcfg, tcfg


def _unit_scales(tree):
    return {k: (_unit_scales(v) if isinstance(v, dict)
                else np.ones_like(v) if k == "scale" else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def detector():
    """(JAX model, minted variables, the port's model, a train batch, the
    trainable mask) with the JAX sampling pinned to bilinear."""
    jcfg, tcfg = _cpv_cfgs()
    jmodel, _ = j_build(jcfg)
    rng = np.random.RandomState(12)
    batch = _batch(rng)
    batch["image"] = rng.randn(B, H, W, 3).astype(np.float32)
    v = mint_variables(jmodel, jnp.asarray(batch["image"][:1]), seed=13)
    params = dict(v["params"])
    params["backbone"] = _unit_scales(params["backbone"])
    v = dict(v, params=params)
    model = build_detector(tcfg)
    load_jax_variables(model, v)
    mask = joptim.make_frozen_mask(v["params"], frozen_param_paths(50, 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        yield jmodel, v, model, batch, mask


def test_detector_forward_and_decode(detector):
    jmodel, v, model, batch, _ = detector
    kw = dict(image_shape=(H, W), num_classes=C, score_thr=0.05)
    shapes = np.array([[H, W]] * B, np.int32)
    sfs = np.ones((B, 4), np.float32)

    @jax.jit
    def jrun(variables, image):
        outs = jmodel.apply(variables, image)
        return outs, jcpv.lscpv_decode(outs, jnp.asarray(shapes),
                                       jnp.asarray(sfs), JTestConfig(**kw))

    jouts, jdet = jrun(to_jax(v), jnp.asarray(batch["image"]))
    with torch.no_grad():
        touts = model.eval()(t(batch["image"]),
                             {s: "bilinear" for s in SITES})
        tdet = cpv.lscpv_decode(touts, t(shapes), t(sfs), TestConfig(**kw))
    for key in OUT_KEYS:
        for g, w_ in zip(touts[key], jouts[key]):
            assert_close(g, np.asarray(w_), rel=1e-4)
    assert np.asarray(jdet.valid).sum() > 0
    for i in range(B):
        g, w_ = _as_set(tdet, i), _as_set(jdet, i)
        np.testing.assert_array_equal(g["labels"], w_["labels"])
        for name in ("bboxes", "scores", "landmarks"):
            np.testing.assert_allclose(g[name], w_[name], atol=1e-3,
                                       rtol=1e-3)


def test_detector_train_step(detector):
    jmodel, v, model, batch, mask = detector
    lkw = dict(image_shape=(H, W), num_classes=C)
    tx, _ = joptim.build_optimizer(
        OPTIM["base_lr"], OPTIM["steps_per_epoch"], OPTIM["decay_epochs"],
        clip_norm=OPTIM["clip_norm"], warmup_iters=OPTIM["warmup_iters"],
        warmup_ratio=OPTIM["warmup_ratio"], trainable_mask=mask)
    jstep = j_make_train_step(
        jmodel, tx, jcpv.CPVLossConfig(base=JLossConfig(**lkw)),
        mixed_precision=False, loss_fn_impl=jcpv.lscpv_loss)
    state, jmetrics = jstep(create_train_state(to_jax(v), tx),
                            {k: jnp.asarray(x) for k, x in batch.items()})

    load_jax_variables(model, v)
    model.train()
    optimizer, _ = build_optimizer(model.parameters(), **OPTIM)
    step = make_train_step(model, optimizer,
                           cpv.CPVLossConfig(base=LossConfig(**lkw)),
                           mixed_precision=False)
    metrics = step({k: t(x) for k, x in batch.items()})
    for k in ("loss", "loss_heatmap", "loss_offset", "loss_sem"):
        _rel(metrics[k], jmetrics[k])
    got = {jax.tree_util.keystr(p): x for p, x in
           jax.tree_util.tree_flatten_with_path(
               to_jax_variables(model)["params"])[0]}
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(state.params)[0]}
    assert set(got) == set(want)
    for key, ref in want.items():
        assert_close(got[key], ref, rel=1e-4)
    assert any("hem_tl" in k for k in got)


# ------------------------------------------------------------ K1 padding

@pytest.mark.parametrize("C_in,cout", [(262, 256), (52, 52), (104, 104),
                                       (208, 208)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_padded_backward_equals_unpadded(C_in, cout, dtype):
    """What the card route computes: operands padded to the kernels'
    multiples (C 288 / 272 for 262, cout 56 for 52), the plain kernel
    math, the outputs sliced back. Small integers and quarter weights keep
    every sum exact in f32, so the sums' order cannot hide a difference."""
    rng = np.random.RandomState(C_in)
    K, R, px, nc = 9, 90, 37, 4
    flat = torch.from_numpy(rng.randint(-3, 4, (R, C_in)).astype(
        np.float32)).to(dtype)
    idx = torch.from_numpy(rng.randint(0, R, (nc, K, px)).astype(np.int32))
    w = torch.from_numpy(rng.randint(0, 5, (nc, K, px)).astype(
        np.float32) / 4)
    weight = torch.from_numpy(rng.randint(-2, 3, (K, C_in, cout)).astype(
        np.float32)).to(dtype)
    dout = torch.from_numpy(rng.randint(-2, 3, (px, cout)).astype(
        np.float32)).to(dtype)
    flat_p, weight_p = dg.pad_channels(flat, weight)
    mc, mo = dg.channel_multiples(dtype)
    assert flat_p.shape[1] % mc == 0 and weight_p.shape[2] % mo == 0
    assert flat_p.shape[1] > C_in or C_in % mc == 0
    dout_p = dg.pad_dout(dout, weight_p.shape[2])
    d_flat_p, d_w_p = dg.deform_gather_contract_bwd_data_ref(
        flat_p, idx, w, weight_p, dout_p)
    d_weight_p = dg.deform_gather_contract_bwd_weight_ref(flat_p, idx, w,
                                                          dout_p)
    d_flat, d_w = dg.deform_gather_contract_bwd_data_ref(flat, idx, w,
                                                         weight, dout)
    d_weight = dg.deform_gather_contract_bwd_weight_ref(flat, idx, w, dout)
    assert torch.equal(d_flat_p[:, :C_in], d_flat)
    assert torch.equal(d_w_p, d_w)
    assert torch.equal(d_weight_p[:, :C_in, :cout], d_weight)
    assert not d_flat_p[:, C_in:].any() and not d_weight_p[:, C_in:].any()

    # the autograd route of the card: pad, the function on the padded
    # operands, slice; its gradients are the unpadded ones
    def grads(padded):
        f = flat.clone().requires_grad_()
        wt = w.clone().requires_grad_()
        wk = weight.clone().requires_grad_()
        a, b = dg.pad_channels(f, wk) if padded else (f, wk)
        out = dg.GatherContract.apply(dg._OPS, a, idx, wt, b, None, None)
        (out[:, :cout].float() * dout.float()).sum().backward()
        return f.grad, wt.grad, wk.grad

    for g, ref in zip(grads(True), grads(False)):
        assert torch.equal(g, ref)
