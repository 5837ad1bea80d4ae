"""The port's training loss against the JAX package, piece by piece and as
a whole: grid points and validity, sigmoid focal loss, cross-IOU loss in
its three modes, the two assigners (with tied distances), the target
construction, and ``lsnet_loss`` in value and gradient.

Inputs are minted with numpy from a seed, f32, and handed to both
packages; the JAX per-image functions run under ``jax.vmap`` as
``lsnet_tpu/core/loss.py`` runs them. Tolerances: values 1e-5 relative,
gradients 1e-4 * max(1, max|ref|) (f32 sums in another order);
assignments and labels are integers and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core import assign as jassign
from lsnet_tpu.core import points as jpoints
from lsnet_tpu.core import targets as jtargets
from lsnet_tpu.core.loss import LossConfig as JLossConfig
from lsnet_tpu.core.loss import lsnet_loss as j_lsnet_loss
from lsnet_tpu.models.losses.cross_iou import cross_iou_loss as j_cross_iou
from lsnet_tpu.ops.focal_loss import sigmoid_focal_loss as j_focal
from lsnet_torch.core import assign as tassign
from lsnet_torch.core import points as tpoints
from lsnet_torch.core import targets as ttargets
from lsnet_torch.core.loss import LossConfig, lsnet_loss
from lsnet_torch.models.losses.cross_iou import cross_iou_loss
from lsnet_torch.ops.focal_loss import sigmoid_focal_loss
from torch_port_util import assert_close, t

torch.set_num_threads(1)

SHAPE = (96, 128)
STRIDES = (8, 16, 32, 64, 128)


def _rel(got, want, rel=1e-5):
    got = float(got.detach() if isinstance(got, torch.Tensor) else got)
    want = float(want)
    assert abs(got - want) <= rel * max(1.0, abs(want)), (got, want)


def test_points_and_valid_flags():
    want = jpoints.multi_level_points(SHAPE, STRIDES)
    got = tpoints.multi_level_points(SHAPE, STRIDES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tpoints.num_level_points(SHAPE, STRIDES) == \
        jpoints.num_level_points(SHAPE, STRIDES)
    pads = np.array([[96, 128], [80, 100], [33, 17]], np.int32)
    want = jax.vmap(lambda p: jpoints.valid_flags(SHAPE, STRIDES, p))(
        jnp.asarray(pads))
    got = tpoints.valid_flags(SHAPE, STRIDES, t(pads))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got[2].sum() < got[0].sum()


@pytest.mark.parametrize("reduction,avg", [("mean", 7.0), ("mean", None),
                                           ("sum", None)])
def test_sigmoid_focal_loss(reduction, avg):
    rng = np.random.RandomState(0)
    N, C = 60, 7
    pred = (3 * rng.randn(N, C)).astype(np.float32)
    target = rng.randint(0, C + 1, N).astype(np.int32)       # C = background
    weight = (rng.rand(N) > 0.2).astype(np.float32)

    def jf(p):
        return j_focal(p, jnp.asarray(target), jnp.asarray(weight),
                       reduction=reduction, avg_factor=avg)

    want, jgrad = jax.value_and_grad(jf)(jnp.asarray(pred))
    tp = t(pred).requires_grad_()
    got = sigmoid_focal_loss(tp, t(target), t(weight), reduction=reduction,
                             avg_factor=avg)
    got.backward()
    _rel(got, want)
    assert_close(tp.grad, jgrad)


@pytest.mark.parametrize("loss_type,nv", [("bbox", 4), ("polygon", 35),
                                          ("keypoint", 17)])
def test_cross_iou_loss(loss_type, nv):
    rng = np.random.RandomState(nv)
    N = 40
    D = (nv + 1) * 4
    pred = np.abs(rng.randn(N, D)).astype(np.float32) + 0.05
    pts = rng.uniform(0, 10, (N, (nv + 1) * 2)).astype(np.float32)
    anchor = rng.uniform(3, 7, (N, 2)).astype(np.float32)
    weight = (rng.rand(N) > 0.3).astype(np.float32)
    target, pos_inds = ttargets.encode_gt_reg(t(pts), t(anchor), t(weight))
    x = np.sort(rng.uniform(0, 10, (N, 2)), axis=1)
    y = np.sort(rng.uniform(0, 10, (N, 2)), axis=1)
    bbox_gt = np.stack([x[:, 0], y[:, 0], x[:, 1] + 1, y[:, 1] + 1],
                       1).astype(np.float32)
    vs = rng.randint(0, 3, (N, nv)).astype(np.float32)
    kw = dict(loss_type=loss_type, avg_factor=float(weight.sum()),
              loss_weight=2.0)

    def jf(p):
        return j_cross_iou(p, jnp.asarray(target.numpy()),
                           jnp.asarray(weight),
                           anchor_pts=jnp.asarray(anchor),
                           vs=jnp.asarray(vs), bbox_gt=jnp.asarray(bbox_gt),
                           pos_inds=jnp.asarray(pos_inds.numpy()), **kw)

    want, jgrad = jax.value_and_grad(jf)(jnp.asarray(pred))
    tp = t(pred).requires_grad_()
    got = cross_iou_loss(tp, target, t(weight), anchor_pts=t(anchor),
                         vs=t(vs), bbox_gt=t(bbox_gt), pos_inds=pos_inds,
                         **kw)
    got.backward()
    _rel(got, want)
    assert float(np.abs(np.asarray(jgrad)).max()) > 0
    assert_close(tp.grad, jgrad)


def test_cross_iou_zero_positives_is_zero():
    pred = torch.rand(5, 20).requires_grad_()
    z = torch.zeros(5, 20)
    loss = cross_iou_loss(pred, z, torch.zeros(5), loss_type="bbox",
                          anchor_pts=torch.zeros(5, 2),
                          bbox_gt=torch.zeros(5, 4),
                          pos_inds=torch.zeros(5, 20, dtype=torch.bool),
                          avg_factor=torch.tensor(0.0))
    loss.backward()
    assert float(loss) == 0.0 and float(pred.grad.abs().max()) == 0.0
    with pytest.raises(ValueError):
        cross_iou_loss(pred, z, torch.zeros(5), loss_type="mask",
                       pos_inds=torch.zeros(5, 20, dtype=torch.bool))


def _gt_batch(rng, B, M, tied):
    """Padded GT boxes. ``tied``: box centres exactly half-way between
    grid points of their level, and pairs of identical boxes, so that both
    the per-GT nearest point and the per-point nearest GT are ties."""
    lo = rng.uniform(0, 60, (B, M, 2))
    wh = rng.uniform(8, 60, (B, M, 2))
    if tied:
        wh = np.full((B, M, 2), 24.0)              # level log2(24/4) -> 8
        lo = 8.0 * rng.randint(0, 8, (B, M, 2)) + 4.0 - wh / 2
        lo[:, 1] = lo[:, 0]                        # two identical GTs
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    valid = np.ones((B, M), bool)
    valid[0, -1] = False
    valid[-1, -2:] = False
    return boxes, valid


@pytest.mark.parametrize("iou_type,pos_num,tied", [
    ("center", 1, False), ("center", 1, True), ("center", 3, True),
    ("centroid", 1, False)])
def test_centroid_assign(iou_type, pos_num, tied):
    rng = np.random.RandomState(pos_num + tied)
    B, M = 3, 5
    boxes, gt_valid = _gt_batch(rng, B, M, tied)
    extremes = ttargets.get_border_center(t(boxes)).numpy()
    extremes[..., :8] += rng.uniform(-3, 3, (B, M, 8)).astype(np.float32)
    pads = np.array([[96, 128], [80, 100], [96, 128]], np.int32)
    jpts = jpoints.multi_level_points(SHAPE, STRIDES)
    jvalid = jax.vmap(lambda p: jpoints.valid_flags(SHAPE, STRIDES, p))(
        jnp.asarray(pads))
    want = jax.vmap(lambda pv, gb, gv, ex: jassign.centroid_assign(
        jpts, pv, gb, gv, gt_extremes=ex, pos_num=pos_num,
        iou_type=iou_type))(jvalid, jnp.asarray(boxes),
                            jnp.asarray(gt_valid), jnp.asarray(extremes))
    got = tassign.centroid_assign(
        tpoints.multi_level_points(SHAPE, STRIDES),
        tpoints.valid_flags(SHAPE, STRIDES, t(pads)), t(boxes), t(gt_valid),
        gt_extremes=t(extremes), pos_num=pos_num, iou_type=iou_type)
    assert got.gt_idx.dtype == torch.int32
    np.testing.assert_array_equal(got.gt_idx.numpy(),
                                  np.asarray(want.gt_idx))
    assert (got.gt_idx >= 0).sum() > 0
    if tied:
        # the second of two identical GTs loses every point to the first
        assert not bool((got.gt_idx == 1).any())


@pytest.mark.parametrize("tied", [False, True])
def test_atss_assign(tied):
    rng = np.random.RandomState(7 + tied)
    B, M = 3, 5
    boxes, gt_valid = _gt_batch(rng, B, M, tied)
    pts = np.asarray(jpoints.multi_level_points(SHAPE, STRIDES))
    nlp = jpoints.num_level_points(SHAPE, STRIDES)
    half = (2.0 * pts[:, 2:3] if tied
            else pts[:, 2:3] * rng.uniform(1, 3, (B, len(pts), 1)))
    centre = np.broadcast_to(pts[None, :, :2], (B, len(pts), 2))
    bboxes = np.concatenate([centre - half, centre + half],
                            -1).astype(np.float32)
    pads = np.array([[96, 128], [80, 100], [96, 128]], np.int32)
    jvalid = jax.vmap(lambda p: jpoints.valid_flags(SHAPE, STRIDES, p))(
        jnp.asarray(pads))
    want = jax.vmap(lambda bb, pv, gb, gv: jassign.atss_assign(
        bb, pv, nlp, gb, gv, topk=9))(
        jnp.asarray(bboxes), jvalid, jnp.asarray(boxes),
        jnp.asarray(gt_valid))
    got = tassign.atss_assign(t(bboxes), t(np.asarray(jvalid)), nlp,
                              t(boxes), t(gt_valid), topk=9)
    np.testing.assert_array_equal(got.gt_idx.numpy(),
                                  np.asarray(want.gt_idx))
    assert_close(got.max_overlaps, want.max_overlaps, rel=1e-6)
    assert (got.gt_idx >= 0).sum() > 0


def test_targets():
    rng = np.random.RandomState(3)
    B, M, N, C = 2, 4, 50, 6
    boxes, gt_valid = _gt_batch(rng, B, M, False)
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    gt_idx = rng.randint(-1, M, (B, N)).astype(np.int32)
    pv = rng.rand(B, N) > 0.2
    lm = np.asarray(jtargets.get_border_center(jnp.asarray(boxes)))
    np.testing.assert_array_equal(
        ttargets.get_border_center(t(boxes)).numpy(), lm)
    want = jax.vmap(lambda gi, v, gb, gl, gv, l: jtargets.build_stage_targets(
        gi, v, gb, gl, gv, l, C))(
        jnp.asarray(gt_idx), jnp.asarray(pv), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(gt_valid), jnp.asarray(lm))
    got = ttargets.build_stage_targets(t(gt_idx), t(pv), t(boxes), t(labels),
                                       t(gt_valid), t(lm), C)
    assert got.kp_vs is None and want.kp_vs is None
    for name in ("labels", "label_weights", "bboxes_gt", "bbox_weights",
                 "lm_gt", "num_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    anchor = rng.uniform(0, 90, (N, 2)).astype(np.float32)
    row_w = (gt_idx[0] >= 0).astype(np.float32)
    jreg, jpos = jtargets.encode_gt_reg(want.lm_gt[0], jnp.asarray(anchor),
                                        jnp.asarray(row_w))
    reg, pos = ttargets.encode_gt_reg(got.lm_gt[0], t(anchor), t(row_w))
    np.testing.assert_array_equal(reg.numpy(), np.asarray(jreg))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


def _head_outputs(rng, B, C):
    outs = {}
    for key, d in (("cls", C), ("bbox_init", 20), ("bbox_refine", 20)):
        outs[key] = []
        for h, w in jpoints.level_shapes(SHAPE, STRIDES):
            x = rng.randn(B, h, w, d).astype(np.float32)
            # landmark fields are softplus outputs: positive, a few px
            outs[key].append(x if key == "cls" else np.abs(x) + 0.5)
    return outs


def _on_bf16_grid(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case", ["boxes", "centroid", "no_gt",
                                  "bf16_ties"])
def test_lsnet_loss_value_and_gradient(case):
    """``bf16_ties``: the outputs of a bf16 forward at the training init,
    cast to f32 for the loss: landmark fields near softplus(0) = 0.693,
    where bf16 steps by 2^-8, so the decode's pair and extreme-point
    comparisons tie often; both packages must break the ties alike."""
    rng = np.random.RandomState(5)
    B, M, C = 2, 6, 7
    outs = _head_outputs(rng, B, C)
    if case == "bf16_ties":
        outs = {k: [_on_bf16_grid(x if k == "cls" else 0.672 + 0.04 * rng.rand(
            *x.shape).astype(np.float32)) for x in v] for k, v in outs.items()}
    lo = rng.uniform(0, 50, (B, M, 2))
    wh = rng.uniform(8, 70, (B, M, 2))          # GTs on several levels
    batch = dict(
        gt_bboxes=np.concatenate([lo, lo + wh], -1).astype(np.float32),
        gt_labels=rng.randint(0, C, (B, M)).astype(np.int32),
        gt_valid=np.array([[1] * M, [1] * (M - 2) + [0, 0]], bool),
        pad_shape=np.array([[96, 128], [80, 100]], np.int32))
    kw = dict(image_shape=SHAPE, num_classes=C, point_strides=STRIDES)
    if case == "centroid":
        kw["init_iou_type"] = "centroid"
        ex = ttargets.get_border_center(t(batch["gt_bboxes"])).numpy()
        ex[..., :8] += rng.uniform(-2, 2, (B, M, 8)).astype(np.float32)
        batch["gt_extremes"] = ex
    if case == "no_gt":
        batch["gt_valid"] = np.zeros((B, M), bool)

    def jf(o):
        return j_lsnet_loss(o, {k: jnp.asarray(v) for k, v in batch.items()},
                            JLossConfig(**kw))

    (want, jterms), jgrads = jax.value_and_grad(jf, has_aux=True)(
        {k: [jnp.asarray(x) for x in v] for k, v in outs.items()})
    touts = {k: [t(x).requires_grad_() for x in v] for k, v in outs.items()}
    got, terms = lsnet_loss(touts, {k: t(v) for k, v in batch.items()},
                            LossConfig(**kw))
    got.backward()
    _rel(got, want)
    assert set(terms) == set(jterms) == {"loss_cls", "loss_bbox_init",
                                         "loss_bbox_refine"}
    for k in terms:
        _rel(terms[k], jterms[k])
    if case == "no_gt":
        assert float(terms["loss_bbox_init"]) == 0.0
        assert float(terms["loss_bbox_refine"]) == 0.0
    else:
        assert float(terms["loss_bbox_init"]) > 0
        assert float(terms["loss_bbox_refine"]) > 0
    for k in outs:
        for g, w_ in zip(touts[k], jgrads[k]):
            assert_close(g.grad, w_)
    assert bool(torch.isfinite(got))


def test_lsnet_loss_other_tasks_wait():
    """The segm and pose tasks no longer wait (``tests/
    test_torch_task_loss.py`` holds them against JAX): segm asks for its
    polygons, and only a task LSNet does not have is refused."""
    outs = {k: [t(x) for x in v] for k, v in _head_outputs(
        np.random.RandomState(0), 2, 3).items()}
    with pytest.raises(KeyError, match="gt_polygons"):
        lsnet_loss(outs, {"pad_shape": torch.tensor([[96, 128]] * 2),
                          "gt_bboxes": torch.zeros(2, 1, 4),
                          "gt_labels": torch.zeros(2, 1, dtype=torch.long),
                          "gt_valid": torch.zeros(2, 1, dtype=torch.bool)},
                   LossConfig(image_shape=SHAPE, num_classes=3, task="segm"))
    with pytest.raises(ValueError, match="task"):
        lsnet_loss({}, {}, LossConfig(image_shape=SHAPE, num_classes=3,
                                      task="mask"))
