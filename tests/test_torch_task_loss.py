"""Training of the segm, pose_bbox and pose_kbox tasks against the JAX
package: the three target helpers (exact: the same f32 operations),
``lsnet_loss`` per task in value (1e-5 relative) and in gradient with
respect to every head output (1e-4 * max(1, max|ref|): f32 sums in another
order), and one narrow X-101-shaped ``pose_bbox`` model (the task with the
most branches: three towers, two refine gathers, five loss terms) whose
parameters after 3 train steps must lie within 1e-4 * max(1, max|ref|) of
the JAX train step's, with the harness of ``tests/test_torch_train.py``.

Ground truth is minted with numpy: 36-point contours on an ellipse inside
each box, 17 keypoints inside each box with visibility 0 / 1 / 2 (invisible
ones at (0, 0), as COCO stores them), and one instance with no visible
keypoint, marked invalid as the data pipeline does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _x101_flagship_cfg
from lsnet_tpu.core import points as jpoints
from lsnet_tpu.core import targets as jtargets
from lsnet_tpu.core.loss import LossConfig as JLossConfig
from lsnet_tpu.core.loss import lsnet_loss as j_lsnet_loss
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models.backbones.resnet import frozen_param_paths
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import optim as joptim
from lsnet_tpu.train.step import create_train_state
from lsnet_tpu.train.step import make_train_step as j_make_train_step
from lsnet_torch import configs
from lsnet_torch.core import targets as ttargets
from lsnet_torch.core.loss import LossConfig, lsnet_loss
from lsnet_torch.models import build_detector
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.train.step import make_train_step
from lsnet_torch.weights import load_jax_variables, to_jax_variables
from test_torch_train import OPTIM, _leaves, _unit_scales
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

SHAPE = (96, 128)
STRIDES = (8, 16, 32, 64, 128)
NV = {"segm": 36, "pose_bbox": 17, "pose_kbox": 17}
TERMS = {"segm": {"loss_cls", "loss_segm_init", "loss_segm_refine"},
         "pose_bbox": {"loss_cls", "loss_bbox_init", "loss_bbox_refine",
                       "loss_pose_init", "loss_pose_refine"},
         "pose_kbox": {"loss_cls", "loss_pose_init", "loss_pose_refine"}}


def _ground_truth(rng, B, M, hw, num_classes, blind=True):
    """Boxes, labels, validity, contours and keypoints of a batch. With
    ``blind`` the last instance of the last image has no visible keypoint
    and is invalid."""
    h, w = hw
    lo = rng.uniform(0, 0.45, (B, M, 2)) * [w, h]
    wh = rng.uniform(0.1, 0.5, (B, M, 2)) * [w, h]
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    ang = np.linspace(0, 2 * np.pi, 36, endpoint=False)
    centre = lo + wh / 2
    radius = wh / 2 * rng.uniform(0.6, 1.0, (B, M, 1))
    poly = centre[:, :, None, :] + radius[:, :, None, :] * np.stack(
        [np.cos(ang), np.sin(ang)], -1)
    kxy = lo[:, :, None, :] + rng.uniform(0, 1, (B, M, 17, 2)) \
        * wh[:, :, None, :]
    vs = rng.randint(0, 3, (B, M, 17, 1)).astype(np.float64)
    valid = np.ones((B, M), bool)
    if blind:
        vs[-1, -1] = 0.0
        valid[-1, -1] = False
    kxy = np.where(vs > 0, kxy, 0.0)
    return {
        "gt_bboxes": boxes,
        "gt_labels": rng.randint(0, num_classes, (B, M)).astype(np.int32),
        "gt_valid": valid,
        "gt_polygons": poly.reshape(B, M, 72).astype(np.float32),
        "gt_keypoints_vs": np.concatenate([kxy, vs], -1).reshape(
            B, M, 51).astype(np.float32),
    }


def test_target_helpers_match_jax():
    gt = _ground_truth(np.random.RandomState(0), 2, 5, SHAPE, 3)
    boxes, kvs, polys = (gt["gt_bboxes"], gt["gt_keypoints_vs"],
                         gt["gt_polygons"])
    want = jtargets.keypoints_with_bbox(jnp.asarray(boxes), jnp.asarray(kvs))
    got = ttargets.keypoints_with_bbox(t(boxes), t(kvs))
    assert got[0].shape == (2, 5, 36) and got[1].shape == (2, 5, 17)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    want = jtargets.keypoints_with_kbox(jnp.asarray(kvs))
    got = ttargets.keypoints_with_kbox(t(kvs))
    assert got[1].shape == (2, 5, 4)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    # the box spans the visible keypoints only; none visible: degenerate
    vis = kvs.reshape(2, 5, 17, 3)[0, 0]
    vis = vis[vis[:, 2] > 0]
    np.testing.assert_array_equal(
        got[1][0, 0].numpy(), [vis[:, 0].min(), vis[:, 1].min(),
                               vis[:, 0].max(), vis[:, 1].max()])
    np.testing.assert_array_equal(got[1][-1, -1].numpy(),
                                  [1e7, 1e7, -1.0, -1.0])
    want = jtargets.polygons_to_gt(jnp.asarray(polys))
    got = ttargets.polygons_to_gt(t(polys))
    assert got[0].shape == (2, 5, 74) and got[1].shape == (2, 5, 4)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_stage_targets_carry_visibility():
    rng = np.random.RandomState(1)
    gt = _ground_truth(rng, 2, 4, SHAPE, 3)
    gt_idx = rng.randint(-1, 4, (2, 50)).astype(np.int32)
    pv = rng.rand(2, 50) > 0.2
    kps, vs = ttargets.keypoints_with_bbox(t(gt["gt_bboxes"]),
                                           t(gt["gt_keypoints_vs"]))
    want = jax.vmap(lambda gi, v, gb, gl, gv, lm, kv:
                    jtargets.build_stage_targets(gi, v, gb, gl, gv, lm, 3,
                                                 kv))(
        jnp.asarray(gt_idx), jnp.asarray(pv), jnp.asarray(gt["gt_bboxes"]),
        jnp.asarray(gt["gt_labels"]), jnp.asarray(gt["gt_valid"]),
        jnp.asarray(kps.numpy()), jnp.asarray(vs.numpy()))
    got = ttargets.build_stage_targets(
        t(gt_idx), t(pv), t(gt["gt_bboxes"]), t(gt["gt_labels"]),
        t(gt["gt_valid"]), kps, 3, vs)
    assert got.kp_vs.shape == (2, 50, 17)
    for name in ("labels", "lm_gt", "kp_vs", "bbox_weights", "num_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def _head_outputs(rng, B, C, task):
    dims = {"cls": C}
    nv4 = 4 * (NV[task] + 1)
    if task == "segm":
        dims.update(segm_init=nv4, segm_refine=nv4)
    else:
        dims.update(pose_init=nv4, pose_refine=nv4)
    if task == "pose_bbox":
        dims.update(bbox_init=20, bbox_refine=20)
    outs = {}
    for key, d in dims.items():
        outs[key] = []
        for h, w in jpoints.level_shapes(SHAPE, STRIDES):
            x = rng.randn(B, h, w, d).astype(np.float32)
            # landmark fields are softplus outputs: positive, a few px
            outs[key].append(x if key == "cls" else np.abs(x) + 0.5)
    return outs


@pytest.mark.parametrize("task", sorted(NV))
def test_lsnet_loss_value_and_gradient(task):
    rng = np.random.RandomState(len(task))
    B, M, C = 2, 6, 1 if task.startswith("pose") else 5
    outs = _head_outputs(rng, B, C, task)
    batch = _ground_truth(rng, B, M, SHAPE, C)
    batch["pad_shape"] = np.array([[96, 128], [80, 100]], np.int32)
    kw = dict(image_shape=SHAPE, num_classes=C, point_strides=STRIDES,
              task=task, num_vectors=NV[task], **configs.LOSS_WEIGHTS[task])

    def jf(o):
        return j_lsnet_loss(o, {k: jnp.asarray(v) for k, v in batch.items()},
                            JLossConfig(**kw))

    (want, jterms), jgrads = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        {k: [jnp.asarray(x) for x in v] for k, v in outs.items()})
    touts = {k: [t(x).requires_grad_() for x in v] for k, v in outs.items()}
    got, terms = lsnet_loss(touts, {k: t(v) for k, v in batch.items()},
                            LossConfig(**kw))
    got.backward()
    assert bool(torch.isfinite(got))
    assert set(terms) == set(jterms) == TERMS[task]
    for k in terms:
        term = float(terms[k].detach())
        assert term > 0, k
        assert abs(term - float(jterms[k])) <= 1e-5 * max(
            1.0, abs(float(jterms[k]))), k
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * max(
        1.0, abs(float(want)))
    for k in outs:
        for g, w_ in zip(touts[k], jgrads[k]):
            assert bool(torch.isfinite(g.grad).all())
            assert_close(g.grad, w_)
        # every branch the task trains takes gradient
        assert max(float(x.grad.abs().max()) for x in touts[k]) > 0, k


def test_blind_instance_gives_zero_weight_not_nan():
    """pose_kbox with an instance that has no visible keypoint: its box is
    degenerate, it is invalid, and no term may turn NaN, in bf16-rounded
    head outputs too."""
    rng = np.random.RandomState(4)
    outs = _head_outputs(rng, 2, 1, "pose_kbox")
    batch = _ground_truth(rng, 2, 3, SHAPE, 1)
    batch["gt_keypoints_vs"].reshape(2, 3, 17, 3)[0, :, :, 2] = 0.0
    batch["gt_valid"][0] = False             # a whole image without poses
    batch["pad_shape"] = np.array([[96, 128]] * 2, np.int32)
    cfg = LossConfig(image_shape=SHAPE, num_classes=1, task="pose_kbox",
                     num_vectors=17)
    touts = {k: [t(x).to(torch.bfloat16).float().requires_grad_()
                 for x in v] for k, v in outs.items()}
    total, terms = lsnet_loss(touts, {k: t(v) for k, v in batch.items()}, cfg)
    total.backward()
    assert all(bool(torch.isfinite(x)) for x in terms.values())
    for v in touts.values():
        for x in v:
            assert bool(torch.isfinite(x.grad).all())
    # image 0 has no positive: only the cls branch sees it
    assert float(touts["pose_refine"][0].grad[0].abs().max()) == 0.0
    assert float(touts["pose_refine"][0].grad[1].abs().max()) > 0.0


def test_lsnet_loss_rejects_unknown_task():
    with pytest.raises(ValueError, match="task"):
        lsnet_loss({}, {}, LossConfig(image_shape=SHAPE, num_classes=3,
                                      task="mask"))


# ----------------------------------------------- three steps of pose_bbox
H, W, B, M = 64, 96, 2, 4


def _pose_cfgs():
    jcfg = _x101_flagship_cfg(feat=32, stacked=1)
    tcfg = configs.x101_pose_bbox_cfg(feat=32, stacked=1)
    for cfg in (jcfg, tcfg):
        cfg["backbone"].update(depth=50, groups=8)
        cfg["bbox_head"].update(task="pose_bbox", num_vectors=17,
                                num_classes=1)
    return jcfg, tcfg


def test_pose_bbox_three_steps_match_jax():
    jcfg, tcfg = _pose_cfgs()
    jmodel, _ = j_build(jcfg)
    rng = np.random.RandomState(7)
    batch = _ground_truth(rng, B, M, (H, W), 1)
    batch["image"] = rng.randn(B, H, W, 3).astype(np.float32)
    batch["pad_shape"] = np.array([[H, W], [H - 8, W - 16]], np.int32)
    del batch["gt_polygons"]
    v = mint_variables(jmodel, jnp.asarray(batch["image"][:1]), seed=8)
    params = dict(v["params"])
    params["backbone"] = _unit_scales(params["backbone"])
    v = dict(v, params=params)
    mask = joptim.make_frozen_mask(v["params"], frozen_param_paths(50, 1))
    lcfg_kw = dict(image_shape=(H, W), num_classes=1, task="pose_bbox",
                   num_vectors=17, **configs.LOSS_WEIGHTS["pose_bbox"])
    tx, _ = joptim.build_optimizer(
        OPTIM["base_lr"], OPTIM["steps_per_epoch"], OPTIM["decay_epochs"],
        clip_norm=OPTIM["clip_norm"], warmup_iters=OPTIM["warmup_iters"],
        warmup_ratio=OPTIM["warmup_ratio"], trainable_mask=mask)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        state = create_train_state(to_jax(v), tx)
        jstep = j_make_train_step(jmodel, tx, JLossConfig(**lcfg_kw),
                                  mixed_precision=False)
        jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
        jlosses = []
        for _ in range(3):
            state, metrics = jstep(state, jbatch)
            jlosses.append(float(metrics["loss"]))

    model = build_detector(tcfg)
    load_jax_variables(model, v)
    model.train()
    optimizer, _ = build_optimizer(model.parameters(), **OPTIM)
    step = make_train_step(model, optimizer, LossConfig(**lcfg_kw),
                           mixed_precision=False)
    tbatch = {k: t(x) for k, x in batch.items()}
    history = [step(tbatch) for _ in range(3)]
    for m, want in zip(history, jlosses):
        assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want)
        assert set(m) == TERMS["pose_bbox"] | {"loss", "grad_norm"}
    got = _leaves(to_jax_variables(model)["params"])
    want = _leaves(state.params)
    before = _leaves(v["params"])
    trainable = _leaves(mask)
    assert set(got) == set(want)
    for key, ref in want.items():
        assert_close(got[key], ref, rel=1e-4)
        if trainable[key]:
            assert np.abs(got[key] - before[key]).max() > 0, key
        else:
            np.testing.assert_array_equal(got[key], before[key], key)
    # all three towers and both refine gathers trained
    for name in ("bbox_convs_0", "pose_convs_0", "cls_convs_0",
                 "pts_bbox_refine_conv", "pts_pose_cls_pair"):
        assert any(name in k and trainable[k] for k in got), name
