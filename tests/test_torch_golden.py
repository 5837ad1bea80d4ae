"""The port against the reference implementation's own numbers.

``tests/golden/*.npz`` hold the outputs of the reference's CPU torch code
on seeded inputs (``tools/gen_golden.py``): the cross-IOU loss, the
landmark encode and decode, the assigners, the polygon pipeline, a
ResNet-50 + FPN forward with its ``state_dict`` (``sd::`` keys) and the
assembled LSHead of each task with its ``state_dict`` (``{task}::sd::``
keys). This file reads them through port code only: the weights go
through the port's own ``convert_torch_backbone`` / ``_neck`` /
``_lshead`` into the port's modules. The inputs and tolerances are those
of ``tests/test_golden_parity.py`` and ``tests/test_golden_head_forward.py``
(the JAX package's): loss 1e-5 relative, encode and assign exact or
1e-6, backbone and FPN maps 1e-4 of max|ref|, head maps 2e-4 absolute
plus 1e-3 relative.
"""

import os

import numpy as np
import pytest
import torch

from lsnet_torch.core.assign import atss_assign, centroid_assign
from lsnet_torch.core.targets import (encode_gt_reg, get_border_center,
                                      keypoints_with_bbox,
                                      keypoints_with_kbox)
from lsnet_torch.data.lsvr import uniform_sample, unify_polygon
from lsnet_torch.models.backbones.resnet import ResNet
from lsnet_torch.models.heads.ls_head import (LSHead, extreme_points2bbox,
                                              vectors2bbox)
from lsnet_torch.models.losses.cross_iou import cross_iou_loss
from lsnet_torch.models.necks.fpn import FPN
from lsnet_torch.ops.nms import box_iou
from lsnet_torch.train.checkpoint import (convert_torch_backbone,
                                          convert_torch_lshead,
                                          convert_torch_neck)

torch.set_num_threads(1)

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
HEAD_TASKS = {"bbox": 4, "segm": 36, "pose_bbox": 17, "pose_kbox": 17}


def _load(name):
    return np.load(os.path.join(GOLD, name))


def _t(x):
    return torch.from_numpy(np.array(x))


def _nlc(x):
    """(B, C, H, W) -> (B*H*W, C), the flat channel-last rows."""
    b, c, h, w = x.shape
    return x.transpose(0, 2, 3, 1).reshape(-1, c)


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["bbox", "polygon", "keypoint"])
def test_cross_iou_loss(mode):
    g = _load("cross_iou.npz")
    kwargs = dict(loss_type=mode, anchor_pts=_t(g[f"{mode}_anchor"]),
                  pos_inds=_t(g[f"{mode}_pos_inds"]),
                  avg_factor=float(g[f"{mode}_avg_factor"]), alpha=0.2,
                  stride=9)
    if mode == "keypoint":
        kwargs["vs"] = _t(g[f"{mode}_vs"])
    else:
        kwargs["bbox_gt"] = _t(g[f"{mode}_bbox_gt"])
    loss = cross_iou_loss(_t(g[f"{mode}_pred"]), _t(g[f"{mode}_target"]),
                          _t(g[f"{mode}_weight"]), **kwargs)
    np.testing.assert_allclose(float(loss), float(g[f"{mode}_loss"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fn", ["extreme_points2bbox", "vectors2bbox"])
def test_landmarks_to_boxes(fn):
    g = _load("head_encode.npz")
    pre, names = {"extreme_points2bbox": ("e2b", ("extremes", "bbox")),
                  "vectors2bbox": ("v2b", ("vectors", "bbox"))}[fn]
    decode = {"extreme_points2bbox": extreme_points2bbox,
              "vectors2bbox": vectors2bbox}[fn]
    outs = decode(_t(_nlc(g[f"{pre}_pts"])))
    for got, name in zip(outs, names):
        _close(got, _nlc(g[f"{pre}_{name}"]))


@pytest.mark.parametrize("mode,task,nv", [
    ("bbox", "bbox", 4), ("segm", "segm", 36), ("pose", "pose_bbox", 17)])
def test_get_pred_reg(mode, task, nv):
    g = _load("head_encode.npz")
    head = LSHead(num_classes=1, in_channels=8, feat_channels=8,
                  point_feat_channels=8, stacked_convs=1, task=task,
                  num_vectors=nv, norm_groups=4)
    r1 = _t(_nlc(g[f"predreg_{mode}_r1"]))
    r2 = _t(_nlc(g["predreg_bbox_r2"])) if mode == "bbox" else None
    _close(head._get_pred_reg(r1, r2), _nlc(g[f"predreg_{mode}_out"]))


@pytest.mark.parametrize("key", ["gtreg_bbox", "gtreg_poly"])
def test_encode_gt_reg(key):
    g = _load("head_encode.npz")
    anchor = g["gtreg_bbox_anchor"]
    reg, inds = encode_gt_reg(_t(g[f"{key}_pts"]), _t(anchor[:, :2]),
                              _t(g["gtreg_bbox_weights"][:, 0]))
    np.testing.assert_allclose(reg.numpy(), g[f"{key}_out"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(inds.numpy(), g[f"{key}_inds"])


@pytest.mark.parametrize("fn", ["get_border_center", "keypoints_with_bbox",
                                "keypoints_with_kbox"])
def test_target_points(fn):
    g = _load("head_encode.npz")
    boxes, kvs = _t(g["border_center_boxes"]), _t(g["kp_bbox_kvs"])
    if fn == "get_border_center":
        _close(get_border_center(boxes), g["border_center_out"])
    elif fn == "keypoints_with_bbox":
        kps, vs = keypoints_with_bbox(boxes, kvs)
        _close(kps, g["kp_bbox_out"])
        np.testing.assert_allclose(vs.numpy(), g["kp_bbox_vs"])
    else:
        kps, kbox, vs = keypoints_with_kbox(kvs)
        _close(kps, g["kp_kbox_out"])
        _close(kbox, g["kp_kbox_boxes"])
        np.testing.assert_allclose(vs.numpy(), g["kp_kbox_vs"])


def test_box_iou():
    g = _load("assigners.npz")
    got = box_iou(_t(g["atss_cand"]), _t(g["atss_gt"]))
    np.testing.assert_allclose(got.numpy(), g["iou_matrix"], rtol=1e-5,
                               atol=1e-6)


def test_atss_assign():
    """The port's assigners take a batch: one image here. The reference's
    indices are 1-based with 0 negative, the port's 0-based with -1."""
    g = _load("assigners.npz")
    cand, gt = _t(g["atss_cand"])[None], _t(g["atss_gt"])[None]
    res = atss_assign(cand, torch.ones(cand.shape[:2], dtype=torch.bool),
                      [int(v) for v in g["atss_num_level"]], gt,
                      torch.ones(gt.shape[:2], dtype=torch.bool), topk=9)
    np.testing.assert_array_equal(res.gt_idx[0].numpy(),
                                  g["atss_assigned"].astype(np.int64) - 1)


@pytest.mark.parametrize("iou_type", ["center", "centroid"])
def test_centroid_assign(iou_type):
    g = _load("assigners.npz")
    points, gt = _t(g["cent_points"]), _t(g["cent_gt"])[None]
    res = centroid_assign(points,
                          torch.ones((1, points.shape[0]), dtype=torch.bool),
                          gt, torch.ones(gt.shape[:2], dtype=torch.bool),
                          _t(g["cent_ext"])[None], scale=4.0, pos_num=1,
                          iou_type=iou_type)
    np.testing.assert_array_equal(
        res.gt_idx[0].numpy(),
        g[f"cent_{iou_type}_assigned"].astype(np.int64) - 1)


@pytest.mark.parametrize("tag", ["up", "down", "cw"])
def test_uniform_sample(tag):
    g = _load("polygons.npz")
    _close(uniform_sample(g[f"{tag}_in"].copy(), 360), g[f"{tag}_uniform"])


@pytest.mark.parametrize("tag", ["up", "down", "cw", "tiny"])
def test_unify_polygon(tag):
    g = _load("polygons.npz")
    comps = ([g[f"{tag}_in"].reshape(-1)] if f"{tag}_in" in g
             else [np.array([1.0, 1.0, 1.2, 1.0, 1.2, 1.2])])
    got = unify_polygon(comps, g[f"{tag}_bbox"], num_points=36)
    _close(np.asarray(got).reshape(-1), g[f"{tag}_unified"])


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def test_backbone_fpn_forward():
    """The reference's ResNet-50 + FPN ``state_dict`` through the port's
    converters into the port's modules (strict: every entry filled),
    then each stage and FPN level against the reference's maps."""
    g = _load("backbone_fwd.npz")
    sd = {k[4:]: g[k] for k in g.files if k.startswith("sd::")}
    backbone = ResNet(depth=50, num_stages=4, out_indices=(0, 1, 2, 3))
    backbone.load_state_dict(convert_torch_backbone(
        {k: v for k, v in sd.items() if k.startswith("backbone.")}),
        strict=True)
    neck = FPN(backbone.out_channels, out_channels=64, num_outs=5,
               start_level=1, norm_cfg=dict(type="GN", num_groups=32))
    neck.load_state_dict(convert_torch_neck(
        {k: v for k, v in sd.items() if k.startswith("neck.")}),
        strict=True)
    with torch.no_grad():
        feats = backbone.eval()(_t(g["image"]).permute(0, 3, 1, 2))
        outs = neck.eval()(list(feats))
    for name, maps in (("c", feats), ("p", outs)):
        for i, m in enumerate(maps):
            err = _rel_err(m.permute(0, 2, 3, 1).numpy(), g[f"{name}{i}"])
            assert err < 1e-4, f"{name}{i}: {err:.3g}"


@pytest.mark.parametrize("task", sorted(HEAD_TASKS))
def test_head_forward(task):
    """The reference head's ``state_dict`` through the port's
    ``convert_torch_lshead`` (strict), then every per-level output map."""
    g = _load("head_forward.npz")
    pre = f"{task}::"
    sd = {k[len(pre) + 4:]: g[k] for k in g.files
          if k.startswith(pre + "sd::")}
    head = LSHead(num_classes=4, in_channels=32, feat_channels=32,
                  point_feat_channels=32, stacked_convs=2, task=task,
                  num_vectors=HEAD_TASKS[task], norm_groups=8,
                  conv_module_type="norm")
    head.load_state_dict(convert_torch_lshead(sd, task=task), strict=True)
    with torch.no_grad():
        outs = head.eval()([_t(g[f"{pre}feat{i}"]).permute(0, 3, 1, 2)
                            for i in range(5)])
    assert len(outs) == {"bbox": 3, "segm": 3, "pose_bbox": 5,
                         "pose_kbox": 3}[task]
    for name, maps in outs.items():
        for lvl, m in enumerate(maps):
            np.testing.assert_allclose(
                m.numpy(), g[f"{pre}{name}{lvl}"], atol=2e-4, rtol=1e-3,
                err_msg=f"{task} {name} lvl{lvl}")
