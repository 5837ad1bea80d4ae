"""The segm, pose_bbox and pose_kbox tasks of the port against the JAX
package, and the head of all four tasks against the reference's own maps.

* the narrow head (feat 32, 4 classes, 36 contour points or 17 keypoints,
  ``dcn`` and ``norm`` towers) on five level maps of a 64x96 image against
  ``lsnet_tpu.models.heads.ls_head.LSHead`` on the same minted weights:
  every output map within 1e-4 (f32 sums in another order);
* decode + NMS of the same head outputs in both packages: identical valid
  masks and labels, boxes, scores and landmarks within 1e-4; hard NMS for
  each task and soft-NMS as one more case (its kept indices show in the
  labels and boxes, its rescoring in the scores);
* a narrow X-101-shaped detector per task end to end under the shipped
  inference sampling, as ``tests/test_torch_x101.py`` does for bbox (head
  outputs 1e-4, the detections compared as a set, 1e-3);
* ``weights.to_jax_variables(load(v)) == v`` for each task's parameter
  names;
* for all four tasks, the head on the converted reference weights of
  ``tests/golden/head_forward.npz`` against the reference's maps there, at
  the tolerance of ``tests/test_golden_head_forward.py`` (atol 2e-4, rtol
  1e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _x101_flagship_cfg
from lsnet_tpu.core.decode import TestConfig as JTestConfig
from lsnet_tpu.core.decode import lsnet_decode as j_decode
from lsnet_tpu.core.decode import lsnet_decode_candidates as j_candidates
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models.heads.ls_head import LSHead as JLSHead
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train.checkpoint import convert_torch_lshead
from lsnet_torch import configs
from lsnet_torch.apis import detect
from lsnet_torch.core.decode import (TestConfig, lsnet_decode,
                                     lsnet_decode_candidates)
from lsnet_torch.models import build_detector
from lsnet_torch.models.heads.ls_head import LSHead
from lsnet_torch.ops.flat_deform import INFERENCE_SAMPLING
from lsnet_torch.weights import load_jax_variables, to_jax_variables
from test_torch_x101 import _as_set, _backbone_leaves
from torch_port_util import mint_variables, t, to_jax

torch.set_num_threads(1)

H, W, B, C = 64, 96, 2, 4
LEVELS = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
NV = {"bbox": 4, "segm": 36, "pose_bbox": 17, "pose_kbox": 17}
NEW_TASKS = ("segm", "pose_bbox", "pose_kbox")
HEAD_KW = dict(num_classes=C, in_channels=32, feat_channels=32,
               point_feat_channels=32, stacked_convs=1, norm_groups=8)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "head_forward.npz")


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


@pytest.fixture
def bilinear(monkeypatch):
    """Pin the JAX package's process-wide sampling policy: another test
    file in the same worker may have set it."""
    monkeypatch.setattr(jfd, "SAMPLING", ["bilinear"])
    monkeypatch.setattr(jfd, "SAMPLING_POLICY", {})


def _head_pair(task, towers, seed):
    """(minted variables, JAX head outputs as numpy, the port's head)."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, h, w, 32).astype(np.float32) for h, w in LEVELS]
    jhead = JLSHead(task=task, num_vectors=NV[task],
                    conv_module_type=towers, **HEAD_KW)
    v = mint_variables(jhead, [jnp.asarray(f[:1]) for f in feats], seed=seed)
    jouts = jax.jit(jhead.apply)(to_jax(v), [jnp.asarray(f) for f in feats])
    thead = LSHead(task=task, num_vectors=NV[task], conv_module_type=towers,
                   **HEAD_KW)
    load_jax_variables(thead, v)
    return v, jax.tree.map(np.asarray, jouts), thead.eval(), feats


@pytest.mark.parametrize("towers", ["dcn", "norm"])
@pytest.mark.parametrize("task", NEW_TASKS)
def test_head_matches_jax(bilinear, task, towers):
    _, jouts, thead, feats = _head_pair(task, towers, seed=len(task))
    with torch.no_grad():
        touts = thead([_nchw(f) for f in feats])
    branches = {"segm": ("segm",), "pose_bbox": ("bbox", "pose"),
                "pose_kbox": ("pose",)}[task]
    assert set(touts) == set(jouts) == {"cls"} | {
        f"{b}_{stage}" for b in branches for stage in ("init", "refine")}
    main = branches[-1]
    assert touts[f"{main}_refine"][0].shape[-1] == 4 * (NV[task] + 1)
    for key in jouts:
        assert len(touts[key]) == len(jouts[key]) == 5
        for g, w_ in zip(touts[key], jouts[key]):
            assert tuple(g.shape) == w_.shape
            np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-4)


def test_head_rejects_unknown_task_and_point_count():
    with pytest.raises(ValueError, match="task"):
        LSHead(task="mask", **HEAD_KW)
    with pytest.raises(ValueError, match="sampling points"):
        LSHead(task="segm", num_vectors=20, **HEAD_KW)   # 5 points, not 8


def _decode_kw(task, **extra):
    return dict(dict(image_shape=(H, W), num_classes=C, task=task,
                     num_vectors=NV[task], nms_pre=1000, score_thr=0.05,
                     nms_iou=0.6, max_per_img=100), **extra)


@pytest.mark.parametrize("task,extra", [
    ("segm", {}), ("pose_bbox", {}), ("pose_kbox", {}),
    # a low threshold, so that the random boxes do decay each other
    ("segm", dict(nms_type="soft_nms", nms_iou=0.2)),
    # one class and few candidates: k = min(nms_pre, T * C) and the
    # per-level min(nms_pre, n) take the smaller side
    ("pose_bbox", dict(nms_pre=100, max_per_img=20))],
    ids=["segm", "pose_bbox", "pose_kbox", "segm-soft_nms",
         "pose_bbox-nms_pre100"])
def test_decode_nms_matches_jax(bilinear, task, extra):
    _, jouts, _, _ = _head_pair(task, "norm", seed=3)
    kw = _decode_kw(task, **extra)
    shapes = np.array([[H, W], [H - 10, W - 20]], np.int32)
    sfs = np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]], np.float32)
    jargs = (jax.tree.map(jnp.asarray, jouts), jnp.asarray(shapes),
             jnp.asarray(sfs), JTestConfig(**kw))
    targs = ({k: [t(x) for x in v] for k, v in jouts.items()}, t(shapes),
             t(sfs), TestConfig(**kw))
    want = jax.jit(j_decode, static_argnums=3)(*jargs)
    got = lsnet_decode(*targs)
    valid = np.asarray(want.valid)
    assert valid.sum(axis=1).min() >= 1
    assert got.landmarks.shape == (B, kw["max_per_img"], 2 * NV[task])
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for name in ("bboxes", "scores", "landmarks"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
    if extra.get("nms_type") == "soft_nms":
        # soft-NMS rescored something: not the hard-NMS result
        hard = lsnet_decode(*targs[:3], TestConfig(**dict(kw, nms_type="nms")))
        assert not torch.equal(hard.scores, got.scores)
    # the candidates before NMS
    cand = lsnet_decode_candidates(*targs)
    jcand = jax.jit(j_candidates, static_argnums=3)(*jargs)
    for g, w_ in zip(cand, jcand):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-4)


def test_decode_rejects_mismatched_config(bilinear):
    _, jouts, _, _ = _head_pair("pose_kbox", "norm", seed=3)
    outs = {k: [t(x) for x in v] for k, v in jouts.items()}
    args = (outs, torch.tensor([[H, W]] * B), torch.ones(B, 4))
    with pytest.raises(ValueError, match="num_vectors"):
        lsnet_decode(*args, TestConfig(**dict(_decode_kw("pose_kbox"),
                                              num_vectors=4)))
    with pytest.raises(ValueError, match="task"):
        lsnet_decode(*args, TestConfig(**dict(_decode_kw("pose_kbox"),
                                              task="mask")))
    with pytest.raises(ValueError, match="nms_type"):
        lsnet_decode(*args, TestConfig(**_decode_kw("pose_kbox",
                                                    nms_type="fast")))


def _narrow(cfg, task):
    cfg["backbone"].update(depth=50, groups=8)
    cfg["bbox_head"].update(num_classes=C, task=task, num_vectors=NV[task])
    return cfg


@pytest.fixture(scope="module", params=NEW_TASKS)
def detector_pair(request):
    """JAX head outputs and detections of a narrow X-101-shaped detector
    under ``inference_sampling()``, and the port's model on the same
    variables (see ``tests/test_torch_x101.py`` for the zeroed backbone
    offset convs and the unit FrozenBatchNorm scales)."""
    task = request.param
    jmodel, _ = j_build(_narrow(_x101_flagship_cfg(feat=32, stacked=1), task))
    images = np.random.RandomState(5).randn(B, H, W, 3).astype(np.float32)
    v = mint_variables(jmodel, jnp.asarray(images[:1]), seed=6)
    params = dict(v["params"])
    params["backbone"] = _backbone_leaves(params["backbone"],
                                          zero_offsets=True)
    v = dict(v, params=params)
    shapes = np.array([[H, W], [H - 10, W - 20]], np.int32)
    sfs = np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]], np.float32)
    kw = _decode_kw(task)

    def e2e(variables, images, shapes, sfs):
        with jfd.inference_sampling():
            outs = jmodel.apply(variables, images)
        return outs, j_decode(outs, shapes, sfs, JTestConfig(**kw))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        mp.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        mp.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])
        jouts, jdet = jax.jit(e2e)(to_jax(v), jnp.asarray(images),
                                   jnp.asarray(shapes), jnp.asarray(sfs))
    cfg = _narrow(getattr(configs, f"x101_{task}_cfg")(feat=32, stacked=1),
                  task)
    tmodel = build_detector(cfg)
    load_jax_variables(tmodel, v)
    return (task, v, jax.tree.map(np.asarray, jouts), jdet, tmodel.eval(),
            images, shapes, sfs)


def test_detector_matches_jax_inference_sampling(detector_pair):
    task, _, jouts, jdet, tmodel, images, shapes, sfs = detector_pair
    with torch.no_grad():
        touts = tmodel(t(images), INFERENCE_SAMPLING)
    assert set(touts) == set(jouts)
    for key in jouts:
        for g, w_ in zip(touts[key], jouts[key]):
            np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-4)
    det = detect(tmodel, t(images), t(shapes), t(sfs),
                 TestConfig(**_decode_kw(task)))
    valid = np.asarray(jdet.valid)
    assert valid.sum(axis=1).min() >= 1
    np.testing.assert_array_equal(det.valid.numpy(), valid)
    for i in range(B):
        got, want = _as_set(det, i), _as_set(jdet, i)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for name in ("bboxes", "scores", "landmarks"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                       atol=1e-3)


def test_weights_round_trip(detector_pair):
    """Every new parameter name maps one to one both ways."""
    task, v, _, _, tmodel, *_ = detector_pair
    back = to_jax_variables(tmodel)

    def leaves(tree):
        return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    got, want = leaves(back), leaves(v)
    assert set(got) == set(want)
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key], ref, key)
    main = "segm" if task == "segm" else "pose"
    assert f"['params']['head']['pts_{main}_cls_pair']['weight_a']" in got
    assert ("['params']['head']['pts_bbox_refine_conv']['weight']" in got) \
        == (task == "pose_bbox")


@pytest.mark.parametrize("task", sorted(NV))
def test_head_matches_reference_golden(task):
    """The reference implementation's own numbers: its weights (``sd::``
    keys), converted as a checkpoint would be, and its per-level maps."""
    g = np.load(GOLDEN)
    pre = f"{task}::"
    sd = {k[len(pre) + 4:]: g[k] for k in g.files
          if k.startswith(pre + "sd::")}
    params = jax.tree.map(np.asarray, convert_torch_lshead(sd, task=task))
    head = LSHead(num_classes=4, in_channels=32, feat_channels=32,
                  point_feat_channels=32, stacked_convs=2, task=task,
                  num_vectors=NV[task], norm_groups=8,
                  conv_module_type="norm")
    load_jax_variables(head, {"params": params})
    with torch.no_grad():
        outs = head.eval()([_nchw(g[f"{pre}feat{i}"]) for i in range(5)])
    keys = [k for k in outs]
    assert len(keys) == {"bbox": 3, "segm": 3, "pose_bbox": 5,
                         "pose_kbox": 3}[task]
    for name in keys:
        for lvl in range(5):
            np.testing.assert_allclose(
                outs[name][lvl].numpy(), g[f"{pre}{name}{lvl}"], atol=2e-4,
                rtol=1e-3, err_msg=f"{task} {name} lvl{lvl}")
