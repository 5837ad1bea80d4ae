"""Dense RepPoints v1 / v2 in the port against the JAX package, on the CPU.

Inputs are made with numpy from seeds; weights are the JAX modules'
minted variables (``torch_port_util.mint_variables``) loaded through
``weights.from_jax_variables``. The heads are narrow, as the JAX
package's own tests make them: 32 channels, one stacked conv and one mask
conv, 4 classes, 49 points in 7 groups, 25 score groups, a 64x64 canvas.
The JAX heads, losses, parameter gradients and decode run in one
compiled function for the file; the small ops run eagerly.

* ``chamfer_distance`` (with and without validity masks): values and
  gradients 1e-5 of max(1, max|ref|);
* ``resample_polygon`` (padding polygons and repeated vertices
  included) 1e-5; ``point_in_polygon`` and ``grid_group_partition``
  equal;
* ``border_sample`` and ``sample_offset_feature`` (points outside the map
  included), the port's per-point flow read ``sample_own_flow`` against
  JAX's ``vmap`` of ``border_sample`` over the points, and
  ``sample_group_scores``, which reads only the selected channel, against
  JAX's full form (all G channels, then one): values and gradients 1e-5;
* each head's outputs 1e-4; each loss's terms 1e-5 and every head
  parameter's gradient 1e-4 of max(1, max|ref|);
* the decode on random head outputs: the same valid mask and labels,
  boxes, scores, point sets and point scores 1e-5 of their scale; and
  ``dense_points_to_masks`` on those detections: equal masks;
* the runner: one narrow step and an evaluation (by bbox) of both files
  through ``train_detector`` / ``evaluate_detector``, the pipeline on the
  segm task's 36-point polygons; the image-level API refuses the files
  and names ``tools.test``.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core import dense_reppoints as jdrp
from lsnet_tpu.core.decode import TestConfig as JTestConfig
from lsnet_tpu.models.heads import dense_reppoints as jdh
from lsnet_tpu.ops.misc import chamfer_distance as j_chamfer
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch import apis
from lsnet_torch.core import dense_reppoints as drp
from lsnet_torch.core.decode import TestConfig
from lsnet_torch.models.heads import dense_reppoints as dh
from lsnet_torch.ops.misc import chamfer_distance
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import loop as ploop
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import load_jax_variables, to_jax_variables
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 64
B, C, M, V = 2, 4, 4, 8
LEVELS = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
PTS = dict(num_points=49, num_group=7, num_score_group=25)
HEAD_KW = dict(num_classes=C, in_channels=32, feat_channels=32,
               point_feat_channels=32, stacked_convs=1,
               stacked_mask_convs=1, **PTS)
HEADS = {"v1": (jdh.DenseRepPointsHead, dh.DenseRepPointsHead),
         "v2": (jdh.DenseRepPointsV2Head, dh.DenseRepPointsV2Head)}
OUT_KEYS = {"v1": ("cls", "pts_init", "pts_refine", "pts_score"),
            "v2": ("cls", "pts_init", "pts_refine", "pts_score", "sem",
                   "hm_tl", "off_tl")}
CFG_KW = dict(image_shape=(H, W), num_classes=C, max_pos_chamfer=8,
              gt_contour_points=24, **PTS)
# 86 grid points: the JAX NMS takes its top max_per_img of them
TEST_KW = dict(image_shape=(H, W), num_classes=C, nms_pre=1000,
               score_thr=0.05, nms_iou=0.6, max_per_img=50)


def _rel(got, want, rel=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(1.0, abs(want)), (got, want)


def _star(rng, cx, cy, r, n=V):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.5, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)


def _polygons(rng):
    """(B, M, V, 2) star polygons, a repeated vertex, one padding (zero)
    polygon."""
    polys = np.stack([np.stack([_star(rng, *rng.uniform(16, 48, 2),
                                      rng.uniform(8, 16))
                                for _ in range(M)]) for _ in range(B)])
    polys[0, 1, 3] = polys[0, 1, 2]
    polys[1, 3] = 0.0
    return polys.astype(np.float32)


# ------------------------------------------------------------ small ops

@pytest.mark.parametrize("masks", ["none", "valid1", "valid2", "both"])
def test_chamfer_distance_matches_jax(masks):
    rng = np.random.RandomState(len(masks))
    a = rng.randn(3, 11, 2).astype(np.float32)
    b = rng.randn(3, 7, 2).astype(np.float32)
    v1 = rng.rand(3, 11) > 0.3 if masks in ("valid1", "both") else None
    v2 = rng.rand(3, 7) > 0.3 if masks in ("valid2", "both") else None
    p1, p2 = rng.rand(3, 11), rng.rand(3, 7)

    def jf(x, y):
        d1, d2 = j_chamfer(x, y, None if v1 is None else jnp.asarray(v1),
                           None if v2 is None else jnp.asarray(v2))
        return jnp.sum(jnp.minimum(d1, 50.0) * p1) + jnp.sum(
            jnp.minimum(d2, 50.0) * p2), (d1, d2)

    with jax.disable_jit():
        (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(a),
                                                         jnp.asarray(b))
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    got = chamfer_distance(ta, tb, None if v1 is None else t(v1),
                           None if v2 is None else t(v2))
    ((got[0].clamp(max=50.0) * t(p1)).sum()
     + (got[1].clamp(max=50.0) * t(p2)).sum()).backward()
    for g, w_ in zip(got, want):
        assert_close(g, np.asarray(w_), rel=1e-5)
    assert_close(ta.grad, np.asarray(jg[0]), rel=1e-5)
    assert_close(tb.grad, np.asarray(jg[1]), rel=1e-5)


@pytest.mark.parametrize("n", [24, 128])
def test_resample_polygon_matches_jax(n):
    polys = _polygons(np.random.RandomState(n))
    want = jax.vmap(jax.vmap(lambda p: jdrp.resample_polygon(p, n)))(
        jnp.asarray(polys))
    got = drp.resample_polygon(t(polys), n)
    assert_close(got, np.asarray(want), rel=1e-5)


def test_point_in_polygon_matches_jax():
    rng = np.random.RandomState(8)
    polys = _polygons(rng)
    pts = rng.uniform(0, 64, (B, M, 300, 2)).astype(np.float32)
    pts[0, 0, :V] = polys[0, 0]                  # on the vertices
    pts[0, 0, V] = polys[0, 0, 0]
    pts[0, 0, V, 1] = polys[0, 0, 1, 1]          # level with a vertex
    want = jax.vmap(jax.vmap(jdrp.point_in_polygon))(jnp.asarray(polys),
                                                     jnp.asarray(pts))
    got = drp.point_in_polygon(t(polys), t(pts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.float().mean() < 1


def _coords(rng, shape, H_, W_):
    """Sample coordinates over and around a (H_, W_) map."""
    return (rng.uniform(-3, W_ + 2, shape).astype(np.float32),
            rng.uniform(-3, H_ + 2, shape).astype(np.float32))


def test_border_sample_and_offset_feature_match_jax():
    rng = np.random.RandomState(9)
    feat = rng.randn(B, 6, 7, 5).astype(np.float32)
    xs, ys = _coords(rng, (B, 6, 7, 4), 6, 7)
    probe = rng.randn(B, 6, 7, 4, 5).astype(np.float32)

    def jf(f, x, y):
        out = jax.vmap(jdh.border_sample)(f, x, y)
        return jnp.sum(out * probe), out

    (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(feat), jnp.asarray(xs), jnp.asarray(ys))
    tf_, tx, ty = (t(a).requires_grad_() for a in (feat, xs, ys))
    got = dh.border_sample(tf_, tx, ty)
    (got * t(probe)).sum().backward()
    assert_close(got, np.asarray(want), rel=1e-5)
    for g, w_ in zip((tf_, tx, ty), jg):
        assert_close(g.grad, np.asarray(w_), rel=1e-5)
    flow = (2 * rng.randn(B, 6, 7, 3, 2)).astype(np.float32)
    want = jdh.sample_offset_feature(jnp.asarray(feat), jnp.asarray(flow))
    got = dh.sample_offset_feature(t(feat), t(flow))
    assert_close(got, np.asarray(want), rel=1e-5)


def test_sample_own_flow_matches_the_jax_vmap():
    """The refine step: each point's 2-channel flow at its own location
    (JAX: ``border_sample`` vmapped over the point axis)."""
    rng = np.random.RandomState(10)
    field = rng.randn(B, 6, 7, 9, 2).astype(np.float32)
    xs, ys = _coords(rng, (B, 6, 7, 9), 6, 7)
    probe = rng.randn(B, 6, 7, 9, 2).astype(np.float32)

    def jf(fl, x, y):
        per_image = jax.vmap(jdh.border_sample, in_axes=(2, 2, 2),
                             out_axes=2)
        out = jax.vmap(per_image)(fl, x, y)
        return jnp.sum(out * probe), out

    (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(field), jnp.asarray(xs), jnp.asarray(ys))
    tfl, tx, ty = (t(a).requires_grad_() for a in (field, xs, ys))
    got = dh.sample_own_flow(tfl, tx, ty)
    (got * t(probe)).sum().backward()
    assert_close(got, np.asarray(want), rel=1e-5)
    for g, w_ in zip((tfl, tx, ty), jg):
        assert_close(g.grad, np.asarray(w_), rel=1e-5)


def test_sample_group_scores_reads_one_channel_as_jax_reads_all():
    rng = np.random.RandomState(11)
    G = 9
    smap = rng.randn(B, 6, 7, G).astype(np.float32)
    xs, ys = _coords(rng, (B, 6, 7, 10), 6, 7)
    pts = np.stack([xs, ys], -1)
    grp = np.asarray(jdh.grid_group_partition(jnp.asarray(pts), G))
    np.testing.assert_array_equal(
        dh.grid_group_partition(t(pts), G).numpy(), grp)
    assert len(np.unique(grp)) == G
    probe = rng.randn(B, 6, 7, 10).astype(np.float32)

    def jf(s, p):
        out = jdh.sample_group_scores(s, p, jnp.asarray(grp))
        return jnp.sum(out * probe), out

    (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(smap), jnp.asarray(pts))
    ts, tp = t(smap).requires_grad_(), t(pts).requires_grad_()
    got = dh.sample_group_scores(ts, tp, t(grp))
    (got * t(probe)).sum().backward()
    assert_close(got, np.asarray(want), rel=1e-5)
    assert_close(ts.grad, np.asarray(jg[0]), rel=1e-5)
    assert_close(tp.grad, np.asarray(jg[1]), rel=1e-5)


# ------------------------------------------------------------ heads, losses

def _feats():
    rng = np.random.RandomState(3)
    return [rng.randn(B, h, w, 32).astype(np.float32) for h, w in LEVELS]


def _batch():
    rng = np.random.RandomState(4)
    polys = _polygons(rng)
    boxes = np.concatenate([polys.min(2), polys.max(2)], -1)
    valid = np.ones((B, M), bool)
    valid[1, 3] = False
    return dict(gt_bboxes=boxes, gt_labels=rng.randint(0, C, (B, M)).astype(
        np.int32), gt_valid=valid, gt_polygons=polys.reshape(B, M, 2 * V),
        pad_shape=np.array([[H, W], [H - 8, W - 16]], np.int32))


def _random_outputs():
    rng = np.random.RandomState(5)
    P = PTS["num_points"]
    return {"cls": [(rng.randn(B, h, w, C) + 1.5).astype(np.float32)
                    for h, w in LEVELS],
            "pts_refine": [(2 * rng.randn(B, h, w, 2 * P)).astype(np.float32)
                           for h, w in LEVELS],
            "pts_score": [(2 * rng.randn(B, h, w, P) + 1).astype(np.float32)
                          for h, w in LEVELS]}


def _configs(version):
    kind = drp.DenseRepPointsV2Config if version == "v2" \
        else drp.DenseRepPointsConfig
    return kind(**CFG_KW), jdrp.DenseRepPointsConfig(**CFG_KW)


DECODE_IN = dict(shapes=np.array([[H, W], [H - 10, W - 20]], np.int32),
                 sfs=np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]],
                              np.float32))


@pytest.fixture(scope="module")
def jax_results():
    """Both heads' outputs, loss terms and parameter gradients, and the
    decode, from one compiled JAX function."""
    feats = _feats()
    jfeats = [jnp.asarray(f) for f in feats]
    variables = {v: mint_variables(jh(**HEAD_KW), [f[:1] for f in jfeats],
                                   seed=21 + i)
                 for i, (v, (jh, _)) in enumerate(HEADS.items())}
    losses = {"v1": jdrp.dense_reppoints_loss,
              "v2": jdrp.dense_reppoints_v2_loss}
    tcfg = JTestConfig(**TEST_KW)

    def run(variables, batch, rand, shapes, sfs):
        res = {}
        for v, (jh, _) in HEADS.items():
            head, jcfg = jh(**HEAD_KW), _configs(v)[1]

            def f(params):
                outs = head.apply({"params": params}, jfeats)
                total, terms = losses[v](outs, batch, jcfg)
                return total, (terms, outs)

            (total, (terms, outs)), grads = jax.value_and_grad(
                f, has_aux=True)(variables[v]["params"])
            res[v] = dict(total=total, terms=terms, outs=outs, grads=grads)
        det = jdrp.dense_reppoints_decode(rand, shapes, sfs, tcfg,
                                          _configs("v1")[1])
        res["det"] = dict(zip(("bboxes", "scores", "labels", "pts",
                               "pts_scores", "valid"), det.tree_flatten()[0]))
        return res

    res = jax.jit(run)(
        to_jax(variables), {k: jnp.asarray(a) for k, a in _batch().items()},
        jax.tree.map(jnp.asarray, _random_outputs()),
        jnp.asarray(DECODE_IN["shapes"]), jnp.asarray(DECODE_IN["sfs"]))
    return jax.tree.map(np.asarray, res), variables, feats


@pytest.fixture(scope="module")
def port_results(jax_results):
    _, variables, feats = jax_results
    res = {}
    for v, (_, th) in HEADS.items():
        head = th(**HEAD_KW)
        load_jax_variables(head, variables[v])
        outs = head([t(f).permute(0, 3, 1, 2) for f in feats])
        loss_fn = drp.dense_reppoints_v2_loss if v == "v2" \
            else drp.dense_reppoints_loss
        total, terms = loss_fn(outs, {k: t(a) for k, a in _batch().items()},
                               _configs(v)[0])
        total.backward()
        grads = to_jax_variables(head, {n: p.grad for n, p in
                                        head.named_parameters()})
        res[v] = dict(total=total, terms=terms, outs=outs, grads=grads)
    return res


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_head_outputs_match_jax(jax_results, port_results, version):
    want, got = jax_results[0][version]["outs"], port_results[version]["outs"]
    assert set(got) == set(want) == set(OUT_KEYS[version])
    for key in OUT_KEYS[version]:
        assert len(got[key]) == len(LEVELS)
        for g, w_ in zip(got[key], want[key]):
            assert tuple(g.shape) == w_.shape, key
            assert_close(g, w_, rel=1e-4)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_loss_terms_match_jax(jax_results, port_results, version):
    want, got = jax_results[0][version], port_results[version]
    assert set(got["terms"]) == set(want["terms"])
    _rel(got["total"], want["total"])
    for k, v in got["terms"].items():
        _rel(v, want["terms"][k])
        assert float(v) > 0, k


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_parameter_gradients_match_jax(jax_results, port_results, version):
    want = jax_results[0][version]["grads"]
    got = port_results[version]["grads"]["params"]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w_ in flat_w.items():
        assert_close(flat_g[path], w_, rel=1e-4)
    # the mask scores' and the refine flow's branches take gradients
    assert np.abs(want["mask_init_out"]["kernel"]).max() > 0
    assert np.abs(want["pts_refine_out"]["kernel"]).max() > 0


@pytest.fixture(scope="module")
def decoded():
    outs = {k: [t(x) for x in v] for k, v in _random_outputs().items()}
    return drp.dense_reppoints_decode(
        outs, t(DECODE_IN["shapes"]), t(DECODE_IN["sfs"]),
        TestConfig(**TEST_KW), _configs("v1")[0])


def test_decode_matches_jax(jax_results, decoded):
    want = jax_results[0]["det"]
    valid = want["valid"]
    assert valid.sum() > 20
    np.testing.assert_array_equal(decoded.valid.numpy(), valid)
    np.testing.assert_array_equal(decoded.labels.numpy(), want["labels"])
    for name in ("bboxes", "scores", "pts", "pts_scores"):
        assert_close(getattr(decoded, name), want[name], rel=1e-5)


def test_dense_points_to_masks_matches_jax(jax_results, decoded):
    want_det = jax_results[0]["det"]
    one = jdrp.DensePointDetections(*(want_det[k][0] for k in (
        "bboxes", "scores", "labels", "pts", "pts_scores", "valid")))
    want = jdrp.dense_points_to_masks(one, (H, W))
    got = drp.dense_points_to_masks(
        drp.DensePointDetections(*(x[0] for x in decoded)), (H, W))
    assert len(got) == len(want) == 50
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    assert sum(int(m.sum()) for m in got) > 0


# ------------------------------------------------------------ runner, API

RUNNER_FILES = ["dense_reppoints_r50_fpn_1x_coco.py",
                "dense_reppoints_v2_r50_fpn_1x_coco.py"]
RUN_HW = (64, 96)


def narrow_options(root):
    """Config overrides: R18, feat 32, 49 points in 7 groups, 25 score
    groups, 3 classes, the procedural set at 64x96, one epoch, an eval at
    its end."""
    ann = os.path.join(root, "ann.json")
    img = os.path.join(root, "imgs")
    return {
        "model.pretrained": None,
        "model.backbone.depth": 18, "model.backbone.frozen_stages": -1,
        "model.neck.in_channels": [64, 128, 256, 512],
        "model.neck.out_channels": 32,
        **{f"model.bbox_head.{k}": v for k, v in HEAD_KW.items()},
        "model.bbox_head.num_classes": 3,
        "data.samples_per_gpu": 2,
        "data.train.ann_file": ann, "data.train.img_prefix": img,
        "data.train.img_scale": (96, 64),
        "data.val.ann_file": ann, "data.val.img_prefix": img,
        "data.val.img_scale": (96, 64),
        "canvas_shape": RUN_HW, "log_interval": 1, "total_epochs": 1,
        "checkpoint_config": dict(interval=100), "eval_max_images": 2,
        "lr_config": dict(warmup_iters=1, step=[1]),
        "test_cfg.score_thr": 0.0}


@pytest.fixture(scope="module")
def shapes_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dense_shapes"))
    make_shapes_coco(root, 4, seed=6, hw=RUN_HW)
    return root


@pytest.mark.parametrize("name", RUNNER_FILES)
def test_runner_step_and_eval(shapes_set, tmp_path, name):
    path = os.path.join(REPO, "configs", "dense_reppoints", name)
    cfg = Config.fromfile(path)
    cfg.merge_from_dict(narrow_options(shapes_set))
    jcfg = JConfig.fromfile(path)
    jcfg.merge_from_dict(narrow_options(shapes_set))
    loss_cfg = ploop.train_loss_cfg(cfg, RUN_HW)
    want = jloop.dense_reppoints_cfg_from(jcfg, RUN_HW)
    assert type(loss_cfg) is (drp.DenseRepPointsV2Config if "v2" in name
                              else drp.DenseRepPointsConfig)
    for f in want.__dataclass_fields__:
        assert getattr(loss_cfg, f) == getattr(want, f), f
    head = jcfg.model.bbox_head
    assert ploop.head_num_vectors(cfg) == jloop._head_num_vectors(
        jcfg, head) == 36
    assert ploop.data_task(cfg, "train") == "segm"
    assert ploop.data_task(cfg, "val") == "bbox"
    work = str(tmp_path / "work")
    res = ploop.train_detector(cfg, work, max_iters_per_epoch=1,
                               device="cpu")
    assert res["step"] == 1
    (log,) = glob.glob(os.path.join(work, "*.log.json"))
    with open(log) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["mode"] == "train"]
    val = [r for r in records if r["mode"] == "val"]
    assert len(train) == 1 and len(val) == 1
    terms = {"loss_cls", "loss_bbox_init", "loss_bbox_refine",
             "loss_pts_init", "loss_pts_refine", "loss_mask_score_init"}
    if "v2" in name:
        terms |= {"loss_cont_heatmap", "loss_cont_offset", "loss_sem"}
    assert terms <= set(train[0])
    assert all(np.isfinite(train[0][k]) for k in terms | {"loss"})
    assert "bbox_mAP" in val[0]


@pytest.mark.parametrize("name", RUNNER_FILES)
def test_api_refuses_dense_reppoints(name):
    path = os.path.join(REPO, "configs", "dense_reppoints", name)
    with pytest.raises(NotImplementedError, match="lsnet_torch.tools.test"):
        apis.init_detector(path, device="cpu")
