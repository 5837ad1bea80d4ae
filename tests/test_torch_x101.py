"""The X-101 slice: ``GroupedConv``, the ResNeXt backbone with grouped DCN,
and a narrow X-101-shaped detector (ResNeXt-50 with G=8 groups of base
width 4, DCN in c3-c5, feat 32, one stacked DCN block, 4 classes) on a
64x96 batch of two, JAX vs the port on the same minted weights.

Tolerances: 1e-4 * max(1, max|ref|) for ``GroupedConv`` and the backbone
(f32 sums in another order). Head outputs: rtol=atol=1e-4, tighter than
the 1e-3 of ``tests/test_torch_e2e.py``: the differences measured here are
~3e-6, while sampling the backbone bilinear instead of nearest moves the
head outputs by ~5e-4, which 1e-3 would not catch.

The backbone's FrozenBatchNorm scales are set to 1 in the minted
variables: at 0.03 * N(0, 1) they would shrink every residual branch, the
grouped DCN included, to ~1e-5 of the shortcut, and the comparison would
not see the DCN.

The detector runs the shipped inference sampling in both packages: JAX
``with inference_sampling(): apply`` (``backbone=nearest``), the port's
``detect`` (``INFERENCE_SAMPLING``). Nearest sampling is
discontinuous in the offsets, and the two frameworks predict offsets that
differ by ~1e-6; so the backbone ``conv_offset`` kernels are zeroed in the
variables both load, which leaves every backbone sample within a bias
(0.03 * N(0, 1)) of a lattice point, far from a rounding tie. Random
weights give every score about 0.51, with ties within 1e-7 whose order
the head differences may swap, so the detections of an image are compared
as a set (sorted by label and box): the same valid detections, labels,
and boxes, scores and landmarks within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _x101_flagship_cfg
from lsnet_tpu.core.decode import TestConfig as JTestConfig
from lsnet_tpu.core.decode import lsnet_decode as j_decode
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models import layers as jl
from lsnet_tpu.models.backbones.resnet import ResNet as JResNet
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_torch.apis import detect, init_model
from lsnet_torch.configs import x101_flagship_cfg
from lsnet_torch.core.decode import TestConfig
from lsnet_torch.models import build_detector
from lsnet_torch.models import layers as tl
from lsnet_torch.models.backbones.resnet import ResNet
from lsnet_torch.ops.flat_deform import INFERENCE_SAMPLING, TRAIN_SAMPLING
from lsnet_torch.weights import load_jax_variables
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

H, W, B = 64, 96, 2
NARROW = dict(depth=50, groups=8)


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("cin,groups,stride", [
    (32, 8, 1),        # cg = 4: JAX runs it as a dense block-diagonal conv
    (64, 4, 2),        # cg = 16: JAX runs it as a grouped conv
])
def test_grouped_conv(cin, groups, stride):
    x = np.random.RandomState(0).randn(2, 9, 13, cin).astype(np.float32)
    jmod = jl.GroupedConv(cin, 3, stride=stride, groups=groups)
    v = mint_variables(jmod, jnp.asarray(x), seed=groups)
    want = jax.jit(jmod.apply)(to_jax(v), jnp.asarray(x))
    tmod = tl.GroupedConv(cin, cin, 3, stride, groups=groups)
    load_jax_variables(tmod, v)
    assert tuple(tmod.weight.shape) == (cin, cin // groups, 3, 3)
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert_close(_nhwc(got), want)


def _backbone_leaves(tree, zero_offsets):
    """Backbone variables: FrozenBatchNorm scales 1, and the conv_offset
    kernels 0 if ``zero_offsets``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if k == "conv_offset" and zero_offsets:
                v = dict(v, kernel=np.zeros_like(v["kernel"]))
            out[k] = _backbone_leaves(v, zero_offsets)
        else:
            out[k] = np.ones_like(v) if k == "scale" else v
    return out


def test_resnext_backbone_bilinear():
    x = np.random.RandomState(1).randn(1, H, W, 3).astype(np.float32)
    kw = dict(num_stages=4, out_indices=(0, 1, 2, 3), frozen_stages=1,
              stage_with_dcn=(False, True, True, True), base_width=4,
              **NARROW)
    jmod = JResNet(block_type="resnext", **kw)
    v = mint_variables(jmod, jnp.asarray(x), seed=1)
    v = dict(v, params=_backbone_leaves(v["params"], zero_offsets=False))
    want = jax.jit(jmod.apply)(to_jax(v), jnp.asarray(x))
    tmod = ResNet(block_type="resnext", **kw)
    load_jax_variables(tmod, v)
    # the grouped conv2 of c2 (OIHW), the grouped DCN of c3 (HWIO compact)
    assert tuple(tmod.layer1_0.conv2.weight.shape) == (32, 4, 3, 3)
    assert tuple(tmod.layer2_0.conv2.weight.shape) == (3, 3, 8, 64)
    with torch.no_grad():
        got = tmod.eval()(_nchw(x), TRAIN_SAMPLING)
    assert len(got) == len(want) == 4
    for g, w_ in zip(got, want):
        assert_close(_nhwc(g), w_)


def _narrow(cfg):
    cfg["backbone"].update(NARROW)
    cfg["bbox_head"]["num_classes"] = 4
    return cfg


DECODE = dict(image_shape=(H, W), num_classes=4, nms_pre=1000,
              score_thr=0.05, nms_iou=0.6, max_per_img=100)


@pytest.fixture(scope="module")
def pair():
    """JAX head outputs and detections under ``inference_sampling()``, and
    the port's model on the same variables."""
    jmodel, _ = j_build(_narrow(_x101_flagship_cfg(feat=32, stacked=1)))
    images = np.random.RandomState(2).randn(B, H, W, 3).astype(np.float32)
    v = mint_variables(jmodel, jnp.asarray(images[:1]), seed=2)
    params = dict(v["params"])
    params["backbone"] = _backbone_leaves(params["backbone"],
                                          zero_offsets=True)
    v = dict(v, params=params)
    shapes = np.array([[H, W], [H - 10, W - 20]], np.int32)
    sfs = np.array([[1, 1, 1, 1], [0.5, 0.5, 0.5, 0.5]], np.float32)

    def e2e(variables, images, shapes, sfs):
        with jfd.inference_sampling():
            outs = jmodel.apply(variables, images)
        return outs, j_decode(outs, shapes, sfs, JTestConfig(**DECODE))

    with pytest.MonkeyPatch.context() as mp:
        # pin the JAX package's process-wide policy: another test file in
        # the same worker may have armed or set it
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        mp.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        mp.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])
        jouts, jdet = jax.jit(e2e)(to_jax(v), jnp.asarray(images),
                                   jnp.asarray(shapes), jnp.asarray(sfs))
    jouts = jax.tree.map(np.asarray, jouts)
    tmodel = build_detector(_narrow(x101_flagship_cfg(feat=32, stacked=1)))
    load_jax_variables(tmodel, v)
    return jouts, jdet, tmodel.eval(), images, shapes, sfs


def test_forward_matches_jax_inference_sampling(pair):
    jouts, _, tmodel, images, _, _ = pair
    with torch.no_grad():
        touts = tmodel(t(images), INFERENCE_SAMPLING)
    assert set(touts) == set(jouts)
    for key in jouts:
        assert len(touts[key]) == len(jouts[key]) == 5
        for g, w_ in zip(touts[key], jouts[key]):
            np.testing.assert_allclose(g.numpy(), w_, rtol=1e-4, atol=1e-4)


def test_inference_detector_matches_jax(pair):
    _, jdet, tmodel, images, shapes, sfs = pair
    det = detect(tmodel, t(images), t(shapes), t(sfs),
                 TestConfig(**DECODE))
    valid = np.asarray(jdet.valid)
    assert valid.sum(axis=1).min() >= 1
    np.testing.assert_array_equal(det.valid.numpy(), valid)
    for i in range(B):
        got, want = _as_set(det, i), _as_set(jdet, i)
        np.testing.assert_array_equal(got["labels"], want["labels"])
        for name in ("bboxes", "scores", "landmarks"):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                       atol=1e-3)


def _as_set(det, i):
    """Image i's valid detections, sorted by label, then box."""
    keep = np.asarray(det.valid)[i]
    d = {n: np.asarray(getattr(det, n))[i][keep]
         for n in ("labels", "bboxes", "scores", "landmarks")}
    box = d["bboxes"]
    order = np.lexsort((box[:, 3], box[:, 2], box[:, 1], box[:, 0],
                        d["labels"]))
    return {n: x[order] for n, x in d.items()}


def test_backbone_sampling_is_live(pair):
    """The backbone sites really sample nearest under INFERENCE_SAMPLING:
    the same model under TRAIN_SAMPLING (bilinear) gives other features."""
    _, _, tmodel, images, _, _ = pair
    x = _nchw(images)
    with torch.no_grad():
        near = tmodel.backbone(x, INFERENCE_SAMPLING)
        bil = tmodel.backbone(x, TRAIN_SAMPLING)
    assert (near[0] == bil[0]).all()             # c2 has no DCN
    assert max(float((n - b).abs().max()) for n, b in zip(near, bil)) > 1e-3


def test_config_copy_matches_graft_entry():
    want = _x101_flagship_cfg()
    want["bbox_head"]["fuse_towers"] = False
    assert x101_flagship_cfg() == want


def test_init_detector_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(x101_flagship_cfg())
    model = init_model(_narrow(x101_flagship_cfg(feat=32, stacked=1)),
                       device="cpu", seed=0)
    det = detect(model, torch.randn(
        B, H, W, 3, generator=torch.Generator().manual_seed(0)),
        torch.tensor([[H, W]] * B), torch.ones(B, 4), TestConfig((H, W), 4))
    assert det.bboxes.shape == (B, 100, 4)
    assert bool(torch.isfinite(det.bboxes).all())
