"""The rest of the zoo's necks (PAFPN, BFP, NAS-FPN, HRFPN, FPN_CARAFE)
and the ops they use (``carafe``; ``masked_conv2d`` and ``nms_match``
beside them in ``ops.misc``) of the port against the JAX package, on the
CPU, in f32.

Each neck is built by both packages' ``build_neck`` from one config dict
at 16 channels (the compositions' settings, narrowed: NAS-FPN at
``stack_times`` 2 with BN from level 1, FPN_CARAFE with its
``upsample_cfg`` and ``order`` dropped by both builders, BFP at
``refine_level`` 2 with its refine conv) on seeded NHWC levels of uneven
sizes: HRNet's strides of a 68x92 image (17x23 to 3x3) for HRFPN, PAFPN,
BFP (five levels, from 33x41) and FPN_CARAFE, and R-50's strides 8 to 32
of a 160x224 canvas for NAS-FPN, whose extra levels are 2x3 and 1x1
there, so ``_resize_to``'s max pool takes its ratio from the height
alone (5x7 -> 2x3 by 2). The JAX variables are minted with numpy from
``eval_shape``'s shapes and carried to the port by
``weights.from_jax_variables``; ONE jitted JAX function a module gives
the outputs and the VJP of seeded cotangents with respect to the
parameters and every input level (``jax_vjp_fn``), held against the
port's (``port_vjp``); each weight round trip is exact and the training
init covers every parameter. FPN_CARAFE's encoder channels are read in
JAX's order, (2 dy + dx) G k^2 + j, which ``F.pixel_shuffle``'s order
(4 j + 2 dy + dx) would break: a test swaps the two and sees the outputs
differ. ``carafe`` at odd sizes with G = 2: forward and the VJP of the
features and the masks; ``masked_conv2d``: forward; ``nms_match``:
exactly, ties and padding included. The slice as a whole: the first
train step of a narrow HRNet + HRFPN Faster R-CNN
(``configs.faster_rcnn_hrnetv2p_w32`` at the HRNet test widths, HRFPN
and RPN 16 wide, 32-wide RoI FCs, 3 classes; 64 RPN samples, 32
proposals, 16 RoIs an image) on a seeded batch, its loss, terms and
every gradient against the JAX loss's from the same variables.

Tolerances: f32, every output, input gradient and parameter gradient
within 1e-4 of max(1, max|ref|) (``assert_close``); the losses 1e-4
relative; ``nms_match`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core import two_stage as jts
from lsnet_tpu.models import build_detector as j_build_detector
from lsnet_tpu.models import build_neck as j_build_neck
from lsnet_tpu.ops import misc as jmisc
from lsnet_torch import configs
from lsnet_torch.core import two_stage as pts
from lsnet_torch.models import build_backbone, build_detector, build_neck
from lsnet_torch.models.init import init_weights_
from lsnet_torch.ops import misc as pmisc
from lsnet_torch.train import loop as ploop
from lsnet_torch.weights import from_jax_variables, to_jax_variables
from torch_port_util import (HRNET_EXTRA, assert_close, assert_round_trip,
                             assert_vjp_close, gt_batch, jax_vjp_fn,
                             mint_variables, port_vjp, t)

torch.set_num_threads(1)

HR_LEVELS = ((17, 23), (9, 12), (5, 6), (3, 3))
BFP_LEVELS = ((33, 41), (17, 21), (9, 11), (5, 6), (3, 3))
NAS_LEVELS = ((40, 56), (20, 28), (10, 14), (5, 7))
BN = dict(type="BN")
# name -> (neck config, (h, w, channels) of each input level)
CASES = {
    "pafpn": (dict(type="PAFPN", in_channels=[8, 16, 24, 32],
                   out_channels=16, num_outs=5),
              [(h, w, c) for (h, w), c in zip(HR_LEVELS, (8, 16, 24, 32))]),
    "bfp": (dict(type="BFP", in_channels=[16] * 5, out_channels=16,
                 refine_level=2, refine_type="conv"),
            [(h, w, 16) for h, w in BFP_LEVELS]),
    "nasfpn": (dict(type="NASFPN", in_channels=[8, 16, 24, 32],
                    out_channels=16, start_level=1, add_extra_convs="on_input",
                    num_outs=5, stack_times=2, norm_cfg=BN),
               [(h, w, c) for (h, w), c in zip(NAS_LEVELS, (8, 16, 24, 32))]),
    "hrfpn": (dict(type="HRFPN", in_channels=[8, 16, 32, 64],
                   out_channels=16),
              [(h, w, c) for (h, w), c in zip(HR_LEVELS, (8, 16, 32, 64))]),
    "fpn_carafe": (dict(type="FPN_CARAFE", in_channels=[8, 16, 24, 32],
                        out_channels=16, num_outs=5, start_level=0,
                        norm_cfg=None, order=("conv", "norm", "act"),
                        compressed_channels=8,
                        upsample_cfg=dict(type="carafe", up_kernel=5)),
                   [(h, w, c) for (h, w), c in zip(HR_LEVELS,
                                                   (8, 16, 24, 32))]),
}


def _case(name, seed=0):
    """(flax module, minted variables, port module with them, inputs)."""
    cfg, levels = CASES[name]
    jmod = j_build_neck(dict(cfg))
    rng = np.random.RandomState(seed)
    xs = [rng.randn(2, h, w, c).astype(np.float32) for h, w, c in levels]
    v = mint_variables(jmod, [jnp.asarray(x[:1]) for x in xs],
                       seed=seed + 1)
    model = build_neck(dict(cfg), [c for _, _, c in levels])
    model.load_state_dict(from_jax_variables(v), strict=True)
    return jmod, v, model, xs


def _jax_vjp(jmod, v, xs, seed=7):
    shapes = jax.eval_shape(lambda: jmod.apply(v, [jnp.asarray(x)
                                                   for x in xs]))
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*s.shape).astype(np.float32) for s in shapes]
    return cots, jax.tree.map(np.asarray, jax_vjp_fn(jmod)(
        v, [jnp.asarray(x) for x in xs], [jnp.asarray(c) for c in cots]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_neck_forward_and_vjp_match_jax(name):
    """Outputs, every input level's and every parameter's VJP."""
    jmod, v, model, xs = _case(name)
    cots, want = _jax_vjp(jmod, v, xs)
    got = port_vjp(model, xs, cots)
    assert_vjp_close(model, got, want)
    assert [tuple(o.shape) for o in got[0]] == [c.shape for c in cots]


@pytest.mark.parametrize("name", sorted(CASES))
def test_neck_weights_round_trip_and_init(name):
    """``from_jax_variables`` -> ``to_jax_variables`` gives the minted
    variables back exactly; ``init_weights_`` covers every parameter."""
    _, v, model, _ = _case(name)
    assert_round_trip(model, v)
    init_weights_(model, torch.Generator().manual_seed(0))


def test_fpn_carafe_reads_the_encoder_in_jax_order():
    """The encoder's channels read in ``F.pixel_shuffle``'s order (4 j + 2
    dy + dx) instead of JAX's ((2 dy + dx) G k^2 + j) give other
    outputs: the order is pinned by the JAX parity above."""
    _, _, model, xs = _case("fpn_carafe")
    with torch.no_grad():
        want = model([t(x).permute(0, 3, 1, 2) for x in xs])
        for i in range(1, 4):
            conv = getattr(model, f"up_enc_{i}").conv
            k = conv.weight.shape[0] // 4
            perm = torch.arange(4 * k).view(4, k).t().reshape(-1)
            conv.weight.copy_(conv.weight[perm])
            conv.bias.copy_(conv.bias[perm])
        got = model([t(x).permute(0, 3, 1, 2) for x in xs])
    assert max((g - w).abs().max().item() for g, w in zip(got, want)) > 1e-3


def test_carafe_matches_jax_at_odd_sizes_and_two_groups():
    """``carafe`` (k 5, G 2, scale 2) on a 7x5 map of 6 channels against
    JAX's, forward and the VJP of the features and the softmaxed
    masks."""
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 7, 5, 6).astype(np.float32)
    masks = rng.rand(2, 14, 10, 50).astype(np.float32)
    cot = rng.randn(2, 14, 10, 6).astype(np.float32)
    out, vjp = jax.vjp(lambda f, m: jmisc.carafe(f, m, 5, 2, 2),
                       jnp.asarray(feats), jnp.asarray(masks))
    dfeats, dmasks = vjp(jnp.asarray(cot))
    f, m = t(feats).requires_grad_(True), t(masks).requires_grad_(True)
    got = pmisc.carafe(f, m, 5, 2, 2)
    gf, gm = torch.autograd.grad(got, [f, m], t(cot))
    assert_close(got, out)
    assert_close(gf, dfeats)
    assert_close(gm, dmasks)


def test_masked_conv2d_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 7, 5).astype(np.float32)
    mask = (rng.rand(2, 9, 7) > 0.5).astype(np.float32)
    w = rng.randn(3, 3, 5, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want = jmisc.masked_conv2d(jnp.asarray(x), jnp.asarray(mask),
                               jnp.asarray(w), jnp.asarray(b))
    assert_close(pmisc.masked_conv2d(t(x), t(mask), t(w), t(b)), want)


@pytest.mark.parametrize("thr", [0.3, 0.6])
def test_nms_match_matches_jax_exactly(thr):
    """Groups of 40 boxes in clusters, with equal scores and padding."""
    rng = np.random.RandomState(5)
    centres = rng.uniform(20, 80, (6, 2))[rng.randint(0, 6, 40)]
    wh = rng.uniform(10, 30, (40, 2))
    xy = centres + rng.uniform(-6, 6, (40, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    scores = rng.rand(40).astype(np.float32)
    scores[[3, 11, 17]] = scores[5]
    scores[[7, 30]] = -1e10
    want = np.asarray(jmisc.nms_match(jnp.asarray(boxes),
                                      jnp.asarray(scores), thr))
    got = pmisc.nms_match(t(boxes), t(scores), thr).numpy()
    assert np.array_equal(got, want)
    assert got[7] == got[30] == -1 and len(set(got.tolist())) > 2


def _hrnet_faster_cfg():
    """The HRNet composition at narrow width."""
    cfg = configs.faster_rcnn_hrnetv2p_w32()
    cfg.merge_from_dict({
        "model.backbone.extra": HRNET_EXTRA,
        "model.neck.in_channels": [8, 16, 32, 64],
        "model.neck.out_channels": 16,
        "model.rpn_head.in_channels": 16,
        "model.rpn_head.feat_channels": 16,
        "model.roi_head.bbox_head.in_channels": 16,
        "model.roi_head.bbox_head.fc_out_channels": 32,
        "model.roi_head.bbox_head.num_classes": 3,
        "train_cfg.rpn.sampler.num": 64,
        "train_cfg.rpn_proposal.nms_pre": 200,
        "train_cfg.rpn_proposal.max_per_img": 32,
        "train_cfg.rcnn.sampler.num": 16})
    return cfg


def test_hrnet_faster_rcnn_first_step_matches_jax():
    """The narrow HRNet + HRFPN Faster R-CNN's loss, its four terms and
    every gradient on a seeded batch of 2 (5 GT slots an image),
    from the same minted variables; 64x128, a canvas of whole stride-64
    cells (``configs``: HRFPN's pools give floor sizes, the anchors'
    grids ceil sizes)."""
    from lsnet_tpu.train import loop as jloop
    from lsnet_tpu.utils.config import Config as JConfig
    cfg = _hrnet_faster_cfg()
    hw = (64, 128)
    jmodel, _ = j_build_detector(cfg.model.to_dict())
    v = mint_variables(jmodel, jnp.zeros((1, *hw, 3)), seed=2)
    jcfg = jloop.two_stage_cfg_from(JConfig(cfg.to_dict()), hw)
    pcfg = ploop.two_stage_cfg_from(cfg, hw)
    batch = dict(gt_batch(hw, 3, seed=5),
                 image=np.random.RandomState(6).randn(2, *hw, 3).astype(
                     np.float32))

    def jfn(variables, batch):
        def f(params):
            return jts.two_stage_loss(
                jmodel, {"params": params,
                         "batch_stats": variables["batch_stats"]},
                batch, jcfg)
        (total, terms), grads = jax.value_and_grad(f, has_aux=True)(
            variables["params"])
        return total, terms, grads

    jtotal, jterms, jgrads = jax.tree.map(np.asarray, jax.jit(jfn)(
        v, {k: jnp.asarray(a) for k, a in batch.items()}))
    model = build_detector(cfg.model.to_dict())
    model.load_state_dict(from_jax_variables(v), strict=True)
    total, terms = pts.two_stage_loss(
        model, {k: t(a) for k, a in batch.items()}, pcfg)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(total, [p for _, p in named])
    assert abs(total.item() - float(jtotal)) <= 1e-4 * abs(float(jtotal))
    assert terms.keys() == jterms.keys()
    for k, w in jterms.items():
        assert abs(terms[k].item() - float(w)) <= 1e-4 * max(
            abs(float(w)), 1e-3)
    got = to_jax_variables(model, {n: g for (n, _), g in zip(named, grads)})
    flat_w = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got["params"])[0])
    assert len(flat_w) == len(flat_g)
    for p, w in flat_w:
        assert_close(flat_g[p], w)


def _narrow_composition(name):
    """A composition of ``lsnet_torch.configs`` at narrow width (HRNet at
    the test widths, RegNet at w0 24, R18 elsewhere; the neck, RPN and
    dense head 16 wide, NAS-FPN 2 stages, 3 classes) that tests at 128 x
    256 (NAS-FPN at 128 x 128), whole stride-128 cells."""
    cfg = configs.COMPOSITIONS[name]()
    model = cfg.model.to_dict()
    bb = model["backbone"]
    if bb["type"] == "HRNet":
        bb["extra"] = HRNET_EXTRA
    elif bb["type"] == "RegNet":
        bb.update(arch=dict(w0=24, wa=24.48, wm=2.54, depth=8, group_w=8),
                  stem_channels=16)
    else:
        bb["depth"] = 18
    with torch.device("meta"):
        widths = build_backbone(dict(bb)).out_channels
    model["neck"].update(in_channels=widths, out_channels=16)
    if model["neck"]["type"] == "NASFPN":
        model["neck"]["stack_times"] = 2
    if "rpn_head" in model:
        model["rpn_head"].update(in_channels=16, feat_channels=16)
        model["roi_head"]["bbox_head"].update(
            in_channels=16, fc_out_channels=32, num_classes=3)
    else:
        model["bbox_head"].update(in_channels=16, feat_channels=16,
                                  stacked_convs=2, num_classes=3)
    scale = (128, 128) if name == "retinanet_r50_nasfpn" else (256, 128)
    cfg.merge_from_dict({"model": dict(model, _delete_=True),
                         "data.test.img_scale": scale})
    return cfg


@pytest.mark.parametrize("name", sorted(configs.COMPOSITIONS))
def test_compositions_serve_through_the_api(name):
    """Each composition, narrowed, passes ``check_runnable`` and serves
    through ``apis.init_detector(Config, device="cpu")`` and
    ``inference_detector`` on a 90x150 image: seeded weights give
    detections, finite, inside the image, the same on a second call."""
    from lsnet_torch import apis
    cfg = _narrow_composition(name)
    ploop.check_runnable(cfg)
    bundle = apis.init_detector(cfg, device="cpu")
    apis.random_weights_(bundle.model, 0)
    img = np.random.RandomState(8).randint(0, 255, (90, 150, 3), np.uint8)
    first = apis.inference_detector(bundle, img)
    again = apis.inference_detector(bundle, img)
    assert len(first["scores"]) > 0
    assert np.isfinite(first["bboxes"]).all()
    assert (first["bboxes"] >= -1e-3).all()
    assert (first["bboxes"][:, [0, 2]] <= 150 + 1e-3).all()
    assert (first["bboxes"][:, [1, 3]] <= 90 + 1e-3).all()
    for k in first:
        assert np.array_equal(first[k], again[k]), k
