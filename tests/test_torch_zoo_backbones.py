"""The rest of the zoo's backbones (HRNet, RegNet, HourglassNet,
MobileNetV2) of the port against the JAX package, on the CPU, in f32.

Each backbone is built by both packages' ``build_backbone`` from one
config dict at narrow width: HRNet at the stage widths of
``tests/test_backbones_necks.py`` (16 / 8-64), RegNet at ``arch=dict(w0=24,
wa=24.48, wm=2.54, depth=8, group_w=8)`` with a 16-wide stem, the
hourglass at ``downsample_times`` 2 (stages 16, 16, 32, one block each),
MobileNetV2 at ``widen_factor`` 0.5; the inputs are odd-sized, so the
integer-index upsamples and the padded stride-2 convs meet uneven maps.
The JAX variables are minted with numpy from ``eval_shape``'s shapes
(``mint_variables``) and carried to the port by
``weights.from_jax_variables``; ONE jitted JAX function a module gives
the outputs and the VJP of seeded cotangents with respect to the
parameters and the input (``jax_vjp_fn``), held against the port's
(``port_vjp``). ``frozen_stages`` (HRNet at 2, RegNet at 1, the RegNet
composition's) stops the gradient on the activations in JAX: the
parameters before the stop have an all-zero gradient there and are
frozen in the port. ``regnet_widths`` for four RegNetX archs, each
weight round trip and the training init are checked without JAX's
compiler. The slice as a whole: the first train step of a narrow RegNet
RetinaNet (``configs.retinanet_regnetx_3_2gf`` with a 16-wide stem and
16-wide FPN and head) on a seeded batch, its loss, terms and every
gradient against the JAX loss's from the same variables.

Tolerances: f32, every output, input gradient and parameter gradient
within 1e-4 of max(1, max|ref|) (``assert_close``); the losses 1e-4
relative; the widths exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.core import anchors as janchors
from lsnet_tpu.core import dense_loss as jdl
from lsnet_tpu.models import build_backbone as j_build_backbone
from lsnet_tpu.models import build_detector as j_build_detector
from lsnet_tpu.models.backbones import extra as jextra
from lsnet_torch import configs
from lsnet_torch.core import dense_loss as pdl
from lsnet_torch.models import build_backbone, build_detector
from lsnet_torch.models.backbones import extra as pextra
from lsnet_torch.models.init import init_weights_
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING
from lsnet_torch.train import loop as ploop
from lsnet_torch.weights import from_jax_variables, to_jax_variables
from torch_port_util import (HRNET_EXTRA, assert_close, assert_round_trip,
                             assert_vjp_close, gt_batch, jax_vjp_fn,
                             mint_variables, port_vjp, t)

torch.set_num_threads(1)

REGNET_ARCH = dict(w0=24, wa=24.48, wm=2.54, depth=8, group_w=8)
# name -> (config, NHWC input shape)
CASES = {
    "hrnet": (dict(type="HRNet", extra=HRNET_EXTRA), (2, 68, 92, 3)),
    "hrnet_frozen2": (dict(type="HRNet", extra=HRNET_EXTRA,
                           frozen_stages=2), (1, 68, 92, 3)),
    "regnet_frozen1": (dict(type="RegNet", arch=REGNET_ARCH,
                            stem_channels=16, frozen_stages=1,
                            with_cp=True), (2, 66, 90, 3)),
    "hourglass": (dict(type="HourglassNet", num_stacks=2,
                       downsample_times=2, stage_channels=(16, 16, 32),
                       stage_blocks=(1, 1, 1), feat_channel=16),
                  (2, 60, 76, 3)),
    "mobilenet": (dict(type="MobileNetV2", widen_factor=0.5,
                       out_indices=(1, 2, 4, 6)), (2, 70, 94, 3)),
}
# mmdet's RegNetX archs (``RegNet.arch_settings``)
REGNETX = {"regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16,
                                 depth=22),
           "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24,
                                 depth=18),
           "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48,
                                 depth=25),
           "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112,
                                depth=19)}


def _case(name, seed=0):
    """(flax module, minted variables, port module with them, input) of
    one case."""
    cfg, shape = CASES[name]
    jmod = j_build_backbone(dict(cfg))
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    v = mint_variables(jmod, jnp.zeros((1, *shape[1:])), seed=seed + 1)
    model = build_backbone(dict(cfg))
    model.load_state_dict(from_jax_variables(v), strict=True)
    return jmod, v, model, x


@pytest.mark.parametrize("name", sorted(CASES))
def test_backbone_forward_and_vjp_match_jax(name):
    """Outputs, the input's and every parameter's VJP; a frozen case's
    frozen parameters have an all-zero JAX gradient, and with HRNet at
    ``frozen_stages=2`` exactly the stem, stage 1 and stage 2 are
    frozen."""
    jmod, v, model, x = _case(name)
    shapes = jax.eval_shape(lambda: jmod.apply(v, jnp.asarray(x)))
    rng = np.random.RandomState(7)
    cots = [rng.randn(*s.shape).astype(np.float32) for s in shapes]
    want = jax.tree.map(np.asarray, jax_vjp_fn(jmod)(
        v, jnp.asarray(x), [jnp.asarray(c) for c in cots]))
    got = port_vjp(model, x, cots)
    assert_vjp_close(model, got, want)
    assert [o.shape[-1] for o in got[0]] == list(model.out_channels)
    frozen = {n.split(".")[0] for n, p in model.named_parameters()
              if not p.requires_grad}
    if name == "hrnet_frozen2":
        assert frozen == {"conv1", "bn1", "conv2", "bn2", "layer1_0",
                          "layer1_1", "stage2_module0"} | {
            f"transition2_{b}_{m}" for b in (0, 1) for m in ("conv", "bn")}
    elif name == "regnet_frozen1":
        assert frozen == {"conv1", "bn1"} | {
            n for n in dict(model.named_children()) if
            n.startswith("layer1_")}
    else:
        assert not frozen


@pytest.mark.parametrize("arch", sorted(REGNETX))
def test_regnet_widths_match_jax(arch):
    a = REGNETX[arch]
    args = (a["w0"], a["wa"], a["wm"], a["depth"], a["group_w"])
    assert pextra.regnet_widths(*args) == jextra.regnet_widths(*args)
    if arch == "regnetx_3.2gf":
        assert pextra.regnet_widths(*args) == ([96, 192, 432, 1008],
                                               [2, 6, 15, 2])
        model = build_backbone(dict(type="RegNet",
                                    arch=configs.REGNETX_3_2GF))
        assert [getattr(model, f"layer{s}_0").conv2.groups
                for s in (1, 2, 3, 4)] == [2, 4, 9, 21]


@pytest.mark.parametrize("name", sorted(CASES))
def test_backbone_weights_round_trip_and_init(name):
    """``from_jax_variables`` -> ``to_jax_variables`` gives the minted
    variables back exactly, and the training init covers every
    parameter (``init_weights_`` raises on one it has no rule for)."""
    _, v, model, _ = _case(name)
    assert_round_trip(model, v)
    init_weights_(model, torch.Generator().manual_seed(0))


def _regnet_retina_cfg():
    """The RegNet composition at narrow width: a 16-wide stem, an FPN and
    a two-conv RetinaNet head of 16, 3 classes; (config, model dict)."""
    cfg = configs.retinanet_regnetx_3_2gf()
    model = cfg.model.to_dict()
    model["backbone"].update(arch=REGNET_ARCH, stem_channels=16)
    model["neck"].update(out_channels=16)
    model["bbox_head"].update(in_channels=16, feat_channels=16,
                              stacked_convs=2, num_classes=3)
    return cfg, model


def test_regnet_retinanet_first_step_matches_jax():
    """The narrow RegNet RetinaNet's loss, terms and every gradient on a
    seeded 64x96 batch of 2 (5 GT slots an image), from the same minted
    variables; the parameters of the frozen stem and stage 1 have an
    all-zero JAX gradient."""
    cfg, model_cfg = _regnet_retina_cfg()
    hw = (64, 96)
    jmodel, _ = j_build_detector(dict(model_cfg))
    v = mint_variables(jmodel, jnp.zeros((1, *hw, 3)), seed=3)
    pcfg = dataclasses.replace(ploop.dense_cfg_from(cfg, hw), num_classes=3)
    fields = {f.name: getattr(pcfg, f.name)
              for f in dataclasses.fields(pcfg)}
    fields["anchor"] = janchors.AnchorConfig(
        **dataclasses.asdict(pcfg.anchor))
    jcfg = jdl.DenseLossConfig(**fields)
    batch = gt_batch(hw, 3, seed=5)
    image = np.random.RandomState(6).randn(2, *hw, 3).astype(np.float32)

    def jfn(params, image, batch):
        def f(p):
            outs = jmodel.apply({"params": p,
                                 "batch_stats": v["batch_stats"]}, image)
            return jdl.dense_loss(outs, batch, jcfg)
        (total, terms), grads = jax.value_and_grad(f, has_aux=True)(params)
        return total, terms, grads

    jtotal, jterms, jgrads = jax.tree.map(np.asarray, jax.jit(jfn)(
        v["params"], jnp.asarray(image),
        {k: jnp.asarray(a) for k, a in batch.items()}))
    model = build_detector(model_cfg)
    model.load_state_dict(from_jax_variables(v), strict=True)
    outs = model(t(image), TRAIN_SAMPLING)
    total, terms = pdl.dense_loss(outs, {k: t(a) for k, a in batch.items()},
                                  pcfg)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, [p for _, p in named])
    assert abs(total.item() - float(jtotal)) <= 1e-4 * abs(float(jtotal))
    assert terms.keys() == jterms.keys()
    for k, w in jterms.items():
        assert abs(terms[k].item() - float(w)) <= 1e-4 * max(
            abs(float(w)), 1e-3)
    got = to_jax_variables(model, {n: g for (n, _), g in zip(named, grads)})
    flat_g = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_flatten_with_path(got["params"])[0]}
    frozen = 0
    for p, w in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        name = jax.tree_util.keystr(p)
        if name in flat_g:
            assert_close(flat_g[name], w)
        else:
            assert not np.any(w), name
            frozen += 1
    assert frozen == sum(not p.requires_grad
                         for p in model.parameters()) > 0
