"""The port's Res2Net backbone and the ResNet options against the JAX
package, on the CPU.

* A narrow Res2Net-50-v1d with DCNv2 in c3-c5 (``base_channels=16,
  base_width=8``: 3x3 widths 8 / 16 / 32 / 64; deep stem; the hierarchical
  ``conv2_i``, the 'stage' blocks' average pool, the avg-down shortcut),
  numpy-minted variables through ``weights.load_jax_variables``, bilinear
  sampling: the four outputs within 1e-4 of max|ref| of JAX
  ``ResNet(block_type="res2net")``. FrozenBatchNorm scales are 1, so no
  residual branch is too small to see.
* ``frozen_stages=1`` with the deep stem freezes what JAX
  ``frozen_param_paths`` names; ``with_cp`` gives the same output and
  gradients (1e-6 of max(1, max|ref|)).
* ``convert_torch_backbone`` on a minted Res2Net v1d ``state_dict`` in
  mmdet's names equals the JAX converter's result, bit for bit.
* ``train.fuse.fuse_conv_bn``: the fused names equal JAX's
  ``lsnet_tpu/train/fuse.py`` list, the fused weights JAX's fused
  variables (1e-6 of max(1, max|ref|)), and the fused outputs the unfused
  ones (1e-4 of max|ref|).
* ``strides``, ``dilations`` and ``base_channels``: one narrow ResNet
  against JAX each, 1e-4 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.models.backbones.resnet import ResNet as JResNet
from lsnet_tpu.models.backbones.resnet import frozen_param_paths
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import checkpoint as jckpt
from lsnet_tpu.train import fuse as jfuse
from lsnet_torch.models.backbones.resnet import ResNet
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING
from lsnet_torch.train import checkpoint as pckpt
from lsnet_torch.train.fuse import fuse_conv_bn
from lsnet_torch.weights import from_jax_variables, load_jax_variables
from torch_port_util import (mint_module_, mint_variables,
                             reference_state_dict, t, to_jax)

torch.set_num_threads(1)

H, W = 64, 96
RES2 = dict(depth=50, block_type="res2net", base_channels=16, base_width=8,
            deep_stem=True, stage_with_dcn=(False, True, True, True))


def _unit_scales(tree):
    return {k: (_unit_scales(v) if isinstance(v, dict)
                else np.ones_like(v) if k == "scale" else v)
            for k, v in tree.items()}


def _close(got, want, rel):
    """max |got - want| <= rel * max|want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    lim = rel * float(np.max(np.abs(want)))
    assert err <= lim, f"max|diff| {err:.3g} > {lim:.3g}"


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _jax_apply(jmod, v, x):
    with pytest.MonkeyPatch.context() as mp:
        # pin the JAX package's process-wide sampling: another test file
        # in the same worker may have set it
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        mp.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        return [np.asarray(o) for o in
                jax.jit(jmod.apply)(to_jax(v), jnp.asarray(x))]


@pytest.fixture(scope="module")
def res2():
    """(JAX outputs, minted variables, input) of the narrow Res2Net."""
    x = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32)
    jmod = JResNet(**RES2)
    v = mint_variables(jmod, jnp.asarray(x), seed=3)
    v = dict(v, params=_unit_scales(v["params"]))
    return _jax_apply(jmod, v, x), v, x


def _port(v, **kw):
    model = ResNet(**{**RES2, **kw})
    load_jax_variables(model, v)
    return model.eval()


def test_res2net_backbone_matches_jax(res2):
    want, v, x = res2
    model = _port(v)
    # 3x3 widths floor(planes * 8 / 16): 8, 16, 32, 64 at c2-c5
    assert [model.layer1_0.width, model.layer4_2.width] == [8, 64]
    assert tuple(model.layer2_0.conv2_2.weight.shape) == (3, 3, 16, 16)
    assert tuple(model.stem_conv1.weight.shape) == (8, 3, 3, 3)
    with torch.no_grad():
        got = model(_nchw(x), TRAIN_SAMPLING)
    assert len(got) == len(want) == 4
    for g, w_ in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w_, 1e-4)


def test_frozen_stages_with_deep_stem(res2):
    model = _port(res2[1], frozen_stages=1)
    prefixes = frozen_param_paths(50, 1, deep_stem=True)
    assert prefixes == ("stem_", "layer1_")
    for name, p in model.named_parameters():
        assert p.requires_grad != name.startswith(prefixes), name
    assert sum(not p.requires_grad for p in model.parameters()) > 6


def test_with_cp_gives_the_same_output_and_gradients(res2):
    _, v, x = res2
    results = []
    for with_cp in (False, True):
        model = _port(v, with_cp=with_cp).train()
        out = model(_nchw(x), TRAIN_SAMPLING)
        loss = sum((o.float() ** 2).mean() for o in out)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append(([o.detach() for o in out], grads))
    (o0, g0), (o1, g1) = results
    for a, b in zip(o0 + list(g0), o1 + list(g1)):
        lim = 1e-6 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= lim


def test_convert_torch_backbone_matches_jax():
    """A minted Res2Net-50-v1d-DCN in mmdet's key names (a full-detector
    dict: ``backbone.`` prefix, a neck key, ``num_batches_tracked``)."""
    model = mint_module_(ResNet(**RES2), seed=5)
    ref = reference_state_dict(model, "backbone.")
    assert {"backbone.stem.6.weight", "backbone.layer1.0.convs.2.weight",
            "backbone.layer2.0.convs.0.conv_offset.weight",
            "backbone.layer3.0.downsample.1.weight",
            "backbone.layer3.0.downsample.2.running_var"} <= set(ref)
    ref["backbone.layer1.0.bns.0.num_batches_tracked"] = torch.tensor(3)
    ref["neck.lateral_convs.0.conv.weight"] = torch.zeros(4, 4, 1, 1)
    params, stats = jckpt.convert_torch_backbone(ref)
    want = from_jax_variables({"params": params, "batch_stats": stats})
    got = pckpt.convert_torch_backbone(ref)
    assert set(got) == set(want)
    for k, w_ in want.items():
        assert torch.equal(got[k], w_), k
    model.load_state_dict(got, strict=True)


def test_fuse_conv_bn_matches_jax(res2):
    want_unfused, v, x = res2
    jfused, jnames = jfuse.fuse_conv_bn(jax.tree.map(np.asarray, v))
    model = _port(v)
    names = fuse_conv_bn(model)
    assert names == jnames
    assert "/layer1_0/downsample_bn" in names and "/layer2_0/bn3" in names
    # JAX's pairing rule knows neither ``stem_bnN`` nor ``bn2_i``: the deep
    # stem and the scale branches stay unfused in both packages
    assert "/stem_bn1" not in names and "/layer1_0/bn2_2" not in names
    want = from_jax_variables(jax.tree.map(np.asarray, jfused))
    got = model.state_dict()
    for k, w_ in want.items():
        lim = 1e-6 * max(1.0, w_.abs().max().item())
        assert (got[k] - w_).abs().max().item() <= lim, k
    with torch.no_grad():
        fused_out = model(_nchw(x), TRAIN_SAMPLING)
    for g, w_ in zip(fused_out, want_unfused):
        _close(g.permute(0, 2, 3, 1), w_, 1e-4)


@pytest.mark.parametrize("option", ["strides", "dilations", "base_channels"])
def test_resnet_option_matches_jax(option):
    kw = {"strides": dict(depth=18, strides=(1, 2, 1, 2)),
          "dilations": dict(depth=50, dilations=(1, 1, 2, 2),
                            strides=(1, 2, 1, 1), base_channels=16,
                            stage_with_dcn=(False, False, True, True)),
          "base_channels": dict(depth=50, block_type="resnext", groups=4,
                                base_width=8, base_channels=32,
                                stage_with_dcn=(False, True, False, True))
          }[option]
    x = np.random.RandomState(1).randn(1, H, W, 3).astype(np.float32)
    jmod = JResNet(**kw)
    v = mint_variables(jmod, jnp.asarray(x), seed=7)
    v = dict(v, params=_unit_scales(v["params"]))
    want = _jax_apply(jmod, v, x)
    model = ResNet(**kw)
    load_jax_variables(model, v)
    with torch.no_grad():
        got = model.eval()(_nchw(x), TRAIN_SAMPLING)
    assert [tuple(g.shape[2:]) for g in got] == [w_.shape[1:3]
                                                 for w_ in want]
    for g, w_ in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w_, 1e-4)
