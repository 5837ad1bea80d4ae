"""The port's layers, ResNet, FPN and LSHead against the flax modules of
the JAX package, on the same minted weights (``from_jax_variables``).

Tolerance: max|diff| <= 1e-4 * max(1, max|ref|) per output in f32; the
deeper stacks (ResNet, LSHead) use 1e-3, since summation-order differences
pass through several convs and GroupNorms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.models import layers as jl
from lsnet_tpu.models.backbones.resnet import ResNet as JResNet
from lsnet_tpu.models.heads.ls_head import LSHead as JLSHead
from lsnet_tpu.models.necks.fpn import FPN as JFPN
from lsnet_torch.models import layers as tl
from lsnet_torch.models.backbones.resnet import ResNet
from lsnet_torch.models.heads.ls_head import LSHead
from lsnet_torch.models.necks.fpn import FPN
from lsnet_torch.weights import load_jax_variables
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

GN = dict(type="GN", num_groups=8)


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _run_pair(jmod, tmod, x, seed=0, rel=1e-4):
    v = mint_variables(jmod, jnp.asarray(x), seed=seed)
    want = jax.jit(jmod.apply)(to_jax(v), jnp.asarray(x))
    load_jax_variables(tmod, v)
    with torch.no_grad():
        got = tmod.eval()(_nchw(x))
    assert_close(_nhwc(got), want, rel)


@pytest.mark.parametrize("norm", [GN, dict(type="BN"), None])
def test_conv_module(norm):
    x = np.random.RandomState(0).randn(2, 9, 13, 16).astype(np.float32)
    _run_pair(jl.ConvModule(32, 3, stride=2, norm_cfg=norm),
              tl.ConvModule(16, 32, 3, stride=2, norm_cfg=norm), x)


def test_modulated_deform_conv_pack_levels():
    rng = np.random.RandomState(1)
    xs = [rng.randn(2, h, w, 32).astype(np.float32)
          for h, w in [(10, 14), (5, 7)]]
    jmod = jl.ModulatedDeformConvPack(24, 3, padding=1)
    tmod = tl.ModulatedDeformConvPack(32, 24, 3, padding=1)
    v = mint_variables(jmod, [jnp.asarray(x) for x in xs], seed=1)
    want = jax.jit(jmod.apply)(to_jax(v), [jnp.asarray(x) for x in xs])
    load_jax_variables(tmod, v)
    with torch.no_grad():
        got = tmod([_nchw(x) for x in xs])
    for g, w_ in zip(got, want):
        assert_close(_nhwc(g), w_)


def test_pyramid_deform_conv_jobs():
    from lsnet_tpu.ops.flat_deform import SampleJob as JJob
    from lsnet_torch.ops.flat_deform import SampleJob as TJob
    rng = np.random.RandomState(2)
    shapes = [(10, 14), (5, 7)]
    xs = [rng.randn(2, h, w, 16).astype(np.float32) for h, w in shapes]
    off = (1.5 * rng.randn(2, 10, 14, 18)).astype(np.float32)
    spec = [(src, (shapes[src][0] / 10, shapes[src][1] / 14))
            for src in range(2)]
    jjobs = [JJob(s, jnp.asarray(off), None, sc, (1, 1), (1, 1), (1, 1))
             for s, sc in spec]
    tjobs = [TJob(s, t(off), None, sc, (1, 1), (1, 1), (1, 1))
             for s, sc in spec]
    jmod = jl.PyramidDeformConv(8, 3)
    v = mint_variables(jmod, [jnp.asarray(x) for x in xs], jjobs, seed=2)
    want = jmod.apply(to_jax(v), [jnp.asarray(x) for x in xs], jjobs)
    tmod = tl.PyramidDeformConv(16, 8, 3)
    load_jax_variables(tmod, v)
    with torch.no_grad():
        got = tmod([t(x) for x in xs], tjobs)
    for g, w_ in zip(got, want):
        assert_close(g, w_)


@pytest.mark.parametrize("depth,stages,dcn", [(18, 4, (False,) * 4),
                                              (50, 2, (False, True))])
def test_resnet(depth, stages, dcn):
    x = np.random.RandomState(3).randn(1, 40, 56, 3).astype(np.float32)
    kw = dict(depth=depth, num_stages=stages,
              out_indices=tuple(range(stages)), stage_with_dcn=dcn,
              frozen_stages=1)
    jmod = JResNet(**kw)
    v = mint_variables(jmod, jnp.asarray(x), seed=3)
    want = jax.jit(jmod.apply)(to_jax(v), jnp.asarray(x))
    tmod = ResNet(**kw)
    load_jax_variables(tmod, v)
    assert not any(p.requires_grad for p in tmod.layer1_0.parameters())
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert len(got) == len(want) == stages
    for g, w_ in zip(got, want):
        assert_close(_nhwc(g), w_, rel=1e-3)


def test_fpn_odd_sizes():
    rng = np.random.RandomState(4)
    chans = [8, 16, 32, 64]
    shapes = [(26, 42), (13, 21), (7, 11), (4, 6)]
    xs = [rng.randn(1, h, w, c).astype(np.float32)
          for (h, w), c in zip(shapes, chans)]
    kw = dict(out_channels=16, start_level=1, add_extra_convs="on_input",
              num_outs=5, norm_cfg=GN)
    jmod = JFPN(**kw)
    v = mint_variables(jmod, [jnp.asarray(x) for x in xs], seed=4)
    want = jax.jit(jmod.apply)(to_jax(v), [jnp.asarray(x) for x in xs])
    tmod = FPN(in_channels=chans, **kw)
    load_jax_variables(tmod, v)
    with torch.no_grad():
        got = tmod([_nchw(x) for x in xs])
    assert [tuple(g.shape[-2:]) for g in got] == \
        [(13, 21), (7, 11), (4, 6), (2, 3), (1, 2)]
    for g, w_ in zip(got, want):
        assert_close(_nhwc(g), w_)


@pytest.mark.parametrize("conv_module_type", ["dcn", "norm"])
def test_ls_head(conv_module_type):
    rng = np.random.RandomState(5)
    shapes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    xs = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in shapes]
    kw = dict(num_classes=4, in_channels=32, feat_channels=32,
              point_feat_channels=32, stacked_convs=2,
              conv_module_type=conv_module_type, norm_groups=8)
    jmod = JLSHead(**kw)
    v = mint_variables(jmod, [jnp.asarray(x) for x in xs], seed=5)
    want = jax.jit(jmod.apply)(to_jax(v), [jnp.asarray(x) for x in xs])
    tmod = LSHead(**kw)
    load_jax_variables(tmod, v)
    with torch.no_grad():
        got = tmod([_nchw(x) for x in xs])
    assert set(got) == set(want) == {"cls", "bbox_init", "bbox_refine"}
    for key in got:
        for g, w_ in zip(got[key], want[key]):
            assert_close(g, w_, rel=1e-3)
