"""The port's flat multi-level sampling engine and per-level oracle against
the JAX package, on the 3-level shapes of ``tests/test_flat_deform.py``.

Tolerance: max|diff| <= 1e-4 * max(1, max|ref|) in f32 (summation order).
Offsets are random f32 values, so no sample lies on a .5 rounding tie of
the nearest mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.ops.deform_conv import (modulated_deform_conv as jax_mdc,
                                       pyramid_deform_conv as jax_pdc)
from lsnet_torch.ops import deform_conv as tdc
from lsnet_torch.ops import flat_deform as tfd
from torch_port_util import assert_close, t

torch.set_num_threads(1)

SHAPES = [(13, 21), (7, 11), (4, 6)]
C = 32
B = 2


def _feats(rng, c=C):
    return [rng.randn(B, h, w, c).astype(np.float32) for h, w in SHAPES]


def _pyramid_jobs(rng, mod):
    """Every (out level, src level) pair of the 3 levels, with masks on
    some of them."""
    jobs = []
    for out in range(3):
        ho, wo = SHAPES[out]
        for src in range(3):
            off = (1.5 * rng.randn(B, ho, wo, 18)).astype(np.float32)
            mask = (rng.rand(B, ho, wo, 9).astype(np.float32)
                    if (out + src) % 2 else None)
            sh = SHAPES[src][0] / ho
            sw = SHAPES[src][1] / wo
            jobs.append(mod.SampleJob(
                src, jnp.asarray(off) if mod is jfd else t(off),
                None if mask is None else
                (jnp.asarray(mask) if mod is jfd else t(mask)),
                (sh, sw), (1, 1), (1, 1), (1, 1)))
    return jobs


@pytest.mark.parametrize("sampling", ["bilinear", "nearest"])
def test_multilevel_pyramid_dcn(monkeypatch, sampling):
    monkeypatch.setattr(jfd, "SAMPLING", [sampling])
    feats = _feats(np.random.RandomState(0))
    w = (0.1 * np.random.RandomState(1).randn(3, 3, C, 16)).astype(
        np.float32)
    want = jfd.multilevel_pyramid_dcn(
        [jnp.asarray(f) for f in feats],
        _pyramid_jobs(np.random.RandomState(2), jfd), jnp.asarray(w),
        site=None)
    got = tfd.multilevel_pyramid_dcn(
        [t(f) for f in feats], _pyramid_jobs(np.random.RandomState(2), tfd),
        t(w), sampling=sampling)
    assert len(got) == 9
    for g, w_ in zip(got, want):
        assert_close(g, w_)


@pytest.mark.parametrize("sampling", ["bilinear", "nearest"])
def test_dual_pyramid_dcn(monkeypatch, sampling):
    monkeypatch.setattr(jfd, "SAMPLING", [sampling])
    rng = np.random.RandomState(3)
    fa, fb = _feats(rng), _feats(rng, c=64)
    wa = (0.1 * rng.randn(3, 3, C, 24)).astype(np.float32)
    wb = (0.1 * rng.randn(3, 3, 64, 40)).astype(np.float32)
    want_a, want_b = jfd.dual_pyramid_dcn(
        [jnp.asarray(f) for f in fa], [jnp.asarray(f) for f in fb],
        _pyramid_jobs(np.random.RandomState(4), jfd), jnp.asarray(wa),
        jnp.asarray(wb), site=None)
    got_a, got_b = tfd.dual_pyramid_dcn(
        [t(f) for f in fa], [t(f) for f in fb],
        _pyramid_jobs(np.random.RandomState(4), tfd), t(wa), t(wb),
        sampling=sampling)
    for g, w_ in zip(got_a + got_b, list(want_a) + list(want_b)):
        assert_close(g, w_)


@pytest.mark.parametrize("stride", [1, 2])
def test_multilevel_modulated_dcn(stride):
    rng = np.random.RandomState(5)
    feats = _feats(rng)
    outs = [(-(-h // stride), -(-w // stride)) for h, w in SHAPES]
    offs = [(2.0 * rng.randn(B, h, w, 18)).astype(np.float32)
            for h, w in outs]
    masks = [rng.rand(B, h, w, 9).astype(np.float32) for h, w in outs]
    wt = (0.1 * rng.randn(3, 3, C, 16)).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    want = jfd.multilevel_modulated_dcn(
        [jnp.asarray(f) for f in feats], [jnp.asarray(o) for o in offs],
        [jnp.asarray(m) for m in masks], jnp.asarray(wt), jnp.asarray(b),
        stride=stride, padding=1)
    got = tfd.multilevel_modulated_dcn(
        [t(f) for f in feats], [t(o) for o in offs], [t(m) for m in masks],
        t(wt), t(b), stride=stride, padding=1)
    for i, (g, w_) in enumerate(zip(got, want)):
        assert_close(g, w_)
        # and the port's own per-level oracle
        oracle = tdc.modulated_deform_conv(t(feats[i]), t(offs[i]),
                                           t(masks[i]), t(wt), t(b),
                                           stride=stride, padding=1)
        assert_close(g, oracle.numpy())


def test_deform_conv_oracle_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(B, 9, 14, C).astype(np.float32)
    off = (2.0 * rng.randn(B, 9, 14, 18)).astype(np.float32)
    mask = rng.rand(B, 9, 14, 9).astype(np.float32)
    wt = (0.1 * rng.randn(3, 3, C, 8)).astype(np.float32)
    want = jax_mdc(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
                   jnp.asarray(wt), padding=1)
    assert_close(tdc.modulated_deform_conv(t(x), t(off), t(mask), t(wt),
                                           padding=1), want)
    want = jax_pdc(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wt), 0.5,
                   0.75, padding=1)
    assert_close(tdc.pyramid_deform_conv(t(x), t(off), t(wt), 0.5, 0.75,
                                         padding=1), want)


def test_pack_levels_layout():
    feats = _feats(np.random.RandomState(7))
    want = jfd.pack_levels([jnp.asarray(f) for f in feats])
    got = tfd.pack_levels([t(f) for f in feats])
    assert (got.B, got.shapes, got.offsets, got.total) == \
        (want.B, want.shapes, want.offsets, want.total)
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(want.flat))


def test_nearest_rounds_half_to_even():
    ys = torch.tensor([[0.5, 1.5, 2.5, -0.5]])
    idx, w = tfd._corner_data(ys, torch.zeros_like(ys), 4, 1,
                              torch.zeros(1, 1, dtype=torch.int32),
                              "nearest")
    assert idx[0].tolist() == [[0, 2, 2, 0]]
    assert w[0].tolist() == [[1.0, 1.0, 1.0, 1.0]]
