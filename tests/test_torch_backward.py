"""Gradients of the port's two fused deformable contractions, on the CPU
(where the ``torch.autograd.Function`` runs the plain ``*_bwd_*_ref``
versions; the CUDA backward kernels are held against these on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``):

* against torch autograd of the forward plain versions;
* against ``jax.grad`` of ``multilevel_modulated_dcn`` and
  ``dual_pyramid_dcn`` with respect to features, offsets, masks and
  weights, bilinear and ``nearest_ste``, ungrouped and grouped;
* the grouped pair against ``jax.grad`` of the Pallas kernel
  ``pallas_grouped.grouped_deform_contract`` (interpret mode) through the
  identity-table wrapper.

Inputs are minted with numpy from a seed, f32. Tolerance: 1e-4 *
max(1, max|ref|) per gradient (f32 sums in another order; the JAX side
gathers, weights and contracts in separate XLA ops). Offsets are random
f32 values, so no sample lies on a rounding tie or a lattice point, where
the sampling is not differentiable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.ops import pallas_grouped as jpg
from lsnet_torch.ops import deform_gather as dg
from lsnet_torch.ops import flat_deform as tfd
from lsnet_torch.ops import grouped as gr
from torch_port_util import assert_close, t

torch.set_num_threads(1)

SHAPES = [(9, 13), (5, 7)]
B = 2


def _pin_jax_sampling(monkeypatch, sampling):
    """The JAX package's sampling is process-wide state that another test
    file in the same worker may have set."""
    monkeypatch.setattr(jfd, "SAMPLING", [sampling])
    monkeypatch.setattr(jfd, "SAMPLING_POLICY", {})


def _table(rng, nc, K, px, R):
    idx = rng.randint(0, R, (nc, K, px)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]               # rows shared between pixels
    w = rng.rand(nc, K, px).astype(np.float32)
    w[rng.rand(nc, K, px) < 0.1] = 0.0        # clipped corners weigh 0
    return idx, w


@pytest.mark.parametrize("groups,nc", [(1, 4), (1, 1), (4, 4), (4, 1)])
def test_function_matches_autograd_of_plain_forward(groups, nc):
    rng = np.random.RandomState(groups + nc)
    K, R, px, C, cout = 9, 50, 70, 32, 16
    idx, w = _table(rng, nc, K, px, R)
    leaves = [rng.randn(R, C), w, 0.1 * rng.randn(K, C // groups, cout)]
    dout = t(rng.randn(px, cout).astype(np.float32))
    grads = []
    for use_function in (True, False):
        flat, w_, wk = (t(x.astype(np.float32)).requires_grad_()
                        for x in leaves)
        if groups == 1:
            fn = (dg.deform_gather_contract if use_function
                  else dg.deform_gather_contract_ref)
            out = fn(flat, t(idx), w_, wk)
        else:
            fn = (gr.deform_gather_grouped_contract if use_function
                  else gr.deform_gather_grouped_contract_ref)
            out = fn(flat, t(idx), w_, wk, groups)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad(out, (flat, w_, wk), dout))
    for got, want in zip(*grads):
        assert_close(got, want.numpy())


def test_backward_computes_only_what_is_needed():
    """``needs_input_grad`` is honoured: no bwd-data call for a frozen
    input map and constant corner weights, no bwd-weight call for a frozen
    weight, and d_flat / d_w are asked for one by one."""
    rng = np.random.RandomState(0)
    idx, w = _table(rng, 4, 9, 20, 30)
    calls = []

    def bwd_data(flat, idx, w, weight, dout, need_flat, need_w):
        calls.append(("data", need_flat, need_w))
        return dg.deform_gather_contract_bwd_data_ref(
            flat, idx, w, weight, dout, need_flat, need_w)

    def bwd_weight(flat, idx, w, weight, dout):
        calls.append(("weight",))
        return dg.deform_gather_contract_bwd_weight_ref(flat, idx, w, dout)

    ops = dg.ContractOps(dg.deform_gather_contract_ref, bwd_data, bwd_weight)
    for req, want in (((False, False, True), [("weight",)]),
                      ((True, False, False), [("data", True, False)]),
                      ((False, True, False), [("data", False, True)]),
                      ((True, True, True), [("data", True, True),
                                            ("weight",)])):
        flat = t(rng.randn(30, 16).astype(np.float32)).requires_grad_(req[0])
        w_ = t(w).requires_grad_(req[1])
        wk = t(rng.randn(9, 16, 8).astype(np.float32)).requires_grad_(req[2])
        calls.clear()
        out = dg.GatherContract.apply(ops, flat, t(idx), w_, wk, None, None)
        out.sum().backward()
        assert calls == want
        for x, r in zip((flat, w_, wk), req):
            assert (x.grad is not None) == r


def _dcn_inputs(rng, C, cin_g, cout, stride=1):
    feats = [rng.randn(B, h * stride, w * stride, C).astype(np.float32)
             for h, w in SHAPES]
    offsets = [(1.5 * rng.randn(B, h, w, 18)).astype(np.float32)
               for h, w in SHAPES]
    masks = [rng.rand(B, h, w, 9).astype(np.float32) for h, w in SHAPES]
    weight = (0.1 * rng.randn(3, 3, cin_g, cout)).astype(np.float32)
    return feats, offsets, masks, weight


@pytest.mark.parametrize("sampling", ["bilinear", "nearest_ste"])
@pytest.mark.parametrize("groups,stride", [(1, 1), (4, 1), (4, 2)])
def test_modulated_dcn_gradients_match_jax(monkeypatch, sampling, groups,
                                           stride):
    """d/d(features, offsets, masks, weight) of a scalar readout of
    ``multilevel_modulated_dcn``; under ``nearest_ste`` the values are the
    nearest samples' and the offsets take the bilinear tent slopes."""
    _pin_jax_sampling(monkeypatch, sampling)
    rng = np.random.RandomState(3 + groups + stride)
    C = cout = 32
    feats, offsets, masks, weight = _dcn_inputs(rng, C, C // groups, cout,
                                                stride)
    readout = [rng.randn(B, h, w, cout).astype(np.float32)
               for h, w in SHAPES]

    def jloss(feats, offsets, masks, weight):
        outs = jfd.multilevel_modulated_dcn(
            feats, offsets, masks, weight, stride=stride, groups=groups,
            site=None)
        return sum(jnp.sum(o * r) for o, r in zip(outs, readout)), outs

    (_, jouts), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        [jnp.asarray(f) for f in feats], [jnp.asarray(o) for o in offsets],
        [jnp.asarray(m) for m in masks], jnp.asarray(weight))

    tf = [t(f).requires_grad_() for f in feats]
    to = [t(o).requires_grad_() for o in offsets]
    tm = [t(m).requires_grad_() for m in masks]
    tw = t(weight).requires_grad_()
    touts = tfd.multilevel_modulated_dcn(tf, to, tm, tw, stride=stride,
                                         groups=groups, sampling=sampling)
    for got, want in zip(touts, jouts):
        assert_close(got, want)
    sum((o * t(r)).sum() for o, r in zip(touts, readout)).backward()
    for got, want in zip((tf, to, tm, [tw]),
                         (*jgrads[:3], [jgrads[3]])):
        for g, w_ in zip(got, want):
            assert float(np.abs(np.asarray(w_)).max()) > 0
            assert_close(g.grad, w_)


def _pyramid_jobs(rng):
    """Every (out level, src level) pair, masks on some; the offsets are
    leaves whose gradients are compared."""
    jobs, offs = [], []
    for out, (ho, wo) in enumerate(SHAPES):
        for src, (hs, ws) in enumerate(SHAPES):
            off = (1.5 * rng.randn(B, ho, wo, 18)).astype(np.float32)
            mask = (rng.rand(B, ho, wo, 9).astype(np.float32)
                    if (out + src) % 2 else None)
            offs.append(off)
            jobs.append((src, mask, (hs / ho, ws / wo)))
    return jobs, offs


@pytest.mark.parametrize("sampling", ["bilinear", "nearest_ste"])
def test_dual_pyramid_dcn_gradients_match_jax(monkeypatch, sampling):
    """Two launches share one corner table: the offsets' gradient is the
    sum over both branches."""
    _pin_jax_sampling(monkeypatch, sampling)
    rng = np.random.RandomState(11)
    C, cout = 16, 24
    fa = [rng.randn(B, h, w, C).astype(np.float32) for h, w in SHAPES]
    fb = [rng.randn(B, h, w, C).astype(np.float32) for h, w in SHAPES]
    wa = (0.1 * rng.randn(3, 3, C, cout)).astype(np.float32)
    wb = (0.1 * rng.randn(3, 3, C, cout)).astype(np.float32)
    specs, offs = _pyramid_jobs(rng)
    ra = [rng.randn(B, *SHAPES[i // 2], cout).astype(np.float32)
          for i in range(len(specs))]
    rb = [rng.randn(B, *SHAPES[i // 2], cout).astype(np.float32)
          for i in range(len(specs))]

    def jobs_of(mod, offsets, conv):
        return [mod.SampleJob(src, off, None if m is None else conv(m), sc,
                              (1, 1), (1, 1), (1, 1))
                for (src, m, sc), off in zip(specs, offsets)]

    def jloss(fa, fb, offsets, wa, wb):
        oa, ob = jfd.dual_pyramid_dcn(fa, fb, jobs_of(jfd, offsets,
                                                      jnp.asarray),
                                      wa, wb, site=None)
        return (sum(jnp.sum(o * r) for o, r in zip(oa, ra))
                + sum(jnp.sum(o * r) for o, r in zip(ob, rb)))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        [jnp.asarray(f) for f in fa], [jnp.asarray(f) for f in fb],
        [jnp.asarray(o) for o in offs], jnp.asarray(wa), jnp.asarray(wb))

    tfa = [t(f).requires_grad_() for f in fa]
    tfb = [t(f).requires_grad_() for f in fb]
    toff = [t(o).requires_grad_() for o in offs]
    twa, twb = t(wa).requires_grad_(), t(wb).requires_grad_()
    oa, ob = tfd.dual_pyramid_dcn(tfa, tfb, jobs_of(tfd, toff, t), twa, twb,
                                  sampling)
    (sum((o * t(r)).sum() for o, r in zip(oa, ra))
     + sum((o * t(r)).sum() for o, r in zip(ob, rb))).backward()
    for got, want in zip((tfa, tfb, toff, [twa], [twb]),
                         (*jgrads[:3], [jgrads[3]], [jgrads[4]])):
        for g, w_ in zip(got, want):
            assert_close(g.grad, w_)


def test_nearest_ste_without_grad_builds_one_table():
    """Under no_grad the straight-through table is not built, and the
    value is the nearest sample's."""
    rng = np.random.RandomState(5)
    feats, offsets, masks, weight = _dcn_inputs(rng, 16, 16, 8)
    args = ([t(f) for f in feats], [t(o) for o in offsets],
            [t(m) for m in masks], t(weight))
    levels = tfd.pack_levels(args[0])
    jobs = [tfd.SampleJob(i, args[1][i], args[2][i], (1.0, 1.0), (1, 1),
                          (1, 1), (1, 1)) for i in range(len(SHAPES))]
    assert tfd._corner_tables(levels, jobs, 9, "nearest_ste")[2] is None
    ste = tfd.multilevel_modulated_dcn(*args, sampling="nearest_ste")
    near = tfd.multilevel_modulated_dcn(*args, sampling="nearest")
    for a, b in zip(ste, near):
        assert torch.equal(a, b)
    assert "nearest_ste" in tfd.SAMPLING_MODES
    assert set(tfd.TRAIN_SAMPLING.values()) == {"bilinear"}


PALLAS_CASES = [
    # (px, K, C, groups, cout): the cases of tests/test_pallas_grouped.py
    # and one whose px is not a multiple of 64
    (64, 9, 512, 4, 512),
    (96, 9, 256, 2, 256),
    (40, 4, 256, 2, 512),
    (100, 9, 256, 2, 256),
]


@pytest.mark.parametrize("px,K,C,G,cout", PALLAS_CASES)
def test_grouped_gradients_match_pallas_kernels(px, K, C, G, cout):
    """d/d(vals, weight) through the identity-table wrapper against the
    two Pallas backward kernels of ``_gdc_bwd`` (interpret mode)."""
    assert jpg.supported(K, C, G, cout)
    rng = np.random.RandomState(px)
    vals = rng.randn(px, K * C).astype(np.float32)
    w = (0.05 * rng.randn(K, C // G, cout)).astype(np.float32)
    dout = rng.randn(px, cout).astype(np.float32)

    def jloss(v, w):
        return jnp.sum(jpg.grouped_deform_contract(v, w, K, G) * dout)

    jgv, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vals),
                                               jnp.asarray(w))
    tv, tw = t(vals).requires_grad_(), t(w).requires_grad_()
    (gr.grouped_deform_contract(tv, tw, K, G) * t(dout)).sum().backward()
    assert_close(tv.grad, jgv)
    assert_close(tw.grad, jgw)
