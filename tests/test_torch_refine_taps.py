"""Refine taps (``LSNET_REFINE_TAPS``) in the port against the JAX package:
the tap-subset coordinates, the refine-site gathers of
``multilevel_pyramid_dcn`` and ``dual_pyramid_dcn`` (outputs and the
gradients of the features, offsets, masks and the full 3x3 weight), a
narrow ``LSHead`` forward, and the checkpoint's record and deployment of
the taps (``train_meta``, and ``deploy_sampling`` / ``deploy_taps``
through the runner's ``eval_sampling``, against JAX's ``train_meta`` and
``arm_deploy_policy``).

The JAX package reads ``LSNET_REFINE_TAPS`` from the environment while it
traces; the port takes the taps in its sampling mapping. Tolerance: f32,
max|diff| <= 1e-4 * max(1, max|ref|) for the ops (summation order), 1e-3
for the head (a deeper stack), as the other parity files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.models.heads.ls_head import LSHead as JLSHead
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import checkpoint as jckpt
from lsnet_torch.models.heads.ls_head import LSHead
from lsnet_torch.ops import flat_deform as tfd
from lsnet_torch.train import checkpoint as tckpt
from lsnet_torch.train import loop as tloop
from lsnet_torch.weights import load_jax_variables
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

SHAPES = [(9, 13), (5, 7), (3, 4)]
B = 2
SPECS = ["5", "0,2,4,6,8"]


def _pin_jax(monkeypatch, taps):
    """The JAX package's sampling and tap state are process-wide: another
    test in the same worker may have set them."""
    monkeypatch.setattr(jfd, "SAMPLING", ["bilinear"])
    monkeypatch.setattr(jfd, "SAMPLING_POLICY", {})
    monkeypatch.setattr(jfd, "_REFINE_TAPS_OVERRIDE", [None])
    monkeypatch.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])
    monkeypatch.setattr(jfd, "INFERENCE_REFINE_TAPS", [None])
    if taps is None:
        monkeypatch.delenv("LSNET_REFINE_TAPS", raising=False)
    else:
        monkeypatch.setenv("LSNET_REFINE_TAPS", taps)


def _job_specs(rng):
    """Every (out level, src level) pair, masks on some of them."""
    specs = []
    for out, (ho, wo) in enumerate(SHAPES):
        for src, (hs, ws) in enumerate(SHAPES):
            off = (1.5 * rng.randn(B, ho, wo, 18)).astype(np.float32)
            mask = (rng.rand(B, ho, wo, 9).astype(np.float32)
                    if (out + src) % 2 else None)
            specs.append((src, off, mask, (hs / ho, ws / wo)))
    return specs


def _jobs(mod, specs, offsets, masks):
    return [mod.SampleJob(src, o, m, sc, (1, 1), (1, 1), (1, 1))
            for (src, _, _, sc), o, m in zip(specs, offsets, masks)]


def test_job_coords_tap_subset():
    """The kept taps take their base displacements from the full 3x3 grid:
    equal to JAX's tap-major coordinates, and to the full grid's
    coordinates at the kept taps."""
    rng = np.random.RandomState(0)
    sel = (1, 3, 4, 5, 7)
    off9 = (1.5 * rng.randn(B, 5, 7, 18)).astype(np.float32)
    off5 = off9.reshape(B, 5, 7, 9, 2)[:, :, :, list(sel)].reshape(
        B, 5, 7, 10)
    kw = dict(src_level=0, mask=None, scale=(1.7, 1.9), stride=(1, 1),
              padding=(1, 1), dilation=(1, 1))
    jy, jx = jfd._job_coords(jfd.SampleJob(
        offset=jnp.asarray(off5), taps=(3, 3, sel), **kw), 5, tap_major=True)
    ty, tx = tfd._job_coords(tfd.SampleJob(
        offset=t(off5), taps=(3, 3, sel), **kw), 5)
    assert_close(ty, jy, rel=1e-6)
    assert_close(tx, jx, rel=1e-6)
    fy, fx = tfd._job_coords(tfd.SampleJob(offset=t(off9), **kw), 9)
    keep = lambda a: a.reshape(B, 9, -1)[:, list(sel)].reshape(B, -1)  # noqa
    assert torch.equal(ty, keep(fy)) and torch.equal(tx, keep(fx))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("paired", [False, True])
def test_refine_gathers_match_jax(monkeypatch, spec, paired):
    """``multilevel_pyramid_dcn`` (one branch) and ``dual_pyramid_dcn`` (the
    paired refine and cls branches) at a tap subset: outputs, and the
    gradients of the features, offsets, masks and full 3x3 weights (zero
    at the dropped taps)."""
    _pin_jax(monkeypatch, spec)
    rng = np.random.RandomState(7 + paired)
    C, cout = 16, 24
    feats = [[rng.randn(B, h, w, C).astype(np.float32) for h, w in SHAPES]
             for _ in range(1 + paired)]
    weights = [(0.1 * rng.randn(3, 3, C, cout)).astype(np.float32)
               for _ in range(1 + paired)]
    specs = _job_specs(rng)
    offs = [s[1] for s in specs]
    mask_ix = [i for i, s in enumerate(specs) if s[2] is not None]
    masks = [specs[i][2] for i in mask_ix]
    reads = [[rng.randn(B, *SHAPES[i // 3], cout).astype(np.float32)
              for i in range(len(specs))] for _ in range(1 + paired)]

    def full_masks(ms):
        it = iter(ms)
        return [next(it) if s[2] is not None else None for s in specs]

    def jloss(feats, offsets, ms, weights):
        jobs = _jobs(jfd, specs, offsets, full_masks(ms))
        if paired:
            outs = jfd.dual_pyramid_dcn(*feats, jobs, *weights)
        else:
            outs = [jfd.multilevel_pyramid_dcn(feats[0], jobs, weights[0])]
        return sum(jnp.sum(o * r) for br, rd in zip(outs, reads)
                   for o, r in zip(br, rd))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        [[jnp.asarray(f) for f in fs] for fs in feats],
        [jnp.asarray(o) for o in offs], [jnp.asarray(m) for m in masks],
        [jnp.asarray(w) for w in weights])
    jouts = jax.tree.map(np.asarray, (
        jfd.dual_pyramid_dcn(*[[jnp.asarray(f) for f in fs] for fs in feats],
                             _jobs(jfd, specs, [jnp.asarray(o) for o in offs],
                                   full_masks([jnp.asarray(m)
                                               for m in masks])),
                             *[jnp.asarray(w) for w in weights])
        if paired else
        [jfd.multilevel_pyramid_dcn(
            [jnp.asarray(f) for f in feats[0]],
            _jobs(jfd, specs, [jnp.asarray(o) for o in offs],
                  full_masks([jnp.asarray(m) for m in masks])),
            jnp.asarray(weights[0]))]))

    taps = tfd.parse_refine_taps(spec)
    tf = [[t(f).requires_grad_() for f in fs] for fs in feats]
    to = [t(o).requires_grad_() for o in offs]
    tm = [t(m).requires_grad_() for m in masks]
    tw = [t(w).requires_grad_() for w in weights]
    jobs = _jobs(tfd, specs, to, full_masks(tm))
    if paired:
        outs = tfd.dual_pyramid_dcn(*tf, jobs, *tw, "bilinear", taps)
    else:
        outs = [tfd.multilevel_pyramid_dcn(tf[0], jobs, tw[0], "bilinear",
                                           taps)]
    for br, jbr in zip(outs, jouts):
        for o, j in zip(br, jbr):
            assert_close(o, j)
    sum((o * t(r)).sum() for br, rd in zip(outs, reads)
        for o, r in zip(br, rd)).backward()
    for got, want in zip((sum(tf, []), to, tm, tw),
                         (sum(jgrads[0], []), *jgrads[1:])):
        for g, w_ in zip(got, want):
            assert_close(g.grad, w_)
    dropped = [k for k in range(9) if k not in taps]
    for w in tw:
        assert not w.grad.reshape(9, C, cout)[dropped].any()


def test_no_subset_off_the_3x3_grid():
    """A kernel that is not 3x3 keeps all its taps, as in JAX."""
    w = torch.zeros(1, 1, 4, 4)
    job = tfd.SampleJob(0, torch.zeros(1, 2, 2, 2), None, (1.0, 1.0),
                        (1, 1), (0, 0), (1, 1))
    jobs, ws = tfd._apply_refine_taps([job], [w], (1, 3, 4, 5, 7))
    assert jobs[0] is job and ws[0] is w


def test_ls_head_taps5(monkeypatch):
    """A narrow LSHead at taps 5 (the bbox refine conv and the paired
    refine / cls gathers): every output map."""
    _pin_jax(monkeypatch, "5")
    rng = np.random.RandomState(5)
    shapes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    xs = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in shapes]
    kw = dict(num_classes=4, in_channels=32, feat_channels=32,
              point_feat_channels=32, stacked_convs=1, norm_groups=8)
    jmod = JLSHead(**kw)
    v = mint_variables(jmod, [jnp.asarray(x) for x in xs], seed=5)
    want = jax.jit(jmod.apply)(to_jax(v), [jnp.asarray(x) for x in xs])
    tmod = LSHead(**kw)
    load_jax_variables(tmod, v)
    sampling = tfd.with_refine_taps(tfd.TRAIN_SAMPLING, "5")
    with torch.no_grad():
        got = tmod([t(x).permute(0, 3, 1, 2) for x in xs], sampling)
        full = tmod([t(x).permute(0, 3, 1, 2) for x in xs])
    for key in got:
        for g, w_ in zip(got[key], want[key]):
            assert_close(g, w_, rel=1e-3)
    # the taps reach the refine maps (the tower and init maps are 9-tap)
    assert not torch.equal(got["bbox_refine"][0], full["bbox_refine"][0])
    assert torch.equal(got["bbox_init"][0], full["bbox_init"][0])


def _jax_deploy(monkeypatch, meta, env):
    """(site->mode, kept taps) of a JAX evaluation after restoring a
    checkpoint with ``meta``: ``arm_deploy_policy`` then the sampling
    and taps in force inside ``inference_sampling()``."""
    _pin_jax(monkeypatch, env)
    monkeypatch.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
    jfd.arm_deploy_policy(meta)
    with jfd.inference_sampling():
        return (tfd.sampling_from_spec(jfd.current_sampling_spec()),
                jfd._refine_taps())


@pytest.mark.parametrize("meta,env", [
    (None, None),
    (None, "5"),
    ({"dcn_sampling_train": "bilinear"}, None),
    ({"dcn_sampling_train": "bilinear", "refine_taps_train": "5"}, None),
    ({"dcn_sampling_train": "nearest_ste", "refine_taps_train": "5"}, None),
    ({"dcn_sampling_train": "bilinear", "refine_taps_train": "5"}, "9"),
    ({"dcn_sampling_train": "bilinear", "refine_taps_train": "5"},
     "0,2,4,6,8"),
    ({"dcn_sampling_train": "tower=nearest_ste",
      "refine_taps_train": "1,3,4,5,7"}, None),
])
def test_deploy_sampling_matches_arm_deploy_policy(monkeypatch, meta, env):
    """The checkpoint's trained taps deploy; an explicit LSNET_REFINE_TAPS
    wins."""
    modes, taps = _jax_deploy(monkeypatch, meta, env)
    got = tloop.eval_sampling(meta=meta, taps=env)
    assert {s: got[s] for s in tfd.SITES} == modes
    assert dict(tckpt.deploy_sampling(meta)) == modes
    assert tfd.refine_taps(got) == (None if taps is None else tuple(taps))


@pytest.mark.parametrize("env", [None, "5", "0,2,4,6,8"])
def test_train_meta_matches_jax(monkeypatch, env):
    _pin_jax(monkeypatch, env)
    assert tckpt.train_meta(None, tckpt.refine_taps_env()) == \
        jckpt.train_meta()
