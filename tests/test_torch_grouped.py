"""The port's grouped deformable contraction against the JAX package.

* ``grouped_deform_contract`` (the fused function on an identity table,
  run by its plain version on the CPU) vs the Pallas kernel
  ``pallas_grouped.grouped_deform_contract`` in interpret mode, and vs
  JAX's dense block-diagonal contraction (``_blockdiag_weight``);
* the fused grouped DCN (``multilevel_modulated_dcn(groups=G)``) on real
  corner tables, bilinear and nearest, stride 1 and 2, vs JAX
  ``multilevel_modulated_dcn(groups=G, site="backbone")`` under the
  matching JAX sampling, on identical numpy offsets and masks;
* the wrapper's shape and device checks.
The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: 2e-5 (rtol and atol) against the Pallas kernel, as
``tests/test_pallas_grouped.py`` holds it against the dense form (a
K*Cg-term f32 sum in another order); 1e-4 * max(1, max|ref|) for the
fused DCN (bilinear weights and the mask multiply in another order too).
Offsets are random f32 values, so no nearest sample lies on a .5 tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.ops import pallas_grouped as jpg
from lsnet_torch.ops import deform_conv as tdc
from lsnet_torch.ops import flat_deform as tfd
from lsnet_torch.ops.deform_gather import deform_gather_contract_ref
from lsnet_torch.ops.grouped import (_check_kernel_limits,
                                     deform_gather_grouped_contract,
                                     deform_gather_grouped_contract_ref,
                                     grouped_deform_contract)
from torch_port_util import assert_close, t

torch.set_num_threads(1)

CASES = [
    # (px, K, C, groups, cout): X-101 c3- and c4-like, and a ragged pixel
    # tile with 2 wide groups
    (64, 9, 512, 64, 512),
    (48, 9, 1024, 64, 1024),
    (40, 9, 256, 2, 256),
]


def _vals_weight(px, K, C, G, cout, seed=0):
    rng = np.random.RandomState(seed)
    vals = rng.randn(px, K * C).astype(np.float32)
    w = (0.05 * rng.randn(K, C // G, cout)).astype(np.float32)
    return vals, w


@pytest.mark.parametrize("px,K,C,G,cout", CASES)
def test_contract_matches_pallas_kernel(px, K, C, G, cout):
    assert jpg.supported(K, C, G, cout)      # the Pallas kernel takes it
    vals, w = _vals_weight(px, K, C, G, cout)
    want = jpg.grouped_deform_contract(jnp.asarray(vals), jnp.asarray(w), K,
                                       G)
    before = deform_gather_grouped_contract.launches
    got = grouped_deform_contract(t(vals), t(w), K, G)
    assert deform_gather_grouped_contract.launches == before  # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (px, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("px,K,C,G,cout", CASES)
def test_contract_matches_dense_blockdiag(px, K, C, G, cout):
    vals, w = _vals_weight(px, K, C, G, cout, seed=1)
    wmat = jfd._blockdiag_weight(jnp.asarray(w).reshape(3, 3, C // G, cout),
                                 K, G)
    want = jax.lax.dot_general(jnp.asarray(vals), wmat,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
    got = grouped_deform_contract(t(vals), t(w), K, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


SHAPES = [(12, 20), (6, 10)]
B = 2


def _dcn_inputs(stride, C, G, cout, seed):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, h, w, C).astype(np.float32) for h, w in SHAPES]
    outs = [(-(-h // stride), -(-w // stride)) for h, w in SHAPES]
    offs = [(2.0 * rng.randn(B, h, w, 18)).astype(np.float32)
            for h, w in outs]
    masks = [rng.rand(B, h, w, 9).astype(np.float32) for h, w in outs]
    wt = (0.1 * rng.randn(3, 3, C // G, cout)).astype(np.float32)
    return feats, offs, masks, wt


def _jax_dcn(monkeypatch, sampling, feats, offs, masks, wt, stride, G):
    """JAX multilevel_modulated_dcn at the backbone site: bilinear with the
    process-wide policy pinned to bilinear, nearest through
    ``inference_sampling()`` with the shipped default pinned."""
    monkeypatch.setattr(jfd, "SAMPLING", ["bilinear"])
    monkeypatch.setattr(jfd, "SAMPLING_POLICY", {})
    monkeypatch.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
    monkeypatch.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])

    def run():
        return jfd.multilevel_modulated_dcn(
            [jnp.asarray(f) for f in feats], [jnp.asarray(o) for o in offs],
            [jnp.asarray(m) for m in masks], jnp.asarray(wt),
            stride=stride, padding=1, groups=G, site="backbone")

    if sampling == "bilinear":
        return run()
    with jfd.inference_sampling():
        return run()


@pytest.mark.parametrize("sampling", ["bilinear", "nearest"])
@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_dcn_matches_jax(monkeypatch, sampling, stride):
    C, G, cout = 64, 8, 64                        # Cg = outG = 8, as at c3
    feats, offs, masks, wt = _dcn_inputs(stride, C, G, cout, seed=stride)
    want = _jax_dcn(monkeypatch, sampling, feats, offs, masks, wt, stride, G)
    got = tfd.multilevel_modulated_dcn(
        [t(f) for f in feats], [t(o) for o in offs], [t(m) for m in masks],
        t(wt), stride=stride, padding=1, groups=G,
        sampling=tfd.INFERENCE_SAMPLING["backbone"] if sampling == "nearest"
        else tfd.TRAIN_SAMPLING["backbone"])
    assert len(got) == len(want) == 2
    for i, (g, w_) in enumerate(zip(got, want)):
        assert_close(g, w_)
        if sampling == "bilinear":               # the per-level oracle too
            oracle = tdc.modulated_deform_conv(
                t(feats[i]), t(offs[i]), t(masks[i]), t(wt), stride=stride,
                padding=1, groups=G)
            assert_close(g, oracle.numpy())


def test_fused_plain_version_matches_blockdiag_k1():
    """The grouped plain version equals the dense contraction with the
    block-diagonal weight (the JAX default route's form) on one table."""
    rng = np.random.RandomState(3)
    K, R, px, C, G, cout = 9, 90, 50, 128, 8, 64
    flat = t(rng.randn(R, C).astype(np.float32))
    idx = t(rng.randint(0, R, (4, K, px)).astype(np.int32))
    w = t(rng.rand(4, K, px).astype(np.float32))
    wk = (0.1 * rng.randn(K, C // G, cout)).astype(np.float32)
    dense = np.asarray(jfd._blockdiag_weight(
        jnp.asarray(wk).reshape(3, 3, C // G, cout), K, G)).reshape(K, C,
                                                                    cout)
    want = deform_gather_contract_ref(flat, idx, w, t(dense))
    got = deform_gather_grouped_contract(flat, idx, w, t(wk), G)
    assert_close(got, want.numpy())


def _table(C=128, G=8, cout=64, nc=1, dtype=torch.float32):
    K, px = 9, 20
    return (torch.zeros(40, C, dtype=dtype),
            torch.zeros(nc, K, px, dtype=torch.int32),
            torch.zeros(nc, K, px),
            torch.zeros(K, C // G, cout, dtype=dtype))


def test_wrapper_rejects_bad_shapes():
    flat, idx, w, wk = _table()
    with pytest.raises(ValueError, match="does not split"):
        deform_gather_grouped_contract(flat[:, :120], idx, w, wk, 8)
    with pytest.raises(ValueError, match="does not split"):
        deform_gather_grouped_contract(flat, idx, w, wk[..., :60], 8)
    with pytest.raises(ValueError, match="want"):
        deform_gather_grouped_contract(flat, idx[0], w[0], wk, 8)
    with pytest.raises(ValueError, match="weight has K"):
        deform_gather_grouped_contract(flat, idx[:, :4], w[:, :4], wk, 8)


def test_wrapper_rejects_bad_types_and_device():
    flat, idx, w, wk = _table()
    with pytest.raises(TypeError):
        deform_gather_grouped_contract(flat, idx.long(), w, wk, 8)
    with pytest.raises(TypeError):
        deform_gather_grouped_contract(flat, idx, w, wk.bfloat16(), 8)
    meta = [x.to("meta") for x in (flat, idx, w, wk)]
    with pytest.raises(ValueError, match="no kernel for device"):
        deform_gather_grouped_contract(*meta, 8)


@pytest.mark.parametrize("C,G,cout,nc", [
    (128, 8, 64, 5),                              # more than 4 corners
    (256, 2, 256, 1),                             # outG 128 does not divide 64
    (128, 8, 32, 1),                              # cout not a multiple of 64
    (64, 16, 256, 1),                             # slice 16 < bf16 chunk 32
])
def test_kernel_limits_raise(C, G, cout, nc):
    with pytest.raises(ValueError):
        _check_kernel_limits(*_table(C, G, cout, nc, torch.bfloat16), G)


def test_kernel_limits_take_x101_stages():
    for C, dtype in ((512, torch.bfloat16), (1024, torch.bfloat16),
                     (2048, torch.float32)):
        flat = torch.zeros(10, C, dtype=dtype)
        idx = torch.zeros(1, 9, 7, dtype=torch.int32)
        _check_kernel_limits(flat, idx, torch.zeros(1, 9, 7),
                             torch.zeros(9, C // 64, C, dtype=dtype), 64)


def test_plain_version_is_the_cpu_path():
    flat, idx, w, wk = _table(nc=4)
    gen = torch.Generator().manual_seed(0)
    flat = torch.randn(flat.shape, generator=gen)
    idx = torch.randint(0, 40, idx.shape, generator=gen, dtype=torch.int32)
    w = torch.rand(w.shape, generator=gen)
    wk = torch.randn(wk.shape, generator=gen)
    got = deform_gather_grouped_contract(flat, idx, w, wk, 8)
    want = deform_gather_grouped_contract_ref(flat, idx, w, wk, 8)
    assert torch.equal(got, want)
