"""The port's deformable gather+contract against the JAX package.

* ``deform_gather_contract_ref`` (the kernel's plain version, which the
  CPU wrapper runs) vs ``flat_deform._tap_gather_contract``;
* ``multilevel_modulated_dcn`` vs the JAX function routed through the
  Pallas kernel ``pallas_dma_gather.dma_quad_contract`` (interpret mode on
  the CPU), at the head's width C=256;
The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerance: max|diff| <= 1e-4 * max(1, max|ref|) in f32 (the two sum a
K*C-term contraction in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.ops import pallas_dma_gather as pdg
from lsnet_torch.ops import flat_deform as tfd
from lsnet_torch.ops.deform_gather import (deform_gather_contract,
                                           deform_gather_contract_ref)
from torch_port_util import assert_close, t

torch.set_num_threads(1)


def _table(rng, nc, K=9, R=300, px=200, C=64, cout=48):
    flat = rng.randn(R, C).astype(np.float32)
    idx = rng.randint(0, R, (nc, K, px)).astype(np.int32)
    w = rng.rand(nc, K, px).astype(np.float32)
    wk = (rng.randn(K, C, cout) / np.sqrt(K * C)).astype(np.float32)
    return flat, idx, w, wk


@pytest.mark.parametrize("nc", [4, 1])
def test_plain_version_matches_tap_gather_contract(nc):
    flat, idx, w, wk = _table(np.random.RandomState(nc), nc)
    want = jfd._tap_gather_contract(jnp.asarray(flat), jnp.asarray(idx),
                                    jnp.asarray(w), jnp.asarray(wk))
    before = deform_gather_contract.launches
    got = deform_gather_contract(t(flat), t(idx), t(w), t(wk))
    assert deform_gather_contract.launches == before   # CPU: no launch
    assert got.dtype == torch.float32 and got.shape == (200, 48)
    assert_close(got, want)


def test_modulated_dcn_matches_pallas_route(monkeypatch):
    monkeypatch.setattr(jfd, "QUAD_X", [True])
    monkeypatch.setattr(pdg, "ENABLED", [True])
    calls = []
    real = pdg.dma_quad_contract

    def spy(*args):
        calls.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(pdg, "dma_quad_contract", spy)
    rng = np.random.RandomState(0)
    B, C, cout = 2, 256, 128
    shapes = [(8, 12), (4, 6)]                     # px = 2 * 120 = 240
    feats = [rng.randn(B, h, w, C).astype(np.float32) for h, w in shapes]
    # fractional offsets, some samples past the border
    offs = [(2.0 * rng.randn(B, h, w, 18)).astype(np.float32)
            for h, w in shapes]
    masks = [rng.rand(B, h, w, 9).astype(np.float32) for h, w in shapes]
    wt = (0.05 * rng.randn(3, 3, C, cout)).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = jfd.multilevel_modulated_dcn(
        [jnp.asarray(f) for f in feats], [jnp.asarray(o) for o in offs],
        [jnp.asarray(m) for m in masks], jnp.asarray(wt), jnp.asarray(b),
        padding=1)
    assert calls == [(9, 240)], "JAX call did not reach the Pallas kernel"
    got = tfd.multilevel_modulated_dcn(
        [t(f) for f in feats], [t(o) for o in offs], [t(m) for m in masks],
        t(wt), t(b), padding=1)
    for g, w_ in zip(got, want):
        assert_close(g, w_)
