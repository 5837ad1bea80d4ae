"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The inputs and weights of both packages are made with numpy from a seed
and handed to each; weights are 0.03 * N(0, 1) everywhere (so the DCN
offset convs are not the all-zero init that would make DCN a plain conv),
with positive FrozenBatchNorm variances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def mint_variables(module, *example_inputs, seed=0):
    """Numpy variables for a flax module, shaped by ``eval_shape``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *example_inputs))
    rng = np.random.RandomState(seed)

    def mint(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return (1.0 + 0.1 * np.abs(rng.randn(*s.shape))).astype(
                np.float32)
        scale = 0.1 if name.endswith("['mean']") else 0.03
        return (scale * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mint, shapes)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def t(x):
    """numpy/jax array -> torch CPU tensor (copy)."""
    return torch.from_numpy(np.array(x))


def assert_close(got, want, rel=1e-4):
    """max |got - want| <= rel * max(1, max |want|)."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    lim = rel * max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    assert err <= lim, f"max|diff| {err:.3g} > {lim:.3g}"
