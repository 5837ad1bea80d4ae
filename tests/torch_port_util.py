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


def mint_module_(module, seed=0):
    """Fill every entry of a port module's state dict in place with the
    numbers ``mint_variables`` would draw (0.03 * N(0, 1), FrozenBatchNorm
    ``var`` 1 + 0.1 |N(0, 1)|, ``mean`` 0.1 * N(0, 1)), in key order."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for key, v in module.state_dict().items():
            n = rng.randn(*v.shape)
            if key.endswith(".var"):
                n = 1.0 + 0.1 * np.abs(n)
            else:
                n = (0.1 if key.endswith(".mean") else 0.03) * n
            v.copy_(torch.from_numpy(n.astype(np.float32)))
    return module


def _reference_backbone_key(module, key):
    import re
    from lsnet_torch.models.layers import ModulatedDeformConvPack
    mod, leaf = key.rsplit(".", 1)
    flip = isinstance(module.get_submodule(mod), ModulatedDeformConvPack)
    leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
    mod = re.sub(r"^layer(\d+)_(\d+)", r"layer\1.\2", mod)
    mod = mod.replace("downsample_conv", "downsample.0").replace(
        "downsample_bn", "downsample.1")
    return f"{mod}.{leaf}", flip and leaf == "weight"


def _reference_neck_key(module, key):
    import re
    m = re.fullmatch(r"(lateral|fpn|extra)_(\d+)\.(conv|norm)\.(\w+)", key)
    kind, i, sub, leaf = m.groups()
    i = int(i) + (module.n_used if kind == "extra" else 0)
    name = "lateral_convs" if kind == "lateral" else "fpn_convs"
    return f"{name}.{i}.{'gn' if sub == 'norm' else sub}.{leaf}", False


def _reference_head_key(module, key):
    import re
    m = re.fullmatch(r"(\w+)_convs_(\d+)\.(conv|norm)\.(\w+)", key)
    if m:
        b, i, sub, leaf = m.groups()
        return f"{b}_convs.{i}.{'gn' if sub == 'norm' else sub}.{leaf}", \
            False
    m = re.fullmatch(r"(\w+)_af_dcn_conv\.(\w+)", key)
    if m:
        return f"{m.group(1)}_af_dcn_conv.0.{m.group(2)}", False
    m = re.fullmatch(r"pts_(\w+)_cls_pair\.weight_(a|b)", key)
    if m:
        return (f"pts_{m.group(1)}_refine_conv.weight" if m.group(2) == "a"
                else "pts_cls_conv.weight"), True
    return key, key == "pts_bbox_refine_conv.weight"


def reference_state_dict(module, prefix=""):
    """A port ``ResNet``, ``FPN`` or ``LSHead`` state dict in the
    reference's key names (torchvision / mmdet: ``layer1.0.downsample.0``,
    ``running_mean``, ``lateral_convs.0.gn``, ``cls_convs.0.gn``,
    ``cls_af_dcn_conv.0``, ``pts_bbox_refine_conv`` + ``pts_cls_conv``),
    every key after ``prefix``; the deformable weights go back from the
    port's (k, k, cin/G, cout) to (cout, cin/G, k, k)."""
    rule = {"ResNet": _reference_backbone_key, "FPN": _reference_neck_key,
            "LSHead": _reference_head_key}[type(module).__name__]
    out = {}
    for key, v in module.state_dict().items():
        name, flip = rule(module, key)
        out[prefix + name] = (v.permute(3, 2, 0, 1) if flip
                              else v).contiguous().clone()
    return out
