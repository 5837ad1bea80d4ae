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
    """torchvision / mmdet names; Res2Net v1d's as mmdet's ``res2net.py``
    writes them: ``convs.i`` / ``bns.i``, the deep stem ``stem.{0..7}``,
    the avg-down shortcut ``downsample.{1,2}`` (an ``AvgPool2d`` at 0)."""
    import re
    from lsnet_torch.models.backbones.resnet import Res2Bottleneck
    from lsnet_torch.models.layers import ModulatedDeformConvPack
    mod, leaf = key.rsplit(".", 1)
    flip = isinstance(module.get_submodule(mod), ModulatedDeformConvPack)
    leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
    res2 = isinstance(module.get_submodule(mod.split(".")[0]),
                      Res2Bottleneck)
    mod = re.sub(r"^stem_(conv|bn)(\d)", lambda m: "stem.%d" % (
        3 * (int(m.group(2)) - 1) + (m.group(1) == "bn")), mod)
    mod = re.sub(r"^layer(\d+)_(\d+)", r"layer\1.\2", mod)
    mod = re.sub(r"\.conv2_(\d+)", r".convs.\1", mod)
    mod = re.sub(r"\.bn2_(\d+)", r".bns.\1", mod)
    mod = mod.replace("downsample_conv", "downsample.%d" % res2).replace(
        "downsample_bn", "downsample.%d" % (1 + res2))
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


def grads_close(got, want, rel=1e-4, abs_=1e-5, leaf_abs=None):
    """Two flax-named gradient trees: the same leaves, and each leaf
    within max(rel * max|want|, abs_) of the reference, or of the floor
    ``leaf_abs`` gives the leaf by its ``keystr``."""
    leaf_abs = leaf_abs or {}
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    assert set(leaf_abs) <= {jax.tree_util.keystr(p) for p in flat_w}
    for path, w_ in flat_w.items():
        name = jax.tree_util.keystr(path)
        g = np.asarray(flat_g[path], np.float64)
        w_ = np.asarray(w_, np.float64)
        assert g.shape == w_.shape, name
        err = float(np.max(np.abs(g - w_)))
        lim = max(rel * float(np.max(np.abs(w_))), leaf_abs.get(name, abs_))
        assert err <= lim, (name, err, lim)


def level_feats(levels, channels, batch=2, seed=3):
    """Seeded NHWC FPN-level features, (batch, h, w, channels) each."""
    rng = np.random.RandomState(seed)
    return [rng.randn(batch, h, w, channels).astype(np.float32)
            for h, w in levels]


def gt_batch(hw, num_classes, m=5, seed=4, empty=False):
    """A seeded loss batch of 2 images on an (h, w) canvas: ``m`` GT slots
    an image, boxes 10 to 50 px a side inside the canvas, the last two
    slots of image 1 padding (all padding with ``empty``); image 1's own
    size 8 x 16 px under the canvas."""
    rng = np.random.RandomState(seed)
    h, w = hw
    wh = rng.uniform(10.0, 50.0, (2, m, 2))
    xy = rng.uniform(0.0, 1.0, (2, m, 2)) * (np.array([w, h]) - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = np.ones((2, m), bool)
    valid[1, m - 2:] = False
    if empty:
        valid[:] = False
    shape = np.array([[h, w], [h - 8, w - 16]], np.int32)
    return dict(gt_bboxes=boxes,
                gt_labels=rng.randint(0, num_classes, (2, m)).astype(
                    np.int32),
                gt_valid=valid, img_shape=shape, pad_shape=shape.copy())


def write_narrow_config(path, ann_file, img_prefix, hw=(64, 96), **extra):
    """A narrow R18 LSNet bbox config file over a procedural COCO set
    (the shipped R50 file with a 32-wide neck and head, 3 classes),
    readable by ``Config.fromfile`` of both packages; returns ``path``."""
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    norm = dict(type="GN", num_groups=8)
    data = dict(ann_file=ann_file, img_prefix=img_prefix,
                img_scale=(hw[1], hw[0]))
    cfg = dict(
        _base_=os.path.join(repo, "configs", "lsnet",
                            "lsnet_bbox_r50_fpn_1x_coco.py"),
        model=dict(
            backbone=dict(depth=18, frozen_stages=-1),
            neck=dict(in_channels=[64, 128, 256, 512], out_channels=32,
                      norm_cfg=norm),
            bbox_head=dict(in_channels=32, feat_channels=32,
                           point_feat_channels=32, stacked_convs=1,
                           norm_cfg=norm, num_classes=3)),
        data=dict(samples_per_gpu=2, train=dict(data), val=dict(data),
                  test=dict(data)),
        canvas_shape=tuple(hw), test_cfg=dict(score_thr=0.008), **extra)
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return path
