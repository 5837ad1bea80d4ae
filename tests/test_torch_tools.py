"""The port's root tools (``lsnet_torch.tools.<name>``) against the JAX
package's scripts (``tools/<name>.py``) on the same inputs, on the CPU:
``print_config`` text, ``analyze_logs`` times, ``gen_coco_lsvr`` json,
``coco_error_analysis`` bands, ``browse_dataset`` pixels, ``get_flops``
counts, and the ``fuse_conv_bn`` / ``publish_model`` checkpoints through
``apis.init_detector``.

``get_flops``: the JAX script prints XLA's cost analysis, which also
counts elementwise work (norms, activations, the sampling's corner
weights), so the test holds the port's count against the products of the
same JAX forward instead: the FLOPs of every ``conv_general_dilated`` and
``dot_general`` in its jaxpr (2 a multiply-add), on an ungrouped DCN model
where the JAX package contracts each DCN call as one dense product. The
two are the same sum: equal within 1e-9 of the total (integer counts).
"""

import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_torch.tools.shapes import make_shapes_coco
from torch_port_util import mint_variables, write_narrow_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

torch.set_num_threads(1)


def _jax_main(module, monkeypatch, *argv):
    """Run a JAX script's ``main()`` with ``argv``."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    return module.main()


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    ann, img = make_shapes_coco(str(root / "data"), 4, seed=2, hw=(64, 96))
    cfg = write_narrow_config(str(root / "narrow.py"), ann, img)
    return root, ann, img, cfg


def test_print_config_text(monkeypatch, capsys):
    import print_config as jtool

    from lsnet_torch.tools import print_config as ptool
    cfg = os.path.join(REPO, "configs", "lsnet",
                       "lsnet_bbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py")
    opts = ["--options", "model.bbox_head.num_classes=3",
            "data.samples_per_gpu=4"]
    _jax_main(jtool, monkeypatch, cfg, *opts)
    want = capsys.readouterr().out
    ptool.main([cfg, *opts])
    got = capsys.readouterr().out
    assert got == want
    assert "num_classes=3" in got and got.startswith("Config:\n")


def test_analyze_logs_times(tmp_path, monkeypatch, capsys):
    import analyze_logs as jtool

    from lsnet_torch.tools import analyze_logs as ptool
    rng = np.random.RandomState(0)
    path = str(tmp_path / "run.log.json")
    with open(path, "w") as f:
        for i in range(12):
            f.write(json.dumps(dict(mode="train", epoch=0, iter=i + 1,
                                    time=float(rng.rand()),
                                    loss=float(rng.rand()))) + "\n")
        f.write(json.dumps(dict(mode="val", epoch=0, bbox_mAP=0.1)) + "\n")
    _jax_main(jtool, monkeypatch, "cal_train_time", path)
    want = capsys.readouterr().out
    got = ptool.main(["cal_train_time", path])
    assert capsys.readouterr().out == want
    times = [r["time"] for r in ptool.load_log(path) if "time" in r]
    assert got[0] == max(times) and got[1] == min(times)


def test_gen_coco_lsvr_json(shapes, tmp_path, monkeypatch):
    import gen_coco_lsvr as jtool

    from lsnet_torch.tools import gen_coco_lsvr as ptool
    _, ann, _, _ = shapes
    with open(ann) as f:
        data = json.load(f)
    data["annotations"][0].pop("segmentation")      # the box-corner path
    src = str(tmp_path / "ann.json")
    with open(src, "w") as f:
        json.dump(data, f)
    _jax_main(jtool, monkeypatch, src, str(tmp_path / "jax.json"))
    assert ptool.main([src, str(tmp_path / "port.json")]) == len(
        data["annotations"])
    with open(tmp_path / "jax.json") as f, open(tmp_path / "port.json") as g:
        want, got = json.load(f), json.load(g)
    assert got == want
    assert all(len(a["extreme_points"]) == 10 for a in got["annotations"])


def _error_analysis_inputs(ann, tmp_path):
    """Supercategories on the shapes set and detections around its boxes:
    jittered true positives, confusions within and across
    supercategories, background boxes."""
    with open(ann) as f:
        data = json.load(f)
    sup = {1: "polygon", 2: "round", 3: "polygon"}
    for c in data["categories"]:
        c["supercategory"] = sup[c["id"]]
    ann_path = str(tmp_path / "ann_sup.json")
    with open(ann_path, "w") as f:
        json.dump(data, f)
    rng = np.random.RandomState(3)
    dts = []
    for a in data["annotations"]:
        x, y, w, h = a["bbox"]
        for _ in range(3):
            j = rng.randn(4) * [2, 2, 3, 3]
            cat = a["category_id"] if rng.rand() < 0.6 else int(
                rng.randint(1, 4))
            dts.append(dict(image_id=a["image_id"], category_id=cat,
                            bbox=[float(x + j[0]), float(y + j[1]),
                                  float(max(2, w + j[2])),
                                  float(max(2, h + j[3]))],
                            score=float(rng.rand())))
    for i in range(8):
        dts.append(dict(image_id=i % 4, category_id=int(rng.randint(1, 4)),
                        bbox=[float(rng.rand() * 60), float(rng.rand() * 40),
                              8.0, 8.0], score=float(rng.rand() * 0.5)))
    res_path = str(tmp_path / "dets.json")
    with open(res_path, "w") as f:
        json.dump(dts, f)
    return ann_path, res_path


def test_coco_error_analysis_bands(shapes, tmp_path):
    import coco_error_analysis as jtool

    from lsnet_torch.tools import coco_error_analysis as ptool
    _, ann, _, _ = shapes
    ann_path, res_path = _error_analysis_inputs(ann, tmp_path)
    gts, sizes, cats = jtool._load_ann(ann_path)
    with open(res_path) as f:
        dts = json.load(f)
    quiet = lambda *a: None  # noqa: E731
    want, want_rec, want_ids = jtool.analyze_results(
        gts, dts, sizes, cats, progress=quiet)
    got, got_rec, got_ids = ptool.analyze_results(
        *ptool._load_ann(ann_path)[:1], dts, sizes, cats, progress=quiet)
    assert got_ids == want_ids
    np.testing.assert_array_equal(got_rec, want_rec)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the bands are nested: each relaxation keeps or raises precision
    assert (np.diff(got[:5, :, :, 0], axis=0) >= -1e-12).all()
    _, _, summary = ptool.analyze_files(res_path, ann_path, progress=quiet)
    assert summary["bbox"] == {
        n: float(want[i, :, :, 0].mean())
        for i, n in enumerate(jtool.BAND_NAMES)}


def test_browse_dataset_pixels(shapes, tmp_path, monkeypatch, capsys):
    import browse_dataset as jtool
    from PIL import Image

    from lsnet_torch.tools import browse_dataset as ptool
    _, _, _, cfg = shapes
    _jax_main(jtool, monkeypatch, cfg, "--output-dir", str(tmp_path / "j"),
              "--number", "2")
    got = ptool.main([cfg, "--output-dir", str(tmp_path / "p"),
                      "--number", "2"])
    assert len(got) == 2
    for path in got:
        want = tmp_path / "j" / os.path.basename(path)
        a = np.asarray(Image.open(path))
        np.testing.assert_array_equal(a, np.asarray(Image.open(want)))
        assert a.std() > 0


def _jax_products(cfg, canvas):
    """FLOPs of every conv and dot of the JAX forward's jaxpr."""
    from lsnet_tpu.models import build_detector
    model, _ = build_detector(cfg.model.to_dict())
    images = jnp.zeros((1, *canvas, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               images))
    n_params = sum(int(np.prod(p.shape))
                   for p in jax.tree.leaves(shapes["params"]))
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    total = 0

    def walk(jaxpr):
        nonlocal total
        for e in jaxpr.eqns:
            out = e.outvars[0].aval
            if e.primitive.name == "dot_general":
                (lc, _), _ = e.params["dimension_numbers"]
                a = e.invars[0].aval
                total += 2 * int(np.prod([a.shape[i] for i in lc])) * \
                    int(np.prod(out.shape))
            elif e.primitive.name == "conv_general_dilated":
                rhs = e.invars[1].aval
                spec = e.params["dimension_numbers"].rhs_spec
                macs = int(np.prod([rhs.shape[i] for i in spec[1:]]))
                total += 2 * macs * int(np.prod(out.shape))
            for p in e.params.values():
                for q in p if isinstance(p, (list, tuple)) else [p]:
                    inner = getattr(q, "jaxpr", q)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jax.make_jaxpr(model.apply)(zeros, images).jaxpr)
    return n_params, total


def test_get_flops_counts(shapes, capsys):
    from lsnet_torch.tools import get_flops as ptool
    from lsnet_torch.utils.config import Config
    root, ann, img, _ = shapes
    cfg_path = str(root / "r50dcn.py")
    with open(cfg_path, "w") as f:
        f.write(f"_base_ = {os.path.join(REPO, 'configs', 'lsnet', 'lsnet_bbox_r50_fpn_1x_coco.py')!r}\n"  # noqa: E501
                "model = dict(backbone=dict(stage_with_dcn=(False, True, "
                "True, True), dcn=dict(type='DCNv2', deformable_groups=1)),"
                " neck=dict(out_channels=32, norm_cfg=dict(type='GN', "
                "num_groups=8)), bbox_head=dict(in_channels=32, "
                "feat_channels=32, point_feat_channels=32, stacked_convs=1,"
                " num_classes=3, norm_cfg=dict(type='GN', num_groups=8)))\n")
    cfg = Config.fromfile(cfg_path)
    canvas = (128, 192)
    n_params, flops = ptool.main([cfg_path, "--shape", *map(str, canvas),
                                  "--device", "cpu"])
    assert "GFLOPs" in capsys.readouterr().out
    want_params, want_flops = _jax_products(cfg, canvas)
    assert n_params == want_params
    assert abs(flops - want_flops) <= 1e-9 * want_flops, (flops, want_flops)
    # the contractions are counted by their products, not by what the
    # counter saw: the plain einsum's count on the CPU is the same number
    from torch.utils.flop_counter import FlopCounterMode

    from lsnet_torch.models import build_detector
    model = build_detector(cfg.model.to_dict()).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros((1, *canvas, 3)))
    assert counter.get_total_flops() == flops


def _narrow_checkpoint(cfg_path, out_dir):
    """A narrow checkpoint with non-trivial FrozenBatchNorm statistics."""
    from lsnet_torch.apis import random_weights_
    from lsnet_torch.models import build_detector
    from lsnet_torch.train.checkpoint import save_checkpoint, train_meta
    from lsnet_torch.train.optim import build_optimizer
    from lsnet_torch.utils.config import Config
    model = build_detector(Config.fromfile(cfg_path).model.to_dict())
    random_weights_(model, 1)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for key, v in model.state_dict().items():
            if key.endswith(".mean"):
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
            elif key.endswith(".var"):
                v.copy_(0.5 + torch.rand(v.shape, generator=gen))
    opt, _ = build_optimizer(model.parameters(), 0.01, 4, [8])
    opt.step([torch.randn_like(p) for p in opt.params])
    return save_checkpoint(out_dir, model, opt, 7, train_meta(None, "5"))


def _detections(cfg_path, ckpt, image):
    from lsnet_torch.apis import inference_detector, init_detector
    bundle = init_detector(cfg_path, ckpt, device="cpu")
    return inference_detector(bundle, image)


@pytest.fixture(scope="module")
def checkpoint(shapes):
    root, _, img, cfg = shapes
    ckpt = _narrow_checkpoint(cfg, str(root / "ckpts"))
    from PIL import Image
    image = np.asarray(Image.open(os.path.join(img, "0001.png")))
    return cfg, ckpt, image, _detections(cfg, ckpt, image)


def _assert_same_detections(got, want, atol):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=0, atol=atol, err_msg=key)
    assert len(want["scores"])


def test_fuse_conv_bn_round_trip(checkpoint, shapes, tmp_path, capsys):
    """The tool fuses the pairs JAX's ``fuse_conv_bn`` fuses, to the same
    numbers, and the fused checkpoint loads strictly and detects as the
    unfused one (f32; 1e-4 in pixels and scores: the fold moves each
    weight by an ULP or so)."""
    from lsnet_tpu.models import build_detector as jbuild
    from lsnet_tpu.train.fuse import fuse_conv_bn as jfuse
    from lsnet_torch.models import build_detector
    from lsnet_torch.tools import fuse_conv_bn as ptool
    from lsnet_torch.train.checkpoint import load_checkpoint
    from lsnet_torch.train.fuse import fuse_conv_bn, fuse_state_dict
    from lsnet_torch.utils.config import Config
    from lsnet_torch.weights import load_jax_variables
    cfg, ckpt, image, want = checkpoint
    out = str(tmp_path / "fused.pt")
    names = ptool.main([ckpt, out])
    text = capsys.readouterr().out
    assert text.startswith(f"fused {len(names)} conv+bn pairs")
    assert names[0] in text
    before, after = load_checkpoint(ckpt), load_checkpoint(out)
    assert after["meta"] == before["meta"] and \
        after["step"] == before["step"]
    # the API on the model: the same pairs and numbers as the tool
    model = build_detector(Config.fromfile(cfg).model.to_dict())
    model.load_state_dict(before["model"])
    assert fuse_conv_bn(model) == names
    for k, v in model.state_dict().items():
        assert torch.equal(after["model"][k], v), k
    # the JAX fuse on JAX variables of the same model
    jmodel, _ = jbuild(Config.fromfile(cfg).model.to_dict())
    v = mint_variables(jmodel, jnp.zeros((1, 64, 96, 3)), seed=4)
    jfused, jnames = jfuse(v)
    assert jnames == names
    unfused = build_detector(Config.fromfile(cfg).model.to_dict())
    load_jax_variables(unfused, jax.tree.map(np.asarray, v))
    ported, pnames = fuse_state_dict(unfused.state_dict())
    assert pnames == names
    fused = build_detector(Config.fromfile(cfg).model.to_dict())
    load_jax_variables(fused, jax.tree.map(np.asarray, jfused))
    for k, want_v in fused.state_dict().items():
        np.testing.assert_allclose(ported[k].numpy(), want_v.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    _assert_same_detections(_detections(cfg, out, image), want, 1e-4)


def test_publish_model_round_trip(checkpoint, tmp_path, capsys):
    from lsnet_torch.tools import publish_model as ptool
    from lsnet_torch.tools import test as ptest
    from lsnet_torch.train.checkpoint import load_checkpoint
    cfg, ckpt, image, want = checkpoint
    final = ptool.main([ckpt, str(tmp_path / "lsnet_narrow.pth")])
    assert capsys.readouterr().out.strip() == f"published: {final}"
    with open(final, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    assert final == str(tmp_path / f"lsnet_narrow-{sha[:8]}.pth")
    slim, full = load_checkpoint(final), load_checkpoint(ckpt)
    assert set(slim) == {"step", "model", "meta"}
    assert slim["meta"] == full["meta"] == {
        "dcn_sampling_train": "bilinear", "refine_taps_train": "5"}
    for k, v in full["model"].items():
        assert torch.equal(slim["model"][k], v)
    _assert_same_detections(_detections(cfg, final, image), want, 0.0)
    assert ptest.main([cfg, final, "--max-images", "2", "--device",
                       "cpu"]) == ptest.main([cfg, ckpt, "--max-images",
                                              "2", "--device", "cpu"])
