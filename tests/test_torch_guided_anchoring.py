"""Guided Anchoring in the port against the JAX package, on the CPU: the
GA-RetinaNet and GA-RPN heads, their losses and decodes, and the
standalone ``RPN`` detector type.

Both heads adapt their features with a mask-free multi-level deformable
conv (K1's job; here its plain version) whose offsets come from a 1x1
conv on the detached shape prediction. Inputs are made with numpy from
seeds; the helpers and the tolerances are those of
``test_torch_dense_heads.py``:

* each head from the shipped file's head config at a narrow width (two
  stacked convs, 32 channels, 3 classes; GA-RPN one objectness class) on
  FPN-level features of a 64x96 canvas at the file's strides, from the
  JAX training init (every guided-anchor offset exactly 0, the case of
  the tent rule's corner) and from minted weights, with GT and with none:
  maps 1e-4 of max(1, max|ref|), loss terms 1e-4 relative, every
  parameter's gradient within 1e-4 of its largest entry or 1e-5
  absolute;
* each decode on random head-shaped outputs: the valid mask and labels
  equal, boxes 1e-3 absolute, scores 1e-5;
* the offset gradient stops at the ``adaption_offset*`` convs: a loss of
  the adapted maps alone leaves ``conv_shape`` without a gradient;
* the files' settings against the JAX runner's: equal but for the GA
  heads' strides, which the port reads from ``square_anchor_generator``
  (JAX's default (8, ..., 128) does not match GA-RPN's FPN levels at 4,
  ..., 64, so its guided anchors and its maps differ in count);
* the runner: a narrow step and an evaluation of each file, ``tools.test``
  on GA-RPN's checkpoint, the image-level API on GA-RetinaNet, and
  ``init_detector``'s refusal of GA-RPN.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.models import build_head as j_build_head
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch import apis
from lsnet_torch.core import dense_loss as pdl
from lsnet_torch.models import build_detector, build_head
from lsnet_torch.models.init import init_weights_
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING
from lsnet_torch.tools import test as test_tool
from lsnet_torch.train import loop as ploop
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import (from_jax_variables, load_jax_variables,
                                 to_jax_variables)
from test_torch_dense_heads import (C, REPO, check_case,
                                    check_decode, head_case, levels_of,
                                    narrow_head_cfg, narrow_file, run_file,
                                    shapes_set)  # noqa: F401
from torch_port_util import level_feats, mint_variables, t

torch.set_num_threads(1)

FILES = {"ga_retina": "guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py",
         "ga_rpn": "guided_anchoring/ga_rpn_r50_fpn_1x_coco.py"}
OUT_KEYS = ("cls", "reg", "loc", "shape")
TERMS = {"ga_retina": {"loss_loc", "loss_shape", "loss_cls", "loss_bbox"},
         "ga_rpn": {"loss_anchor_loc", "loss_anchor_shape", "loss_rpn_cls",
                    "loss_rpn_bbox"}}
CHANNELS = {"ga_retina": {"cls": C, "reg": 4, "loc": 1, "shape": 2},
            "ga_rpn": {"cls": 1, "reg": 4, "loc": 1, "shape": 2}}
GA_STRIDES = {"ga_retina": (8, 16, 32, 64, 128), "ga_rpn": (4, 8, 16, 32, 64)}


def file_cfg(kind, package=Config):
    return package.fromfile(os.path.join(REPO, "configs", FILES[kind]))


@pytest.fixture(scope="module")
def cases():
    with pytest.MonkeyPatch.context() as mp:
        # the JAX package's process-wide sampling state, pinned
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        return {kind: head_case(kind, lambda pkg, k=kind: file_cfg(k, pkg),
                                CHANNELS[kind], seed=7 + i)
                for i, kind in enumerate(FILES)}


@pytest.mark.parametrize("kind", sorted(FILES))
def test_head_loss_and_gradients_match_jax(cases, kind):
    """From the JAX training init (zero adaption offsets) and from minted
    weights, with GT and with none."""
    jres, pres, pcfg, *_ = cases[kind]
    assert pcfg.strides == GA_STRIDES[kind]
    check_case(jres, pres, OUT_KEYS, TERMS[kind])
    for key, res in jres.items():
        grads = res["grads"]
        offsets = [k for k in grads if k.startswith("adaption_offset")]
        assert len(offsets) == (2 if kind == "ga_retina" else 1)
        if key[1] == "gt":
            # K1's offset and weight gradients, from the zero offsets of
            # the training init too
            for k in offsets:
                assert np.abs(grads[k]["kernel"]).max() > 0, (key, k)
            for k in ("adaption_weight", "adaption_weight_cls",
                      "adaption_weight_reg"):
                if k in grads:
                    assert np.abs(grads[k]).max() > 0, (key, k)
    assert jres["init", "gt"]["terms"][
        "loss_loc" if kind == "ga_retina" else "loss_anchor_loc"] > 0


@pytest.mark.parametrize("kind", sorted(FILES))
def test_decode_matches_jax(cases, kind):
    jres, _, pcfg, tcfg, rand = cases[kind]
    check_decode(kind, jres, rand, pcfg, tcfg)


@pytest.mark.parametrize("kind", sorted(FILES))
def test_offset_gradient_stops_at_the_adaption(kind):
    """A loss of the adapted cls / reg maps alone: the ``adaption_offset*``
    convs and the adaption weights take a gradient (through the
    deformable conv's offsets and weight), ``conv_shape`` and
    ``conv_loc`` none (the offsets read the detached shape)."""
    head = build_head(narrow_head_cfg(file_cfg(kind)))
    init_weights_(head, torch.Generator().manual_seed(0))
    with torch.no_grad():                  # offsets away from the lattice
        for name, p in head.named_parameters():
            if name.startswith("adaption_offset"):
                p.normal_(0.0, 0.3, generator=torch.Generator()
                          .manual_seed(1))
    feats = level_feats(levels_of(GA_STRIDES[kind]), 32, seed=2)
    outs = head([t(f).permute(0, 3, 1, 2) for f in feats], TRAIN_SAMPLING)
    loss = sum((m ** 2).sum() for k in ("cls", "reg") for m in outs[k])
    loss.backward()
    grads = {n: p.grad for n, p in head.named_parameters()}
    for n in ("conv_shape.weight", "conv_shape.bias", "conv_loc.weight"):
        assert grads[n] is None, n
    for n, g in grads.items():
        if n.startswith("adaption"):
            assert g is not None and g.abs().max() > 0, n


def test_weights_bridge_carries_the_adaption_weights():
    """``adaption_weight`` (GA-RPN) and ``adaption_weight_cls`` /
    ``_reg`` (GA-RetinaNet), HWIO, in both directions."""
    for kind, names in (("ga_rpn", ["adaption_weight"]),
                        ("ga_retina", ["adaption_weight_cls",
                                       "adaption_weight_reg"])):
        jhead, _ = j_build_head(dict(narrow_head_cfg(file_cfg(kind,
                                                              JConfig))))
        feats = [jnp.zeros((1, h, w, 32))
                 for h, w in levels_of(GA_STRIDES[kind])]
        v = mint_variables(jhead, feats, seed=3)
        head = build_head(narrow_head_cfg(file_cfg(kind)))
        load_jax_variables(head, v)
        sd = from_jax_variables({"params": {"head": v["params"]}})
        for n in names:
            assert v["params"][n].shape == (3, 3, 32, 32)
            np.testing.assert_array_equal(getattr(head, n).detach().numpy(),
                                          v["params"][n])
            assert f"head.{n}" in sd
        back = to_jax_variables(head)["params"]
        assert jax.tree.structure(back) == jax.tree.structure(v["params"])
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v["params"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", sorted(FILES))
def test_training_init_matches_the_jax_init(kind):
    """The port's ``init_weights_`` against JAX's ``module.init``: the
    offset convs all zeros, the biases equal (the focal prior on
    ``conv_loc`` and GA-RetinaNet's ``ga_cls``, GA-RPN's ``ga_cls`` 0),
    the kernels and the adaption weights N(0, 0.01) within 15 %."""
    jhead, _ = j_build_head(dict(narrow_head_cfg(file_cfg(kind, JConfig),
                                                 64)))
    feats = [jnp.zeros((1, h, w, 64)) for h, w in levels_of(
        GA_STRIDES[kind])]
    want = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(0),
                                               feats))["params"]
    head = build_head(narrow_head_cfg(file_cfg(kind), 64))
    init_weights_(head, torch.Generator().manual_seed(0))
    got = to_jax_variables(head)["params"]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w_ in flat_w.items():
        name = jax.tree_util.keystr(path)
        g = flat_g[path]
        if "adaption_offset" in name or not (
                name.endswith("['kernel']") or "adaption_weight" in name):
            np.testing.assert_array_equal(g, w_)
        else:
            assert abs(g.std() / 0.01 - 1) < 0.15, name
    assert np.allclose(want["conv_loc"]["bias"], -np.log(99.0))
    assert np.allclose(want["ga_cls"]["bias"],
                       -np.log(99.0) if kind == "ga_retina" else 0.0)


@pytest.mark.parametrize("kind", sorted(FILES))
def test_file_settings_match_the_jax_runner(kind):
    """``dense_cfg_from`` and ``test_cfg_from`` against the JAX runner's,
    field by field, but for the strides: the port reads the
    ``square_anchor_generator``'s, JAX its default, which is GA-RPN's
    FPN levels (start_level 0) only for GA-RetinaNet."""
    pc, jc = file_cfg(kind), file_cfg(kind, JConfig)
    got = ploop.dense_cfg_from(pc, (800, 1344))
    want = jloop.dense_cfg_from(jc, (800, 1344))
    for f in dataclasses.fields(got):
        g, w_ = getattr(got, f.name), getattr(want, f.name)
        if f.name == "anchor":
            g, w_ = dataclasses.asdict(g), dataclasses.asdict(w_)
        if f.name == "strides":
            assert g == GA_STRIDES[kind]
            assert (g == w_) == (kind == "ga_retina")
            continue
        assert g == w_, f.name
    wt = jloop.test_cfg_from(jc, (800, 1344))
    gt_ = ploop.test_cfg_from(pc, (800, 1344))
    for f in dataclasses.fields(gt_):
        assert getattr(gt_, f.name) == getattr(wt, f.name), f.name
    if kind == "ga_rpn":
        assert (gt_.max_per_img, gt_.nms_pre, gt_.score_thr, gt_.num_classes
                ) == (1000, 2000, 0.0, 1)
        # the file's FPN levels: the strides the port reads
        with torch.device("meta"):
            model = build_detector(pc.model.to_dict())
        feats = model.neck([torch.zeros(1, c, 800 // s, 1344 // s)
                            for c, s in zip((256, 512, 1024, 2048),
                                            (4, 8, 16, 32))])
        assert [f.shape[-2] for f in feats] == [200, 100, 50, 25, 13]
        assert [-(-800 // s) for s in got.strides] == [200, 100, 50, 25, 13]


def test_rpn_detector_type():
    """``RPN`` builds from ``rpn_head`` at full width on the ``meta``
    device, its head GARPNHead without classes; the runner's head
    config, pipeline and checks read it there."""
    cfg = file_cfg("ga_rpn")
    with torch.device("meta"):
        model = build_detector(cfg.model.to_dict())
    assert type(model.head).__name__ == "GARPNHead"
    assert model.head.adaption_weight.shape == (3, 3, 256, 256)
    ploop.check_runnable(cfg)
    assert ploop.head_cfg(cfg).type == "GARPNHead"
    assert ploop.head_num_vectors(cfg) == 4
    assert ploop.data_task(cfg, "train") == "bbox"
    lcfg = ploop.train_loss_cfg(cfg, (800, 1344))
    assert isinstance(lcfg, pdl.DenseLossConfig) and lcfg.head == "ga_rpn"
    with pytest.raises(NotImplementedError, match="tools.test"):
        apis.init_detector(cfg, device="cpu")


def test_runner_trains_and_tests_ga_rpn(shapes_set, tmp_path):
    """GA-RPN through ``train_detector`` / ``evaluate_detector`` (label-0
    proposals scored by bbox) and ``tools.test`` on its checkpoint: the
    same metrics as the run's own evaluation."""
    path = os.path.join(REPO, "configs", FILES["ga_rpn"])
    work = str(tmp_path / "work")
    cfg, model = run_file(path, shapes_set, work, TERMS["ga_rpn"],
                          checkpoint_config=dict(interval=1))
    assert type(model.head).__name__ == "GARPNHead"
    (log,) = glob.glob(os.path.join(work, "*.log.json"))
    with open(log) as f:
        val = [json.loads(line) for line in f][-1]
    ckpt = os.path.join(work, "ckpts", "step_1.pt")
    opts = [f"{k}={v!r}" for k, v in narrow_options_for(shapes_set).items()]
    metrics = test_tool.main([path, ckpt, "--eval", "bbox", "--device",
                              "cpu", "--max-images", "2", "--options",
                              *opts])
    for k, v in metrics.items():
        assert abs(v - val[k]) <= 1e-6, k


def narrow_options_for(root):
    """The overrides of ``narrow_file`` as ``--options`` entries."""
    from test_torch_dense_heads import narrow_options
    opts = narrow_options(root)
    opts.update({"model.rpn_head.in_channels": 64,
                 "model.rpn_head.feat_channels": 64})
    return opts


def test_runner_and_api_ga_retina(shapes_set, tmp_path):
    """GA-RetinaNet through the runner, then ``init_detector`` /
    ``inference_detector`` on its narrow file (seeded weights)."""
    path = os.path.join(REPO, "configs", FILES["ga_retina"])
    run_file(path, shapes_set, str(tmp_path / "work"), TERMS["ga_retina"])
    cfg = narrow_file(path, shapes_set)
    bundle = apis.init_detector(cfg, device="cpu")
    apis.random_weights_(bundle.model, 0)
    img = (np.random.RandomState(0).rand(48, 80, 3) * 255).astype(np.uint8)
    res = apis.inference_detector(bundle, img)
    assert len(res["scores"]) > 0 and not res["landmarks"].any()
    assert (res["labels"] < C).all()


def _covering_batch(pts, hw):
    """Two images of GTs centred on cell origins at the level their size
    picks (scale 8, 16, 32 px: levels 0, 1, 2), so each centre region
    (shrunk to 0.2) holds a cell; the second image's last slot is
    padding."""
    boxes = np.zeros((2, 3, 4), np.float32)
    for b in range(2):
        for lvl, (s, size) in enumerate(((8, 9.0), (16, 17.0),
                                          (32, 31.0))):
            cells = pts[pts[:, 2] == s]
            x, y = cells[(3 * b + 2 * lvl + 1) % len(cells), :2]
            boxes[b, lvl] = [x - size / 2, y - size / 2 - 1,
                             x + size / 2, y + size / 2 + 1]
    valid = np.array([[True] * 3, [True, True, False]])
    shape = np.array([hw] * 2, np.int32)
    return dict(gt_bboxes=boxes, gt_labels=np.array([[0, 1, 2], [2, 1, 0]],
                                                     np.int32),
                gt_valid=valid, img_shape=shape, pad_shape=shape.copy())


def test_ga_retina_shape_term_on_covered_centres():
    """ROADMAP Queue 3: GA-RetinaNet's ``loss_shape`` read 0.0 on every
    batch seen so far, its GTs too small for their centre regions to
    hold a cell. Here each GT's region holds one: JAX's term
    (``lsnet_tpu/core/dense_loss.py`` ``ga_retina_loss``) is non-zero,
    and the port's term, the whole loss and the gradient of the term
    with respect to every level's shape map equal JAX's (1e-5 relative,
    gradients 1e-5 of their largest entry)."""
    from lsnet_tpu.core import dense_loss as jdl
    from test_torch_dense_heads import HW, jax_loss_cfg, random_outputs

    pcfg = dataclasses.replace(ploop.dense_cfg_from(file_cfg("ga_retina"),
                                                    HW), num_classes=C)
    jcfg = jax_loss_cfg(pcfg)
    levels = levels_of(pcfg.strides)
    outs = random_outputs("ga_retina", levels, CHANNELS["ga_retina"], 23)
    pts = pdl._level_points(pcfg, "cpu").numpy()
    batch = _covering_batch(pts, HW)

    def jf(shape):
        jouts = {k: [jnp.asarray(x) for x in v] for k, v in outs.items()}
        jouts["shape"] = shape
        total, terms = jdl.dense_loss(jouts, {k: jnp.asarray(v) for k, v in
                                              batch.items()}, jcfg)
        return terms["loss_shape"], (total, terms)

    (want, (jtotal, jterms)), jgrad = jax.value_and_grad(jf, has_aux=True)(
        [jnp.asarray(x) for x in outs["shape"]])
    assert float(want) > 0.01

    pouts = {k: [t(x) for x in v] for k, v in outs.items()}
    for m in pouts["shape"]:
        m.requires_grad_(True)
    total, terms = pdl.dense_loss(pouts, {k: t(v) for k, v in
                                          batch.items()}, pcfg)
    got = terms["loss_shape"]
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * float(want)
    assert abs(float(total.detach()) - float(jtotal)) <= \
        1e-5 * abs(float(jtotal))
    for k, v in jterms.items():
        assert abs(float(terms[k].detach()) - float(v)) <= 1e-5 * max(1e-6,
                                                             abs(float(v)))
    grads = torch.autograd.grad(got, pouts["shape"])
    top = max(float(np.abs(np.asarray(g)).max()) for g in jgrad)
    assert top > 0
    for g, w in zip(grads, jgrad):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * top)
