"""The plain reference against lsnet_torch on the CPU, at narrow widths
(the backbones whole): the forward at both samplings, decode + NMS, and
one float32 train step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench import harness, weights
from h100bench.entries.train import Train
from h100bench.reference import decode as ref_decode
from h100bench.reference import model as ref_model

CONFIGS = ("flagship_r50_cfg", "x101_flagship_cfg")


def narrow(name):
    from lsnet_torch import configs
    return getattr(configs, name)(feat=32, stacked=1)


def pair(name, seed=11):
    from lsnet_torch.models import build_detector
    cfg = narrow(name)
    ref = ref_model.build(cfg)
    w = weights.mint(ref, seed, "cpu")
    ref.load_state_dict(w, strict=True)
    prog = build_detector(cfg)
    prog.load_state_dict(w, strict=True)
    return cfg, prog.eval(), ref.eval()


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("mode", ("inference", "train"))
def test_forward(name, mode):
    from lsnet_torch.ops import flat_deform
    _, prog, ref = pair(name)
    smp, rsmp = ((flat_deform.INFERENCE_SAMPLING, ref_model.INFERENCE)
                 if mode == "inference"
                 else (flat_deform.TRAIN_SAMPLING, ref_model.TRAIN))
    img = torch.randn(2, 96, 128, 3, generator=torch.Generator()
                      .manual_seed(3))
    with torch.no_grad():
        a, b = prog(img, smp), ref(img, rsmp)
    assert sorted(a) == sorted(b)
    for k in b:
        for x, y in zip(a[k], b[k]):
            assert x.shape == y.shape
            assert float((x - y).norm() / y.norm()) < 1e-4, k


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_nms(name):
    from lsnet_torch.core.decode import TestConfig, lsnet_decode
    from lsnet_torch.ops import flat_deform
    _, prog, _ = pair(name)
    img = torch.randn(2, 128, 192, 3, generator=torch.Generator()
                      .manual_seed(4))
    shapes = torch.tensor([[128, 170], [120, 192]], dtype=torch.int32)
    sf = torch.tensor([[1.25] * 4, [0.8] * 4])
    with torch.no_grad():
        outs = prog(img, flat_deform.INFERENCE_SAMPLING)
    cfg = TestConfig(image_shape=(128, 192), num_classes=80, nms_pre=300)
    det = lsnet_decode(outs, shapes, sf, cfg)
    for i in range(2):
        want = ref_decode.detect_one(
            [m[i] for m in outs["cls"]], [m[i] for m in outs["bbox_refine"]],
            shapes[i].tolist(), sf[i].tolist(), strides=cfg.point_strides,
            nms_pre=300, score_thr=0.05, iou_thr=0.6, max_per_img=100)
        v = det.valid[i].numpy()
        assert v.sum() == len(want["scores"]) > 10
        np.testing.assert_array_equal(det.labels[i].numpy()[v],
                                      want["labels"])
        np.testing.assert_allclose(det.bboxes[i].numpy()[v], want["boxes"],
                                   atol=1e-4)
        np.testing.assert_allclose(det.scores[i].numpy()[v],
                                   want["scores"], atol=1e-6)
        np.testing.assert_allclose(det.landmarks[i].numpy()[v],
                                   want["landmarks"], atol=1e-4)


def tiny_train(name):
    mix = harness.load_json(harness.HERE / "traffic" / "train_b8.json")
    # a canvas whose coarsest level has 6 cells: GroupNorm over fewer
    # values turns rounding into gaps of whole percents
    mix.update(batch=2, canvas=[256, 320], img_scale=[320, 256],
               pool_batches=4, orig_long=[300, 320], mixed_precision=False)
    return {"config": {"model": narrow(name)}, "mix": mix}


@pytest.mark.parametrize("name", CONFIGS)
def test_train_steps(name):
    """Three f32 steps of the program and of the reference from the same
    weights on the same batches: losses, the gradient norm and each
    leaf's change after three steps. One DCN layer agrees within 1e-6;
    through 30 of them a rounding apart moves some samples across a pixel
    line, where the tent's slope turns, so the offset convolutions'
    gradients part by up to a percent."""
    tr = Train(tiny_train(name), 5, "cpu")
    tr.setup()
    ref = tr.reference_steps()
    # step 1 from equal weights; steps 2 and 3 after updates that round
    # apart, where an assignment can flip
    for step, (p, r) in enumerate(zip(tr.prog["loss"], ref["loss"])):
        for k in p:
            assert abs(p[k] - r[k]) <= (1e-3 if step == 0 else 2e-2) \
                * abs(r[k]), (step, k)
    assert abs(tr.prog["grad_norm"] - ref["grad_norm"]) \
        <= 2e-3 * ref["grad_norm"]
    at = {n: i for i, n in enumerate(ref["names"])}
    med = float(np.median(ref["grad_leaf"]))
    medc = float(np.median(ref["change_leaf"]))
    for n, c in zip(tr.prog["names"], tr.prog["change_leaf"]):
        r = ref["change_leaf"][at[n]]
        if ref["grad_leaf"][at[n]] >= 1e-3 * med:
            assert abs(c - r) <= 0.1 * max(r, medc), n


@pytest.mark.parametrize("name", CONFIGS)
def test_first_gradient_leaves(name):
    """The first f32 step's gradient, leaf by leaf, as the program's
    optimizer got it (its momentum after one step is the clipped gradient
    plus the weight decay's term), against the reference's."""
    import inspect
    files = tiny_train(name)
    files["mix"]["checked_steps"] = 1
    tr = Train(files, 5, "cpu")
    tr.setup()
    optimizer = inspect.getclosurevars(tr.step).nonlocals["optimizer"]
    wd = files["mix"]["optimizer"]["weight_decay"]
    ref = tr.reference_steps()
    start = weights.mint(ref_model.build(files["config"]["model"]), 5,
                         "cpu")
    bufs = optimizer.state_dict()["momentum"]
    at = {n: i for i, n in enumerate(ref["names"])}
    med = float(np.median(ref["grad_leaf"]))
    for n, buf in zip(tr.prog["names"], bufs):
        g = float(torch.linalg.vector_norm(buf - wd * start[n]))
        r = ref["grad_leaf"][at[n]]
        assert abs(g - r) <= 2e-2 * max(r, med), n
