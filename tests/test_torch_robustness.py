"""The corruption-robustness benchmark in the port against the JAX
package: every corruption byte for byte, the val dataset's corruption
hook, ``robustness_eval``'s P / mPC / rPC, and the json layout of
``lsnet_torch.tools.test_robustness`` on a narrow model on the CPU.

The images are seeded numpy or procedural PNGs; the corruptions draw
their noise from a RandomState keyed on the image's bytes, so both
packages must give equal bytes (no tolerance).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from lsnet_tpu.data import coco as jcoco
from lsnet_tpu.data import corruptions as jcor
from lsnet_torch.data import coco as pcoco
from lsnet_torch.data import corruptions as pcor
from lsnet_torch.tools.shapes import make_shapes_coco
from torch_port_util import write_narrow_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    img[10:30, 12:40] = [200, 80, 40]         # a flat patch for the blurs
    return img


def test_corruption_sets_equal_jax():
    assert pcor.BENCHMARK == jcor.BENCHMARK
    assert pcor.HOLDOUT == jcor.HOLDOUT
    assert pcor.UNAVAILABLE == jcor.UNAVAILABLE
    assert list(pcor.CORRUPTIONS) == list(jcor.CORRUPTIONS)


@pytest.mark.parametrize("severity", [1, 5])
@pytest.mark.parametrize("name", sorted(jcor.CORRUPTIONS))
def test_corruption_bytes_equal_jax(image, name, severity):
    got = pcor.corrupt(image, name, severity)
    want = jcor.corrupt(image, name, severity)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, image)


@pytest.fixture(scope="module")
def shapes(tmp_path_factory):
    root = tmp_path_factory.mktemp("robust")
    ann, img = make_shapes_coco(str(root / "data"), 4, seed=5, hw=(64, 96))
    return root, ann, img


def test_val_sample_with_a_corruption_equals_jax(shapes):
    _, ann, img = shapes
    kw = dict(ann_file=ann, img_prefix=img, task="bbox", num_vectors=4,
              img_scale=(96, 64), filter_empty=False,
              corruption=("fog", 3))
    got = pcoco.CocoDataset(pcoco.DatasetConfig(**kw),
                            test_mode=True).get_sample(1)
    want = jcoco.CocoDataset(jcoco.DatasetConfig(**kw),
                             test_mode=True).get_sample(1)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    clean = pcoco.CocoDataset(pcoco.DatasetConfig(
        **{**kw, "corruption": None}), test_mode=True).get_sample(1)
    assert not np.array_equal(clean["image"], got["image"])


def _robust_json(path):
    rng = np.random.RandomState(1)
    res = {}
    for c in ["gaussian_noise", "fog", "speckle_noise"]:
        res[c] = {str(s): {m: float(rng.rand()) for m in
                           ("bbox_mAP", "bbox_mAP_50", "bbox_mAP_75",
                            "bbox_mAP_s", "bbox_mAP_m", "bbox_mAP_l")}
                  for s in range(1, 4)}
        res[c]["0"] = {"bbox_mAP": 0.5, "bbox_mAP_50": 0.7,
                       "bbox_mAP_75": 0.4, "bbox_mAP_s": 0.2,
                       "bbox_mAP_m": 0.3, "bbox_mAP_l": 0.6}
    with open(path, "w") as f:
        json.dump(res, f)
    return path


@pytest.mark.parametrize("aggregate", ["benchmark", "all"])
def test_robustness_eval_equals_jax(tmp_path, aggregate):
    import robustness_eval as jre

    from lsnet_torch.tools import robustness_eval as pre
    path = _robust_json(str(tmp_path / "r.json"))
    got_lines, want_lines = [], []
    got = pre.get_results(path, prints=("P", "mPC", "rPC"),
                          aggregate=aggregate, echo=got_lines.append)
    want = jre.get_results(path, prints=("P", "mPC", "rPC"),
                           aggregate=aggregate, echo=want_lines.append)
    assert got == want
    assert got_lines == want_lines
    assert pre.DEFAULT_METRICS == jre.DEFAULT_METRICS


def test_corruption_groups_equal_jax():
    import test_robustness as jtr

    from lsnet_torch.tools import test_robustness as ptr
    for spec in (["benchmark"], ["holdout"], ["all"], ["noise"], ["blur"],
                 ["weather"], ["digital"], ["fog", "contrast"]):
        assert ptr.pick_corruptions(spec) == jtr.pick_corruptions(spec)
    with pytest.raises(SystemExit):
        ptr.pick_corruptions(["snowy"])


def test_test_robustness_json_on_a_narrow_model(shapes, monkeypatch):
    """The port's tool on a narrow checkpoint, on the CPU: the clean entry
    is ``tools.test``'s metrics and is stored under every corruption; the
    json is the one the JAX tool writes when its evaluation returns the
    same metrics (its model building and evaluation replaced by the
    port's results)."""
    import test_robustness as jtr

    from lsnet_torch.apis import random_weights_
    from lsnet_torch.models import build_detector
    from lsnet_torch.tools import test as ptest
    from lsnet_torch.tools import test_robustness as ptr
    from lsnet_torch.train.checkpoint import save_checkpoint
    from lsnet_torch.train.optim import build_optimizer
    from lsnet_torch.utils.config import Config
    root, ann, img = shapes
    cfg_path = write_narrow_config(str(root / "narrow.py"), ann, img)
    model = build_detector(Config.fromfile(cfg_path).model.to_dict())
    random_weights_(model, 0)
    opt, _ = build_optimizer(model.parameters(), 0.01, 4, [8])
    ckpt = save_checkpoint(str(root / "ckpts"), model, opt, 3)
    out = str(root / "port.json")
    argv = [cfg_path, ckpt, "--corruptions", "gaussian_noise", "fog",
            "--severities", "0", "2", "--max-images", "3",
            "--device", "cpu"]
    got = ptr.main(argv[:2] + ["--out", out] + argv[2:])
    clean = ptest.main([cfg_path, ckpt, "--max-images", "3",
                        "--device", "cpu"])
    with open(out) as f:
        port = json.load(f)
    assert list(port) == ["gaussian_noise", "fog"]
    for c in port:
        assert list(port[c]) == ["0", "2"]
        assert port[c]["0"] == clean
    assert got["fog"][0] == clean

    # the JAX tool over the port's numbers: the same file, key for key
    import lsnet_tpu.models as jmodels
    import lsnet_tpu.train.checkpoint as jckpt
    import lsnet_tpu.train.loop as jloop

    def evaluate(cfg, *a, **k):
        spec = cfg.data.val.get("corruption")
        return got[spec[0]][spec[1]] if spec else clean

    monkeypatch.setattr(jmodels, "build_detector", lambda c: (None, None))
    monkeypatch.setattr(jckpt, "init_variables_shell", lambda m, c: None)
    monkeypatch.setattr(jckpt, "restore_eval_state", lambda p, v: None)
    monkeypatch.setattr(jloop, "evaluate_detector", evaluate)
    jout = str(root / "jax.json")
    monkeypatch.setattr(sys, "argv", ["test_robustness.py"] + argv[:2]
                        + ["--out", jout] + argv[2:-2])
    jtr.main()
    with open(jout) as f:
        assert f.read() == open(out).read()
