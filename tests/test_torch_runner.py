"""The runner as a whole: ``lsnet_torch.train.loop.train_detector`` and
``evaluate_detector`` against the JAX package's, on the same data, from
the same weights, f32.

One run of each: a narrow R18-backbone LSHead (feat 32, one stacked DCN
block, 3 classes, ``frozen_stages=-1`` so that ``grad_norm`` counts the
same tensors) on 16 procedural landscape images at 64x96, 2 epochs of 2
iterations, both runners' ``make_train_step`` swapped for its
``mixed_precision=False`` form (no package file changes for that).

The JAX runner's batch is ``samples_per_gpu`` x the device count, and
JAX sees 8 virtual CPU devices under the tests, so the port's config has
a ``samples_per_gpu`` 8 times the JAX config's: both loaders then cut the
same batches from the same seeded shuffle, which is asserted before the
losses are compared. The JAX runner starts from ``model.init(
PRNGKey(seed), zeros(1, *canvas, 3))``, jitted (the eager call takes
about 70 s on this CPU; the two agree to 6e-8) and recorded; those
variables, carried across by ``weights.from_jax_variables`` into a port
``step_0.pt``, are what the port resumes from.

Tolerances: per-iteration ``loss`` 1e-4 relative, ``grad_norm`` 1e-3
relative (each gradient agrees only to 1e-3 of its tensor's largest
entry, ``tests/test_torch_train.py``), the parameters after 4 steps 1e-4
* max(1, max|ref|); ``evaluate_detector`` of both packages on the JAX
state: the same metric keys, each metric within 0.01 absolute, the
detection counts within 1 % (head outputs agree to 1e-3, so a detection
can cross ``score_thr``).
"""

import functools
import glob
import json
import os

import flax.linen
import jax
import numpy as np
import pytest
import torch

from lsnet_tpu.data import coco as j_coco
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import loop as jloop
from lsnet_tpu.train import step as jstep
from lsnet_tpu.utils.config import Config as JConfig
from lsnet_torch.data import coco as p_coco
from lsnet_torch.models import build_detector
from lsnet_torch.ops.flat_deform import INFERENCE_SAMPLING, TRAIN_SAMPLING
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import loop as ploop
from lsnet_torch.train import step as pstep
from lsnet_torch.train.checkpoint import save_checkpoint, train_meta
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import from_jax_variables
from torch_port_util import assert_close

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
N_IMAGES = 16
JAX_DEVICES = 8


def _cfg_dict(root, samples_per_gpu):
    norm = dict(type="GN", num_groups=8)
    data = dict(ann_file=os.path.join(root, "ann.json"),
                img_prefix=os.path.join(root, "imgs"), img_scale=(96, 64))
    return dict(
        _base_=os.path.join(REPO, "configs", "lsnet",
                            "lsnet_bbox_r50_fpn_1x_coco.py"),
        model=dict(
            backbone=dict(depth=18, frozen_stages=-1),
            neck=dict(in_channels=[64, 128, 256, 512], out_channels=32,
                      norm_cfg=norm),
            bbox_head=dict(in_channels=32, feat_channels=32,
                           point_feat_channels=32, stacked_convs=1,
                           norm_cfg=norm, num_classes=3)),
        data=dict(samples_per_gpu=samples_per_gpu, train=dict(data),
                  val=dict(data)),
        canvas_shape=HW, log_interval=1, total_epochs=2,
        checkpoint_config=dict(interval=100),
        lr_config=dict(warmup_iters=2, step=[1]),
        optimizer=dict(lr=0.01),
        test_cfg=dict(score_thr=0.008))


def _config(cls, root, samples_per_gpu):
    path = os.path.join(root, f"cfg_{samples_per_gpu}.py")
    with open(path, "w") as f:
        for k, v in _cfg_dict(root, samples_per_gpu).items():
            f.write(f"{k} = {v!r}\n")
    return cls.fromfile(path)


def _recording_loader(base, seen):
    class Recording(base):
        def epoch(self, epoch_idx):
            for batch in super().epoch(epoch_idx):
                seen.append({k: np.array(v) for k, v in batch.items()})
                yield batch
    return Recording


def _counting(fn, counts):
    def wrapped(gts, dts, *a, **k):
        counts.append(len(dts))
        return fn(gts, dts, *a, **k)
    return wrapped


def _recorded_jit_init(orig, seen):
    """flax ``Module.init`` jitted, a host copy of each result kept in
    ``seen`` (the train step donates the arrays it is given)."""
    def init(self, *a, **k):
        variables = jax.jit(lambda *b: orig(self, *b, **k))(*a)
        seen.append(jax.tree.map(np.array, variables))
        return variables
    return init


def _f32_step(make, *a, **k):
    return make(*a, **{**k, "mixed_precision": False})


def _log_records(work_dir):
    (path,) = glob.glob(os.path.join(work_dir, "*.log.json"))
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    root = str(tmp_path_factory.mktemp("runner"))
    data = os.path.join(root, "data")
    make_shapes_coco(data, N_IMAGES, seed=3, hw=HW)
    jcfg = _config(JConfig, data, 1)
    pcfg = _config(Config, data, JAX_DEVICES)
    assert jax.device_count() == JAX_DEVICES
    out = {"jcfg": jcfg, "pcfg": pcfg}
    try:
        # the JAX package's process-wide sampling state, pinned
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        mp.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        mp.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])
        mp.setattr(jloop, "make_train_step",
                   functools.partial(jstep.make_train_step,
                                     mixed_precision=False))
        mp.setattr(ploop, "make_train_step",
                   functools.partial(_f32_step, pstep.make_train_step))
        out["jbatches"], out["pbatches"] = [], []
        mp.setattr(jloop, "DataLoader",
                   _recording_loader(j_coco.DataLoader, out["jbatches"]))
        mp.setattr(ploop, "DataLoader",
                   _recording_loader(p_coco.DataLoader, out["pbatches"]))

        inits = []
        mp.setattr(flax.linen.Module, "init",
                   _recorded_jit_init(flax.linen.Module.init, inits))
        jwork = os.path.join(root, "jax")
        res = jloop.train_detector(jcfg, jwork, eval_interval=100)
        out["jstate"] = res["state"]
        out["jrecords"] = _log_records(jwork)

        # the JAX runner's initial variables as the port's step_0.pt
        jmodel, _ = j_build(jcfg.model.to_dict())
        assert len(inits) == 1
        variables = inits[0]
        init = build_detector(pcfg.model.to_dict())
        init.load_state_dict(from_jax_variables(variables), strict=True)
        optimizer, _ = build_optimizer(init.parameters(), 0.01, 2, [1])
        start = save_checkpoint(os.path.join(root, "init"), init, optimizer,
                                0, train_meta())
        pwork = os.path.join(root, "port")
        res = ploop.train_detector(pcfg, pwork, resume_from=start,
                                   eval_interval=100, device="cpu")
        out["pmodel"] = res["model"]
        out["precords"] = _log_records(pwork)

        # both evaluations on the JAX state
        jstate = out["jstate"]
        out["jcounts"], out["pcounts"] = [], []
        mp.setattr(jloop, "evaluate_coco",
                   _counting(jloop.evaluate_coco, out["jcounts"]))
        mp.setattr(ploop, "evaluate_coco",
                   _counting(ploop.evaluate_coco, out["pcounts"]))
        out["jmetrics"] = jloop.evaluate_detector(jcfg, jmodel, jstate, HW)
        evalm = build_detector(pcfg.model.to_dict())
        evalm.load_state_dict(from_jax_variables(jax.tree.map(
            np.asarray, {"params": jstate.params,
                         "batch_stats": jstate.batch_stats})), strict=True)
        out["pmetrics"] = ploop.evaluate_detector(
            pcfg, evalm, HW, sampling=ploop.eval_sampling())
    finally:
        mp.undo()
    return out


def test_both_runners_cut_the_same_batches(runs):
    jb, pb = runs["jbatches"], runs["pbatches"]
    assert len(jb) == len(pb) == 4
    for a, b in zip(jb, pb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_log_records_have_the_same_keys(runs):
    jr, pr = runs["jrecords"], runs["precords"]
    assert [r["mode"] for r in jr] == [r["mode"] for r in pr] == \
        ["train"] * 4
    for a, b in zip(jr, pr):
        assert list(a) == list(b)
        assert (a["epoch"], a["iter"], a["lr"]) == \
            (b["epoch"], b["iter"], b["lr"])


def test_losses_and_grad_norms_agree(runs):
    for a, b in zip(runs["jrecords"], runs["precords"]):
        assert abs(b["loss"] - a["loss"]) <= 1e-4 * abs(a["loss"]), (a, b)
        assert abs(b["grad_norm"] - a["grad_norm"]) <= \
            1e-3 * abs(a["grad_norm"]), (a, b)
        for k in a:
            if k.startswith("loss_"):
                assert abs(b[k] - a[k]) <= 1e-4 * max(1.0, abs(a[k])), k


def test_parameters_after_four_steps_agree(runs):
    jstate = runs["jstate"]
    want = from_jax_variables(jax.tree.map(
        np.asarray, {"params": jstate.params,
                     "batch_stats": jstate.batch_stats}))
    got = runs["pmodel"].state_dict()
    assert int(jstate.step) == 4
    assert set(got) == set(want)
    for k, w in want.items():
        assert_close(got[k], w.numpy(), rel=1e-4)


def test_evaluations_of_the_jax_state_agree(runs):
    jm, pm = runs["jmetrics"], runs["pmetrics"]
    assert list(jm) == list(pm) and len(jm) == 12
    for k in jm:
        assert abs(pm[k] - jm[k]) <= 0.01, (k, pm[k], jm[k])
    (jn,), (pn,) = runs["jcounts"], runs["pcounts"]
    assert jn > 0 and abs(pn - jn) <= 0.01 * jn, (pn, jn)


def test_eval_sampling_matches_the_jax_precedence(monkeypatch):
    """The mapping each package's eval runs: a train config's own
    ``dcn_sampling`` (the runner's EvalHook) and, without one, the shipped
    default; a checkpoint's meta (tools.test) after ``arm_deploy_policy``."""
    from lsnet_torch.train.checkpoint import train_meta as p_meta

    def jax_effective(train_spec, meta):
        monkeypatch.setattr(jfd, "SAMPLING", ["bilinear"])
        monkeypatch.setattr(jfd, "SAMPLING_POLICY", {})
        monkeypatch.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        monkeypatch.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])
        if train_spec:
            jfd.set_sampling(train_spec)
        jfd.arm_deploy_policy(meta)
        with jfd.inference_sampling():
            return {s: jfd.SAMPLING_POLICY.get(s, jfd.SAMPLING[0])
                    for s in ("backbone", "tower", "refine")}

    from lsnet_torch.ops.flat_deform import sampling_from_spec
    for spec in (None, "bilinear", "nearest_ste", "backbone=nearest_ste"):
        hook = ploop.eval_sampling(sampling_from_spec(spec) if spec
                                   else None)
        assert dict(hook) == jax_effective(spec, None), spec
        meta = p_meta(spec)
        assert dict(ploop.eval_sampling(meta=meta)) == \
            jax_effective(None, meta), spec
    assert ploop.eval_sampling() is INFERENCE_SAMPLING
    assert dict(TRAIN_SAMPLING) == jax_effective("bilinear", None)
