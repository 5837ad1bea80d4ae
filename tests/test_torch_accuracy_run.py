"""``lsnet_torch.tools.accuracy_run`` against the JAX package's
``tools/accuracy_run.py``.

* ``accuracy_cfg`` equals the config the JAX tool builds, key for key, for
  the five tasks (LSNet-CPV's ``cpv`` with its ``LSCPVDetector`` and
  ``heatmap`` assigner among them) with and without ``--dcn``: the JAX
  tool's own config expression is read from its source and evaluated with
  the same arguments (its file is not changed).
* A CPU run of 10 iterations (the tool logs a loss record every 10
  iterations of an epoch) writes ``result.json`` with finite losses and
  COCO metric keys; an ``--eval-only`` run of its checkpoint records the
  sampling it was given.
* ``--train-sampling`` writes ``train_cfg.dcn_sampling`` and is
  otherwise the JAX tool's config, the run of its STE records; a CPU run
  with it records the spec in its checkpoints and evaluates at the
  deployed sampling.
* ``--sampling`` without ``--eval-only``, ``--train-sampling`` with it,
  and an unknown spec raise.
"""

import argparse
import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest

from lsnet_torch.tools import accuracy_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "accuracy_run.py")
PATHS = dict(train_ann="tr/ann.json", train_dir="tr/imgs",
             val_ann="va/ann.json", val_dir="va/imgs")


def _jax_tool_cfg(args, paths=PATHS):
    """The dict the JAX tool passes to ``Config``, evaluated from its
    source with ``args`` and the data ``paths``."""
    spec = importlib.util.spec_from_file_location("jax_accuracy_run",
                                                  JAX_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    main = next(n for n in ast.parse(open(JAX_TOOL).read()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    call = next(n.value for n in ast.walk(main)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "cfg")
    expr = ast.Expression(call.args[0])
    names = dict(args=args, np=np, TASK_HEADS=tool.TASK_HEADS,
                 IMG_H=tool.IMG_H, IMG_W=tool.IMG_W,
                 pose=args.task in ("pose", "pose_kbox"), **paths)
    return eval(compile(expr, JAX_TOOL, "eval"), names)


def _plain(tree):
    return json.loads(json.dumps(tree))


CASES = [(task, dcn, run)
         for task in ("bbox", "segm", "pose", "pose_kbox", "cpv")
         for dcn in (False, True)
         for run in ((36, 160, 8),)] + [("bbox", True, (48, 320, 8)),
                                          ("segm", False, (1, 4, 2))]


@pytest.mark.parametrize("task,dcn,run", CASES, ids=[
    f"{t}-{'dcn' if d else 'plain'}-{e}e{n}i{b}b" for t, d, (e, n, b)
    in CASES])
def test_config_matches_jax_tool(task, dcn, run):
    epochs, n_train, batch = run
    args = argparse.Namespace(task=task, dcn=dcn, epochs=epochs,
                              train=n_train, batch=batch, seed=0)
    ours = accuracy_run.accuracy_cfg(args, *PATHS.values()).to_dict()
    assert _plain(ours) == _plain(_jax_tool_cfg(args))


def test_cpu_run_and_eval_only(tmp_path):
    out = str(tmp_path / "run")
    flags = ["--device", "cpu", "--task", "bbox", "--val", "2",
             "--batch", "2"]
    res = accuracy_run.main(flags + ["--epochs", "1", "--train", "20",
                                     "--out", out])
    with open(os.path.join(out, "result.json")) as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(res))
    assert len(saved["losses"]) == 1
    assert all(math.isfinite(v) for v in saved["losses"])
    assert "bbox_mAP" in saved["metrics"]
    assert all(k.startswith("bbox_") for k in saved["metrics"])
    assert (saved["epochs"], saved["train_images"], saved["val_images"],
            saved["seed"], saved["sampling"], saved["card"]) == \
        (1, 20, 2, 0, "backbone=nearest", "cpu")
    assert saved["seconds"]["train"] > 0

    ckpt = os.path.join(out, "ckpts", "step_10.pt")
    ev = accuracy_run.main(flags + ["--out", str(tmp_path / "ev"),
                                    "--eval-only", ckpt, "--sampling",
                                    "refine=nearest,backbone=nearest"])
    assert ev["eval_only"] == ckpt
    assert ev["sampling"] == "backbone=nearest,refine=nearest"
    assert "losses" not in ev and "bbox_mAP" in ev["metrics"]


def test_train_sampling_config_is_the_jax_ste_runs():
    """``--train-sampling nearest_ste`` on the R50-DCN bbox 36e run of
    ``docs/accuracy/README.md`` (``r5/ste36_clean.json``): the JAX tool's
    config of that run, which trained under ``LSNET_DCN_SAMPLING=
    nearest_ste``, with ``train_cfg.dcn_sampling`` set to the same spec;
    the JAX runner reads that key with ``set_sampling``, the process-wide
    state the variable sets, and both packages parse the spec to the same
    site -> mode mapping."""
    from lsnet_tpu.ops import flat_deform as jfd
    from lsnet_torch.ops.flat_deform import sampling_from_spec, sampling_spec
    args = argparse.Namespace(task="bbox", dcn=True, epochs=36, train=160,
                              batch=8, seed=0, train_sampling="nearest_ste")
    ours = _plain(accuracy_run.accuracy_cfg(args, *PATHS.values()).to_dict())
    want = _plain(_jax_tool_cfg(args))
    assert ours["train_cfg"].pop("dcn_sampling") == "nearest_ste"
    assert ours == want
    default, listed = jfd._parse_sampling("nearest_ste")
    assert dict(sampling_from_spec("nearest_ste")) == {
        s: listed.get(s, default) for s in ("backbone", "tower", "refine")}
    assert sampling_spec("nearest_ste") == "nearest_ste"
    args.train_sampling = None
    assert _plain(accuracy_run.accuracy_cfg(
        args, *PATHS.values()).to_dict()) == want


def test_cpu_run_with_train_sampling(tmp_path):
    out = str(tmp_path / "ste")
    res = accuracy_run.main(["--device", "cpu", "--task", "bbox", "--val",
                             "2", "--batch", "2", "--epochs", "1",
                             "--train", "20", "--out", out,
                             "--train-sampling", "nearest_ste"])
    assert res["train_sampling"] == \
        "backbone=nearest_ste,refine=nearest_ste,tower=nearest_ste"
    # the run evaluates at its deployed sampling: nearest at every site
    assert res["sampling"] == "backbone=nearest,refine=nearest,tower=nearest"
    from lsnet_torch.train.checkpoint import load_checkpoint
    meta = load_checkpoint(os.path.join(out, "ckpts", "step_10.pt"))["meta"]
    assert meta["dcn_sampling_train"] == "nearest_ste"


@pytest.mark.parametrize("argv,err,match", [
    (["--sampling", "bilinear"], ValueError, "--eval-only"),
    (["--train-sampling", "nearest_ste", "--eval-only", "x.pt"], ValueError,
     "--train-sampling is for a training run"),
    (["--train-sampling", "cubic"], ValueError, "sampling spec")])
def test_refused(argv, err, match):
    with pytest.raises(err, match=match):
        accuracy_run.main(argv + ["--device", "cpu"])


def test_cpv_config_is_the_jax_tools():
    """The cpv task's config at the tool's defaults, the run that
    ``docs/accuracy_torch/run.sh cpv`` makes on the card."""
    args = argparse.Namespace(task="cpv", dcn=False, epochs=12, train=160,
                              batch=8, seed=0)
    ours = accuracy_run.accuracy_cfg(args, *PATHS.values())
    assert ours.model.type == "LSCPVDetector"
    assert ours.model.bbox_head.type == "LSCPVHead"
    assert "heatmap" in ours.train_cfg
    assert _plain(ours.to_dict()) == _plain(_jax_tool_cfg(args))


@pytest.mark.slow
def test_steps_match_jax_runner(tmp_path):
    """(Slow: the JAX runner compiles the R50-DCN train step, about 4
    minutes; run by hand with ``-m slow -s``.) The tool's R50-DCN bbox
    config, 2 epochs of 2 steps on 16 shapes images, f32, a log record
    every step, through both runners from the JAX init (carried across as
    the port's ``step_0.pt``). The JAX runner's batch is
    ``samples_per_gpu`` x its 8 virtual devices.

    * Steps 1 and 2: loss 1e-4 relative, ``grad_norm`` 1e-3.
    * Step 3 from JAX's own parameters after step 2 (its ``step_2``
      checkpoint in the port's model): the loss terms 1e-4, ``grad_norm``
      1e-3, so the loss of a step is the same function in both.
    * The runs' own steps 3 and 4 are printed, not compared: a bilinear
      sample's offset gradient is discontinuous on the lattice (one-sided
      differences toward the next corner), every DCN starts there (zero
      ``conv_offset``), and one step in, offsets of 1e-5 to 1e-4 pixels
      put samples so close to it that the two packages' f32 rounding
      sends some to other corners. The parameters after step 2 differ
      most in the ``conv_offset`` tensors (printed)."""
    import functools

    import jax
    import jax.numpy as jnp
    from lsnet_tpu.models import build_detector as j_build
    from lsnet_tpu.ops import flat_deform as jfd
    from lsnet_tpu.train import loop as jloop
    from lsnet_tpu.train import step as jstep
    from lsnet_tpu.train.checkpoint import (init_variables_shell,
                                            restore_eval_state)
    from lsnet_tpu.utils.config import Config as JConfig
    from lsnet_torch.data.coco import (CocoDataset, DataLoader,
                                       batch_to_device)
    from lsnet_torch.models import build_detector
    from lsnet_torch.tools.shapes import make_shapes_coco
    from lsnet_torch.train import loop as ploop
    from lsnet_torch.train import step as pstep
    from lsnet_torch.train.checkpoint import (load_checkpoint,
                                              save_checkpoint, train_meta)
    from lsnet_torch.train.optim import build_optimizer
    from lsnet_torch.weights import from_jax_variables

    ann, img = make_shapes_coco(str(tmp_path / "data"), 16, seed=0)
    args = argparse.Namespace(task="bbox", dcn=True, epochs=2, train=16,
                              batch=8, seed=0)
    paths = dict(train_ann=ann, train_dir=img, val_ann=ann, val_dir=img)
    jdict = _jax_tool_cfg(args, paths)
    jdict["data"]["samples_per_gpu"] = 1
    jdict["log_interval"] = 1
    jcfg = JConfig(jdict)
    pcfg = accuracy_run.accuracy_cfg(args, *paths.values())
    pcfg.log_interval = 1
    assert jax.device_count() == 8
    f32 = functools.partial(pstep.make_train_step, mixed_precision=False)
    jwork, pwork = str(tmp_path / "jax"), str(tmp_path / "port")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        mp.setattr(jfd, "_SAMPLING_EXPLICIT", [False])
        mp.setattr(jloop, "make_train_step",
                   functools.partial(jstep.make_train_step,
                                     mixed_precision=False))
        mp.setattr(ploop, "make_train_step", f32)
        jloop.train_detector(jcfg, jwork, total_epochs=2,
                             eval_interval=10 ** 9)
        jmodel, _ = j_build(jcfg.model.to_dict())
        variables = jax.tree.map(np.asarray, jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 128, 160, 3), jnp.float32)))
        init = build_detector(pcfg.model.to_dict())
        init.load_state_dict(from_jax_variables(variables), strict=True)
        opt, _ = build_optimizer(init.parameters(), 0.01, 2, [1])
        start = save_checkpoint(str(tmp_path / "init"), init, opt, 0,
                                train_meta())
        ploop.train_detector(pcfg, pwork, resume_from=start,
                             total_epochs=2, eval_interval=10 ** 9,
                             device="cpu")
    finally:
        mp.undo()
    jr, pr = (_train_records(w) for w in (jwork, pwork))
    print("JAX ", [(r["loss"], r["grad_norm"]) for r in jr])
    print("port", [(r["loss"], r["grad_norm"]) for r in pr])
    assert len(jr) == len(pr) == 4
    for a, b in zip(jr[:2], pr[:2]):
        _assert_record_close(b, a)

    # step 3 of the port from JAX's parameters after step 2
    st = restore_eval_state(os.path.join(jwork, "ckpts", "step_2"),
                            init_variables_shell(jmodel, (128, 160)))
    after2 = from_jax_variables(jax.tree.map(
        np.asarray, {"params": st.params, "batch_stats": st.batch_stats}))
    model = build_detector(pcfg.model.to_dict())
    model.load_state_dict(after2, strict=True)
    model.train()
    opt, _ = build_optimizer(model.parameters(), 0.01, 2, [1])
    ds = CocoDataset(ploop._dataset_cfg(pcfg, "train", flip_ratio=0.5,
                                        max_instances=8))
    loader = DataLoader(ds, 8, None)
    step = f32(model, opt, ploop.loss_cfg_from(pcfg, loader.canvas_hw))
    batch = next(iter(loader.epoch(1)))
    got = {k: round(float(v), 5) for k, v in
           step(batch_to_device(batch, "cpu")).items()}
    print("step 3 from JAX's step-2 parameters:", got, "JAX:", jr[2])
    _assert_record_close(got, jr[2])

    # where the runs' own trajectories part: each tensor's difference
    # after step 2 as a share of how far JAX moved it from the init
    mine = load_checkpoint(os.path.join(pwork, "ckpts", "step_2.pt"))["model"]
    start_sd = init.state_dict()
    drift = sorted((((mine[k] - v).abs().max()
                     / (v - start_sd[k]).abs().max().clamp(min=1e-30)).item(),
                    k) for k, v in after2.items())
    print("after step 2, difference / JAX's motion, largest:", drift[-6:])


def _train_records(work):
    import glob
    (path,) = glob.glob(os.path.join(work, "*.log.json"))
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["mode"] == "train"]


def _assert_record_close(got, want):
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"]), \
        (got, want)
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        1e-3 * abs(want["grad_norm"]), (got, want)
    for k in want:
        if k.startswith("loss_"):
            assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), k
