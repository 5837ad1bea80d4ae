"""The runner's state: checkpoints, the deploy sampling, hooks and the
training init.

* A checkpoint round trip is bit for bit (masters, FrozenBatchNorm
  statistics, momentum, ``count``, meta); ``latest_checkpoint``;
  ``CheckpointHook(max_keep=)`` prunes whole files.
* ``deploy_sampling`` equals the parse of the JAX ``deploy_sampling_spec``
  on every train spec the JAX tests feed it, and restoring checkpoints
  leaves ``INFERENCE_SAMPLING`` unchanged; a resume with another train
  sampling raises.
* The hooks' priorities and ``custom_hooks``; the scalar hooks fall back
  to jsonl when their package is absent.
* ``init_weights_`` against the JAX ``model.init``, parameter by parameter
  (names through ``weights.from_jax_variables``), on a narrow X-101-shaped
  detector: constants (zeros, ones, the prior bias) exact; each random
  tensor of at least 4096 entries with a std within 5 % of the JAX
  tensor's and a |mean| under 5 % of that std.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_torch.models import build_detector
from lsnet_torch.models.init import bias_init_with_prob, init_weights_
from lsnet_torch.ops import flat_deform as pfd
from lsnet_torch.train import checkpoint as ck
from lsnet_torch.train import hooks as H
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.utils.config import Config
from lsnet_torch.weights import from_jax_variables

torch.set_num_threads(1)

SPECS = [None, "bilinear", "nearest", "nearest_ste", "backbone=nearest_ste",
         "backbone=bilinear,tower=nearest_ste"]


def _narrow_cfg(r18=False):
    norm = dict(type="GN", num_groups=8)
    backbone = (dict(type="ResNet", depth=18, num_stages=4,
                     out_indices=(0, 1, 2, 3), frozen_stages=1)
                if r18 else
                dict(type="ResNeXt", depth=50, groups=8, base_width=4,
                     num_stages=4, out_indices=(0, 1, 2, 3), frozen_stages=1,
                     stage_with_dcn=(False, True, True, True)))
    chans = [64, 128, 256, 512] if r18 else [256, 512, 1024, 2048]
    return dict(
        type="LSDetector", backbone=backbone,
        neck=dict(type="FPN", in_channels=chans, out_channels=32,
                  start_level=1, add_extra_convs="on_input", num_outs=5,
                  norm_cfg=norm),
        bbox_head=dict(type="LSHead", task="bbox", num_vectors=4,
                       num_classes=3, in_channels=32, feat_channels=32,
                       point_feat_channels=32, stacked_convs=2,
                       num_kernel_points=9, norm_cfg=norm,
                       conv_module_type="dcn"))


def _trained(seed=0):
    """A narrow model and its optimizer after two updates."""
    torch.manual_seed(seed)
    model = build_detector(_narrow_cfg(r18=True))
    init_weights_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "mean") and hasattr(m, "var"):
                m.mean.normal_()
                m.var.uniform_(0.5, 2.0)
    opt, _ = build_optimizer(model.parameters(), 0.01, 4, [8])
    for _ in range(2):
        opt.step([torch.randn_like(p) for p in opt.params])
    return model, opt


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    model, opt = _trained()
    meta = ck.train_meta("backbone=nearest_ste")
    path = ck.save_checkpoint(str(tmp_path), model, opt, 2, meta)
    assert os.path.basename(path) == "step_2.pt"
    assert os.listdir(tmp_path) == ["step_2.pt"]     # the meta is inside
    raw = torch.load(path, weights_only=True)
    assert raw["meta"] == {"dcn_sampling_train": "backbone=nearest_ste"}

    other, opt2 = _trained(seed=1)
    info = ck.restore_checkpoint(path, other, opt2)
    assert info == {"step": 2, "meta": meta}
    want, got = model.state_dict(), other.state_dict()
    assert list(want) == list(got)
    assert any(k.endswith(".var") for k in want)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    a, b = opt.state_dict(), opt2.state_dict()
    assert a["count"] == b["count"] == 2
    for x, y in zip(a["momentum"], b["momentum"]):
        assert torch.equal(x, y)
    state, meta2 = ck.restore_eval_state(path)
    assert meta2 == meta and all(torch.equal(state[k], want[k])
                                 for k in want)


def test_latest_checkpoint(tmp_path):
    assert ck.latest_checkpoint(str(tmp_path / "none")) is None
    assert ck.latest_checkpoint(str(tmp_path)) is None
    for name in ("step_2.pt", "step_10.pt", "step_9.pt", "step_11.pt.tmp",
                 "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert ck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_10.pt")
    assert ck.checkpoint_steps(str(tmp_path)) == [2, 9, 10]


def test_checkpoint_hook_prunes_whole_files(tmp_path):
    model, opt = _trained()
    hook = H.CheckpointHook(max_keep=2)
    ctx = H.RunnerContext(None, str(tmp_path), 1, 5)
    ctx.model, ctx.optimizer, ctx.meta = model, opt, ck.train_meta()
    for epoch in range(4):
        ctx.epoch, ctx.global_step = epoch, epoch + 1
        hook.after_epoch(ctx)
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["step_3.pt",
                                                      "step_4.pt"]


def _jax_deploy(spec, monkeypatch):
    monkeypatch.setattr(jfd, "INFERENCE_SAMPLING", ["backbone=nearest"])
    out = jfd.deploy_sampling_spec(spec)
    d, p = jfd._parse_sampling(out if out is not None
                               else jfd.INFERENCE_SAMPLING[0])
    return {s: p.get(s, d) for s in pfd.SITES}


@pytest.mark.parametrize("spec", SPECS)
def test_deploy_sampling_matches_the_jax_policy(spec, monkeypatch):
    meta = ck.train_meta(spec)
    monkeypatch.setattr(jfd, "SAMPLING", ["bilinear"])
    monkeypatch.setattr(jfd, "SAMPLING_POLICY", {})
    if spec is not None:
        jfd.set_sampling(spec)
    assert meta["dcn_sampling_train"] == jfd.current_sampling_spec()
    assert dict(ck.deploy_sampling(meta)) == _jax_deploy(spec, monkeypatch)


def test_deploy_sampling_leaves_the_default_unchanged(tmp_path):
    before = dict(pfd.INFERENCE_SAMPLING)
    model, opt = _trained()
    got = []
    for spec in ("nearest_ste", "bilinear"):
        path = ck.save_checkpoint(str(tmp_path / spec), model, opt, 1,
                                  ck.train_meta(spec))
        got.append(dict(ck.deploy_sampling(ck.restore_eval_state(path)[1])))
    assert got[0] == dict.fromkeys(pfd.SITES, "nearest")
    assert got[1] == before == dict(pfd.INFERENCE_SAMPLING)
    assert ck.deploy_sampling(None) is pfd.INFERENCE_SAMPLING
    with pytest.raises(NotImplementedError,
                       match="Queue 1 \"Leftovers on the surface already"):
        ck.deploy_sampling({"refine_taps_train": "0,1,3,5,7"})


def test_resume_with_another_sampling_raises(tmp_path):
    from lsnet_torch.tools.shapes import make_shapes_coco
    from lsnet_torch.train.loop import train_detector
    ann, img = make_shapes_coco(str(tmp_path / "data"), 4, 0, hw=(64, 96))
    model = build_detector(_narrow_cfg(r18=True))
    opt, _ = build_optimizer(model.parameters(), 0.01, 1, [8])
    path = ck.save_checkpoint(str(tmp_path / "c"), model, opt, 0,
                              ck.train_meta("nearest_ste"))
    data = dict(ann_file=ann, img_prefix=img, img_scale=(96, 64))
    cfg = Config(dict(
        model=_narrow_cfg(r18=True),
        data=dict(samples_per_gpu=2, train=data),
        train_cfg=dict(init=dict(assigner=dict()),
                       refine=dict(assigner=dict())),
        test_cfg=dict(), optimizer=dict(lr=0.01), canvas_shape=(64, 96)))
    with pytest.raises(ValueError, match="nearest_ste"):
        train_detector(cfg, str(tmp_path / "w"), resume_from=path,
                       device="cpu")


def test_hooks_priorities_and_custom_hooks(tmp_path):
    cfg = Config(dict(checkpoint_config=dict(interval=2), custom_hooks=[
        dict(type="TensorboardHook", interval=1),
        dict(type="WandbHook", interval=1),
        dict(type="MlflowHook", interval=1)]))
    hooks = H.build_hooks(cfg, logger=None, eval_interval=3)
    assert [type(h).__name__ for h in hooks] == [
        "CheckpointHook", "EvalHook", "LoggerHook", "TensorboardHook",
        "WandbHook", "MlflowHook"]
    assert [h.priority for h in hooks] == [70, 80, 90, 91, 92, 93]
    assert hooks[0].interval == 2 and hooks[1].interval == 3
    with pytest.raises(KeyError, match="NoSuchHook"):
        H.build_hooks(Config(dict(custom_hooks=[dict(type="NoSuchHook")])),
                      None, 1)


@pytest.mark.parametrize("kind,path", [
    ("WandbHook", "wandb_scalars.jsonl"),
    ("MlflowHook", "mlflow_scalars.jsonl")])
def test_scalar_hooks_fall_back_to_jsonl(kind, path, tmp_path, monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_backend(name, *a, **k):
        if name in ("wandb", "mlflow"):
            raise ImportError(name)
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_backend)
    hook = H.HOOKS.get(kind)(interval=2)
    ctx = H.RunnerContext(None, str(tmp_path), 4, 1)
    hook.before_train(ctx)
    for step in (1, 2, 3, 4):
        ctx.global_step, ctx.lr, ctx.metrics = step, 0.1 * step, {"loss": 1.0}
        hook.after_iter(ctx)
    hook.after_train(ctx)
    with open(tmp_path / path) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [2, 4] and rows[0]["loss"] == 1.0


@pytest.fixture(scope="module")
def inits():
    cfg = _narrow_cfg()
    jmodel, _ = j_build(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 96, 3), jnp.float32))
    want = from_jax_variables(jax.tree.map(np.asarray, variables))
    model = init_weights_(build_detector(cfg),
                          torch.Generator().manual_seed(0))
    return want, dict(model.state_dict())


def test_init_has_the_jax_parameters(inits):
    want, got = inits
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k


def test_init_constants_are_exact(inits):
    want, got = inits
    n = 0
    for k, w in want.items():
        if w.numel() and bool((w == w.flatten()[0]).all()):
            assert torch.equal(got[k], w), k
            n += 1
    prior = want["head.pts_cls_out.bias"]
    assert torch.allclose(prior, torch.full_like(
        prior, bias_init_with_prob(0.01)))
    assert n > 50


def test_init_random_tensors_match_the_jax_distribution(inits):
    want, got = inits
    n = 0
    for k, w in want.items():
        if w.numel() < 4096 or bool((w == w.flatten()[0]).all()):
            continue
        sw, sg = w.std().item(), got[k].std().item()
        assert abs(sg - sw) <= 0.05 * sw, (k, sg, sw)
        assert abs(got[k].mean().item()) <= 0.05 * sw, k
        n += 1
    assert n > 30
