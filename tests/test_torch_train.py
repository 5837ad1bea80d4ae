"""The training slice as a whole: narrow models (the flagship configs with
feat 32, one stacked DCN block, 4 classes; an R50-shaped one on a
ResNet-18 backbone and an X-101-shaped one on ResNeXt-50 with G=8 and DCN
in c3-c5) on a 64x96 batch of two, JAX vs the port on the same minted
weights and the same synthetic batch, f32:

* loss and every trainable parameter's gradient against
  ``jax.value_and_grad`` of ``model.apply`` + ``lsnet_loss``;
* the parameters after 3 steps against ``make_train_step(
  mixed_precision=False)`` with the JAX optimizer (clip, weight decay,
  momentum, warm-up and a decay boundary inside the 3 steps; frozen stage
  masked out);
* the LR schedule's values, the clip rule, and one bf16 step.

Tolerances: the loss 1e-5 relative; each gradient 1e-3 of its tensor's
largest entry (the differences pass through the whole network, as in
``tests/test_torch_e2e.py``) plus 2e-5 of the largest gradient of all.
The second term is f32 noise: with 32 GroupNorm groups over 32 channels
every conv in front of a GroupNorm has a bias gradient that is exactly 0
analytically (both frameworks give ~1e-9 of rounding) and a weight
gradient that is the small remainder (1e-3 to 1e-4 of the largest
gradient) of cancelling terms; measured against an f64 run of the port,
the port's and JAX's f32 gradients of those tensors are each 2-8 % off
and within 1 % of each other; parameters after 3 steps 1e-4 *
max(1, max|ref|). The backbone's FrozenBatchNorm scales are set to 1 in
the minted variables so that the residual branches, the backbone DCN
included, carry gradient (see ``tests/test_torch_x101.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg, _x101_flagship_cfg
from lsnet_tpu.core.loss import LossConfig as JLossConfig
from lsnet_tpu.core.loss import lsnet_loss as j_lsnet_loss
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.models.backbones.resnet import frozen_param_paths
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.train import optim as joptim
from lsnet_tpu.train.step import create_train_state
from lsnet_tpu.train.step import make_train_step as j_make_train_step
from lsnet_torch.apis import init_model, train_detector_step
from lsnet_torch.configs import flagship_r50_cfg, x101_flagship_cfg
from lsnet_torch.core.loss import LossConfig, lsnet_loss
from lsnet_torch.models import build_detector
from lsnet_torch.train.optim import build_optimizer, step_lr_schedule
from lsnet_torch.train.step import make_train_step
from lsnet_torch.weights import load_jax_variables, to_jax_variables
from torch_port_util import assert_close, mint_variables, t, to_jax

torch.set_num_threads(1)

H, W, B, M, C = 64, 96, 2, 4, 4
OPTIM = dict(base_lr=0.02, steps_per_epoch=2, decay_epochs=[1],
             warmup_iters=2, warmup_ratio=0.1, clip_norm=2.0)


def _unit_scales(tree):
    return {k: (_unit_scales(v) if isinstance(v, dict)
                else np.ones_like(v) if k == "scale" else v)
            for k, v in tree.items()}


def _configs(kind):
    if kind == "r50":
        jcfg, tcfg = (_flagship_cfg(feat=32, stacked=1),
                      flagship_r50_cfg(feat=32, stacked=1))
        for cfg in (jcfg, tcfg):
            cfg["backbone"]["depth"] = 18
    else:
        jcfg, tcfg = (_x101_flagship_cfg(feat=32, stacked=1),
                      x101_flagship_cfg(feat=32, stacked=1))
        for cfg in (jcfg, tcfg):
            cfg["backbone"].update(depth=50, groups=8)
    for cfg in (jcfg, tcfg):
        cfg["bbox_head"]["num_classes"] = C
    return jcfg, tcfg


def _batch(seed):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 40, (B, M, 2))
    wh = rng.uniform(8, 50, (B, M, 2))
    return {
        "image": rng.randn(B, H, W, 3).astype(np.float32),
        "pad_shape": np.array([[H, W], [H - 8, W - 16]], np.int32),
        "gt_bboxes": np.concatenate([lo, lo + wh], -1).astype(np.float32),
        "gt_labels": rng.randint(0, C, (B, M)).astype(np.int32),
        "gt_valid": np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool),
    }


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=["r50", "x101"])
def pair(request):
    """(kind, JAX model, variables, torch config, batch, trainable mask)
    with the JAX sampling pinned to bilinear while the module's tests
    run."""
    kind = request.param
    jcfg, tcfg = _configs(kind)
    jmodel, _ = j_build(jcfg)
    batch = _batch(0 if kind == "r50" else 1)
    v = mint_variables(jmodel, jnp.asarray(batch["image"][:1]),
                       seed=3 if kind == "r50" else 4)
    params = dict(v["params"])
    params["backbone"] = _unit_scales(params["backbone"])
    v = dict(v, params=params)
    mask = joptim.make_frozen_mask(
        v["params"], frozen_param_paths(jcfg["backbone"]["depth"], 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        yield kind, jmodel, v, tcfg, batch, mask


def _torch_model(tcfg, v):
    model = build_detector(tcfg)
    load_jax_variables(model, v)
    return model.train()


def test_loss_and_gradients_match_jax(pair):
    kind, jmodel, v, tcfg, batch, mask = pair
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    kw = dict(image_shape=(H, W), num_classes=C)

    def jf(params):
        outs = jmodel.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jbatch["image"])
        return j_lsnet_loss(outs, jbatch, JLossConfig(**kw))[0]

    want, jgrads = jax.jit(jax.value_and_grad(jf))(to_jax(v["params"]))
    model = _torch_model(tcfg, v)
    tbatch = {k: t(x) for k, x in batch.items()}
    total, _ = lsnet_loss(model(tbatch["image"]), tbatch, LossConfig(**kw))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(total, [p for _, p in named])
    assert abs(float(total.detach()) - float(want)) <= 1e-5 * abs(float(want))

    got = _leaves(to_jax_variables(
        model, {n: g for (n, _), g in zip(named, grads)})["params"])
    jleaves, trainable = _leaves(jgrads), _leaves(mask)
    assert set(got) == {k for k, m in trainable.items() if m}
    frozen = [k for k, m in trainable.items() if not m]
    assert frozen and all("backbone" in k for k in frozen)
    overall = max(float(np.abs(jleaves[k]).max()) for k in got)
    for key, g in got.items():
        ref = jleaves[key]
        assert g.shape == ref.shape, key
        top = float(np.abs(ref).max())
        err = float(np.abs(g - ref).max())
        assert err <= 1e-3 * top + 2e-5 * overall, \
            f"{key}: {err:.3g} vs max {top:.3g}, overall {overall:.3g}"
    if kind == "x101":       # the grouped backbone DCN takes gradient
        assert any("layer2_0']['conv2']['weight" in k for k in got)


def test_three_steps_match_jax(pair):
    kind, jmodel, v, tcfg, batch, mask = pair
    lcfg_kw = dict(image_shape=(H, W), num_classes=C)
    tx, _ = joptim.build_optimizer(
        OPTIM["base_lr"], OPTIM["steps_per_epoch"], OPTIM["decay_epochs"],
        clip_norm=OPTIM["clip_norm"], warmup_iters=OPTIM["warmup_iters"],
        warmup_ratio=OPTIM["warmup_ratio"], trainable_mask=mask)
    state = create_train_state(to_jax(v), tx)
    jstep = j_make_train_step(jmodel, tx, JLossConfig(**lcfg_kw),
                              mixed_precision=False)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    jlosses = []
    for _ in range(3):
        state, metrics = jstep(state, jbatch)
        jlosses.append(float(metrics["loss"]))

    model = _torch_model(tcfg, v)
    optimizer, _ = build_optimizer(model.parameters(), **OPTIM)
    step = make_train_step(model, optimizer, LossConfig(**lcfg_kw),
                           mixed_precision=False)
    tbatch = {k: t(x) for k, x in batch.items()}
    history = [step(tbatch) for _ in range(3)]
    assert optimizer.count == 3
    for m, want in zip(history, jlosses):
        assert abs(float(m["loss"]) - want) <= 1e-4 * abs(want)
        assert float(m["grad_norm"]) > OPTIM["clip_norm"]   # the clip bites
        assert set(m) == {"loss", "loss_cls", "loss_bbox_init",
                          "loss_bbox_refine", "grad_norm"}
    got = _leaves(to_jax_variables(model)["params"])
    want = _leaves(state.params)
    before = _leaves(v["params"])
    trainable = _leaves(mask)
    assert set(got) == set(want)
    for key, ref in want.items():
        assert_close(got[key], ref, rel=1e-4)
        if trainable[key]:
            assert np.abs(got[key] - before[key]).max() > 0, key
        else:                              # the frozen stage is untouched
            np.testing.assert_array_equal(got[key], before[key], key)
            np.testing.assert_array_equal(ref, before[key], key)


def test_lr_schedule_values():
    kw = dict(warmup_iters=500, warmup_ratio=0.001)
    sched = step_lr_schedule(0.01, 1000, [8, 11], **kw)
    jsched = joptim.step_lr_schedule(0.01, 1000, [8, 11], **kw)
    for step in (0, 1, 250, 499, 500, 7999, 8000, 10999, 11000, 20000):
        # the JAX schedule computes in f32
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-4)
    assert sched(0) == pytest.approx(0.01 * 0.001)
    assert sched(500) == 0.01
    assert sched(8000) == pytest.approx(0.001)
    assert sched(11000) == pytest.approx(0.0001)


def test_clip_follows_optax_and_frozen_parameters_stay():
    """clip / max(norm, clip): a gradient under the limit is not scaled,
    one over it is scaled onto it; momentum and weight decay as
    torch.optim.SGD; a frozen parameter is not held by the optimizer."""
    a = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    b = torch.nn.Parameter(torch.tensor([3.0]), requires_grad=False)
    opt, sched = build_optimizer([a, b], 0.1, 10, [], momentum=0.0,
                                 weight_decay=0.0, clip_norm=5.0,
                                 warmup_iters=0)
    assert len(opt.params) == 1 and sched(0) == 0.1
    norm = opt.step([torch.tensor([3.0, 4.0])])            # norm 5: kept
    assert float(norm) == 5.0
    torch.testing.assert_close(a.detach(), torch.tensor([0.7, 1.6]))
    norm = opt.step([torch.tensor([30.0, 40.0])])          # norm 50: / 10
    assert float(norm) == 50.0
    torch.testing.assert_close(a.detach(), torch.tensor([0.4, 1.2]))
    assert float(b) == 3.0 and a.grad is None


def test_bf16_step_is_finite_and_updates_f32_masters():
    cfg = x101_flagship_cfg(feat=32, stacked=1)
    cfg["backbone"].update(depth=50, groups=8)
    cfg["bbox_head"]["num_classes"] = C
    model = init_model(cfg, device="cpu", seed=2, train=True)
    assert model.training
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    # nearest-aware training at the head sites, bilinear in the backbone
    step = train_detector_step(
        model, LossConfig(image_shape=(H, W), num_classes=C), warmup_iters=0,
        sampling={"backbone": "bilinear", "tower": "nearest_ste",
                  "refine": "nearest_ste"})
    metrics = step({k: t(x) for k, x in _batch(2).items()})
    assert all(bool(torch.isfinite(x)) for x in metrics.values())
    assert float(metrics["grad_norm"]) > 0
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p, before[n]) != p.requires_grad, n
