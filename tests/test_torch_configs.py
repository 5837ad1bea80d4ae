"""The shipped LSNet and RepPoints-family configs through the port's
config loader and ``build_detector``.

Every ``configs/lsnet/*.py`` file is read with the port's own
``lsnet_torch.utils.config.Config``, whose ``to_dict()`` must equal the JAX
package's loader's (the test may import that one, the port may not); the
runner's ``loss_cfg_from`` / ``test_cfg_from`` equal the JAX ones field by
field for every LSHead file, and ``build_lr_schedule`` (step, cosine and
poly, with warm-up) equals the JAX schedule at every step of a short run
(1e-7 absolute; the JAX one computes in f32). The ``model`` dict goes to
the port's ``build_detector``
on the ``meta`` device (no weights are allocated). The R50, X-101 and
Res2Net-101 files build, ``with_cp=True`` included, the two CPV files with
the CPV head (``LSCPVDetector``: an LSDetector with ``LSCPVHead``); the
runner's loss config of a CPV file is ``CPVLossConfig`` around the base
one, as the JAX runner's ``make_loss_for`` builds it. The five
``configs/reppoints`` and ``configs/dense_reppoints`` files read the same,
build on the ``meta`` device with a head whose state dict has the keys
and shapes of the JAX head's parameters, and give the JAX runner's loss
and test configs. The thirteen dense-zoo files (RetinaNet, GA-RetinaNet,
GA-RPN, FCOS, ATSS, GFL, FoveaBox, FSAF, FreeAnchor, PISA RetinaNet,
SSD300, PISA SSD300, NAS-FCOS) read the same and build the same way; the
two-stage files are refused with the ROADMAP entry they wait for.

``with_cp`` runs each residual block under ``torch.utils.checkpoint``
(``remat`` in the JAX package): a narrow ResNeXt with DCN stages gives the
same loss and gradients with and without it (f32, 1e-6 of max(1, max|ref|):
the recomputed forward repeats the same operations), and the block's
forward runs a second time in the backward only when training with
gradients on.
"""

import glob
import os

import numpy as np
import pytest
import torch

from lsnet_tpu.train import loop as jloop
from lsnet_tpu.train import optim as joptim
from lsnet_tpu.utils.config import Config
from lsnet_torch.models import build_detector, head_cfg_of, is_cpv
from lsnet_torch.train import loop as ploop
from lsnet_torch.train import optim as poptim
from lsnet_torch.utils.config import Config as PConfig
from lsnet_torch.models.backbones.resnet import ResNet
from lsnet_torch.ops.flat_deform import TRAIN_SAMPLING

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "configs", "lsnet", "*.py")))


def _model_cfg(name):
    return Config.fromfile(os.path.join(REPO, "configs", "lsnet",
                                        name)).to_dict()["model"]


def _path(name):
    return os.path.join(REPO, "configs", "lsnet", name)


@pytest.mark.parametrize("name", CONFIGS)
def test_port_config_loader_reads_the_same(name):
    want = Config.fromfile(_path(name)).to_dict()
    got = PConfig.fromfile(_path(name)).to_dict()
    assert got == want and "model" in got


def test_port_config_overrides():
    cfg = PConfig.fromfile(_path("lsnet_bbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py"))
    assert cfg.model.backbone.with_cp and cfg.model.backbone.type == "ResNeXt"
    assert cfg.data.train.img_scale == [(1333, 480), (1333, 960)]
    cfg.merge_from_dict({"model.bbox_head.num_classes": 3,
                         "data.samples_per_gpu": 4})
    assert cfg.model.bbox_head.num_classes == 3
    assert cfg.data.samples_per_gpu == 4 and cfg.total_epochs == 24


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_test_configs_match_the_jax_runner(name):
    """The segm and pose_kbox files turn the bbox losses off with None,
    on which the JAX ``loss_cfg_from`` raises ``AttributeError``; the JAX
    function is read there on the file with those None entries left out,
    which is what the port does with them."""
    jcfg, pcfg = Config.fromfile(_path(name)), PConfig.fromfile(_path(name))
    head = jcfg.model.bbox_head
    for k in [k for k, v in head.items() if v is None]:
        del head[k]
    canvas = (800, 1344)
    want = jloop.loss_cfg_from(jcfg, canvas)
    got = ploop.loss_cfg_from(pcfg, canvas)
    assert got.__dataclass_fields__.keys() <= want.__dataclass_fields__.keys()
    for f in got.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    want = jloop.test_cfg_from(jcfg, canvas)
    got = ploop.test_cfg_from(pcfg, canvas)
    for f in got.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    train = ploop.train_loss_cfg(pcfg, canvas)
    if "cpv" in name:
        from lsnet_torch.core.cpv import CPVLossConfig
        assert train == CPVLossConfig(base=ploop.loss_cfg_from(pcfg, canvas))
    else:
        assert train == ploop.loss_cfg_from(pcfg, canvas)


@pytest.mark.parametrize("lr_config", [
    dict(policy="step", step=[1, 2], warmup_iters=5, warmup_ratio=0.1),
    dict(policy="CosineAnnealing", min_lr_ratio=0.05, warmup_iters=4),
    dict(policy="cosine", min_lr=1e-4, warmup_iters=0),
    dict(policy="poly", power=0.9, min_lr=1e-4, warmup_iters=3,
         warmup_ratio=0.01)])
def test_lr_schedules_match_the_jax_ones(lr_config):
    want = joptim.build_lr_schedule(dict(lr_config), 0.02, 4, 3)
    got = poptim.build_lr_schedule(dict(lr_config), 0.02, 4, 3)
    for step in range(14):
        assert abs(got(step) - float(want(step))) <= 1e-7, step


def test_every_lsnet_config_is_listed():
    """17 files: 6 R50, 7 X-101 and 4 Res2Net-101, one of each of the
    last two with the CPV head."""
    assert len(CONFIGS) == 17
    assert sum("r50" in n for n in CONFIGS) == 6
    assert sum("x101" in n for n in CONFIGS) == 7
    assert sum("cpv" in n for n in CONFIGS) == 2


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_or_names_what_is_missing(name):
    cfg = _model_cfg(name)
    with torch.device("meta"):
        model = build_detector(cfg)
    assert is_cpv(model) == ("cpv" in name)
    if "cpv" in name:
        assert cfg["type"] == "LSCPVDetector"
        # the 6 corner channels widen the paired gather: C = 256 + 6
        assert model.head.pts_bbox_cls_pair.weight_a.shape == (3, 3, 262,
                                                               256)
    backbone = cfg["backbone"]
    assert model.backbone.with_cp == bool(backbone.get("with_cp", False))
    if "dconv" in name:
        assert backbone["with_cp"] and backbone["type"] in ("ResNeXt",
                                                            "Res2Net")
    assert sum(p.numel() for p in model.head.parameters()) > 0


def _narrow_resnext(with_cp):
    return ResNet(depth=50, block_type="resnext", groups=4, base_width=4,
                  stage_with_dcn=(False, True, True, True), frozen_stages=1,
                  with_cp=with_cp)


def _loss_and_grads(model, image, probe):
    outs = model(image, TRAIN_SAMPLING)
    loss = sum((o * p).sum() for o, p in zip(outs, probe))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(
        loss, [p for p in model.parameters() if p.requires_grad])
    return loss.detach(), dict(zip(names, grads))


def test_with_cp_gives_the_same_loss_and_gradients():
    torch.manual_seed(0)
    ref = _narrow_resnext(False).train()
    cp = _narrow_resnext(True).train()
    cp.load_state_dict(ref.state_dict())
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.randn(2, 3, 64, 96).astype(np.float32))
    with torch.no_grad():
        shapes = [o.shape for o in ref(image, TRAIN_SAMPLING)]
    probe = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in shapes]

    calls = []
    hook = cp.layer2_0.register_forward_pre_hook(lambda *_: calls.append(1))
    want_loss, want = _loss_and_grads(ref, image, probe)
    got_loss, got = _loss_and_grads(cp, image, probe)
    assert len(calls) == 2          # the forward, and its recompute
    hook.remove()

    assert abs(got_loss.item() - want_loss.item()) <= 1e-6 * max(
        1.0, abs(want_loss.item()))
    assert got.keys() == want.keys() and len(want) > 0
    for name, g in want.items():
        lim = 1e-6 * max(1.0, g.abs().max().item())
        assert (got[name] - g).abs().max().item() <= lim, name


def test_with_cp_is_off_without_gradients_or_training():
    model = _narrow_resnext(True)
    calls = []
    model.layer3_0.register_forward_pre_hook(lambda *_: calls.append(1))
    image = torch.randn(1, 3, 32, 32)
    with torch.no_grad():
        model.train()(image)
    model.eval()
    model(image)[-1].sum().backward()
    assert len(calls) == 2          # once per forward, no recompute


def test_with_cp_under_the_mixed_precision_train_step():
    """bf16 compute over f32 masters (the runner's default) with
    ``with_cp``: the blocks recomputed in the backward see the same bf16
    copies as the forward (they saw the f32 masters before, and the first
    convolution raised on the bf16 input), so one update equals the update
    without ``with_cp``."""
    from lsnet_torch.apis import init_model, train_detector_step
    from lsnet_torch.configs import x101_flagship_cfg
    from lsnet_torch.core.loss import LossConfig

    rng = np.random.RandomState(0)
    H, W = 64, 96
    xy = rng.rand(2, 3, 2) * 40
    batch = {
        "image": torch.from_numpy(rng.randn(2, H, W, 3).astype(np.float32)),
        "pad_shape": torch.tensor([[H, W]] * 2, dtype=torch.int32),
        "gt_bboxes": torch.from_numpy(np.concatenate(
            [xy, xy + 12 + rng.rand(2, 3, 2) * 30], -1).astype(np.float32)),
        "gt_labels": torch.from_numpy(rng.randint(0, 3, (2, 3))),
        "gt_valid": torch.ones(2, 3, dtype=torch.bool)}
    out = []
    for with_cp in (False, True):
        cfg = x101_flagship_cfg(feat=32, stacked=1)
        cfg["backbone"].update(depth=50, groups=8, with_cp=with_cp)
        cfg["bbox_head"]["num_classes"] = 3
        model = init_model(cfg, device="cpu", seed=0, train=True)
        step = train_detector_step(
            model, LossConfig(image_shape=(H, W), num_classes=3),
            steps_per_epoch=1)
        metrics = step(batch)
        out.append((metrics["loss"].item(),
                    {n: p.detach().clone()
                     for n, p in model.named_parameters()}))
    (loss, want), (loss_cp, got) = out
    assert loss_cp == loss
    for n, w in want.items():
        assert torch.equal(got[n], w), n


# ------------------------------------------------------------ RepPoints

RP_CONFIGS = sorted(
    os.path.relpath(p, os.path.join(REPO, "configs")) for d in (
        "reppoints", "dense_reppoints")
    for p in glob.glob(os.path.join(REPO, "configs", d, "*.py")))


def test_every_reppoints_config_is_listed():
    """Three RepPoints files (moment, minmax, v2) and two Dense RepPoints
    files (v1, v2)."""
    assert len(RP_CONFIGS) == 5
    assert sum(n.startswith("dense_reppoints/") for n in RP_CONFIGS) == 2


@pytest.mark.parametrize("name", RP_CONFIGS)
def test_reppoints_config_loader_reads_the_same(name):
    path = os.path.join(REPO, "configs", name)
    assert PConfig.fromfile(path).to_dict() == Config.fromfile(
        path).to_dict()


@pytest.mark.parametrize("name", RP_CONFIGS)
def test_reppoints_config_builds_with_the_jax_head_parameters(name):
    """``build_detector`` on the ``meta`` device; the head's state dict
    has the keys and shapes ``from_jax_variables`` makes of the JAX
    head's parameters (``eval_shape`` of its init at the full width)."""
    import jax
    import jax.numpy as jnp
    from lsnet_tpu.models import build_head as j_build_head
    from lsnet_torch.weights import from_jax_variables
    cfg = Config.fromfile(os.path.join(REPO, "configs", name))
    model_cfg = cfg.to_dict()["model"]
    with torch.device("meta"):
        model = build_detector(model_cfg)
    assert type(model.head).__name__ == model_cfg["bbox_head"]["type"]
    jhead, _ = j_build_head(dict(model_cfg["bbox_head"]))
    feats = [jnp.zeros((1, s, s, 256)) for s in (4, 2, 2, 1, 1)]
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0),
                                               feats))
    want = {k: tuple(v.shape) for k, v in from_jax_variables(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in model.head.state_dict().items()}
    assert got == want
    if "v2" in name and not name.startswith("dense"):
        # the paired gather reads C = 256 + 6 corner channels
        assert model.head.cls_refine_dcn.weight_a.shape == (3, 3, 262, 256)
    if name.startswith("dense"):
        assert model.head.num_points == 729


@pytest.mark.parametrize("name", RP_CONFIGS)
def test_reppoints_runner_configs_match_the_jax_runner(name):
    """The loss config (the RepPoints or Dense RepPoints config of
    ``make_loss_for``), the test config and the pipeline's
    ``num_vectors`` equal the JAX runner's field by field."""
    path = os.path.join(REPO, "configs", name)
    jcfg, pcfg = Config.fromfile(path), PConfig.fromfile(path)
    canvas = (800, 1344)
    dense = name.startswith("dense")
    want = (jloop.dense_reppoints_cfg_from if dense
            else jloop.reppoints_cfg_from)(jcfg, canvas)
    got = ploop.train_loss_cfg(pcfg, canvas)
    # v2's config is a subclass of its own (the train step's loss table
    # tells v2 from v1 by it); the JAX runner picks the loss by head type
    assert type(got).__name__.replace("V2", "") == type(want).__name__
    assert ("V2" in type(got).__name__) == ("v2" in name)
    for f in want.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    want = jloop.test_cfg_from(jcfg, canvas)
    got = ploop.test_cfg_from(pcfg, canvas)
    for f in got.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert ploop.head_num_vectors(pcfg) == jloop._head_num_vectors(
        jcfg, jcfg.model.bbox_head)


# ------------------------------------------------------------ dense zoo

DENSE_CONFIGS = ["retinanet/retinanet_r50_fpn_1x_coco.py",
                 "guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py",
                 "guided_anchoring/ga_rpn_r50_fpn_1x_coco.py",
                 "fcos/fcos_r50_fpn_1x_coco.py",
                 "atss/atss_r50_fpn_1x_coco.py",
                 "gfl/gfl_r50_fpn_1x_coco.py",
                 "foveabox/fovea_r50_fpn_4x4_1x_coco.py",
                 "fsaf/fsaf_r50_fpn_1x_coco.py",
                 "free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py",
                 "pisa/pisa_retinanet_r50_fpn_1x_coco.py",
                 "ssd/ssd300_coco.py", "pisa/pisa_ssd300_coco.py",
                 "nas_fcos/nas_fcos_fcoshead_r50_fpn_1x_coco.py"]
# the files whose backbone or neck is not ResNet + FPN: SSD's VGG-16 with
# no neck, NAS-FCOS's searched FPN
OWN_BODY = {"ssd/ssd300_coco.py": (300, 300),
            "pisa/pisa_ssd300_coco.py": (300, 300),
            "nas_fcos/nas_fcos_fcoshead_r50_fpn_1x_coco.py": (128, 192)}
SSD_LEVELS = ((4, 512), (2, 1024), (2, 512), (1, 256), (1, 256), (1, 256))
# files the port still refuses (the two-stage family), by the ROADMAP
# entry it names
REFUSED = ["faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py",
           "mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py",
           "cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py"]


@pytest.mark.parametrize("name", DENSE_CONFIGS)
def test_dense_config_builds_with_the_jax_head_parameters(name):
    """The thirteen dense-zoo files read the same with both loaders, pass
    ``check_runnable``, and build on the ``meta`` device with a head whose
    state dict has the keys and shapes of the JAX head's parameters
    (``eval_shape`` at full width, on the file's levels: SSD's six of
    VGG-16's widths); for SSD and NAS-FCOS the whole detector's state dict
    has the keys and shapes of the JAX detector's variables."""
    import jax
    import jax.numpy as jnp
    from lsnet_tpu.models import build_head as j_build_head
    from lsnet_torch.weights import from_jax_variables
    path = os.path.join(REPO, "configs", name)
    assert PConfig.fromfile(path).to_dict() == Config.fromfile(
        path).to_dict()
    ploop.check_runnable(PConfig.fromfile(path))
    model_cfg = Config.fromfile(path).to_dict()["model"]
    with torch.device("meta"):
        model = build_detector(model_cfg)
    kind = head_cfg_of(model_cfg)["type"]
    # FreeAnchor and PISA build the plain RetinaNet and SSD head modules
    assert type(model.head).__name__ == {
        "FreeAnchorRetinaHead": "RetinaHead", "PISARetinaHead": "RetinaHead",
        "PISASSDHead": "SSDHead"}.get(kind, kind)
    jhead, _ = j_build_head(dict(head_cfg_of(model_cfg)))
    feats = [jnp.zeros((1, s, s, c)) for s, c in (
        SSD_LEVELS if "ssd" in name else
        [(s, 256) for s in (4, 2, 2, 1, 1)])]
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0),
                                               feats))
    want = {k: tuple(v.shape) for k, v in from_jax_variables(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in model.head.state_dict().items()}
    assert got == want
    if name in OWN_BODY:
        from lsnet_tpu.models import build_detector as j_build_detector
        jdet, _ = j_build_detector(dict(model_cfg))
        shapes = jax.eval_shape(lambda: jdet.init(
            jax.random.PRNGKey(0), jnp.zeros((1, *OWN_BODY[name], 3))))
        want = {k: tuple(v.shape) for k, v in from_jax_variables(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         shapes)).items()}
        assert {k: tuple(v.shape) for k, v in
                model.state_dict().items()} == want
        return
    # the neck's extra levels: convs on the input, on the output (FCOS)
    # or, with none named (GA-RPN), the subsampled last output
    extra = model_cfg["neck"].get("add_extra_convs")
    assert model.neck.add_extra_convs == extra
    assert hasattr(model.neck, "extra_0") == (extra is not None)
    if extra == "on_output":
        assert model.neck.extra_0.conv.weight.shape[1] == 256


@pytest.mark.parametrize("name", REFUSED)
def test_rest_of_the_zoo_is_refused_with_its_roadmap_entry(name):
    cfg = PConfig.fromfile(os.path.join(REPO, "configs", name))
    with pytest.raises(NotImplementedError,
                       match="ROADMAP Queue 1 \"Inherited zoo\""):
        ploop.check_runnable(cfg)


def test_fpn_extra_levels_match_jax():
    """The FPN's ``add_extra_convs`` None (GA-RPN's file) and 'on_output'
    (FCOS's) against the JAX FPN on the same minted weights: 1e-4 of
    max(1, max|ref|)."""
    import jax
    import jax.numpy as jnp
    from lsnet_tpu.models.necks.fpn import FPN as JFPN
    from lsnet_torch.models.necks.fpn import FPN
    from lsnet_torch.weights import load_jax_variables
    from torch_port_util import assert_close, mint_variables
    rng = np.random.RandomState(6)
    chans = [8, 16, 32, 64]
    shapes = [(26, 42), (13, 21), (7, 11), (4, 6)]
    xs = [rng.randn(1, h, w, c).astype(np.float32)
          for (h, w), c in zip(shapes, chans)]
    for kw in (dict(add_extra_convs=None, start_level=0),
               dict(add_extra_convs="on_output", start_level=1)):
        kw.update(out_channels=16, num_outs=6)
        jmod = JFPN(**kw)
        v = mint_variables(jmod, [jnp.asarray(x) for x in xs], seed=4)
        want = jax.jit(jmod.apply)(jax.tree.map(jnp.asarray, v),
                                   [jnp.asarray(x) for x in xs])
        tmod = FPN(in_channels=chans, **kw)
        load_jax_variables(tmod, v)
        with torch.no_grad():
            got = tmod([torch.from_numpy(x).permute(0, 3, 1, 2)
                        for x in xs])
        assert len(got) == len(want) == 6
        for g, w_ in zip(got, want):
            assert_close(g.permute(0, 2, 3, 1), np.asarray(w_))
