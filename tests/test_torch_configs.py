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
SSD300, PISA SSD300, NAS-FCOS) read the same and build the same way, and
so do the ten two-stage files the port runs (Faster R-CNN, Double-Head,
Dynamic R-CNN, Mask R-CNN, Mask Scoring R-CNN, PointRend, Cascade R-CNN,
Grid R-CNN, HTC, DetectoRS), against the whole JAX detector's variables;
the mask and cascade files' runner settings equal the JAX runner's, and
the settings it leaves unread are recorded. Every shipped file now runs,
and so do the backbones and necks that no file uses (ROADMAP Queue 1
"Inherited zoo" item 3.4's model half): their five published
compositions (``lsnet_torch.configs``) and the Faster R-CNN file on
MobileNetV2, HourglassNet-104 or BFP pass ``check_runnable`` and build
on the ``meta`` device.
The six pose files pass ``check_runnable``: their ``CocoPoseDataset`` is
the COCO dataset of ``data.extra``.

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
# the rest of the zoo (ROADMAP Queue 1 "Inherited zoo" item 3.4's model
# half): a backbone or neck type, by case, and the config that carries it:
# a composition of ``lsnet_torch.configs``, or, for the three without one
# that JAX's builder can serve (CornerNet's head, SSDLite's neck and
# Libra R-CNN's neck list are not in JAX), the shipped Faster R-CNN file
# with the module's full-width settings
FASTER = "faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py"
REFUSED = {"regnet_backbone": ("retinanet_regnetx_3.2gf", "backbone",
                               "RegNet"),
           "pafpn_neck": ("faster_rcnn_r50_pafpn", "neck", "PAFPN"),
           "hrnet_backbone": ("faster_rcnn_hrnetv2p_w32", "backbone",
                              "HRNet")}
LATER = {"mobilenet_backbone": (FASTER, "backbone", dict(
             type="MobileNetV2", widen_factor=1.0, out_indices=(1, 2, 4, 6))),
         "hourglass_backbone": (FASTER, "backbone", dict(
             type="HourglassNet")),
         "bfp_neck": (FASTER, "neck", dict(type="BFP", in_channels=256,
                                           out_channels=256,
                                           refine_level=2,
                                           refine_type="conv")),
         "nasfpn_neck": ("retinanet_r50_nasfpn", "neck", "NASFPN")}
# the cascade family's files, by the port's detector class
CASCADE_FILES = {
    "cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py": "CascadeRCNNDetector",
    "grid_rcnn/grid_rcnn_r50_fpn_gn-head_2x_coco.py": "GridRCNNDetector",
    "htc/htc_r50_fpn_1x_coco.py": "HTCDetector",
    "detectors/detectors_cascade_rcnn_r50_1x_coco.py":
        "CascadeRCNNDetector"}
# the mask files, by the port's detector class
MASK_FILES = {"mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py": "MaskRCNNDetector",
              "ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py": "MaskScoringRCNNDetector",
              "point_rend/point_rend_r50_caffe_fpn_1x_coco.py":
                  "PointRendDetector"}
# the two-stage files the port runs
TWO_STAGE = ["faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py",
             "double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py",
             "dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py"] + list(
                 MASK_FILES) + list(CASCADE_FILES)


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


def _later_cfg(case):
    """The config of one case of the rest of the zoo: a composition, or
    the Faster R-CNN file with its backbone or neck replaced whole."""
    from lsnet_torch import configs
    base, key, kind = {**REFUSED, **LATER}[case]
    if base in configs.COMPOSITIONS:
        cfg = configs.COMPOSITIONS[base]()
        assert cfg.model[key].type == kind
        return cfg
    cfg = PConfig.fromfile(os.path.join(REPO, "configs", base))
    cfg.merge_from_dict({f"model.{key}": dict(kind, _delete_=True)})
    return cfg


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_rest_of_the_zoo_is_refused_with_its_roadmap_entry(name):
    """A RegNet or HRNet backbone, a PAFPN neck, each in its published
    composition (``lsnet_torch.configs``): ``check_runnable`` admits it
    (no ROADMAP entry is named: the model half of Queue 1 "Inherited zoo"
    item 3.4 is ported) and ``build_detector`` builds it on the ``meta``
    device with the backbone's widths (RegNetX-3.2GF's 96 to 1008,
    HRNetV2p-W32's 32 to 256) and the neck's type."""
    from lsnet_torch.models import NECK_KINDS, ZOO_BACKBONES
    cfg = _later_cfg(name)
    ploop.check_runnable(cfg)
    with torch.device("meta"):
        model = build_detector(cfg.model.to_dict())
    _, key, kind = REFUSED[name]
    built = {**ZOO_BACKBONES, **NECK_KINDS}[kind][0]
    assert type(getattr(model, key)).__name__ == built.__name__
    assert model.backbone.out_channels == {
        "regnet_backbone": [96, 192, 432, 1008],
        "hrnet_backbone": [32, 64, 128, 256]}.get(
            name, [256, 512, 1024, 2048])


@pytest.mark.parametrize("name", sorted(LATER))
def test_two_stage_files_name_their_queue_item(name):
    """A two-stage file on MobileNetV2 (1.0, outputs 1, 2, 4, 6),
    HourglassNet-104 or BFP, and the NAS-FPN RetinaNet composition:
    ``check_runnable`` admits each and ``build_detector`` builds it on
    the ``meta`` device."""
    cfg = _later_cfg(name)
    ploop.check_runnable(cfg)
    with torch.device("meta"):
        model = build_detector(cfg.model.to_dict())
    assert {"mobilenet_backbone": [24, 32, 96, 320],
            "hourglass_backbone": [256, 256]}.get(
        name, [256, 512, 1024, 2048]) == model.backbone.out_channels


@pytest.mark.parametrize("name", [n for n in CONFIGS if "pose" in n])
def test_pose_files_are_runnable(name):
    """The six pose files: their ``CocoPoseDataset`` is a dataset the
    port reads (``data.extra.DATASET_TYPES``), so ``check_runnable``
    passes, and the train set the runner builds is a person-only
    ``CocoDataset``."""
    from lsnet_torch.data.coco import CocoDataset
    from lsnet_torch.data.extra import DATASET_TYPES
    cfg = PConfig.fromfile(_path(name))
    assert cfg.data.train.type == cfg.data.val.type == "CocoPoseDataset"
    assert DATASET_TYPES["CocoPoseDataset"] is CocoDataset
    ploop.check_runnable(cfg)
    assert ploop.data_task(cfg, "train") == "pose"


@pytest.mark.parametrize("name", TWO_STAGE)
def test_two_stage_file_builds_with_the_jax_detector_variables(name):
    """The ten two-stage files read the same with both loaders, pass
    ``check_runnable`` and build on the ``meta`` device a detector whose
    state dict has the keys and shapes of the JAX detector's variables
    (``eval_shape`` at full width on a 64x64 image): the R50 backbone
    (DetectoRS': its SAC stages), the FPN (DetectoRS' RFP), the RPN, the
    Shared2FC or Double-Head RoI head (the cascades' three), and the
    mask, MaskIoU, point, grid, semantic and HTC mask heads (the
    transposed convolutions' kernels laid out by their rule)."""
    import jax
    import jax.numpy as jnp
    from lsnet_tpu.models import build_detector as j_build_detector
    from lsnet_torch.weights import from_jax_variables
    path = os.path.join(REPO, "configs", name)
    assert PConfig.fromfile(path).to_dict() == Config.fromfile(
        path).to_dict()
    ploop.check_runnable(PConfig.fromfile(path))
    model_cfg = Config.fromfile(path).to_dict()["model"]
    with torch.device("meta"):
        model = build_detector(model_cfg)
    jdet, _ = j_build_detector(dict(model_cfg))
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 64, 64, 3))))
    want = {k: tuple(v.shape) for k, v in from_jax_variables(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == want
    assert type(model).__name__ == {**MASK_FILES, **CASCADE_FILES}.get(
        name, ("DoubleHeadRCNNDetector" if "double" in name
               else "TwoStageDetector"))


@pytest.mark.parametrize("name", sorted(MASK_FILES))
def test_file_settings_match_the_jax_runner(name):
    """The mask files' runner settings (``two_stage_cfg_from``,
    ``test_cfg_from``, the pipeline's task and contour length) equal the
    JAX runner's, field by field, and the settings that the JAX runner
    leaves unread or reads otherwise than mmdet, which the port follows:

    * the mask extractor's RoIAlign ``sampling_ratio=0`` is dropped: it
      samples 2 x 2 a bin, at 14 x 14;
    * the mask head runs on every sampled RoI and the loss on the
      positives (mmdet runs it on the positives: the same loss);
    * mask targets are rasterised from the segm pipeline's 36-point
      contours (mmdet crops GT masks);
    * MS R-CNN: the file has no ``mask_iou_head``; the MaskIoU head keeps
      JAX's fixed widths (256 convs, 1024 FCs), its IoU targets come from
      the 28 x 28 grids (mmdet's from area ratios), the loss weight is a
      fixed 0.5;
    * PointRend: the mask head is ``FCNMaskHead`` (the reference's is a
      ``CoarseMaskHead``); it trains on the 196 most uncertain points,
      chosen deterministically (the reference oversamples at random), and
      decodes in 2 subdivision steps of 784 points to 112 x 112;
    * the paste threshold is a fixed 0.5 (the file sets no
      ``mask_thr_binary``);
    * ``optimizer_config.grad_clip=None``: the JAX runner raises
      ``AttributeError`` on it; the port clips at 35 (ROADMAP Queue 3).
    """
    import dataclasses
    import inspect
    from lsnet_torch.core import two_stage as pts
    from lsnet_torch.evalkit.evaluator import paste_mask
    from lsnet_torch.ops.roi import multilevel_roi_align
    path = os.path.join(REPO, "configs", name)
    pc, jc = PConfig.fromfile(path), Config.fromfile(path)
    assert pc.to_dict() == jc.to_dict()
    ploop.check_runnable(pc)
    for hw in ((800, 1344), (1344, 800)):
        assert dataclasses.asdict(ploop.two_stage_cfg_from(pc, hw)) == \
            dataclasses.asdict(jloop.two_stage_cfg_from(jc, hw))
        assert dataclasses.asdict(ploop.test_cfg_from(pc, hw)) == \
            dataclasses.asdict(jloop.test_cfg_from(jc, hw))
    head = jloop._head_cfg(jc)
    assert ploop.head_num_vectors(pc) == jloop._head_num_vectors(jc, head) \
        == 36
    assert ploop.data_task(pc, "train") == "segm"
    assert ploop.data_task(pc, "val") == "bbox"
    roi = pc.model.roi_head
    assert roi.mask_roi_extractor.roi_layer.sampling_ratio == 0
    assert roi.mask_roi_extractor.roi_layer.output_size == 14
    assert inspect.signature(multilevel_roi_align).parameters[
        "sampling_ratio"].default == 2
    assert "mask_iou_head" not in roi and "point_head" not in roi
    assert roi.mask_head.type == "FCNMaskHead"
    with torch.device("meta"):
        model = build_detector(pc.model.to_dict())
    assert type(model).__name__ == MASK_FILES[name]
    assert type(model.mask_head).__name__ == "FCNMaskHead"
    if name.startswith("ms_rcnn"):
        iou = model.maskiou_head
        assert (iou.maskiou_conv0.out_channels, iou.maskiou_fc0.out_features
                ) == (256, 1024)
    defaults = {k: v.default for k, v in inspect.signature(
        pts.point_rend_decode).parameters.items()}
    assert (defaults["subdivision_steps"], defaults["num_points"]) == (2, 784)
    assert inspect.signature(pts.point_rend_loss).parameters[
        "num_points"].default == 196
    assert "mask_thr_binary" not in pc.test_cfg.rcnn
    assert inspect.signature(paste_mask).parameters["thr"].default == 0.5
    assert pc.optimizer_config.grad_clip is None
    with pytest.raises(AttributeError):
        jc.get("optimizer_config", {}).get("grad_clip", {}).get(
            "max_norm", 35.0)
    assert ploop.clip_norm_from(pc) == 35.0


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


@pytest.mark.parametrize("name", sorted(CASCADE_FILES))
def test_cascade_file_settings_match_the_jax_runner(name):
    """The cascade family's runner settings (``two_stage_cfg_from``, a
    cascade file's from its first stage, ``test_cfg_from``, the
    pipeline's task and contour length) equal the JAX runner's, field by
    field, and the settings that the JAX runner leaves unread, which the
    port follows:

    * Cascade R-CNN and DetectoRS: the stages' IoUs, loss weights and
      stds are the fixed ``CASCADE_IOUS`` / ``CASCADE_WEIGHTS`` /
      ``CASCADE_STDS`` (equal to the file's), the heads class-agnostic,
      their SmoothL1 at beta 1 (``rcnn_loss``'s);
    * DetectoRS: ``conv_cfg=ConvAWS`` is dropped (the bottlenecks' other
      convs are plain ``nn.Conv2d``), the SAC's ``use_deform`` too (its two
      convs are plain, no offsets), and RFP's ``rfp_backbone`` and ASPP
      (the recursion is unrolled at the neck, two FPNs and a gate);
    * Grid R-CNN: the grid loss weight is a fixed 15 (no ``loss_grid`` in
      the file);
    * HTC: the file is Mask R-CNN's with ``type='HybridTaskCascade'``;
      the three stages and the semantic branch are fixed (its targets are
      the GT boxes' class maps, weight 0.2: a detection set has no
      COCO-stuff maps), the mask heads ``HTCMaskHead``s;
    * ``optimizer_config.grad_clip=None``: the JAX runner raises
      ``AttributeError`` on it; the port clips at 35 (ROADMAP Queue 3).
    """
    import dataclasses
    import inspect
    from lsnet_torch.core import two_stage as pts
    path = os.path.join(REPO, "configs", name)
    pc, jc = PConfig.fromfile(path), Config.fromfile(path)
    assert pc.to_dict() == jc.to_dict()
    ploop.check_runnable(pc)
    for hw in ((800, 1344), (1344, 800)):
        assert dataclasses.asdict(ploop.two_stage_cfg_from(pc, hw)) == \
            dataclasses.asdict(jloop.two_stage_cfg_from(jc, hw))
        assert dataclasses.asdict(ploop.test_cfg_from(pc, hw)) == \
            dataclasses.asdict(jloop.test_cfg_from(jc, hw))
    htc = name.startswith("htc")
    head = jloop._head_cfg(jc)
    assert ploop.head_num_vectors(pc) == jloop._head_num_vectors(jc, head) \
        == (36 if htc else 4)
    assert ploop.data_task(pc, "train") == ("segm" if htc else "bbox")
    with torch.device("meta"):
        model = build_detector(pc.model.to_dict())
    assert type(model).__name__ == CASCADE_FILES[name]
    roi = pc.model.roi_head
    if isinstance(roi.bbox_head, (list, tuple)):
        assert [r.assigner.pos_iou_thr for r in pc.train_cfg.rcnn] == \
            list(pts.CASCADE_IOUS)
        assert tuple(roi.stage_loss_weights) == pts.CASCADE_WEIGHTS
        assert [tuple(h.bbox_coder.target_stds) for h in roi.bbox_head] \
            == list(pts.CASCADE_STDS)
        assert all(h.reg_class_agnostic and h.loss_bbox.beta == 1.0
                   for h in roi.bbox_head)
        assert inspect.signature(pts.rcnn_loss).parameters[
            "smoothl1_beta"].default == 1.0
    if name.startswith("detectors"):
        from lsnet_torch.models.layers import SAConv
        bb, neck = pc.model.backbone, pc.model.neck
        assert bb.conv_cfg.type == "ConvAWS" and bb.sac.use_deform
        assert isinstance(model.backbone.layer1_0.conv2, torch.nn.Conv2d)
        sac = model.backbone.layer2_0.conv2
        assert isinstance(sac, SAConv) and not hasattr(sac, "conv_offset")
        assert "rfp_backbone" in neck and neck.rfp_steps == 2
        assert not any("aspp" in n for n, _ in model.neck.named_modules())
        assert hasattr(model.neck, "fpn_step1") and not hasattr(
            model.neck, "fpn_step2")
    if name.startswith("grid"):
        assert "loss_grid" not in roi.grid_head
        assert inspect.signature(pts.grid_rcnn_loss).parameters[
            "loss_weight"].default == 15.0
        assert model.grid_head.G == roi.grid_head.grid_points == 9
    if htc:
        assert roi.type == "StandardRoIHead" and roi.mask_head.type == \
            "FCNMaskHead"
        assert "semantic_head" not in roi
        assert inspect.signature(pts.htc_loss).parameters[
            "sem_loss_weight"].default == 0.2
        assert type(model.mask_head3).__name__ == "HTCMaskHead"
        assert not hasattr(model.mask_head1, "conv_res")
    assert pc.optimizer_config.grad_clip is None
    with pytest.raises(AttributeError):
        jc.get("optimizer_config", {}).get("grad_clip", {}).get(
            "max_norm", 35.0)
    assert ploop.clip_norm_from(pc) == 35.0
