"""The loader of reference weights (``lsnet_torch.train.checkpoint``
``convert_torch_backbone`` / ``_neck`` / ``_lshead`` and
``load_pretrained_backbone``) against the JAX package's.

* Round trip: port modules at narrow width, their entries minted from a
  seed, are written in the reference's key names
  (``torch_port_util.reference_state_dict``), go through the JAX
  converters and ``weights.from_jax_variables``, and come back equal bit
  for bit; the port's own converters give the same dict. R50, a narrow
  ResNeXt (G = 4) with DCN in c3-c5, the FPN, and the norm-tower LSHead of
  the four tasks.
* What must raise: an unknown backbone, neck or head key, a shape
  mismatch, a key of a module the model lacks (a Res2Net key into R50).
* The runner with ``model.pretrained`` a minted torchvision-keyed file:
  the backbone it starts from equals JAX's ``load_pretrained_backbone``
  on the same file, carried across by ``weights.from_jax_variables``.
"""

import pytest
import torch

from lsnet_tpu.train import checkpoint as jckpt
from lsnet_torch.models import build_detector
from lsnet_torch.models.backbones.resnet import ResNet
from lsnet_torch.models.heads.ls_head import LSHead
from lsnet_torch.models.necks.fpn import FPN
from lsnet_torch.tools import accuracy_run
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train import checkpoint as pckpt
from lsnet_torch.train import hooks as phooks
from lsnet_torch.train.loop import train_detector
from lsnet_torch.weights import from_jax_variables, to_jax_variables
from torch_port_util import mint_module_, reference_state_dict

torch.set_num_threads(1)

NV = {"bbox": 4, "segm": 36, "pose_bbox": 17, "pose_kbox": 17}
DCN_C3_C5 = (False, True, True, True)


def _backbone(kind):
    if kind == "R50":
        return ResNet(depth=50)
    if kind == "Res2Net-v1d-DCN":
        return ResNet(depth=50, block_type="res2net", base_channels=16,
                      base_width=8, deep_stem=True,
                      stage_with_dcn=DCN_C3_C5)
    return ResNet(depth=50, block_type="resnext", groups=4, base_width=4,
                  stage_with_dcn=DCN_C3_C5)


def _head(task):
    return LSHead(num_classes=3, in_channels=32, feat_channels=32,
                  point_feat_channels=32, stacked_convs=2, task=task,
                  num_vectors=NV[task], norm_groups=8)


def _assert_same(got, want):
    assert set(got) == set(want), (sorted(set(got) ^ set(want))[:6])
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


MODULES = [("backbone", "R50"), ("backbone", "ResNeXt-G4-DCN"),
           ("backbone", "Res2Net-v1d-DCN"), ("neck", "FPN")] + [("head", t) for t in sorted(NV)]


@pytest.mark.parametrize("part,kind", MODULES,
                         ids=[k for _, k in MODULES])
def test_round_trip(part, kind):
    """port -> reference keys -> JAX converter -> from_jax_variables is
    the identity; the port's converter gives the same fragment."""
    if part == "backbone":
        module = _backbone(kind)
    elif part == "neck":
        module = FPN([256, 512, 1024, 2048], out_channels=32, num_outs=5,
                     start_level=1, add_extra_convs="on_input",
                     norm_cfg=dict(type="GN", num_groups=8))
    else:
        module = _head(kind)
    mint_module_(module, seed=len(kind))
    want = module.state_dict()
    prefix = {"backbone": "backbone.", "neck": "neck.",
              "head": "bbox_head."}[part]
    ref = reference_state_dict(module, prefix)
    if part == "backbone":
        params, stats = jckpt.convert_torch_backbone(ref)
        tree = {"params": params, "batch_stats": stats}
        ours = pckpt.convert_torch_backbone(ref)
    elif part == "neck":
        tree = {"params": jckpt.convert_torch_neck(ref)}
        ours = pckpt.convert_torch_neck(ref)
    else:
        tree = {"params": jckpt.convert_torch_lshead(ref, task=kind)}
        ours = pckpt.convert_torch_lshead(ref, task=kind)
    _assert_same(from_jax_variables(tree), want)
    _assert_same(ours, want)
    module.load_state_dict(ours, strict=True)


def _save(tmp_path, sd, name="w.pth"):
    path = str(tmp_path / name)
    torch.save(sd, path)
    return path


class _Detector(torch.nn.Module):
    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def _reference_r50(prefix=""):
    return reference_state_dict(mint_module_(ResNet(depth=50)), prefix)


@pytest.mark.parametrize("case", ["unknown_backbone_key", "unknown_neck_key",
                                  "unknown_head_key", "shape_mismatch",
                                  "missing_leaf", "res2net"])
def test_refused(tmp_path, case):
    if case == "unknown_backbone_key":
        sd = {**_reference_r50("backbone."),
              "backbone.attn.proj.weight": torch.zeros(4),
              "backbone.layer1.0.bn1.running_std": torch.zeros(64)}
        with pytest.raises(ValueError, match="attn.proj.weight.*"
                           "layer1.0.bn1.running_std"):
            pckpt.convert_torch_backbone(sd)
    elif case == "unknown_neck_key":
        with pytest.raises(ValueError, match="neck"):
            pckpt.convert_torch_neck({"neck.top_down.0.weight":
                                      torch.zeros(2)})
    elif case == "unknown_head_key":
        ref = reference_state_dict(_head("bbox"), "bbox_head.")
        ref["bbox_head.reppoints_cls_conv.weight"] = torch.zeros(3)
        with pytest.raises(ValueError, match="reppoints_cls_conv"):
            pckpt.convert_torch_lshead(ref, task="bbox")
    elif case == "shape_mismatch":
        sd = _reference_r50()
        sd["layer1.0.conv1.weight"] = torch.zeros(64, 64, 3, 3)
        path = _save(tmp_path, sd)
        with pytest.raises(ValueError, match="shape mismatch at "
                           "backbone.layer1_0.conv1.weight"):
            pckpt.load_pretrained_backbone(_Detector(ResNet(depth=50)), path)
    elif case == "missing_leaf":
        path = _save(tmp_path, _reference_r50())
        with pytest.raises(KeyError, match="layer4_0.conv1.weight"):
            pckpt.load_pretrained_backbone(
                _Detector(ResNet(depth=50, num_stages=3)), path)
    else:
        # Res2Net keys load (tests/test_torch_res2net.py), but not into a
        # model without those modules
        sd = {**_reference_r50(),
              "layer1.0.convs.0.weight": torch.zeros(26, 26, 3, 3),
              "stem.0.weight": torch.zeros(32, 3, 3, 3)}
        frag = pckpt.convert_torch_backbone(sd)
        assert frag["layer1_0.conv2_0.weight"].shape == (26, 26, 3, 3)
        assert frag["stem_conv1.weight"].shape == (32, 3, 3, 3)
        with pytest.raises(KeyError, match="layer1_0.conv2_0.weight"):
            pckpt.load_pretrained_backbone(_Detector(ResNet(depth=50)),
                                           _save(tmp_path, sd))


def test_imagenet_file_into_dcn_stages(tmp_path):
    """An ImageNet file has no ``conv_offset`` for the DCN stages of the
    model it starts. As in the JAX loader, such a ``convN.weight`` is not
    taken for a DCN pack's weight: ``load_pretrained_backbone`` raises
    and leaves the model as it was (no partial load)."""
    plain = mint_module_(ResNet(depth=50, block_type="resnext", groups=4,
                                base_width=4), seed=3)
    sd = {**reference_state_dict(plain), "fc.weight": torch.zeros(10, 2048),
          "fc.bias": torch.zeros(10),
          "bn1.num_batches_tracked": torch.tensor(5)}
    dcn = _backbone("ResNeXt-G4-DCN")
    before = {k: v.clone() for k, v in dcn.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch at backbone.layer"
                       r"\d+_\d+\.conv2\.weight"):
        pckpt.load_pretrained_backbone(_Detector(dcn),
                                       _save(tmp_path, {"state_dict": sd}))
    for k, v in dcn.state_dict().items():
        assert torch.equal(v, before[k]), k


@phooks.HOOKS.register_module()
class StartingBackboneHook(phooks.Hook):
    """The backbone a run starts from; the run stops after one step."""
    state = {}

    def before_train(self, ctx):
        StartingBackboneHook.state = {
            k: v.detach().clone()
            for k, v in ctx.model.backbone.state_dict().items()}

    def after_iter(self, ctx):
        ctx.should_stop = True


def test_runner_reads_pretrained(tmp_path):
    """``train_detector`` with ``model.pretrained``: a torchvision-keyed
    R18 file (with ``fc.*`` and ``num_batches_tracked``) for the
    accuracy tool's R18 model. The backbone the run starts from equals
    JAX's ``load_pretrained_backbone`` on the same file, laid over the
    port's init and carried back by ``from_jax_variables``."""
    ann, img = make_shapes_coco(str(tmp_path / "data"), 2, seed=0)
    args = accuracy_run.parse_args(["--task", "bbox", "--epochs", "1",
                                    "--train", "2", "--batch", "2"])
    cfg = accuracy_run.accuracy_cfg(args, ann, img, ann, img)
    source = mint_module_(build_detector(cfg.model.to_dict()).backbone,
                          seed=7)
    sd = {**reference_state_dict(source),
          "fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000),
          "layer1.0.bn1.num_batches_tracked": torch.tensor(3)}
    path = _save(tmp_path, sd, "resnet18.pth")
    cfg.model.pretrained = path
    cfg.custom_hooks = [dict(type="StartingBackboneHook")]
    out = train_detector(cfg, str(tmp_path / "work"), total_epochs=1,
                         eval_interval=10 ** 9, device="cpu")
    assert out["step"] == 1
    got = StartingBackboneHook.state

    # JAX: the same file over the same init (the port's init, carried to
    # flax names; only the loaded backbone entries are compared)
    init = build_detector(cfg.model.to_dict())
    from lsnet_torch.models.init import init_weights_
    init_weights_(init, torch.Generator().manual_seed(cfg.seed))
    jvars = jckpt.load_pretrained_backbone(to_jax_variables(init), path)
    want = from_jax_variables({
        "params": jvars["params"]["backbone"],
        "batch_stats": jvars["batch_stats"]["backbone"]})
    _assert_same(got, want)
    _assert_same(got, source.state_dict())


def test_loader_reads_mmdet_detector_dict(tmp_path):
    """A full mmdet detector checkpoint (``module.`` and ``backbone.``
    prefixes, neck and head keys beside, under ``state_dict`` with a
    ``meta``): the backbone loads, skipping the neck and head keys; the
    neck converter skips the backbone and head keys; the head converter
    reads the ``bbox_head.`` keys."""
    backbone = mint_module_(_backbone("ResNeXt-G4-DCN"), seed=1)
    neck = mint_module_(FPN(backbone.out_channels, out_channels=32,
                            num_outs=5, start_level=1,
                            add_extra_convs="on_input",
                            norm_cfg=dict(type="GN", num_groups=8)), seed=2)
    head = mint_module_(_head("segm"), seed=4)
    sd = {"module." + k: v for k, v in {
        **reference_state_dict(backbone, "backbone."),
        **reference_state_dict(neck, "neck."),
        **reference_state_dict(head, "bbox_head.")}.items()}
    path = _save(tmp_path, {"meta": {"epoch": 12}, "state_dict": sd})
    target = _Detector(_backbone("ResNeXt-G4-DCN"))
    pckpt.load_pretrained_backbone(target, path)
    _assert_same(target.backbone.state_dict(), backbone.state_dict())
    _assert_same(pckpt.convert_torch_neck(sd), neck.state_dict())
    head_sd = {k: v for k, v in sd.items() if ".bbox_head." in k}
    _assert_same(pckpt.convert_torch_lshead(head_sd, task="segm"),
                 head.state_dict())
