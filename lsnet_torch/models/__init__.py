"""Model builders (counterpart of ``lsnet_tpu/models/__init__.py``): config
dicts with a ``type`` key -> ``nn.Module``s. The port builds every type
the JAX package's builders name: the backbones ResNet, ResNeXt, Res2Net,
SSDVGG, DetectoRS' ResNet and ResNeXt (SAC stages), HRNet, RegNet,
HourglassNet and MobileNetV2; the necks FPN, PAFPN, BFP, NASFPN,
NASFCOS_FPN, HRFPN, FPN_CARAFE, RFP and none (SSD's ``neck=None``, an
identity); the heads LSHead (all four tasks), LSCPVHead, the RepPoints
family's four (RepPointsHead, RepPointsV2Head, DenseRepPointsHead,
DenseRepPointsV2Head) and the dense zoo's RetinaHead, RetinaSepBNHead,
FreeAnchorRetinaHead and PISARetinaHead (RetinaHead modules), FCOSHead,
ATSSHead, GFLHead, SSDHead and PISASSDHead (an SSDHead), FoveaHead,
FSAFHead, GARetinaHead and GARPNHead, and their single-stage detectors,
each an ``LSDetector`` (backbone -> neck -> head), as in the JAX package;
the standalone ``RPN`` reads its head from ``rpn_head``. Of the two-stage
family: Faster R-CNN (``FasterRCNN`` / ``TwoStageDetector``, with the
Shared2FC head, or with the Double-Head RoI head where ``roi_head.type``
is ``DoubleHeadRoIHead``), ``FastRCNN``, the mask branch's ``MaskRCNN``,
``MaskScoringRCNN`` and ``PointRend``, and ``CascadeRCNN`` (DetectoRS
too), ``GridRCNN`` and ``HybridTaskCascade`` / ``HTC``. Each backbone
has ``out_channels``, the widths ``build_neck`` gives the neck. BFP
builds, as in JAX, from one neck dict: Libra R-CNN's ``[FPN, BFP]``
neck list does not (JAX's ``build_neck`` takes one dict)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from .backbones.extra import SSDVGG, HourglassNet, RegNet
from .backbones.hrnet import HRNet
from .backbones.mobilenet import MobileNetV2
from .backbones.resnet import ResNet
from .detectors.lsnet import LSDetector
from .heads.dense import (ATSSHead, FCOSHead, FoveaHead, FSAFHead,
                          GARetinaHead, GARPNHead, GFLHead, RetinaHead,
                          RetinaSepBNHead, SSDHead)
from .heads.dense_reppoints import DenseRepPointsHead, DenseRepPointsV2Head
from .heads.ls_head import LSHead
from .heads.lscpv_head import LSCPVHead
from .heads.reppoints import RepPointsHead, RepPointsV2Head
from .heads.two_stage import (CascadeRCNNDetector, DoubleConvFCBBoxHead,
                              DoubleHeadRCNNDetector, FastRCNNDetector,
                              FCNMaskHead, FusedSemanticHead, GridHead,
                              GridRCNNDetector, HTCDetector, HTCMaskHead,
                              MaskIoUHead, MaskPointHead, MaskRCNNDetector,
                              MaskScoringRCNNDetector, PointRendDetector,
                              RPNHead, Shared2FCBBoxHead, TwoStageDetector)
from .necks.extra import (BFP, HRFPN, NASFCOSFPN, NASFPN, PAFPN, RFP,
                          FPNCarafe)
from .necks.fpn import FPN

# the single-stage detector types and heads the port builds; as in the JAX
# package, any of the types assembles backbone -> FPN -> whichever head
# the config gives (the shipped RepPoints v2 file keeps RepPointsDetector)
DETECTORS = ("LSDetector", "LSCPVDetector", "RepPointsDetector",
             "RepPointsV2Detector", "DenseRepPointsDetector",
             "DenseRepPointsV2Detector", "RetinaNet", "FCOS", "ATSS", "GFL",
             "SSD", "FOVEA", "FoveaBox", "FSAF", "FreeAnchor", "NASFCOS",
             "SingleStageDetector", "RPN")
# the dense zoo's heads by config type (FreeAnchor and PISA build the plain
# RetinaNet and SSD modules; their losses differ)
DENSE_KINDS = {"RetinaHead": RetinaHead, "RetinaSepBNHead": RetinaSepBNHead,
               "FreeAnchorRetinaHead": RetinaHead,
               "PISARetinaHead": RetinaHead, "FCOSHead": FCOSHead,
               "ATSSHead": ATSSHead, "GFLHead": GFLHead, "SSDHead": SSDHead,
               "PISASSDHead": SSDHead, "FoveaHead": FoveaHead,
               "FSAFHead": FSAFHead}
# the two-stage detector types the port builds: HTC's names, and the
# types whose decodes give masks
HTC = ("HybridTaskCascade", "HTC")
MASK_TYPES = ("MaskRCNN", "MaskScoringRCNN", "PointRend") + HTC
TWO_STAGE = ("FasterRCNN", "TwoStageDetector", "FastRCNN", "CascadeRCNN",
             "GridRCNN") + MASK_TYPES
# the backbone and neck types the port builds (None: SSD's identity neck)
RESNET_KINDS = {"ResNet": "resnet", "ResNeXt": "resnext",
                "Res2Net": "res2net", "DetectoRS_ResNet": "resnet",
                "DetectoRSResNet": "resnet", "DetectoRS_ResNeXt": "resnext",
                "DetectoRSResNeXt": "resnext"}
# the other backbones, and the keys JAX's build_backbone drops for each
# (``with_cp`` first becomes JAX's ``remat``, which none of them reads)
ZOO_BACKBONES = {
    "HRNet": (HRNet, ("num_stages", "stage_with_dcn", "strides",
                      "dilations", "out_indices", "groups", "base_width",
                      "scales")),
    "RegNet": (RegNet, ("num_stages", "stage_with_dcn", "strides",
                        "dilations")),
    "HourglassNet": (HourglassNet, ("num_stages", "stage_with_dcn",
                                    "strides", "dilations", "out_indices")),
    "MobileNetV2": (MobileNetV2, ("num_stages", "stage_with_dcn", "strides",
                                  "dilations"))}
BACKBONES = ("SSDVGG",) + tuple(RESNET_KINDS) + tuple(ZOO_BACKBONES)
# the necks by config type, and the keys JAX's build_neck drops for each
# (None, SSD's, is the identity)
NECK_KINDS = {
    "FPN": (FPN, ()), "PAFPN": (PAFPN, ()), "BFP": (BFP, ()),
    "NASFPN": (NASFPN, ("add_extra_convs",)),
    "NASFCOS_FPN": (NASFCOSFPN, ("add_extra_convs", "conv_cfg")),
    "NASFCOSFPN": (NASFCOSFPN, ("add_extra_convs", "conv_cfg")),
    "HRFPN": (HRFPN, ()),
    "FPN_CARAFE": (FPNCarafe, ("upsample_cfg", "order")),
    "FPNCarafe": (FPNCarafe, ("upsample_cfg", "order")),
    "RFP": (RFP, ("rfp_backbone", "aspp_out_channels", "aspp_dilations",
                  "add_extra_convs"))}
NECKS = (None,) + tuple(NECK_KINDS)
HEADS = ("LSHead", "LSCPVHead", "RepPointsHead", "RepPointsV2Head",
         "DenseRepPointsHead", "DenseRepPointsV2Head", "GARetinaHead",
         "GARPNHead") + tuple(DENSE_KINDS)
# the dense zoo's settings that the loss and decode read, not the module
DENSE_SETTINGS = ("anchor_generator", "bbox_coder", "train_cfg", "test_cfg",
                  "strides", "regress_ranges", "norm_groups",
                  "centerness_on_reg", "center_sampling", "norm_on_bbox",
                  "centerness_branch", "base_edge_list", "scale_ranges",
                  "sigma", "background_label", "reg_decoded_bbox")
# FreeAnchor's bag settings (the loss's)
FREE_ANCHOR_SETTINGS = ("pre_anchor_topk", "bbox_thr", "gamma", "alpha")
# SSD300's anchor ratios a level: A_l = 2 + 2 * len(ratios)
SSD_RATIOS = ([2], [2, 3], [2, 3], [2, 3], [2], [2])
SSD_IN_CHANNELS = (512, 1024, 512, 256, 256, 256)
GA_SETTINGS = ("approx_anchor_generator", "square_anchor_generator",
               "anchor_coder", "bbox_coder", "loc_filter_thr", "train_cfg",
               "test_cfg", "deform_groups")


def build_backbone(cfg: Dict[str, Any]) -> nn.Module:
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind == "SSDVGG":
        # input_size is the anchors' (the loss reads it); JAX's
        # build_backbone drops l2_norm_scale
        return SSDVGG(depth=cfg.get("depth", 16))
    for k in ("pretrained", "norm_cfg", "norm_eval", "style",
              "zero_init_residual"):
        cfg.pop(k, None)     # BN is always FrozenBatchNorm; pytorch style
    if cfg.pop("dcn", None) is not None and "stage_with_dcn" not in cfg:
        cfg["stage_with_dcn"] = (False, True, True, True)
    if cfg.pop("sac", None) is not None and "stage_with_sac" not in cfg:
        cfg["stage_with_sac"] = (False, True, True, True)
    if kind in ZOO_BACKBONES:
        cls, dropped = ZOO_BACKBONES[kind]
        for k in dropped + ("with_cp",):
            cfg.pop(k, None)
        return cls(**cfg)
    block_type = RESNET_KINDS.get(kind)
    if block_type is None:
        raise NotImplementedError(
            f"backbone {kind}: the port builds {', '.join(BACKBONES)}, "
            "every type the JAX package's build_backbone names")
    if kind == "Res2Net":
        cfg.setdefault("base_width", 26)
        cfg.setdefault("deep_stem", True)   # res2net101_v1d pretrain layout
    if kind.startswith("DetectoRS"):
        # ConvAWS on the other convs, the image input and the RFP widths
        # are not read, as in the JAX package (ROADMAP Queue 3)
        for k in ("conv_cfg", "output_img", "rfp_inplanes"):
            cfg.pop(k, None)
    return ResNet(block_type=block_type, **cfg)


def build_neck(cfg: Optional[Dict[str, Any]], in_channels: Sequence[int]
               ) -> nn.Module:
    """A neck on the backbone's widths; ``None`` (SSD's) is the identity.
    The keys JAX's ``build_neck`` drops are dropped: NASFPN's and
    NASFCOS_FPN's ``add_extra_convs``, FPN_CARAFE's ``upsample_cfg`` and
    ``order`` (its CARAFE settings are the module's defaults), RFP's
    ``rfp_backbone`` and ASPP settings (it unrolls the recursion at the
    neck)."""
    if cfg is None:
        return nn.Identity()
    cfg = dict(cfg)
    kind = cfg.pop("type")
    cfg.pop("in_channels", None)     # taken from the backbone
    if kind not in NECK_KINDS:
        raise NotImplementedError(
            f"neck {kind}: the port builds {', '.join(map(str, NECKS))}, "
            "every type the JAX package's build_neck names")
    cls, dropped = NECK_KINDS[kind]
    for k in dropped:
        cfg.pop(k, None)
    return cls(in_channels=list(in_channels), **cfg)


def build_head(cfg: Dict[str, Any]) -> nn.Module:
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in HEADS:
        raise NotImplementedError(f"head {kind}")
    # losses and the point layout are read by training and decode
    for k in [k for k in cfg if k.startswith("loss_")] + [
            "point_strides", "point_base_scale"]:
        cfg.pop(k, None)
    norm_cfg = cfg.pop("norm_cfg", None)
    if norm_cfg is not None:
        cfg["norm_groups"] = norm_cfg.get("num_groups", 32)
    if kind in ("DenseRepPointsHead", "DenseRepPointsV2Head"):
        for k in ("train_cfg", "test_cfg", "transform_method",
                  "sample_padding_mode", "use_grid_points", "center_init"):
            cfg.pop(k, None)
        cls_h = (DenseRepPointsHead if kind == "DenseRepPointsHead"
                 else DenseRepPointsV2Head)
        return cls_h(**cfg)
    if kind in ("RepPointsHead", "RepPointsV2Head"):
        for k in ("use_grid_points", "center_init", "train_cfg",
                  "test_cfg"):
            cfg.pop(k, None)
        cls_h = RepPointsHead if kind == "RepPointsHead" else RepPointsV2Head
        return cls_h(**cfg)
    if kind == "GARetinaHead":
        for k in GA_SETTINGS:
            cfg.pop(k, None)
        return GARetinaHead(**cfg)
    if kind == "GARPNHead":          # binary objectness: no classes
        for k in GA_SETTINGS + ("num_classes",):
            cfg.pop(k, None)
        return GARPNHead(**cfg)
    if kind in DENSE_KINDS:
        return _dense_head(kind, cfg)
    if cfg.pop("fuse_towers", False):
        raise NotImplementedError("fuse_towers is a TPU layout option")
    if kind == "LSHead":
        return LSHead(**cfg)
    for k in ("use_grid_points", "center_init"):
        cfg.pop(k, None)
    if "num_points" in cfg:
        cfg["num_kernel_points"] = cfg.pop("num_points")
    return LSCPVHead(**cfg)


def _dense_head(kind: str, cfg: Dict[str, Any]) -> nn.Module:
    """A dense-zoo head from its config (the JAX ``build_head``'s key
    translation): the anchor generator sets RetinaHead's and
    RetinaSepBNHead's anchors a cell (FreeAnchor's and PISA's keep 9) and
    SSD's per level; FCOSHead keeps ``strides`` and
    ``centerness_on_reg``; FreeAnchor keeps its GroupNorm towers
    (``norm_groups``); the other settings are the loss's and decode's."""
    norm_groups = cfg.get("norm_groups")
    taken = {k: cfg.pop(k) for k in DENSE_SETTINGS + FREE_ANCHOR_SETTINGS
             if k in cfg}
    ag = taken.get("anchor_generator")
    if kind in ("RetinaHead", "RetinaSepBNHead") and ag is not None:
        cfg["num_base_anchors"] = (len(ag.get("ratios", [0.5, 1, 2]))
                                   * ag.get("scales_per_octave", 3))
    if kind == "FreeAnchorRetinaHead" and norm_groups is not None:
        cfg["norm_groups"] = norm_groups
    if kind in ("SSDHead", "PISASSDHead"):
        cfg["in_channels"] = tuple(cfg.get("in_channels", SSD_IN_CHANNELS))
        if ag is not None:
            # the ratio-1 anchors at both scales + each ratio's pair
            cfg["num_base_anchors"] = tuple(
                2 + 2 * len(r) for r in ag.get("ratios", SSD_RATIOS))
    if kind == "FCOSHead":
        if taken.get("strides") is not None:
            cfg["strides"] = tuple(taken["strides"])
        if taken.get("centerness_on_reg") is not None:
            cfg["centerness_on_reg"] = taken["centerness_on_reg"]
    return DENSE_KINDS[kind](**cfg)


def head_cfg_of(model_cfg) -> Dict[str, Any]:
    """A ``model`` config's head: its ``bbox_head``, a two-stage
    detector's ``roi_head.bbox_head`` (the first stage's of a list), or an
    ``RPN``'s ``rpn_head`` ({} where there is none), as the JAX runner's
    ``_head_cfg``."""
    if model_cfg.get("type") == "RPN":
        return model_cfg.get("rpn_head", {})
    head = model_cfg.get("bbox_head",
                         (model_cfg.get("roi_head") or {}).get("bbox_head",
                                                               {}))
    if isinstance(head, (list, tuple)):
        head = head[0] if head else {}
    return head


def is_two_stage(model: nn.Module) -> bool:
    """Whether the detector is of the two-stage family."""
    return isinstance(model, FastRCNNDetector)


def _two_stage(cfg: Dict[str, Any], backbone: nn.Module,
               neck: nn.Module) -> nn.Module:
    """A two-stage detector as the JAX ``build_detector`` reads it: the
    RPN's anchors a cell from its anchor generator, the bbox head's widths
    from ``roi_head.bbox_head`` (a cascade's first stage), the mask head's
    convs from ``roi_head.mask_head`` (``num_convs``,
    ``conv_out_channels``), the grid head's from ``roi_head.grid_head``;
    the MaskIoU head, the point head and HTC's semantic head keep their
    defaults (JAX builds them from ``num_classes`` alone, the semantic
    head at the neck's width); a cascade's three heads are
    class-agnostic whatever the file says; the RoI features have the
    neck's width."""
    kind = cfg["type"]
    rpn_cfg = dict(cfg.get("rpn_head") or {})
    ag = rpn_cfg.get("anchor_generator") or {}
    n_base = (len(ag.get("ratios", [0.5, 1.0, 2.0]))
              * len(ag.get("scales", [8])))
    roi_cfg = dict(cfg.get("roi_head") or {})
    bh = head_cfg_of(cfg)
    num_classes = bh.get("num_classes", 80)
    neck_cfg = cfg.get("neck") or {}
    width = neck_cfg.get("out_channels", 256)
    agnostic = bh.get("reg_class_agnostic", False)

    def shared2fc(agnostic=agnostic):
        return Shared2FCBBoxHead(
            num_classes=num_classes, in_channels=width,
            fc_channels=bh.get("fc_out_channels", 1024),
            reg_class_agnostic=agnostic)
    if roi_cfg.get("type") == "DoubleHeadRoIHead":
        bbox_head = DoubleConvFCBBoxHead(
            num_classes=num_classes, in_channels=width,
            num_convs=bh.get("num_convs", 4), num_fcs=bh.get("num_fcs", 2),
            conv_channels=bh.get("conv_out_channels", 1024),
            fc_channels=bh.get("fc_out_channels", 1024),
            reg_class_agnostic=agnostic)
    elif kind in ("CascadeRCNN",) + HTC:
        bbox_head = shared2fc(agnostic=True)
    else:
        bbox_head = shared2fc()
    if kind == "FastRCNN":
        return FastRCNNDetector(backbone, neck, bbox_head)
    rpn = RPNHead(num_base_anchors=n_base, **{
        k: v for k, v in rpn_cfg.items()
        if k in ("in_channels", "feat_channels")})
    if roi_cfg.get("type") == "DoubleHeadRoIHead":
        return DoubleHeadRCNNDetector(
            backbone, neck, rpn, bbox_head,
            reg_roi_scale_factor=roi_cfg.get("reg_roi_scale_factor", 1.3))
    if kind == "CascadeRCNN":
        return CascadeRCNNDetector(backbone, neck, rpn, bbox_head,
                                   shared2fc(True), shared2fc(True))
    if kind == "GridRCNN":
        gh = roi_cfg.get("grid_head") or {}
        return GridRCNNDetector(backbone, neck, rpn, bbox_head, GridHead(
            in_channels=width, grid_points=gh.get("grid_points", 9),
            num_convs=gh.get("num_convs", 8),
            point_feat_channels=gh.get("point_feat_channels", 64)))
    if kind not in MASK_TYPES:
        return TwoStageDetector(backbone, neck, rpn, bbox_head)
    mh = roi_cfg.get("mask_head") or {}
    mask_kw = dict(num_classes=num_classes, in_channels=width,
                   conv_channels=mh.get("conv_out_channels", 256),
                   num_convs=mh.get("num_convs", 4))
    if kind in HTC:
        return HTCDetector(
            backbone, neck, rpn,
            (bbox_head, shared2fc(True), shared2fc(True)),
            [HTCMaskHead(**mask_kw, with_res=st > 0) for st in range(3)],
            FusedSemanticHead(num_classes, in_channels=width,
                              num_levels=neck_cfg.get("num_outs", 5),
                              conv_channels=width))
    mask_head = FCNMaskHead(**mask_kw)
    if kind == "MaskScoringRCNN":
        return MaskScoringRCNNDetector(
            backbone, neck, rpn, bbox_head, mask_head,
            MaskIoUHead(num_classes=num_classes, in_channels=width))
    if kind == "PointRend":
        return PointRendDetector(
            backbone, neck, rpn, bbox_head, mask_head,
            MaskPointHead(num_classes=num_classes, in_channels=width))
    return MaskRCNNDetector(backbone, neck, rpn, bbox_head, mask_head)


def build_detector(cfg: Dict[str, Any]) -> nn.Module:
    """Build the detector from a full ``model`` config dict."""
    kind = cfg["type"]
    if kind not in DETECTORS + TWO_STAGE:
        raise NotImplementedError(
            f"detector {kind}: the port builds {', '.join(DETECTORS)} and "
            f"{', '.join(TWO_STAGE)}, every type the JAX package's "
            "build_detector builds")
    backbone = build_backbone(cfg["backbone"])
    neck = build_neck(cfg.get("neck"), backbone.out_channels)
    if kind in TWO_STAGE:
        return _two_stage(cfg, backbone, neck)
    return LSDetector(backbone, neck, build_head(head_cfg_of(cfg)))


def is_cpv(model: nn.Module) -> bool:
    """Whether the detector carries the CPV head."""
    return isinstance(getattr(model, "head", None), LSCPVHead)
