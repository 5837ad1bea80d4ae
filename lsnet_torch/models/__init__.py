"""Model builders (counterpart of ``lsnet_tpu/models/__init__.py``): config
dicts with a ``type`` key -> ``nn.Module``s. The port builds the backbones
ResNet, ResNeXt, Res2Net and SSDVGG, the necks FPN, NASFCOS_FPN and none
(SSD's ``neck=None``, an identity), the heads LSHead (all four tasks),
LSCPVHead, the RepPoints family's four (RepPointsHead, RepPointsV2Head,
DenseRepPointsHead, DenseRepPointsV2Head) and the dense zoo's RetinaHead,
RetinaSepBNHead, FreeAnchorRetinaHead and PISARetinaHead (RetinaHead
modules), FCOSHead, ATSSHead, GFLHead, SSDHead and PISASSDHead (an
SSDHead), FoveaHead, FSAFHead, GARetinaHead and GARPNHead, and their
single-stage detectors, each an ``LSDetector`` (backbone -> neck ->
head), as in the JAX package; the standalone ``RPN`` reads its head from
``rpn_head``. The two-stage family is ROADMAP Queue 1 "Inherited zoo"."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from torch import nn

from .backbones.extra import SSDVGG
from .backbones.resnet import ResNet
from .detectors.lsnet import LSDetector
from .heads.dense import (ATSSHead, FCOSHead, FoveaHead, FSAFHead,
                          GARetinaHead, GARPNHead, GFLHead, RetinaHead,
                          RetinaSepBNHead, SSDHead)
from .heads.dense_reppoints import DenseRepPointsHead, DenseRepPointsV2Head
from .heads.ls_head import LSHead
from .heads.lscpv_head import LSCPVHead
from .heads.reppoints import RepPointsHead, RepPointsV2Head
from .necks.extra import NASFCOSFPN
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
    block_type = {"ResNet": "resnet", "ResNeXt": "resnext",
                  "Res2Net": "res2net"}.get(kind)
    if block_type is None:
        raise NotImplementedError(f"backbone {kind}")
    if kind == "Res2Net":
        cfg.setdefault("base_width", 26)
        cfg.setdefault("deep_stem", True)   # res2net101_v1d pretrain layout
    for k in ("pretrained", "norm_cfg", "norm_eval", "style",
              "zero_init_residual"):
        cfg.pop(k, None)     # BN is always FrozenBatchNorm; pytorch style
    if cfg.pop("dcn", None) is not None and "stage_with_dcn" not in cfg:
        cfg["stage_with_dcn"] = (False, True, True, True)
    return ResNet(block_type=block_type, **cfg)


def build_neck(cfg: Optional[Dict[str, Any]], in_channels: Sequence[int]
               ) -> nn.Module:
    """FPN or NASFCOS_FPN on the backbone's widths; ``None`` (SSD's) is
    the identity."""
    if cfg is None:
        return nn.Identity()
    cfg = dict(cfg)
    kind = cfg.pop("type")
    cfg.pop("in_channels", None)     # taken from the backbone
    if kind == "FPN":
        return FPN(in_channels=list(in_channels), **cfg)
    if kind in ("NASFCOS_FPN", "NASFCOSFPN"):
        for k in ("add_extra_convs", "conv_cfg"):
            cfg.pop(k, None)
        return NASFCOSFPN(in_channels=list(in_channels), **cfg)
    raise NotImplementedError(f"neck {kind}")


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
    """A ``model`` config's head: its ``bbox_head``, or an ``RPN``'s
    ``rpn_head`` ({} where there is none)."""
    return model_cfg.get("rpn_head" if model_cfg.get("type") == "RPN"
                         else "bbox_head", {})


def build_detector(cfg: Dict[str, Any]) -> LSDetector:
    """Build the detector from a full ``model`` config dict."""
    if cfg["type"] not in DETECTORS:
        raise NotImplementedError(f"detector {cfg['type']}")
    backbone = build_backbone(cfg["backbone"])
    neck = build_neck(cfg.get("neck"), backbone.out_channels)
    return LSDetector(backbone, neck, build_head(head_cfg_of(cfg)))


def is_cpv(model: nn.Module) -> bool:
    """Whether the detector carries the CPV head."""
    return isinstance(getattr(model, "head", None), LSCPVHead)
