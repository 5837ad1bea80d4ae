"""Model builders (counterpart of ``lsnet_tpu/models/__init__.py``): config
dicts with a ``type`` key -> ``nn.Module``s. The port builds ResNet,
ResNeXt, Res2Net, FPN, LSHead (all four tasks), LSCPVHead, the RepPoints
family's four heads (RepPointsHead, RepPointsV2Head, DenseRepPointsHead,
DenseRepPointsV2Head), the dense zoo's RetinaHead, FCOSHead, ATSSHead,
GFLHead, GARetinaHead and GARPNHead, and their single-stage detectors,
each an ``LSDetector`` (backbone -> FPN -> head), as in the JAX package;
the standalone ``RPN`` reads its head from ``rpn_head``."""

from __future__ import annotations

from typing import Any, Dict, Sequence

from torch import nn

from .backbones.resnet import ResNet
from .detectors.lsnet import LSDetector
from .heads.dense import (ATSSHead, FCOSHead, GARetinaHead, GARPNHead,
                          GFLHead, RetinaHead)
from .heads.dense_reppoints import DenseRepPointsHead, DenseRepPointsV2Head
from .heads.ls_head import LSHead
from .heads.lscpv_head import LSCPVHead
from .heads.reppoints import RepPointsHead, RepPointsV2Head
from .necks.fpn import FPN

# the single-stage detector types and heads the port builds; as in the JAX
# package, any of the types assembles backbone -> FPN -> whichever head
# the config gives (the shipped RepPoints v2 file keeps RepPointsDetector)
DETECTORS = ("LSDetector", "LSCPVDetector", "RepPointsDetector",
             "RepPointsV2Detector", "DenseRepPointsDetector",
             "DenseRepPointsV2Detector", "RetinaNet", "FCOS", "ATSS", "GFL",
             "RPN")
HEADS = ("LSHead", "LSCPVHead", "RepPointsHead", "RepPointsV2Head",
         "DenseRepPointsHead", "DenseRepPointsV2Head", "RetinaHead",
         "FCOSHead", "ATSSHead", "GFLHead", "GARetinaHead", "GARPNHead")
# the dense zoo's settings that the loss and decode read, not the module
DENSE_SETTINGS = ("anchor_generator", "bbox_coder", "train_cfg", "test_cfg",
                  "strides", "regress_ranges", "norm_groups",
                  "centerness_on_reg", "center_sampling", "norm_on_bbox",
                  "centerness_branch", "background_label",
                  "reg_decoded_bbox")
GA_SETTINGS = ("approx_anchor_generator", "square_anchor_generator",
               "anchor_coder", "bbox_coder", "loc_filter_thr", "train_cfg",
               "test_cfg", "deform_groups")


def build_backbone(cfg: Dict[str, Any]) -> ResNet:
    cfg = dict(cfg)
    kind = cfg.pop("type")
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


def build_neck(cfg: Dict[str, Any], in_channels: Sequence[int]) -> FPN:
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind != "FPN":
        raise NotImplementedError(f"neck {kind}")
    cfg.pop("in_channels", None)     # taken from the backbone
    return FPN(in_channels=list(in_channels), **cfg)


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
    if kind in ("RetinaHead", "FCOSHead", "ATSSHead", "GFLHead"):
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
    """RetinaHead / FCOSHead / ATSSHead / GFLHead from a head config (the
    JAX ``build_head``'s key translation): the anchor generator sets
    RetinaHead's anchors a cell; FCOSHead keeps ``strides`` and
    ``centerness_on_reg``; the other settings are the loss's and
    decode's."""
    taken = {k: cfg.pop(k) for k in DENSE_SETTINGS if k in cfg}
    ag = taken.get("anchor_generator")
    if kind == "RetinaHead" and ag is not None:
        cfg["num_base_anchors"] = (len(ag.get("ratios", [0.5, 1, 2]))
                                   * ag.get("scales_per_octave", 3))
    if kind == "FCOSHead":
        if taken.get("strides") is not None:
            cfg["strides"] = tuple(taken["strides"])
        if taken.get("centerness_on_reg") is not None:
            cfg["centerness_on_reg"] = taken["centerness_on_reg"]
    return {"RetinaHead": RetinaHead, "FCOSHead": FCOSHead,
            "ATSSHead": ATSSHead, "GFLHead": GFLHead}[kind](**cfg)


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
    neck = build_neck(cfg["neck"], backbone.out_channels)
    return LSDetector(backbone, neck, build_head(head_cfg_of(cfg)))


def is_cpv(model: nn.Module) -> bool:
    """Whether the detector carries the CPV head."""
    return isinstance(getattr(model, "head", None), LSCPVHead)
