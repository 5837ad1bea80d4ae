"""The dense-head zoo (counterpart of ``lsnet_tpu/models/heads/dense.py``):
RetinaNet, FCOS, ATSS and GFL, and the two Guided Anchoring heads,
GA-RPN and GA-RetinaNet.

Forward only: NCHW levels in, a dict of per-level NHWC maps out, like the
JAX heads; the losses are :mod:`lsnet_torch.core.dense_loss`'s and the
decodes :mod:`lsnet_torch.core.dense_decode`'s.

The Guided Anchoring heads adapt their features with a mask-free 3x3
deformable conv whose offsets come from a 1x1 conv on the *detached*
shape prediction (JAX's ``stop_gradient``): one
:func:`~lsnet_torch.ops.flat_deform.multilevel_modulated_dcn` over all
levels per branch at sampling site ``"tower"``, scale 1, stride 1, so one
K1 (``deform_gather_contract``) launch per branch and forward, and in
training one of each backward kernel. The offset gradient K1 gives
reaches the ``adaption_offset*`` convs and stops there. GA-RetinaNet
computes its post-adaption convs densely, as JAX does (the reference's
``masked_conv`` only skips cells the location mask gates at decode).

Submodule names are the flax names: the towers are flax's auto-named
``_Tower_0`` (cls) and ``_Tower_1`` (reg) with ``cls_conv{i}`` /
``cls_conv{i}_gn``; the per-level ``scales`` of FCOS, ATSS and GFL and
the adaption weights (HWIO (3, 3, feat, feat)) are raw parameters.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING, multilevel_modulated_dcn
from ..layers import nchw, nhwc

Maps = Dict[str, List[torch.Tensor]]


def conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class Tower(nn.Module):
    """``convs`` x (3x3 conv, GroupNorm(32) where ``use_gn``, ReLU), named
    ``{prefix}{i}`` and ``{prefix}{i}_gn``."""

    def __init__(self, convs: int, cin: int, channels: int, use_gn: bool,
                 prefix: str):
        super().__init__()
        self.convs, self.prefix, self.use_gn = convs, prefix, use_gn
        for i in range(convs):
            setattr(self, f"{prefix}{i}", conv3(cin if i == 0 else channels,
                                                 channels))
            if use_gn:
                # flax's GroupNorm default epsilon
                setattr(self, f"{prefix}{i}_gn",
                        nn.GroupNorm(32, channels, eps=1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.convs):
            x = getattr(self, f"{self.prefix}{i}")(x)
            if self.use_gn:
                x = getattr(self, f"{self.prefix}{i}_gn")(x)
            x = F.relu(x)
        return x


class _TwoTowers(nn.Module):
    """The cls and reg towers every head of the zoo shares."""

    def __init__(self, in_channels: int, feat_channels: int,
                 stacked_convs: int, use_gn: bool):
        super().__init__()
        self._Tower_0 = Tower(stacked_convs, in_channels, feat_channels,
                               use_gn, "cls_conv")
        self._Tower_1 = Tower(stacked_convs, in_channels, feat_channels,
                               use_gn, "reg_conv")

    def towers(self, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._Tower_0(f), self._Tower_1(f)


class RetinaHead(_TwoTowers):
    """Anchor-based focal-loss head, A anchors a cell, plain towers.
    ``forward`` -> ``cls`` (A * num_classes) and ``reg`` (A * 4)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_base_anchors: int = 9):
        super().__init__(in_channels, feat_channels, stacked_convs, False)
        self.retina_cls = conv3(feat_channels,
                                 num_base_anchors * num_classes)
        self.retina_reg = conv3(feat_channels, num_base_anchors * 4)

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING) -> Maps:
        outs: Maps = {"cls": [], "reg": []}
        for f in feats:
            cf, rf = self.towers(f)
            outs["cls"].append(nhwc(self.retina_cls(cf)))
            outs["reg"].append(nhwc(self.retina_reg(rf)))
        return outs


class ScaledHead(_TwoTowers):
    """GroupNorm towers, a cls conv and a reg conv scaled by a learnable
    per-level ``scales`` (the reference ``Scale``), applied in the maps'
    dtype as in JAX."""

    prefix = ""

    def __init__(self, num_classes: int, in_channels: int, feat_channels: int,
                 stacked_convs: int, reg_channels: int, num_levels: int = 5):
        super().__init__(in_channels, feat_channels, stacked_convs, True)
        setattr(self, f"{self.prefix}_cls", conv3(feat_channels,
                                                   num_classes))
        setattr(self, f"{self.prefix}_reg", conv3(feat_channels,
                                                   reg_channels))
        self.scales = nn.Parameter(torch.ones(num_levels))

    def _level(self, i: int, f: torch.Tensor, outs: Maps
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Append level ``i``'s ``cls`` and ``reg`` maps; -> its towers'
        (cls, reg) features."""
        cf, rf = self.towers(f)
        outs["cls"].append(nhwc(getattr(self, f"{self.prefix}_cls")(cf)))
        reg = getattr(self, f"{self.prefix}_reg")(rf) * self.scales[i].to(
            f.dtype)
        outs["reg"].append(nhwc(self._reg_map(reg)))
        return cf, rf

    @staticmethod
    def _reg_map(reg: torch.Tensor) -> torch.Tensor:
        return reg

    def _check_levels(self, feats: Sequence[torch.Tensor]) -> None:
        if len(feats) != self.scales.shape[0]:
            raise ValueError(f"{type(self).__name__}: {len(feats)} levels, "
                             f"scales for {self.scales.shape[0]}")


class FCOSHead(ScaledHead):
    """Anchor-free per-point head: ``cls``, positive (l, t, r, b)
    distances ``reg`` = exp(scale * conv) in stride units and
    ``centerness`` (on the cls tower unless ``centerness_on_reg``).
    ``strides`` are the loss's and decode's; the module reads none."""

    prefix = "fcos"

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Tuple[int, ...] = (8, 16, 32, 64, 128),
                 centerness_on_reg: bool = False):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, 4, len(strides))
        self.fcos_centerness = conv3(feat_channels, 1)
        self.centerness_on_reg = centerness_on_reg

    @staticmethod
    def _reg_map(reg: torch.Tensor) -> torch.Tensor:
        return torch.exp(reg)

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING) -> Maps:
        self._check_levels(feats)
        outs: Maps = {"cls": [], "reg": [], "centerness": []}
        for i, f in enumerate(feats):
            cf, rf = self._level(i, f, outs)
            outs["centerness"].append(nhwc(self.fcos_centerness(
                rf if self.centerness_on_reg else cf)))
        return outs


class ATSSHead(ScaledHead):
    """One square anchor a cell: ``cls``, ``reg`` deltas scaled per level
    and ``centerness`` on the reg tower."""

    prefix = "atss"

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, 4)
        self.atss_centerness = conv3(feat_channels, 1)

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING) -> Maps:
        self._check_levels(feats)
        outs: Maps = {"cls": [], "reg": [], "centerness": []}
        for i, f in enumerate(feats):
            _, rf = self._level(i, f, outs)
            outs["centerness"].append(nhwc(self.atss_centerness(rf)))
        return outs


class GFLHead(ScaledHead):
    """Generalized Focal Loss head: the joint quality-classification
    ``cls`` and the discretized box distribution ``reg``, 4 sides x
    (reg_max + 1) logits, scaled per level."""

    prefix = "gfl"

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 reg_max: int = 16):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, 4 * (reg_max + 1))
        self.reg_max = reg_max

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING) -> Maps:
        self._check_levels(feats)
        outs: Maps = {"cls": [], "reg": []}
        for i, f in enumerate(feats):
            self._level(i, f, outs)
        return outs


def _adaption_weight(channels: int) -> nn.Parameter:
    """A feature adaption's 3x3 deformable weight, HWIO."""
    return nn.Parameter(torch.zeros(3, 3, channels, channels))


def _adapt(feats: List[torch.Tensor], offsets: List[torch.Tensor],
           weight: torch.Tensor, sampling: Mapping[str, str]
           ) -> List[torch.Tensor]:
    """The mask-free multi-level deformable conv of one branch: NHWC in
    and out, one K1 launch."""
    return multilevel_modulated_dcn(
        feats, offsets, [None] * len(feats), weight.to(feats[0].dtype),
        sampling=sampling["tower"])


class GARPNHead(nn.Module):
    """Guided-Anchoring RPN head: a 3x3 ``rpn_conv``, 1x1 location
    (``conv_loc``) and anchor-shape (``conv_shape``, (dw, dh)) branches,
    the feature adaption, and 1x1 binary objectness ``ga_cls`` and deltas
    ``ga_reg`` on the adapted features (one guided anchor a cell).
    ``forward`` -> ``cls`` (1), ``reg`` (4), ``loc`` (1), ``shape`` (2)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256):
        super().__init__()
        fc = feat_channels
        self.rpn_conv = conv3(in_channels, fc)
        self.conv_loc = nn.Conv2d(fc, 1, 1)
        self.conv_shape = nn.Conv2d(fc, 2, 1)
        self.adaption_offset = nn.Conv2d(2, 2 * 9, 1)
        self.adaption_weight = _adaption_weight(fc)
        self.ga_cls = nn.Conv2d(fc, 1, 1)
        self.ga_reg = nn.Conv2d(fc, 4, 1)

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING) -> Maps:
        outs: Maps = {"cls": [], "reg": [], "loc": [], "shape": []}
        xs, offs = [], []
        for f in feats:
            x = F.relu(self.rpn_conv(f))
            shape = self.conv_shape(x)
            outs["loc"].append(nhwc(self.conv_loc(x)))
            outs["shape"].append(nhwc(shape))
            xs.append(nhwc(x))
            offs.append(nhwc(self.adaption_offset(shape.detach())).to(
                f.dtype))
        for a in _adapt(xs, offs, self.adaption_weight, sampling):
            a = F.relu(nchw(a))
            outs["cls"].append(nhwc(self.ga_cls(a)))
            outs["reg"].append(nhwc(self.ga_reg(a)))
        return outs


class GARetinaHead(_TwoTowers):
    """Guided-Anchoring RetinaNet head: plain (no-norm) towers, 3x3
    location (``conv_loc``, on the cls tower) and shape (``conv_shape``,
    on the reg tower) branches, two feature adaptions (cls and reg, 1x1
    ``adaption_offset_cls`` / ``_reg`` convs on the detached shape), then
    3x3 ``ga_cls`` / ``ga_reg`` on the adapted features.
    ``forward`` -> ``cls``, ``reg`` (4), ``loc`` (1), ``shape`` (2)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4):
        super().__init__(in_channels, feat_channels, stacked_convs, False)
        fc = feat_channels
        self.conv_loc = conv3(fc, 1)
        self.conv_shape = conv3(fc, 2)
        self.adaption_offset_cls = nn.Conv2d(2, 2 * 9, 1)
        self.adaption_offset_reg = nn.Conv2d(2, 2 * 9, 1)
        self.adaption_weight_cls = _adaption_weight(fc)
        self.adaption_weight_reg = _adaption_weight(fc)
        self.ga_cls = conv3(fc, num_classes)
        self.ga_reg = conv3(fc, 4)

    def forward(self, feats: Sequence[torch.Tensor],
                sampling: Mapping[str, str] = TRAIN_SAMPLING) -> Maps:
        outs: Maps = {"cls": [], "reg": [], "loc": [], "shape": []}
        cfs, rfs, offs_c, offs_r = [], [], [], []
        for f in feats:
            cf, rf = self.towers(f)
            shape = self.conv_shape(rf)
            outs["loc"].append(nhwc(self.conv_loc(cf)))
            outs["shape"].append(nhwc(shape))
            sg = shape.detach()
            cfs.append(nhwc(cf))
            rfs.append(nhwc(rf))
            offs_c.append(nhwc(self.adaption_offset_cls(sg)).to(f.dtype))
            offs_r.append(nhwc(self.adaption_offset_reg(sg)).to(f.dtype))
        a_cls = _adapt(cfs, offs_c, self.adaption_weight_cls, sampling)
        a_reg = _adapt(rfs, offs_r, self.adaption_weight_reg, sampling)
        for ac, ar in zip(a_cls, a_reg):
            outs["cls"].append(nhwc(self.ga_cls(F.relu(nchw(ac)))))
            outs["reg"].append(nhwc(self.ga_reg(F.relu(nchw(ar)))))
        return outs
