"""The two-stage detectors: RPN + RoI bbox head (counterpart of
``lsnet_tpu/models/heads/two_stage.py``, the Faster R-CNN slice):

* :class:`RPNHead`: objectness and box-delta maps per FPN level;
* :class:`Shared2FCBBoxHead`: flatten(7x7xC) -> 2 shared FCs -> softmax
  logits and per-class deltas;
* :class:`DoubleConvFCBBoxHead`: Double-Head R-CNN's conv branch (boxes)
  and fc branch (classes);
* :class:`TwoStageDetector` (Faster R-CNN, Dynamic R-CNN),
  :class:`DoubleHeadRCNNDetector` and :class:`FastRCNNDetector` (external
  proposals), whose ``extract`` / ``rpn`` / ``roi_forward`` the losses and
  decodes of :mod:`lsnet_torch.core.two_stage` call one by one.

The backbone and neck take and give NCHW, as in :class:`LSDetector`; the
RPN maps are NHWC, and RoI features stay NHWC up to the flatten, so the
first FC's input order is flax's ``(7, 7, C)`` and its weight is the flax
kernel transposed (``weights.py``). Submodule names are the flax names;
the Double-Head convs are ``{block}_conv`` / ``{block}_bn``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING
from ...ops.roi import multilevel_roi_align
from ..layers import FrozenBatchNorm, nchw, nhwc

STRIDES = (4, 8, 16, 32, 64)


class RPNHead(nn.Module):
    """A shared 3x3 conv + ReLU, then 1x1 objectness (A) and deltas
    (4A) per level."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_base_anchors: int = 3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_base_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_base_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Dict[str, List[torch.Tensor]]:
        outs: Dict[str, List[torch.Tensor]] = {"rpn_cls": [], "rpn_reg": []}
        for f in feats:
            x = F.relu(self.rpn_conv(f))
            outs["rpn_cls"].append(nhwc(self.rpn_cls(x)))
            outs["rpn_reg"].append(nhwc(self.rpn_reg(x)))
        return outs


def _n_reg(num_classes: int, reg_class_agnostic: bool) -> int:
    return 4 if reg_class_agnostic else 4 * num_classes


class Shared2FCBBoxHead(nn.Module):
    """NHWC RoI features (N, 7, 7, C) -> (cls logits (N, C+1), deltas
    (N, 4 * num_classes, or 4 class-agnostic))."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 fc_channels: int = 1024, roi_size: Tuple[int, int] = (7, 7),
                 reg_class_agnostic: bool = False):
        super().__init__()
        self.shared_fc0 = nn.Linear(in_channels * roi_size[0] * roi_size[1],
                                    fc_channels)
        self.shared_fc1 = nn.Linear(fc_channels, fc_channels)
        self.fc_cls = nn.Linear(fc_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_channels,
                                _n_reg(num_classes, reg_class_agnostic))

    def forward(self, roi_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = roi_feats.reshape(roi_feats.shape[0], -1)
        x = F.relu(self.shared_fc0(x))
        x = F.relu(self.shared_fc1(x))
        return self.fc_cls(x), self.fc_reg(x)


class DoubleConvFCBBoxHead(nn.Module):
    """Double-Head R-CNN bbox head (reference ``double_bbox_head.py:72-180``):
    a conv branch (a residual block C -> ``conv_channels``, ``num_convs``
    bottlenecks, global average pool) regresses boxes from the *reg* RoI
    features; ``num_fcs`` FCs classify from the *cls* RoI features."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_convs: int = 4, num_fcs: int = 2,
                 conv_channels: int = 1024, fc_channels: int = 1024,
                 roi_size: Tuple[int, int] = (7, 7),
                 reg_class_agnostic: bool = False):
        super().__init__()
        mid = conv_channels // 4
        self._conv_bn("res_conv1", in_channels, in_channels, 3)
        self._conv_bn("res_conv2", in_channels, conv_channels, 1)
        self._conv_bn("res_identity", in_channels, conv_channels, 1)
        for i in range(num_convs):
            self._conv_bn(f"branch{i}_1", conv_channels, mid, 1)
            self._conv_bn(f"branch{i}_2", mid, mid, 3)
            self._conv_bn(f"branch{i}_3", mid, conv_channels, 1)
        self.num_convs, self.num_fcs = num_convs, num_fcs
        self.fc_reg = nn.Linear(conv_channels,
                                _n_reg(num_classes, reg_class_agnostic))
        width = in_channels * roi_size[0] * roi_size[1]
        for i in range(num_fcs):
            setattr(self, f"fc_branch{i}",
                    nn.Linear(width if i == 0 else fc_channels, fc_channels))
        self.fc_cls = nn.Linear(fc_channels if num_fcs else width,
                                num_classes + 1)

    def _conv_bn(self, name: str, cin: int, cout: int, k: int) -> None:
        """A bias-free conv and its FrozenBatchNorm, ``{name}_conv`` /
        ``{name}_bn``."""
        setattr(self, f"{name}_conv",
                nn.Conv2d(cin, cout, k, padding=k // 2, bias=False))
        setattr(self, f"{name}_bn", FrozenBatchNorm(cout))

    def _block(self, name: str, x: torch.Tensor,
               act: bool = True) -> torch.Tensor:
        x = getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x))
        return F.relu(x) if act else x

    def forward(self, cls_feats: torch.Tensor, reg_feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        r = nchw(reg_feats)
        x = self._block("res_conv2", self._block("res_conv1", r), act=False)
        x = F.relu(x + self._block("res_identity", r, act=False))
        for i in range(self.num_convs):
            y = self._block(f"branch{i}_2", self._block(f"branch{i}_1", x))
            x = F.relu(x + self._block(f"branch{i}_3", y, act=False))
        reg = self.fc_reg(x.mean(dim=(2, 3)))
        f = cls_feats.reshape(cls_feats.shape[0], -1)
        for i in range(self.num_fcs):
            f = F.relu(getattr(self, f"fc_branch{i}")(f))
        return self.fc_cls(f), reg


def scale_rois(rois: torch.Tensor, factor: float) -> torch.Tensor:
    """(N, 5) rois rescaled about their centres (the reference
    ``roi_rescale``; JAX's ``_scale_rois``)."""
    cx = (rois[:, 1] + rois[:, 3]) * 0.5
    cy = (rois[:, 2] + rois[:, 4]) * 0.5
    hw = (rois[:, 3] - rois[:, 1]) * 0.5 * factor
    hh = (rois[:, 4] - rois[:, 2]) * 0.5 * factor
    return torch.stack([rois[:, 0], cx - hw, cy - hh, cx + hw, cy + hh], -1)


class FastRCNNDetector(nn.Module):
    """Fast R-CNN (reference ``detectors/fast_rcnn.py``): the RoI head on
    proposals given from outside; no RPN."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, strides: Sequence[int] = STRIDES):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.strides = tuple(strides)

    def extract(self, images: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> List[torch.Tensor]:
        """images (B, H, W, 3) NHWC -> the neck's NCHW levels."""
        return list(self.neck(self.backbone(images.permute(0, 3, 1, 2),
                                            sampling)))

    def roi_forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cls logits, deltas) of the (N, 5) rois."""
        return self.bbox_head(multilevel_roi_align(
            [nhwc(f) for f in feats], rois, self.strides))

    def forward(self, images: torch.Tensor, rois: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.roi_forward(self.extract(images, sampling), rois)


class TwoStageDetector(FastRCNNDetector):
    """Faster R-CNN: backbone -> neck -> RPN, and the RoI head on the
    proposals. ``forward`` gives the RPN maps (``rpn_cls`` A, ``rpn_reg``
    4A per level, NHWC); proposals, sampling and losses are
    :mod:`lsnet_torch.core.two_stage`'s."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_head: nn.Module,
                 strides: Sequence[int] = STRIDES):
        super().__init__(backbone, neck, bbox_head, strides)
        self.rpn_head = rpn_head

    def rpn(self, feats: Sequence[torch.Tensor]
            ) -> Dict[str, List[torch.Tensor]]:
        return self.rpn_head(feats)

    def forward(self, images: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Dict[str, List[torch.Tensor]]:
        return self.rpn(self.extract(images, sampling))


class DoubleHeadRCNNDetector(TwoStageDetector):
    """Faster R-CNN with the Double-Head RoI head (reference
    ``double_roi_head.py:8-34``): the reg branch reads RoI features of the
    boxes enlarged ``reg_roi_scale_factor`` times."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_head: nn.Module,
                 strides: Sequence[int] = STRIDES,
                 reg_roi_scale_factor: float = 1.3):
        super().__init__(backbone, neck, rpn_head, bbox_head, strides)
        self.reg_roi_scale_factor = reg_roi_scale_factor

    def roi_forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        levels = [nhwc(f) for f in feats]
        cls_feats = multilevel_roi_align(levels, rois, self.strides)
        reg_feats = multilevel_roi_align(
            levels, scale_rois(rois, self.reg_roi_scale_factor),
            self.strides)
        return self.bbox_head(cls_feats, reg_feats)
