"""The two-stage detectors: RPN + RoI bbox head and the mask branch
(counterpart of ``lsnet_tpu/models/heads/two_stage.py``, its Faster R-CNN,
Mask R-CNN, Mask Scoring R-CNN and PointRend parts):

* :class:`RPNHead`: objectness and box-delta maps per FPN level;
* :class:`Shared2FCBBoxHead`: flatten(7x7xC) -> 2 shared FCs -> softmax
  logits and per-class deltas;
* :class:`DoubleConvFCBBoxHead`: Double-Head R-CNN's conv branch (boxes)
  and fc branch (classes);
* :class:`TwoStageDetector` (Faster R-CNN, Dynamic R-CNN),
  :class:`DoubleHeadRCNNDetector` and :class:`FastRCNNDetector` (external
  proposals), whose ``extract`` / ``rpn`` / ``roi_forward`` the losses and
  decodes of :mod:`lsnet_torch.core.two_stage` call one by one;
* :class:`FCNMaskHead`: 4 convs 3x3, a 2x2 stride-2 transposed conv and a
  1x1 conv, 14x14 RoI features -> (N, 28, 28, C) mask logits;
  :class:`MaskRCNNDetector` adds ``mask_forward``;
* :class:`MaskIoUHead` and :class:`MaskScoringRCNNDetector`
  (``maskiou_forward``): each RoI's per-class mask IoU;
* :func:`point_sample`, :class:`MaskPointHead` and
  :class:`PointRendDetector` (``point_forward``): PointRend's point MLP
  on P2's features and the coarse logits at given points.

The backbone and neck take and give NCHW, as in :class:`LSDetector`; the
RPN maps are NHWC, and RoI features stay NHWC up to the flatten, so the
first FC's input order is flax's ``(7, 7, C)`` and its weight is the flax
kernel transposed (``weights.py``); so does the MaskIoU head's first FC
(``(7, 7, 256)``). The mask heads take and give NHWC. Submodule names are
the flax names; the Double-Head convs are ``{block}_conv`` /
``{block}_bn``. ``mask_upsample`` is an ``nn.ConvTranspose2d``: flax's
``nn.ConvTranspose`` does not flip its kernel, so the bridge flips it in
both spatial axes (``weights.py``).
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


class FCNMaskHead(nn.Module):
    """Mask R-CNN's mask branch (reference ``fcn_mask_head.py``): NHWC
    (N, 14, 14, in_channels) RoI features -> ``num_convs`` conv 3x3 +
    ReLU -> 2x2 stride-2 transposed conv + ReLU -> 1x1 per-class logits,
    (N, 28, 28, num_classes)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_channels: int = 256, num_convs: int = 4):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            setattr(self, f"mask_conv{i}", nn.Conv2d(
                in_channels if i == 0 else conv_channels, conv_channels, 3,
                padding=1))
        width = conv_channels if num_convs else in_channels
        self.mask_upsample = nn.ConvTranspose2d(width, conv_channels, 2,
                                                stride=2)
        self.mask_logits = nn.Conv2d(conv_channels, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        x = nchw(roi_feats)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"mask_conv{i}")(x))
        x = F.relu(self.mask_upsample(x))
        return nhwc(self.mask_logits(x))


class MaskIoUHead(nn.Module):
    """Mask Scoring R-CNN's MaskIoU head (reference ``maskiou_head.py``):
    the 14x14 RoI features with the 2x2 max-pooled sigmoid of the
    class-max mask logit as one more channel -> 4 conv 3x3 (the last at
    stride 2) -> flatten (NHWC order) -> 2 FCs -> per-class IoU."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_channels: int = 256, fc_channels: int = 1024,
                 roi_size: int = 14):
        super().__init__()
        for i in range(4):
            setattr(self, f"maskiou_conv{i}", nn.Conv2d(
                in_channels + 1 if i == 0 else conv_channels, conv_channels,
                3, stride=2 if i == 3 else 1, padding=1))
        side = (roi_size + 1) // 2
        self.maskiou_fc0 = nn.Linear(conv_channels * side * side,
                                     fc_channels)
        self.maskiou_fc1 = nn.Linear(fc_channels, fc_channels)
        self.maskiou_out = nn.Linear(fc_channels, num_classes)

    def forward(self, roi_feats: torch.Tensor, mask_pred: torch.Tensor
                ) -> torch.Tensor:
        # equal maxima share the gradient (amax), as jnp.max's do; the
        # pool's goes to the first of a window's equal values, as XLA's
        mp = torch.sigmoid(mask_pred.amax(dim=-1, keepdim=True))
        x = torch.cat([nchw(roi_feats), F.max_pool2d(nchw(mp), 2)], dim=1)
        for i in range(4):
            x = F.relu(getattr(self, f"maskiou_conv{i}")(x))
        x = nhwc(x).reshape(x.shape[0], -1)
        x = F.relu(self.maskiou_fc0(x))
        x = F.relu(self.maskiou_fc1(x))
        return self.maskiou_out(x)


def _clamped_bilinear(rows: torch.Tensor, base: torch.Tensor, h: int,
                      w: int, ys: torch.Tensor, xs: torch.Tensor
                      ) -> torch.Tensor:
    """Bilinear samples of row-major maps in one table, as the JAX mask
    branch takes them: each corner's index clamped into the map, its
    weight that of the unclamped corner (a sample off the map reads the
    edge). rows (R, C); ``base`` (N, 1) each set's first row; ys/xs
    (N, P) in map pixels (centres at +0.5) -> (N, P, C)."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            yi = (y0 + dy).clamp(0, h - 1).long()
            xi = (x0 + dx).clamp(0, w - 1).long()
            wt = ((1 - (xs - (x0 + dx)).abs())
                  * (1 - (ys - (y0 + dy)).abs()))
            idx = base + yi * w + xi
            v = rows[idx.reshape(-1)].reshape(*idx.shape, rows.shape[-1]) \
                * wt[..., None].to(rows.dtype)
            out = v if out is None else out + v
    return out


def point_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NHWC (N, H, W, C) at each set's normalised
    [0, 1] xy ``points`` (N, P, 2) -> (N, P, C) (mmcv's ``point_sample``,
    ``align_corners=False``; corners clamped into the map)."""
    N, H, W, C = feat.shape
    base = (torch.arange(N, device=feat.device) * (H * W))[:, None]
    return _clamped_bilinear(feat.reshape(N * H * W, C), base, H, W,
                             points[..., 1] * H - 0.5,
                             points[..., 0] * W - 0.5)


class MaskPointHead(nn.Module):
    """PointRend's point head (reference ``mask_point_head.py``): an MLP of
    ``num_fcs`` FCs + ReLU on [fine features, coarse logits], the coarse
    logits concatenated again after each, -> per-class point logits."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_fcs: int = 3, fc_channels: int = 256):
        super().__init__()
        self.num_fcs = num_fcs
        width = in_channels + num_classes
        for i in range(num_fcs):
            setattr(self, f"fc{i}", nn.Linear(width, fc_channels))
            width = fc_channels + num_classes
        self.fc_logits = nn.Linear(width, num_classes)

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([fine, coarse], dim=-1)
        for i in range(self.num_fcs):
            x = torch.cat([F.relu(getattr(self, f"fc{i}")(x)), coarse],
                          dim=-1)
        return self.fc_logits(x)


class MaskRCNNDetector(TwoStageDetector):
    """Faster R-CNN with the FCN mask branch (reference
    ``detectors/mask_rcnn.py``): ``mask_forward`` runs the mask head on
    each RoI's 14x14 features of its level."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_head: nn.Module,
                 mask_head: nn.Module, strides: Sequence[int] = STRIDES):
        super().__init__(backbone, neck, rpn_head, bbox_head, strides)
        self.mask_head = mask_head

    def mask_roi_feats(self, feats: Sequence[torch.Tensor],
                       rois: torch.Tensor) -> torch.Tensor:
        """(N, 14, 14, C) NHWC RoIAlign of the (N, 5) rois."""
        return multilevel_roi_align([nhwc(f) for f in feats], rois,
                                    self.strides, out_size=(14, 14))

    def mask_forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor
                     ) -> torch.Tensor:
        """(N, 28, 28, num_classes) mask logits of the (N, 5) rois."""
        return self.mask_head(self.mask_roi_feats(feats, rois))


class MaskScoringRCNNDetector(MaskRCNNDetector):
    """Mask Scoring R-CNN (reference ``detectors/mask_scoring_rcnn.py``):
    Mask R-CNN with the MaskIoU head on the same 14x14 RoI features."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_head: nn.Module,
                 mask_head: nn.Module, maskiou_head: nn.Module,
                 strides: Sequence[int] = STRIDES):
        super().__init__(backbone, neck, rpn_head, bbox_head, mask_head,
                         strides)
        self.maskiou_head = maskiou_head

    def maskiou_forward(self, feats: Sequence[torch.Tensor],
                        rois: torch.Tensor, mask_pred: torch.Tensor,
                        roi_feats: torch.Tensor = None) -> torch.Tensor:
        """(N, num_classes) mask IoUs of the rois from their mask logits;
        ``roi_feats`` are the rois' ``mask_roi_feats`` where the caller
        has them (the JAX method extracts them again: the same numbers)."""
        if roi_feats is None:
            roi_feats = self.mask_roi_feats(feats, rois)
        return self.maskiou_head(roi_feats, mask_pred)


class PointRendDetector(MaskRCNNDetector):
    """PointRend (reference ``detectors/point_rend.py`` +
    ``point_rend_roi_head.py``): Mask R-CNN whose masks are refined at
    uncertain points by an MLP over P2's features."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_head: nn.Module,
                 mask_head: nn.Module, point_head: nn.Module,
                 strides: Sequence[int] = STRIDES):
        super().__init__(backbone, neck, rpn_head, bbox_head, mask_head,
                         strides)
        self.point_head = point_head

    def point_forward(self, feats: Sequence[torch.Tensor],
                      rois: torch.Tensor, points: torch.Tensor,
                      coarse_logits: torch.Tensor) -> torch.Tensor:
        """Point logits (N, P, num_classes) at ``points`` (N, P, 2),
        normalised within each roi: P2's features (stride 4, as JAX's;
        each roi reads its own image's rows of the flat map) and the
        coarse logits (N, 28, 28, C) sampled there."""
        f0 = nhwc(feats[0])
        B, H, W, C = f0.shape
        x1, y1 = rois[:, 1:2], rois[:, 2:3]
        w = torch.clamp(rois[:, 3:4] - rois[:, 1:2], min=1e-3)
        h = torch.clamp(rois[:, 4:5] - rois[:, 2:3], min=1e-3)
        stride = 4.0
        px = (x1 + points[..., 0] * w) / stride - 0.5
        py = (y1 + points[..., 1] * h) / stride - 0.5
        bidx = rois[:, 0].long().clamp(0, B - 1)[:, None]
        fine = _clamped_bilinear(f0.reshape(B * H * W, C), bidx * (H * W),
                                 H, W, py, px)
        return self.point_head(fine, point_sample(coarse_logits, points))
