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
  on P2's features and the coarse logits at given points;
* :class:`CascadeRCNNDetector` (Cascade R-CNN and DetectoRS): three
  class-agnostic Shared2FC heads ``bbox_head``, ``bbox_head2``,
  ``bbox_head3`` (``roi_forward_stage``);
* :class:`GridHead` and :class:`GridRCNNDetector` (``grid_forward``):
  Grid R-CNN's per-point heatmaps from 14x14 RoI features;
* :class:`FusedSemanticHead`, :class:`HTCMaskHead` and
  :class:`HTCDetector`: Hybrid Task Cascade's semantic branch, its mask
  heads with the previous stage's features, and its three stages.

The backbone and neck take and give NCHW, as in :class:`LSDetector`; the
RPN maps are NHWC, and RoI features stay NHWC up to the flatten, so the
first FC's input order is flax's ``(7, 7, C)`` and its weight is the flax
kernel transposed (``weights.py``); so does the MaskIoU head's first FC
(``(7, 7, 256)``). The mask heads take and give NHWC. Submodule names are
the flax names; the Double-Head convs are ``{block}_conv`` /
``{block}_bn``. ``mask_upsample`` is an ``nn.ConvTranspose2d``: flax's
``nn.ConvTranspose`` does not flip its kernel, so the bridge flips it in
both spatial axes (``weights.py``); so are Grid R-CNN's per-point
``deconv1_g{g}`` / ``deconv2_g{g}`` (4x4, stride 2, flax's ``"SAME"``:
padding 1) and HTC's ``mask_upsample``. The GroupNorms of
``GridHead`` take flax's default epsilon, 1e-6.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING
from ...ops.roi import multilevel_roi_align
from ..layers import FrozenBatchNorm, nchw, nhwc
from ..necks.extra import bilinear_to

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


class CascadeRCNNDetector(TwoStageDetector):
    """Cascade R-CNN (reference ``detectors/cascade_rcnn.py`` +
    ``cascade_roi_head.py``), and DetectoRS with its own backbone and
    neck: three bbox heads, each refining the boxes of the one before at
    a higher IoU; class-agnostic deltas. ``bbox_head`` is stage 0's, so
    ``roi_forward`` is stage 0's too."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_head: nn.Module,
                 bbox_head2: nn.Module, bbox_head3: nn.Module,
                 strides: Sequence[int] = STRIDES):
        super().__init__(backbone, neck, rpn_head, bbox_head, strides)
        self.bbox_head2 = bbox_head2
        self.bbox_head3 = bbox_head3

    def stage_head(self, stage: int) -> nn.Module:
        return (self.bbox_head, self.bbox_head2, self.bbox_head3)[stage]

    def roi_forward_stage(self, feats: Sequence[torch.Tensor],
                          rois: torch.Tensor, stage: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cls logits, class-agnostic deltas (N, 4)) of stage ``stage``'s
        head on the (N, 5) rois."""
        return self.stage_head(stage)(multilevel_roi_align(
            [nhwc(f) for f in feats], rois, self.strides))


def grid_neighbors(grid_points: int) -> List[Tuple[int, ...]]:
    """Each grid point's neighbours on the sqrt(G) x sqrt(G) grid: above,
    left, right, below (JAX ``GridHead.neighbors``)."""
    gs = int(round(grid_points ** 0.5))
    out = []
    for i in range(gs):
        for j in range(gs):
            n = []
            if i > 0:
                n.append((i - 1) * gs + j)
            if j > 0:
                n.append(i * gs + j - 1)
            if j < gs - 1:
                n.append(i * gs + j + 1)
            if i < gs - 1:
                n.append((i + 1) * gs + j)
            out.append(tuple(n))
    return out


class GridHead(nn.Module):
    """Grid R-CNN's grid head (reference ``grid_head.py:11-219``; JAX
    ``GridHead``): NHWC (N, 14, 14, in_channels) RoI features ->
    ``num_convs`` conv 3x3 (the first at stride 2) + GroupNorm(4G) + ReLU
    to G x ``point_feat_channels`` channels, G slices of c; the first- and
    second-order fusion of each point's slice with its neighbours' (a 5x5
    depthwise conv ``{fo,so}_{i}_{j}_dw`` then a 1x1 ``_pw`` per edge);
    then, for the fused and the unfused slices alike, the per-point 4x4
    stride-2 transposed convs ``deconv1_g{g}`` (c -> c), GroupNorm(G) +
    ReLU over all G slices, and ``deconv2_g{g}`` (c -> 1): {"fused",
    "unfused"} heatmap logits (N, 28, 28, G). The transposed convs are
    shared between the two."""

    def __init__(self, in_channels: int = 256, grid_points: int = 9,
                 num_convs: int = 8, point_feat_channels: int = 64):
        super().__init__()
        G, c = grid_points, point_feat_channels
        self.G, self.c, self.num_convs = G, c, num_convs
        self.nbrs = grid_neighbors(G)
        for i in range(num_convs):
            setattr(self, f"conv{i}", nn.Conv2d(
                in_channels if i == 0 else G * c, G * c, 3,
                stride=2 if i == 0 else 1, padding=1))
            setattr(self, f"gn{i}", nn.GroupNorm(4 * G, G * c, eps=1e-6))
        for prefix in ("fo", "so"):
            for i, pts in enumerate(self.nbrs):
                for j in range(len(pts)):
                    name = f"{prefix}_{i}_{j}"
                    setattr(self, f"{name}_dw",
                            nn.Conv2d(c, c, 5, padding=2, groups=c))
                    setattr(self, f"{name}_pw", nn.Conv2d(c, c, 1))
        for g in range(G):
            setattr(self, f"deconv1_g{g}",
                    nn.ConvTranspose2d(c, c, 4, stride=2, padding=1))
            setattr(self, f"deconv2_g{g}",
                    nn.ConvTranspose2d(c, 1, 4, stride=2, padding=1))
        self.deconv1_gn = nn.GroupNorm(G, G * c, eps=1e-6)

    def _slice(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return x[:, i * self.c:(i + 1) * self.c]

    def _fuse(self, prefix: str, x: torch.Tensor,
              src: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for i, pts in enumerate(self.nbrs):
            acc = self._slice(x, i)
            for j, p in enumerate(pts):
                h = getattr(self, f"{prefix}_{i}_{j}_dw")(src[p])
                acc = acc + getattr(self, f"{prefix}_{i}_{j}_pw")(h)
            out.append(acc)
        return out

    def _heatmap(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([getattr(self, f"deconv1_g{g}")(self._slice(x, g))
                       for g in range(self.G)], dim=1)
        h = F.relu(self.deconv1_gn(h))
        return nhwc(torch.cat([getattr(self, f"deconv2_g{g}")(
            self._slice(h, g)) for g in range(self.G)], dim=1))

    def forward(self, roi_feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = nchw(roi_feats)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x)))
        slices = [self._slice(x, i) for i in range(self.G)]
        x_fo = self._fuse("fo", x, slices)
        x_so = self._fuse("so", x, x_fo)
        return {"fused": self._heatmap(torch.cat(x_so, dim=1)),
                "unfused": self._heatmap(x)}


class GridRCNNDetector(TwoStageDetector):
    """Grid R-CNN (reference ``detectors/grid_rcnn.py``): Faster R-CNN
    whose boxes the decode re-localises from the grid head's heatmaps;
    ``grid_forward`` runs it on each RoI's 14x14 features of its level."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_head: nn.Module,
                 grid_head: nn.Module, strides: Sequence[int] = STRIDES):
        super().__init__(backbone, neck, rpn_head, bbox_head, strides)
        self.grid_head = grid_head

    def grid_forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
        return self.grid_head(multilevel_roi_align(
            [nhwc(f) for f in feats], rois, self.strides, out_size=(14, 14)))


class FusedSemanticHead(nn.Module):
    """HTC's fused semantic head (reference ``fused_semantic_head.py``;
    JAX ``FusedSemanticHead``): a 1x1 ``lateral_{i}`` + ReLU on each
    level, the others resized to the ``fusion_level`` (stride 8) as
    ``jax.image.resize(method="bilinear")`` does (antialiased where a
    level shrinks: level 0) and summed, ``num_convs`` conv 3x3 + ReLU,
    then a 1x1 ``conv_embedding`` + ReLU and 1x1 ``conv_logits`` (C + 1).
    NCHW levels -> (logits, embedding), both NHWC."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 num_levels: int = 5, fusion_level: int = 1,
                 num_convs: int = 4, conv_channels: int = 256):
        super().__init__()
        self.fusion_level, self.num_convs = fusion_level, num_convs
        for i in range(num_levels):
            setattr(self, f"lateral_{i}",
                    nn.Conv2d(in_channels, conv_channels, 1))
        for i in range(num_convs):
            setattr(self, f"conv{i}", nn.Conv2d(conv_channels, conv_channels,
                                                3, padding=1))
        self.conv_embedding = nn.Conv2d(conv_channels, conv_channels, 1)
        self.conv_logits = nn.Conv2d(conv_channels, num_classes + 1, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        fl = self.fusion_level
        x = F.relu(getattr(self, f"lateral_{fl}")(feats[fl]))
        th, tw = x.shape[-2:]
        for i, f in enumerate(feats):
            if i != fl:
                x = x + bilinear_to(
                    F.relu(getattr(self, f"lateral_{i}")(f)), th, tw)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return (nhwc(self.conv_logits(x)),
                nhwc(F.relu(self.conv_embedding(x))))


class HTCMaskHead(nn.Module):
    """HTC's mask head with the mask information flow (reference
    ``htc_mask_head.py``; JAX ``HTCMaskHead``): NHWC (N, 14, 14, C) RoI
    features, plus ReLU(``conv_res`` (1x1) of the previous stage's
    features) where ``with_res`` (stages 2 and 3: flax creates
    ``conv_res`` only where it is called), ``num_convs`` conv 3x3 + ReLU,
    a 2x2 stride-2 transposed conv + ReLU and 1x1 per-class logits.
    Returns (logits (N, 28, 28, num_classes) NHWC, the features after the
    convs (N, conv_channels, 14, 14) NCHW: the next stage's
    ``last_feat``)."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 conv_channels: int = 256, num_convs: int = 4,
                 with_res: bool = False):
        super().__init__()
        self.num_convs = num_convs
        if with_res:
            self.conv_res = nn.Conv2d(conv_channels, conv_channels, 1)
        for i in range(num_convs):
            setattr(self, f"mask_conv{i}", nn.Conv2d(
                in_channels if i == 0 else conv_channels, conv_channels, 3,
                padding=1))
        width = conv_channels if num_convs else in_channels
        self.mask_upsample = nn.ConvTranspose2d(width, conv_channels, 2,
                                                stride=2)
        self.mask_logits = nn.Conv2d(conv_channels, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor,
                last_feat: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = nchw(roi_feats)
        if last_feat is not None:
            x = x + F.relu(self.conv_res(last_feat))
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"mask_conv{i}")(x))
        logits = self.mask_logits(F.relu(self.mask_upsample(x)))
        return nhwc(logits), x


class HTCDetector(CascadeRCNNDetector):
    """Hybrid Task Cascade (reference ``detectors/htc.py`` +
    ``htc_roi_head.py``; JAX ``HTCDetector``): the three cascade stages,
    a mask head a stage (``mask_head1`` .. ``mask_head3``, each after the
    first taking the one before's features) and the semantic branch,
    whose embedding's RoI features (one map at stride 8) add to the bbox
    heads' (7x7) and the mask heads' (14x14)."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, bbox_heads: Sequence[nn.Module],
                 mask_heads: Sequence[nn.Module], semantic_head: nn.Module,
                 strides: Sequence[int] = STRIDES):
        super().__init__(backbone, neck, rpn_head, *bbox_heads,
                         strides=strides)
        self.mask_head1, self.mask_head2, self.mask_head3 = mask_heads
        self.semantic_head = semantic_head

    def semantic(self, feats: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(semantic logits, embedding), NHWC at stride 8."""
        return self.semantic_head(feats)

    def _sem_roi(self, sem_feat: torch.Tensor, rois: torch.Tensor,
                 out_size: Tuple[int, int]) -> torch.Tensor:
        return multilevel_roi_align([sem_feat], rois, (8,),
                                    out_size=out_size)

    def roi_forward_stage(self, feats: Sequence[torch.Tensor],
                          rois: torch.Tensor, stage: int,
                          sem_feat: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        roi_feats = multilevel_roi_align([nhwc(f) for f in feats], rois,
                                         self.strides)
        if sem_feat is not None:
            roi_feats = roi_feats + self._sem_roi(sem_feat, rois, (7, 7))
        return self.stage_head(stage)(roi_feats)

    def mask_roi_feats(self, feats: Sequence[torch.Tensor],
                       rois: torch.Tensor,
                       sem_feat: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """(N, 14, 14, C) NHWC RoIAlign of the rois on their levels, plus
        the semantic embedding's where given."""
        roi_feats = multilevel_roi_align([nhwc(f) for f in feats], rois,
                                         self.strides, out_size=(14, 14))
        if sem_feat is not None:
            roi_feats = roi_feats + self._sem_roi(sem_feat, rois, (14, 14))
        return roi_feats

    def mask_head_stage(self, stage: int, roi_feats: torch.Tensor,
                        last_feat: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        head = (self.mask_head1, self.mask_head2, self.mask_head3)[stage]
        return head(roi_feats, last_feat)

    def mask_forward_stage(self, feats: Sequence[torch.Tensor],
                           rois: torch.Tensor, stage: int,
                           sem_feat: Optional[torch.Tensor] = None,
                           last_feat: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage ``stage``'s (mask logits, features) of the rois."""
        return self.mask_head_stage(
            stage, self.mask_roi_feats(feats, rois, sem_feat), last_feat)
