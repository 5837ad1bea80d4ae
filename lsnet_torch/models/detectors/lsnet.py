"""LSDetector: backbone -> FPN -> LSHead (counterpart of
``lsnet_tpu/models/detectors/lsnet.py``)."""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING


class LSDetector(nn.Module):

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, images: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Dict[str, List[torch.Tensor]]:
        """images (B, H, W, 3) NHWC, as the JAX detector takes them ->
        per-level NHWC head maps. The NCHW view of a contiguous NHWC batch
        is channels-last, so no copy is made. ``sampling`` maps each
        sampling site to its mode (``flat_deform.TRAIN_SAMPLING`` or
        ``INFERENCE_SAMPLING``)."""
        feats = self.backbone(images.permute(0, 3, 1, 2), sampling)
        return self.head(list(self.neck(feats)), sampling)
