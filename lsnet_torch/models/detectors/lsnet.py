"""LSDetector: backbone -> FPN -> LSHead (counterpart of
``lsnet_tpu/models/detectors/lsnet.py``)."""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn


class LSDetector(nn.Module):

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, images: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """images (B, H, W, 3) NHWC, as the JAX detector takes them ->
        per-level NHWC head maps. The NCHW view of a contiguous NHWC batch
        is channels-last, so no copy is made."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        return self.head(list(self.neck(feats)))
