"""User entry points (counterpart of ``lsnet_tpu/apis.py``).

``init_detector`` builds a detector on the card (or on the CPU when the
caller asks for it) with seeded random weights; ``inference_detector`` runs
forward + decode + NMS, the path ``bench.py`` (``e2e_fn``) times for the
JAX package, with the shipped inference sampling (``backbone=nearest``) as
the JAX entry points apply it with ``inference_sampling()``. Image loading
and resizing come with a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from .core.decode import Detections, TestConfig, lsnet_decode
from .models import build_detector
from .models.detectors.lsnet import LSDetector
from .models.layers import FrozenBatchNorm
from .ops.flat_deform import INFERENCE_SAMPLING


def random_weights_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter ~ 0.03 * N(0, 1) from ``seed`` (the scale
    ``bench.py`` mints), FrozenBatchNorm statistics mean 0, var 1. In
    place."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.03 * torch.randn(p.shape, generator=gen))
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
    return model


def init_detector(cfg: Dict[str, Any], device: str = "cuda", seed: int = 0,
                  dtype: torch.dtype = torch.float32) -> LSDetector:
    """Build the detector from a ``model`` config with seeded random
    weights, in eval mode, on ``device`` (the card by default)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_detector: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    model = random_weights_(build_detector(cfg), seed)
    return model.to(device=device, dtype=dtype).eval()


def inference_detector(model: LSDetector, images: torch.Tensor,
                       img_shapes: torch.Tensor,
                       scale_factors: torch.Tensor,
                       test_cfg: TestConfig,
                       sampling: Mapping[str, str] = INFERENCE_SAMPLING
                       ) -> Detections:
    """images (B, H, W, 3) NHWC in the model's dtype; img_shapes (B, 2)
    [h, w]; scale_factors (B, 4); ``sampling`` maps each sampling site to
    its mode (``flat_deform.TRAIN_SAMPLING`` for bilinear everywhere).
    Returns padded Detections."""
    with torch.inference_mode():
        outs = model(images, sampling)
        return lsnet_decode(outs, img_shapes, scale_factors, test_cfg)
