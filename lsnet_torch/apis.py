"""User entry points (counterpart of ``lsnet_tpu/apis.py``).

``init_detector`` builds a detector on the card (or on the CPU when the
caller asks for it) with seeded random weights; ``inference_detector`` runs
forward + decode + NMS, the path ``bench.py`` (``e2e_fn``) times for the
JAX package, with the shipped inference sampling (``backbone=nearest``) as
the JAX entry points apply it with ``inference_sampling()``;
``train_detector_step`` builds the train step of a detector (loss,
assigners, clip, SGD; ``tools/bench_train.py`` drives the JAX one). All
three serve the four tasks: the task is the head's in the model config and
the ``TestConfig``'s / ``LossConfig``'s at the call. They take tensors;
training and evaluating from a config file and COCO data (image loading,
resizing, checkpoints, COCO metrics) is the runner's:
``python3 -m lsnet_torch.tools.train`` / ``lsnet_torch.tools.test``
(:mod:`lsnet_torch.train.loop`). ``inference_detector`` on an image file
or a numpy image (resize, normalise, pad to a canvas) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence

import torch

from .core.decode import Detections, TestConfig, lsnet_decode
from .core.loss import LossConfig
from .models import build_detector
from .models.detectors.lsnet import LSDetector
from .models.layers import FrozenBatchNorm
from .ops.flat_deform import INFERENCE_SAMPLING, TRAIN_SAMPLING
from .train.optim import build_optimizer
from .train.step import make_train_step


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
                  dtype: torch.dtype = torch.float32,
                  train: bool = False) -> LSDetector:
    """Build the detector from a ``model`` config with seeded random
    weights on ``device`` (the card by default), in eval mode or, with
    ``train=True``, in training mode (FrozenBatchNorm normalises with its
    stored statistics either way; the frozen stages' parameters have
    ``requires_grad=False``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_detector: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    model = random_weights_(build_detector(cfg), seed)
    return model.to(device=device, dtype=dtype).train(train)


def train_detector_step(model: LSDetector, loss_cfg: LossConfig, *,
                        base_lr: float = 0.01, steps_per_epoch: int = 1000,
                        decay_epochs: Sequence[int] = (8, 11),
                        mixed_precision: bool = True,
                        sampling: Mapping[str, str] = TRAIN_SAMPLING,
                        **optim_kwargs
                        ) -> Callable[[Mapping[str, torch.Tensor]],
                                      Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics`` for ``model`` (f32 master weights, from
    ``init_detector(..., train=True)``): the reference recipe (SGD 0.9,
    weight decay 1e-4, clip 35, warm-up + step schedule) on the loss of
    ``loss_cfg.task``,
    bf16 compute unless ``mixed_precision=False``. ``optim_kwargs`` go to
    :func:`lsnet_torch.train.optim.build_optimizer`."""
    optimizer, _ = build_optimizer(model.parameters(), base_lr,
                                   steps_per_epoch, decay_epochs,
                                   **optim_kwargs)
    return make_train_step(model, optimizer, loss_cfg, mixed_precision,
                           sampling)


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
