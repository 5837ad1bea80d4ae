"""Optimizer and LR schedule (counterpart of ``lsnet_tpu/train/optim.py``
``step_lr_schedule`` and ``build_optimizer``): the reference recipe.

SGD with momentum 0.9 and weight decay 1e-4 (the decay is added to the
gradient before the momentum, as ``torch.optim.SGD`` and the optax chain
both do), linear warm-up (500 iterations, ratio 0.001), step decay x0.1 at
the given epochs, and gradient clipping by the global norm (35) before the
optimizer. The clip is optax's ``clip_by_global_norm``: the gradients are
scaled by ``clip / max(norm, clip)``, not torch's ``clip / (norm + 1e-6)``.
Frozen parameters (``requires_grad=False``) take no update and no weight
decay, like the JAX package's ``make_frozen_mask``.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: Sequence[int], *, gamma: float = 0.1,
                     warmup_iters: int = 500,
                     warmup_ratio: float = 0.001) -> Callable[[int], float]:
    """The 'step' LR policy with linear warm-up: step -> learning rate."""
    boundaries = [e * steps_per_epoch for e in decay_epochs]

    def schedule(step: int) -> float:
        regular = base_lr * gamma ** sum(step >= b for b in boundaries)
        if step >= warmup_iters:
            return regular
        frac = min(step / max(warmup_iters, 1), 1.0)
        return regular * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))

    return schedule


class ClippedSGD:
    """Global-norm clip, then ``torch.optim.SGD`` at the schedule's rate.

    ``step(grads)`` takes the gradients of ``self.params`` in order,
    applies one update in place and returns the norm before the clip."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], momentum: float,
                 weight_decay: float, clip_norm: float):
        self.params: List[torch.nn.Parameter] = [
            p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0                 # updates taken so far
        self.sgd = torch.optim.SGD(self.params, lr=schedule(0),
                                   momentum=momentum,
                                   weight_decay=weight_decay)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(list(grads))))
        scale = self.clip_norm / norm.clamp(min=self.clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g * scale
        for group in self.sgd.param_groups:
            group["lr"] = self.schedule(self.count)
        self.sgd.step()
        self.sgd.zero_grad(set_to_none=True)
        self.count += 1
        return norm


def build_optimizer(params: Iterable[torch.nn.Parameter], base_lr: float,
                    steps_per_epoch: int, decay_epochs: Sequence[int], *,
                    momentum: float = 0.9, weight_decay: float = 1e-4,
                    clip_norm: float = 35.0, warmup_iters: int = 500,
                    warmup_ratio: float = 0.001,
                    schedule: Optional[Callable[[int], float]] = None
                    ) -> Tuple[ClippedSGD, Callable[[int], float]]:
    """(optimizer over the trainable ones of ``params``, schedule)."""
    if schedule is None:
        schedule = step_lr_schedule(base_lr, steps_per_epoch, decay_epochs,
                                    warmup_iters=warmup_iters,
                                    warmup_ratio=warmup_ratio)
    return ClippedSGD(params, schedule, momentum, weight_decay,
                      clip_norm), schedule
