"""Optimizer and LR schedules (counterpart of ``lsnet_tpu/train/optim.py``
``step_lr_schedule``, ``cosine_lr_schedule``, ``poly_lr_schedule``,
``build_lr_schedule`` and ``build_optimizer``): the reference recipe.

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

import math
from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import torch


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: Sequence[int], *, gamma: float = 0.1,
                     warmup_iters: int = 500,
                     warmup_ratio: float = 0.001) -> Callable[[int], float]:
    """The 'step' LR policy with linear warm-up: step -> learning rate."""
    boundaries = [e * steps_per_epoch for e in decay_epochs]

    def schedule(step: int) -> float:
        regular = base_lr * gamma ** sum(step >= b for b in boundaries)
        return _warmup(regular, step, warmup_iters, warmup_ratio)

    return schedule


def _warmup(regular: float, step: int, warmup_iters: int,
            warmup_ratio: float) -> float:
    if step >= warmup_iters:
        return regular
    frac = min(step / max(warmup_iters, 1), 1.0)
    return regular * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))


def cosine_lr_schedule(base_lr: float, total_steps: int, *,
                       min_lr_ratio: float = 0.0, warmup_iters: int = 500,
                       warmup_ratio: float = 0.001) -> Callable[[int], float]:
    """The 'CosineAnnealing' LR policy with linear warm-up."""

    def schedule(step: int) -> float:
        prog = min(max(step / max(total_steps, 1), 0.0), 1.0)
        target = base_lr * min_lr_ratio
        regular = target + 0.5 * (base_lr - target) * (
            1.0 + math.cos(math.pi * prog))
        return _warmup(regular, step, warmup_iters, warmup_ratio)

    return schedule


def poly_lr_schedule(base_lr: float, total_steps: int, *, power: float = 1.0,
                     min_lr: float = 0.0, warmup_iters: int = 500,
                     warmup_ratio: float = 0.001) -> Callable[[int], float]:
    """The 'poly' LR policy with linear warm-up."""

    def schedule(step: int) -> float:
        prog = min(max(step / max(total_steps, 1), 0.0), 1.0)
        regular = (base_lr - min_lr) * (1.0 - prog) ** power + min_lr
        return _warmup(regular, step, warmup_iters, warmup_ratio)

    return schedule


def build_lr_schedule(lr_config: Dict[str, Any], base_lr: float,
                      steps_per_epoch: int,
                      total_epochs: int) -> Callable[[int], float]:
    """The schedule of a config's ``lr_config.policy``: 'step' (default),
    'CosineAnnealing' (or 'cosine') or 'poly'."""
    policy = lr_config.get("policy", "step")
    warmup_iters = lr_config.get("warmup_iters", 500)
    warmup_ratio = lr_config.get("warmup_ratio", 0.001)
    if policy == "step":
        return step_lr_schedule(base_lr, steps_per_epoch,
                                lr_config.get("step", [8, 11]),
                                gamma=lr_config.get("gamma", 0.1),
                                warmup_iters=warmup_iters,
                                warmup_ratio=warmup_ratio)
    total = steps_per_epoch * total_epochs
    if policy in ("CosineAnnealing", "cosine"):
        min_lr = lr_config.get("min_lr")
        ratio = (min_lr / base_lr if min_lr is not None
                 else lr_config.get("min_lr_ratio", 0.0))
        return cosine_lr_schedule(base_lr, total, min_lr_ratio=ratio,
                                  warmup_iters=warmup_iters,
                                  warmup_ratio=warmup_ratio)
    if policy == "poly":
        return poly_lr_schedule(base_lr, total,
                                power=lr_config.get("power", 1.0),
                                min_lr=lr_config.get("min_lr", 0.0),
                                warmup_iters=warmup_iters,
                                warmup_ratio=warmup_ratio)
    raise ValueError(f"unknown lr policy {policy!r}")


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

    def state_dict(self) -> Dict[str, Any]:
        """``count`` and the momentum buffer of each parameter, in order
        (None before the first update)."""
        return {"count": self.count,
                "momentum": [self.sgd.state.get(p, {}).get("momentum_buffer")
                             for p in self.params]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if len(state["momentum"]) != len(self.params):
            raise ValueError(
                f"optimizer state holds {len(state['momentum'])} momentum "
                f"buffers for {len(self.params)} parameters")
        self.count = int(state["count"])
        for p, buf in zip(self.params, state["momentum"]):
            if buf is None:
                self.sgd.state.pop(p, None)
            else:
                self.sgd.state[p]["momentum_buffer"] = buf.to(
                    device=p.device, dtype=p.dtype).clone()


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
