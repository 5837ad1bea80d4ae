"""MobileNetV2 (counterpart of ``lsnet_tpu/models/backbones/mobilenet.py``):
inverted-residual bottlenecks, a width multiplier, frozen stages.

NCHW in, the ``out_indices`` stages' NCHW maps out; submodule names are
the flax ones (``conv1_conv`` / ``conv1_bn``, ``layer{s}_{b}`` with
``expand_conv`` / ``_bn``, ``depthwise_conv`` / ``_bn``,
``project_conv`` / ``_bn``).
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flat_deform import TRAIN_SAMPLING
from ..layers import FrozenBatchNorm
from .extra import freeze_before

# (expand_ratio, channels, num_blocks, stride) a stage: the V2 recipe
ARCH = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def conv_bn_relu6(parent: nn.Module, name: str, cin: int, cout: int, k: int,
                  stride: int = 1, groups: int = 1) -> None:
    """Add ``{name}_conv`` (bias-free, padding k // 2) and ``{name}_bn``
    to ``parent``, as JAX's ``_conv_bn_relu6`` names them in the parent;
    :func:`run_bn_relu6` applies them."""
    setattr(parent, f"{name}_conv", nn.Conv2d(
        cin, cout, k, stride=stride, padding=k // 2, groups=groups,
        bias=False))
    setattr(parent, f"{name}_bn", FrozenBatchNorm(cout))


def run_bn_relu6(parent: nn.Module, name: str,
                 x: torch.Tensor) -> torch.Tensor:
    """ReLU6, min(relu(x), 6), of ``{name}_bn`` of ``{name}_conv`` of x."""
    x = getattr(parent, f"{name}_bn")(getattr(parent, f"{name}_conv")(x))
    return F.relu(x).clamp(max=6.0)


class InvertedResidual(nn.Module):
    """1x1 expansion to ``cin * expand_ratio`` (none at ratio 1), a 3x3
    depthwise conv (``groups = hidden``) at the stride, each with BN and
    ReLU6, a 1x1 projection with BN; the input added where the stride is
    1 and the width is kept."""

    def __init__(self, cin: int, out_channels: int, stride: int,
                 expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.expand = expand_ratio != 1
        if self.expand:
            conv_bn_relu6(self, "expand", cin, hidden, 1)
        conv_bn_relu6(self, "depthwise", hidden, hidden, 3, stride,
                      groups=hidden)
        self.project_conv = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.project_bn = FrozenBatchNorm(out_channels)
        self.residual = stride == 1 and cin == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = run_bn_relu6(self, "expand", x) if self.expand else x
        out = run_bn_relu6(self, "depthwise", out)
        out = self.project_bn(self.project_conv(out))
        return out + x if self.residual else out


class MobileNetV2(nn.Module):
    """A 3x3 stride-2 stem (``_make_divisible(32 * widen_factor)``), then
    the seven stages of ``ARCH`` at ``_make_divisible(channels *
    widen_factor)``; stage i (0-based) is an output where i is in
    ``out_indices``. ``frozen_stages`` >= 0 stops the gradient after the
    stem and >= s after stage s (1-based), on the activations as JAX's
    ``stop_gradient``; the parameters before the last stop are frozen
    (``requires_grad=False``)."""

    def __init__(self, widen_factor: float = 1.0,
                 out_indices: Sequence[int] = (1, 2, 4, 6),
                 frozen_stages: int = -1):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        cin = _make_divisible(32 * widen_factor)
        conv_bn_relu6(self, "conv1", 3, cin, 3, 2)
        self.out_channels = []
        for si, (t, ch, n, s) in enumerate(ARCH):
            cout = _make_divisible(ch * widen_factor)
            for bi in range(n):
                setattr(self, f"layer{si + 1}_{bi}", InvertedResidual(
                    cin, cout, s if bi == 0 else 1, t))
                cin = cout
            if si in self.out_indices:
                self.out_channels.append(cout)
        freeze_before(self, ["conv1_"] + [
            f"layer{s}_" for s in range(1, frozen_stages + 1)],
            frozen_stages)

    def forward(self, x: torch.Tensor,
                sampling: Mapping[str, str] = TRAIN_SAMPLING
                ) -> Tuple[torch.Tensor, ...]:
        """``sampling`` is unused: MobileNetV2 has no deformable conv."""
        x = run_bn_relu6(self, "conv1", x)
        if self.frozen_stages >= 0:
            x = x.detach()
        outs = []
        for si, (_, _, n, _) in enumerate(ARCH):
            for bi in range(n):
                x = getattr(self, f"layer{si + 1}_{bi}")(x)
            if self.frozen_stages >= si + 1:
                x = x.detach()
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)
