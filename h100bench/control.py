"""The control of the check: the reference with the operands of every
product (each convolution and each deformable contraction) rounded to a
precision below the configuration's, products accumulated in float32.

``fp8``: float8 e4m3 with one scale a tensor (its largest magnitude at
448), the step below the configured bfloat16. The rounding passes the
gradient straight through, so a train step runs under it too.
"""

from __future__ import annotations

import types

import torch
from torch import nn



def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


PRECISIONS = {"fp8": fp8}


def _rounded_forward(rnd):
    def forward(self, x):
        return self._conv_forward(rnd(x), rnd(self.weight), self.bias)
    return forward


def lowered(net: nn.Module, precision: str) -> nn.Module:
    """``net`` (in place) with its products rounded to ``precision``: its
    convolutions' and its deformable contractions' operands."""
    rnd = PRECISIONS[precision]
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            m.forward = types.MethodType(_rounded_forward(rnd), m)
        elif hasattr(m, "round_fn"):
            m.round_fn = rnd
    return net
