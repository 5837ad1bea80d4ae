"""Model FLOPs of a batch, counted on the reference model (on the ``meta``
device: shapes only, nothing computed).

The forward: ``torch.utils.flop_counter.FlopCounterMode`` over the
reference's forward (2 FLOPs a multiply-add of every convolution and
product), with each deformable contraction counted by its product
``2 * K * (C / groups) * cout * px`` and whatever the counter saw inside
it left out. A train step: the forward, plus the data gradient of every
layer after the first trainable one, plus the weight gradient of every
trainable layer (each as many FLOPs as its forward); the frozen stem and
stage 1 take neither.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref


class _Tally(list):
    """Receives a module's contractions as (FLOPs, trainable)."""

    def __init__(self, seq):
        super().__init__()
        self.seq = seq

    def append(self, item):
        self.seq.append(("dcn", item[0], item[1].requires_grad))


def count(model_cfg: Dict, batch: int, canvas: Sequence[int],
          sampling: Dict[str, str], counter: bool = False) -> Dict[str, int]:
    """{"forward": FLOPs, "train": FLOPs} of one batch: one image's,
    times the batch (every layer's work is linear in it). Each conv's
    FLOPs come from its output's shape, as the counter counts them; with
    ``counter`` the forward also runs under ``FlopCounterMode`` and
    ``"counter"`` holds what it saw (the convs and the contractions'
    products), a check of the arithmetic that takes some ten seconds
    more."""
    with torch.device("meta"):
        net = ref.build(model_cfg)
        images = torch.zeros(1, canvas[0], canvas[1], 3)
    seq = []                     # (kind, FLOPs, trainable) in call order

    def conv_hook(mod, inp, out):
        k = mod.weight.shape[2] * mod.weight.shape[3]
        seq.append(("conv", 2 * out.numel() * (mod.in_channels // mod.groups)
                    * k, mod.weight.requires_grad))

    handles = [m.register_forward_hook(conv_hook) for m in net.modules()
               if isinstance(m, nn.Conv2d)]
    for m in net.modules():
        if hasattr(m, "tally"):
            m.tally = _Tally(seq)
    mode = (FlopCounterMode(display=False) if counter
            else contextlib.nullcontext())
    try:
        with torch.no_grad(), mode:
            net(images, sampling)
    finally:
        for h in handles:
            h.remove()
    convs = sum(f for kind, f, _ in seq if kind == "conv")
    dcn = sum(f for kind, f, _ in seq if kind == "dcn")
    forward = convs + dcn
    first = next(i for i, (_, _, t) in enumerate(seq) if t)
    data = sum(f for _, f, _ in seq[first + 1:])
    weight = sum(f for _, f, t in seq if t)
    out = {"forward": int(forward) * batch,
           "train": int(forward + data + weight) * batch}
    if counter:
        out["counter"] = int(mode.get_total_flops()) * batch
    return out
