"""Feature Pyramid Network (counterpart of ``lsnet_tpu/models/necks/fpn.py``):
``start_level``, ``num_outs``, GN, no activation on the lateral and output
convs, nearest top-down upsampling. The levels past the inputs are
stride-2 3x3 convs on the last input (``add_extra_convs='on_input'``, as
LSNet configures it) or on the last output (``'on_output'``, FCOS's
file); with ``add_extra_convs=None`` (the JAX module's default, GA-RPN's
file), stride-2 subsampling of the last output (flax's 1x1 max pool).
The JAX module's ``'on_lateral'`` and ``relu_before_extra_convs`` are
not ported: no file the port runs sets them."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..layers import ConvModule


def upsample_nearest_to(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Nearest upsample of NCHW x to (th, tw) with the integer source
    indices (i * H) // th. ``F.interpolate(mode="nearest")`` computes a
    float scale instead, which can pick other rows on odd sizes."""
    H, W = x.shape[-2:]
    ridx = torch.arange(th, device=x.device) * H // th
    cidx = torch.arange(tw, device=x.device) * W // tw
    return x.index_select(2, ridx).index_select(3, cidx)


class FPN(nn.Module):

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, start_level: int = 0,
                 add_extra_convs: Optional[str] = None,
                 norm_cfg: Optional[dict] = None):
        super().__init__()
        if add_extra_convs not in (None, "on_input", "on_output"):
            raise NotImplementedError(f"add_extra_convs={add_extra_convs!r}")
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        used = list(in_channels[start_level:])
        self.n_used = len(used)
        self.n_extra = num_outs - self.n_used
        for i, c in enumerate(used):
            setattr(self, f"lateral_{i}", ConvModule(
                c, out_channels, 1, norm_cfg=norm_cfg, act=None))
            setattr(self, f"fpn_{i}", ConvModule(
                out_channels, out_channels, 3, norm_cfg=norm_cfg, act=None))
        if add_extra_convs is None:
            return
        for k in range(self.n_extra):
            cin = (used[-1] if k == 0 and add_extra_convs == "on_input"
                   else out_channels)
            setattr(self, f"extra_{k}", ConvModule(
                cin, out_channels, 3, stride=2, norm_cfg=norm_cfg, act=None))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        used = list(inputs[self.start_level:])
        laterals = [getattr(self, f"lateral_{i}")(used[i])
                    for i in range(self.n_used)]
        for i in range(self.n_used - 1, 0, -1):
            th, tw = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + upsample_nearest_to(
                laterals[i], th, tw)
        outs = [getattr(self, f"fpn_{i}")(laterals[i])
                for i in range(self.n_used)]
        if self.add_extra_convs is None:
            for _ in range(self.n_extra):
                outs.append(outs[-1][..., ::2, ::2])
            return tuple(outs)
        src = used[-1] if self.add_extra_convs == "on_input" else outs[-1]
        for k in range(self.n_extra):
            src = getattr(self, f"extra_{k}")(src)
            outs.append(src)
        return tuple(outs)
