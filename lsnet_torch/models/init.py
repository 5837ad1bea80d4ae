"""The training init of the detector's parameters (the initializers of the
JAX modules that ``model.init`` runs).

Each parameter is drawn from the distribution its flax module gives it:

* ``nn.Conv2d`` of the backbone and the neck (``GroupedConv`` included):
  ``kaiming_init``, He normal over fan_out (``lsnet_tpu/models/layers.py:28``);
* ``nn.Conv2d`` of the head: N(0, 0.01) (``normal_init``, ``:32``), the
  classifier's bias at the focal prior ``bias_init_with_prob(0.01)``
  (``:42``; ``ls_head.py:268-269``; in LSCPVHead and RepPointsV2Head also
  the corner-heatmap and semantic scores, ``lscpv_head.py:135-170``,
  ``reppoints.py:177-214``; in the Dense RepPoints heads the classifier,
  ``dense_reppoints.py:187``, and v2's semantic and contour scores,
  ``:276-279``), every other bias 0;
* the modules of LSCPVHead and RepPointsV2Head that keep the flax
  defaults (``lsnet_tpu/models/heads/lscpv_head.py``): the ConvModules of
  their corner-pool packs and ``sem_embedding`` ``kaiming_init``, the
  packs' bare ``p_conv1`` / ``conv1`` LeCun normal (truncated at 2 std,
  fan_in);
* the dense zoo's heads (``models/heads/dense.py``): every convolution
  N(0, 0.01), the focal prior on ``retina_cls``, ``fcos_cls``,
  ``atss_cls``, ``gfl_cls``, ``fovea_cls``, GA-RetinaNet's ``ga_cls`` and
  both GA heads' ``conv_loc`` (GA-RPN's ``ga_cls`` bias is 0, as in JAX,
  and so are SSD's ``cls_conv{i}``), FSAF's ``retina_reg`` bias 0.25, the
  ``adaption_offset*`` convs 0, so every guided-anchor offset starts at
  exactly 0, the raw ``adaption_weight*`` N(0, 0.01), the per-level
  ``scales`` 1;
* the modules that keep flax's ``nn.Conv`` defaults: every convolution
  of SSDVGG, and NASFCOSFPN's bare ``adapt_{i}``, ``out_conv`` and
  ``extra_{k}`` (its cells' ``input{1,2}_conv`` are ConvModules:
  ``kaiming_init``), LeCun normal (truncated at 2 std, fan_in), biases 0;
  SSDVGG's ``l2_norm_scale_param`` 20;
* the RepPoints heads' ``moment_transfer``: 0;
* ``conv_offset`` of a DCNv2 pack: 0 (``layers.py:146``), so every DCN
  starts as a plain conv;
* the DCNv2 weight: U(-s, s) with s = 1 / sqrt(cin_per_group * k * k), the
  torch ``reset_parameters`` scale;
* the pyramid (refine) deformable weights: He normal over fan_out in
  LSHead and the RepPoints heads, N(0, 0.01) in LSCPVHead;
* GroupNorm and FrozenBatchNorm: scale 1 and bias 0; the statistics mean 0
  and var 1.

The draws come from an explicit ``torch.Generator`` (the runner seeds it
with ``cfg.seed``); the numbers differ from JAX's, the distributions do
not. A parameter that no rule covers raises.
"""

from __future__ import annotations

import math
from typing import Set

import torch
from torch import nn

from .backbones.extra import L2_NORM_SCALE, SSDVGG
from .heads.dense import (FoveaHead, FSAFHead, GARetinaHead, GARPNHead,
                          RetinaHead, RetinaSepBNHead, ScaledHead, SSDHead)
from .heads.dense_reppoints import DenseRepPointsHead
from .heads.ls_head import LSHead
from .heads.lscpv_head import LSCPVHead
from .heads.reppoints import RepPointsHead, RepPointsV2Head
from .layers import (ConvModule, FrozenBatchNorm, ModulatedDeformConvPack,
                     PairedPyramidDeformConv, PyramidDeformConv)
from .necks.extra import NASFCOSFPN

PRIOR_PROB = 0.01
# head convolutions whose bias starts at the focal prior
PRIOR_BIASED = ("cls_out", "hem_tl_score_out", "hem_br_score_out",
                "sem_out", "cont_score_out", "retina_cls", "fcos_cls",
                "atss_cls", "gfl_cls", "fovea_cls", "conv_loc")
# the heads whose convolutions start at N(0, 0.01)
DENSE_HEADS = (RetinaHead, ScaledHead, GARetinaHead, GARPNHead, FoveaHead,
               SSDHead, RetinaSepBNHead)
# FSAF's regression bias at init: 0.25 x the TBLR normaliser 4, one
# stride each side
FSAF_REG_BIAS = 0.25
HEADS = (LSHead, LSCPVHead, RepPointsHead, DenseRepPointsHead) + DENSE_HEADS
# heads with the corner-pool packs, whose convolutions (name ends) keep
# the flax defaults: ConvModule's kaiming_init, nn.Conv's lecun_normal
CORNER_HEADS = (LSCPVHead, RepPointsV2Head)
CPV_KAIMING = ("p1_conv1.conv", "p2_conv1.conv", "conv2.conv",
               "sem_embedding.conv")
CPV_LECUN = ("p_conv1", "hem_tl.conv1", "hem_br.conv1")
# flax's truncated normal: the std of N(0, 1) truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def bias_init_with_prob(prior_prob: float) -> float:
    """The focal-loss classifier's bias: sigmoid(bias) = prior_prob."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def _normal_(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    p.copy_(std * torch.randn(p.shape, generator=gen))


def _he_fan_out_(p: torch.Tensor, fan_out: int, gen: torch.Generator):
    _normal_(p, math.sqrt(2.0 / fan_out), gen)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator
                  ) -> nn.Module:
    """Draw every parameter of ``model`` (a detector or any of its parts)
    from its JAX initializer, in place, in module order."""
    def members(kinds) -> Set[int]:
        return {id(m) for h in model.modules() if isinstance(h, kinds)
                for m in h.modules()}

    head_modules = members(HEADS)
    # GA-RetinaNet's 3x3 classifier starts at the prior, GA-RPN's 1x1 at 0
    prior_ids = {id(getattr(h, "ga_cls")) for h in model.modules()
                 if isinstance(h, GARetinaHead)}
    cpv_modules = members(CORNER_HEADS)
    normal_deform = members(LSCPVHead)
    # flax's nn.Conv default (LeCun normal): SSDVGG's convolutions, and
    # NASFCOSFPN's outside its ConvModules
    nas = [m for h in model.modules() if isinstance(h, NASFCOSFPN)
           for m in h.modules()]
    lecun = members(SSDVGG) | (
        {id(m) for m in nas if isinstance(m, nn.Conv2d)}
        - {id(m.conv) for m in nas if isinstance(m, ConvModule)})
    fsaf_reg = {id(h.retina_reg) for h in model.modules()
                if isinstance(h, FSAFHead)}
    done: Set[int] = set()

    def mark(*ps):
        done.update(id(p) for p in ps if p is not None)

    for name, m in model.named_modules():
        if isinstance(m, (FrozenBatchNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, FrozenBatchNorm):
                m.mean.zero_()
                m.var.fill_(1.0)
            mark(m.weight, m.bias)
        elif isinstance(m, nn.Conv2d):
            cpv = id(m) in cpv_modules
            cout, cin, kh, kw = m.weight.shape          # OIHW
            if name.endswith(("conv_offset", "adaption_offset",
                              "adaption_offset_cls", "adaption_offset_reg")):
                m.weight.zero_()
            elif (cpv and name.endswith(CPV_LECUN)) or id(m) in lecun:
                std = math.sqrt(1.0 / (cin * kh * kw)) / TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
            elif id(m) in head_modules and not (
                    cpv and name.endswith(CPV_KAIMING)):
                _normal_(m.weight, 0.01, generator)
            else:
                _he_fan_out_(m.weight, cout * kh * kw, generator)
            if m.bias is not None:
                m.bias.zero_()
                if id(m) in head_modules and (
                        name.endswith(PRIOR_BIASED) or id(m) in prior_ids):
                    m.bias.fill_(bias_init_with_prob(PRIOR_PROB))
                if id(m) in fsaf_reg:
                    m.bias.fill_(FSAF_REG_BIAS)
            mark(m.weight, m.bias)
        elif isinstance(m, ModulatedDeformConvPack):
            k, _, cin_g, _ = m.weight.shape
            s = 1.0 / math.sqrt(cin_g * k * k)
            m.weight.copy_(torch.rand(m.weight.shape, generator=generator)
                           * (2 * s) - s)
            if m.bias is not None:
                m.bias.zero_()
            mark(m.weight, m.bias)
        elif isinstance(m, DENSE_HEADS):
            for pname, p in m.named_parameters(recurse=False):
                if pname == "scales":
                    p.fill_(1.0)
                else:                               # adaption_weight*
                    _normal_(p, 0.01, generator)
                mark(p)
        elif isinstance(m, SSDVGG):
            m.l2_norm_scale_param.fill_(L2_NORM_SCALE)
            mark(m.l2_norm_scale_param)
        elif isinstance(m, RepPointsHead) and hasattr(m, "moment_transfer"):
            m.moment_transfer.zero_()
            mark(m.moment_transfer)
        elif isinstance(m, (PyramidDeformConv, PairedPyramidDeformConv)):
            for p in m.parameters(recurse=False):   # HWIO
                if id(m) in normal_deform:
                    _normal_(p, 0.01, generator)
                else:
                    _he_fan_out_(p, p.shape[0] * p.shape[1] * p.shape[3],
                                 generator)
                mark(p)
    left = [n for n, p in model.named_parameters() if id(p) not in done]
    if left:
        raise NotImplementedError(f"init_weights_: no JAX initializer for "
                                  f"{left[:5]}")
    return model
