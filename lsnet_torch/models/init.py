"""The training init of the detector's parameters (the initializers of the
JAX modules that ``model.init`` runs).

Each parameter is drawn from the distribution its flax module gives it:

* ``nn.Conv2d`` of the backbone and the neck (``GroupedConv`` included):
  ``kaiming_init``, He normal over fan_out (``lsnet_tpu/models/layers.py:28``);
  so every convolution of HRNet, RegNet (grouped), HourglassNet and
  MobileNetV2 (depthwise: fan_out k x k x cout), and the ConvModules of
  PAFPN, BFP, NAS-FPN, HRFPN and FPN_CARAFE (bias 0), as JAX's ``_conv``
  and ``ConvModule`` draw them;
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
* the two-stage heads (``models/heads/two_stage.py``): the RPN's
  convolutions N(0, 0.01); the RoI heads' ``nn.Linear``s (flax
  ``nn.Dense``) LeCun normal (truncated at 2 std, fan_in), but ``fc_cls``
  N(0, 0.01) and ``fc_reg`` N(0, 0.001); the Double-Head convolutions
  flax's ``nn.Conv`` default, LeCun normal; every bias 0;
* the mask branch (the same file): ``mask_conv*`` and ``maskiou_conv*``
  N(0, 0.01), ``mask_logits`` N(0, 0.001); ``mask_upsample`` (flax's
  ``nn.ConvTranspose`` default), the MaskIoU head's FCs and the point
  head's FCs LeCun normal (fan_in); every bias 0;
* the cascade's heads (Cascade R-CNN, DetectoRS, HTC): the RoI heads'
  rules; Grid R-CNN's ``GridHead`` and HTC's ``FusedSemanticHead``: flax's
  ``nn.Conv`` / ``nn.ConvTranspose`` defaults, LeCun normal (fan_in: a
  depthwise 5x5 has 25); HTC's ``HTCMaskHead``: ``mask_conv*`` N(0, 0.01),
  ``mask_logits`` N(0, 0.001), ``conv_res`` and ``mask_upsample`` LeCun
  normal; every bias 0;
* ``SAConv`` (DetectoRS' backbone): ``weight`` ``kaiming_init``, He
  normal over fan_out (k x k x cout), ``weight_diff`` 0, ``aws_gamma`` 1,
  ``aws_beta`` 0, ``pre_context`` and ``post_context`` 0 (kernel and
  bias), ``switch`` kernel 0 and bias 1 (``layers.py:304-365``): every SAC
  starts as the standardised conv at its own dilation;
* RFP's convolutions (ConvModules): ``kaiming_init``;
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
from .heads.two_stage import (DoubleConvFCBBoxHead, FCNMaskHead,
                              FusedSemanticHead, GridHead, HTCMaskHead,
                              MaskIoUHead, RPNHead)
from .layers import (ConvModule, FrozenBatchNorm, ModulatedDeformConvPack,
                     PairedPyramidDeformConv, PyramidDeformConv, SAConv)
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
HEADS = (LSHead, LSCPVHead, RepPointsHead, DenseRepPointsHead,
         RPNHead, FCNMaskHead, MaskIoUHead, HTCMaskHead) + DENSE_HEADS
# head convolutions that start at another std than N(0, 0.01)
CONV_STD = {"mask_logits": 0.001}
# the RoI heads' classifier and regressor (flax nn.Dense) and their stds
DENSE_STD = {"fc_cls": 0.01, "fc_reg": 0.001}
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


def _lecun_(p: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's LeCun normal: N(0, 1 / fan_in) truncated at 2 std."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)


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
    lecun = members(SSDVGG) | members(DoubleConvFCBBoxHead) | members(
        (GridHead, FusedSemanticHead)) | (
        {id(m) for m in nas if isinstance(m, nn.Conv2d)}
        - {id(m.conv) for m in nas if isinstance(m, ConvModule)}) | {
        id(h.conv_res) for h in model.modules()
        if isinstance(h, HTCMaskHead) and hasattr(h, "conv_res")}
    # SAConv's context convs start at 0, its switch with bias 1
    sac = [m for m in model.modules() if isinstance(m, SAConv)]
    sac_zero = {id(c) for m in sac
                for c in (m.pre_context, m.switch, m.post_context)}
    switches = {id(m.switch) for m in sac}
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
                              "adaption_offset_cls", "adaption_offset_reg")
                             ) or id(m) in sac_zero:
                m.weight.zero_()
            elif (cpv and name.endswith(CPV_LECUN)) or id(m) in lecun:
                _lecun_(m.weight, cin * kh * kw, generator)
            elif id(m) in head_modules and not (
                    cpv and name.endswith(CPV_KAIMING)):
                _normal_(m.weight, CONV_STD.get(name.rsplit(".", 1)[-1],
                                                0.01), generator)
            else:
                _he_fan_out_(m.weight, cout * kh * kw, generator)
            if m.bias is not None:
                m.bias.zero_()
                if id(m) in head_modules and (
                        name.endswith(PRIOR_BIASED) or id(m) in prior_ids):
                    m.bias.fill_(bias_init_with_prob(PRIOR_PROB))
                if id(m) in fsaf_reg:
                    m.bias.fill_(FSAF_REG_BIAS)
                if id(m) in switches:
                    m.bias.fill_(1.0)
            mark(m.weight, m.bias)
        elif isinstance(m, nn.ConvTranspose2d):
            cin, _, kh, kw = m.weight.shape             # IOHW
            _lecun_(m.weight, cin * kh * kw, generator)
            m.bias.zero_()
            mark(m.weight, m.bias)
        elif isinstance(m, nn.Linear):
            leaf = name.rsplit(".", 1)[-1]
            if leaf in DENSE_STD:
                _normal_(m.weight, DENSE_STD[leaf], generator)
            else:
                _lecun_(m.weight, m.in_features, generator)
            m.bias.zero_()
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
        elif isinstance(m, SAConv):
            k, _, _, cout = m.weight.shape              # HWIO
            _he_fan_out_(m.weight, k * k * cout, generator)
            m.weight_diff.zero_()
            m.aws_gamma.fill_(1.0)
            m.aws_beta.zero_()
            mark(m.weight, m.weight_diff, m.aws_gamma, m.aws_beta)
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
