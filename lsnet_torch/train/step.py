"""The train step (counterpart of ``lsnet_tpu/train/step.py``
``make_train_step``): forward + loss + backward + clip + SGD update on one
device.

Mixed precision as in the JAX package: f32 master parameters; inside the
differentiated call the parameters and the FrozenBatchNorm statistics are
cast to bf16 (so the gradients arrive in f32 at the masters through the
cast) and the image is bf16; the head outputs are cast back to f32 before
assignment and the losses. This is not ``torch.autocast``, which rounds at
other places. The bf16 copies stand in for the masters until the gradients
are taken: a ``with_cp`` backbone recomputes its blocks in the backward and
must see the same copies there. The update is in place (JAX returns a new
state).

A full loss (JAX's ``make_train_step(..., full_loss_fn=)``) replaces the
forward and the head's loss: the two-stage detectors' losses call the
model's ``extract`` / ``rpn`` / ``roi_forward`` themselves, on the bf16
copies and the bf16 image, and cast to f32 where they assign and sum.

``grad_norm`` is the global norm before the clip over the trainable
parameters, the norm the clip sees; the JAX step's metric also counts the
gradients of the frozen stage, which the port never computes.

Under W ranks (``lsnet_torch.parallel``) the step takes the global batch
on every rank and computes the one-process step on it, as JAX's jitted
mesh step does: the rank runs the model on its rows; a head's outputs are
gathered and every rank takes the whole batch's loss, or a full loss runs
on the rank's rows with the global batch's normalisers and its terms are
summed; the gradients are summed over the ranks before the clip. Every
rank's update and metrics are then the same. In one process nothing of
this runs.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch.nn.utils.stateless import _reparametrize_module

from ..core.cpv import CPVLossConfig, lscpv_loss
from ..core.dense_loss import DenseLossConfig, dense_loss
from ..core.dense_reppoints import (DenseRepPointsConfig,
                                    DenseRepPointsV2Config,
                                    dense_reppoints_loss,
                                    dense_reppoints_v2_loss)
from ..core.loss import LossConfig, lsnet_loss
from ..core.reppoints import (RepPointsConfig, RepPointsV2Config,
                              reppoints_loss, reppoints_v2_loss)
from ..core.two_stage import (TWO_STAGE_LOSSES, TwoStageConfig,
                              two_stage_loss)
from ..ops.flat_deform import TRAIN_SAMPLING
from .. import parallel
from .optim import ClippedSGD

# the loss of each head family, by its config's type
LOSSES = {LossConfig: lsnet_loss, CPVLossConfig: lscpv_loss,
          RepPointsConfig: reppoints_loss,
          RepPointsV2Config: reppoints_v2_loss,
          DenseRepPointsConfig: dense_reppoints_loss,
          DenseRepPointsV2Config: dense_reppoints_v2_loss,
          DenseLossConfig: dense_loss}
LossCfg = Union[LossConfig, CPVLossConfig, RepPointsConfig,
                DenseRepPointsConfig, DenseLossConfig, TwoStageConfig]
# full_loss_fn(model, batch, sampling) -> (total, losses)
FullLoss = Callable[[torch.nn.Module, Mapping[str, torch.Tensor],
                     Mapping[str, str]],
                    Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def as_f32(outs: Mapping[str, object]) -> Dict[str, object]:
    """The head's outputs in f32: each level map of a list, and a tensor
    output (the RepPoints ``moment``) itself."""
    return {k: v.float() if isinstance(v, torch.Tensor)
            else [m.float() for m in v] for k, v in outs.items()}


def make_train_step(model: torch.nn.Module, optimizer: ClippedSGD,
                    loss_cfg: LossCfg,
                    mixed_precision: bool = True,
                    sampling: Mapping[str, str] = TRAIN_SAMPLING,
                    full_loss_fn: Optional[FullLoss] = None
                    ) -> Callable[[Mapping[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``: one update of ``model`` in place.

    ``full_loss_fn(model, batch, sampling) -> (total, losses)``, where
    given, is the whole loss; a ``TwoStageConfig`` takes the detector's
    own loss (``core.two_stage.TWO_STAGE_LOSSES``: ``mask_rcnn_loss``,
    ``mask_scoring_rcnn_loss``, ``point_rend_loss``,
    ``cascade_rcnn_loss``, ``grid_rcnn_loss``, ``htc_loss``) or else
    ``two_stage_loss`` by default. Otherwise the loss is the one
    ``LOSSES`` names for the config's type:
    ``lsnet_loss`` for a ``LossConfig``, ``lscpv_loss`` for a
    ``CPVLossConfig`` (the CPV head), ``reppoints_loss`` /
    ``reppoints_v2_loss`` / ``dense_reppoints_loss`` /
    ``dense_reppoints_v2_loss`` for the RepPoints family's, ``dense_loss``
    (by the config's head kind) for the dense zoo's. batch:
    ``image`` (B, H, W, 3) NHWC and the keys of the loss, on the model's
    device.
    metrics: ``loss``, the loss terms and the pre-clip ``grad_norm``, as
    tensors on the device (no synchronisation). Under W ranks ``batch`` is
    the global batch, the same on every rank."""
    if full_loss_fn is None and isinstance(loss_cfg, TwoStageConfig):
        ts_loss = TWO_STAGE_LOSSES.get(type(model).__name__, two_stage_loss)

        def full_loss_fn(m, batch, smp):
            return ts_loss(m, batch, loss_cfg, smp)
    loss_fn = None if full_loss_fn else LOSSES[type(loss_cfg)]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    masters = dict(model.named_parameters())
    if [id(masters[n]) for n in names] != [id(p) for p in optimizer.params]:
        raise ValueError("the optimizer does not hold the model's trainable "
                         "parameters in order")

    def compute_copies():
        """The model's tensors in the compute dtype, for the forward and
        the backward."""
        if not mixed_precision:
            return contextlib.nullcontext()
        cast = {n: t.to(torch.bfloat16) if t.is_floating_point() else t
                for n, t in (*model.named_parameters(),
                             *model.named_buffers())}
        return _reparametrize_module(model, cast)

    def step(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image = parallel.shard_rows(batch["image"])
        if mixed_precision:
            image = image.to(torch.bfloat16)
        with compute_copies():
            if full_loss_fn is not None:
                total, losses = full_loss_fn(
                    model, {**parallel.shard_batch_pytree(batch),
                            "image": image}, sampling)
            else:
                # assignment and losses in f32, over the global batch
                outs = parallel.gather_outputs(as_f32(model(image, sampling)))
                total, losses = loss_fn(outs, batch, loss_cfg)
            grads = torch.autograd.grad(total, optimizer.params)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        if full_loss_fn is not None:
            # each rank's terms are its share of the global loss; the
            # statistics (``stat_*``) are the global batch's already
            metrics = {k: v if k.startswith("stat_")
                       else parallel.all_reduce_sum(v)
                       for k, v in metrics.items()}
        metrics["grad_norm"] = optimizer.step(
            parallel.reduce_gradients(grads))
        return metrics

    return step
