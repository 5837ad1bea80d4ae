"""The train step (counterpart of ``lsnet_tpu/train/step.py``
``make_train_step``): forward + loss + backward + clip + SGD update on one
device.

Mixed precision as in the JAX package: f32 master parameters; inside the
differentiated call the parameters and the FrozenBatchNorm statistics are
cast to bf16 (so the gradients arrive in f32 at the masters through the
cast) and the image is bf16; the head outputs are cast back to f32 before
assignment and the losses. This is not ``torch.autocast``, which rounds at
other places. The update is in place (JAX returns a new state).

``grad_norm`` is the global norm before the clip over the trainable
parameters, the norm the clip sees; the JAX step's metric also counts the
gradients of the frozen stage, which the port never computes.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from ..core.loss import LossConfig, lsnet_loss
from ..ops.flat_deform import TRAIN_SAMPLING
from .optim import ClippedSGD


def make_train_step(model: torch.nn.Module, optimizer: ClippedSGD,
                    loss_cfg: LossConfig, mixed_precision: bool = True,
                    sampling: Mapping[str, str] = TRAIN_SAMPLING
                    ) -> Callable[[Mapping[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]:
    """``step(batch) -> metrics``: one update of ``model`` in place.

    batch: ``image`` (B, H, W, 3) NHWC and the keys of
    :func:`lsnet_torch.core.loss.lsnet_loss`, on the model's device.
    metrics: ``loss``, the loss terms and the pre-clip ``grad_norm``, as
    tensors on the device (no synchronisation)."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    masters = dict(model.named_parameters())
    if [id(masters[n]) for n in names] != [id(p) for p in optimizer.params]:
        raise ValueError("the optimizer does not hold the model's trainable "
                         "parameters in order")

    def forward(image: torch.Tensor):
        if not mixed_precision:
            return model(image, sampling)
        cast = {n: t.to(torch.bfloat16) if t.is_floating_point() else t
                for n, t in (*model.named_parameters(),
                             *model.named_buffers())}
        return torch.func.functional_call(
            model, cast, (image.to(torch.bfloat16), sampling))

    def step(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        outs = forward(batch["image"])
        # assignment and losses in f32
        outs = {k: [m.float() for m in v] for k, v in outs.items()}
        total, losses = lsnet_loss(outs, batch, loss_cfg)
        grads = torch.autograd.grad(total, optimizer.params)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = optimizer.step(grads)
        return metrics

    return step
