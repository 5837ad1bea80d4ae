"""Checkpoints of the runner (counterpart of ``lsnet_tpu/train/checkpoint.py``
``train_meta``, ``save_checkpoint``, ``restore_checkpoint``,
``restore_eval_state``, ``latest_checkpoint``, and of the deploy policy of
``lsnet_tpu/ops/flat_deform.py`` ``deploy_sampling_spec`` /
``arm_deploy_policy``).

One file per save, ``step_{N}.pt``, readable by
``torch.load(weights_only=True)``. It holds the step, the model's state
dict (the f32 master parameters and the FrozenBatchNorm statistics), the
``ClippedSGD`` state (momentum buffers and ``count``) and the train meta,
all in the one file: pruning a checkpoint removes its meta with it.

The meta records the train sampling as the JAX spec string
(``dcn_sampling_train``: ``"bilinear"`` or sorted ``site=mode,...``), so
metas read the same in both packages. :func:`deploy_sampling` turns it
into the site->mode mapping an evaluation of the checkpoint runs with. It
is a pure function: no process-wide default is armed, so restoring one
checkpoint cannot change how a later one deploys.
"""

from __future__ import annotations

import os
import re
from types import MappingProxyType
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from ..ops.flat_deform import (INFERENCE_SAMPLING, SITES, sampling_from_spec,
                               sampling_spec)
from .optim import ClippedSGD

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def train_meta(spec: Optional[str] = None) -> Dict[str, Any]:
    """The train-time record of a save: the train sampling spec (None is
    bilinear everywhere) in the JAX package's form."""
    return {"dcn_sampling_train": sampling_spec(spec)}


def deploy_sampling(meta: Optional[Mapping[str, Any]]) -> Mapping[str, str]:
    """The site->mode mapping a checkpoint deploys with: a site trained
    ``nearest_ste`` deploys ``nearest`` (its offsets live on the rounded
    lattice), another non-bilinear site as trained, and a bilinear site at
    the shipped default ``INFERENCE_SAMPLING``. No meta: the default."""
    if not meta:
        return INFERENCE_SAMPLING
    if meta.get("refine_taps_train"):
        raise NotImplementedError(
            "a checkpoint trained on refine taps "
            f"{meta['refine_taps_train']!r}: refine taps 5 are not ported "
            "yet (ROADMAP Queue 1 item 3)")
    train = sampling_from_spec(meta.get("dcn_sampling_train"))
    deploy = {}
    for site in SITES:
        mode = train[site]
        if mode == "nearest_ste":
            deploy[site] = "nearest"
        elif mode != "bilinear":
            deploy[site] = mode
        else:
            deploy[site] = INFERENCE_SAMPLING[site]
    return MappingProxyType(deploy)


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module,
                    optimizer: ClippedSGD, step: int,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``ckpt_dir/step_{step}.pt`` (through a temporary file, so a
    reader never sees half a checkpoint) and return its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}.pt"))
    payload = {
        "step": int(step),
        "model": {k: v.detach().cpu() for k, v in
                  model.state_dict().items()},
        "optimizer": _to_cpu(optimizer.state_dict()),
        "meta": dict(train_meta() if meta is None else meta),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _to_cpu(state: Dict[str, Any]) -> Dict[str, Any]:
    return {"count": int(state["count"]),
            "momentum": [None if b is None else b.detach().cpu()
                         for b in state["momentum"]]}


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The raw contents of a checkpoint file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[ClippedSGD] = None
                       ) -> Dict[str, Any]:
    """Load the model (strict) and, when given, the optimizer from
    ``path`` in place; return ``{"step", "meta"}``."""
    ckpt = load_checkpoint(path)
    model.load_state_dict(ckpt["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
    return {"step": int(ckpt["step"]), "meta": dict(ckpt["meta"])}


def restore_eval_state(path: str
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(model state dict, meta) of a checkpoint: what an evaluation needs,
    without the optimizer state."""
    ckpt = load_checkpoint(path)
    return ckpt["model"], dict(ckpt["meta"])


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """The steps of the ``step_{N}.pt`` files in ``ckpt_dir``, sorted."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in
                  map(_STEP_FILE.fullmatch, os.listdir(ckpt_dir)) if m)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The path of the highest ``step_{N}.pt`` in ``ckpt_dir``, or None."""
    steps = checkpoint_steps(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{steps[-1]}.pt") if steps else None
