"""Checkpoints of the runner (counterpart of ``lsnet_tpu/train/checkpoint.py``
``train_meta``, ``save_checkpoint``, ``restore_checkpoint``,
``restore_eval_state``, ``latest_checkpoint``, and of the deploy policy of
``lsnet_tpu/ops/flat_deform.py`` ``deploy_sampling_spec`` /
``arm_deploy_policy``), and the loader of reference weights (the
counterpart of ``convert_torch_backbone``, ``convert_torch_neck``,
``convert_torch_lshead`` and ``load_pretrained_backbone``).

One file per save, ``step_{N}.pt``, readable by
``torch.load(weights_only=True)``. It holds the step, the model's state
dict (the f32 master parameters and the FrozenBatchNorm statistics), the
``ClippedSGD`` state (momentum buffers and ``count``) and the train meta,
all in the one file: pruning a checkpoint removes its meta with it.

Reference weights are ``state_dict``s in the key space of torchvision and
mmdet (``layer1.0.downsample.0.weight``, ``bn1.running_mean``,
``bbox_head.pts_bbox_refine_conv.weight``). The ``convert_torch_*``
functions turn one into a ``state_dict`` fragment in the port's names
(``layer1_0.downsample_conv.weight``, ``bn1.mean``,
``pts_bbox_cls_pair.weight_a``), keyed from the backbone, neck or head
module, ready for its ``load_state_dict``. A key they do not recognise
raises: a partial load never passes silently.

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
from collections import OrderedDict
from types import MappingProxyType
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.heads.ls_head import MAIN_BRANCH
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
            "yet (ROADMAP Queue 1 \"Leftovers on the surface already "
            "ported\")")
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


# ------------------------------------------------------- reference weights

def _tensor(val) -> torch.Tensor:
    """A ``state_dict`` value (tensor or array) as a contiguous f32 CPU
    tensor of its own."""
    if isinstance(val, torch.Tensor):
        t = val.detach().to("cpu")
    else:
        t = torch.from_numpy(np.array(val))
    return t.to(torch.float32).clone().contiguous()


def _dcn_layout(oihw: torch.Tensor) -> torch.Tensor:
    """A deformable weight (cout, cin/G, kh, kw) -> the port's
    (kh, kw, cin/G, cout) (group-major cout, as the reference)."""
    return oihw.permute(2, 3, 1, 0).contiguous()


def _strip_module(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def _refuse(unknown: List[str], what: str) -> None:
    if unknown:
        raise ValueError(f"{what} keys not recognized (partial load "
                         f"refused): {sorted(unknown)[:20]}")


# the mmdet deep stem's Sequential(conv, norm, relu) x 3 -> the port's
# names (JAX ``_DEEP_STEM_MAP``)
_DEEP_STEM_MAP = {"0": "stem_conv1", "1": "stem_bn1",
                  "3": "stem_conv2", "4": "stem_bn2",
                  "6": "stem_conv3", "7": "stem_bn3"}


def convert_torch_backbone(state_dict: Mapping[str, Any]
                           ) -> "OrderedDict[str, torch.Tensor]":
    """A reference backbone ``state_dict`` -> the port's ``ResNet`` keys.

    The key spaces of ``lsnet_tpu/train/checkpoint.py``
    ``convert_torch_backbone``: torchvision ``layerS.B.convN`` /
    ``downsample.{0,1}`` names; mmdet full-detector dicts, whose
    ``backbone.`` keys are taken and neck and head keys skipped; a
    ``module.`` prefix; DCNv2 packs, a ``convN.weight`` beside
    ``convN.conv_offset.*``, whose weight goes to the port's compact
    (k, k, cin/G, cout) layout; Res2Net v1d: the scale branches
    ``convs.i`` / ``bns.i`` -> ``conv2_i`` / ``bn2_i`` (DCN packs among
    them), the deep stem ``stem.{0..7}`` -> ``stem_conv{1,2,3}`` /
    ``stem_bn{1,2,3}``. The downsample's conv and norm are told apart by
    rank, not index (the avg-down Sequential puts them at 1 and 2).
    ``num_batches_tracked`` and ``fc.*`` are skipped; any other key raises
    ``ValueError``."""
    has_prefix = any(_strip_module(k).startswith("backbone.")
                     for k in state_dict)
    items = OrderedDict()
    for key, val in state_dict.items():
        k = _strip_module(key)
        if has_prefix:
            if not k.startswith("backbone."):
                continue                      # neck., bbox_head., ...
            k = k[len("backbone."):]
        items[k] = val
    dcn = {k.rsplit(".conv_offset.", 1)[0] for k in items
           if ".conv_offset." in k}

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    unknown = []
    for key, val in items.items():
        if key.endswith("num_batches_tracked") or key.startswith("fc."):
            continue
        parts = key.split(".")
        t = _tensor(val)
        m = re.fullmatch(r"layer(\d+)", parts[0])
        path = None
        if parts[0] in ("conv1", "bn1") and len(parts) == 2:
            path = parts[:1]
        elif parts[0] == "stem" and len(parts) == 3 \
                and parts[1] in _DEEP_STEM_MAP:
            path = [_DEEP_STEM_MAP[parts[1]]]
        elif m and len(parts) >= 4:
            path = [f"layer{m.group(1)}_{parts[1]}"] + parts[2:-1]
            if path[1] == "downsample":
                path = path[:1] + ["downsample_conv" if t.dim() == 4
                                   else "downsample_bn"] + path[3:]
            elif path[1] in ("convs", "bns") and len(path) >= 3:
                base = "conv2" if path[1] == "convs" else "bn2"
                path = path[:1] + [f"{base}_{path[2]}"] + path[3:]
        if path is None:
            unknown.append(key)
            continue
        leaf = parts[-1]
        src = key.rsplit(".", 1)[0]
        if leaf == "weight" and t.dim() == 4:
            if src in dcn:
                t = _dcn_layout(t)
        elif leaf in ("running_mean", "running_var"):
            leaf = leaf[len("running_"):]
        elif not (leaf == "bias" or (leaf == "weight" and t.dim() == 1)):
            unknown.append(key)
            continue
        out[".".join(path + [leaf])] = t
    _refuse(unknown, "backbone")
    return out


def convert_torch_neck(state_dict: Mapping[str, Any]
                       ) -> "OrderedDict[str, torch.Tensor]":
    """A reference FPN ``state_dict`` (mmdet ``necks/fpn.py`` names) -> the
    port's ``FPN`` keys: ``lateral_convs.i`` -> ``lateral_i``,
    ``fpn_convs.j`` -> ``fpn_j`` below the lateral count and
    ``extra_{j - n}`` from it (the reference appends its extra convs to
    ``fpn_convs``), a ConvModule's ``gn`` / ``bn`` -> ``norm``. A
    ``neck.`` prefix is taken off; backbone and head keys are skipped."""
    items = OrderedDict()
    for key, val in state_dict.items():
        k = _strip_module(key)
        if k.startswith("neck."):
            k = k[len("neck."):]
        elif k.startswith(("backbone.", "bbox_head.", "roi_head.")):
            continue
        items[k] = val
    n_lat = len({k.split(".")[1] for k in items
                 if k.startswith("lateral_convs.")})
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    unknown = []
    for key, val in items.items():
        parts = key.split(".")
        if len(parts) != 4 or not parts[1].isdigit() or \
                parts[0] not in ("lateral_convs", "fpn_convs"):
            unknown.append(key)
            continue
        j = int(parts[1])
        mod = (f"lateral_{j}" if parts[0] == "lateral_convs"
               else f"fpn_{j}" if j < n_lat else f"extra_{j - n_lat}")
        sub, leaf = parts[2], parts[3]
        if leaf == "num_batches_tracked":
            continue
        if sub in ("gn", "bn"):
            sub = "norm"
        if sub not in ("conv", "norm") or leaf not in ("weight", "bias"):
            unknown.append(key)
            continue
        out[f"{mod}.{sub}.{leaf}"] = _tensor(val)
    _refuse(unknown, "neck")
    return out


_HEAD_BRANCH = r"(cls|bbox|segm|pose)"


def convert_torch_lshead(state_dict: Mapping[str, Any], task: str = "bbox"
                         ) -> "OrderedDict[str, torch.Tensor]":
    """A reference LSHead ``state_dict`` (``lsnet_head.py`` names) -> the
    port's ``LSHead`` keys, the norm-conv towers:

    * ``{b}_convs.i.conv`` / ``.gn`` -> ``{b}_convs_i.conv`` / ``.norm``;
    * ``{b}_GN``, ``pts_{t}_init_conv`` / ``_init_out`` / ``_refine_out``,
      ``{b}_feat_conv``, ``pts_cls_out``: the same names;
    * ``{b}_af_dcn_conv.0`` (a Sequential with its ReLU) ->
      ``{b}_af_dcn_conv``;
    * ``pts_{main}_refine_conv.weight`` + ``pts_cls_conv.weight`` -> the
      fused ``pts_{main}_cls_pair.weight_a`` / ``weight_b``, and another
      ``pts_{t}_refine_conv.weight`` (pose_bbox's bbox branch) -> its own,
      all in the (k, k, cin, cout) layout of the deformable layers.

    ``bbox_head.`` and ``module.`` prefixes are taken off;
    ``dcn_base_offset`` and ``num_batches_tracked`` are skipped; any other
    key raises (the DCN-tower keys too: ROADMAP Queue 1 "Not queued")."""
    main = MAIN_BRANCH[task]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    unknown = []
    for key, val in state_dict.items():
        k = _strip_module(key)
        if k.startswith("bbox_head."):
            k = k[len("bbox_head."):]
        if k == "dcn_base_offset" or k.endswith("num_batches_tracked"):
            continue
        t = _tensor(val)
        m = re.fullmatch(_HEAD_BRANCH + r"_convs\.(\d+)\.(conv|gn)\."
                         r"(weight|bias)", k)
        if m:
            b, i, sub, leaf = m.groups()
            out[f"{b}_convs_{i}.{'conv' if sub == 'conv' else 'norm'}."
                f"{leaf}"] = t
            continue
        m = re.fullmatch(r"pts_(bbox|segm|pose)_refine_conv\.weight", k)
        if m:
            name = (f"pts_{main}_cls_pair.weight_a" if m.group(1) == main
                    else f"pts_{m.group(1)}_refine_conv.weight")
            out[name] = _dcn_layout(t)
            continue
        if k == "pts_cls_conv.weight":
            out[f"pts_{main}_cls_pair.weight_b"] = _dcn_layout(t)
            continue
        m = re.fullmatch(_HEAD_BRANCH + r"_af_dcn_conv\.0\.(weight|bias)",
                         k)
        if m:
            out[f"{m.group(1)}_af_dcn_conv.{m.group(2)}"] = t
            continue
        if re.fullmatch(r"(pts_(bbox|segm|pose)_(init_conv|init_out|"
                        r"refine_out)|pts_cls_out|" + _HEAD_BRANCH +
                        r"_(feat_conv|GN))\.(weight|bias)", k):
            out[k] = t
            continue
        unknown.append(k)
    _refuse(unknown, "LSHead")
    return out


def load_pretrained_backbone(model: torch.nn.Module, path: str
                             ) -> List[str]:
    """Load a reference backbone checkpoint (a torchvision or mmdet
    ``state_dict``, or a dict holding one under ``state_dict``) into
    ``model.backbone`` in place; return the loaded keys. Every key the
    file fills must exist in the model with the same shape, else it
    raises; the model's entries the file does not fill keep their values.
    A DCN pack's weight loads only beside its ``conv_offset``: a file
    without it (an ImageNet file for a model with DCN stages) meets the
    pack's compact weight with an OIHW one and raises, as the JAX
    loader does."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    backbone = model.backbone
    frag = convert_torch_backbone(sd)
    own = backbone.state_dict()
    for k, v in frag.items():
        if k not in own:
            raise KeyError(f"missing leaf backbone.{k} in the model")
        if own[k].shape != v.shape:
            raise ValueError(f"shape mismatch at backbone.{k}: "
                             f"{tuple(own[k].shape)} vs {tuple(v.shape)}")
    with torch.no_grad():
        for k, v in frag.items():
            own[k].copy_(v)
    return list(frag)
