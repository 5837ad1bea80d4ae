"""Data parallelism over ``torch.distributed`` (counterpart of
``lsnet_tpu/parallel/mesh.py``).

The JAX package shards each global batch over a ``("data", "model")``
device mesh and lets XLA emit the collectives; its jitted step computes
exactly the one-device step on the global batch. Here each of W ranks
(one process per card, started by ``torchrun``) holds the whole model,
builds the same loader from the same seed, and runs the leading-axis rows
``[r * b, (r + 1) * b)`` of each global batch of ``b * W`` images: the
rank's share of JAX's ``PS("data")`` sharding (``shard_batch_pytree``).

What a rank computes must sum to the global batch's step, so a loss
that divides by a count over the batch sees the global count:

* a single-stage head's outputs are gathered over the ranks
  (:func:`gather_outputs`) and every rank computes the whole batch's loss;
  the backward of the gather keeps the rank's own rows, so each rank's
  gradient is its images' share of the global gradient;
* a two-stage loss reads the batch through the model stage by stage; its
  normalisers are the global ones (:func:`global_count`,
  :func:`batch_mean`) and its per-rank terms add up to the global loss;
* the gradients are summed over the ranks (:func:`reduce_gradients`)
  before the clip, which sees the global norm.

Every helper is the identity in one process, so the one-card path keeps
its numbers. The cost: every rank loads the whole global batch and, for a
single-stage head, takes the whole batch's loss, W times one rank's share
of that work (ROADMAP Queue 1 item 5 has the measured unit). The JAX package has no batch-statistic BatchNorm (every norm
is FrozenBatchNorm or GroupNorm), so no ``SyncBatchNorm`` is needed.
``spatial_sharding``, ``run_spatially_sharded`` and ``maybe_constrain``
are TPU layout (GSPMD) and have no counterpart here.

Bootstrap: :func:`initialize_distributed` takes the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``: ``torchrun``) or an explicit address, NCCL on ``cuda`` and
gloo on the CPU; a bootstrap that was asked for and fails raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda",
                           timeout: float = 1800.0) -> None:
    """Join the process group (replaces the reference ``init_dist``).

    A no-op when the group exists, and when no address was given and the
    process has no launcher environment (a one-process run). Otherwise
    the group is NCCL on ``cuda`` (each process on the card its
    ``LOCAL_RANK`` names) and gloo on the CPU, at ``coordinator`` (an
    ``init_method`` URL such as ``tcp://host:port`` or ``file://path``)
    or the launcher's ``env://``. A bootstrap that was asked for and
    fails raises: a silent one-process run would train other numbers."""
    if dist.is_initialized():
        return
    launched = all(k in os.environ for k in LAUNCHER_ENV)
    if coordinator is None and num_processes is None and not launched:
        return
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device for "
                               "NCCL; pass device='cpu' for gloo")
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=coordinator or "env://",
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)


def init_launcher(launcher: str, device="cuda") -> None:
    """The tools' ``--launcher``: ``none`` runs one process; ``pytorch``
    joins ``torchrun``'s group and raises without its environment."""
    if launcher == "none":
        return
    if launcher != "pytorch":
        raise ValueError(f"--launcher {launcher!r}: want none or pytorch")
    missing = [k for k in LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--launcher pytorch: {', '.join(missing)} not "
                           "set; start the tool with torchrun "
                           "(tools/dist_train.sh)")
    initialize_distributed(device=device)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Reference ``master_only`` equivalent: rank 0, or no group."""
    return rank() == 0


def rank_device(device) -> torch.device:
    """``device`` with the rank's card index where it names none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


# ------------------------------------------------------------ rows -----

def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a global batch tensor: ``[r * b, (r + 1) * b)``
    with ``b = len(x) / W`` (JAX's ``PS("data")`` leading-axis sharding).
    The identity in one process."""
    w = world_size()
    if w == 1:
        return x
    if x.shape[0] % w:
        raise ValueError(f"a global batch of {x.shape[0]} rows does not "
                         f"split over {w} ranks")
    b = x.shape[0] // w
    return x[rank() * b:(rank() + 1) * b]


def shard_batch_pytree(batch: Mapping[str, object]) -> Dict[str, object]:
    """Every tensor and array of a batch dict cut to the rank's rows
    (the counterpart of JAX's ``shard_batch_pytree(batch, mesh)``);
    a 0-d tensor (a scalar that rides the batch) stays whole."""
    def cut(v):
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            return shard_rows(v)
        if isinstance(v, np.ndarray) and v.ndim > 0:
            return shard_rows(torch.from_numpy(v)).numpy()
        return v
    return {k: cut(v) for k, v in batch.items()}


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """(W, *x.shape): every rank's ``x`` (equal shapes) in rank order."""
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts)


class _GatherRows(torch.autograd.Function):
    """all_gather of equal flat buffers; the backward keeps the rank's
    own part of the gradient (every rank differentiates the same
    function of the gathered rows)."""

    @staticmethod
    def forward(ctx, flat):
        return _all_gather(flat)

    @staticmethod
    def backward(ctx, grad):
        return grad[rank()].clone()


class _Replicated(torch.autograd.Function):
    """The identity on a value every rank computes alike (a parameter
    that reaches the loss directly): each rank differentiates the whole
    loss, so its gradient is 1/W of the rank sum."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / world_size()


def gather_outputs(outs: Mapping[str, object]) -> Dict[str, object]:
    """A head's outputs over the global batch: each level map of a list
    gathered along its leading (batch) axis in rank order, in one
    collective; a tensor output (not batched, such as the RepPoints
    ``moment``) kept as :class:`_Replicated`. The identity in one
    process."""
    if world_size() == 1:
        return dict(outs)
    maps = [(k, i, m) for k, v in outs.items() if not isinstance(
        v, torch.Tensor) for i, m in enumerate(v)]
    flat = torch.cat([m.reshape(-1) for _, _, m in maps])
    every = _GatherRows.apply(flat)                       # (W, n)
    res: Dict[str, object] = {k: (_Replicated.apply(v)
                                  if isinstance(v, torch.Tensor)
                                  else [None] * len(v))
                              for k, v in outs.items()}
    at = 0
    for k, i, m in maps:
        n = m.numel()
        res[k][i] = every[:, at:at + n].reshape(-1, *m.shape[1:])
        at += n
    return res


# ----------------------------------------------------------- counts -----

def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The rank sum of ``x`` (detached; ``x`` itself in one process)."""
    if world_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out


def global_count(n: torch.Tensor) -> torch.Tensor:
    """A count over the rank's rows summed over the ranks: the global
    batch's count, which a loss divides by (no gradient flows into a
    count). ``n`` itself in one process."""
    return all_reduce_sum(n)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` (leading axis the batch) over the global batch,
    as the rank's share: its sum over ``x.numel() * W`` (the shards are
    equal). ``x.mean()`` in one process."""
    w = world_size()
    if w == 1:
        return x.mean()
    return x.sum() / (x.numel() * w)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of every rank, concatenated in rank order, without
    gradient (statistics over the global batch). ``x`` in one process."""
    if world_size() == 1:
        return x
    return _all_gather(x.detach()).reshape(-1, *x.shape[1:])


def reduce_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients summed over the ranks, in one collective (each
    rank's gradient is its share of the global batch's)."""
    grads = list(grads)
    if world_size() == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


# ---------------------------------------------------------- results -----

def _pack_results(local_results: list):
    """Pickle a per-rank result list into a (payload, size) pair for the
    all-gather. Split out of :func:`collect_results` so the wire format is
    unit-testable without several processes (JAX's format)."""
    payload = np.frombuffer(pickle.dumps(local_results), np.uint8)
    return payload, np.array([payload.size], np.int64)


def _merge_gathered(gathered, sizes) -> list:
    """Inverse of :func:`_pack_results` over stacked per-rank buffers:
    ``gathered`` (P, max_len) uint8 rows padded to the longest payload,
    ``sizes`` (P, 1) true lengths. Keeps rank order (the reference's
    rank-ordered ``collect_results_cpu``)."""
    out = []
    for i in range(gathered.shape[0]):
        out.extend(pickle.loads(gathered[i, : int(sizes[i, 0])].tobytes()))
    return out


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def collect_results(local_results: list) -> list:
    """Gather per-rank python result lists onto every rank, in rank order
    (replaces the reference rank-0 tmpdir-pickle gather), as pickled
    bytes over the process group. One process: the identity."""
    if world_size() == 1:
        return list(local_results)
    dev = _comm_device()
    payload, n = _pack_results(local_results)
    sizes = gather_rows(torch.from_numpy(n).to(dev)).cpu().numpy()
    sizes = sizes.reshape(-1, 1)
    padded = torch.zeros(int(sizes.max()), dtype=torch.uint8, device=dev)
    padded[: payload.size] = torch.from_numpy(payload.copy()).to(dev)
    gathered = gather_rows(padded[None]).cpu().numpy()
    return _merge_gathered(gathered, sizes)
