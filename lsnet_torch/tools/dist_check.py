"""W data-parallel ranks against one process on the global batch.

Each rank (a process of its own, gloo over a ``file://`` store, so no
network is used) builds the same model from the same state and takes the
same global batches; ``train.step`` runs its rows (``lsnet_torch.parallel``).
After the steps every rank's parameters and metrics are held against the
one-process steps on the same global batches, which is what the JAX
package's jitted mesh step computes. The ranks use gloo also on the card
(NCCL does not take two ranks on one card), and every rank is joined
with a time limit: a hang fails.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch


def run_steps(job: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """The job's steps in this process (one rank of a group, or alone):
    ``{"metrics": [per step {name: float}], "params": {name: tensor}}``.

    job: ``model_cfg`` (``build_detector``'s dict), ``state`` (its state
    dict), ``loss_cfg``, ``optim`` (``build_optimizer``'s keywords),
    ``batches`` (collated numpy batches), optional ``mixed_precision``
    (False), ``dynamic`` ((iou_thr, beta): Dynamic R-CNN's full loss)."""
    from ..data.coco import batch_to_device
    from ..models import build_detector
    from ..train.loop import dynamic_loss
    from ..train.optim import build_optimizer
    from ..train.step import make_train_step

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_detector(dict(job["model_cfg"]))
    model.load_state_dict(job["state"])
    model.to(device).train()
    optimizer, _ = build_optimizer(model.parameters(), **job["optim"])
    dyn = job.get("dynamic")
    step = make_train_step(
        model, optimizer, job["loss_cfg"],
        mixed_precision=job.get("mixed_precision", False),
        full_loss_fn=dynamic_loss(None, job["loss_cfg"]) if dyn else None)
    metrics = []
    for batch in job["batches"]:
        batch = batch_to_device(batch, device)
        if dyn:
            batch["dyn_iou_thr"] = torch.tensor(dyn[0], device=device)
            batch["dyn_beta"] = torch.tensor(dyn[1], device=device)
        metrics.append({k: float(v) for k, v in step(batch).items()})
    return {"metrics": metrics,
            "params": {n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()}}


def _rank_main(rank: int, world: int, store: str, job_path: str,
               out_dir: str, device: str) -> None:
    import torch.distributed as dist

    from .. import parallel
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(0)
    # gloo on either device: NCCL takes one rank a card
    parallel.initialize_distributed("file://" + store, world, rank,
                                    device="cpu")
    try:
        jobs = torch.load(job_path, weights_only=False)
        res = [run_steps(job, device) for job in jobs]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(jobs: Sequence[Mapping[str, Any]], world: int, work_dir: str,
              device="cpu", timeout: float = 120.0
              ) -> List[List[Dict[str, Any]]]:
    """``run_steps`` of each of ``jobs`` in turn in ``world`` spawned gloo
    ranks; each rank is joined within ``timeout`` seconds, or all are
    killed and this raises. Returns the results by job, then by rank."""
    import torch.multiprocessing as mp

    os.makedirs(work_dir, exist_ok=True)
    job_path = os.path.join(work_dir, "job.pt")
    torch.save([dict(job) for job in jobs], job_path)
    store = os.path.join(work_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, job_path, work_dir,
                               str(device)), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                raise TimeoutError(f"a rank did not end within {timeout}s")
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    by_rank = [torch.load(os.path.join(work_dir, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    return [list(res) for res in zip(*by_rank)]


# the ranks' updates against the one-process run's, over its largest
# update: f32 gradients agree to about 1e-3 of a tensor's largest entry
# where GroupNorm cancels most of a sum (the port's gradient tests hold
# that tolerance against JAX)
UPDATE_TOL = 1e-3


def within(errs: Mapping[str, float], tol: float) -> bool:
    """``compare``'s differences within ``tol`` (the updates within
    ``UPDATE_TOL``)."""
    return (max(v for k, v in errs.items() if k != "updates") <= tol
            and errs.get("updates", 0.0) <= UPDATE_TOL)


def _finite_or_inf(x: float) -> float:
    return x if x == x else float("inf")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max(1, max |want|); a NaN reads as inf."""
    got, want = got.double(), want.double()
    if want.numel() == 0:
        return 0.0
    scale = max(1.0, float(want.abs().max()))
    return _finite_or_inf(float((got - want).abs().max()) / scale)


def compare(ranks: List[Dict[str, Any]], alone: Dict[str, Any],
            start: Optional[Mapping[str, torch.Tensor]] = None
            ) -> Dict[str, float]:
    """The largest relative differences of the ranks' parameters and
    metrics from the one-process run's, and between the ranks; with the
    ``start`` state, also of the ranks' updates (parameters less
    ``start``) from the one-process run's, over its largest update."""
    out = {"params": 0.0, "metrics": 0.0, "between_ranks": 0.0}
    if start is not None:
        top = max(float((p - start[n]).abs().max())
                  for n, p in alone["params"].items())
        out["updates"] = _finite_or_inf(max(
            float((res["params"][n].double() - p.double()).abs().max())
            for res in ranks for n, p in alone["params"].items()) / top)
    for res in ranks:
        if res["params"].keys() != alone["params"].keys() or [
                m.keys() for m in res["metrics"]] != [
                m.keys() for m in alone["metrics"]]:
            raise AssertionError("a rank's parameters or metrics differ "
                                 "in their names")
        for n, p in res["params"].items():
            out["params"] = max(out["params"], rel_err(p, alone["params"][n]))
            out["between_ranks"] = max(out["between_ranks"], rel_err(
                p, ranks[0]["params"][n]))
        for got, want in zip(res["metrics"], alone["metrics"]):
            for k, v in want.items():
                # equal infinities (a statistic with no positive) agree
                d = 0.0 if got[k] == v else (abs(got[k] - v)
                                             / max(1.0, abs(v)))
                out["metrics"] = max(out["metrics"], _finite_or_inf(d))
    return out


def file_job(config: str, hw, n: int, world: int, steps: int,
             classes: Optional[int], root: str,
             options: Optional[Mapping[str, Any]] = None,
             seed: int = 0) -> Dict[str, Any]:
    """A job from a config file (``options`` merged into it): its seeded
    init, its train loss config, SGD settings, clip and warm-up, and the
    first ``steps`` global batches of ``samples_per_gpu * world``
    procedural shapes images at ``hw`` (the set of ``seed``), unflipped."""
    from ..data.coco import DataLoader
    from ..data.extra import build_dataset
    from ..models import build_detector
    from ..models.init import init_weights_
    from ..train.loop import (_dataset_cfg, clip_norm_from, dynamic_schedule,
                              head_cfg, train_loss_cfg)
    from ..utils.config import Config
    from .shapes import make_shapes_coco

    cfg = Config.fromfile(config)
    ann, img = make_shapes_coco(os.path.join(root, "data"), n, seed=seed,
                                hw=tuple(hw))
    cfg.merge_from_dict(dict(options or {}))
    cfg.merge_from_dict({"data.train.ann_file": ann,
                         "data.train.img_prefix": img,
                         "data.train.type": "CocoDataset"})
    if classes is not None:
        head_cfg(cfg)["num_classes"] = classes
    ds = build_dataset("CocoDataset", _dataset_cfg(
        cfg, "train", flip_ratio=0.0,
        max_instances=cfg.get("max_instances", 100)))
    spg = cfg.data.get("samples_per_gpu", 2)
    loader = DataLoader(ds, spg * world, tuple(cfg.get("canvas_shape")
                                               or hw), prefetch=0)
    batches = [b for _, b in zip(range(steps), loader.epoch(0))]
    batches = [{k: v for k, v in b.items() if k != "img_id"}
               for b in batches]
    model = build_detector(cfg.model.to_dict())
    init_weights_(model, torch.Generator().manual_seed(cfg.get("seed", 0)))
    dyn = dynamic_schedule(cfg)
    lr_cfg = dict(cfg.get("lr_config", {}) or {})
    return dict(
        model_cfg=cfg.model.to_dict(), state=model.state_dict(),
        loss_cfg=train_loss_cfg(cfg, tuple(batches[0]["image"].shape[1:3])),
        optim=dict(base_lr=cfg.optimizer.get("lr", 0.01),
                   steps_per_epoch=steps, decay_epochs=[],
                   momentum=cfg.optimizer.get("momentum", 0.9),
                   weight_decay=cfg.optimizer.get("weight_decay", 1e-4),
                   clip_norm=clip_norm_from(cfg),
                   warmup_iters=lr_cfg.get("warmup_iters", 500),
                   warmup_ratio=lr_cfg.get("warmup_ratio", 0.001)),
        batches=batches,
        dynamic=None if dyn is None else (dyn.iou_thr, dyn.beta))
