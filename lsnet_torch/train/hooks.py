"""Runner hooks (counterpart of ``lsnet_tpu/train/hooks.py``): the same
protocol, priorities (lower runs first) and config-driven
``custom_hooks``.

The context carries the model and its ``ClippedSGD`` in place of the JAX
``TrainState``. ``CheckpointHook`` writes one ``step_{N}.pt`` per save,
which holds its own meta, so ``max_keep`` prunes whole checkpoints and
leaves no stale meta behind. Under W ranks the logging and checkpoint
hooks act on rank 0 (the reference's ``@master_only``); the other ranks
wait at the checkpoint. The Tensorboard, W&B and MLflow hooks import
their package when the run starts; where it is absent (or its start
fails) they write the same scalars to a jsonl file in the work dir.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

from ..parallel import barrier, is_main_process, rank
from ..utils.registry import Registry
from .checkpoint import checkpoint_steps, save_checkpoint

HOOKS = Registry("hook")


class RunnerContext:
    """Mutable state handed to hooks (the reference ``runner``)."""

    def __init__(self, cfg, work_dir: str, steps_per_epoch: int,
                 total_epochs: int):
        self.cfg = cfg
        self.work_dir = work_dir
        self.steps_per_epoch = steps_per_epoch
        self.total_epochs = total_epochs
        self.epoch = 0                      # 0-based current epoch
        self.iter = 0                       # iteration within the epoch
        self.global_step = 0
        self.model = None                   # the detector (f32 masters)
        self.optimizer = None               # its ClippedSGD
        self.meta: Dict[str, Any] = {}      # train meta of each save
        self.lr = 0.0
        self.metrics: Dict[str, float] = {}
        self.eval_fn = None                 # () -> Dict[str, float]
        self.should_stop = False


class Hook:
    priority: int = 50                      # lower runs first

    def before_train(self, ctx: RunnerContext):  # noqa: D102
        pass

    def before_epoch(self, ctx: RunnerContext):
        pass

    def after_iter(self, ctx: RunnerContext):
        pass

    def after_epoch(self, ctx: RunnerContext):
        pass

    def after_train(self, ctx: RunnerContext):
        pass


@HOOKS.register_module()
class LoggerHook(Hook):
    """Console + json logging (reference TextLoggerHook)."""
    priority = 90

    def __init__(self, logger):
        self.logger = logger

    def after_iter(self, ctx):
        if not is_main_process():       # reference hooks are @master_only
            return
        self.logger.log_iter(ctx.epoch + 1, ctx.iter, ctx.steps_per_epoch,
                             ctx.lr, ctx.metrics)


@HOOKS.register_module()
class CheckpointHook(Hook):
    """A save every ``interval`` epochs; with ``max_keep``, the newest
    ``max_keep`` checkpoint files stay and older ones are deleted."""
    priority = 70

    def __init__(self, interval: int = 1, out_dir: Optional[str] = None,
                 max_keep: Optional[int] = None):
        self.interval = interval
        self.out_dir = out_dir
        self.max_keep = max_keep

    def after_epoch(self, ctx):
        if ctx.model is None or (ctx.epoch + 1) % self.interval:
            return
        if not is_main_process():       # every rank holds the same model
            barrier()
            return
        out = self.out_dir or os.path.join(ctx.work_dir, "ckpts")
        path = save_checkpoint(out, ctx.model, ctx.optimizer,
                               ctx.global_step, ctx.meta)
        print(f"epoch {ctx.epoch + 1}: checkpoint -> {path}", flush=True)
        if self.max_keep:
            for s in checkpoint_steps(out)[:-self.max_keep]:
                os.remove(os.path.join(out, f"step_{s}.pt"))
        barrier()


@HOOKS.register_module()
class EvalHook(Hook):
    """Periodic COCO eval (reference EvalHook)."""
    priority = 80

    def __init__(self, interval: int = 1, logger=None):
        self.interval = interval
        self.logger = logger

    def after_epoch(self, ctx):
        if ctx.eval_fn is None or (ctx.epoch + 1) % self.interval:
            return
        metrics = ctx.eval_fn()             # on every rank, its share
        if self.logger is not None and is_main_process():
            self.logger.log_eval(ctx.epoch + 1, metrics)


def kernel_wrappers():
    """The main paths' kernel wrappers by name; each counts its launches
    in ``launches``."""
    from ..ops import deform_gather as dg
    from ..ops import grouped as gr
    return {"deform_gather_contract": dg.deform_gather_contract,
            "deform_gather_contract_bwd_data":
                dg.deform_gather_contract_bwd_data,
            "deform_gather_contract_bwd_weight":
                dg.deform_gather_contract_bwd_weight,
            "deform_gather_grouped_contract":
                gr.deform_gather_grouped_contract,
            "deform_gather_grouped_contract_bwd_data":
                gr.deform_gather_grouped_contract_bwd_data,
            "deform_gather_grouped_contract_bwd_weight":
                gr.deform_gather_grouped_contract_bwd_weight}


@HOOKS.register_module()
class KernelLaunchHook(Hook):
    """The kernels' launch counts (``kernel_wrappers``): set to 0 before
    the run, read after every step and after each epoch (it runs after
    ``EvalHook``, so an epoch's read holds its evaluation), each read
    setting them to 0. Every rank appends its reads to
    ``work_dir/launches_rank{r}.jsonl``: ``{"mode": "train" or "epoch",
    "step": ..., kernel: count, ...}``."""
    priority = 95

    def _read(self, ctx, mode):
        counts = {}
        for name, fn in kernel_wrappers().items():
            counts[name], fn.launches = fn.launches, 0
        with open(os.path.join(ctx.work_dir,
                               f"launches_rank{rank()}.jsonl"), "a") as f:
            f.write(json.dumps({"mode": mode, "step": ctx.global_step,
                                **counts}) + "\n")

    def before_train(self, ctx):
        for fn in kernel_wrappers().values():
            fn.launches = 0

    def after_iter(self, ctx):
        self._read(ctx, "train")

    def after_epoch(self, ctx):
        self._read(ctx, "epoch")


class _ScalarHook(Hook):
    """Scalars every ``interval`` steps to a backend, or to
    ``work_dir/<fallback>`` as jsonl when the backend cannot start."""
    fallback_name = "scalars.jsonl"

    def __init__(self, interval: int = 50):
        self.interval = interval
        self._fallback = None

    def _start(self, ctx) -> None:
        """Start the backend; raise ImportError (or anything) if absent."""
        raise NotImplementedError

    def _log(self, scalars: Dict[str, float], step: int) -> None:
        raise NotImplementedError

    def _finish(self, ctx) -> None:
        pass

    def _scalars(self, ctx) -> Dict[str, float]:
        return dict(ctx.metrics, lr=ctx.lr)

    def _fallback_path(self, ctx) -> str:
        return os.path.join(ctx.work_dir, self.fallback_name)

    def before_train(self, ctx):
        if not is_main_process():     # reference hooks are @master_only
            return
        try:
            self._start(ctx)
        except Exception as ex:         # absent package or failed start
            if not isinstance(ex, ImportError):
                logging.getLogger(__name__).warning(
                    "%s could not start (%s: %s); falling back to jsonl",
                    type(self).__name__, type(ex).__name__, ex)
            path = self._fallback_path(ctx)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._fallback = open(path, "a")

    def after_iter(self, ctx):
        if ctx.global_step % self.interval:
            return
        scalars = self._scalars(ctx)
        if self._fallback is not None:
            self._fallback.write(json.dumps(
                {"step": ctx.global_step, **scalars}) + "\n")
            self._fallback.flush()
        elif is_main_process():
            self._log(scalars, ctx.global_step)

    def after_train(self, ctx):
        if self._fallback is not None:
            self._fallback.close()
        elif is_main_process():
            self._finish(ctx)


@HOOKS.register_module()
class TensorboardHook(_ScalarHook):
    """Scalar event files in the TensorBoard layout (reference
    TensorboardLoggerHook), through ``torch.utils.tensorboard``."""
    priority = 91

    def __init__(self, log_dir: Optional[str] = None, interval: int = 50):
        super().__init__(interval)
        self.log_dir = log_dir
        self._writer = None

    def _fallback_path(self, ctx):
        return os.path.join(self._dir(ctx), self.fallback_name)

    def _dir(self, ctx) -> str:
        return self.log_dir or os.path.join(ctx.work_dir, "tf_logs")

    def _start(self, ctx):
        from torch.utils.tensorboard import SummaryWriter
        self._writer = SummaryWriter(self._dir(ctx))

    def _log(self, scalars, step):
        for k, v in scalars.items():
            self._writer.add_scalar(f"train/{k}", v, step)

    def _finish(self, ctx):
        self._writer.close()


@HOOKS.register_module()
class WandbHook(_ScalarHook):
    """Weights & Biases scalar logging (reference WandbLoggerHook)."""
    priority = 92
    fallback_name = "wandb_scalars.jsonl"

    def __init__(self, init_kwargs: Optional[Dict[str, Any]] = None,
                 interval: int = 50, log_artifact: bool = False):
        super().__init__(interval)
        self.init_kwargs = init_kwargs or {}
        self.log_artifact = log_artifact
        self._run = None

    def _start(self, ctx):
        import wandb  # type: ignore
        self._run = wandb.init(**self.init_kwargs)

    def _scalars(self, ctx):
        return dict(ctx.metrics, lr=ctx.lr, epoch=ctx.epoch + 1)

    def _log(self, scalars, step):
        self._run.log(scalars, step=step)

    def _finish(self, ctx):
        if self.log_artifact:
            import wandb  # type: ignore
            art = wandb.Artifact("checkpoints", type="model")
            ckpt_dir = os.path.join(ctx.work_dir, "ckpts")
            if os.path.isdir(ckpt_dir):
                art.add_dir(ckpt_dir)
            self._run.log_artifact(art)
        self._run.finish()


@HOOKS.register_module()
class MlflowHook(_ScalarHook):
    """MLflow metric logging (reference MlflowLoggerHook)."""
    priority = 93
    fallback_name = "mlflow_scalars.jsonl"

    def __init__(self, exp_name: Optional[str] = None,
                 tags: Optional[Dict[str, Any]] = None, interval: int = 50):
        super().__init__(interval)
        self.exp_name = exp_name
        self.tags = tags
        self._mlflow = None

    def _start(self, ctx):
        import mlflow  # type: ignore
        if self.exp_name:
            mlflow.set_experiment(self.exp_name)
        mlflow.start_run()
        if self.tags:
            mlflow.set_tags(self.tags)
        self._mlflow = mlflow

    def _log(self, scalars, step):
        self._mlflow.log_metrics({k: float(v) for k, v in scalars.items()},
                                 step=step)

    def _finish(self, ctx):
        self._mlflow.end_run()


def build_hooks(cfg, logger, eval_interval: int) -> List[Hook]:
    """Default hook set + config-driven ``custom_hooks`` (reference
    ``register_training_hooks`` + custom_hooks)."""
    hooks: List[Hook] = [
        LoggerHook(logger),
        CheckpointHook(interval=cfg.get("checkpoint_config",
                                        {}).get("interval", 1)),
        EvalHook(interval=eval_interval, logger=logger),
    ]
    for hc in cfg.get("custom_hooks", []) or []:
        hc = dict(hc)
        kind = hc.pop("type")
        cls = HOOKS.get(kind)
        if cls is None:
            raise KeyError(f"unknown hook type {kind!r}")
        hooks.append(cls(**hc))
    return sorted(hooks, key=lambda h: h.priority)


def call_hooks(hooks: List[Hook], stage: str, ctx: RunnerContext) -> None:
    for h in hooks:
        getattr(h, stage)(ctx)
