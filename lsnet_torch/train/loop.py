"""The runner: train and evaluate an LSNet detector from a config
(counterpart of ``lsnet_tpu/train/loop.py`` ``loss_cfg_from``,
``test_cfg_from``, ``train_detector`` and ``evaluate_detector``, for the
``LSDetector`` / ``LSHead`` family).

``train_detector`` runs the epoch loop of the reference runner: a COCO
dataset and an orientation-grouped loader, the training init from
``cfg.seed`` (then ``cfg.model.pretrained``, where that file exists,
through ``load_pretrained_backbone``), the config's LR policy, SGD with
clipping, one train step per canvas (bf16 compute over f32 masters), and
the hooks: logging, a checkpoint per epoch, COCO eval.
``evaluate_detector`` runs the val set through the f32 masters, decodes,
and scores with the package's own COCO evaluation.

Sampling is an explicit mapping everywhere. Training runs
``cfg.train_cfg.dcn_sampling`` (bilinear by default) and records it in each
checkpoint's meta. An evaluation runs, in this order of precedence, the
run's own train sampling where the config chose one (``EvalHook``), the
checkpoint's deployed sampling (``tools.test``), or ``INFERENCE_SAMPLING``:
the order of the JAX package's ``inference_sampling()``.

Left out, as the TPU's own or not LSHead: the compile cache, the chunk
budget, the device mesh (one card; ``num_hosts`` 1 until ROADMAP Queue 1
item 11), and the two-stage, dense, RepPoints and CPV branches.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..core.decode import TestConfig, lsnet_decode
from ..core.loss import LossConfig
from ..data.coco import (CocoDataset, DataLoader, DatasetConfig,
                         batch_to_device, collate_batch)
from ..evalkit.evaluator import (coco_gt_from_annotations, detections_to_coco,
                                 evaluate_coco)
from ..models import build_detector
from ..models.init import init_weights_
from ..ops.flat_deform import (INFERENCE_SAMPLING, TRAIN_SAMPLING,
                               sampling_from_spec)
from ..utils.logging import JsonLogger, collect_env
from .checkpoint import (deploy_sampling, load_pretrained_backbone,
                         restore_checkpoint, train_meta)
from .hooks import RunnerContext, build_hooks, call_hooks
from .optim import build_lr_schedule, build_optimizer
from .step import make_train_step

DATA_TASK = {"bbox": "bbox", "segm": "segm", "pose_bbox": "pose",
             "pose_kbox": "pose"}
IOU_TYPE = {"bbox": "bbox", "segm": "segm", "pose_bbox": "keypoints",
            "pose_kbox": "keypoints"}


def _loss_weight(head, names, default: float) -> float:
    """The ``loss_weight`` of the first of the head's loss configs
    ``names`` that is set. A shipped config turns a loss off with None
    (``loss_bbox_init=None`` in the segm and pose_kbox files), where the
    JAX ``loss_cfg_from`` raises ``AttributeError``."""
    for name in names:
        if head.get(name) is not None:
            return head[name].get("loss_weight", default)
    return default


def loss_cfg_from(cfg, image_shape) -> LossConfig:
    head = cfg.model.bbox_head
    tc = cfg.train_cfg
    return LossConfig(
        image_shape=tuple(image_shape),
        num_classes=head.num_classes,
        task=head.get("task", "bbox"),
        num_vectors=head.get("num_vectors", 4),
        point_strides=tuple(head.get("point_strides", (8, 16, 32, 64, 128))),
        point_base_scale=head.get("point_base_scale", 4),
        init_scale=tc.init.assigner.get("scale", 4),
        init_pos_num=tc.init.assigner.get("pos_num", 1),
        init_iou_type=tc.init.assigner.get("iou_type", "center"),
        refine_topk=tc.refine.assigner.get("topk", 9),
        cls_loss_weight=_loss_weight(head, ["loss_cls"], 1.0),
        init_loss_weight=_loss_weight(
            head, ["loss_bbox_init", "loss_segm_init"], 1.0),
        refine_loss_weight=_loss_weight(
            head, ["loss_bbox_refine", "loss_segm_refine"], 2.0),
        pose_init_loss_weight=_loss_weight(head, ["loss_pose_init"], 1.0),
        pose_refine_loss_weight=_loss_weight(head, ["loss_pose_refine"],
                                             2.0),
    )


def test_cfg_from(cfg, image_shape) -> TestConfig:
    head = cfg.model.bbox_head
    tc = cfg.test_cfg
    return TestConfig(
        image_shape=tuple(image_shape),
        num_classes=head.get("num_classes", 1),
        task=head.get("task", "bbox"),
        num_vectors=head.get("num_vectors", 4),
        point_strides=tuple(head.get("point_strides", (8, 16, 32, 64, 128))),
        nms_pre=tc.get("nms_pre", 1000),
        score_thr=tc.get("score_thr", 0.05),
        nms_iou=tc.get("nms", {}).get("iou_thr", 0.6),
        max_per_img=tc.get("max_per_img", 100),
        nms_type=tc.get("nms", {}).get("type", "nms"),
        soft_sigma=tc.get("nms", {}).get("sigma", 0.5),
        soft_min_score=tc.get("nms", {}).get("min_score", 1e-3),
    )


def check_runnable(cfg) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item of a model or
    dataset the port cannot run yet."""
    model = cfg.model
    if model.type == "LSCPVDetector":
        raise NotImplementedError("LSCPVDetector (CPV): ROADMAP Queue 1 "
                                  "item 10")
    if model.type != "LSDetector" or \
            model.get("bbox_head", {}).get("type") != "LSHead":
        raise NotImplementedError(f"{model.type}: the port runs LSDetector "
                                  "with LSHead; the zoo is ROADMAP Queue 1 "
                                  "item 12")
    if model.backbone.type == "Res2Net":
        raise NotImplementedError("Res2Net backbone: ROADMAP Queue 1 item 9")
    for split in ("train", "val"):
        kind = cfg.data.get(split, {}).get("type", "CocoDataset")
        if kind != "CocoDataset":
            raise NotImplementedError(f"dataset {kind}: data/extra.py is "
                                      "ROADMAP Queue 1 item 12")


def eval_sampling(explicit: Optional[Mapping[str, str]] = None,
                  meta: Optional[Mapping[str, Any]] = None
                  ) -> Mapping[str, str]:
    """The sampling an evaluation runs: an explicit choice, else the
    checkpoint's deployed sampling (``deploy_sampling(meta)``), else
    ``INFERENCE_SAMPLING``."""
    if explicit is not None:
        return explicit
    if meta:
        return deploy_sampling(meta)
    return INFERENCE_SAMPLING


def runner_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card must exist when asked
    for (the entry points never carry on on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def _dataset_cfg(cfg, split: str, **kw) -> DatasetConfig:
    head = cfg.model.bbox_head
    d = cfg.data[split]
    raw = d.get("img_scale", (1333, 800))
    scale = (tuple(tuple(s) for s in raw)
             if isinstance(raw[0], (list, tuple)) else tuple(raw))
    return DatasetConfig(
        ann_file=d.ann_file, img_prefix=d.img_prefix,
        task=DATA_TASK[head.get("task", "bbox")],
        num_vectors=head.get("num_vectors", 4), img_scale=scale, **kw)


def train_detector(cfg, work_dir: str, *, total_epochs: Optional[int] = None,
                   max_iters_per_epoch: Optional[int] = None,
                   resume_from: Optional[str] = None,
                   eval_interval: int = 1,
                   device="cuda") -> Dict[str, Any]:
    """A training run from a ``Config``. Returns the model, its optimizer,
    the step reached and the work dir."""
    check_runnable(cfg)
    device = runner_device(device)
    os.makedirs(work_dir, exist_ok=True)
    logger = JsonLogger(work_dir, interval=cfg.get("log_interval", 50))
    print("environment:", dict(collect_env()), flush=True)

    spec = cfg.get("train_cfg", {}).get("dcn_sampling")
    sampling = sampling_from_spec(str(spec)) if spec else TRAIN_SAMPLING
    meta = train_meta(str(spec) if spec else None)

    data_cfg = cfg.data
    train = data_cfg.train
    ds = CocoDataset(_dataset_cfg(
        cfg, "train",
        multiscale_mode=train.get("multiscale_mode", "range"),
        ratio_range=train.get("ratio_range"),
        augmentations=tuple(train.get("augmentations", ()) or ()),
        keep_ratio=train.get("keep_ratio", True),
        flip_ratio=train.get("flip_ratio", 0.5),
        max_instances=cfg.get("max_instances", 100)))
    batch_size = data_cfg.get("samples_per_gpu", 2)     # one card
    explicit_canvas = cfg.get("canvas_shape")
    loader = DataLoader(ds, batch_size,
                        tuple(explicit_canvas) if explicit_canvas else None)
    canvas = loader.canvas_hw
    steps_per_epoch = max_iters_per_epoch or loader.steps_per_epoch()

    model = build_detector(cfg.model.to_dict())
    init_weights_(model, torch.Generator().manual_seed(cfg.get("seed", 0)))
    pretrained = cfg.model.get("pretrained")
    if pretrained and os.path.exists(str(pretrained)):
        load_pretrained_backbone(model, str(pretrained))
    model.to(device).train()

    epochs = total_epochs or cfg.get("total_epochs", 12)
    lr_cfg = dict(cfg.get("lr_config", {}) or {})
    base_lr = cfg.optimizer.get("lr", 0.01)
    schedule = build_lr_schedule(lr_cfg, base_lr, steps_per_epoch, epochs)
    optimizer, _ = build_optimizer(
        model.parameters(), base_lr, steps_per_epoch,
        lr_cfg.get("step", [8, 11]),
        momentum=cfg.optimizer.get("momentum", 0.9),
        weight_decay=cfg.optimizer.get("weight_decay", 1e-4),
        clip_norm=(cfg.get("optimizer_config", {}).get("grad_clip") or {}
                   ).get("max_norm", 35.0),
        schedule=schedule)

    start_epoch = 0
    if resume_from:
        info = restore_checkpoint(resume_from, model, optimizer)
        saved = info["meta"].get("dcn_sampling_train")
        if sampling_from_spec(saved) != sampling:
            raise ValueError(
                f"resuming {resume_from}, trained with DCN sampling "
                f"{saved!r}, with train sampling {dict(sampling)}: set "
                f"train_cfg.dcn_sampling={saved!r} to resume it")
        start_epoch = info["step"] // steps_per_epoch
        print(f"resumed from {resume_from} at epoch {start_epoch}",
              flush=True)

    # one train step per canvas orientation (its loss config holds the
    # canvas)
    step_fns: Dict[Tuple[int, int], Any] = {}

    def step_for(canvas_hw):
        if canvas_hw not in step_fns:
            step_fns[canvas_hw] = make_train_step(
                model, optimizer, loss_cfg_from(cfg, canvas_hw),
                sampling=sampling)
        return step_fns[canvas_hw]

    hooks = build_hooks(cfg, logger, eval_interval)
    ctx = RunnerContext(cfg, work_dir, steps_per_epoch, epochs)
    ctx.model, ctx.optimizer, ctx.meta = model, optimizer, meta
    ctx.global_step = optimizer.count
    if "val" in cfg.data:
        explicit = sampling if spec else None
        ctx.eval_fn = lambda: evaluate_detector(
            cfg, model, canvas, max_images=cfg.get("eval_max_images"),
            sampling=eval_sampling(explicit))

    call_hooks(hooks, "before_train", ctx)
    for epoch in range(start_epoch, epochs):
        ctx.epoch = epoch
        call_hooks(hooks, "before_epoch", ctx)
        for it, batch in enumerate(loader.epoch(epoch)):
            if max_iters_per_epoch and it >= max_iters_per_epoch:
                break
            canvas_hw = tuple(batch["image"].shape[1:3])
            metrics = step_for(canvas_hw)(batch_to_device(batch, device))
            ctx.iter = it
            ctx.global_step = optimizer.count
            ctx.lr = float(schedule(optimizer.count))
            ctx.metrics = {k: float(v) for k, v in sorted(metrics.items())}
            call_hooks(hooks, "after_iter", ctx)
            if ctx.should_stop:
                break
        call_hooks(hooks, "after_epoch", ctx)
        if ctx.should_stop:
            break
    call_hooks(hooks, "after_train", ctx)
    return {"model": model, "optimizer": optimizer,
            "step": optimizer.count, "work_dir": work_dir}


def evaluate_detector(cfg, model: torch.nn.Module, canvas, *,
                      batch_size: int = 8, max_images: Optional[int] = None,
                      sampling: Mapping[str, str] = INFERENCE_SAMPLING
                      ) -> Dict[str, float]:
    """COCO metrics of ``model`` on ``cfg.data.val``.

    Images are grouped by orientation, so each batch pads onto one canvas
    (``canvas`` is the landscape one, portrait its transpose). The forward
    runs in the dtype and on the device of the model's parameters."""
    check_runnable(cfg)
    head = cfg.model.bbox_head
    task = head.get("task", "bbox")
    ds = CocoDataset(_dataset_cfg(cfg, "val", filter_empty=False),
                     test_mode=True)
    param = next(model.parameters())
    n = len(ds) if max_images is None else min(max_images, len(ds))
    img_sizes = {info["id"]: (info["height"], info["width"])
                 for info in ds.coco.img_infos}
    label_to_cat = {v: k for k, v in ds.coco.cat_to_label.items()}
    land, port = tuple(canvas), (canvas[1], canvas[0])
    groups = {land: [], port: []}
    for i in range(n):
        info = ds.img_infos[i]
        groups[port if info["height"] > info["width"] else land].append(i)
    was_training = model.training
    model.eval()
    dts = []
    try:
        for cv, idx_list in groups.items():
            tcfg = test_cfg_from(cfg, cv)
            for s0 in range(0, len(idx_list), batch_size):
                samples = [ds.get_sample(i)
                           for i in idx_list[s0:s0 + batch_size]]
                batch = collate_batch(samples, cv, task=DATA_TASK[task],
                                      num_vectors=head.get("num_vectors", 4))
                image = torch.from_numpy(batch["image"]).to(
                    param.device, param.dtype)
                with torch.inference_mode():
                    outs = model(image, sampling)
                    det = lsnet_decode(
                        outs,
                        torch.from_numpy(batch["img_shape"]).to(param.device),
                        torch.from_numpy(batch["scale_factor"]).to(
                            param.device), tcfg)
                dts += detections_to_coco(det, batch["img_id"], label_to_cat,
                                          task=task, img_sizes=img_sizes)
    finally:
        model.train(was_training)
    eval_ids = {int(info["id"]) for info in ds.img_infos[:n]}
    gts = [g for g in coco_gt_from_annotations(ds.coco, task=task)
           if g["image_id"] in eval_ids]
    dts = [d for d in dts if d["image_id"] in eval_ids]
    return evaluate_coco(gts, dts, img_sizes, iou_type=IOU_TYPE[task])

