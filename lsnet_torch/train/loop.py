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

The head family sets the loss and the decode, as in the JAX runner:
LSHead trains on ``lsnet_loss`` and decodes with ``lsnet_decode``;
LSCPVHead (``LSCPVDetector``) on ``lscpv_loss``, whose config reads only
the base (LSHead) loss settings from the file, as JAX's does, and decodes
with ``lscpv_decode``; RepPointsHead / RepPointsV2Head on
``reppoints_loss`` / ``reppoints_v2_loss`` and their decodes; the Dense
RepPoints heads on ``dense_reppoints_loss`` / ``dense_reppoints_v2_loss``
(their pipeline carries the 36-point GT polygons, as the segm task's),
evaluated by bbox: ``dense_reppoints_decode``'s boxes with zero
landmarks; the dense zoo's heads (``DENSE_HEAD_KINDS``: RetinaNet and
RetinaSepBN, FCOS, ATSS, GFL, SSD, FoveaBox, FSAF, FreeAnchor, PISA
RetinaNet and SSD, GA-RetinaNet and the standalone GA-RPN, whose head is
the ``RPN``'s ``rpn_head``) on ``dense_loss`` and ``dense_decode`` with
the ``dense_cfg_from`` settings (a GA-RPN proposal is a label-0
detection).

Left out, as the TPU's own or not yet ported: the compile cache, the
chunk budget, the device mesh (one card; ``num_hosts`` 1 until ROADMAP
Queue 1 "Multi-GPU") and the two-stage branch.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ..core.cpv import CPVLossConfig, lscpv_decode
from ..core.decode import Detections, TestConfig, lsnet_decode
from ..core.dense_decode import dense_decode
from ..core.dense_loss import DenseLossConfig
from ..core.dense_reppoints import (DenseRepPointsConfig,
                                    DenseRepPointsV2Config,
                                    dense_reppoints_decode)
from ..core.loss import LossConfig
from ..core.reppoints import (RepPointsConfig, RepPointsV2Config,
                              reppoints_decode, reppoints_v2_decode)
from ..data.coco import (CocoDataset, DataLoader, DatasetConfig,
                         batch_to_device, collate_batch)
from ..evalkit.evaluator import (coco_gt_from_annotations, detections_to_coco,
                                 evaluate_coco)
from ..models import DETECTORS, HEADS, build_detector, head_cfg_of
from ..models.init import init_weights_
from ..ops.flat_deform import (INFERENCE_SAMPLING, TRAIN_SAMPLING,
                               sampling_from_spec, with_refine_taps)
from ..utils.logging import JsonLogger, collect_env
from .checkpoint import (deploy_sampling, deploy_taps,
                         load_pretrained_backbone, refine_taps_env,
                         restore_checkpoint, train_meta)
from .hooks import RunnerContext, build_hooks, call_hooks
from .optim import build_lr_schedule, build_optimizer
from .step import make_train_step

DATA_TASK = {"bbox": "bbox", "segm": "segm", "pose_bbox": "pose",
             "pose_kbox": "pose"}
DENSE_REPPOINTS = ("DenseRepPointsHead", "DenseRepPointsV2Head")
REPPOINTS = ("RepPointsHead", "RepPointsV2Head")
IOU_TYPE = {"bbox": "bbox", "segm": "segm", "pose_bbox": "keypoints",
            "pose_kbox": "keypoints"}
# the dense zoo's heads, by their loss and decode kind
DENSE_HEAD_KINDS = {"RetinaHead": "retina", "RetinaSepBNHead": "retina",
                    "FCOSHead": "fcos", "ATSSHead": "atss",
                    "GFLHead": "gfl", "SSDHead": "ssd",
                    "FoveaHead": "fovea", "FSAFHead": "fsaf",
                    "FreeAnchorRetinaHead": "free_anchor",
                    "PISARetinaHead": "pisa_retina",
                    "PISASSDHead": "pisa_ssd",
                    "GARetinaHead": "ga_retina", "GARPNHead": "ga_rpn"}


def head_cfg(cfg):
    """The head's config of a file (the JAX runner's ``_head_cfg`` for
    single-stage files)."""
    return head_cfg_of(cfg.model)


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


def _assigners(cfg):
    tc = cfg.get("train_cfg", {}) or {}
    return (tc.get("init", {}).get("assigner", {}),
            tc.get("refine", {}).get("assigner", {}))


def reppoints_cfg_from(cfg, image_shape) -> RepPointsConfig:
    """The RepPoints loss / decode config of a RepPoints file
    (``RepPointsV2Config`` for RepPointsV2Head, whose CPV terms keep their
    defaults, as in the JAX runner)."""
    head = cfg.model.bbox_head
    init_a, ref_a = _assigners(cfg)
    kind = (RepPointsV2Config if head.get("type") == "RepPointsV2Head"
            else RepPointsConfig)
    return kind(
        image_shape=tuple(image_shape),
        num_classes=head.num_classes,
        num_points=head.get("num_points", 9),
        point_strides=tuple(head.get("point_strides",
                                     (8, 16, 32, 64, 128))),
        point_base_scale=head.get("point_base_scale", 4),
        transform_method=head.get("transform_method", "moment"),
        init_scale=init_a.get("scale", 4),
        init_pos_num=init_a.get("pos_num", 1),
        refine_pos_iou=ref_a.get("pos_iou_thr", 0.5),
        refine_neg_iou=ref_a.get("neg_iou_thr", 0.4),
        refine_min_pos_iou=ref_a.get("min_pos_iou", 0.0),
        cls_weight=head.get("loss_cls", {}).get("loss_weight", 1.0),
        init_weight=head.get("loss_bbox_init", {}).get("loss_weight", 0.5),
        refine_weight=head.get("loss_bbox_refine", {}
                               ).get("loss_weight", 1.0))


def dense_reppoints_cfg_from(cfg, image_shape) -> DenseRepPointsConfig:
    """The Dense RepPoints loss / decode config of a Dense RepPoints file
    (``DenseRepPointsV2Config`` for the v2 head); the loss weights keep
    their defaults, as in the JAX runner."""
    head = cfg.model.bbox_head
    init_a, ref_a = _assigners(cfg)
    kind = (DenseRepPointsV2Config
            if head.get("type") == "DenseRepPointsV2Head"
            else DenseRepPointsConfig)
    return kind(
        image_shape=tuple(image_shape),
        num_classes=head.num_classes,
        num_points=head.get("num_points", 729),
        num_group=head.get("num_group", 9),
        num_score_group=head.get("num_score_group", 121),
        point_strides=tuple(head.get("point_strides",
                                     (8, 16, 32, 64, 128))),
        point_base_scale=head.get("point_base_scale", 4),
        init_scale=init_a.get("scale", 4),
        init_pos_num=init_a.get("pos_num", 1),
        refine_pos_iou=ref_a.get("pos_iou_thr", 0.5),
        refine_neg_iou=ref_a.get("neg_iou_thr", 0.4),
        refine_min_pos_iou=ref_a.get("min_pos_iou", 0.0))


def _kind_settings(kind: str, head, tc, assigner) -> Dict[str, Any]:
    """The SSD, FoveaBox and FSAF fields of JAX's ``dense_cfg_from``:
    SSD's levels and anchors from its anchor generator, its mining and
    SmoothL1 from the train config, its stds from the coder; FoveaBox's
    base edges, scale ranges, sigma and loss settings from the head;
    FSAF's centre-region scale and TBLR normaliser."""
    if kind in ("ssd", "pisa_ssd"):
        ag = head.get("anchor_generator") or {}
        return dict(
            strides=tuple(ag.get("strides", (8, 16, 32, 64, 100, 300))),
            ssd_input_size=ag.get("input_size", 300),
            ssd_ratios=tuple(tuple(r) for r in ag.get(
                "ratios", ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)))),
            ssd_basesize_ratio_range=tuple(ag.get(
                "basesize_ratio_range", (0.15, 0.9))),
            ssd_neg_pos_ratio=tc.get("neg_pos_ratio", 3),
            ssd_smoothl1_beta=tc.get("smoothl1_beta", 1.0),
            ssd_stds=tuple((head.get("bbox_coder") or {}).get(
                "target_stds", (0.1, 0.1, 0.2, 0.2))))
    if kind == "fovea":
        loss_cls = head.get("loss_cls") or {}
        return dict(
            fovea_base_edges=tuple(head.get("base_edge_list",
                                            (16, 32, 64, 128, 256))),
            fovea_scale_ranges=tuple(tuple(r) for r in head.get(
                "scale_ranges",
                ((8, 32), (16, 64), (32, 128), (64, 256), (128, 512)))),
            fovea_sigma=head.get("sigma", 0.4),
            fovea_alpha=loss_cls.get("alpha", 0.4),
            fovea_gamma=loss_cls.get("gamma", 1.5),
            fovea_bbox_weight=(head.get("loss_bbox") or {}).get(
                "loss_weight", 0.75))
    if kind == "fsaf":
        return dict(
            fsaf_pos_scale=assigner.get("pos_scale", 0.2),
            fsaf_normalizer=(head.get("bbox_coder") or {}).get(
                "normalizer", 4.0))
    return {}


def dense_cfg_from(cfg, image_shape) -> DenseLossConfig:
    """The loss / decode config of a dense-zoo file: JAX's
    ``dense_cfg_from``, with two repairs. An ``assigner=None`` (the FCOS
    file's, which NAS-FCOS inherits) reads as no settings; the JAX
    function raises on it. The Guided Anchoring heads' levels are the
    ``square_anchor_generator``'s strides; JAX reads the head's
    ``strides``, absent in both GA files, so its default (8, ..., 128)
    against the GA-RPN file's FPN levels at 4, ..., 64. FreeAnchor's bag
    and PISA's ISR-P / CARL settings are the loss's constants, the
    shipped files' values (JAX's loss defaults, which its runner leaves
    unread)."""
    head = head_cfg(cfg)
    kind = DENSE_HEAD_KINDS[head.type]
    tc = cfg.get("train_cfg", {}) or {}
    assigner = tc.get("assigner") or {}
    extra = _kind_settings(kind, head, tc, assigner)
    strides = extra.pop("strides", head.get("strides"))
    if strides is None and kind in ("ga_retina", "ga_rpn"):
        strides = (head.get("square_anchor_generator") or {}).get("strides")
    return DenseLossConfig(
        image_shape=tuple(image_shape),
        num_classes=head.get("num_classes", 1),
        head=kind,
        strides=tuple(strides or (8, 16, 32, 64, 128)),
        pos_iou_thr=assigner.get("pos_iou_thr", 0.5),
        neg_iou_thr=assigner.get("neg_iou_thr", 0.4),
        min_pos_iou=assigner.get("min_pos_iou", 0.0),
        topk=assigner.get("topk", 9),
        regress_ranges=tuple(tuple(r) for r in head.get(
            "regress_ranges",
            ((-1, 64), (64, 128), (128, 256), (256, 512), (512, 1e8)))),
        **extra)


def train_loss_cfg(cfg, image_shape):
    """The train step's loss config, by head type: ``CPVLossConfig``
    around the base config for the CPV head (its heatmap, offset and
    semantic terms keep their defaults, as in the JAX runner),
    ``reppoints_cfg_from`` / ``dense_reppoints_cfg_from`` for the
    RepPoints family, ``dense_cfg_from`` for the dense zoo, else
    ``loss_cfg_from``."""
    kind = head_cfg(cfg).get("type")
    if kind in DENSE_HEAD_KINDS:
        return dense_cfg_from(cfg, image_shape)
    if kind in REPPOINTS:
        return reppoints_cfg_from(cfg, image_shape)
    if kind in DENSE_REPPOINTS:
        return dense_reppoints_cfg_from(cfg, image_shape)
    base = loss_cfg_from(cfg, image_shape)
    if kind == "LSCPVHead":
        return CPVLossConfig(base=base)
    return base


def decode_for(model: torch.nn.Module, config=None) -> Callable[..., Any]:
    """The detector's decode, by its head: ``lscpv_decode`` for the CPV
    head, ``reppoints_decode`` / ``reppoints_v2_decode`` for the RepPoints
    heads, ``dense_reppoints_decode`` as bbox Detections (zero landmarks)
    for the Dense RepPoints heads, ``dense_decode`` for the dense zoo,
    else ``lsnet_decode``; ``fn(outs, img_shapes, scale_factors,
    test_cfg)``. The RepPoints family's and the dense zoo's decodes take
    their settings from the model's ``config`` file
    (``reppoints_cfg_from`` / ``dense_reppoints_cfg_from`` /
    ``dense_cfg_from`` at the test config's canvas, as in the JAX runner)
    and require it."""
    kind = type(model.head).__name__
    if kind == "LSCPVHead":
        return lscpv_decode
    if kind not in REPPOINTS + DENSE_REPPOINTS + tuple(DENSE_HEAD_KINDS):
        return lsnet_decode
    if config is None:
        raise ValueError(f"{kind}: its decode reads the model's config "
                         "file; pass it as config")
    if kind in DENSE_HEAD_KINDS:
        def decode(outs, img_shapes, scale_factors, tcfg):
            return dense_decode(outs, img_shapes, scale_factors, tcfg,
                                dense_cfg_from(config, tcfg.image_shape))
        return decode
    if kind in REPPOINTS:
        fn = reppoints_decode if kind == "RepPointsHead" \
            else reppoints_v2_decode

        def decode(outs, img_shapes, scale_factors, tcfg):
            rcfg = reppoints_cfg_from(config, tcfg.image_shape)
            return fn(outs, img_shapes, scale_factors, tcfg, rcfg)
        return decode

    def decode(outs, img_shapes, scale_factors, tcfg):
        dcfg = dense_reppoints_cfg_from(config, tcfg.image_shape)
        d = dense_reppoints_decode(outs, img_shapes, scale_factors, tcfg,
                                   dcfg)
        lms = torch.zeros(*d.bboxes.shape[:2], 8, dtype=d.bboxes.dtype,
                          device=d.bboxes.device)
        return Detections(d.bboxes, d.scores, d.labels, lms, d.valid)
    return decode


def test_cfg_from(cfg, image_shape) -> TestConfig:
    head = head_cfg(cfg)
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
    """Raise ``NotImplementedError`` naming the ROADMAP entry of a model
    or dataset the port cannot run yet."""
    model = cfg.model
    head = head_cfg(cfg).get("type")
    if model.type not in DETECTORS or head not in HEADS:
        raise NotImplementedError(
            f"{model.type} with {head}: the port runs the single-stage "
            f"detectors {', '.join(sorted(DETECTORS))} with the heads "
            f"{', '.join(sorted(HEADS))}; the two-stage family and the "
            "rest of the zoo are ROADMAP Queue 1 \"Inherited zoo\"")
    for split in ("train", "val"):
        kind = cfg.data.get(split, {}).get("type", "CocoDataset")
        if kind != "CocoDataset":
            raise NotImplementedError(f"dataset {kind}: data/extra.py is "
                                      "ROADMAP Queue 1 \"Inherited zoo\"")


def head_num_vectors(cfg) -> int:
    """The pipeline's ``num_vectors``: the head's, or 36 for Dense
    RepPoints, whose loss reads the segm task's 36-point GT polygons."""
    head = head_cfg(cfg)
    return head.get("num_vectors",
                    36 if head.get("type") in DENSE_REPPOINTS else 4)


def data_task(cfg, split: str) -> str:
    """The pipeline's task: the head's, except that Dense RepPoints trains
    on the segm task's polygons (and evaluates by bbox)."""
    head = head_cfg(cfg)
    if split == "train" and head.get("type") in DENSE_REPPOINTS:
        return "segm"
    return DATA_TASK[head.get("task", "bbox")]


def eval_sampling(explicit: Optional[Mapping[str, str]] = None,
                  meta: Optional[Mapping[str, Any]] = None,
                  taps: Optional[str] = None) -> Mapping[str, str]:
    """The sampling an evaluation runs: an explicit site->mode choice,
    else the checkpoint's deployed sampling (``deploy_sampling(meta)``,
    ``INFERENCE_SAMPLING`` without one); at the refine taps of
    ``deploy_taps(meta, taps)``: an explicit ``taps`` spec
    (``LSNET_REFINE_TAPS``), else the ones the checkpoint trained on."""
    modes = explicit if explicit is not None else deploy_sampling(meta)
    return with_refine_taps(modes, deploy_taps(meta, taps))


def runner_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the card must exist when asked
    for (the entry points never carry on on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def _dataset_cfg(cfg, split: str, **kw) -> DatasetConfig:
    d = cfg.data[split]
    raw = d.get("img_scale", (1333, 800))
    scale = (tuple(tuple(s) for s in raw)
             if isinstance(raw[0], (list, tuple)) else tuple(raw))
    if split == "val" and d.get("corruption") is not None:
        # the robustness benchmark: (name, severity) on each loaded image
        kw["corruption"] = (d.corruption[0], int(d.corruption[1]))
    return DatasetConfig(
        ann_file=d.ann_file, img_prefix=d.img_prefix,
        task=data_task(cfg, split), num_vectors=head_num_vectors(cfg),
        img_scale=scale, **kw)


def train_detector(cfg, work_dir: str, *, total_epochs: Optional[int] = None,
                   max_iters_per_epoch: Optional[int] = None,
                   resume_from: Optional[str] = None,
                   eval_interval: int = 1,
                   device="cuda") -> Dict[str, Any]:
    """A training run from a ``Config``. Returns the model, its optimizer,
    the step reached and the work dir."""
    device = runner_device(device)
    check_runnable(cfg)
    os.makedirs(work_dir, exist_ok=True)
    logger = JsonLogger(work_dir, interval=cfg.get("log_interval", 50))
    print("environment:", dict(collect_env()), flush=True)

    spec = cfg.get("train_cfg", {}).get("dcn_sampling")
    taps = refine_taps_env()
    modes = sampling_from_spec(str(spec)) if spec else TRAIN_SAMPLING
    sampling = with_refine_taps(modes, taps)
    meta = train_meta(str(spec) if spec else None, taps)

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
        if sampling_from_spec(saved) != modes:
            raise ValueError(
                f"resuming {resume_from}, trained with DCN sampling "
                f"{saved!r}, with train sampling {dict(modes)}: set "
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
                model, optimizer, train_loss_cfg(cfg, canvas_hw),
                sampling=sampling)
        return step_fns[canvas_hw]

    hooks = build_hooks(cfg, logger, eval_interval)
    ctx = RunnerContext(cfg, work_dir, steps_per_epoch, epochs)
    ctx.model, ctx.optimizer, ctx.meta = model, optimizer, meta
    ctx.global_step = optimizer.count
    if "val" in cfg.data:
        ctx.eval_fn = lambda: evaluate_detector(
            cfg, model, canvas, max_images=cfg.get("eval_max_images"),
            sampling=eval_sampling(modes if spec else None, taps=taps))

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
    task = head_cfg(cfg).get("task", "bbox")
    ds = CocoDataset(_dataset_cfg(cfg, "val", filter_empty=False),
                     test_mode=True)
    param = next(model.parameters())
    n = len(ds) if max_images is None else min(max_images, len(ds))
    img_sizes = {info["id"]: (info["height"], info["width"])
                 for info in ds.coco.img_infos}
    label_to_cat = {v: k for k, v in ds.coco.cat_to_label.items()}
    decode = decode_for(model, cfg)
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
                batch = collate_batch(samples, cv,
                                      task=data_task(cfg, "val"),
                                      num_vectors=head_num_vectors(cfg))
                image = torch.from_numpy(batch["image"]).to(
                    param.device, param.dtype)
                with torch.inference_mode():
                    outs = model(image, sampling)
                    det = decode(
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

