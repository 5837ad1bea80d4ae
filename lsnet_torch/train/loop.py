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
detection). The two-stage files (Faster R-CNN, Double-Head, Dynamic
R-CNN) train on the full loss ``two_stage_loss`` (Dynamic R-CNN on
``dynamic_rcnn_loss``, its threshold and beta fed each step from a
``DynamicRCNNSchedule`` and its statistics popped from the step's
metrics) and decode with ``two_stage_decode``, with the
``two_stage_cfg_from`` settings; the mask files (Mask R-CNN, Mask Scoring
R-CNN, PointRend) train on ``mask_rcnn_loss`` / ``mask_scoring_rcnn_loss``
/ ``point_rend_loss`` over the segm pipeline's 36-point GT contours, and
decode with ``mask_rcnn_decode`` / ``mask_scoring_rcnn_decode`` /
``point_rend_decode``: their evaluation scores the boxes (``bbox_*``) and
the pasted masks (``segm_*``), as the JAX runner's; the cascade files
(Cascade R-CNN, DetectoRS) train on ``cascade_rcnn_loss`` and decode with
``cascade_rcnn_decode``, Grid R-CNN on ``grid_rcnn_loss`` /
``grid_rcnn_decode``, and HTC on ``htc_loss`` over the GT contours, and
``htc_decode`` scores its boxes and masks. Any of the backbones and
necks ``models.BACKBONES`` and ``models.NECKS`` name runs under these
detectors (``lsnet_torch.configs`` has five published compositions:
HRNet + HRFPN, RegNet, PAFPN, FPN_CARAFE and NAS-FPN). The datasets come
from ``data.extra.build_dataset``: all eight of JAX's ``DATASET_TYPES``
(COCO and the pose files' ``CocoPoseDataset``, VOC, WIDER Face,
Cityscapes, DeepFashion, LVIS and LVIS v1). The evaluation reads the val
split as COCO json, as JAX's ``evaluate_detector`` does (a COCO-style
type through its own class, so LVIS' ``coco_url`` names its files; an
XML type's val split is a COCO json); ``data.extra.eval_map`` scores VOC
detections as a function, as in JAX.

Under W ranks (``torchrun``, ``tools.train --launcher pytorch``) every
rank builds the same loader from the same seed with the global batch of
``samples_per_gpu * W`` images (JAX's ``per_dev * n_dev``), and
``train.step`` makes each step the one-process step on that batch
(``lsnet_torch.parallel``); logging and checkpoints run on rank 0 (JAX's
``@master_only`` hooks) and each rank evaluates its share of the val
images, gathered by ``parallel.collect_results``. Left out, as the
TPU's own: the compile cache, the chunk budget and the spatial ("model")
mesh axis.
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
from ..core.two_stage import (TWO_STAGE_DECODES, DynamicRCNNSchedule,
                              TwoStageConfig, dynamic_rcnn_loss,
                              two_stage_decode)
from ..data.coco import (CocoDataset, DataLoader, DatasetConfig,
                         batch_to_device, collate_batch)
from ..data.extra import build_dataset, dataset_class
from ..evalkit.evaluator import (coco_gt_from_annotations, detections_to_coco,
                                 evaluate_coco, mask_detections_to_coco)
from ..models import (BACKBONES, DETECTORS, HEADS, MASK_TYPES, NECKS,
                      TWO_STAGE, build_detector, head_cfg_of, is_two_stage)
from ..models.init import init_weights_
from ..ops.flat_deform import (INFERENCE_SAMPLING, TRAIN_SAMPLING,
                               sampling_from_spec, with_refine_taps)
from .. import parallel
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
# the two-stage detectors the runner trains (JAX's ``_is_two_stage``; a
# Fast R-CNN takes its proposals from outside) and their RoI heads
TWO_STAGE_RUNNER = tuple(t for t in TWO_STAGE if t != "FastRCNN")
ROI_HEADS = ("StandardRoIHead", "DoubleHeadRoIHead", "DynamicRoIHead",
             "CascadeRoIHead")


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


def two_stage_cfg_from(cfg, image_shape) -> TwoStageConfig:
    """The settings of a two-stage file, as the JAX runner reads them:
    the RPN assigner's thresholds and sampler's count, the proposals'
    ``nms_pre`` / ``max_per_img`` (capped at 512) / NMS IoU from
    ``train_cfg.rpn_proposal`` (decode too: ``test_cfg.rpn`` is not read),
    the RoI assigner's ``pos_iou_thr`` and sampler's count and positive
    fraction (a cascade file's first stage's: the stages' thresholds are
    ``core.two_stage.CASCADE_IOUS``), the classes of
    ``roi_head.bbox_head`` (a cascade's first)."""
    tc = cfg.get("train_cfg", {}) or {}
    rpn = tc.get("rpn", {}).get("assigner", {})
    prop = tc.get("rpn_proposal", {})
    rcnn = tc.get("rcnn", {})
    if isinstance(rcnn, (list, tuple)):
        rcnn = rcnn[0] if rcnn else {}
    return TwoStageConfig(
        image_shape=tuple(image_shape),
        num_classes=head_cfg(cfg).num_classes,
        rpn_pos_iou=rpn.get("pos_iou_thr", 0.7),
        rpn_neg_iou=rpn.get("neg_iou_thr", 0.3),
        rpn_num_samples=tc.get("rpn", {}).get("sampler", {}).get("num", 256),
        nms_pre=prop.get("nms_pre", 1000),
        proposal_count=min(prop.get("max_per_img", 512), 512),
        proposal_nms_iou=prop.get("nms", {}).get("iou_threshold", 0.7),
        rcnn_pos_iou=rcnn.get("assigner", {}).get("pos_iou_thr", 0.5),
        rcnn_num_samples=rcnn.get("sampler", {}).get("num", 512),
        rcnn_pos_fraction=rcnn.get("sampler", {}).get("pos_fraction", 0.25))


def is_two_stage_cfg(cfg) -> bool:
    """Whether a file's detector is of the two-stage family the runner
    trains (JAX's ``_is_two_stage``)."""
    return cfg.model.type in TWO_STAGE_RUNNER


def dynamic_schedule(cfg) -> Optional[DynamicRCNNSchedule]:
    """Dynamic R-CNN's schedule from ``train_cfg.rcnn.dynamic_rcnn``
    where the RoI head is a ``DynamicRoIHead``, else None."""
    if (cfg.model.get("roi_head") or {}).get("type") != "DynamicRoIHead":
        return None
    dyn = (cfg.get("train_cfg", {}) or {}).get("rcnn", {}).get(
        "dynamic_rcnn", {})
    return DynamicRCNNSchedule(
        initial_iou=dyn.get("initial_iou", 0.4),
        initial_beta=dyn.get("initial_beta", 1.0),
        update_iter_interval=dyn.get("update_iter_interval", 100))


def dynamic_loss(cfg, loss_cfg: TwoStageConfig):
    """The train step's full loss of a Dynamic R-CNN file: the threshold
    and beta ride the batch (``dyn_iou_thr``, ``dyn_beta``), as in the JAX
    runner; ``iou_topk`` / ``beta_topk`` keep ``dynamic_rcnn_loss``'s
    defaults, which the JAX runner does not read from the file."""
    def loss(model, batch, sampling):
        rest = {k: v for k, v in batch.items() if not k.startswith("dyn_")}
        return dynamic_rcnn_loss(model, rest, loss_cfg, batch["dyn_iou_thr"],
                                 batch["dyn_beta"], sampling=sampling)
    return loss


def train_loss_cfg(cfg, image_shape):
    """The train step's loss config, by head type: ``CPVLossConfig``
    around the base config for the CPV head (its heatmap, offset and
    semantic terms keep their defaults, as in the JAX runner),
    ``reppoints_cfg_from`` / ``dense_reppoints_cfg_from`` for the
    RepPoints family, ``dense_cfg_from`` for the dense zoo,
    ``two_stage_cfg_from`` for the two-stage files, else
    ``loss_cfg_from``."""
    if is_two_stage_cfg(cfg):
        return two_stage_cfg_from(cfg, image_shape)
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


def forward_decode(model: torch.nn.Module, images: torch.Tensor,
                   img_shapes: torch.Tensor, scale_factors: torch.Tensor,
                   tcfg: TestConfig, sampling: Mapping[str, str],
                   config=None):
    """The detector's forward and decode on a batch: ``two_stage_decode``
    (with ``two_stage_cfg_from`` of the ``config`` file at the test
    config's canvas) for a two-stage detector, or its own decode
    (``core.two_stage.TWO_STAGE_DECODES``: the cascade's, Grid R-CNN's, and the mask
    detectors', which give (Detections, masks (B, K, 28, 28), 112 x 112
    for PointRend) as JAX's do); else the forward and :func:`decode_for`'s
    decode."""
    if is_two_stage(model):
        if config is None:
            raise ValueError("a two-stage decode reads the model's config "
                             "file; pass it as config")
        decode = TWO_STAGE_DECODES.get(type(model).__name__,
                                       two_stage_decode)
        return decode(
            model, images, img_shapes, scale_factors,
            two_stage_cfg_from(config, tcfg.image_shape), tcfg,
            sampling=sampling)
    return decode_for(model, config)(model(images, sampling), img_shapes,
                                     scale_factors, tcfg)


def test_cfg_from(cfg, image_shape) -> TestConfig:
    """The decode's test settings; a two-stage file's ``test_cfg.rcnn``."""
    head = head_cfg(cfg)
    tc = cfg.test_cfg
    if "rcnn" in tc:
        tc = tc.rcnn
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
    """Raise ``NotImplementedError`` for a model the port does not run
    (one that no builder of the JAX package names either), naming what
    it runs, and the registry's ``KeyError`` for a dataset type that
    ``data.extra.DATASET_TYPES`` does not name."""
    model = cfg.model
    head = head_cfg(cfg).get("type")
    roi_head = (model.get("roi_head") or {}).get("type", "StandardRoIHead")
    if is_two_stage_cfg(cfg):
        if roi_head not in ROI_HEADS:
            raise NotImplementedError(
                f"{model.type} with {roi_head}: the port runs the RoI heads "
                f"{', '.join(ROI_HEADS)}")
    elif model.type not in DETECTORS or head not in HEADS:
        raise NotImplementedError(
            f"{model.type} with {head}: the port runs the single-stage "
            f"detectors {', '.join(sorted(DETECTORS))} with the heads "
            f"{', '.join(sorted(HEADS))} and the two-stage "
            f"{', '.join(TWO_STAGE_RUNNER)}, which run every shipped file "
            "under configs/")
    backbone = (model.get("backbone") or {}).get("type")
    neck = (model.get("neck") or {}).get("type")
    if backbone not in BACKBONES or neck not in NECKS:
        raise NotImplementedError(
            f"{model.type} on {backbone} and {neck}: the port builds the "
            f"backbones {', '.join(BACKBONES)} and the necks "
            f"{', '.join(str(n) for n in NECKS)}, every type the JAX "
            "package's builders name")
    for split in ("train", "val"):
        dataset_class(cfg.data.get(split, {}).get("type", "CocoDataset"))



def _polygon_trained(cfg) -> bool:
    """Whether the file's loss reads the segm task's 36-point GT
    polygons: Dense RepPoints and the mask detectors (HTC's too)."""
    return (head_cfg(cfg).get("type") in DENSE_REPPOINTS
            or cfg.model.type in MASK_TYPES)


def head_num_vectors(cfg) -> int:
    """The pipeline's ``num_vectors``: the head's, or 36 where the loss
    reads the segm task's GT polygons (Dense RepPoints; the mask targets
    of Mask R-CNN, MS R-CNN, PointRend and HTC, as JAX's
    ``_head_num_vectors``)."""
    return head_cfg(cfg).get("num_vectors",
                             36 if _polygon_trained(cfg) else 4)


def data_task(cfg, split: str) -> str:
    """The pipeline's task: the head's, except that Dense RepPoints and the
    mask detectors train on the segm task's polygons (and evaluate on the
    head's task: bbox, and segm from the masks)."""
    if split == "train" and _polygon_trained(cfg):
        return "segm"
    return DATA_TASK[head_cfg(cfg).get("task", "bbox")]


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


def clip_norm_from(cfg) -> float:
    """The gradient clip's ``max_norm``: 35 (the JAX runner's default)
    where the file sets none, and where it sets ``grad_clip=None`` (the
    schedules of the two-stage and dense files), on which the JAX runner
    raises ``AttributeError``."""
    return (cfg.get("optimizer_config", {}).get("grad_clip") or {}).get(
        "max_norm", 35.0)


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
    device = parallel.rank_device(runner_device(device))
    check_runnable(cfg)
    world = parallel.world_size()
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
    ds = build_dataset(train.get("type", "CocoDataset"), _dataset_cfg(
        cfg, "train",
        multiscale_mode=train.get("multiscale_mode", "range"),
        ratio_range=train.get("ratio_range"),
        augmentations=tuple(train.get("augmentations", ()) or ()),
        keep_ratio=train.get("keep_ratio", True),
        flip_ratio=train.get("flip_ratio", 0.5),
        max_instances=cfg.get("max_instances", 100)))
    # the global batch, the same on every rank (JAX's per_dev * n_dev)
    batch_size = data_cfg.get("samples_per_gpu", 2) * world
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
        clip_norm=clip_norm_from(cfg),
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
    # canvas); Dynamic R-CNN's threshold and beta ride the batch
    step_fns: Dict[Tuple[int, int], Any] = {}
    dyn_sched = dynamic_schedule(cfg)

    def step_for(canvas_hw):
        if canvas_hw not in step_fns:
            loss_cfg = train_loss_cfg(cfg, canvas_hw)
            step_fns[canvas_hw] = make_train_step(
                model, optimizer, loss_cfg, sampling=sampling,
                full_loss_fn=(dynamic_loss(cfg, loss_cfg) if dyn_sched
                              else None))
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
            batch = batch_to_device(batch, device)
            if dyn_sched is not None:
                batch["dyn_iou_thr"] = torch.tensor(dyn_sched.iou_thr,
                                                    device=device)
                batch["dyn_beta"] = torch.tensor(dyn_sched.beta,
                                                 device=device)
            metrics = step_for(canvas_hw)(batch)
            if dyn_sched is not None:
                dyn_sched.update(float(metrics.pop("stat_iou")),
                                 float(metrics.pop("stat_beta")))
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


def val_dataset(cfg) -> CocoDataset:
    """The val split as COCO json, as JAX's ``evaluate_detector`` reads it:
    through the type's own class where that is a ``CocoDataset`` (LVIS
    names its files from ``coco_url``), else (an XML type) through
    ``CocoDataset``."""
    cls = dataset_class(cfg.data.val.get("type", "CocoDataset"))
    if not issubclass(cls, CocoDataset):
        cls = CocoDataset
    return cls(_dataset_cfg(cfg, "val", filter_empty=False), test_mode=True)


def evaluate_detector(cfg, model: torch.nn.Module, canvas, *,
                      batch_size: int = 8, max_images: Optional[int] = None,
                      sampling: Mapping[str, str] = INFERENCE_SAMPLING
                      ) -> Dict[str, float]:
    """COCO metrics of ``model`` on ``cfg.data.val``: the head task's, and
    for a mask detector also the pasted masks' ``segm_*`` (as the JAX
    runner's).

    Images are grouped by orientation, so each batch pads onto one canvas
    (``canvas`` is the landscape one, portrait its transpose). The forward
    runs in the dtype and on the device of the model's parameters. Under
    W ranks each rank decodes every W-th image of a group and the
    detections are gathered (``parallel.collect_results``): every rank
    returns the same metrics."""
    check_runnable(cfg)
    task = head_cfg(cfg).get("task", "bbox")
    ds = val_dataset(cfg)
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
    groups = {cv: idx[parallel.rank()::parallel.world_size()]
              for cv, idx in groups.items()}
    was_training = model.training
    model.eval()
    dts, segm_dts = [], []
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
                    det = forward_decode(
                        model, image,
                        torch.from_numpy(batch["img_shape"]).to(param.device),
                        torch.from_numpy(batch["scale_factor"]).to(
                            param.device), tcfg, sampling, cfg)
                if isinstance(det, tuple) and not isinstance(det,
                                                             Detections):
                    det, masks = det
                    segm_dts += mask_detections_to_coco(
                        det, masks, batch["img_id"], label_to_cat, img_sizes)
                dts += detections_to_coco(det, batch["img_id"], label_to_cat,
                                          task=task, img_sizes=img_sizes)
    finally:
        model.train(was_training)
    dts = parallel.collect_results(dts)
    segm_dts = parallel.collect_results(segm_dts)
    eval_ids = {int(info["id"]) for info in ds.img_infos[:n]}
    gts = [g for g in coco_gt_from_annotations(ds.coco, task=task)
           if g["image_id"] in eval_ids]
    dts = [d for d in dts if d["image_id"] in eval_ids]
    metrics = evaluate_coco(gts, dts, img_sizes, iou_type=IOU_TYPE[task])
    if cfg.model.type in MASK_TYPES:
        segm_gts = [g for g in coco_gt_from_annotations(ds.coco, task="segm")
                    if g["image_id"] in eval_ids]
        segm_dts = [d for d in segm_dts if d["image_id"] in eval_ids]
        # mmdet's names (segm_mAP, ...); JAX's runner prefixes them once
        # more (segm_segm_mAP, ROADMAP Queue 3)
        metrics.update(evaluate_coco(segm_gts, segm_dts, img_sizes,
                                     iou_type="segm"))
    return metrics

