"""Model configurations of the port.

``flagship_r50_cfg`` is LSNet-R50 with DCN head towers, the JAX package's
flagship (``__graft_entry__._flagship_cfg``) with ``fuse_towers=False``:
the fused-tower gather is a TPU layout option the port leaves out. The
R50 backbone has no DCN stage.

``x101_flagship_cfg`` is LSNet X-101-64x4d-DCN, the model ``bench.py``
builds (``__graft_entry__._x101_flagship_cfg``), again with
``fuse_towers=False``: a ResNeXt-101 backbone with G=64 groups of base
width 4 and grouped DCNv2 on conv2 of stages c3-c5.

``x101_segm_cfg``, ``x101_pose_bbox_cfg`` and ``x101_pose_kbox_cfg`` are
the same backbone, neck and head widths for the other three tasks, written
out from ``configs/lsnet/lsnet_segm_x101_fpn_dconv_c3-c5_mstrain_30e_coco.py``
(36-point contours, 80 classes),
``lsnet_pose_bbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py`` (17 keypoints,
one class, boxes from the annotation) and
``lsnet_pose_kbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py`` (boxes from the
visible keypoints). ``TEST_SETTINGS`` and ``LOSS_WEIGHTS`` hold each
task's ``test_cfg`` and loss weights from the same files, as keyword
arguments of ``core.decode.TestConfig`` and ``core.loss.LossConfig``.

``x101_cpv_cfg`` is LSNet-CPV on the same backbone and neck, the head of
``configs/lsnet/lsnet_bbox_cpv_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py``.

``COMPOSITIONS`` are five published mmdet configs on the backbones and
necks past ResNet and FPN, each a function that returns a ``Config``: the
shipped ``configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py`` or
``configs/retinanet/retinanet_r50_fpn_1x_coco.py`` with the overrides of
the mmdet file its docstring names. What those files set in the data
pipeline (crops, scale jitter, mean and std, pad divisors) is not read:
the pipeline is the JAX package's. Serve one with
``apis.init_detector(configs.COMPOSITIONS[name]())``.

The two-stage anchors lie on grids of ceil(canvas / stride) cells, in
both packages. HRFPN's pooled levels and FPN_CARAFE's extra level are
VALID pools, floor(level / 2^i), as in JAX (mmdet's FPN_CARAFE pools
with a 1x1 kernel: the ceiling); they meet the grids only where the
canvas is a multiple of 64 (JAX's own runner raises on the 800 x 1344
canvas). So the HRNet and CARAFE compositions test, train and pad at
(1333, 832): an 832 x 1344 canvas, the short side 832 for mmdet's 800
(ROADMAP Queue 3).
"""

from __future__ import annotations

import os

from .utils.config import Config

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
FASTER_RCNN = os.path.join(CONFIGS, "faster_rcnn",
                           "faster_rcnn_r50_fpn_1x_coco.py")
RETINANET = os.path.join(CONFIGS, "retinanet", "retinanet_r50_fpn_1x_coco.py")
# HRNetV2p-W32's stages (mmdet configs/hrnet/)
HRNETV2P_W32 = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(4, 4), num_channels=(32, 64)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                num_blocks=(4, 4, 4, 4), num_channels=(32, 64, 128, 256)))
# RegNetX-3.2GF, mmdet's ``arch='regnetx_3.2gf'`` (``RegNet.arch_settings``;
# JAX's RegNet takes the dict): widths 96, 192, 432, 1008, depths 2, 6,
# 15, 2, groups 2, 4, 9, 21
REGNETX_3_2GF = dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25,
                     bot_mul=1.0)


def flagship_r50_cfg(feat: int = 256, stacked: int = 3,
                     conv_module_type: str = "dcn") -> dict:
    return dict(
        type="LSDetector",
        backbone=dict(type="ResNet", depth=50, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1),
        neck=dict(type="FPN", out_channels=feat, start_level=1,
                  add_extra_convs="on_input", num_outs=5,
                  norm_cfg=dict(type="GN", num_groups=32)),
        bbox_head=dict(type="LSHead", task="bbox", num_vectors=4,
                       num_classes=80, in_channels=feat, feat_channels=feat,
                       point_feat_channels=feat, stacked_convs=stacked,
                       num_kernel_points=9, gradient_mul=0.1,
                       point_strides=[8, 16, 32, 64, 128],
                       point_base_scale=4,
                       norm_cfg=dict(type="GN", num_groups=32),
                       conv_module_type=conv_module_type,
                       fuse_towers=False),
    )


def x101_flagship_cfg(feat: int = 256, stacked: int = 3) -> dict:
    cfg = flagship_r50_cfg(feat=feat, stacked=stacked, conv_module_type="dcn")
    cfg["backbone"] = dict(type="ResNeXt", depth=101, groups=64, base_width=4,
                           num_stages=4, out_indices=(0, 1, 2, 3),
                           frozen_stages=1,
                           stage_with_dcn=(False, True, True, True))
    return cfg


def _x101_task_cfg(task: str, num_vectors: int, num_classes: int,
                   feat: int, stacked: int) -> dict:
    cfg = x101_flagship_cfg(feat=feat, stacked=stacked)
    cfg["bbox_head"].update(task=task, num_vectors=num_vectors,
                            num_classes=num_classes)
    return cfg


def x101_segm_cfg(feat: int = 256, stacked: int = 3) -> dict:
    return _x101_task_cfg("segm", 36, 80, feat, stacked)


def x101_pose_bbox_cfg(feat: int = 256, stacked: int = 3) -> dict:
    return _x101_task_cfg("pose_bbox", 17, 1, feat, stacked)


def x101_pose_kbox_cfg(feat: int = 256, stacked: int = 3) -> dict:
    return _x101_task_cfg("pose_kbox", 17, 1, feat, stacked)


def x101_cpv_cfg(feat: int = 256, stacked: int = 3) -> dict:
    """LSNet-CPV X-101-64x4d-DCN: the head of
    ``configs/lsnet/lsnet_bbox_cpv_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py``
    (DCN towers, one shared DCN block, corner pools of 64 channels) on the
    X-101 flagship's backbone and neck."""
    cfg = x101_flagship_cfg(feat=feat, stacked=stacked)
    cfg["type"] = "LSCPVDetector"
    cfg["bbox_head"] = dict(
        type="LSCPVHead", num_classes=80, in_channels=feat,
        feat_channels=feat, point_feat_channels=feat, stacked_convs=stacked,
        shared_stacked_convs=1, first_kernel_size=3, kernel_size=1,
        corner_dim=64, num_points=9, gradient_mul=0.1,
        point_strides=[8, 16, 32, 64, 128], point_base_scale=4,
        norm_cfg=dict(type="GN", num_groups=32), conv_module_type="dcn")
    return cfg


_DET_TEST = dict(nms_pre=1000, score_thr=0.05, nms_iou=0.6, max_per_img=100)
_POSE_TEST = dict(nms_pre=100, score_thr=0.05, nms_iou=0.6, max_per_img=20)
TEST_SETTINGS = {
    "bbox": dict(task="bbox", num_vectors=4, num_classes=80, **_DET_TEST),
    "segm": dict(task="segm", num_vectors=36, num_classes=80, **_DET_TEST),
    "pose_bbox": dict(task="pose_bbox", num_vectors=17, num_classes=1,
                      **_POSE_TEST),
    "pose_kbox": dict(task="pose_kbox", num_vectors=17, num_classes=1,
                      **_POSE_TEST),
}
LOSS_WEIGHTS = {
    "bbox": dict(init_loss_weight=1.0, refine_loss_weight=2.0),
    "segm": dict(init_loss_weight=1.0, refine_loss_weight=2.0),
    "pose_bbox": dict(init_loss_weight=0.1, refine_loss_weight=0.2,
                      pose_init_loss_weight=1.0,
                      pose_refine_loss_weight=2.0),
    "pose_kbox": dict(pose_init_loss_weight=1.0,
                      pose_refine_loss_weight=2.0),
}


# the scale and canvas of the compositions whose pyramids pool by floor
SCALE_64 = (1333, 832)
CANVAS_64 = (832, 1344)


def _composed(base: str, **overrides) -> Config:
    cfg = Config.fromfile(base)
    cfg.merge_from_dict(overrides)
    return cfg


def _on_canvas_64(cfg: Config) -> Config:
    cfg.merge_from_dict({"canvas_shape": CANVAS_64, **{
        f"data.{split}.img_scale": SCALE_64
        for split in ("train", "val", "test")}})
    return cfg


def faster_rcnn_hrnetv2p_w32() -> Config:
    """Faster R-CNN on HRNetV2p-W32 and HRFPN (mmdet
    ``configs/hrnet/faster_rcnn_hrnetv2p_w32_1x_coco.py``), at (1333,
    832)."""
    return _on_canvas_64(_composed(FASTER_RCNN, model=dict(
        pretrained="open-mmlab://msra/hrnetv2_w32",
        backbone=dict(_delete_=True, type="HRNet", extra=HRNETV2P_W32),
        neck=dict(_delete_=True, type="HRFPN",
                  in_channels=[32, 64, 128, 256], out_channels=256))))


def retinanet_regnetx_3_2gf() -> Config:
    """RetinaNet on RegNetX-3.2GF (mmdet
    ``configs/regnet/retinanet_regnetx-3.2GF_fpn_1x_coco.py``: its
    backbone, the FPN's widths, SGD at lr 0.02 and weight decay 5e-5,
    the gradient clipped at norm 35)."""
    return _composed(
        RETINANET, model=dict(
            pretrained="open-mmlab://regnetx_3.2gf",
            backbone=dict(_delete_=True, type="RegNet", arch=REGNETX_3_2GF,
                          out_indices=(0, 1, 2, 3), frozen_stages=1,
                          norm_cfg=dict(type="BN", requires_grad=True),
                          norm_eval=True, style="pytorch"),
            neck=dict(type="FPN", in_channels=[96, 192, 432, 1008],
                      out_channels=256, num_outs=5)),
        optimizer=dict(type="SGD", lr=0.02, momentum=0.9,
                       weight_decay=0.00005),
        optimizer_config=dict(_delete_=True, grad_clip=dict(max_norm=35,
                                                            norm_type=2)))


def faster_rcnn_r50_pafpn() -> Config:
    """Faster R-CNN on R-50 and PAFPN (mmdet
    ``configs/pafpn/faster_rcnn_r50_pafpn_1x_coco.py``)."""
    return _composed(FASTER_RCNN, model=dict(neck=dict(
        type="PAFPN", in_channels=[256, 512, 1024, 2048], out_channels=256,
        num_outs=5)))


def faster_rcnn_r50_fpn_carafe() -> Config:
    """Faster R-CNN on R-50 and FPN_CARAFE (mmdet
    ``configs/carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py``), at (1333,
    832). That file's ``end_level=-1`` and ``act_cfg=None`` are left out:
    JAX's ``FPNCarafe`` takes neither key (its builder would raise) and
    does what they say; its ``upsample_cfg`` is dropped by both builders,
    and its values are the module's defaults."""
    return _on_canvas_64(_composed(FASTER_RCNN, model=dict(neck=dict(
        type="FPN_CARAFE", in_channels=[256, 512, 1024, 2048],
        out_channels=256, num_outs=5, start_level=0, norm_cfg=None,
        order=("conv", "norm", "act"),
        upsample_cfg=dict(type="carafe", up_kernel=5, up_group=1,
                          encoder_kernel=3, encoder_dilation=1,
                          compressed_channels=64)))))


def retinanet_r50_nasfpn() -> Config:
    """RetinaNet on R-50 and NAS-FPN at its 640x640 crop (mmdet
    ``configs/nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py``):
    NAS-FPN of 7 stages from level 1 with BN, ``RetinaSepBNHead`` with BN
    on 5 levels, the assigner's negatives under IoU 0.5, 640x640 images
    (the canvas and every split's scale), 8 a batch, SGD at lr 0.08 for 50
    epochs (warm-up 1000 iterations from 0.1, steps at 30 and 40). Its BN
    is FrozenBatchNorm here, as in JAX (mmdet trains it: ``norm_eval``
    False); its ``paramwise_cfg`` is not read."""
    norm = dict(type="BN", requires_grad=True)
    scale = (640, 640)
    return _composed(
        RETINANET, model=dict(
            pretrained="torchvision://resnet50",
            backbone=dict(norm_cfg=norm, norm_eval=False),
            neck=dict(type="NASFPN", stack_times=7, norm_cfg=norm),
            bbox_head=dict(type="RetinaSepBNHead", num_ins=5,
                           norm_cfg=norm)),
        train_cfg=dict(assigner=dict(neg_iou_thr=0.5)),
        data=dict(samples_per_gpu=8, train=dict(img_scale=scale),
                  val=dict(img_scale=scale), test=dict(img_scale=scale)),
        canvas_shape=scale,
        optimizer=dict(type="SGD", lr=0.08, momentum=0.9,
                       weight_decay=0.0001,
                       paramwise_cfg=dict(norm_decay_mult=0,
                                          bypass_duplicate=True)),
        optimizer_config=dict(grad_clip=None),
        lr_config=dict(policy="step", warmup="linear", warmup_iters=1000,
                       warmup_ratio=0.1, step=[30, 40]),
        total_epochs=50)


# the five compositions by their mmdet names
COMPOSITIONS = {"faster_rcnn_hrnetv2p_w32": faster_rcnn_hrnetv2p_w32,
                "retinanet_regnetx_3.2gf": retinanet_regnetx_3_2gf,
                "faster_rcnn_r50_pafpn": faster_rcnn_r50_pafpn,
                "faster_rcnn_r50_fpn_carafe": faster_rcnn_r50_fpn_carafe,
                "retinanet_r50_nasfpn": retinanet_r50_nasfpn}
