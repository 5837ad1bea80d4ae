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
"""

from __future__ import annotations


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
