"""Model configurations of the port.

``flagship_r50_cfg`` is LSNet-R50 with DCN head towers, the JAX package's
flagship (``__graft_entry__._flagship_cfg``) with ``fuse_towers=False``:
the fused-tower gather is a TPU layout option the port leaves out. The
R50 backbone has no DCN stage.

``x101_flagship_cfg`` is LSNet X-101-64x4d-DCN, the model ``bench.py``
builds (``__graft_entry__._x101_flagship_cfg``), again with
``fuse_towers=False``: a ResNeXt-101 backbone with G=64 groups of base
width 4 and grouped DCNv2 on conv2 of stages c3-c5.
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
