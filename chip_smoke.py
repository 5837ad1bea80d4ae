"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. build every CUDA kernel of the port from ``lsnet_torch/csrc`` (one
   ``nvcc`` per source, started together), timed;
2. hold each kernel against its plain PyTorch version at the shapes the
   main paths give it (f32 with TF32 off, and bf16; nearest and bilinear),
   and time both: (a) ``deform_gather_contract`` at the head's tower and
   refine calls, (b) ``deform_gather_grouped_contract`` at the three
   grouped DCN stages of X-101-64x4d (stride 1 and the stride-2 first
   block), with the bf16 kernel's device time per inference forward
   (nearest) and per train step (bilinear) and ptxas's registers and
   spills for it, (c) and (d) the bwd-data and bwd-weight kernels of each
   at the same shapes; beside each, as a yardstick, one PyTorch einsum on the
   already gathered patch tensor (for bwd-data: G alone); for the bf16
   grouped bwd-weight kernel its device time per call and per train step
   and ptxas's registers and spills; with the
   bwd-data kernels' split readings (both outputs,
   one output at a time, a table without and with full contention, the
   memset and cast around the launch), (e) the four probe kernels at the
   probes' own inputs and tolerances, kernel, plain version and library
   call also by device time, each launch under a host-side time limit,
   ``probe_block_gather`` also at 147,456 random rows of a 64 MB table
   with its byte bound beside ``torch.index_select``, warm and with the L2
   cold before each call (lines kept by evict_last policies reset, 256 MB
   written), ``probe_subrow_sum`` also at P = 65,536
   beside ``torch.sum`` and ``probe_subrow_dot`` at P = 16,384 beside
   ``torch.mm`` (each 1e-5 of max(1, max|ref|), two launches equal bit for
   bit) with their bounds, then the checks of ``lsnet_torch.tools.probe``
   in-process with the probes' launch counts read around them;
3. check the port on the card against the port on the CPU on small inputs
   (a narrow R50-shaped model, and a narrow ResNeXt-shaped model for each
   of the four tasks, f32): (a) the head outputs, (b) the training loss
   and every parameter's gradient (ResNeXt-shaped, each task);
4. drive the main paths, each with the kernels' launch counts set to 0
   just before and read just after: (a) ``detect`` (forward +
   decode + NMS, the shipped inference sampling) on a batch of two
   800x1344 images, seeded random bf16 weights, for the full-width
   LSNet-R50 flagship and the full-width LSNet X-101-64x4d-DCN in the
   bbox, segm and pose_bbox tasks; (b) train steps of the full-width
   X-101-64x4d-DCN, bbox and pose_bbox, on the same batch size and canvas
   (bf16 over f32 master weights, bilinear at every site, 20 seeded
   instances per image: boxes, 36-point contours, 17 keypoints with
   visibility), asserting the launch counts per step, a finite loss, that
   trainable parameters moved and frozen ones did not;
5. profile one forward + decode of each, and one train step of each, for
   the device time by kernel;
6. the runner: (a) the phase-3 ResNeXt-shaped bbox model through
   ``train_detector`` (2 iterations, f32) and ``evaluate_detector`` on 4
   procedural 128x160 images, on the card and on the CPU (losses to 1e-3
   relative, metrics to 0.01 absolute); (b) the shipped
   ``lsnet_bbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py`` at full width
   (``with_cp``, ``frozen_stages=1``, multi-scale train range, 3 classes)
   through ``lsnet_torch.tools.train`` on 8 procedural images (6 landscape
   768x1280, 2 portrait) for 2 epochs of 4 steps with an ``EvalHook`` each
   epoch on 4 more (run A), ``lsnet_torch.tools.test`` on A's
   ``step_8.pt``, and a run B resumed from A's ``step_4.pt``: asserting
   the logged losses, ``grad_norm`` and learning rates, the six kernels'
   launches on every step (the same each step) and K1 and the grouped
   forward in each eval, the checkpoint bit for bit with its meta and
   deploy sampling, the test's metrics within 1e-4 of the EvalHook's, and
   B's steps 5 to 8; it prints the train seconds per iteration, eval
   images per second, checkpoint bytes and save / restore seconds, the
   metrics and peak memory beside the card's name and power limit. Run
   A starts from ``model.pretrained``: the same file's backbone, drawn
   from another seed and written in the reference's (mmdet) key names by
   chip_smoke's own writer, which must be the backbone A starts from,
   tensor for tensor (the grouped G = 64 DCN weights included);
7. a short ``lsnet_torch.tools.accuracy_run``: --task bbox --dcn (R50,
   DCN in c3-c5 and in the head towers) for 2 epochs of 10 steps (80
   procedural 128x160 images, batch 8), then --eval-only at
   ``backbone=nearest`` on its last checkpoint: both logged losses finite
   and the last below the first, COCO metric keys, and K1's launches
   (forward, bwd-data, bwd-weight) 19 on every train step (13 backbone
   DCN blocks, 4 tower blocks, 2 refine contractions; read after each
   step by a hook) and 19 forward an eval batch, no other kernel; the
   eval-only metrics equal the run's own last evaluation (the same
   sampling) within 0.01. The arguments of every K1 call of the first
   train step (bf16: R50's c3-c5 DCN at 128-512 channels, the stride-2
   first blocks, the 64-channel towers and refine) and of the first eval
   batch (f32) are kept, and each call's kernel is held against its plain
   version on them at phase 2's tolerance;
8. the image-level API (``lsnet_torch.apis``): (a) a narrow
   Res2Net-50-DCN segm model (``base_channels=16, base_width=13``: 3x3
   widths 26 / 52 / 104 in c3-c5) through ``init_detector`` (config and
   checkpoint) and ``inference_detector`` on a 480x640 image, f32, on the
   card and on the CPU: the same detections and labels, boxes and
   landmarks within 1e-3 of the image size; (b) the shipped
   Res2Net-101-DCN segm file at full width from a checkpoint written by
   ``save_checkpoint``: ``inference_detector`` on a numpy image and on a
   PNG path (equal), every K1 call of one forward (98: 90 backbone at
   C = 52 / 104 / 208, 8 head) held against its plain version in f32 and
   in bf16, ``fuse_conv_bn=True`` giving the unfused detections,
   ``aug_test`` at (1333, 800) and (1666, 1000) with flip, its vote on the
   card against the numpy oracle on the same per-augmentation
   detections, ``async_inference_detector`` equal to the sync call,
   ``show_result`` writing a file; it prints img/s (host clock, image in
   to numpy out, median of 5), aug_test seconds per image, the device
   kernel time and idle share, peak memory and the launches per path;
   (c) ``aug_test_simple`` on the shipped X-101-64x4d-DCN bbox file, one
   scale with flip. Phase 2a also holds K1 at Res2Net's C = cout = 52,
   104 and 208 (nearest and bilinear, stride 1 and 2, f32 and bf16),
   where the wrapper pads C and cout to the kernel's multiples, and
   times the padding copy apart. The seeded weights of phase 8 spread the
   classifier (x30) so that no two kept scores tie, and zero the backbone
   ``conv_offset`` kernels so that no nearest sample sits near a rounding
   tie: card against CPU and fused against unfused then compare
   detections, not rounding flips;
9. LSNet-CPV, and Res2Net training: (a) a narrow ResNeXt-shaped CPV
   model (DCN towers, f32) on the card against the CPU: the six head
   outputs, then the loss, its six terms and every parameter's gradient,
   at phase 3's tolerances; (b) K1's forward, bwd-data and bwd-weight
   against their plain versions at the CPV refine call (C = 262, cout =
   256, the five-level cross-level job at B=2, 800x1344) and Res2Net's
   C = cout = 52 / 104 / 208 (stride 1 and 2), f32 and bf16, nearest and
   bilinear, at phase 2's tolerances: the wrappers pad C and cout to the
   kernels' multiples; for bf16 bilinear each kernel's device time, the
   padding copies' device time, the einsum yardsticks, and at the CPV
   shape the two places for the padding (saved from the forward, or
   again in each backward wrapper) by time and memory; (c) the shipped
   X-101-64x4d-DCN CPV file at full width, 80 classes: ``init_detector``
   from a ``save_checkpoint`` file and ``inference_detector`` twice on a
   seeded 480x640 image (equal detections, 9 K1 and 30 grouped
   launches), ``detect`` at B=2 800x1344 bf16 (9 K1, 30 grouped a
   forward), ``CPV_TRAIN_STEPS`` train steps (bilinear, 20 instances an
   image; 9 / 30 launches each way a step, finite loss, trainable
   parameters moved and frozen ones not), each profiled, then
   ``lsnet_torch.tools.bench_cpv``; (d) the shipped Res2Net-101-DCN CPV
   file at full width through ``lsnet_torch.tools.train`` (1 epoch of 2
   steps on 4 procedural 768x1280 images, an EvalHook on 2 more) and
   ``lsnet_torch.tools.test`` on its checkpoint (metrics within 1e-4 of
   the hook's), 189 K1 forward launches a step (90 backbone calls twice
   under ``with_cp``, 9 head), 99 of each backward kernel, 99 forward an
   eval batch; every K1 call of the first train step held against its
   plain version;
10. the RepPoints family: (a) narrow RepPoints v1 and v2 models (R50,
   feat 64, two stacked convs, f32) on the card against the CPU: the
   head outputs, then the loss, its terms and every parameter's
   gradient, at phase 3's tolerances; (b) K1's forward, bwd-data and
   bwd-weight against their plain versions at RepPoints' paired gather
   (B=2, 800x1344, the five levels, each job on its own level, no mask,
   scale 1, bilinear) at C = cout = 256 and at v2's C = 262 (padded to
   288), f32 and bf16, with each call's time beside its bound; (c) and
   (d) the shipped ``reppoints_moment`` and ``reppoints_v2_moment`` files
   at full width, 80 classes: ``init_detector`` from a
   ``save_checkpoint`` file, ``inference_detector`` twice on a seeded
   480x640 image (equal detections), ``detect`` at B=2 800x1344 bf16 (2
   K1 and 0 grouped launches a forward), 2 train steps at B=2 bf16 (2 K1
   launches of each kind a step, finite loss, trainable parameters moved
   and frozen ones not), each profiled; (e) the two shipped Dense
   RepPoints files (729 points): ``detect`` and one train step, no K1
   launch, peak memory; (f) the RepPoints moment file through
   ``lsnet_torch.tools.train`` (1 epoch of 2 steps on 4 procedural
   768x1280 images, an EvalHook on 2 more) and ``lsnet_torch.tools.test``
   on its checkpoint (metrics within 1e-4 of the hook's);
11. the dense zoo: (a) each of the thirteen shipped RetinaNet,
   GA-RetinaNet, GA-RPN, FCOS, ATSS, GFL, FoveaBox, FSAF, FreeAnchor,
   PISA RetinaNet, SSD300, PISA SSD300 and NAS-FCOS files as a narrow
   model (R50, feat 64, two stacked convs, f32; the SSD files' fixed
   VGG-16 and head on one 300x300 image in f64) on the card against the
   CPU: the head outputs, then the loss, its terms and every parameter's
   gradient, at phase 3's tolerances; K1's forward, bwd-data and
   bwd-weight against their plain versions at Guided Anchoring's
   mask-free feature adaption (C = cout = 256, each level's job on its
   own level, scale 1, bilinear): GA-RetinaNet's 44,800 px and GA-RPN's
   179,046 (its FPN starts at C2), f32 and bf16; (b) each file at full width, 80 classes, seeded weights:
   ``init_detector`` from a ``save_checkpoint`` file and
   ``inference_detector`` twice (GA-RPN, which the API refuses, through
   ``detect`` only), ``detect`` at B=2 800x1344 bf16 (the SSD files at
   B=8 300x300) and 2 train steps, each profiled, with the K1 launches
   asserted (GA-RetinaNet 2, GA-RPN 1 a forward and of each backward
   kernel a step, the other eleven 0); (c) GA-RetinaNet through
   ``lsnet_torch.tools.train`` and ``lsnet_torch.tools.test``, as (10f);
   (d) the SSD300 file the same way (its augmentations, its 300x300
   canvas, no neck; 360x480 procedural images);
12. refine taps and the port's user tools: (a) K1's forward, bwd-data and
   bwd-weight at K = 5 (``LSNET_REFINE_TAPS=5``: the plus taps) against
   their plain versions at the R50 bbox file's paired refine call (B=2,
   800x1344, C = cout = 256, bilinear), f32 and bf16, at phase 2's
   tolerances, each time beside K = 9 at the same call and beside its
   bound; (b) a narrow R50-shaped model at taps 5 on the card against the
   CPU (outputs, loss and gradients, phase 3's tolerances), then the
   shipped R50 bbox file at full width with ``LSNET_REFINE_TAPS=5`` set
   for the phase: 2 train steps at B=2 bf16 (K1 at K = 5 at the 2 refine
   contractions and K = 9 at the 6 tower blocks, each way, counted by K),
   a checkpoint whose meta records the taps, deployed at 5 taps by
   ``init_detector`` with the variable unset (``inference_detector`` on a
   480x640 image, ``detect`` at B=2); (c) ``lsnet_torch.tools.
   test_robustness`` on the X-101-64x4d-DCN bbox file from a seeded
   checkpoint over 4 procedural 768x1280 images, gaussian_noise and fog
   at severities 0, 1 and 5 (8 K1 and 30 grouped launches every eval
   batch, the json's layout, ``robustness_eval``'s P / mPC / rPC, clean
   and corrupted eval img/s); (d) print_config, get_flops (the X-101 file
   at 800x1344; a narrow model counted alike on the card and the CPU),
   fuse_conv_bn and publish_model (the same detections through
   ``init_detector``), analyze_logs on phase 6's log, browse_dataset,
   coco_error_analysis and gen_coco_lsvr, one OK line each.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
(all ten kernels) and, last, ``{"ok": true, "device": {...}}``; the
card's clocks, power draw and temperature are logged before and after
phases 2c, 2d and the profiled train steps. ``python3 chip_smoke.py --only
backward`` builds, runs phases 2c and 2d alone and prints no result line
(for work on the backward kernels); ``--only probes`` does the same for
phase 2e, ``--only accuracy`` for phase 7, ``--only api`` for the Res2Net
K1 cases of phase 2a and phase 8, ``--only cpv`` for phase 9,
``--only reppoints`` for phase 10, ``--only dense`` for phase 11,
``--only tools`` for phase 12 (after a narrow runner on the card for
analyze_logs' log). With
``CHIP_SMOKE_LOG=<path>`` in the environment it also writes every line it
prints to that file, each after the seconds since the start. It needs
the repository
around it and a CUDA device, and runs no JAX.
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from lsnet_torch import _build  # noqa: E402
from lsnet_torch import apis  # noqa: E402
from lsnet_torch.apis import (detect, init_model,  # noqa: E402
                              train_detector_step)
from lsnet_torch import configs  # noqa: E402
from lsnet_torch.configs import (flagship_r50_cfg,  # noqa: E402
                                 x101_flagship_cfg)
from lsnet_torch.core import cpv  # noqa: E402
from lsnet_torch.core.cpv import CPVLossConfig  # noqa: E402
from lsnet_torch.core.decode import TestConfig  # noqa: E402
from lsnet_torch.core.loss import LossConfig  # noqa: E402
from lsnet_torch.core import reppoints as rp  # noqa: E402
from lsnet_torch.evalkit import tta  # noqa: E402
from lsnet_torch.models import (build_backbone, build_detector,  # noqa: E402
                                head_cfg_of)
from lsnet_torch.models.heads.ls_head import branch_pyramid_jobs  # noqa: E402
from lsnet_torch.models.init import init_weights_  # noqa: E402
from lsnet_torch.models.layers import (  # noqa: E402
    FrozenBatchNorm, ModulatedDeformConvPack)
from lsnet_torch.ops import deform_gather as dg  # noqa: E402
from lsnet_torch.ops import flat_deform as fd  # noqa: E402
from lsnet_torch.ops import grouped as gr  # noqa: E402
from lsnet_torch.ops import probes  # noqa: E402
from lsnet_torch.tools import accuracy_run as accuracy_tool  # noqa: E402
from lsnet_torch.tools import probe as probe_tool  # noqa: E402
from lsnet_torch.ops.deform_gather import (  # noqa: E402
    deform_gather_contract, deform_gather_contract_ref)
from lsnet_torch.ops.grouped import (  # noqa: E402
    deform_gather_grouped_contract, deform_gather_grouped_contract_ref)
from lsnet_torch.tools import test as test_tool  # noqa: E402
from lsnet_torch.tools import train as train_tool  # noqa: E402
from lsnet_torch.tools.shapes import make_shapes_coco  # noqa: E402
from lsnet_torch.train import checkpoint as ckpt  # noqa: E402
from lsnet_torch.train import hooks as runner_hooks  # noqa: E402
from lsnet_torch.train import loop as runner_loop  # noqa: E402
from lsnet_torch.train import step as runner_step  # noqa: E402
from lsnet_torch.train.optim import (build_lr_schedule,  # noqa: E402
                                     build_optimizer)
from lsnet_torch.utils.config import Config  # noqa: E402

B, H, W = 2, 800, 1344
LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
FEAT = 256
K = 9
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them,
# HBM3 bandwidth
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# main-path launches of deform_gather_contract per forward: 3 DCN blocks
# per tower (cls and one tower per regression branch), then the two
# contractions of the refine gather that the main branch shares with cls;
# pose_bbox has a third tower and its bbox branch's own refine gather
K1_PER_FORWARD = {"bbox": 2 * 3 + 2, "segm": 2 * 3 + 2,
                  "pose_bbox": 3 * 3 + 2 + 1, "pose_kbox": 2 * 3 + 2}
# X-101-64x4d grouped DCN stages at B=2, 800x1344: output map, C = cout,
# calls per forward (blocks of the stage); the first block of each stage
# samples at stride 2 from a map twice the size
X101_STAGES = [("c3", (100, 168), 512, 4), ("c4", (50, 84), 1024, 23),
               ("c5", (25, 42), 2048, 3)]
GROUPS = 64
GROUPED_PER_FORWARD = sum(n for *_, n in X101_STAGES)            # 30
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max(1, max|ref|)
ITERS = 5                        # timed runs of each main path
TRAIN_WARMUP, TRAIN_STEPS = 2, 3
NUM_GT = 20
NUM_VECTORS = {"bbox": 4, "segm": 36, "pose_bbox": 17, "pose_kbox": 17}
PROBE_TIME_LIMIT = 30.0          # seconds a probe launch may take
COPY_RATE_ROWS = 9 * 16384       # block gathers of the copy-rate timing
LARGE_DOT_P = 16384              # pixels of the sub-row dot's large run
LARGE_SUM_P = 65536              # pixels of the sub-row sum's large run:
#                                  x 128 MB and out 32 MB pass the 50 MB L2
L2_FLUSH_BYTES = 256 << 20       # written before each call of a cold timing
PROFILE_TRIES = 16               # profiles that may lose their device records
LOST_PROFILES = []               # host records of each profile that did
# phase 6: the shipped X-101-64x4d-DCN bbox config through the runner, on
# procedural sets of 768x1280 landscape and 1280x768 portrait images
# (aspect 5:3, so the multi-scale range (1333, 480)-(1333, 960) keeps every
# resize inside the config's (800, 1344) canvas)
R50_CONFIG = os.path.join(REPO, "configs", "lsnet",
                          "lsnet_bbox_r50_fpn_1x_coco.py")
RUNNER_CONFIG = os.path.join(REPO, "configs", "lsnet",
                             "lsnet_bbox_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py")
LAND, PORT = (768, 1280), (1280, 768)
RUNNER_TRAIN_HW = [LAND, LAND, LAND, PORT] * 2          # 6 + 2 images
RUNNER_VAL_HW = [LAND, LAND, LAND, PORT]
RUNNER_EPOCHS, RUNNER_STEPS = 2, 4                      # steps per epoch
PRETRAINED_SEED = 1          # the runner's own init draws from seed 0
# phase 7: a short accuracy_run, R50-DCN bbox, 10 steps an epoch (the
# tool logs a loss record every 10 iterations of an epoch)
ACC_EPOCHS, ACC_TRAIN, ACC_VAL, ACC_BATCH = 2, 80, 16, 8
# K1 launches a train step (forward, and each backward kernel): the 13
# DCN blocks of R50's c3-c5 (4 + 6 + 3), 2 DCN tower blocks for each of
# the 2 branches, the 2 contractions of the paired refine gather
ACC_K1_PER_STEP = 13 + 2 * 2 + 2
# phase 8: the image-level API. Res2Net-101's DCN stages at the 800x1344
# canvas, B=1: output map, 3x3 width C = cout (floor(planes * 26 / 64)),
# blocks (each block three K1 calls on channel slices; the first samples
# at stride 2 from a map twice the size)
RES2_STAGES = [("c3", (100, 168), 52, 4), ("c4", (50, 84), 104, 23),
               ("c5", (25, 42), 208, 3)]
RES2_K1_PER_FORWARD = (3 * sum(n for *_, n in RES2_STAGES)
                       + K1_PER_FORWARD["segm"])               # 90 + 8
RES2_CONFIG = os.path.join(
    REPO, "configs", "lsnet",
    "lsnet_segm_res2_101_fpn_dconv_c3-c5_mstrain_30e_coco.py")
# phase 9: LSNet-CPV. K1 launches a forward of the CPV head: 3 DCN blocks
# in each of the cls and bbox towers, the shared DCN block on the bbox
# tower's output, the 2 contractions of the paired refine / cls gather
# (C = 256 + 6 corner channels)
CPV_K1_PER_FORWARD = 2 * 3 + 1 + 2
CPV_C = FEAT + 6
CPV_X101_CONFIG = os.path.join(
    REPO, "configs", "lsnet",
    "lsnet_bbox_cpv_x101_fpn_dconv_c3-c5_mstrain_2x_coco.py")
CPV_RES2_CONFIG = os.path.join(
    REPO, "configs", "lsnet",
    "lsnet_bbox_cpv_res2_101_fpn_dconv_c3-c5_mstrain_2x_coco.py")
CPV_TRAIN_STEPS = 2              # counted train steps of phase 9c
# a Res2Net-101-CPV train step (with_cp): the 90 backbone K1 calls run in
# the forward and again in the backward's recompute, the 9 head calls
# once; each backward kernel once per call
RES2_CPV_K1_CALLS = 3 * sum(n for *_, n in RES2_STAGES) + CPV_K1_PER_FORWARD
RES2_CPV_PER_STEP = {
    "deform_gather_contract": 3 * sum(n for *_, n in RES2_STAGES)
    + RES2_CPV_K1_CALLS,                                          # 189
    "deform_gather_contract_bwd_data": RES2_CPV_K1_CALLS,          # 99
    "deform_gather_contract_bwd_weight": RES2_CPV_K1_CALLS}        # 99
RES2_CPV_TRAIN_HW = [LAND] * 4   # 2 steps of 2 images, aspect 5:3
RES2_CPV_VAL_HW = [LAND] * 2     # one eval batch
API_IMAGE_HW = (480, 640)
API_SCALES = [(1333, 800), (1666, 1000)]         # aug_test, each with flip
API_RUNS = 5                     # timed inference_detector calls (median)
CLS_SPREAD = 30.0                # the classifier's weights x this (below)
# phase 10: the RepPoints family. K1 launches a forward of a RepPoints v1
# or v2 head: the 2 contractions of its paired cls / refine gather (C =
# 256, v2 256 + 6 corner channels); the Dense RepPoints heads run none
RP_CONFIGS = {
    "v1": os.path.join(REPO, "configs", "reppoints",
                       "reppoints_moment_r50_fpn_1x_coco.py"),
    "v2": os.path.join(REPO, "configs", "reppoints",
                       "reppoints_v2_moment_r50_fpn_1x_coco.py"),
    "dense_v1": os.path.join(REPO, "configs", "dense_reppoints",
                             "dense_reppoints_r50_fpn_1x_coco.py"),
    "dense_v2": os.path.join(REPO, "configs", "dense_reppoints",
                             "dense_reppoints_v2_r50_fpn_1x_coco.py")}
RP_K1_PER_FORWARD = 2
RP_V2_C = FEAT + 6
RP_TRAIN_STEPS = 2               # counted train steps of phases 10c, 10d
DENSE_TRAIN_STEPS = 1            # of phase 10e
RP_RUNNER_TRAIN_HW = [LAND] * 4  # 2 steps of 2 images, aspect 5:3
RP_RUNNER_VAL_HW = [LAND] * 2    # one eval batch
# phase 11: the dense zoo. K1 launches a forward: GA-RetinaNet's two
# feature adaptions (cls, reg), GA-RPN's one; RetinaNet, FCOS, ATSS and
# GFL run none. GA-RPN's FPN starts at C2: its levels are at strides 4 to
# 64, so its adaption reads B x 89,523 px (GA-RetinaNet's 22,400 a image)
# FoveaBox, FSAF, FreeAnchor, PISA RetinaNet and NAS-FCOS on R50 at
# 800x1344, B=2 as the rest; SSD300 and PISA SSD300 on their VGG-16 with
# no neck, at 300x300 and their file's B=8; none runs K1
ZOO_CONFIGS = {
    name: os.path.join(REPO, "configs", *path.split("/")) for name, path in (
        ("retina", "retinanet/retinanet_r50_fpn_1x_coco.py"),
        ("ga_retina", "guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py"),
        ("ga_rpn", "guided_anchoring/ga_rpn_r50_fpn_1x_coco.py"),
        ("fcos", "fcos/fcos_r50_fpn_1x_coco.py"),
        ("atss", "atss/atss_r50_fpn_1x_coco.py"),
        ("gfl", "gfl/gfl_r50_fpn_1x_coco.py"),
        ("fovea", "foveabox/fovea_r50_fpn_4x4_1x_coco.py"),
        ("fsaf", "fsaf/fsaf_r50_fpn_1x_coco.py"),
        ("free_anchor",
         "free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py"),
        ("pisa_retina", "pisa/pisa_retinanet_r50_fpn_1x_coco.py"),
        ("ssd", "ssd/ssd300_coco.py"),
        ("pisa_ssd", "pisa/pisa_ssd300_coco.py"),
        ("nas_fcos", "nas_fcos/nas_fcos_fcoshead_r50_fpn_1x_coco.py"))}
ZOO_LABELS = {"retina": "RetinaNet", "ga_retina": "GA-RetinaNet",
              "ga_rpn": "GA-RPN", "fcos": "FCOS", "atss": "ATSS",
              "gfl": "GFL", "fovea": "FoveaBox", "fsaf": "FSAF",
              "free_anchor": "FreeAnchor", "pisa_retina": "PISA-RetinaNet",
              "ssd": "SSD300", "pisa_ssd": "PISA-SSD300",
              "nas_fcos": "NAS-FCOS"}
ZOO_SSD = ("ssd", "pisa_ssd")
SSD_B, SSD_HW = 8, (300, 300)
ZOO_K1_PER_FORWARD = {"ga_retina": 2, "ga_rpn": 1}
GA_RPN_LEVELS = [(200, 336)] + LEVELS[:4]
ZOO_TRAIN_STEPS = 2              # counted train steps of phase 11b
# phase 11d: the SSD300 file's runner on smaller procedural images (its
# Expand augmentation grows an image up to 4x a side before the crop)
SSD_RUNNER_TRAIN_HW = [(360, 480), (480, 360)] * 2
SSD_RUNNER_VAL_HW = [(360, 480)] * 2


LOG_PATH = os.environ.get("CHIP_SMOKE_LOG")    # optional copy of the log
STARTED = time.perf_counter()


def log(msg):
    """Print ``msg``; copy it to LOG_PATH, where given, after the seconds
    since the script started."""
    print(msg, flush=True)
    if LOG_PATH:
        with open(LOG_PATH, "a") as f:
            f.write(f"[{time.perf_counter() - STARTED:7.1f}s] {msg}\n")


def cuda_ms(fn, iters):
    """Mean device time of fn() over iters launches, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dev_us(event):
    """Device time of a profiler event, in microseconds."""
    return getattr(event, "device_time_total",
                   getattr(event, "cuda_time_total", 0.0))


def kernel_device_us(fn, kernel="", iters=10, skip=(), per_call=None,
                     profiles=1):
    """Mean device time per call of fn() of the kernels whose name contains
    ``kernel`` (all of fn's kernels by default) and is none of ``skip``,
    from the profiler (the median of ``profiles`` profiles): for
    work so short that CUDA events around the calls time the host's launch
    rate instead. Raises AssertionError when PROFILE_TRIES profiles in a
    row lack ``kernel``'s device records, or hold a number of them that is
    no whole multiple of ``iters`` (not ``per_call * iters`` exactly, where
    the caller knows that fn() launches ``per_call`` of them).

    A profile can lose every device record while it keeps the host's (the
    launches): on the H100 with PyTorch 2.11 / CUDA 12.8 it happened to a
    probe kernel and to ``torch.mm`` alike, cluster launch or not, rarely
    and sometimes for several profiles in a row (eight in a row once, for
    K1 in phase 10b), each time with an "Activity
    Buffer Request" span (CUPTI asking the profiler for a new record
    buffer) over the first launch; so each profile records its calls in
    a second step, after a warm-up step of the same calls in which the
    profiler starts collecting. A profile can also lose only some of
    them: the named kernel's records missing beside those of other kernels,
    or fewer of them than a whole number per call. Such a profile is taken
    again and its records kept in LOST_PROFILES (``bench_probes`` and
    ``bench_grouped`` report them); it is never read as 0 or as a part of
    the calls. A profile that holds every record can still read about half
    the time of the profiles before and after it (K1 at RepPoints' paired
    call, twice in four runs, events times steady): ``profiles`` > 1 keeps
    such a reading out of the median, and logs every reading."""
    fn()
    torch.cuda.synchronize()
    readings = [_profile_device_us(fn, kernel, iters, skip, per_call)
                for _ in range(profiles)]
    if profiles > 1:
        log(f"kernel_device_us {kernel!r}: readings {readings}")
    return sorted(readings)[profiles // 2]


def _profile_device_us(fn, kernel, iters, skip, per_call):
    """One accepted profile's reading for :func:`kernel_device_us`."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule
    on_device = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=[ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1,
                                        repeat=1)) as prof:
            for _ in range(2):              # warm-up step, recorded step
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        averages = prof.key_averages()
        events = [e for e in averages if e.device_type == on_device
                  and not e.key.startswith("ProfilerStep")]
        mine = [e for e in events if kernel in e.key and e.key not in skip]
        launches = sum(e.count for e in mine)
        # each call launches the named kernel a whole number of times
        whole = (launches % iters == 0 if per_call is None
                 else launches == per_call * iters)
        if mine and (not kernel or whole):
            break
        LOST_PROFILES.append([f"{e.key} x{e.count}" for e in averages])
        log(f"kernel_device_us: the profile of {kernel!r} lost device "
            f"records; records {LOST_PROFILES[-1]}")
    else:
        raise AssertionError(f"kernel_device_us: {PROFILE_TRIES} profiles "
                             f"of {kernel!r} in a row without all its "
                             "device records")
    return sum(dev_us(e) for e in mine) / iters


def reset_persisting_l2():
    """Return every L2 line that an evict_last (persisting) policy keeps to
    normal, through libcuda's cuCtxResetPersistingL2Cache: such lines
    outlive a write of L2_FLUSH_BYTES, and the block gather's table lines
    would otherwise flatter the next call of any function that reads the
    same table."""
    import ctypes
    rc = ctypes.CDLL("libcuda.so.1").cuCtxResetPersistingL2Cache()
    if rc != 0:
        raise RuntimeError(f"cuCtxResetPersistingL2Cache: CUDA error {rc}")


def cold_device_us(fn, kernel="", iters=10):
    """kernel_device_us of fn() with the L2 cold: before each call the
    persisting lines reset (reset_persisting_l2) and a write of
    L2_FLUSH_BYTES, whose own device records (their names read from a
    profile of the write alone) are left out."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            flush.zero_()
            torch.cuda.synchronize()
        flush_keys = {e.key for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA}
        if flush_keys:
            break
    else:
        raise AssertionError("cold_device_us: no device record of the L2 "
                             "flush")

    def call():
        reset_persisting_l2()
        flush.zero_()
        return fn()

    return kernel_device_us(call, kernel, iters, skip=flush_keys)


def card_state(label):
    """Log the card's SM clock, power draw and temperature; a failure of
    nvidia-smi is logged and changes nothing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as ex:
        out = f"nvidia-smi failed: {ex}"
    log(f"card state {label}: {out}")


def main_path_inputs(dtype, gen, sampling):
    """(flat, idx, w, weight) of one tower call and of one refine
    contraction, built by the port's own index code from random level maps
    and offsets of the main path's shapes."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    feats = [rnd(B, h, w, FEAT).to(dtype) for h, w in LEVELS]
    levels = fd.pack_levels(feats)
    weight = rnd(K, FEAT, FEAT, scale=0.02).to(dtype).contiguous()
    tower_jobs = [fd.SampleJob(i, rnd(B, h, w, 2 * K, scale=2.0),
                               torch.rand(B, h, w, K, generator=gen).to(dev),
                               (1.0, 1.0), (1, 1), (1, 1), (1, 1))
                  for i, (h, w) in enumerate(LEVELS)]
    idx, w = fd._gather_indices_tap(levels, tower_jobs, K, sampling)
    tower = (levels.flat.contiguous(), idx, w, weight)
    offs = [rnd(B, h, w, 2 * K, scale=2.0) for h, w in LEVELS]
    refine_jobs = branch_pyramid_jobs(LEVELS, offs, 3)
    idx, w = fd._gather_indices_tap(levels, refine_jobs, K, sampling)
    refine = (levels.flat.contiguous(), idx, w, weight)
    return tower, refine


def work(args):
    """(operations, bytes) the function needs for these inputs: the corner
    weighting, and the products of each output with its (K, C/G) inputs
    (weight (K, C/G, cout); G = 1 for deform_gather_contract)."""
    flat, idx, w, weight = args[:4]
    nc, k, px = idx.shape
    C = flat.shape[1]
    cin, cout = weight.shape[1], weight.shape[2]
    ops = 2 * k * px * cin * cout + 2 * nc * k * px * C
    nbytes = (flat.numel() * flat.element_size() + idx.numel() * 4
              + w.numel() * 4 + weight.numel() * weight.element_size()
              + px * cout * flat.element_size())
    return ops, nbytes


def work_bwd_data(args):
    """bwd-data: the forward's product once (G = dout @ W^T), two passes
    over the corners (the d_w dot products and the weighted scatter); it
    reads flat, the table, the weight and dout and writes d_flat in f32
    and d_w."""
    flat, idx, w, weight = args[:4]
    nc, k, px = idx.shape
    C = flat.shape[1]
    cin, cout = weight.shape[1], weight.shape[2]
    ops = 2 * k * px * cin * cout + 2 * (2 * nc * k * px * C)
    nbytes = (flat.numel() * flat.element_size() + idx.numel() * 4
              + w.numel() * 4 + weight.numel() * weight.element_size()
              + px * cout * flat.element_size()
              + flat.numel() * 4 + w.numel() * 4)
    return ops, nbytes


def work_bwd_weight(args):
    """bwd-weight: the product once (V^T @ dout) and the corner weighting;
    it reads flat, the table and dout and writes d_weight."""
    flat, idx, w, weight = args[:4]
    nc, k, px = idx.shape
    C = flat.shape[1]
    cin, cout = weight.shape[1], weight.shape[2]
    ops = 2 * k * px * cin * cout + 2 * nc * k * px * C
    nbytes = (flat.numel() * flat.element_size() + idx.numel() * 4
              + w.numel() * 4 + px * cout * flat.element_size()
              + weight.numel() * weight.element_size())
    return ops, nbytes


def bound_ms(args, work=work):
    ops, nbytes = work(args)
    t_ops = ops / PEAK_OPS[args[0].dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_kernel():
    """Phase 2a: deform_gather_contract vs its plain version at the
    head's shapes."""
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    per_fwd = {}
    for dtype in (torch.float32, torch.bfloat16):
        for sampling in ("bilinear", "nearest"):
            for site, args in zip(("tower", "refine"),
                                  main_path_inputs(dtype, gen, sampling)):
                got = deform_gather_contract(*args).float()
                want = deform_gather_contract_ref(*args).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                lim = TOL[dtype] * max(1.0, want.abs().max().item())
                ok = bool(torch.isfinite(got).all()) and err <= lim
                del got, want
                ms = cuda_ms(lambda: deform_gather_contract(*args), 20)
                plain = cuda_ms(lambda: deform_gather_contract_ref(*args), 3)
                bnd, by = bound_ms(args)
                row = dict(site=site, dtype=str(dtype).split(".")[-1],
                           sampling=sampling, px=args[1].shape[2],
                           nc=args[1].shape[0], max_abs_err=err, limit=lim,
                           ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                           tflops=work(args)[0] / ms / 1e9)
                log("kernel " + json.dumps(row))
                if not ok:
                    raise AssertionError(f"kernel disagrees: {row}")
                if dtype == torch.bfloat16 and sampling == "bilinear":
                    # yardstick: one PyTorch call on the already gathered
                    # (K, px, C) patch tensor
                    vals = dg.gathered_rows(*args[:3]).to(dtype)
                    row["library_ms"] = cuda_ms(
                        lambda: torch.einsum("kpc,kco->po", vals, args[3]),
                        10)
                    del vals
                    log(f"kernel library {site}: einsum "
                        f"{row['library_ms']:.4f} ms")
                    per_fwd[site] = row
                    max_err = max(max_err, err)
                del args
            torch.cuda.empty_cache()
    # one forward = 6 tower calls + 2 refine contractions (bf16, bilinear)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    fwd = {key: 6 * per_fwd["tower"][key] + 2 * per_fwd["refine"][key]
           for key in keys}
    fwd["bound_by"] = max(per_fwd.values(),
                          key=lambda r: r["bound_ms"])["bound_by"]
    fwd["per_call"] = {site: {key: row[key] for key in keys}
                       for site, row in per_fwd.items()}
    return fwd, max_err


def grouped_inputs(gen, out_hw, C, stride):
    """(levels, job, weight) of one grouped backbone DCN call, f32: a
    random input map (twice the output size at stride 2), random offsets
    and masks, a compact (K, C/G, C) weight."""
    dev = torch.device("cuda")
    h, w = out_hw
    feat = torch.randn(B, h * stride, w * stride, C, device=dev,
                       generator=gen)
    job = fd.SampleJob(
        0, 2.0 * torch.randn(B, h, w, 2 * K, device=dev, generator=gen),
        torch.rand(B, h, w, K, device=dev, generator=gen), (1.0, 1.0),
        (stride, stride), (1, 1), (1, 1))
    weight = 0.05 * torch.randn(K, C // GROUPS, C, device=dev, generator=gen)
    return fd.pack_levels([feat]), job, weight


def ptxas_summary(log, kernel):
    """Registers, spill bytes and shared memory of each entry whose name
    holds ``kernel``, from the ``-Xptxas -v`` output of one source."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = None
            if kernel in line:
                cur = {"entry": line.split("'")[1]}
                out.append(cur)
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in line.replace(",", " ").split()
                    if x.isdigit()]
            cur["stack_bytes"], cur["spill_store_bytes"], \
                cur["spill_load_bytes"] = nums[:3]
        elif cur is not None and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            cur["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                cur["static_smem_bytes"] = int(words[words.index("smem") - 2])
    return out


def check_grouped_kernel(ptxas_log=""):
    """Phase 2b: deform_gather_grouped_contract vs its plain version at the
    X-101 stages, stride 1 and 2, nearest and bilinear, f32 and bf16; the
    PyTorch grouped einsum on the same contraction as the yardstick; the
    bf16 kernel's device time (profiler) per call, summed per inference
    forward (nearest) and per train step (bilinear), beside ptxas's
    registers and spills for it (from ``ptxas_log``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}                    # (stage, stride) -> bf16 nearest row
    device_us = {}               # (stage, stride, sampling) -> bf16 us
    library = {}
    max_err = 0.0
    for stage, out_hw, C, _ in X101_STAGES:
        for stride in (1, 2):
            levels, job, weight32 = grouped_inputs(gen, out_hw, C, stride)
            for sampling in ("nearest", "bilinear"):
                idx, w = fd._gather_indices_tap(levels, [job], K, sampling)
                for dtype in (torch.float32, torch.bfloat16):
                    args = (levels.flat.to(dtype).contiguous(), idx, w,
                            weight32.to(dtype).contiguous(), GROUPS)
                    got = deform_gather_grouped_contract(*args).float()
                    want = deform_gather_grouped_contract_ref(*args).float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    lim = TOL[dtype] * max(1.0, want.abs().max().item())
                    ok = bool(torch.isfinite(got).all()) and err <= lim
                    del got, want
                    ms = cuda_ms(
                        lambda: deform_gather_grouped_contract(*args), 20)
                    plain = cuda_ms(
                        lambda: deform_gather_grouped_contract_ref(*args), 3)
                    bnd, by = bound_ms(args)
                    row = dict(stage=stage, stride=stride,
                               dtype=str(dtype).split(".")[-1],
                               sampling=sampling, px=idx.shape[2], C=C,
                               nc=idx.shape[0], max_abs_err=err, limit=lim,
                               ms=ms, plain_ms=plain, bound_ms=bnd,
                               bound_by=by,
                               gbytes_s=work(args)[1] / ms / 1e6)
                    log("grouped " + json.dumps(row))
                    if not ok:
                        raise AssertionError(f"grouped kernel disagrees: "
                                             f"{row}")
                    if dtype == torch.bfloat16:
                        device_us[stage, stride, sampling] = \
                            kernel_device_us(
                                lambda: deform_gather_grouped_contract(
                                    *args), "gdc_bf16", 10)
                    if dtype == torch.bfloat16 and sampling == "nearest":
                        main[stage, stride] = row
                        max_err = max(max_err, err)
                    del args
            del levels, job, weight32
            torch.cuda.empty_cache()
        # yardstick: one PyTorch call computing the grouped contraction of
        # an already gathered (px, K, G, C/G) patch tensor
        px = B * out_hw[0] * out_hw[1]
        cg = C // GROUPS
        vals = torch.randn(px, K, GROUPS, cg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        wg = torch.randn(K, cg, GROUPS, cg, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
        library[stage] = cuda_ms(
            lambda: torch.einsum("pkgc,kcgj->pgj", vals, wg), 10)
        log(f"grouped library {stage}: einsum {library[stage]:.4f} ms")
        del vals, wg
    # one forward: per stage one stride-2 call + (n - 1) stride-1 calls,
    # bf16, nearest (the shipped backbone sampling)
    fwd = {key: sum(main[st, 2][key] + (n - 1) * main[st, 1][key]
                    for st, _, _, n in X101_STAGES)
           for key in ("ms", "plain_ms", "bound_ms")}
    fwd["bound_by"] = max(main.values(),
                          key=lambda r: r["bound_ms"])["bound_by"]
    fwd["library_ms"] = sum(n * library[st] for st, _, _, n in X101_STAGES)
    for key, sampling in (("device_ms", "nearest"),
                          ("train_device_ms", "bilinear")):
        fwd[key] = sum(device_us[st, 2, sampling]
                       + (n - 1) * device_us[st, 1, sampling]
                       for st, _, _, n in X101_STAGES) / 1e3
    fwd["device_us_per_call"] = {f"{st} s{stride} {sampling}": us for
                                 (st, stride, sampling), us in
                                 device_us.items()}
    fwd["ptxas_gdc_bf16"] = ptxas_summary(ptxas_log, "gdc_bf16")
    log("grouped per forward " + json.dumps(fwd))
    return fwd, max_err


def split_readings(data, flat, idx):
    """Where a bwd-data call's time goes (ms): both outputs, one at a
    time, the same call on a table that sends every corner to another row
    (no two adds meet) and on one that sends all to one row (every add
    meets), and the f32 memset and the cast around the launch."""
    rows = flat.shape[0]
    distinct = (torch.arange(idx.numel(), device=idx.device) % rows).to(
        torch.int32).view(idx.shape)
    one_row = torch.full_like(idx, rows // 2)

    def zero_cast():
        return torch.zeros(flat.shape, dtype=torch.float32,
                           device=flat.device).to(flat.dtype)

    return {"both": cuda_ms(data, 5),
            "d_w_only": cuda_ms(lambda: data(need_flat=False), 5),
            "d_flat_only": cuda_ms(lambda: data(need_w=False), 5),
            "distinct_rows": cuda_ms(lambda: data(table=distinct), 5),
            "one_row": cuda_ms(lambda: data(table=one_row), 2),
            "zero_and_cast": cuda_ms(zero_cast, 5)}


def check_backward_call(label, args, groups, gen, splits=False,
                        library=False, weight_kernel=None):
    """Both backward kernels of one call against their plain versions;
    returns the log row. Tolerance as the forward's, relative to
    max(1, max|ref|) of each gradient: the kernels sum with f32 atomics in
    an order that changes from run to run, and the bf16 route rounds the
    weighted rows and G's inputs to 8 bits of mantissa. With ``splits``
    the row also gets the bwd-data kernel's split readings; with
    ``library`` (K1 only) the PyTorch calls on the already gathered (K, px,
    C) patch tensor: d_weight, and G alone for bwd-data (no PyTorch call
    gives its scatter and d_w). With ``weight_kernel`` the row also gets
    the profiler's device time of that bwd-weight kernel per call."""
    flat, idx, w, weight = args
    px, cout = idx.shape[2], weight.shape[2]
    dout = torch.randn(px, cout, device="cuda", generator=gen).to(flat.dtype)
    if groups:
        def data(table=idx, need_flat=True, need_w=True):
            return gr.deform_gather_grouped_contract_bwd_data(
                flat, table, w, weight, dout, groups, need_flat, need_w)

        def wgt():
            return gr.deform_gather_grouped_contract_bwd_weight(
                flat, idx, w, weight, dout, groups)

        def data_ref():
            return gr.deform_gather_grouped_contract_bwd_data_ref(
                flat, idx, w, weight, dout, groups)

        def wgt_ref():
            return gr.deform_gather_grouped_contract_bwd_weight_ref(
                flat, idx, w, dout, groups)
    else:
        def data(table=idx, need_flat=True, need_w=True):
            return dg.deform_gather_contract_bwd_data(
                flat, table, w, weight, dout, need_flat, need_w)

        def wgt():
            return dg.deform_gather_contract_bwd_weight(flat, idx, w, weight,
                                                        dout)

        def data_ref():
            return dg.deform_gather_contract_bwd_data_ref(flat, idx, w,
                                                          weight, dout)

        def wgt_ref():
            return dg.deform_gather_contract_bwd_weight_ref(flat, idx, w,
                                                            dout)

    row = dict(label, dtype=str(flat.dtype).split(".")[-1], px=px,
               nc=idx.shape[0])
    ok = True
    errs = {}
    for name, got, want in zip(
            ("d_flat", "d_w", "d_weight"), (*data(), wgt()),
            (*data_ref(), wgt_ref())):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lim = TOL[flat.dtype] * max(1.0, want.float().abs().max().item())
        ok = ok and bool(torch.isfinite(got).all()) and err <= lim
        errs[name] = err
        row[f"err_{name}"] = err
        row[f"limit_{name}"] = lim
        del got, want
    row["data_err"] = max(errs["d_flat"], errs["d_w"])
    row["weight_err"] = errs["d_weight"]
    for key, fn, ref, wk in (("data", data, data_ref, work_bwd_data),
                             ("weight", wgt, wgt_ref, work_bwd_weight)):
        row[f"{key}_ms"] = cuda_ms(fn, 10)
        row[f"{key}_plain_ms"] = cuda_ms(ref, 2)
        row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound_ms(args, wk)
    if weight_kernel:
        row["weight_device_us"] = kernel_device_us(wgt, weight_kernel, 10)
    if splits:
        row["data_split_ms"] = split_readings(data, flat, idx)
    if library:
        vals = dg.gathered_rows(flat, idx, w).to(flat.dtype)
        row["weight_library_ms"] = cuda_ms(
            lambda: torch.einsum("kpc,po->kco", vals, dout), 10)
        del vals
        row["data_einsum_g_only_ms"] = cuda_ms(
            lambda: torch.einsum("po,kco->kpc", dout, weight), 10)
    log("backward " + json.dumps(row))
    if not ok:
        raise AssertionError(f"backward kernel disagrees: {row}")
    return row


BWD_KEYS = ("ms", "plain_ms", "bound_ms")


def sum_rows(weighted_rows, kind):
    """Per-step totals of one backward kernel (kind "data" or "weight")
    from (count, row) pairs."""
    tot = {key: sum(n * r[f"{kind}_{key}"] for n, r in weighted_rows)
           for key in BWD_KEYS}
    tot["bound_by"] = max((r for _, r in weighted_rows),
                          key=lambda r: r[f"{kind}_bound_ms"]
                          )[f"{kind}_bound_by"]
    tot["max_abs_err"] = max(r[f"{kind}_err"] for _, r in weighted_rows)
    return tot


def check_backward_kernels():
    """Phase 2c: the two backward kernels of deform_gather_contract at the
    head's tower and refine shapes."""
    gen = torch.Generator().manual_seed(2)
    cgen = torch.Generator(device="cuda").manual_seed(2)
    main = {}
    card_state("before phase 2c")
    for dtype in (torch.float32, torch.bfloat16):
        for sampling in ("bilinear", "nearest"):
            for site, args in zip(("tower", "refine"),
                                  main_path_inputs(dtype, gen, sampling)):
                is_main = dtype == torch.bfloat16 and sampling == "bilinear"
                row = check_backward_call(
                    dict(site=site, sampling=sampling), args, 0, cgen,
                    splits=is_main, library=is_main)
                if is_main:
                    main[site] = row
                del args
            torch.cuda.empty_cache()
    card_state("after phase 2c")
    # one step = 6 tower calls + 2 refine contractions (bf16, bilinear)
    rows = [(6, main["tower"]), (2, main["refine"])]
    out = {kind: sum_rows(rows, kind) for kind in ("data", "weight")}
    lib = {"weight": "weight_library_ms", "data": "data_einsum_g_only_ms"}
    for kind in out:
        out[kind]["per_call"] = {
            site: {key: row[f"{kind}_{key}"] for key in BWD_KEYS}
            for site, row in main.items()}
        for site, row in main.items():
            out[kind]["per_call"][site][lib[kind]] = row[lib[kind]]
    out["weight"]["library_ms"] = sum(n * r["weight_library_ms"]
                                      for n, r in rows)
    out["data"]["library_ms"] = None
    out["data"]["einsum_g_only_ms"] = sum(n * r["data_einsum_g_only_ms"]
                                          for n, r in rows)
    log("backward per step " + json.dumps(out))
    return out


def check_grouped_backward_kernels(ptxas_log=""):
    """Phase 2d: the two backward kernels of
    deform_gather_grouped_contract at the X-101 stages, stride 1 and 2;
    the PyTorch transposed einsums on an already gathered patch tensor as
    the yardstick. Also the forward's bilinear (training) time, and the
    bf16 bwd-weight kernel's (``gdw_bf16``) device time (profiler) per
    call and per train step beside ptxas's registers and spills for it
    (from ``ptxas_log``)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    main = {}
    fwd_train = {}
    library = {"data": {}, "weight": {}}
    card_state("before phase 2d")
    for stage, out_hw, C, _ in X101_STAGES:
        for stride in (1, 2):
            levels, job, weight32 = grouped_inputs(gen, out_hw, C, stride)
            for sampling in ("bilinear", "nearest"):
                idx, w = fd._gather_indices_tap(levels, [job], K, sampling)
                for dtype in (torch.float32, torch.bfloat16):
                    args = (levels.flat.to(dtype).contiguous(), idx, w,
                            weight32.to(dtype).contiguous())
                    is_main = (dtype == torch.bfloat16
                               and sampling == "bilinear")
                    row = check_backward_call(
                        dict(stage=stage, stride=stride, sampling=sampling,
                             C=C), args, GROUPS, gen, splits=is_main,
                        weight_kernel="gdw_bf16" if is_main else None)
                    if is_main:
                        main[stage, stride] = row
                        fwd_train[stage, stride] = cuda_ms(
                            lambda: deform_gather_grouped_contract(
                                *args, GROUPS), 20)
                    del args
            del levels, job, weight32
            torch.cuda.empty_cache()
        px = B * out_hw[0] * out_hw[1]
        cg = C // GROUPS
        vals = torch.randn(px, K, GROUPS, cg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        wg = torch.randn(K, cg, GROUPS, cg, device="cuda", generator=gen,
                         dtype=torch.bfloat16)
        dout = torch.randn(px, GROUPS, cg, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        library["data"][stage] = cuda_ms(
            lambda: torch.einsum("pgj,kcgj->pkgc", dout, wg), 10)
        library["weight"][stage] = cuda_ms(
            lambda: torch.einsum("pkgc,pgj->kcgj", vals, dout), 10)
        del vals, wg, dout
    rows = []
    for st, _, _, n in X101_STAGES:
        rows += [(1, main[st, 2]), (n - 1, main[st, 1])]
    out = {kind: sum_rows(rows, kind) for kind in ("data", "weight")}
    # no PyTorch call computes bwd-data's whole function: the einsum gives
    # G alone (no scatter, no d_w) and is logged as such
    lib = {kind: sum(n * library[kind][st] for st, _, _, n in X101_STAGES)
           for kind in library}
    out["weight"]["library_ms"] = lib["weight"]
    out["data"]["library_ms"] = None
    out["data"]["einsum_g_only_ms"] = lib["data"]
    out["forward_bilinear_ms"] = sum(
        fwd_train[st, 2] + (n - 1) * fwd_train[st, 1]
        for st, _, _, n in X101_STAGES)
    out["weight"]["device_ms"] = sum(
        n * r["weight_device_us"] for n, r in rows) / 1e3
    out["weight"]["device_us_per_call"] = {
        f"{st} s{stride}": r["weight_device_us"]
        for (st, stride), r in main.items()}
    out["weight"]["ptxas"] = ptxas_summary(ptxas_log, "gdw_bf16")
    card_state("after phase 2d")
    log("grouped backward per step " + json.dumps(out))
    return out


def within_time_limit(fn, what):
    """fn() (which launches on the current stream), then wait for the
    device under a host-side time limit: a kernel that hangs (a barrier
    that never completes) ends the run with a message instead of holding
    the card."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > PROBE_TIME_LIMIT:
            log(f"chip_smoke: {what} did not finish within "
                f"{PROBE_TIME_LIMIT:.0f} s (a hung kernel); giving up")
            os._exit(1)
        time.sleep(0.001)
    return out


def probe_work(name, args):
    """(operations, their peak rate, bytes) of one probe call: each input
    the function needs read once (of a gathered table only the blocks the
    indices name), the output written once."""
    x = args[0]
    if name == "probe_row_copy":
        row = x.shape[1] * x.element_size()
        return 0, PEAK_OPS[torch.float32], 2 * row
    if name == "probe_block_gather":
        block = probes.BLOCK_ROWS * x.shape[1] * x.element_size()
        idx = args[1]
        return (0, PEAK_OPS[torch.float32],
                (idx.unique().numel() + idx.numel()) * block
                + idx.numel() * 4)
    P = x.shape[0]
    out_bytes = P * 128 * 4
    if name == "probe_subrow_sum":
        return (x.numel(), PEAK_OPS[torch.float32],
                x.numel() * x.element_size() + out_bytes)
    w = args[1]
    return (2 * x.numel() * w.shape[2], PEAK_OPS[torch.bfloat16],
            (x.numel() + w.numel()) * x.element_size() + out_bytes)


def probe_bound_ms(name, args):
    ops, rate, nbytes = probe_work(name, args)
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def probe_library_call(name, args):
    """One PyTorch call that computes the probe's function on the same
    inputs (a yardstick only; the port never calls it)."""
    x = args[0]
    if name == "probe_row_copy":
        return lambda: torch.narrow_copy(x, 0, 0, 1)
    if name == "probe_block_gather":
        blocks = x.view(-1, probes.BLOCK_ROWS * x.shape[1])
        return lambda: torch.index_select(blocks, 0, args[1])
    if name == "probe_subrow_sum":
        return lambda: torch.sum(x, dim=1, dtype=torch.float32)
    a, b = x.view(x.shape[0], -1), args[1].view(-1, args[1].shape[2])
    return lambda: torch.mm(a, b, out_dtype=torch.float32)


def copy_rate_inputs(gen):
    """The block gather's copy-rate inputs: COPY_RATE_ROWS random indices
    of the 2,048-byte blocks of a 64 MB bf16 table (larger than the 50 MB
    L2)."""
    dev = torch.device("cuda")
    table = torch.randn(32768 * probes.BLOCK_ROWS, 128, device=dev,
                        generator=gen).to(torch.bfloat16)
    rows = torch.randint(0, 32768, (COPY_RATE_ROWS,), device=dev,
                         generator=gen, dtype=torch.int32)
    return [table, rows]


def large_probe_inputs(name, P, gen):
    """Seeded normals for a sub-row probe at P pixels: x (P, 8, 128) bf16,
    and for the dot w (8, 128, 128) bf16 / 16."""
    dev = torch.device("cuda")
    args = [torch.randn(P, probes.SUBROWS, probes.SUBROW, device=dev,
                        generator=gen).to(torch.bfloat16)]
    if name == "probe_subrow_dot":
        args.append((torch.randn(probes.SUBROWS, probes.SUBROW, 128,
                                 device=dev, generator=gen) / 16).to(
                                     torch.bfloat16))
    return args


def check_large(name, P, gen):
    """A sub-row probe at P seeded normals (the sum at LARGE_SUM_P: x
    128 MB, out 32 MB; the dot at LARGE_DOT_P: x 32 MB, w 256 KB, out
    8 MB): the kernel against its plain version (1e-5 of max(1, max|ref|),
    f32 sums in another order), two launches equal bit for bit, and the
    kernel, plain version and library call by device time beside the
    bound."""
    args = large_probe_inputs(name, P, gen)
    fn = getattr(probes, name)

    def ref():
        return getattr(probes, name + "_ref")(*args)

    got = within_time_limit(lambda: fn(*args), f"{name} at P = {P}")
    want = ref()
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    repeats = torch.equal(got, fn(*args))
    finite = bool(torch.isfinite(got).all())
    del got, want
    bnd, by = probe_bound_ms(name, args)
    library = probe_library_call(name, args)
    large = {"P": P, "max_abs_err": err, "tolerance": 1e-5 * scale,
             "bit_repeat": repeats, "ms": cuda_ms(lambda: fn(*args), 20),
             "plain_ms": cuda_ms(ref, 5), "library_ms": cuda_ms(library, 20),
             "bound_ms": bnd, "bound_by": by,
             "device_us": kernel_device_us(lambda: fn(*args),
                                           f"{name}_kernel"),
             "plain_device_us": kernel_device_us(ref),
             "library_device_us": kernel_device_us(library)}
    log(f"{name} large P " + json.dumps(large))
    if err > 1e-5 * scale or not repeats or not finite:
        raise AssertionError(f"{name} disagrees at P = {P}: {large}")
    return large


def check_probe_kernels():
    """Phase 2e: the four probe kernels against their plain versions at
    the JAX probes' inputs and tolerances, every first launch under the
    host-side time limit; the block gather's copy rate at COPY_RATE_ROWS
    random rows of a 64 MB table, warm and cold; the sub-row sum at
    LARGE_SUM_P and the sub-row dot at LARGE_DOT_P; then the
    probe tool's own checks in-process, with the probes' launch counts set
    to 0 just before and read just after. Returns the probes' entries of
    the kernels line."""
    dev = torch.device("cuda")
    replaces = {
        "probe_row_copy": "lsnet_tpu/ops/pallas_dma_gather.py:220",
        "probe_block_gather": "tools/probe_dma2.py:33",
        "probe_subrow_sum": "tools/probe_dma2.py:69",
        "probe_subrow_dot": "tools/probe_dma2.py:98"}
    entries = {}
    for name in probes.PROBES:
        fn = getattr(probes, name)
        ref = getattr(probes, name + "_ref")
        args = [a.to(dev) for a in probes.probe_inputs(name)]
        got = within_time_limit(lambda: fn(*args), name)
        want = ref(*args)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        tol = probe_tool.TOLERANCES[name]
        ok = (torch.equal(got, want) if tol is None
              else torch.allclose(got, want, rtol=tol[0], atol=tol[1]))
        bnd, by = probe_bound_ms(name, args)
        entry = {"name": name, "route": "cuda",
                 "source": f"lsnet_torch/csrc/{name}.cu",
                 "replaces": replaces[name], "max_abs_err": err,
                 "ms": cuda_ms(lambda: fn(*args), 50),
                 "plain_ms": cuda_ms(lambda: ref(*args), 20),
                 "bound_ms": bnd, "bound_by": by,
                 "device_us": kernel_device_us(lambda: fn(*args),
                                               f"{name}_kernel")}
        # ms, plain_ms and library_ms are CUDA events around the calls: at
        # these sizes the wrappers' launch rate on the host. The *_device_us
        # keys compare kernel with kernel.
        entry["plain_device_us"] = kernel_device_us(lambda: ref(*args))
        try:
            library = probe_library_call(name, args)
            entry["library_ms"] = cuda_ms(library, 20)
            entry["library_device_us"] = kernel_device_us(library)
        except (TypeError, RuntimeError) as ex:
            # an older PyTorch without mm(out_dtype=): no yardstick
            log(f"probe {name}: no library call here ({ex})")
            entry["library_ms"] = entry["library_device_us"] = None
        log("probe " + json.dumps(dict(entry, tolerance=tol, ok=bool(ok))))
        if not ok or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"probe kernel disagrees: {entry}")
        entries[name] = entry

    gen = torch.Generator(device="cuda").manual_seed(4)
    args = copy_rate_inputs(gen)
    got = within_time_limit(lambda: probes.probe_block_gather(*args),
                            "probe_block_gather at many rows")
    if not torch.equal(got, probes.probe_block_gather_ref(*args)):
        raise AssertionError("probe_block_gather disagrees at "
                             f"{COPY_RATE_ROWS} rows")
    del got
    ms = cuda_ms(lambda: probes.probe_block_gather(*args), 20)
    bnd, by = probe_bound_ms("probe_block_gather", args)
    library = probe_library_call("probe_block_gather", args)
    rate = {"rows": COPY_RATE_ROWS, "ms": ms,
            "plain_ms": cuda_ms(
                lambda: probes.probe_block_gather_ref(*args), 5),
            "bound_ms": bnd, "bound_by": by,
            "device_us": kernel_device_us(
                lambda: probes.probe_block_gather(*args),
                "probe_block_gather_kernel")}
    # the library call warm in its own right: not on the table lines the
    # kernel's evict_last loads leave behind
    reset_persisting_l2()
    rate["library_ms"] = cuda_ms(library, 10)
    rate["library_device_us"] = kernel_device_us(library)
    rate.update({
        "cold_device_us": cold_device_us(
            lambda: probes.probe_block_gather(*args),
            "probe_block_gather_kernel"),
        "library_cold_device_us": cold_device_us(library),
        "gathered_gbytes_s": COPY_RATE_ROWS * 2048 / ms / 1e6})
    log("probe_block_gather copy rate " + json.dumps(rate))
    entries["probe_block_gather"]["copy_rate"] = rate
    del args
    entries["probe_subrow_dot"]["large_p"] = check_large(
        "probe_subrow_dot", LARGE_DOT_P, gen)
    entries["probe_subrow_sum"]["large_p"] = check_large(
        "probe_subrow_sum", LARGE_SUM_P, gen)

    # the entry point: lsnet_torch.tools.probe's checks, in-process
    for name in probes.PROBES:
        getattr(probes, name).launches = 0
    deform_gather_contract.launches = 0
    if not within_time_limit(
            lambda: probe_tool.run_checks(dev, lambda m: log("tool " + m)),
            "lsnet_torch.tools.probe"):
        raise AssertionError("lsnet_torch.tools.probe reports a failure")
    for name in probes.PROBES:
        entries[name]["launches"] = getattr(probes, name).launches
        if entries[name]["launches"] < 1:
            raise AssertionError(f"the probe tool never launched {name}")
    if deform_gather_contract.launches != 1:
        raise AssertionError("the probe tool's full-kernel check launched "
                             f"{deform_gather_contract.launches} times")
    reset_persisting_l2()           # no table lines kept for later phases
    return entries


def unit_bn_scales_(model):
    """FrozenBatchNorm scales to 1: at random 0.03 * N(0, 1) scales every
    residual branch, the backbone DCN included, is ~1e-5 of its shortcut
    and a comparison would not see it."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                m.weight.fill_(1.0)
    return model


def narrow_task_cfg(task):
    """A narrow X-101-shaped model of ``task``: ResNeXt-50, G=8, feat 64,
    two stacked DCN blocks, the task's own landmark count."""
    cfg = {"bbox": x101_flagship_cfg, "segm": configs.x101_segm_cfg,
           "pose_bbox": configs.x101_pose_bbox_cfg,
           "pose_kbox": configs.x101_pose_kbox_cfg}[task](feat=64, stacked=2)
    cfg["backbone"].update(depth=50, groups=8)
    return cfg


def check_small_against_cpu():
    """Phase 3: narrow models on the card vs the same models on the CPU
    (where the plain versions run), f32, TF32 off, bilinear sampling (the
    nearest rounding would amplify the card's ~1e-6 differences): an
    R50-shaped bbox model and a ResNeXt-shaped model of each task."""
    cases = [("R50-shaped", flagship_r50_cfg(feat=64, stacked=2))]
    for task in NUM_VECTORS:
        cases.append((f"ResNeXt-shaped {task}", narrow_task_cfg(task)))
    for label, cfg in cases:
        outputs_card_vs_cpu(label, cfg)


def set_classes(cfg, n):
    """``n`` classes for a head that has classes (GA-RPN has none)."""
    head = head_cfg_of(cfg)
    if cfg["type"] != "RPN":
        head["num_classes"] = n
    return head.get("num_classes", 1)


def outputs_card_vs_cpu(label, cfg, sampling=fd.TRAIN_SAMPLING,
                        hw=(96, 128), dtype=torch.float32, batch=2):
    """Phase 3a for one model: the head outputs of ``cfg`` (8 classes)
    on the card against the CPU, 1e-3 of max(1, max|ref|), on ``batch``
    images at ``hw`` in ``dtype``."""
    set_classes(cfg, 8)
    cpu = unit_bn_scales_(init_model(cfg, device="cpu", seed=1,
                                     dtype=dtype))
    gpu = unit_bn_scales_(init_model(cfg, device="cuda", seed=1,
                                     dtype=dtype))
    images = torch.randn(batch, *hw, 3, dtype=dtype,
                         generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = cpu(images, sampling)
        got = gpu(images.cuda(), sampling)
    worst = 0.0
    for key in want:
        for g, w_ in zip(got[key], want[key]):
            err = (g.float().cpu() - w_).abs().max().item()
            worst = max(worst, err / max(1.0, w_.abs().max().item()))
    log(f"small {label} model, card vs CPU: {sorted(want)} max rel err "
        f"{worst:.3g}")
    if worst > 1e-3:
        raise AssertionError(f"{label}: card disagrees with CPU: {worst}")


def drive_main_path(label, cfg, grouped_per_forward, task="bbox", k1=None,
                    config=None, batch=B, hw=(H, W)):
    """Phase 4: a full-width model end to end, B=2 at 800x1344 (or
    ``batch`` images at ``hw``), bf16, with the task's own test settings
    (those of the ``config`` file where given) and the head's decode
    (``train.loop.decode_for``); ``k1`` K1 launches a forward
    (K1_PER_FORWARD[task] unless given)."""
    B, (H, W) = batch, hw
    k1 = K1_PER_FORWARD[task] if k1 is None else k1
    t0 = time.perf_counter()
    model = init_model(cfg, device="cuda", seed=0, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(B, H, W, 3, generator=gen).to(
        "cuda", torch.bfloat16)
    img_shapes = torch.tensor([[H, W]] * B, device="cuda")
    sfs = torch.ones(B, 4, device="cuda")
    tcfg = (runner_loop.test_cfg_from(config, (H, W)) if config else
            TestConfig(image_shape=(H, W), **configs.TEST_SETTINGS[task]))
    log(f"{label} model built in {time.perf_counter() - t0:.1f}s")

    def run():
        return detect(model, images, img_shapes, sfs, tcfg, config=config)

    for _ in range(2):                      # warm-up
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        det = run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    img_s = B * ITERS / dt
    n_valid = det.valid.sum(dim=1).tolist()
    log(f"{label} e2e: {img_s:.3f} img/s ({dt / ITERS * 1e3:.2f} ms per "
        f"batch of {B}), peak memory {peak / 2 ** 30:.2f} GiB, launches "
        f"{launches} over {ITERS} runs, valid {n_valid}")
    want = dict.fromkeys(launches, 0)
    want.update({
        "deform_gather_contract": k1 * ITERS,
        "deform_gather_grouped_contract": grouped_per_forward * ITERS})
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    for name, x in det._asdict().items():
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {name}")
    shapes = (tuple(det.bboxes.shape), tuple(det.landmarks.shape))
    if shapes != ((B, tcfg.max_per_img, 4),
                  (B, tcfg.max_per_img, 2 * tcfg.num_vectors)) \
            or min(n_valid) < 1:
        raise AssertionError(f"{label}: bad detections: {shapes}, valid "
                             f"{n_valid}")
    # host-clock split of one batch: forward alone, decode + NMS alone
    with torch.inference_mode():
        t0 = time.perf_counter()
        for _ in range(ITERS):
            outs = model(images, fd.INFERENCE_SAMPLING)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) / ITERS * 1e3
        decode = runner_loop.decode_for(model, config)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            decode(outs, img_shapes, sfs, tcfg)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) / ITERS * 1e3
    log(f"{label} split per batch: forward {fwd_ms:.2f} ms, decode+NMS "
        f"{dec_ms:.2f} ms")
    return run, img_s, launches, peak


def synthetic_batch(batch, hw, num_gt, num_classes, seed, device):
    """A seeded training batch: random images, ``num_gt`` boxes per image
    with corners uniform in [0, min(hw)/2) and at least 8 px a side (the
    recipe of tools/bench_train.py); for the segm task a 36-point contour
    on an ellipse inside each box, for the pose tasks 17 keypoints inside
    each box with visibility 0 / 1 / 2 (invisible ones at (0, 0))."""
    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    bb = torch.rand(batch, num_gt, 4, generator=gen) * (min(h, w) / 2)
    bb = torch.cat([torch.minimum(bb[..., :2], bb[..., 2:]),
                    torch.maximum(bb[..., :2], bb[..., 2:]) + 8], dim=-1)
    out = {
        "image": torch.randn(batch, h, w, 3, generator=gen),
        "pad_shape": torch.tensor([[h, w]] * batch, dtype=torch.int32),
        "img_shape": torch.tensor([[h, w]] * batch, dtype=torch.int32),
        "gt_bboxes": bb,
        "gt_labels": torch.randint(0, num_classes, (batch, num_gt),
                                   generator=gen),
        "gt_valid": torch.ones(batch, num_gt, dtype=torch.bool),
    }
    lo, wh = bb[..., None, :2], (bb[..., 2:] - bb[..., :2])[..., None, :]
    ang = torch.arange(36) * (2 * torch.pi / 36)
    radius = wh / 2 * (0.6 + 0.4 * torch.rand(batch, num_gt, 1, 1,
                                              generator=gen))
    out["gt_polygons"] = (lo + wh / 2 + radius * torch.stack(
        [ang.cos(), ang.sin()], dim=-1)).flatten(-2)
    vs = torch.randint(0, 3, (batch, num_gt, 17, 1), generator=gen).float()
    vs[..., 0, :] = 2.0               # every instance has a visible keypoint
    kxy = (lo + torch.rand(batch, num_gt, 17, 2, generator=gen) * wh) \
        * (vs > 0)
    out["gt_keypoints_vs"] = torch.cat([kxy, vs], dim=-1).flatten(-2)
    return {k: v.to(device) for k, v in out.items()}


def loss_config(task, hw, num_classes):
    return LossConfig(image_shape=hw, num_classes=num_classes, task=task,
                      num_vectors=NUM_VECTORS[task],
                      **configs.LOSS_WEIGHTS[task])


def check_small_gradients(task):
    """Phase 3b: the training loss and every parameter's gradient of a
    narrow ResNeXt-shaped model of ``task`` on the card (the kernels, forward and
    backward) against the same model on the CPU (the plain versions), f32,
    TF32 off. Tolerance 2e-3 of each gradient's largest entry (floored at
    1e-3 of the largest gradient of all): the convolutions and the
    kernels' atomics sum in another order than the CPU."""
    hw = (96, 128)
    gradients_card_vs_cpu(f"ResNeXt-shaped {task}", narrow_task_cfg(task),
                          loss_config(task, hw, 8), hw)


def gradients_card_vs_cpu(label, cfg, lcfg, hw, sampling=fd.TRAIN_SAMPLING,
                          dtype=torch.float32, batch=2):
    """Phase 3b for one model: the loss (``runner_step.LOSSES`` of the
    config's type), each of its terms and every parameter's gradient of
    ``cfg`` (8 classes) on the card against the CPU, ``batch`` images,
    the model in ``dtype`` (f32 unless given)."""
    set_classes(cfg, 8)
    loss_fn = runner_step.LOSSES[type(lcfg)]
    grads = {}
    for device in ("cpu", "cuda"):
        model = unit_bn_scales_(init_model(cfg, device=device, seed=1,
                                           train=True, dtype=dtype))
        data = synthetic_batch(batch, hw, 4, 8, 1, device)
        outs = model(data["image"].to(dtype), sampling)
        total, terms = loss_fn(outs, data, lcfg)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        got = torch.autograd.grad(
            total, [p for p in model.parameters() if p.requires_grad])
        grads[device] = (total.item(),
                         {n: g.cpu() for n, g in zip(names, got)},
                         {k: v.item() for k, v in terms.items()})
    (loss_c, g_c, t_c), (loss_g, g_g, t_g) = grads["cpu"], grads["cuda"]
    top = max(g.abs().max().item() for g in g_c.values())
    worst, worst_name = 0.0, ""
    for n, ref in g_c.items():
        rel = ((g_g[n] - ref).abs().max().item()
               / max(ref.abs().max().item(), 1e-3 * top))
        if rel > worst:
            worst, worst_name = rel, n
    log(f"small {label} model gradients, card vs CPU: loss "
        f"{loss_g:.6f} vs {loss_c:.6f}, terms {json.dumps(t_g)} vs "
        f"{json.dumps(t_c)}, {len(g_c)} gradients, max rel err "
        f"{worst:.3g} ({worst_name})")
    if abs(loss_g - loss_c) > 1e-4 * abs(loss_c) or worst > 2e-3 or \
            t_g.keys() != t_c.keys() or any(
                abs(t_g[k] - v) > 1e-4 * max(abs(v), 1e-3 * abs(loss_c))
                for k, v in t_c.items()):
        raise AssertionError(f"{label}: card loss or gradients disagree "
                             "with the CPU")


def launch_counts():
    return {
        "deform_gather_contract": deform_gather_contract.launches,
        "deform_gather_contract_bwd_data":
            dg.deform_gather_contract_bwd_data.launches,
        "deform_gather_contract_bwd_weight":
            dg.deform_gather_contract_bwd_weight.launches,
        "deform_gather_grouped_contract":
            deform_gather_grouped_contract.launches,
        "deform_gather_grouped_contract_bwd_data":
            gr.deform_gather_grouped_contract_bwd_data.launches,
        "deform_gather_grouped_contract_bwd_weight":
            gr.deform_gather_grouped_contract_bwd_weight.launches,
    }


def zero_launch_counts():
    for fn in (deform_gather_contract, dg.deform_gather_contract_bwd_data,
               dg.deform_gather_contract_bwd_weight,
               deform_gather_grouped_contract,
               gr.deform_gather_grouped_contract_bwd_data,
               gr.deform_gather_grouped_contract_bwd_weight):
        fn.launches = 0


def drive_train_path(task, cfg, lcfg=None, k1=None, steps=None,
                     label=None, grouped=GROUPED_PER_FORWARD, batch=B,
                     hw=(H, W), **optim_kwargs):
    """Phase 4b: train steps of the full-width X-101-64x4d-DCN in
    ``task`` (or of the model ``cfg`` names: ``label``, ``grouped``
    grouped launches a forward), B=2 at 800x1344 (or ``batch`` images at
    ``hw``), bf16 compute over f32 master weights; the loss config
    ``lcfg`` (the task's unless given), ``k1`` K1 launches a forward
    (K1_PER_FORWARD[task] unless given), ``steps`` counted steps
    (TRAIN_STEPS unless given), ``optim_kwargs`` to the optimizer."""
    B, (H, W) = batch, hw
    label = label or f"X-101 {task} train"
    num_classes = head_cfg_of(cfg).get("num_classes", 1)
    k1 = K1_PER_FORWARD[task] if k1 is None else k1
    steps = steps or TRAIN_STEPS
    t0 = time.perf_counter()
    model = init_model(cfg, device="cuda", seed=0, train=True)
    step = train_detector_step(
        model, lcfg or loss_config(task, (H, W), num_classes), base_lr=0.01,
        **optim_kwargs)
    batch = synthetic_batch(B, (H, W), NUM_GT, num_classes, 0, "cuda")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    log(f"{label}er built in {time.perf_counter() - t0:.1f}s")
    for _ in range(TRAIN_WARMUP):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    history = [step(batch) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    history = [{k: v.item() for k, v in m.items()} for m in history]
    img_s = B * steps / dt
    log(f"{label}: {img_s:.3f} img/s ({dt / steps * 1e3:.2f} ms "
        f"per step of {B}), peak memory {peak / 2 ** 30:.2f} GiB, "
        f"launches {launches} over {steps} steps")
    for m in history:
        log("  step " + json.dumps(m))
    want = {
        "deform_gather_contract": k1,
        "deform_gather_contract_bwd_data": k1,
        "deform_gather_contract_bwd_weight": k1,
        "deform_gather_grouped_contract": grouped,
        "deform_gather_grouped_contract_bwd_data": grouped,
        "deform_gather_grouped_contract_bwd_weight": grouped}
    want = {k: v * steps for k, v in want.items()}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    for m in history:
        for key, x in m.items():
            if not x == x or abs(x) == float("inf"):
                raise AssertionError(f"{label}: non-finite {key}: {m}")
    moved = frozen_moved = 0
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if p.requires_grad and same:
            raise AssertionError(f"{label}: trainable {n} did not move")
        if not p.requires_grad and not same:
            frozen_moved += 1
        moved += p.requires_grad
    if frozen_moved or moved == 0:
        raise AssertionError(f"{label}: {frozen_moved} frozen parameters "
                             f"moved, {moved} trainable ones")
    log(f"{label}: {moved} trainable parameters moved, "
        f"{len(before) - moved} frozen ones unchanged")
    return (lambda: step(batch)), img_s, launches, peak


def profile(label, run, batch_ms):
    """Phase 5: device time by kernel over one call of ``run`` (a forward
    + decode, or a train step), and the device's idle share of the
    measured batch time. The profile records the device's activity only
    (the host's operator events of an X-101 train step, some 10^5, took
    the profiler 11-20 s to sum), in a second step after a warm-up step
    of the same call, as ``kernel_device_us`` does; a profile without
    device records is taken again (PROFILE_TRIES times)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule
    on_device = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        with tprofile(activities=[ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1,
                                        repeat=1)) as prof:
            for _ in range(2):              # warm-up step, recorded step
                run()
                torch.cuda.synchronize()
                prof.step()
        events = prof.key_averages()
        # kernel events only: a device-side copy of a user annotation (the
        # optimizer's step, a profiler step) repeats its kernels' time
        kernels = [e for e in events
                   if dev_us(e) > 0 and e.device_type == on_device
                   and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
        if kernels:
            break
        LOST_PROFILES.append([f"{e.key} x{e.count}" for e in events])
        log(f"profile {label}: no device records; records "
            f"{LOST_PROFILES[-1]}")
    else:
        raise AssertionError(f"profile {label}: {PROFILE_TRIES} profiles "
                             "in a row without device records")
    total = sum(dev_us(e) for e in kernels)
    dgc = sum(dev_us(e) for e in kernels if "dgc_" in e.key)
    gdc = sum(dev_us(e) for e in kernels if "gdc_" in e.key)
    bwd = {}
    for e in kernels:
        for name in ("bwd_data_kernel", "bwd_weight_kernel", "gdw_bf16"):
            if name in e.key:
                # gdw_bf16: the bf16 grouped bwd-weight kernel
                grouped = (name == "gdw_bf16" or "true>" in e.key
                           or "(bool)1>" in e.key)
                key = (("grouped " if grouped else "")
                       + name.replace("gdw_bf16", "bwd_weight_kernel"))
                bwd[key] = bwd.get(key, 0.0) + dev_us(e)
    log(f"{label} profile: device kernel time {total / 1e3:.3f} ms per "
        f"batch, deform_gather_contract {dgc / 1e3:.3f} ms, "
        f"deform_gather_grouped_contract {gdc / 1e3:.3f} ms; device idle "
        f"{1.0 - total / 1e3 / batch_ms:.3f} of the {batch_ms:.2f} ms batch")
    if bwd:
        log(f"{label} profile, backward kernels: " + ", ".join(
            f"{k} {v / 1e3:.3f} ms" for k, v in sorted(bwd.items()))
            + f"; {sum(bwd.values()) / total:.3f} of the device time")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return {"device_ms": total / 1e3, "dgc_ms": dgc / 1e3,
            "idle_share": 1.0 - total / 1e3 / batch_ms}


@runner_hooks.HOOKS.register_module()
class LaunchCountHook(runner_hooks.Hook):
    """Phase 6: the kernels' launch counts, read after each train step and
    after each epoch's evaluation (it runs after ``EvalHook``), each read
    setting them to 0; set to 0 before the run, when the backbone the run
    starts from is copied too."""
    priority = 95
    steps, evals = [], []
    start_backbone = {}

    def before_train(self, ctx):
        LaunchCountHook.start_backbone = {
            k: v.detach().cpu().clone()
            for k, v in ctx.model.backbone.state_dict().items()}
        zero_launch_counts()

    def after_iter(self, ctx):
        LaunchCountHook.steps.append(launch_counts())
        zero_launch_counts()

    def after_epoch(self, ctx):
        LaunchCountHook.evals.append(launch_counts())
        zero_launch_counts()


def f32_train_step(*args, **kwargs):
    """The runner's ``make_train_step`` with ``mixed_precision=False``."""
    return runner_step.make_train_step(*args, **{**kwargs,
                                                 "mixed_precision": False})


def narrow_runner_cfg(root):
    """Phase 6a: the phase-3 ResNeXt-shaped bbox model (3 classes) in the
    shipped R50 file's recipe, on 4 procedural images at 128x160."""
    ann, img = make_shapes_coco(root, 4, seed=0, hw=(128, 160))
    cfg = Config.fromfile(os.path.join(
        REPO, "configs", "lsnet", "lsnet_bbox_r50_fpn_1x_coco.py")).to_dict()
    cfg["model"] = narrow_task_cfg("bbox")
    cfg["model"]["bbox_head"]["num_classes"] = 3
    data = dict(ann_file=ann, img_prefix=img, img_scale=(160, 128))
    cfg.update(data=dict(samples_per_gpu=2, train=data, val=data),
               canvas_shape=(128, 160), log_interval=1,
               lr_config=dict(warmup_iters=2, step=[8]),
               test_cfg=dict(cfg["test_cfg"], score_thr=0.008))
    return Config(cfg)


def log_records(work_dir, mode):
    import glob
    (path,) = glob.glob(os.path.join(work_dir, "*.log.json"))
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["mode"] == mode]


def narrow_runner(device, root):
    """``train_detector`` for 2 iterations (one epoch of 2 steps), f32,
    then ``evaluate_detector``: the log's losses and the metrics."""
    cfg = narrow_runner_cfg(os.path.join(root, "data"))
    work = os.path.join(root, f"work_{device}")
    saved = runner_loop.make_train_step
    runner_loop.make_train_step = f32_train_step
    try:
        res = runner_loop.train_detector(cfg, work, total_epochs=1,
                                         eval_interval=100, device=device)
    finally:
        runner_loop.make_train_step = saved
    metrics = runner_loop.evaluate_detector(
        cfg, res["model"], (128, 160), sampling=runner_loop.eval_sampling())
    return [r["loss"] for r in log_records(work, "train")], metrics


def check_narrow_runner(root):
    """Phase 6a: the narrow runner on the card against the CPU: each
    iteration's loss to 1e-3 relative, the metrics to 0.01 absolute."""
    (loss_c, met_c), (loss_g, met_g) = (narrow_runner(d, root)
                                        for d in ("cpu", "cuda"))
    log(f"runner narrow, card vs CPU: losses {loss_g} vs {loss_c}; "
        f"metrics {json.dumps(met_g)} vs {json.dumps(met_c)}")
    if len(loss_g) != 2 or len(loss_c) != 2 or any(
            abs(g - c) > 1e-3 * abs(c) for g, c in zip(loss_g, loss_c)):
        raise AssertionError("runner narrow: card losses disagree")
    if met_g.keys() != met_c.keys() or any(
            abs(met_g[k] - met_c[k]) > 0.01 for k in met_c):
        raise AssertionError("runner narrow: card metrics disagree")


def reference_backbone_state(backbone):
    """Phase 6b: a port backbone's state dict in the reference's (mmdet)
    key names: ``backbone.layerS.B.*``, ``downsample.{0,1}``,
    ``running_mean`` / ``running_var``, a DCN weight as (cout, cin/G, kh,
    kw). chip_smoke's own writer, apart from the loader it checks."""
    dcn = {n for n, m in backbone.named_modules()
           if isinstance(m, ModulatedDeformConvPack)}
    out = {}
    for key, t in backbone.state_dict().items():
        mod, leaf = key.rsplit(".", 1)
        if mod in dcn and leaf == "weight":
            t = t.permute(3, 2, 0, 1)
        leaf = {"mean": "running_mean", "var": "running_var"}.get(leaf, leaf)
        mod = re.sub(r"^layer(\d+)_(\d+)", r"layer\1.\2", mod)
        mod = mod.replace("downsample_conv", "downsample.0").replace(
            "downsample_bn", "downsample.1")
        out[f"backbone.{mod}.{leaf}"] = t.contiguous().clone()
    return out


def pretrained_backbone_file(path):
    """Phase 6b: the runner file's X-101-64x4d-DCN backbone at full width,
    drawn by the training init from ``PRETRAINED_SEED``, with seeded
    FrozenBatchNorm statistics and DCN offset convs (which the init
    leaves at 0), saved as a reference checkpoint ``{"state_dict": ...}``.
    Returns its state dict in the port's names."""
    backbone = build_backbone(Config.fromfile(RUNNER_CONFIG)
                              .model.backbone.to_dict())
    gen = torch.Generator().manual_seed(PRETRAINED_SEED)
    init_weights_(backbone, gen)
    with torch.no_grad():
        for name, m in backbone.named_modules():
            if isinstance(m, FrozenBatchNorm):
                m.mean.copy_(0.01 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(1.0 + 0.05 * torch.randn(
                    m.var.shape, generator=gen).abs())
            elif name.endswith("conv_offset"):
                m.weight.copy_(1e-3 * torch.randn(m.weight.shape,
                                                  generator=gen))
    torch.save({"state_dict": reference_backbone_state(backbone)}, path)
    return {k: v.clone() for k, v in backbone.state_dict().items()}


def runner_options(train_root, val_root, train_ann, val_ann):
    """(--options of tools.test, and the more of tools.train): the
    procedural sets, 3 classes, a score threshold under the focal prior
    (0.01, where a model 8 steps from its init still scores), and for
    training 2 images a step, a log record and an eval every epoch, and
    the launch-count hook."""
    test = [f"data.val.ann_file={val_ann}",
            f"data.val.img_prefix={os.path.join(val_root, 'imgs')}",
            "model.bbox_head.num_classes=3", "test_cfg.score_thr=0.005"]
    return test, test + [
        f"data.train.ann_file={train_ann}",
        f"data.train.img_prefix={os.path.join(train_root, 'imgs')}",
        "data.samples_per_gpu=2", "log_interval=1", "evaluation.interval=1",
        "custom_hooks=[{'type': 'LaunchCountHook'}]"]


def check_runner(root):
    """Phase 6b: the shipped X-101-64x4d-DCN bbox config at full width
    through ``lsnet_torch.tools.train`` (run A: 2 epochs of 4 steps; run B:
    resumed from A's step_4.pt) and ``lsnet_torch.tools.test`` on A's
    step_8.pt. Returns the numbers of the printed line and the launch
    counts per train step and per eval batch."""
    train_root, val_root = (os.path.join(root, n) for n in ("train", "val"))
    train_ann, _ = make_shapes_coco(train_root, len(RUNNER_TRAIN_HW), seed=1,
                                    hw=RUNNER_TRAIN_HW)
    val_ann, _ = make_shapes_coco(val_root, len(RUNNER_VAL_HW), seed=2,
                                  hw=RUNNER_VAL_HW)
    test_opts, opts = runner_options(train_root, val_root, train_ann,
                                     val_ann)
    # run A starts from a reference-keyed backbone file (model.pretrained)
    pretrained = os.path.join(root, "x101_dcn_backbone.pth")
    t0 = time.perf_counter()
    want = pretrained_backbone_file(pretrained)
    write_s = time.perf_counter() - t0
    work_a, work_b = (os.path.join(root, n) for n in ("A", "B"))
    torch.cuda.reset_peak_memory_stats()
    LaunchCountHook.steps.clear()
    LaunchCountHook.evals.clear()
    res = train_tool.main([RUNNER_CONFIG, "--work-dir", work_a,
                           "--total-epochs", str(RUNNER_EPOCHS),
                           "--options", *opts,
                           f"model.pretrained={pretrained}"])
    steps, evals = list(LaunchCountHook.steps), list(LaunchCountHook.evals)
    got = LaunchCountHook.start_backbone
    n_dcn = sum(k.endswith("conv_offset.weight") for k in want)
    if got.keys() != want.keys() or any(
            not torch.equal(got[k], v) for k, v in want.items()):
        raise AssertionError("runner A: the backbone it started from is "
                             "not the model.pretrained file")
    log(f"runner A started from model.pretrained: {len(want)} tensors "
        f"({n_dcn} DCN packs, G = {GROUPS}), "
        f"{os.path.getsize(pretrained)} bytes written in {write_s:.1f}s, "
        "equal tensor for tensor")
    del want, got
    LaunchCountHook.start_backbone = {}
    train = log_records(work_a, "train")
    val = log_records(work_a, "val")
    cfg = Config.fromfile(RUNNER_CONFIG)
    schedule = build_lr_schedule(dict(cfg.lr_config), cfg.optimizer.lr,
                                 RUNNER_STEPS, RUNNER_EPOCHS)
    for r in train:
        step = (r["epoch"] - 1) * RUNNER_STEPS + r["iter"]
        log("runner A " + json.dumps(r))
        if not all(math.isfinite(r[k]) for k in ("loss", "grad_norm")) or \
                r["lr"] != round(schedule(step), 6):
            raise AssertionError(f"runner A: bad record at step {step}: {r}")
    if len(train) != RUNNER_EPOCHS * RUNNER_STEPS or len(val) != 2 \
            or res["step"] != RUNNER_EPOCHS * RUNNER_STEPS:
        raise AssertionError(f"runner A: {len(train)} train and {len(val)} "
                             f"val records, step {res['step']}")
    log(f"runner launches per train step {json.dumps(steps[0])}, per "
        f"eval {json.dumps(evals[0])}")
    if len(steps) != len(train) or any(s != steps[0] for s in steps) or \
            min(steps[0].values()) < 1:
        raise AssertionError(f"runner A: launches per step {steps}")
    fwd = ("deform_gather_contract", "deform_gather_grouped_contract")
    if len(evals) != RUNNER_EPOCHS or any(
            e[k] < 1 for e in evals for k in fwd) or any(
            e[k] for e in evals for k in e if k not in fwd):
        raise AssertionError(f"runner A: launches per eval {evals}")

    # the saved state, bit for bit, and its meta
    path_a = os.path.join(work_a, "ckpts", f"step_{res['step']}.pt")
    raw = ckpt.load_checkpoint(path_a)
    model, opt = res["model"], res["optimizer"]
    sd, osd = model.state_dict(), opt.state_dict()
    if raw["step"] != res["step"] or raw["model"].keys() != sd.keys() or \
            any(not torch.equal(raw["model"][k], v.cpu())
                for k, v in sd.items()) or \
            raw["optimizer"]["count"] != osd["count"] or any(
                not torch.equal(a, b.cpu()) for a, b in
                zip(raw["optimizer"]["momentum"], osd["momentum"])):
        raise AssertionError("runner A: step_8.pt differs from the state")
    if raw["meta"] != {"dcn_sampling_train": "bilinear"} or \
            dict(ckpt.deploy_sampling(raw["meta"])) != \
            dict(fd.INFERENCE_SAMPLING):
        raise AssertionError(f"runner A: meta {raw['meta']}")
    t0 = time.perf_counter()
    path = ckpt.save_checkpoint(os.path.join(root, "timed"), model, opt,
                                res["step"], raw["meta"])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(path, model, opt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(path_a)
    del model, opt, res, sd, osd
    torch.cuda.empty_cache()

    # tools.test on A's step_8.pt, its evaluation timed
    timed = []
    evaluate = runner_loop.evaluate_detector

    def timed_evaluate(*a, **k):
        t0 = time.perf_counter()
        out = evaluate(*a, **k)
        timed.append(time.perf_counter() - t0)
        return out
    runner_loop.evaluate_detector = timed_evaluate
    try:
        metrics = test_tool.main([RUNNER_CONFIG, path_a, "--eval", "bbox",
                                  "--options", *test_opts])
    finally:
        runner_loop.evaluate_detector = evaluate
    hook_metrics = {k: v for k, v in val[-1].items()
                    if k not in ("mode", "epoch")}
    log(f"runner tools.test metrics {json.dumps(metrics)}; EvalHook epoch "
        f"2 {json.dumps(hook_metrics)}")
    if metrics.keys() != hook_metrics.keys() or len(metrics) != 12 or any(
            not -1.0 <= v <= 1.0 or abs(v - hook_metrics[k]) > 1e-4
            for k, v in metrics.items()):
        raise AssertionError("runner: tools.test metrics disagree with "
                             "the EvalHook's")

    # run B, resumed from A's step_4.pt
    path_4 = os.path.join(work_a, "ckpts", f"step_{RUNNER_STEPS}.pt")
    res_b = train_tool.main([RUNNER_CONFIG, "--work-dir", work_b,
                             "--total-epochs", str(RUNNER_EPOCHS),
                             "--resume-from", path_4, "--options", *opts])
    train_b = log_records(work_b, "train")
    first = (train_b[0]["epoch"] - 1) * RUNNER_STEPS + train_b[0]["iter"]
    if first != RUNNER_STEPS + 1 or len(train_b) != RUNNER_STEPS or any(
            not math.isfinite(r["loss"]) for r in train_b) or \
            not os.path.exists(os.path.join(
                work_b, "ckpts", f"step_{res_b['step']}.pt")) or \
            res_b["step"] != RUNNER_EPOCHS * RUNNER_STEPS:
        raise AssertionError(f"runner B: first step {first}, records "
                             f"{train_b}")
    log(f"runner B resumed at step {first}: losses "
        f"{[r['loss'] for r in train_b]}")
    del res_b
    n_val = len(RUNNER_VAL_HW)
    numbers = {
        "train_s_per_iter": sorted(r["time"] for r in train)[len(train) // 2],
        "eval_img_per_s": n_val / timed[0],
        "checkpoint_bytes": ckpt_bytes, "checkpoint_save_s": save_s,
        "checkpoint_restore_s": restore_s, "metrics": metrics,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    eval_batches = 2                 # 3 landscape images, 1 portrait
    return numbers, steps[0], {k: v // eval_batches
                               for k, v in evals[0].items()}


def capture_k1_calls(limit):
    """Phase 7: put in place of ``deform_gather``'s ops functions that keep
    a clone of the arguments of the first ``limit`` calls of each K1
    wrapper (forward, bwd-data, bwd-weight; ``limit`` may be a dict of
    each wrapper's) and then call it. Returns the calls by wrapper and a
    function that puts the wrappers back."""
    calls = {name: [] for name in dg.ContractOps._fields}
    limits = (limit if isinstance(limit, dict)
              else dict.fromkeys(calls, limit))
    saved = dg._OPS

    def keep(name, fn):
        def call(*args):
            if len(calls[name]) < limits[name]:
                calls[name].append(tuple(
                    a.detach().clone() if torch.is_tensor(a) else a
                    for a in args))
            return fn(*args)
        return call

    dg._OPS = dg.ContractOps(*(keep(name, fn) for name, fn in
                               zip(dg.ContractOps._fields, saved)))

    def undo():
        dg._OPS = saved
    return calls, undo


K1_CALLS = {       # wrapper -> (its kernel, its plain version) on the args
    "forward": (lambda a: (dg._forward(*a),),
                lambda a: (deform_gather_contract_ref(*a),)),
    "bwd_data": (lambda a: dg.deform_gather_contract_bwd_data(*a),
                 lambda a: dg.deform_gather_contract_bwd_data_ref(*a)),
    "bwd_weight": (lambda a: (dg.deform_gather_contract_bwd_weight(*a),),
                   lambda a: (dg.deform_gather_contract_bwd_weight_ref(
                       *a[:3], a[4]),))}


def check_k1_calls(label, calls):
    """Phase 7: each captured K1 call's kernel against its plain version
    on the same card tensors, at phase 2's tolerance (TOL of the call's
    dtype x max(1, max|ref|) for every output). Returns the log rows."""
    rows = {}
    for name, args_list in calls.items():
        if not args_list:
            continue
        kernel, plain = K1_CALLS[name]
        worst, ratio, shapes, ok = 0.0, 0.0, set(), True
        for args in args_list:
            flat, idx, weight = args[0], args[1], args[3]
            shapes.add((flat.shape[1], weight.shape[2], idx.shape[2]))
            for got, want in zip(kernel(args), plain(args)):
                if got is None:
                    continue
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                lim = TOL[flat.dtype] * max(
                    1.0, want.float().abs().max().item())
                ok = ok and bool(torch.isfinite(got).all()) and err <= lim
                worst, ratio = max(worst, err), max(ratio, err / lim)
        rows[name] = dict(calls=len(args_list),
                          dtype=str(args_list[0][0].dtype).split(".")[-1],
                          max_abs_err=worst, max_err_over_limit=ratio,
                          c_cout_px=sorted(shapes))
        log(f"{label} K1 {name} " + json.dumps(rows[name]))
        if not ok:
            raise AssertionError(f"{label}: K1 {name} disagrees: "
                                 f"{rows[name]}")
    return rows


def check_accuracy_run(root):
    """Phase 7: ``lsnet_torch.tools.accuracy_run`` --task bbox --dcn for
    ``ACC_EPOCHS`` epochs on ``ACC_TRAIN`` images, then --eval-only at
    ``backbone=nearest`` on its last checkpoint: finite, falling losses,
    COCO metric keys, the K1 launches of every step (``LaunchCountHook``)
    and of the eval-only run; the K1 calls of the first train step (bf16)
    and of the first eval batch (f32) held against their plain versions.
    Returns the launches per train step and per eval batch, and the
    phase's numbers."""
    flags = ["--task", "bbox", "--dcn", "--train", str(ACC_TRAIN),
             "--val", str(ACC_VAL), "--batch", str(ACC_BATCH)]
    out = os.path.join(root, "bbox")
    steps = ACC_EPOCHS * -(-ACC_TRAIN // ACC_BATCH)
    eval_batches = -(-ACC_VAL // ACC_BATCH)          # all landscape
    none = {k: 0 for k in launch_counts()}
    per_step = {**none, "deform_gather_contract": ACC_K1_PER_STEP,
                "deform_gather_contract_bwd_data": ACC_K1_PER_STEP,
                "deform_gather_contract_bwd_weight": ACC_K1_PER_STEP}
    per_eval = {**none, "deform_gather_contract":
                ACC_K1_PER_STEP * eval_batches}

    real_train = runner_loop.train_detector

    def train_counted(cfg, *args, **kwargs):
        cfg.custom_hooks = [dict(type="LaunchCountHook")]
        return real_train(cfg, *args, **kwargs)

    LaunchCountHook.steps.clear()
    LaunchCountHook.evals.clear()
    runner_loop.train_detector = train_counted
    calls, undo = capture_k1_calls(ACC_K1_PER_STEP)
    try:
        t0 = time.perf_counter()
        res = accuracy_tool.main(flags + ["--epochs", str(ACC_EPOCHS),
                                          "--out", out])
        train_s = time.perf_counter() - t0
        # the hook read and zeroed the counts after every step and epoch:
        # what is left is the closing evaluation's
        step_counts = list(LaunchCountHook.steps)
        epoch_counts = list(LaunchCountHook.evals)
        closing = launch_counts()
    finally:
        runner_loop.train_detector = real_train
        undo()
        LaunchCountHook.start_backbone = {}
    losses, metrics = res["losses"], res["metrics"]
    log(f"accuracy_run bbox --dcn, {ACC_EPOCHS} epochs of "
        f"{steps // ACC_EPOCHS} steps: losses {losses}, metrics "
        f"{json.dumps(metrics)}, launches a step "
        f"{json.dumps(step_counts[0] if step_counts else None)}, closing "
        f"evaluation {json.dumps(closing)} in {train_s:.1f}s")
    if len(step_counts) != steps or any(c != per_step for c in step_counts):
        raise AssertionError(f"accuracy_run: launches a step {step_counts},"
                             f" want {steps} x {per_step}")
    if any(c != none for c in epoch_counts) or closing != per_eval:
        raise AssertionError(f"accuracy_run: launches after the epochs "
                             f"{epoch_counts}, in the closing evaluation "
                             f"{closing}, want {per_eval}")
    if len(losses) != ACC_EPOCHS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"accuracy_run: losses {losses}")
    if "bbox_mAP" not in metrics or any(
            not k.startswith("bbox_") for k in metrics):
        raise AssertionError(f"accuracy_run: metrics {metrics}")
    train_calls = check_k1_calls("accuracy_run train step 1", calls)

    ckpt_path = os.path.join(out, "ckpts", f"step_{steps}.pt")
    calls, undo = capture_k1_calls(ACC_K1_PER_STEP)
    zero_launch_counts()
    try:
        t0 = time.perf_counter()
        near = accuracy_tool.main(flags + [
            "--out", os.path.join(root, "near"), "--eval-only", ckpt_path,
            "--sampling", "backbone=nearest"])
        eval_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        undo()
    log(f"accuracy_run --eval-only backbone=nearest: metrics "
        f"{json.dumps(near['metrics'])}, launches {json.dumps(counts)} in "
        f"{eval_s:.1f}s")
    if counts != per_eval or near["sampling"] != "backbone=nearest":
        raise AssertionError(f"accuracy_run --eval-only: launches {counts},"
                             f" sampling {near['sampling']}")
    # the run's own last evaluation is at the same (shipped) sampling
    if near["metrics"].keys() != metrics.keys() or any(
            abs(near["metrics"][k] - v) > 0.01 for k, v in metrics.items()):
        raise AssertionError("accuracy_run --eval-only: metrics differ from "
                             "the run's own evaluation")
    eval_calls = check_k1_calls("accuracy_run eval batch 1", calls)
    return step_counts[0], {k: v // eval_batches for k, v in counts.items()}, {
        "train_and_eval_s": train_s, "eval_only_s": eval_s,
        "losses": losses, "metrics": metrics, "card": res["card"],
        "k1_calls_checked": {"train step 1": train_calls,
                             "eval batch 1": eval_calls}}

def res2net_k1_inputs(gen, out_hw, C, stride, sampling, dtype):
    """(flat, idx, w, weight) of one Res2Net DCN call, B=1: a random input
    map of C channels (twice the output size at stride 2), random offsets
    and masks through the port's index code, a (K, C, C) weight."""
    dev = torch.device("cuda")
    h, w = out_hw
    feat = torch.randn(1, h * stride, w * stride, C, generator=gen)
    levels = fd.pack_levels([feat.to(dev, dtype)])
    job = fd.SampleJob(
        0, (2.0 * torch.randn(1, h, w, 2 * K, generator=gen)).to(dev),
        torch.rand(1, h, w, K, generator=gen).to(dev), (1.0, 1.0),
        (stride, stride), (1, 1), (1, 1))
    idx, wts = fd._gather_indices_tap(levels, [job], K, sampling)
    weight = (0.05 * torch.randn(K, C, C, generator=gen)).to(dev, dtype)
    return levels.flat.contiguous(), idx, wts, weight


def check_res2net_kernel():
    """Phase 2a, Res2Net: deform_gather_contract vs its plain version at
    C = cout = 52, 104, 208 (c3-c5 of Res2Net-101), stride 1 and the
    stage's stride-2 first block, nearest and bilinear, f32 and bf16. The
    wrapper pads C and cout to the kernel's multiples: its time includes
    that copy, which is also timed alone (``pad_ms``). For bf16 nearest
    (the shipped inference sampling) the einsum on the gathered patch
    tensor is the yardstick, and the calls sum to K1's time per forward.
    Returns (rows of bf16 nearest by stage and stride, per-forward sums,
    max error)."""
    gen = torch.Generator().manual_seed(8)
    rows, max_err = {}, 0.0
    for stage, out_hw, C, _ in RES2_STAGES:
        for stride in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                for sampling in ("nearest", "bilinear"):
                    args = res2net_k1_inputs(gen, out_hw, C, stride,
                                             sampling, dtype)
                    got = deform_gather_contract(*args).float()
                    want = deform_gather_contract_ref(*args).float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    lim = TOL[dtype] * max(1.0, want.abs().max().item())
                    ok = (bool(torch.isfinite(got).all()) and err <= lim
                          and got.shape == want.shape)
                    del got, want
                    bnd, by = bound_ms(args)
                    row = dict(
                        stage=stage, stride=stride, C=C, cout=C,
                        dtype=str(dtype).split(".")[-1], sampling=sampling,
                        px=args[1].shape[2], nc=args[1].shape[0],
                        max_abs_err=err, limit=lim,
                        ms=cuda_ms(lambda: deform_gather_contract(*args),
                                   20),
                        pad_ms=cuda_ms(lambda: dg.pad_channels(
                            args[0], args[3]), 20),
                        plain_ms=cuda_ms(
                            lambda: deform_gather_contract_ref(*args), 3),
                        bound_ms=bnd, bound_by=by)
                    # the kernel alone, by the profiler: the events above
                    # also time the wrapper's host work and the padding
                    row["device_us"] = kernel_device_us(
                        lambda: deform_gather_contract(*args), "dgc_")
                    if dtype == torch.bfloat16 and sampling == "nearest":
                        vals = dg.gathered_rows(*args[:3]).to(dtype)
                        row["library_ms"] = cuda_ms(
                            lambda: torch.einsum("kpc,kco->po", vals,
                                                 args[3]), 10)
                        del vals
                        rows[(stage, stride)] = row
                    log("kernel res2net " + json.dumps(row))
                    if not ok:
                        raise AssertionError(f"kernel disagrees: {row}")
                    max_err = max(max_err, err)
                    del args
    keys = ("ms", "device_us", "pad_ms", "plain_ms", "bound_ms",
            "library_ms")
    fwd = {key: sum(3 * (rows[(st, 2)][key] + (n - 1) * rows[(st, 1)][key])
                    for st, _, _, n in RES2_STAGES) for key in keys}
    log("kernel res2net bf16 nearest per Res2Net-101 forward (90 calls) "
        + json.dumps(fwd))
    return rows, fwd, max_err


def api_weights_(model, seed):
    """Phase 8's seeded weights, in place: ``random_weights_``, then the
    classifier (``pts_cls_out``, RepPoints' ``cls_out``, the dense zoo's
    ``retina_cls`` / ``fcos_cls`` / ``atss_cls`` / ``gfl_cls`` /
    ``fovea_cls`` / ``ga_cls``, SSD's ``cls_conv{i}`` of every level) x
    CLS_SPREAD (the kept scores then lie far apart: no two of them tie
    within the card's ~1e-6 differences) and the backbone ``conv_offset``
    kernels 0 (each backbone sample within a bias of a lattice point, far
    from a nearest-rounding tie)."""
    apis.random_weights_(model, seed)
    names = ("pts_cls_out", "cls_out", "retina_cls", "fcos_cls",
             "atss_cls", "gfl_cls", "fovea_cls", "ga_cls")
    cls = [n for n in names if hasattr(model.head, n)][:1] or [
        n for n, _ in model.head.named_children()
        if n.startswith("cls_conv")]
    with torch.no_grad():
        for n in cls:
            getattr(model.head, n).weight.mul_(CLS_SPREAD)
        for name, m in model.backbone.named_modules():
            if name.endswith("conv_offset"):
                m.weight.zero_()
    return model


def seeded_checkpoint(cfg, ckpt_dir, seed=0):
    """A runner checkpoint (``save_checkpoint``, step 0, the train meta of
    a bilinear run) of ``cfg``'s model with phase 8's seeded weights."""
    model = api_weights_(build_detector(cfg.model.to_dict()), seed)
    optimizer, _ = build_optimizer(model.parameters(), 0.01, 1, (8, 11))
    return ckpt.save_checkpoint(ckpt_dir, model, optimizer, 0,
                                ckpt.train_meta())


def api_image(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(*API_IMAGE_HW, 3, generator=gen) * 255).to(
        torch.uint8).numpy()


def same_detections(label, got, want, vec="landmarks", atol=None):
    """Same count and labels; each label's detections paired one to one
    (least largest difference, ``linear_sum_assignment``) with boxes and
    vectors within ``atol`` (1e-3 of the image size by default) and scores
    within 1e-4. Returns the largest box / vector error."""
    from scipy.optimize import linear_sum_assignment
    atol = 1e-3 * max(API_IMAGE_HW) if atol is None else atol
    n = len(want["scores"])
    if len(got["scores"]) != n or not n or not np.array_equal(
            np.sort(got["labels"]), np.sort(want["labels"])):
        raise AssertionError(f"{label}: {len(got['scores'])} detections, "
                             f"want {n} (> 0) with the same labels")
    err = serr = 0.0
    for lab in np.unique(want["labels"]):
        g, w_ = (np.concatenate([r["bboxes"], r[vec]], 1)[r["labels"] == lab]
                 for r in (got, want))
        cost = np.abs(g[:, None] - w_[None]).max(-1)
        rows, cols = linear_sum_assignment(cost)
        err = max(err, float(cost[rows, cols].max()))
        serr = max(serr, float(np.abs(
            got["scores"][got["labels"] == lab][rows]
            - want["scores"][want["labels"] == lab][cols]).max()))
    if err > atol or serr > 1e-4:
        raise AssertionError(f"{label}: detections differ (box / vector "
                             f"{err:.3g} > {atol:.3g} or score {serr:.3g} "
                             "> 1e-4)")
    return err


def narrow_res2net_cfg():
    """Phase 8a: the Res2Net segm file cut to Res2Net-50 at
    ``base_channels=16, base_width=13`` (3x3 widths 13 / 26 / 52 / 104:
    every DCN width not a multiple of 8 or of 32), FPN and head at 64
    channels, test scale (640, 384)."""
    cfg = Config.fromfile(RES2_CONFIG)
    cfg.model.backbone.update(depth=50, base_channels=16, base_width=13)
    cfg.model.neck.update(out_channels=64)
    cfg.model.bbox_head.update(in_channels=64, feat_channels=64,
                               point_feat_channels=64)
    cfg.data.test.img_scale = (640, 384)
    return cfg


def check_api_narrow(root):
    """Phase 8a: the narrow Res2Net-DCN through init_detector (config and
    checkpoint) + inference_detector, f32, card against CPU."""
    cfg = narrow_res2net_cfg()
    path = seeded_checkpoint(cfg, os.path.join(root, "narrow"))
    img = api_image(1)
    res = {dev: apis.inference_detector(
        apis.init_detector(cfg, path, device=dev), img)
        for dev in ("cpu", "cuda")}
    err = same_detections("narrow Res2Net card vs CPU", res["cuda"],
                          res["cpu"])
    log(f"api narrow Res2Net-50-DCN segm (widths 26/52/104), card vs CPU: "
        f"{len(res['cpu']['scores'])} detections, labels equal, max box / "
        f"contour error {err:.3g} px")


def capture_forward_k1(bundle, img, want_calls):
    """Every K1 call of one ``inference_detector`` call, each held against
    its plain version (``check_k1_calls``)."""
    calls, undo = capture_k1_calls(10 * want_calls)
    try:
        apis.inference_detector(bundle, img)
    finally:
        undo()
    n = len(calls["forward"])
    if n != want_calls or calls["bwd_data"] or calls["bwd_weight"]:
        raise AssertionError(f"captured {n} K1 forward calls, want "
                             f"{want_calls}")
    return check_k1_calls(f"api Res2Net-101 {bundle.dtype}",
                          calls)["forward"]


def check_api_full(root):
    """Phase 8b and 8c. Returns (numbers, launches by path)."""
    import asyncio
    import statistics
    from PIL import Image as PILImage
    cfg = Config.fromfile(RES2_CONFIG)
    t0 = time.perf_counter()
    path = seeded_checkpoint(cfg, os.path.join(root, "res2"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = apis.init_detector(RES2_CONFIG, path)
    init_s = time.perf_counter() - t0
    if dict(bundle.sampling) != dict(fd.INFERENCE_SAMPLING):
        raise AssertionError(f"deploy sampling {dict(bundle.sampling)}")
    img = api_image(0)
    png = os.path.join(root, "image.png")
    PILImage.fromarray(img).save(png)
    by_path, numbers = {}, {"checkpoint_write_s": write_s,
                            "init_detector_s": init_s}

    # (b) inference_detector: warm-up, then counted and timed calls
    for _ in range(2):
        res = apis.inference_detector(bundle, img)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    res = apis.inference_detector(bundle, img)
    by_path["api inference_detector"] = launch_counts()
    want = {**dict.fromkeys(launch_counts(), 0),
            "deform_gather_contract": RES2_K1_PER_FORWARD}
    if by_path["api inference_detector"] != want:
        raise AssertionError(f"inference_detector launches "
                             f"{by_path['api inference_detector']}")
    times = []
    for _ in range(API_RUNS):
        t0 = time.perf_counter()
        res = apis.inference_detector(bundle, img)
        times.append(time.perf_counter() - t0)
    numbers["inference_detector_s"] = times
    numbers["img_per_s"] = 1.0 / statistics.median(times)
    numbers["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    n = len(res["scores"])
    if not n or res["landmarks"].shape != (n, 72) or not all(
            bool(np.isfinite(v).all()) for v in res.values()):
        raise AssertionError(f"inference_detector result: {n} detections")
    from_png = apis.inference_detector(bundle, png)
    same_detections("PNG path vs array", from_png, res, atol=0.0)
    log(f"api Res2Net-101-DCN segm inference_detector: {n} detections, "
        f"{numbers['img_per_s']:.3f} img/s (host clock, median of "
        f"{API_RUNS}: {[round(t * 1e3, 2) for t in times]} ms), peak "
        f"memory {numbers['peak_memory_bytes'] / 2 ** 30:.2f} GiB")
    profile("api Res2Net-101-DCN segm inference_detector",
            lambda: apis.inference_detector(bundle, img),
            1e3 / numbers["img_per_s"])

    # every K1 call of one forward, f32 and bf16
    numbers["k1_calls_checked"] = {"float32": capture_forward_k1(
        bundle, img, RES2_K1_PER_FORWARD)}
    bf16 = apis.init_detector(RES2_CONFIG, path, dtype=torch.bfloat16)
    numbers["k1_calls_checked"]["bfloat16"] = capture_forward_k1(
        bf16, img, RES2_K1_PER_FORWARD)
    times = []
    for _ in range(API_RUNS):
        t0 = time.perf_counter()
        apis.inference_detector(bf16, img)
        times.append(time.perf_counter() - t0)
    numbers["bf16_img_per_s"] = 1.0 / statistics.median(times)
    log(f"api Res2Net-101-DCN segm inference_detector in bf16: "
        f"{numbers['bf16_img_per_s']:.3f} img/s (host clock, median of "
        f"{API_RUNS})")
    profile("api Res2Net-101-DCN segm inference_detector bf16",
            lambda: apis.inference_detector(bf16, img),
            1e3 / numbers["bf16_img_per_s"])
    del bf16

    # fused FrozenBatchNorm: the unfused detections
    fused = apis.init_detector(RES2_CONFIG, path, fuse_conv_bn=True)
    err = same_detections("fuse_conv_bn", apis.inference_detector(fused, img),
                          res)
    log(f"api fuse_conv_bn=True: the unfused {n} detections, max box / "
        f"contour error {err:.3g} px")
    del fused

    # aug_test: 2 scales x flip on two canvases; its vote against the
    # numpy oracle on the same per-augmentation detections
    votes = []
    real_vote = tta.aug_test_vote

    def keep_vote(*args, **kwargs):
        votes.append((args, kwargs))
        return real_vote(*args, **kwargs)

    tta.aug_test_vote = keep_vote
    try:
        apis.aug_test(bundle, img, scales=API_SCALES, flip=True)  # warm-up
        zero_launch_counts()
        t0 = time.perf_counter()
        merged = apis.aug_test(bundle, img, scales=API_SCALES, flip=True)
        numbers["aug_test_s_per_image"] = time.perf_counter() - t0
        by_path["api aug_test"] = launch_counts()
    finally:
        tta.aug_test_vote = real_vote
    if by_path["api aug_test"]["deform_gather_contract"] != \
            4 * RES2_K1_PER_FORWARD:
        raise AssertionError(f"aug_test launches {by_path['api aug_test']}")
    args, kwargs = votes[-1]
    oracle = real_vote(*args, **{**kwargs, "use_device": False})
    err = same_detections("aug_test vote card vs numpy oracle", merged,
                          oracle, vec="vectors", atol=1e-3)
    log(f"api aug_test {API_SCALES} x flip: {len(merged['scores'])} voted "
        f"detections from {sum(len(r['scores']) for r in args[0])}, "
        f"{numbers['aug_test_s_per_image']:.3f} s per image; the card's "
        f"vote equals the numpy oracle (max error {err:.3g} px)")
    # the same first augmentation twice, the copy's boxes shifted by 8 %
    # of their size (IoU 0.73 with the original): every detection meets a
    # partner, so the vote merges and re-emits soft detections
    first = args[0][0]
    b = first["bboxes"]
    wh = np.tile(b[:, 2:] - b[:, :2], 2)
    jit = dict(first, bboxes=b + 0.08 * wh, scores=first["scores"] * 0.9)
    pair = ([first, jit], [args[1][0]] * 2, [(0, 10000)])
    card = real_vote(*pair, **kwargs)
    err = same_detections("vote of jittered pairs, card vs numpy oracle",
                          card, real_vote(*pair, **{**kwargs,
                                                    "use_device": False}),
                          vec="vectors", atol=1e-3)
    if not len(card["scores"]) > len(first["scores"]):
        raise AssertionError("the jittered pairs made no soft detection")
    log(f"api vote of {len(first['scores'])} detections and their jittered "
        f"copies: {len(card['scores'])} merged and soft detections, card "
        f"equals the numpy oracle (max error {err:.3g} px)")

    # async_inference_detector and show_result
    async def gather():
        return await asyncio.gather(*[
            apis.async_inference_detector(bundle, img) for _ in range(3)])
    for a in asyncio.run(gather()):
        same_detections("async vs sync", a, res, atol=0.0)
    out_file = os.path.join(root, "show.png")
    shown = apis.show_result(img, res, "segm", score_thr=0.0,
                             out_file=out_file)
    if shown.shape != img.shape or not os.path.getsize(out_file):
        raise AssertionError("show_result wrote no image")
    del bundle
    torch.cuda.empty_cache()

    # (c) aug_test_simple on the X-101-64x4d-DCN bbox file
    x101 = apis.init_detector(RUNNER_CONFIG)
    api_weights_(x101.model, 0)
    apis.aug_test_simple(x101, img, scales=[(1333, 800)], flip=True)
    zero_launch_counts()
    t0 = time.perf_counter()
    simple = apis.aug_test_simple(x101, img, scales=[(1333, 800)],
                                  flip=True)
    numbers["aug_test_simple_s_per_image"] = time.perf_counter() - t0
    by_path["api aug_test_simple"] = launch_counts()
    want = {**dict.fromkeys(launch_counts(), 0),
            "deform_gather_contract": 2 * K1_PER_FORWARD["bbox"],
            "deform_gather_grouped_contract": 2 * GROUPED_PER_FORWARD}
    n = len(simple["scores"])
    if by_path["api aug_test_simple"] != want or not n \
            or simple["landmarks"].shape != (n, 8):
        raise AssertionError(f"aug_test_simple: {n} detections, launches "
                             f"{by_path['api aug_test_simple']}")
    log(f"api aug_test_simple X-101-64x4d-DCN bbox (1333, 800) x flip: {n} "
        f"detections, {numbers['aug_test_simple_s_per_image']:.3f} s per "
        "image")
    return numbers, by_path


def check_api(root):
    """Phase 8."""
    check_api_narrow(root)
    return check_api_full(root)


# ------------------------------------------------------------ phase 9: CPV

def narrow_cpv_cfg():
    """Phase 9a: LSNet-CPV on the narrow ResNeXt-shaped model of phase 3
    (ResNeXt-50, G=8, DCN c3-c5, feat 64, two stacked DCN blocks)."""
    cfg = configs.x101_cpv_cfg(feat=64, stacked=2)
    cfg["backbone"].update(depth=50, groups=8)
    return cfg


def check_cpv_small():
    """Phase 9a: the narrow CPV model on the card against the CPU: the six
    head outputs, then the loss, its six terms and every parameter's
    gradient, at phase 3's tolerances."""
    outputs_card_vs_cpu("ResNeXt-shaped CPV", narrow_cpv_cfg())
    hw = (96, 128)
    gradients_card_vs_cpu("ResNeXt-shaped CPV", narrow_cpv_cfg(),
                          CPVLossConfig(base=loss_config("bbox", hw, 8)), hw)


def cpv_refine_inputs(dtype, gen, sampling):
    """(flat, idx, w, weight) of the CPV head's paired refine contraction
    at B=2, 800x1344: five level maps of 262 channels, the five-level
    cross-level jobs, a (K, 262, 256) weight."""
    dev = torch.device("cuda")
    feats = [torch.randn(B, h, w, CPV_C, generator=gen).to(dev, dtype)
             for h, w in LEVELS]
    levels = fd.pack_levels(feats)
    offs = [(2.0 * torch.randn(B, h, w, 2 * K, generator=gen)).to(dev)
            for h, w in LEVELS]
    idx, w = fd._gather_indices_tap(levels, branch_pyramid_jobs(
        LEVELS, offs, 3), K, sampling)
    weight = (0.02 * torch.randn(K, CPV_C, FEAT, generator=gen)).to(
        dev, dtype)
    return levels.flat.contiguous(), idx, w, weight


def pad_device_us(args, dout):
    """Device time of the padding copies of one K1 call (flat and the
    weight, and dout for the backward), 0 where nothing is padded."""
    flat, _, _, weight = args
    mc, mo = dg.channel_multiples(flat.dtype)
    if flat.shape[1] % mc == 0 and weight.shape[2] % mo == 0:
        return 0.0

    def pad():
        fp, wp = dg.pad_channels(flat, weight)
        return dg.pad_dout(dout, wp.shape[2])
    return kernel_device_us(pad, "", 10)


def padding_options(args, gen):
    """The two places for the padding of an autograd K1 call, timed and
    weighed on one call (forward + backward, bf16): "saved" (the public
    ``deform_gather_contract`` pads once and the function saves the
    padded operands) and "again" (``GatherContract`` on the unpadded
    operands: the forward wrapper pads, and each backward wrapper pads
    once more). flat is a non-leaf, as in the model, so the unpadded copy
    dies after the forward where only the padded one is saved."""
    src, idx, w, weight = args
    src = src.detach().clone().requires_grad_()
    wk = weight.detach().clone().requires_grad_()
    wt = w.detach().clone().requires_grad_()
    dout = torch.randn(idx.shape[2], weight.shape[2], device="cuda",
                       generator=gen).to(src.dtype)

    def saved():
        out = deform_gather_contract(src * 1, idx, wt, wk)
        torch.autograd.backward(out, dout)

    def again():
        out = dg.GatherContract.apply(dg._OPS, src * 1, idx, wt, wk, None,
                                      None)
        torch.autograd.backward(out, dout)

    out = {}
    for name, fn in (("saved", saved), ("again", again)):
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[name] = {"ms": cuda_ms(fn, 10),
                     "peak_extra_bytes":
                         torch.cuda.max_memory_allocated() - base}
        src.grad = wk.grad = wt.grad = None
    return out


def check_cpv_kernels():
    """Phase 9b: K1's forward, bwd-data and bwd-weight against their plain
    versions at the CPV refine call (C = 262, cout = 256) and Res2Net's
    C = cout = 52 / 104 / 208 (stride 1 and 2), f32 (TF32 off) and bf16,
    nearest and bilinear, phase 2's tolerances; the wrappers pad C and
    cout. For bf16 bilinear (the train step's) the device time of each
    kernel and of the padding copies, the einsum yardsticks, and (CPV)
    the two places for the padding. Returns the rows by shape."""
    gen = torch.Generator().manual_seed(9)
    cgen = torch.Generator(device="cuda").manual_seed(9)
    shapes = [("CPV refine", None, CPV_C, 1)] + [
        (f"Res2Net {st} stride {stride}", out_hw, C, stride)
        for st, out_hw, C, _ in RES2_STAGES for stride in (1, 2)]
    rows = {}
    for label, out_hw, C, stride in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for sampling in ("nearest", "bilinear"):
                args = (cpv_refine_inputs(dtype, gen, sampling)
                        if out_hw is None else
                        res2net_k1_inputs(gen, out_hw, C, stride, sampling,
                                          dtype))
                main = dtype == torch.bfloat16 and sampling == "bilinear"
                got = deform_gather_contract(*args).float()
                want = deform_gather_contract_ref(*args).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                lim = TOL[dtype] * max(1.0, want.abs().max().item())
                if not (bool(torch.isfinite(got).all()) and err <= lim
                        and got.shape == want.shape):
                    raise AssertionError(f"{label} {dtype} {sampling}: K1 "
                                         f"forward err {err} > {lim}")
                del got, want
                row = check_backward_call(
                    dict(shape=label, C=C, cout=args[3].shape[2],
                         sampling=sampling), args, 0, cgen, library=main)
                row.update(fwd_err=err, fwd_limit=lim,
                           fwd_ms=cuda_ms(
                               lambda: deform_gather_contract(*args), 10),
                           fwd_plain_ms=cuda_ms(
                               lambda: deform_gather_contract_ref(*args), 2))
                row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(args)
                if main:
                    dout = torch.randn(args[1].shape[2], args[3].shape[2],
                                       device="cuda", generator=cgen).to(
                                           dtype)
                    # each kernel on operands padded beforehand, the
                    # padding copies apart: a profile holds fewer records
                    # (one with many, at 134,400 px, lost some in a row)
                    fp, wp = dg.pad_channels(args[0], args[3])
                    padded = (fp, args[1], args[2], wp)
                    dp = dg.pad_dout(dout, wp.shape[2])
                    row["device_us"] = {
                        "forward": kernel_device_us(
                            lambda: dg._forward(*padded), "dgc_", 5),
                        "bwd_data": kernel_device_us(
                            lambda: dg.deform_gather_contract_bwd_data(
                                *padded, dp), "bwd_data_kernel", 5),
                        "bwd_weight": kernel_device_us(
                            lambda: dg.deform_gather_contract_bwd_weight(
                                *padded, dp), "bwd_weight_kernel", 5),
                        "padding": pad_device_us(args, dout)}
                    del fp, wp, padded, dp
                    vals = dg.gathered_rows(*args[:3]).to(dtype)
                    row["fwd_library_ms"] = cuda_ms(
                        lambda: torch.einsum("kpc,kco->po", vals, args[3]),
                        10)
                    del vals
                    if out_hw is None:
                        row["padding_options"] = padding_options(args, cgen)
                    rows[label] = row
                    log("cpv kernels " + json.dumps(row))
                del args
            torch.cuda.empty_cache()
    return rows


def check_cpv_x101(root):
    """Phase 9c: the shipped X-101-64x4d-DCN CPV file at full width (80
    classes, seeded weights): ``init_detector`` from a ``save_checkpoint``
    file, ``inference_detector`` twice on a seeded 480x640 image (the same
    detections), ``detect`` at B=2 800x1344 bf16 (9 K1 and 30 grouped a
    forward), train steps at B=2 bf16 (bilinear, 20 instances an image),
    each profiled, then ``lsnet_torch.tools.bench_cpv``. Returns
    (numbers, launches by path)."""
    from lsnet_torch.tools import bench_cpv
    by_path, numbers = {}, {}
    cfg = Config.fromfile(CPV_X101_CONFIG)
    path = seeded_checkpoint(cfg, os.path.join(root, "cpv"))
    bundle = apis.init_detector(CPV_X101_CONFIG, path)
    if runner_loop.decode_for(bundle.model) is not cpv.lscpv_decode:
        raise AssertionError("the CPV bundle does not decode with "
                             "lscpv_decode")
    img = api_image(2)
    first = apis.inference_detector(bundle, img)
    zero_launch_counts()
    again = apis.inference_detector(bundle, img)
    by_path["cpv inference_detector"] = launch_counts()
    want = {**dict.fromkeys(launch_counts(), 0),
            "deform_gather_contract": CPV_K1_PER_FORWARD,
            "deform_gather_grouped_contract": GROUPED_PER_FORWARD}
    n = len(again["scores"])
    if by_path["cpv inference_detector"] != want or not n or \
            again["landmarks"].shape != (n, 8):
        raise AssertionError(f"CPV inference_detector: {n} detections, "
                             f"launches {by_path['cpv inference_detector']}")
    same_detections("CPV inference_detector, second call", again, first,
                    atol=0.0)
    log(f"cpv X-101 inference_detector: {n} detections, equal on a second "
        "call")
    del bundle
    torch.cuda.empty_cache()

    label = "X-101-64x4d-DCN CPV"
    run, img_s, launches, peak = drive_main_path(
        label, configs.x101_cpv_cfg(), GROUPED_PER_FORWARD, "bbox",
        k1=CPV_K1_PER_FORWARD)
    profile(label, run, B / img_s * 1e3)
    numbers["img_per_s"], numbers["peak_memory_bytes"] = img_s, peak
    by_path[label] = {k: v // ITERS for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    # no warm-up: at the random weights the CPV loss's gradient norm is
    # about 1,400 (the bbox model's 157), so the clip scales every
    # gradient by 0.024, and at the warm-up's first rate (1e-5) the
    # updates of some parameters fall under their f32 spacing: they would
    # not move although their gradient is right (phase 9a)
    run, img_s, launches, peak = drive_train_path(
        "cpv", configs.x101_cpv_cfg(),
        CPVLossConfig(base=loss_config("bbox", (H, W), 80)),
        k1=CPV_K1_PER_FORWARD, steps=CPV_TRAIN_STEPS, warmup_iters=0)
    card_state("before the profiled CPV train step")
    profile(f"{label} train step", run, B / img_s * 1e3)
    numbers["train_img_per_s"] = img_s
    numbers["train_peak_memory_bytes"] = peak
    by_path[f"{label} train"] = {k: v // CPV_TRAIN_STEPS
                                 for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    numbers["bench_cpv"] = bench_cpv.main([])
    return numbers, by_path


def check_cpv_res2_runner(root):
    """Phase 9d: the shipped Res2Net-101-DCN CPV file at full width through
    ``lsnet_torch.tools.train`` (1 epoch of 2 steps on 4 procedural 5:3
    images, an EvalHook on 2 more) and ``lsnet_torch.tools.test`` on its
    checkpoint (metrics within 1e-4 of the hook's); the launches of every
    step (RES2_CPV_PER_STEP) and of the eval; every K1 call of the first
    train step (forward, bwd-data, bwd-weight, at 52 / 104 / 208 and 262
    channels, which reach the kernels padded) held against its plain
    version. Returns (numbers, launches per step, per eval batch)."""
    train_root, val_root = (os.path.join(root, n) for n in ("train", "val"))
    train_ann, _ = make_shapes_coco(train_root, len(RES2_CPV_TRAIN_HW),
                                    seed=3, hw=RES2_CPV_TRAIN_HW)
    val_ann, _ = make_shapes_coco(val_root, len(RES2_CPV_VAL_HW), seed=4,
                                  hw=RES2_CPV_VAL_HW)
    test_opts, opts = runner_options(train_root, val_root, train_ann,
                                     val_ann)
    work = os.path.join(root, "work")
    LaunchCountHook.steps.clear()
    LaunchCountHook.evals.clear()
    calls, undo = capture_k1_calls({
        "forward": RES2_CPV_PER_STEP["deform_gather_contract"],
        "bwd_data": RES2_CPV_K1_CALLS, "bwd_weight": RES2_CPV_K1_CALLS})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = train_tool.main([CPV_RES2_CONFIG, "--work-dir", work,
                               "--total-epochs", "1", "--options", *opts])
    finally:
        undo()
        LaunchCountHook.start_backbone = {}
    train_s = time.perf_counter() - t0
    steps, evals = list(LaunchCountHook.steps), list(LaunchCountHook.evals)
    train = log_records(work, "train")
    val = log_records(work, "val")
    for r in train:
        log("runner Res2Net-101-CPV " + json.dumps(r))
    want = {**dict.fromkeys(launch_counts(), 0), **RES2_CPV_PER_STEP}
    if len(train) != 2 or res["step"] != 2 or len(val) != 1 or any(
            not math.isfinite(r[k]) for r in train
            for k in ("loss", "grad_norm", "loss_heatmap", "loss_sem")):
        raise AssertionError(f"runner Res2Net-101-CPV: records {train}, "
                             f"{val}")
    if steps != [want] * 2:
        raise AssertionError(f"runner Res2Net-101-CPV: launches per step "
                             f"{steps}, want {want}")
    want_eval = {**dict.fromkeys(launch_counts(), 0),
                 "deform_gather_contract": RES2_CPV_K1_CALLS}
    if evals != [want_eval]:
        raise AssertionError(f"runner Res2Net-101-CPV: launches per eval "
                             f"{evals}, want {want_eval}")
    widths = {name: sorted({(a[0].shape[1], a[3].shape[2]) for a in v})
              for name, v in calls.items()}
    log(f"runner Res2Net-101-CPV step 1 K1 calls (C, cout as the kernels "
        f"get them): {json.dumps(widths)}")
    checked = check_k1_calls("runner Res2Net-101-CPV train step 1", calls)
    del calls
    torch.cuda.empty_cache()
    path = os.path.join(work, "ckpts", "step_2.pt")
    metrics = test_tool.main([CPV_RES2_CONFIG, path, "--eval", "bbox",
                              "--options", *test_opts])
    hook_metrics = {k: v for k, v in val[-1].items()
                    if k not in ("mode", "epoch")}
    log(f"runner Res2Net-101-CPV tools.test metrics {json.dumps(metrics)}; "
        f"EvalHook {json.dumps(hook_metrics)}")
    if metrics.keys() != hook_metrics.keys() or len(metrics) != 12 or any(
            not -1.0 <= v <= 1.0 or abs(v - hook_metrics[k]) > 1e-4
            for k, v in metrics.items()):
        raise AssertionError("runner Res2Net-101-CPV: tools.test metrics "
                             "disagree with the EvalHook's")
    numbers = {"train_and_eval_s": train_s,
               "train_s_per_iter": [r["time"] for r in train],
               "losses": [r["loss"] for r in train], "metrics": metrics,
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "k1_calls_checked": checked}
    return numbers, steps[0], evals[0]


def check_cpv(root):
    """Phase 9 (a to d). Returns (numbers, kernel rows, launches by
    path)."""
    t0 = time.perf_counter()
    check_cpv_small()
    seconds = {"a": time.perf_counter() - t0}
    rows = check_cpv_kernels()
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    numbers, by_path = check_cpv_x101(os.path.join(root, "x101"))
    seconds["c"] = time.perf_counter() - t0 - sum(seconds.values())
    (numbers["runner_res2net"], by_path["runner Res2Net-101-CPV train"],
     by_path["runner Res2Net-101-CPV eval"]) = check_cpv_res2_runner(
        os.path.join(root, "res2"))
    seconds["d"] = time.perf_counter() - t0 - sum(seconds.values())
    log(f"phase 9 seconds by part {json.dumps(seconds)}")
    numbers["seconds"] = time.perf_counter() - t0
    return numbers, rows, by_path


# ---------------------------------------------------- phase 10: RepPoints

def rp_config(name):
    return Config.fromfile(RP_CONFIGS[name])


def narrow_rp_cfg(name):
    """Phase 10a: the shipped file's model (R50) with a narrow neck and
    head: feat 64, two stacked convs."""
    cfg = rp_config(name).model.to_dict()
    cfg["neck"]["out_channels"] = 64
    cfg["bbox_head"].update(in_channels=64, feat_channels=64,
                            point_feat_channels=64, stacked_convs=2)
    return cfg


def check_reppoints_small():
    """Phase 10a: narrow RepPoints v1 and v2 models on the card against
    the CPU: the head outputs, then the loss, its terms and every
    parameter's gradient, at phase 3's tolerances."""
    hw = (96, 128)
    for name, kind in (("v1", rp.RepPointsConfig),
                       ("v2", rp.RepPointsV2Config)):
        label = f"R50-shaped RepPoints {name}"
        outputs_card_vs_cpu(label, narrow_rp_cfg(name))
        gradients_card_vs_cpu(label, narrow_rp_cfg(name),
                              kind(image_shape=hw, num_classes=8), hw)


def rp_k1_inputs(dtype, gen, C, levels=LEVELS):
    """(flat, idx, w, weight) of RepPoints' paired gather (and of Guided
    Anchoring's feature adaption) at B=2, 800x1344: five level maps of C
    channels (``levels``), each job on its own level at scale 1, stride 1
    and no mask, offsets a few pixels around the taps, bilinear; a (K, C,
    256) weight."""
    dev = torch.device("cuda")
    feats = [torch.randn(B, h, w, C, generator=gen).to(dev, dtype)
             for h, w in levels]
    levels_ = fd.pack_levels(feats)
    jobs = [fd.SampleJob(i, (2.0 * torch.randn(B, h, w, 2 * K,
                                               generator=gen)).to(dev),
                         None, (1.0, 1.0), (1, 1), (1, 1), (1, 1))
            for i, (h, w) in enumerate(levels)]
    idx, w = fd._gather_indices_tap(levels_, jobs, K, "bilinear")
    weight = (0.02 * torch.randn(K, C, FEAT, generator=gen)).to(dev, dtype)
    return levels_.flat.contiguous(), idx, w, weight


def check_reppoints_kernels():
    """Phase 10b: K1's forward, bwd-data and bwd-weight against their
    plain versions at RepPoints' paired call (B=2, 800x1344, the five
    levels, no mask, scale 1, bilinear): C = cout = 256 (v1) and C = 262
    (v2, padded to 288 by the wrappers). Returns the bf16 rows by
    shape."""
    return check_k1_level_calls(
        "reppoints", [("RepPoints v1 paired", FEAT, LEVELS),
                      ("RepPoints v2 paired", RP_V2_C, LEVELS)], seed=10)


def check_k1_level_calls(what, cases, seed):
    """K1's forward, bwd-data and bwd-weight against their plain versions
    at calls whose jobs each read their own level at scale 1, stride 1,
    no mask, bilinear (``rp_k1_inputs``), for each (label, C, levels) of
    ``cases``: f32 (TF32 off) and bf16, phase 2's tolerances; each call's
    events time, plain time and bound, and for bf16 (the train step's)
    each kernel's device time on operands padded beforehand, the padding
    copies' device time and the einsum yardsticks. Returns the bf16 rows
    by label."""
    gen = torch.Generator().manual_seed(seed)
    cgen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for label, C, levels in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = rp_k1_inputs(dtype, gen, C, levels)
            got = deform_gather_contract(*args).float()
            want = deform_gather_contract_ref(*args).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lim = TOL[dtype] * max(1.0, want.abs().max().item())
            if not (bool(torch.isfinite(got).all()) and err <= lim
                    and got.shape == want.shape):
                raise AssertionError(f"{label} {dtype}: K1 forward err "
                                     f"{err} > {lim}")
            del got, want
            main = dtype == torch.bfloat16
            row = check_backward_call(
                dict(shape=label, C=C, cout=FEAT, sampling="bilinear"),
                args, 0, cgen, library=main)
            row.update(fwd_err=err, fwd_limit=lim,
                       fwd_ms=cuda_ms(lambda: deform_gather_contract(*args),
                                      10),
                       fwd_plain_ms=cuda_ms(
                           lambda: deform_gather_contract_ref(*args), 2))
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound_ms(args)
            if main:
                dout = torch.randn(args[1].shape[2], FEAT, device="cuda",
                                   generator=cgen).to(dtype)
                fp, wp = dg.pad_channels(args[0], args[3])
                padded = (fp, args[1], args[2], wp)
                dp = dg.pad_dout(dout, wp.shape[2])
                row["device_us"] = {
                    "forward": kernel_device_us(
                        lambda: dg._forward(*padded), "dgc_", 5,
                        per_call=1, profiles=3),
                    "bwd_data": kernel_device_us(
                        lambda: dg.deform_gather_contract_bwd_data(
                            *padded, dp), "bwd_data_kernel", 5, per_call=1,
                        profiles=3),
                    "bwd_weight": kernel_device_us(
                        lambda: dg.deform_gather_contract_bwd_weight(
                            *padded, dp), "bwd_weight_kernel", 5,
                        per_call=1, profiles=3),
                    "padding": pad_device_us(args, dout)}
                del fp, wp, padded, dp
                vals = dg.gathered_rows(*args[:3]).to(dtype)
                row["fwd_library_ms"] = cuda_ms(
                    lambda: torch.einsum("kpc,kco->po", vals, args[3]), 10)
                del vals
                rows[label] = row
            log(f"{what} kernels {label} {dtype}: forward "
                f"{row['fwd_ms']:.4f} ms (bound {row['fwd_bound_ms']:.4f}, "
                f"plain {row['fwd_plain_ms']:.4f}), bwd-data "
                f"{row['data_ms']:.4f} (bound {row['data_bound_ms']:.4f}), "
                f"bwd-weight {row['weight_ms']:.4f} (bound "
                f"{row['weight_bound_ms']:.4f}) " + json.dumps(row))
            del args
            torch.cuda.empty_cache()
    return rows


def check_reppoints_full(root, name):
    """Phase 10c / 10d: the shipped RepPoints v1 / v2 moment file at full
    width (R50, 80 classes, seeded weights): ``init_detector`` from a
    ``save_checkpoint`` file, ``inference_detector`` twice on a seeded
    480x640 image (equal detections, 2 K1 launches each), ``detect`` at
    B=2 800x1344 bf16 (2 K1 and 0 grouped a forward), RP_TRAIN_STEPS train
    steps at B=2 bf16 (bilinear, 20 instances an image; 2 K1 launches of
    each kind a step, finite loss, trainable parameters moved and frozen
    ones not), each profiled. Returns (numbers, launches by path)."""
    cfg = rp_config(name)
    label = f"RepPoints {name} R50"
    by_path, numbers = {}, {}
    path = seeded_checkpoint(cfg, os.path.join(root, name))
    bundle = apis.init_detector(RP_CONFIGS[name], path)
    kind = type(bundle.model.head).__name__
    if kind != ("RepPointsV2Head" if name == "v2" else "RepPointsHead"):
        raise AssertionError(f"{label}: the bundle's head is {kind}")
    img = api_image(3)
    first = apis.inference_detector(bundle, img)
    zero_launch_counts()
    again = apis.inference_detector(bundle, img)
    by_path[f"{label} inference_detector"] = launch_counts()
    want = {**dict.fromkeys(launch_counts(), 0),
            "deform_gather_contract": RP_K1_PER_FORWARD}
    n = len(again["scores"])
    got = by_path[f"{label} inference_detector"]
    if got != want or not n:
        raise AssertionError(f"{label} inference_detector: {n} detections, "
                             f"launches {got}")
    same_detections(f"{label} inference_detector, second call", again,
                    first, atol=0.0)
    log(f"{label} inference_detector: {n} detections, equal on a second "
        "call")
    del bundle
    torch.cuda.empty_cache()

    model_cfg = cfg.model.to_dict()
    run, img_s, launches, peak = drive_main_path(
        label, model_cfg, 0, "bbox", k1=RP_K1_PER_FORWARD, config=cfg)
    profile(label, run, B / img_s * 1e3)
    numbers["img_per_s"], numbers["peak_memory_bytes"] = img_s, peak
    by_path[label] = {k: v // ITERS for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    run, img_s, launches, peak = drive_train_path(
        "bbox", model_cfg, runner_loop.train_loss_cfg(cfg, (H, W)),
        k1=RP_K1_PER_FORWARD, steps=RP_TRAIN_STEPS, label=f"{label} train",
        grouped=0, warmup_iters=0)
    card_state(f"before the profiled {label} train step")
    profile(f"{label} train step", run, B / img_s * 1e3)
    numbers["train_img_per_s"] = img_s
    numbers["train_peak_memory_bytes"] = peak
    by_path[f"{label} train"] = {k: v // RP_TRAIN_STEPS
                                 for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    return numbers, by_path


def check_dense_full(name):
    """Phase 10e: the shipped Dense RepPoints v1 / v2 file at full width
    (R50, 729 points, 80 classes, seeded weights): ``detect`` at B=2
    800x1344 bf16 and one train step (bf16, 20 instances an image with
    36-point contours), 0 K1 and 0 grouped launches, each profiled, with
    peak memory. Returns (numbers, launches by path)."""
    cfg = rp_config(name)
    label = f"Dense RepPoints {name.split('_')[1]} R50"
    model_cfg = cfg.model.to_dict()
    numbers, by_path = {"batch": B}, {}
    run, img_s, launches, peak = drive_main_path(
        label, model_cfg, 0, "bbox", k1=0, config=cfg)
    profile(label, run, B / img_s * 1e3)
    numbers["img_per_s"], numbers["peak_memory_bytes"] = img_s, peak
    by_path[label] = {k: v // ITERS for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    run, img_s, launches, peak = drive_train_path(
        "bbox", model_cfg, runner_loop.train_loss_cfg(cfg, (H, W)), k1=0,
        steps=DENSE_TRAIN_STEPS, label=f"{label} train", grouped=0,
        warmup_iters=0)
    profile(f"{label} train step", run, B / img_s * 1e3)
    numbers["train_img_per_s"] = img_s
    numbers["train_peak_memory_bytes"] = peak
    by_path[f"{label} train"] = {k: v // DENSE_TRAIN_STEPS
                                 for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    return numbers, by_path


def check_reppoints_runner(root):
    """Phase 10f: the shipped RepPoints moment file at full width through
    ``lsnet_torch.tools.train`` (1 epoch of 2 steps on 4 procedural
    768x1280 images, an EvalHook on 2 more) and ``lsnet_torch.tools.test``
    on its checkpoint (metrics within 1e-4 of the hook's); 2 K1 launches of
    each kind every step, 2 forward in the eval. Returns (numbers,
    launches per step, per eval)."""
    return check_file_runner("RepPoints", RP_CONFIGS["v1"],
                             RP_K1_PER_FORWARD,
                             ("loss_pts_init", "loss_pts_refine"), root)


def check_file_runner(label, path, k1, loss_keys, root,
                      train_hw=RP_RUNNER_TRAIN_HW, val_hw=RP_RUNNER_VAL_HW):
    """A shipped file at full width through ``lsnet_torch.tools.train`` (1
    epoch of 2 steps on 4 procedural images, 768x1280 unless
    ``train_hw`` says otherwise, an EvalHook on 2 more, ``val_hw``) and
    ``lsnet_torch.tools.test`` on its checkpoint (metrics within 1e-4 of
    the hook's); ``k1`` K1 launches of each kind every step and forward
    in the eval, finite ``loss_keys``. Returns (numbers, launches per
    step, per eval)."""
    train_root, val_root = (os.path.join(root, n) for n in ("train", "val"))
    train_ann, _ = make_shapes_coco(train_root, len(train_hw), seed=5,
                                    hw=train_hw)
    val_ann, _ = make_shapes_coco(val_root, len(val_hw), seed=6, hw=val_hw)
    test_opts, opts = runner_options(train_root, val_root, train_ann,
                                     val_ann)
    work = os.path.join(root, "work")
    LaunchCountHook.steps.clear()
    LaunchCountHook.evals.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        res = train_tool.main([path, "--work-dir", work,
                               "--total-epochs", "1",
                               "--max-iters-per-epoch", "2",
                               "--options", *opts])
    finally:
        LaunchCountHook.start_backbone = {}
    train_s = time.perf_counter() - t0
    steps, evals = list(LaunchCountHook.steps), list(LaunchCountHook.evals)
    train = log_records(work, "train")
    val = log_records(work, "val")
    for r in train:
        log(f"runner {label} " + json.dumps(r))
    if len(train) != 2 or res["step"] != 2 or len(val) != 1 or any(
            not math.isfinite(r[k]) for r in train
            for k in ("loss", "grad_norm") + tuple(loss_keys)):
        raise AssertionError(f"runner {label}: records {train}, {val}")
    want = {**dict.fromkeys(launch_counts(), 0),
            "deform_gather_contract": k1,
            "deform_gather_contract_bwd_data": k1,
            "deform_gather_contract_bwd_weight": k1}
    if steps != [want] * 2:
        raise AssertionError(f"runner {label}: launches per step {steps}, "
                             f"want {want}")
    want_eval = {**dict.fromkeys(launch_counts(), 0),
                 "deform_gather_contract": k1}
    if evals != [want_eval]:
        raise AssertionError(f"runner {label}: launches per eval {evals}, "
                             f"want {want_eval}")
    ckpt_path = os.path.join(work, "ckpts", "step_2.pt")
    metrics = test_tool.main([path, ckpt_path, "--eval", "bbox",
                              "--options", *test_opts])
    hook_metrics = {k: v for k, v in val[-1].items()
                    if k not in ("mode", "epoch")}
    log(f"runner {label} tools.test metrics {json.dumps(metrics)}; "
        f"EvalHook {json.dumps(hook_metrics)}")
    if metrics.keys() != hook_metrics.keys() or len(metrics) != 12 or any(
            not -1.0 <= v <= 1.0 or abs(v - hook_metrics[k]) > 1e-4
            for k, v in metrics.items()):
        raise AssertionError(f"runner {label}: tools.test metrics disagree "
                             "with the EvalHook's")
    numbers = {"train_and_eval_s": train_s,
               "train_s_per_iter": [r["time"] for r in train],
               "losses": [r["loss"] for r in train], "metrics": metrics,
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return numbers, steps[0], evals[0]


def check_reppoints(root):
    """Phase 10 (a to f). Returns (numbers, kernel rows, launches by
    path)."""
    t0 = time.perf_counter()
    check_reppoints_small()
    seconds = {"a": time.perf_counter() - t0}
    rows = check_reppoints_kernels()
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    numbers, by_path = {}, {}
    for part, name in (("c", "v1"), ("d", "v2")):
        numbers[name], paths = check_reppoints_full(root, name)
        by_path.update(paths)
        seconds[part] = time.perf_counter() - t0 - sum(seconds.values())
    for name in ("dense_v1", "dense_v2"):
        numbers[name], paths = check_dense_full(name)
        by_path.update(paths)
    seconds["e"] = time.perf_counter() - t0 - sum(seconds.values())
    (numbers["runner"], by_path["runner RepPoints train"],
     by_path["runner RepPoints eval"]) = check_reppoints_runner(
        os.path.join(root, "runner"))
    seconds["f"] = time.perf_counter() - t0 - sum(seconds.values())
    log(f"phase 10 seconds by part {json.dumps(seconds)}")
    numbers["seconds"] = time.perf_counter() - t0
    return numbers, rows, by_path

# ---------------------------------------------------- phase 11: dense zoo

def zoo_config(name):
    return Config.fromfile(ZOO_CONFIGS[name])


def zoo_label(name):
    return (f"{ZOO_LABELS[name]} "
            f"{'VGG16' if name in ZOO_SSD else 'R50'}")


def zoo_shape(name):
    """(batch, canvas) of the file's full-width paths."""
    return (SSD_B, SSD_HW) if name in ZOO_SSD else (B, (H, W))


def narrow_zoo_cfg(name):
    """Phase 11a: the shipped file's model (R50) with a narrow neck and
    head: feat 64, two stacked convs; SSD's VGG-16 and head keep their
    fixed widths."""
    cfg = zoo_config(name).model.to_dict()
    if name in ZOO_SSD:
        return cfg
    cfg["neck"]["out_channels"] = 64
    head = head_cfg_of(cfg)
    head.update(in_channels=64, feat_channels=64)
    if "stacked_convs" in head:
        head["stacked_convs"] = 2
    return cfg


def check_zoo_small():
    """Phase 11a: each file's narrow model on the card against the CPU:
    the head outputs, then the loss, its terms and every parameter's
    gradient, at phase 3's tolerances; the SSD files on one 300x300
    image in f64 (in f32 a few of VGG-16's ReLU and max-pool decisions
    fall the other way of a rounding at init, and conv4_3's L2 norm
    divides by small norms: its convs' gradients differ by up to about
    2 %)."""
    import dataclasses
    for name in ZOO_CONFIGS:
        label = f"{zoo_label(name)}-shaped"
        ssd = name in ZOO_SSD
        hw = SSD_HW if ssd else (96, 128)
        dtype = torch.float64 if ssd else torch.float32
        batch = 1 if ssd else 2
        outputs_card_vs_cpu(label, narrow_zoo_cfg(name), hw=hw, dtype=dtype,
                            batch=batch)
        cfg = narrow_zoo_cfg(name)
        lcfg = dataclasses.replace(
            runner_loop.dense_cfg_from(zoo_config(name), hw),
            num_classes=set_classes(cfg, 8))
        gradients_card_vs_cpu(label, cfg, lcfg, hw, dtype=dtype, batch=batch)


def check_zoo_kernels():
    """Phase 11a: K1's forward, bwd-data and bwd-weight against their
    plain versions at Guided Anchoring's feature adaption (B=2, 800x1344,
    C = cout = 256, each level's job on its own level, no mask, scale 1,
    bilinear): GA-RetinaNet's five levels at strides 8 to 128 (44,800 px)
    and GA-RPN's at 4 to 64 (179,046 px). Returns the bf16 rows."""
    return check_k1_level_calls(
        "guided anchoring", [("GA-RetinaNet adaption", FEAT, LEVELS),
                             ("GA-RPN adaption", FEAT, GA_RPN_LEVELS)],
        seed=11)


def check_zoo_full(root, name):
    """Phase 11b: the shipped file at full width (R50 or SSD's VGG-16, 80
    classes, seeded weights): ``init_detector`` from a
    ``save_checkpoint`` file and ``inference_detector`` twice on a seeded
    480x640 image (equal detections; GA-RPN, which ``init_detector``
    refuses, only through ``detect``), ``detect`` at B=2 800x1344 bf16
    (the SSD files at their B=8 300x300), ZOO_TRAIN_STEPS train steps
    at the same shape (20 instances an image), each profiled, the K1
    launches asserted (ZOO_K1_PER_FORWARD a forward and of each kind a
    step). Returns (numbers, launches by path)."""
    cfg = zoo_config(name)
    label = zoo_label(name)
    batch, hw = zoo_shape(name)
    k1 = ZOO_K1_PER_FORWARD.get(name, 0)
    by_path, numbers = {}, {}
    if name == "ga_rpn":
        try:
            apis.init_detector(ZOO_CONFIGS[name], device="cuda")
        except NotImplementedError as e:
            log(f"{label}: init_detector refuses the file: {e}")
        else:
            raise AssertionError(f"{label}: init_detector served an RPN")
    else:
        path = seeded_checkpoint(cfg, os.path.join(root, name))
        bundle = apis.init_detector(ZOO_CONFIGS[name], path)
        img = api_image(3)
        first = apis.inference_detector(bundle, img)
        zero_launch_counts()
        again = apis.inference_detector(bundle, img)
        by_path[f"{label} inference_detector"] = launch_counts()
        want = {**dict.fromkeys(launch_counts(), 0),
                "deform_gather_contract": k1}
        n = len(again["scores"])
        got = by_path[f"{label} inference_detector"]
        if got != want or not n:
            raise AssertionError(f"{label} inference_detector: {n} "
                                 f"detections, launches {got}")
        same_detections(f"{label} inference_detector, second call", again,
                        first, atol=0.0)
        log(f"{label} inference_detector: {n} detections, equal on a "
            "second call")
        del bundle
        torch.cuda.empty_cache()

    model_cfg = cfg.model.to_dict()
    run, img_s, launches, peak = drive_main_path(
        label, model_cfg, 0, "bbox", k1=k1, config=cfg, batch=batch, hw=hw)
    numbers["detect"] = profile(label, run, batch / img_s * 1e3)
    numbers["img_per_s"], numbers["peak_memory_bytes"] = img_s, peak
    by_path[label] = {k: v // ITERS for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    run, img_s, launches, peak = drive_train_path(
        "bbox", model_cfg, runner_loop.train_loss_cfg(cfg, hw), k1=k1,
        steps=ZOO_TRAIN_STEPS, label=f"{label} train", grouped=0,
        warmup_iters=0, batch=batch, hw=hw)
    numbers["train"] = profile(f"{label} train step", run,
                               batch / img_s * 1e3)
    numbers["train_img_per_s"] = img_s
    numbers["train_peak_memory_bytes"] = peak
    by_path[f"{label} train"] = {k: v // ZOO_TRAIN_STEPS
                                 for k, v in launches.items()}
    del run
    torch.cuda.empty_cache()
    numbers["batch"], numbers["canvas"] = batch, list(hw)
    log(f"{label} device ms: detect {numbers['detect']['device_ms']:.3f} "
        f"a batch of {batch}, train {numbers['train']['device_ms']:.3f} a "
        "step")
    log(f"{label} device idle share: detect "
        f"{numbers['detect']['idle_share']:.3f}, train "
        f"{numbers['train']['idle_share']:.3f}")
    log(f"{label} peak memory: detect {peak_gib(numbers, ''):.2f} GiB, "
        f"train {peak_gib(numbers, 'train_'):.2f} GiB")
    log(f"{label} numbers " + json.dumps(numbers))
    return numbers, by_path


def peak_gib(numbers, prefix):
    return numbers[f"{prefix}peak_memory_bytes"] / 2 ** 30


def check_zoo(root):
    """Phase 11 (a to c). Returns (numbers, kernel rows, launches by
    path)."""
    t0 = time.perf_counter()
    check_zoo_small()
    rows = check_zoo_kernels()
    seconds = {"a": time.perf_counter() - t0}
    numbers, by_path = {}, {}
    for name in ZOO_CONFIGS:
        numbers[name], paths = check_zoo_full(root, name)
        by_path.update(paths)
    seconds["b"] = time.perf_counter() - t0 - sum(seconds.values())
    (numbers["runner"], by_path["runner GA-RetinaNet train"],
     by_path["runner GA-RetinaNet eval"]) = check_file_runner(
        "GA-RetinaNet", ZOO_CONFIGS["ga_retina"],
        ZOO_K1_PER_FORWARD["ga_retina"],
        ("loss_loc", "loss_shape", "loss_cls", "loss_bbox"),
        os.path.join(root, "runner"))
    seconds["c"] = time.perf_counter() - t0 - sum(seconds.values())
    (numbers["runner_ssd"], by_path["runner SSD300 train"],
     by_path["runner SSD300 eval"]) = check_file_runner(
        "SSD300", ZOO_CONFIGS["ssd"], 0, ("loss_cls", "loss_bbox"),
        os.path.join(root, "runner_ssd"), train_hw=SSD_RUNNER_TRAIN_HW,
        val_hw=SSD_RUNNER_VAL_HW)
    seconds["d"] = time.perf_counter() - t0 - sum(seconds.values())
    log(f"phase 11 seconds by part {json.dumps(seconds)}")
    numbers["seconds"] = time.perf_counter() - t0
    return numbers, rows, by_path


# ------------------------------------------------------------- phase 12

def leaves(x):
    """The floating-point tensors of a nest of tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        return [x] if x.is_floating_point() else []
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in leaves(v)]
    return []


def K1_ONLY(n):
    """Launch counts with each of K1's three kernels at ``n`` and the
    grouped kernels at 0 (a model without a DCN backbone)."""
    return {**dict.fromkeys(launch_counts(), 0),
            **dict.fromkeys(("deform_gather_contract",
                             "deform_gather_contract_bwd_data",
                             "deform_gather_contract_bwd_weight"), n)}


def count_k1_by_taps():
    """Phase 12: put in place of ``deform_gather``'s ops functions that
    count each K1 wrapper's calls by the table's tap count K, then call
    it. Returns the Counter of (wrapper, K) and a function that puts the
    wrappers back."""
    from collections import Counter
    seen = Counter()
    saved = dg._OPS

    def counted(name, fn):
        def call(*args):
            seen[(name, int(args[1].shape[1]))] += 1
            return fn(*args)
        return call

    dg._OPS = dg.ContractOps(*(counted(name, fn) for name, fn in
                               zip(dg.ContractOps._fields, saved)))

    def undo():
        dg._OPS = saved
    return seen, undo


def taps_counts(run, want):
    """Run ``run()`` with the K1 calls counted by tap count; raise unless
    the counts are ``want`` ({(wrapper, K): calls}). Returns run()'s
    result."""
    seen, undo = count_k1_by_taps()
    try:
        out = run()
    finally:
        undo()
    if dict(seen) != want:
        raise AssertionError(f"K1 calls by taps {dict(seen)}, want {want}")
    return out


def refine_taps_inputs(dtype, gen, taps=fd._PLUS_TAPS):
    """(args at K = 9, args at K = len(taps)) of the main path's paired
    refine contraction: the R50 bbox file's cross-level jobs at B=2,
    800x1344, C = cout = 256, bilinear, one set of feature maps and
    offsets; the K = 5 table is the one ``dual_pyramid_dcn`` builds at
    those taps."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    feats = [rnd(B, h, w, FEAT).to(dtype) for h, w in LEVELS]
    levels = fd.pack_levels(feats)
    weight = rnd(3, 3, FEAT, FEAT, scale=0.02).to(dtype)
    offs = [rnd(B, h, w, 2 * K, scale=2.0) for h, w in LEVELS]
    jobs = branch_pyramid_jobs(LEVELS, offs, 3)
    flat = levels.flat.contiguous()
    out = []
    for sel in (None, taps):
        jb, (wt,) = fd._apply_refine_taps(jobs, [weight], sel)
        k = wt.shape[0] * wt.shape[1]
        idx, w = fd._gather_indices_tap(levels, jb, k, "bilinear")
        out.append((flat, idx, w, fd._tap_weight(wt, dtype)))
    return out


def check_refine_taps_kernels():
    """Phase 12a: K1's forward, bwd-data and bwd-weight at K = 5 (the plus
    taps) against their plain versions at the R50 bbox file's paired
    refine call, f32 and bf16, at phase 2's tolerances; each kernel's
    time (CUDA events) beside K = 9 at the same call and beside its bound.
    Returns the bf16 rows."""
    gen = torch.Generator().manual_seed(12)
    cgen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        args9, args5 = refine_taps_inputs(dtype, gen)
        got = deform_gather_contract(*args5).float()
        want = deform_gather_contract_ref(*args5).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        lim = TOL[dtype] * max(1.0, want.abs().max().item())
        if not (bool(torch.isfinite(got).all()) and err <= lim):
            raise AssertionError(f"K1 forward at K = 5 disagrees: {err} > "
                                 f"{lim} ({dtype})")
        del got, want
        bf16 = dtype == torch.bfloat16
        bwd = check_backward_call(dict(site="refine", taps=5), args5, 0,
                                  cgen, library=bf16)
        px, cout = args9[1].shape[2], FEAT
        dout = torch.randn(px, cout, device="cuda",
                           generator=cgen).to(dtype)
        row = dict(dtype=str(dtype).split(".")[-1], px=px, C=FEAT,
                   cout=FEAT, forward_err=err, forward_limit=lim,
                   data_err=bwd["data_err"], weight_err=bwd["weight_err"])
        for k, args in ((5, args5), (9, args9)):
            flat, idx, w, weight = args
            calls = {
                "forward": (lambda: deform_gather_contract(*args),
                            lambda: deform_gather_contract_ref(*args),
                            work),
                "bwd_data": (lambda: dg.deform_gather_contract_bwd_data(
                    flat, idx, w, weight, dout), None, work_bwd_data),
                "bwd_weight": (
                    lambda: dg.deform_gather_contract_bwd_weight(
                        flat, idx, w, weight, dout), None, work_bwd_weight)}
            for name, (fn, plain, wk) in calls.items():
                row[f"{name}_k{k}_ms"] = cuda_ms(fn, 10)
                row[f"{name}_k{k}_bound_ms"], row[f"{name}_k{k}_bound_by"] \
                    = bound_ms(args, wk)
                if plain is not None:
                    row[f"{name}_k{k}_plain_ms"] = cuda_ms(plain, 2)
        row["data_k5_plain_ms"] = bwd["data_plain_ms"]
        row["weight_k5_plain_ms"] = bwd["weight_plain_ms"]
        if bf16:      # the yardsticks on the already gathered patch tensor
            vals = dg.gathered_rows(*args5[:3]).to(dtype)
            row["forward_k5_library_ms"] = cuda_ms(
                lambda: torch.einsum("kpc,kco->po", vals, args5[3]), 10)
            del vals
            row["weight_k5_library_ms"] = bwd["weight_library_ms"]
            row["data_k5_einsum_g_only_ms"] = bwd["data_einsum_g_only_ms"]
        for name in ("forward", "bwd_data", "bwd_weight"):
            row[f"{name}_k5_over_k9"] = (row[f"{name}_k5_ms"]
                                         / row[f"{name}_k9_ms"])
        log("refine taps 5 kernels " + json.dumps(row))
        rows[row["dtype"]] = row
        del args9, args5, dout
        torch.cuda.empty_cache()
    return rows["bfloat16"]


def refine_taps_small():
    """Phase 12b: a narrow R50-shaped model at taps 5 on the card against
    the CPU: the head outputs, then the loss and every gradient, at
    phase 3's tolerances."""
    sampling = fd.with_refine_taps(fd.TRAIN_SAMPLING, "5")
    outputs_card_vs_cpu("R50-shaped taps 5", flagship_r50_cfg(
        feat=64, stacked=2), sampling)
    hw = (96, 128)
    gradients_card_vs_cpu("R50-shaped taps 5", flagship_r50_cfg(
        feat=64, stacked=2), loss_config("bbox", hw, 8), hw, sampling)


def check_refine_taps_e2e(root):
    """Phase 12b: the shipped R50 bbox file at full width, 80 classes, with
    ``LSNET_REFINE_TAPS=5`` in the environment (set here, restored after):
    2 train steps at B=2, 800x1344, bf16 (K1 at 5 taps at the 2 refine
    contractions, at 9 at the 6 tower blocks, each way), a checkpoint
    whose meta records the taps; with the variable unset again,
    ``init_detector`` deploys it at 5 taps (``inference_detector`` on a
    480x640 image, ``detect`` at B=2). Returns the numbers."""
    cfg = Config.fromfile(R50_CONFIG)
    num_classes = cfg.model.bbox_head.num_classes
    saved_env = os.environ.get("LSNET_REFINE_TAPS")
    os.environ["LSNET_REFINE_TAPS"] = "5"
    try:
        taps = ckpt.refine_taps_env()
        sampling = fd.with_refine_taps(fd.TRAIN_SAMPLING, taps)
        model = init_model(cfg.model.to_dict(), device="cuda", seed=0,
                           train=True)
        step = train_detector_step(model, loss_config(
            "bbox", (H, W), num_classes), base_lr=0.01, sampling=sampling)
        batch = synthetic_batch(B, (H, W), NUM_GT, num_classes, 0, "cuda")
        step(batch)                                  # warm-up
        torch.cuda.synchronize()
        per_step = {(n, k): c for n in dg.ContractOps._fields
                    for k, c in ((9, 6), (5, 2))}
        zero_launch_counts()
        t0 = time.perf_counter()
        history = taps_counts(lambda: [step(batch) for _ in range(2)],
                              {key: 2 * c for key, c in per_step.items()})
        torch.cuda.synchronize()
        train_s = (time.perf_counter() - t0) / 2
        measured = launch_counts()
        if measured != K1_ONLY(16):
            raise AssertionError(f"taps 5 train: launches in 2 steps "
                                 f"{measured}, want {K1_ONLY(16)}")
        train_launches = {n: c // 2 for n, c in measured.items()}
        losses = [m["loss"].item() for m in history]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"taps 5 train: losses {losses}")
        optimizer, _ = build_optimizer(model.parameters(), 0.01, 1, (8, 11))
        path = ckpt.save_checkpoint(os.path.join(root, "taps5"), model,
                                    optimizer, 3, ckpt.train_meta(None, taps))
    finally:
        if saved_env is None:
            os.environ.pop("LSNET_REFINE_TAPS", None)
        else:
            os.environ["LSNET_REFINE_TAPS"] = saved_env
    del model, step, batch
    torch.cuda.empty_cache()
    meta = ckpt.load_checkpoint(path)["meta"]
    if meta != {"dcn_sampling_train": "bilinear", "refine_taps_train": "5"}:
        raise AssertionError(f"taps 5 checkpoint meta {meta}")
    bundle = apis.init_detector(R50_CONFIG, path)
    if fd.refine_taps(bundle.sampling) != fd._PLUS_TAPS:
        raise AssertionError(f"deployed sampling {dict(bundle.sampling)}")
    fwd = {("forward", 9): 6, ("forward", 5): 2}
    zero_launch_counts()
    res = taps_counts(lambda: apis.inference_detector(bundle, api_image()),
                      fwd)
    api_launches = launch_counts()
    want = {**K1_ONLY(0), "deform_gather_contract": 8}
    if api_launches != want:
        raise AssertionError(f"taps 5 inference_detector: launches "
                             f"{api_launches}, want {want}")
    n_api = len(res["scores"])
    model = bundle.model.to(torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    images = torch.randn(B, H, W, 3, generator=gen).to("cuda",
                                                        torch.bfloat16)
    tcfg = runner_loop.test_cfg_from(bundle.cfg, (H, W))
    zero_launch_counts()
    det = taps_counts(lambda: detect(
        model, images, torch.tensor([[H, W]] * B, device="cuda"),
        torch.ones(B, 4, device="cuda"), tcfg, bundle.sampling),
        {key: c * 1 for key, c in fwd.items()})
    detect_launches = launch_counts()
    if detect_launches != want:
        raise AssertionError(f"taps 5 detect: launches {detect_launches}, "
                             f"want {want}")
    for name, x in det._asdict().items():
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"taps 5 detect: non-finite {name}")
    numbers = dict(train_losses=losses, train_s_per_step=train_s,
                   meta=meta, api_detections=n_api,
                   detect_valid=det.valid.sum(dim=1).tolist(),
                   k1_per_train_step={f"{n} K={k}": c
                                      for (n, k), c in per_step.items()},
                   launches_per_train_step=train_launches,
                   launches_api=api_launches,
                   launches_detect=detect_launches,
                   k1_per_forward={f"K={k}": c for (_, k), c in fwd.items()})
    log("refine taps 5 e2e " + json.dumps(numbers))
    del bundle, model, images
    torch.cuda.empty_cache()
    return numbers


def robust_config(root):
    """Phase 12c: the shipped X-101-64x4d-DCN bbox file over four
    procedural 768x1280 val images (aspect 5:3, inside its 800x1344
    canvas), 3 classes, written as a config file that inherits it."""
    ann, img = make_shapes_coco(os.path.join(root, "val"), 4, seed=7,
                                hw=[LAND] * 4)
    data = dict(ann_file=ann, img_prefix=img)
    path = os.path.join(root, "robust_cfg.py")
    with open(path, "w") as f:
        f.write(f"_base_ = {RUNNER_CONFIG!r}\n"
                "model = dict(bbox_head=dict(num_classes=3))\n"
                f"data = dict(train=dict({data!r}), val=dict({data!r}), "
                f"test=dict({data!r}))\n"
                "test_cfg = dict(score_thr=0.005)\n")
    return path, ann


def check_robustness(root):
    """Phase 12c: ``lsnet_torch.tools.test_robustness`` on the X-101 file
    from a seeded checkpoint, gaussian_noise and fog at severities 0, 1
    and 5 on 4 images; K1 (8) and the grouped forward (30) launched for
    every eval batch, the json's layout, ``robustness_eval`` on it.
    Returns (numbers, config, checkpoint, ann file, json)."""
    from lsnet_torch.tools import robustness_eval as reval_tool
    from lsnet_torch.tools import test_robustness as robust_tool
    cfg_path, ann = robust_config(root)
    path = seeded_checkpoint(Config.fromfile(cfg_path),
                             os.path.join(root, "ckpt"))
    out = os.path.join(root, "robust.json")
    passes = []
    evaluate = runner_loop.evaluate_detector

    def counted_evaluate(cfg, model, *a, **k):
        sums = []

        def abs_sum(out):
            return sum(x.double().abs().sum() for x in leaves(out))

        def seen_neck(_, args, out):   # the FPN maps
            sums.append([abs_sum(out)])

        def seen(_, args, out):        # the images in, the head maps out
            sums[-1][:0] = [args[0].double().sum()]
            sums[-1].append(abs_sum(out))
        hooks = (model.neck.register_forward_hook(seen_neck),
                 model.register_forward_hook(seen))
        zero_launch_counts()
        t0 = time.perf_counter()
        try:
            metrics = evaluate(cfg, model, *a, **k)
            torch.cuda.synchronize()
        finally:
            for hook in hooks:
                hook.remove()
        seconds = time.perf_counter() - t0
        passes.append((cfg.data.val.get("corruption"), seconds,
                       launch_counts(),
                       [[x.item() for x in batch] for batch in sums]))
        return metrics
    runner_loop.evaluate_detector = counted_evaluate
    try:
        results = robust_tool.main([
            cfg_path, path, "--out", out, "--corruptions", "gaussian_noise",
            "fog", "--severities", "0", "1", "5", "--max-images", "4"])
    finally:
        runner_loop.evaluate_detector = evaluate
    batches = 1                               # 4 landscape images, batch 8
    want = dict.fromkeys(launch_counts(), 0)
    want.update({"deform_gather_contract": 8 * batches,
                 "deform_gather_grouped_contract":
                     GROUPED_PER_FORWARD * batches})
    if len(passes) != 5 or any(c != want for _, _, c, _ in passes):
        raise AssertionError(f"robustness passes {passes}, want 5 passes "
                             f"of {want}")
    # each corrupted pass saw other images than the clean pass and its
    # other severity, and its FPN and head maps changed with them
    clean = passes[0][3]
    for name, i in (("gaussian_noise", 1), ("fog", 3)):
        (c1, _, _, s1), (c5, _, _, s5) = passes[i], passes[i + 1]
        if (c1, c5) != ([name, 1], [name, 5]) or len(s1) != len(clean) or \
                any(u == v for x, y in ((s1, clean), (s5, clean), (s1, s5))
                    for a, b in zip(x, y) for u, v in zip(a, b)):
            raise AssertionError(f"robustness: {name} passes "
                                 f"{passes[i]}, {passes[i + 1]} against the "
                                 f"clean pass {passes[0]}")
    with open(out) as f:
        saved = json.load(f)
    if list(saved) != ["gaussian_noise", "fog"] or any(
            list(v) != ["0", "1", "5"] for v in saved.values()) or \
            saved["fog"]["0"] != saved["gaussian_noise"]["0"] or any(
            len(m) != 12 for v in saved.values() for m in v.values()):
        raise AssertionError(f"robustness json layout {saved}")
    lines = []
    agg = reval_tool.get_results(out, prints=("P", "mPC", "rPC"),
                                 echo=lines.append)
    for line in lines:
        log("robustness_eval " + line)
    clean_s = passes[0][1]
    corr_s = sum(s for _, s, _, _ in passes[1:]) / len(passes[1:])
    numbers = dict(clean_img_per_s=4 / clean_s,
                   corrupted_img_per_s=4 / corr_s,
                   launches_per_eval_batch=passes[0][2],
                   image_fpn_head_sums={
                       "clean" if c is None else f"{c[0]} {c[1]}": sums
                       for c, _, _, sums in passes},
                   bbox_mAP={c: {s: m["bbox_mAP"] for s, m in v.items()}
                             for c, v in saved.items()},
                   P_mPC_rPC=agg["bbox_mAP"])
    log("robustness " + json.dumps(numbers))
    return numbers, cfg_path, path, ann, results


def coco_detections(bundle, ann):
    """``inference_detector``'s detections on every image of ``ann`` as
    COCO result dicts (category id = label + 1, boxes x, y, w, h)."""
    from PIL import Image as PILImage
    with open(ann) as f:
        images = json.load(f)["images"]
    root = os.path.join(os.path.dirname(ann), "imgs")
    dts = []
    for info in images:
        with PILImage.open(os.path.join(root, info["file_name"])) as im:
            res = apis.inference_detector(bundle, np.asarray(im))
        for box, lab, sc in zip(res["bboxes"], res["labels"],
                                res["scores"]):
            x0, y0, x1, y1 = (float(v) for v in box[:4])
            dts.append(dict(image_id=info["id"], category_id=int(lab) + 1,
                            bbox=[x0, y0, x1 - x0, y1 - y0],
                            score=float(sc)))
    return dts


def check_tools(root, cfg_path, path, ann, log_dir):
    """Phase 12d: the other tools once each, on the card where they build
    a model: print_config, get_flops (the X-101 file at 800x1344; phase
    3's narrow model the same on the card and the CPU), fuse_conv_bn and
    publish_model on phase 12c's checkpoint (the same detections through
    ``init_detector``), analyze_logs on a runner log, browse_dataset,
    coco_error_analysis on 12c's clean detections and gen_coco_lsvr.
    Returns the numbers."""
    import contextlib
    import io
    from lsnet_torch.tools import (analyze_logs, browse_dataset,
                                   coco_error_analysis, fuse_conv_bn,
                                   gen_coco_lsvr, get_flops, print_config,
                                   publish_model)
    numbers = {}

    def quiet(fn, *a):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out = fn(*a)
        return out, text.getvalue()

    cfg, text = quiet(print_config.main, [RUNNER_CONFIG])
    if not text.startswith("Config:\n") or "ResNeXt" not in text:
        raise AssertionError("print_config: unexpected text")
    log(f"tool print_config OK: {len(text.splitlines())} lines")

    t0 = time.perf_counter()
    params, flops = get_flops.count(cfg, (H, W), "cuda")
    numbers["x101_params"], numbers["x101_gflops"] = params, flops / 1e9
    narrow = Config(dict(model=flagship_r50_cfg(feat=64, stacked=2)))
    small = {dev: get_flops.count(narrow, (128, 192), dev)
             for dev in ("cpu", "cuda")}
    if small["cpu"] != small["cuda"]:
        raise AssertionError(f"get_flops: card {small['cuda']} vs CPU "
                             f"{small['cpu']}")
    log(f"tool get_flops OK: X-101-64x4d-DCN at {H}x{W}: "
        f"{params / 1e6:.2f} M parameters, {flops / 1e9:.2f} GFLOPs; narrow "
        f"R50-shaped at 128x192 {small['cuda']} on the card and the CPU "
        f"({time.perf_counter() - t0:.1f}s)")

    img = api_image(4)
    want = apis.inference_detector(apis.init_detector(cfg_path, path), img)
    fused = os.path.join(root, "fused.pt")
    names, _ = quiet(fuse_conv_bn.main, [path, fused])
    err = same_detections("fuse_conv_bn", apis.inference_detector(
        apis.init_detector(cfg_path, fused), img), want)
    log(f"tool fuse_conv_bn OK: {len(names)} pairs fused, "
        f"{len(want['scores'])} detections as unfused (max box error "
        f"{err:.3g} px)")
    final, _ = quiet(publish_model.main,
                     [path, os.path.join(root, "x101_robust.pth")])
    err = same_detections("publish_model", apis.inference_detector(
        apis.init_detector(cfg_path, final), img), want)
    log(f"tool publish_model OK: {os.path.basename(final)}, "
        f"{os.path.getsize(final)} bytes (checkpoint "
        f"{os.path.getsize(path)}), same detections (max box error "
        f"{err:.3g} px)")

    (log_path,) = [os.path.join(log_dir, n) for n in os.listdir(log_dir)
                   if n.endswith(".log.json")]
    times, text = quiet(analyze_logs.main, ["cal_train_time", log_path])
    if times is None:
        raise AssertionError("analyze_logs: no timing records")
    log(f"tool analyze_logs OK: {text.strip()}")

    written, _ = quiet(browse_dataset.main, [
        cfg_path, "--output-dir", os.path.join(root, "browse"),
        "--number", "2"])
    if len(written) != 2 or not all(map(os.path.exists, written)):
        raise AssertionError(f"browse_dataset wrote {written}")
    log(f"tool browse_dataset OK: {[os.path.basename(p) for p in written]}")

    bundle = apis.init_detector(cfg_path, path)
    dts = coco_detections(bundle, ann)
    res = os.path.join(root, "clean_dets.json")
    with open(res, "w") as f:
        json.dump(dts, f)
    (_, _, summary), _ = quiet(coco_error_analysis.analyze_files, res, ann)
    bands = summary["bbox"]
    if list(bands) != ["C75", "C50", "Loc", "Sim", "Oth", "BG", "FN"] or \
            bands["FN"] != 1.0:
        raise AssertionError(f"coco_error_analysis bands {bands}")
    log(f"tool coco_error_analysis OK: {len(dts)} clean detections, bands "
        f"{json.dumps(bands)}")

    n, _ = quiet(gen_coco_lsvr.main, [ann, os.path.join(root, "lsvr.json")])
    with open(os.path.join(root, "lsvr.json")) as f:
        anns = json.load(f)["annotations"]
    if n != len(anns) or any(len(a["extreme_points"]) != 10 for a in anns):
        raise AssertionError("gen_coco_lsvr: bad annotations")
    log(f"tool gen_coco_lsvr OK: {n} annotations")
    return numbers


def check_refine_taps_and_tools(root, log_dir):
    """Phase 12. Returns (numbers, the K1 rows at K = 5)."""
    t0 = time.perf_counter()
    rows = check_refine_taps_kernels()
    refine_taps_small()
    numbers = {"taps5": check_refine_taps_e2e(root)}
    numbers["robustness"], cfg_path, path, ann, _ = check_robustness(root)
    numbers["tools"] = check_tools(root, cfg_path, path, ann, log_dir)
    numbers["seconds"] = time.perf_counter() - t0
    return numbers, rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["backward", "probes", "accuracy",
                                           "api", "cpv", "reppoints",
                                           "dense", "tools"],
                        default=None,
                        help="run phases 2c and 2d, phase 2e, phase 7, "
                        "phase 2a's Res2Net cases and phase 8, phase 9, "
                        "phase 10, phase 11 or phase 12 alone; no result "
                        "line")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if LOG_PATH:
        os.makedirs(os.path.dirname(os.path.abspath(LOG_PATH)), exist_ok=True)
        open(LOG_PATH, "w").close()
    t_start = t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(_build.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, out in logs.items():
        log(f"nvcc {name}:\n{out.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    # f32 checks need full f32: TF32 off for matmuls and cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if opts.only == "backward":
        check_backward_kernels()
        check_grouped_backward_kernels(
            logs.get("grouped_deform_contract_bwd_weight", ""))
        log(f"partial run (--only backward) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "probes":
        check_probe_kernels()
        log(f"partial run (--only probes) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "accuracy":
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            *_, acc = check_accuracy_run(root)
        log(f"{smi}: accuracy_run R50-DCN bbox " + json.dumps(acc))
        log(f"partial run (--only accuracy) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "api":
        import tempfile
        check_res2net_kernel()
        with tempfile.TemporaryDirectory() as root:
            numbers, by_path = check_api(root)
        log(f"{smi}: api " + json.dumps(numbers))
        log("launches per call " + json.dumps(by_path))
        log(f"partial run (--only api) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "cpv":
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            numbers, rows, by_path = check_cpv(root)
        log(f"{smi}: cpv " + json.dumps(numbers))
        log("cpv kernel rows " + json.dumps(rows))
        log("launches per call or step " + json.dumps(by_path))
        log(f"partial run (--only cpv) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "reppoints":
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            numbers, rows, by_path = check_reppoints(root)
        log(f"{smi}: reppoints " + json.dumps(numbers))
        log("reppoints kernel rows " + json.dumps(rows))
        log("launches per call or step " + json.dumps(by_path))
        log(f"partial run (--only reppoints) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "dense":
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            numbers, rows, by_path = check_zoo(root)
        log(f"{smi}: dense " + json.dumps(numbers))
        log("dense kernel rows " + json.dumps(rows))
        log("launches per call or step " + json.dumps(by_path))
        log(f"partial run (--only dense) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0
    if opts.only == "tools":
        import tempfile
        with tempfile.TemporaryDirectory() as root:
            narrow_runner("cuda", os.path.join(root, "runner"))
            numbers, rows = check_refine_taps_and_tools(
                os.path.join(root, "tools"),
                os.path.join(root, "runner", "work_cuda"))
        log(f"{smi}: tools " + json.dumps(numbers))
        log(f"{smi}: K1 at refine taps 5 " + json.dumps(rows))
        log(f"partial run (--only tools) passed in "
            f"{time.perf_counter() - t_start:.1f}s; no result line")
        return 0

    fwd, max_err = check_kernel()
    res2_rows, res2_fwd, res2_err = check_res2net_kernel()
    gfwd, gmax_err = check_grouped_kernel(
        logs.get("grouped_deform_contract", ""))
    bwd = check_backward_kernels()
    gbwd = check_grouped_backward_kernels(
        logs.get("grouped_deform_contract_bwd_weight", ""))
    probe_entries = check_probe_kernels()
    check_small_against_cpu()
    for task in NUM_VECTORS:
        check_small_gradients(task)

    # every path is driven with the launch counts set to 0 just before it
    # and read just after; by_path keeps each path's counts per batch or
    # step
    e2e, peaks, by_path = {}, {}, {}
    for label, cfg, grouped, task in (
            ("R50", flagship_r50_cfg(), 0, "bbox"),
            ("X-101-64x4d-DCN", x101_flagship_cfg(), GROUPED_PER_FORWARD,
             "bbox"),
            ("X-101-64x4d-DCN segm", configs.x101_segm_cfg(),
             GROUPED_PER_FORWARD, "segm"),
            ("X-101-64x4d-DCN pose_bbox", configs.x101_pose_bbox_cfg(),
             GROUPED_PER_FORWARD, "pose_bbox")):
        run, img_s, launches, peak = drive_main_path(label, cfg, grouped,
                                                     task)
        profile(label, run, B / img_s * 1e3)
        e2e[label], peaks[label] = img_s, peak
        by_path[label] = {k: v // ITERS for k, v in launches.items()}
        del run
        torch.cuda.empty_cache()

    for task, cfg in (("bbox", x101_flagship_cfg()),
                      ("pose_bbox", configs.x101_pose_bbox_cfg())):
        label = f"X-101-64x4d-DCN {task} train"
        run, img_s, launches, peak = drive_train_path(task, cfg)
        card_state(f"before the profiled {task} train step")
        profile(f"X-101 {task} train step", run, B / img_s * 1e3)
        card_state(f"after the profiled {task} train step")
        e2e[label], peaks[label] = img_s, peak
        by_path[label] = {k: v // TRAIN_STEPS for k, v in launches.items()}
        del run
        torch.cuda.empty_cache()
    # phase 6: the runner
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        check_narrow_runner(os.path.join(root, "narrow"))
        numbers, by_path["runner train"], by_path["runner eval"] = \
            check_runner(os.path.join(root, "full"))
        log(f"{smi}: runner X-101-64x4d-DCN bbox " + json.dumps(numbers)
            + f" (phase 6 in {time.perf_counter() - t0:.1f}s)")
        # phase 7: a short accuracy run
        t0 = time.perf_counter()
        (by_path["accuracy_run train"], by_path["accuracy_run eval"],
         acc) = check_accuracy_run(os.path.join(root, "accuracy"))
        log(f"{smi}: accuracy_run R50-DCN bbox " + json.dumps(acc)
            + f" (phase 7 in {time.perf_counter() - t0:.1f}s)")
        # phase 8: the image-level API
        t0 = time.perf_counter()
        api_numbers, api_paths = check_api(os.path.join(root, "api"))
        by_path.update(api_paths)
        log(f"{smi}: api Res2Net-101-DCN segm " + json.dumps(api_numbers)
            + f" (phase 8 in {time.perf_counter() - t0:.1f}s)")
        # phase 9: LSNet-CPV, and Res2Net training
        cpv_numbers, cpv_rows, cpv_paths = check_cpv(os.path.join(root,
                                                                  "cpv"))
        by_path.update(cpv_paths)
        e2e["X-101-64x4d-DCN CPV"] = cpv_numbers["img_per_s"]
        e2e["X-101-64x4d-DCN CPV train"] = cpv_numbers["train_img_per_s"]
        log(f"{smi}: cpv " + json.dumps(cpv_numbers)
            + f" (phase 9 in {cpv_numbers['seconds']:.1f}s)")
        # phase 10: the RepPoints family
        rp_numbers, rp_rows, rp_paths = check_reppoints(
            os.path.join(root, "reppoints"))
        by_path.update(rp_paths)
        for name, label in (("v1", "RepPoints v1 R50"),
                            ("v2", "RepPoints v2 R50"),
                            ("dense_v1", "Dense RepPoints v1 R50"),
                            ("dense_v2", "Dense RepPoints v2 R50")):
            e2e[label] = rp_numbers[name]["img_per_s"]
            e2e[f"{label} train"] = rp_numbers[name]["train_img_per_s"]
            peaks[label] = rp_numbers[name]["peak_memory_bytes"]
            peaks[f"{label} train"] = \
                rp_numbers[name]["train_peak_memory_bytes"]
        log(f"{smi}: reppoints " + json.dumps(rp_numbers)
            + f" (phase 10 in {rp_numbers['seconds']:.1f}s)")
        # phase 11: the dense zoo
        zoo_numbers, zoo_rows, zoo_paths = check_zoo(
            os.path.join(root, "dense"))
        by_path.update(zoo_paths)
        for name in ZOO_LABELS:
            label = zoo_label(name)
            e2e[label] = zoo_numbers[name]["img_per_s"]
            e2e[f"{label} train"] = zoo_numbers[name]["train_img_per_s"]
            peaks[label] = zoo_numbers[name]["peak_memory_bytes"]
            peaks[f"{label} train"] = \
                zoo_numbers[name]["train_peak_memory_bytes"]
        log(f"{smi}: dense " + json.dumps(zoo_numbers)
            + f" (phase 11 in {zoo_numbers['seconds']:.1f}s)")
        # phase 12: refine taps 5, the robustness benchmark, the tools
        tools_numbers, taps_rows = check_refine_taps_and_tools(
            os.path.join(root, "tools"), os.path.join(root, "full", "A"))
        e2e["X-101-64x4d-DCN robustness clean eval"] = \
            tools_numbers["robustness"]["clean_img_per_s"]
        e2e["X-101-64x4d-DCN robustness corrupted eval"] = \
            tools_numbers["robustness"]["corrupted_img_per_s"]
        log(f"{smi}: tools " + json.dumps(tools_numbers)
            + f" (phase 12 in {tools_numbers['seconds']:.1f}s)")
        taps5 = tools_numbers["taps5"]
        by_path["taps 5 train"] = taps5["launches_per_train_step"]
        by_path["taps 5 inference_detector"] = taps5["launches_api"]
        by_path["taps 5 detect"] = taps5["launches_detect"]
        by_path["robustness eval"] = \
            tools_numbers["robustness"]["launches_per_eval_batch"]
    for name, entry in probe_entries.items():
        by_path.setdefault("lsnet_torch.tools.probe", {})[name] = \
            entry["launches"]
    log("launches per batch or step " + json.dumps(by_path))

    # "launches": the counts of the heaviest path, the pose_bbox
    # train steps (TRAIN_STEPS steps through all six kernels), and of the
    # probe tool for the probes; the rows of every other path are in
    # launches_by_path. Forward times are per forward of the bbox
    # inference path as before (6 tower + 2 refine calls), backward times
    # per bbox train step; pose_bbox_ms is the same for pose_bbox (9 tower
    # + 3 refine calls).
    def path_counts(name):
        return {path: counts[name] for path, counts in by_path.items()
                if counts.get(name)}

    def pose_bbox_ms(per_call):
        return 9 * per_call["tower"]["ms"] + 3 * per_call["refine"]["ms"]

    def cpv_entry(kind):
        """Phase 9b's bf16 bilinear rows of one K1 kernel (kind forward,
        data or weight) by shape: events ms, device us, padding us, plain
        ms, bound, library ms."""
        lib = {"fwd": "fwd_library_ms", "data": "data_einsum_g_only_ms",
               "weight": "weight_library_ms"}[kind]
        dev = {"fwd": "forward", "data": "bwd_data",
               "weight": "bwd_weight"}[kind]
        return {label: {
            "C": row["C"], "cout": row["cout"], "px": row["px"],
            "ms": row[f"{kind}_ms"], "device_us": row["device_us"][dev],
            "padding_device_us": row["device_us"]["padding"],
            "plain_ms": row[f"{kind}_plain_ms"],
            "bound_ms": row[f"{kind}_bound_ms"],
            "bound_by": row[f"{kind}_bound_by"], "library_ms": row[lib]}
            for label, row in cpv_rows.items()}

    def rp_entry(kind, rows=None):
        """Phase 10b's bf16 rows of one K1 kernel (kind fwd, data or
        weight) at RepPoints' paired call, v1 and v2 (phase 11a's at
        Guided Anchoring's adaption with ``rows=zoo_rows``)."""
        lib = {"fwd": "fwd_library_ms", "data": "data_einsum_g_only_ms",
               "weight": "weight_library_ms"}[kind]
        dev = {"fwd": "forward", "data": "bwd_data",
               "weight": "bwd_weight"}[kind]
        return {label: {
            "C": row["C"], "cout": row["cout"], "px": row["px"],
            "ms": row[f"{kind}_ms"], "device_us": row["device_us"][dev],
            "padding_device_us": row["device_us"]["padding"],
            "plain_ms": row[f"{kind}_plain_ms"],
            "bound_ms": row[f"{kind}_bound_ms"],
            "bound_by": row[f"{kind}_bound_by"], "library_ms": row[lib]}
            for label, row in (rp_rows if rows is None else rows).items()}

    def taps_entry(kind):
        """Phase 12a's bf16 row of one K1 kernel (kind forward, bwd_data
        or bwd_weight) at the paired refine call at K = 5, beside K = 9."""
        row = taps_rows
        plain = {"forward": "forward_k5_plain_ms",
                 "bwd_data": "data_k5_plain_ms",
                 "bwd_weight": "weight_k5_plain_ms"}[kind]
        library = {"forward": "forward_k5_library_ms",
                   "bwd_weight": "weight_k5_library_ms"}.get(kind)
        return {"px": row["px"], "ms": row[f"{kind}_k5_ms"],
                "plain_ms": row[plain],
                "library_ms": row[library] if library else None,
                "einsum_g_only_ms": row["data_k5_einsum_g_only_ms"]
                if kind == "bwd_data" else None,
                "bound_ms": row[f"{kind}_k5_bound_ms"],
                "bound_by": row[f"{kind}_k5_bound_by"],
                "k9_ms": row[f"{kind}_k9_ms"],
                "k9_bound_ms": row[f"{kind}_k9_bound_ms"],
                "k5_over_k9": row[f"{kind}_k5_over_k9"]}

    def bwd_entry(name, source, replaces, row):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                 "bound_by": row["bound_by"],
                 "library_ms": row.get("library_ms"),
                 "launches_by_path": path_counts(name)}
        for key in ("einsum_g_only_ms", "device_ms", "ptxas"):
            if key in row:
                entry[key] = row[key]
        if name.startswith("deform_gather_contract_bwd"):
            entry["cpv_res2net_per_call"] = cpv_entry(
                name.rsplit("_", 1)[1])
            entry["reppoints_per_call"] = rp_entry(name.rsplit("_", 1)[1])
            entry["guided_anchoring_per_call"] = rp_entry(
                name.rsplit("_", 1)[1], zoo_rows)
            entry["refine_taps5_per_call"] = taps_entry(
                "bwd_" + name.rsplit("_", 1)[1])
        if "per_call" in row:
            entry["pose_bbox_ms"] = pose_bbox_ms(row["per_call"])
            entry["per_call"] = row["per_call"]
        return entry

    kernels = [{
        "name": "deform_gather_contract", "route": "cuda",
        "source": "lsnet_torch/csrc/deform_gather_contract.cu",
        "replaces": "lsnet_tpu/ops/pallas_dma_gather.py:128",
        "launches": launches["deform_gather_contract"],
        "max_abs_err": max_err,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "pose_bbox_ms": pose_bbox_ms(fwd["per_call"]),
        "per_call": fwd["per_call"],
        "res2net_max_abs_err": res2_err,
        "res2net_forward_ms": res2_fwd,
        "res2net_per_call": {
            f"{st} C={row['C']} stride {stride}": {
                k: row[k] for k in ("px", "ms", "device_us", "pad_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}
            for (st, stride), row in res2_rows.items()},
        "cpv_res2net_per_call": cpv_entry("fwd"),
        "reppoints_per_call": rp_entry("fwd"),
        "guided_anchoring_per_call": rp_entry("fwd", zoo_rows),
        "refine_taps5_per_call": taps_entry("forward"),
        "launches_by_path": path_counts("deform_gather_contract")}, {
        "name": "deform_gather_grouped_contract", "route": "cuda",
        "source": "lsnet_torch/csrc/grouped_deform_contract.cu",
        "replaces": "lsnet_tpu/ops/pallas_grouped.py:98",
        "launches": launches["deform_gather_grouped_contract"],
        "max_abs_err": gmax_err,
        "ms": gfwd["ms"], "plain_ms": gfwd["plain_ms"],
        "bound_ms": gfwd["bound_ms"], "bound_by": gfwd["bound_by"],
        "library_ms": gfwd["library_ms"],
        "train_forward_ms": gbwd["forward_bilinear_ms"],
        "device_ms": gfwd["device_ms"],
        "train_device_ms": gfwd["train_device_ms"],
        "ptxas": gfwd["ptxas_gdc_bf16"],
        "launches_by_path": path_counts("deform_gather_grouped_contract")},
        bwd_entry("deform_gather_contract_bwd_data",
                  "lsnet_torch/csrc/deform_gather_contract_bwd_data.cu",
                  "lsnet_tpu/ops/pallas_dma_gather.py:184", bwd["data"]),
        bwd_entry("deform_gather_contract_bwd_weight",
                  "lsnet_torch/csrc/deform_gather_contract_bwd_weight.cu",
                  "lsnet_tpu/ops/pallas_dma_gather.py:184", bwd["weight"]),
        bwd_entry("deform_gather_grouped_contract_bwd_data",
                  "lsnet_torch/csrc/grouped_deform_contract_bwd_data.cu",
                  "lsnet_tpu/ops/pallas_grouped.py:113", gbwd["data"]),
        bwd_entry("deform_gather_grouped_contract_bwd_weight",
                  "lsnet_torch/csrc/grouped_deform_contract_bwd_weight.cu",
                  "lsnet_tpu/ops/pallas_grouped.py:127", gbwd["weight"]),
        *probe_entries.values()]
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was never launched on "
                                 "its path")
    log(json.dumps({"e2e_img_per_s": e2e, "batch": B,
                    "image": [H, W], "dtype": "bfloat16",
                    "peak_memory_bytes": peaks, "card": smi,
                    "profiles_taken_again": len(LOST_PROFILES),
                    "seconds": time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
