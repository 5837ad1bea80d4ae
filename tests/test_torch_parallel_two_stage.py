"""Data parallelism of the mask, cascade and grid families on the CPU:
two gloo ranks against one process on the global batch
(``lsnet_torch/tools/dist_check.py``, as ``test_torch_parallel.py`` holds
the other families).

Narrow copies of the Mask R-CNN, Mask Scoring R-CNN, PointRend, Cascade
R-CNN, Grid R-CNN and HTC files (each test file's own narrow copy: R18,
FPN 16, 3 classes, 64x96) take their first 2 f32 steps (the files'
warm-up) on global batches of 4 procedural images whose two shards hold
different numbers of GTs. Their losses divide by the global batch's
counts (sampled RoIs, positives of the mask, MaskIoU, point and grid
terms; HTC's semantic mean), so every parameter and metric of both ranks
equals the one-process steps within 1e-5 of max(1, max |ref|) (PointRend
1e-4, ``FAMILY_TOL``) and every update within 1e-3 of the largest
(``dist_check.UPDATE_TOL``). DetectoRS
trains on Cascade R-CNN's loss (its narrow copy's training init
overflows: ``grad_norm`` inf in one process too). One spawn of two ranks
runs every job, joined within its own time limit.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_cascade as cascade_tests
import test_torch_grid_htc as grid_htc_tests
import test_torch_mask_rcnn as mask_tests
from lsnet_torch.tools import dist_check
from lsnet_torch.utils.config import Config

torch.set_num_threads(1)

HW = (64, 96)
WORLD, STEPS = 2, 2
TOL = 1e-5
# PointRend's second step: each RoI's 196 most uncertain cells are a top-k
# of logits each rank computes on its own sub-batch, and a near-tie there
# moves grad_norm by 4e-5 of itself while every loss term agrees to 1e-6
FAMILY_TOL = {"point_rend": 1e-4}
# family -> (the test module whose narrow copy it takes, its name there)
FAMILIES = {"mask_rcnn": (mask_tests, "mask"), "ms_rcnn": (mask_tests, "ms"),
            "point_rend": (mask_tests, "point_rend"),
            "cascade_rcnn": (cascade_tests, "cascade"),
            "grid_rcnn": (grid_htc_tests, "grid"),
            "htc": (grid_htc_tests, "htc")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp2"))
    jobs = {}
    for name, (module, key) in FAMILIES.items():
        work = os.path.join(root, name)
        os.makedirs(work)
        path, _ = module._config(Config, work, key, 2)
        jobs[name] = dist_check.file_job(path, HW, 8, WORLD, STEPS, None,
                                         work, seed=4)
    alone = {name: dist_check.run_steps(job) for name, job in jobs.items()}
    names = sorted(jobs)
    ranked = dist_check.run_ranks([jobs[n] for n in names], WORLD,
                                  os.path.join(root, "ranks"),
                                  timeout=240.0)
    return dict(jobs=jobs, alone=alone, ranks=dict(zip(names, ranked)))


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_two_ranks_step_as_one_process(runs, name):
    job = runs["jobs"][name]
    counts = [[int(b["gt_valid"][r * 2:(r + 1) * 2].sum())
               for r in range(WORLD)] for b in job["batches"]]
    assert len(counts) == STEPS and all(a != b for a, b in counts), counts
    alone, ranks = runs["alone"][name], runs["ranks"][name]
    errs = dist_check.compare(ranks, alone, job["state"])
    assert errs["between_ranks"] == 0.0, errs
    assert dist_check.within(errs, FAMILY_TOL.get(name, TOL)), errs
    assert any(not torch.equal(p, job["state"][n])
               for n, p in alone["params"].items())
    for m in alone["metrics"]:
        assert all(np.isfinite(v) for v in m.values()), m
    if "mask" in name or name in ("ms_rcnn", "point_rend"):
        assert alone["metrics"][0]["loss_mask"] > 0
