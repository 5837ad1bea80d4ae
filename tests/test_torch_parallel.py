"""Data parallelism (``lsnet_torch.parallel``, ``tools/dist_check.py``)
against one process on the global batch and against the JAX package's
mesh step, on the CPU.

* ``collect_results``' wire format round-trips ragged per-rank payloads
  in rank order, through the port's and the JAX package's pack and merge
  alike; one process is the identity, as every helper is.
* The bootstrap is a no-op without a launcher, and raises where one was
  asked for and fails (no environment, a bad port, no card for NCCL, a
  store nobody serves).
* Two gloo ranks (spawned processes, a ``file://`` store in ``tmp_path``,
  each joined within its own time limit) take 2 f32 steps of narrow
  copies of LSNet bbox, Faster R-CNN, Dynamic R-CNN, FoveaBox (its
  classification loss divides by the global positives plus the global
  batch) and RetinaNet, on global batches of 4 whose two shards hold
  different numbers of GTs, hence of positives, at lr 0.01 from the first
  step. Every parameter and metric equals the one-process steps on the
  global batches within 1e-5 of max(1, max |ref|), every update within
  1e-3 of the largest (``dist_check.UPDATE_TOL``: f32 gradients), and
  the two ranks hold the same parameters.
* LSNet bbox's first loss equals JAX's ``make_train_step(mesh=
  make_mesh(n_data=2))`` on the same batch from the same variables
  (1e-5 relative), which is JAX's one-device loss on the global batch.
* The mask, cascade and grid families are held in
  ``test_torch_parallel_two_stage.py``, the tools in
  ``test_torch_dist_tools.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from lsnet_torch import parallel
from lsnet_torch.configs import flagship_r50_cfg
from lsnet_torch.core.loss import LossConfig
from lsnet_torch.models import build_detector
from lsnet_torch.parallel import mesh as pmesh
from lsnet_torch.tools import dist_check
from lsnet_torch.weights import load_jax_variables
from lsnet_tpu.core.loss import LossConfig as JLossConfig
from lsnet_tpu.models import build_detector as j_build
from lsnet_tpu.ops import flat_deform as jfd
from lsnet_tpu.parallel import mesh as jmesh
from lsnet_tpu.train import optim as joptim
from lsnet_tpu.train.step import create_train_state
from lsnet_tpu.train.step import make_train_step as j_make_train_step
from torch_port_util import mint_variables, to_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
WORLD, STEPS, C = 2, 2, 3
TOL = 1e-5
# the narrow copies: R18, FPN 32 (16 for the two-stage files), 3 classes
DENSE = dict(feat=32)
FILES = {"retinanet": "retinanet/retinanet_r50_fpn_1x_coco.py",
         "foveabox": "foveabox/fovea_r50_fpn_4x4_1x_coco.py",
         "faster_rcnn": "faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py",
         "dynamic_rcnn": "dynamic_rcnn/dynamic_rcnn_r50_fpn_1x.py"}
OPTIM = dict(base_lr=0.01, steps_per_epoch=STEPS, decay_epochs=[],
             clip_norm=35.0, warmup_iters=0)
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK")


def _options(name):
    common = {"model.pretrained": None, "model.backbone.depth": 18,
              "model.backbone.frozen_stages": -1,
              "model.neck.in_channels": [64, 128, 256, 512],
              "data.samples_per_gpu": 2, "data.train.img_scale": HW[::-1],
              "canvas_shape": HW, "max_instances": 8}
    if name in ("faster_rcnn", "dynamic_rcnn"):
        return {**common, "model.neck.out_channels": 16,
                "model.rpn_head.in_channels": 16,
                "model.rpn_head.feat_channels": 16,
                "model.roi_head.bbox_head.fc_out_channels": 32,
                "train_cfg.rpn.sampler.num": 64,
                "train_cfg.rpn_proposal.nms_pre": 200,
                "train_cfg.rpn_proposal.max_per_img": 32,
                "train_cfg.rcnn.sampler.num": 16}
    return {**common, "model.neck.out_channels": DENSE["feat"],
            "model.bbox_head.in_channels": DENSE["feat"],
            "model.bbox_head.feat_channels": DENSE["feat"],
            "model.bbox_head.stacked_convs": 2}


def _lsnet_job(batches):
    """The narrow LSNet bbox model (``test_torch_train.py``'s R50 cut on
    R18) from JAX-minted variables; (job, JAX model, variables)."""
    jcfg, tcfg = _flagship_cfg(feat=32, stacked=1), flagship_r50_cfg(
        feat=32, stacked=1)
    for cfg in (jcfg, tcfg):
        cfg["backbone"]["depth"] = 18
        cfg["bbox_head"]["num_classes"] = C
    jmodel, _ = j_build(jcfg)
    v = mint_variables(jmodel, jnp.zeros((1, *HW, 3), jnp.float32), seed=5)
    model = build_detector(tcfg)
    load_jax_variables(model, v)
    job = dict(model_cfg=tcfg, state=model.state_dict(),
               loss_cfg=LossConfig(image_shape=HW, num_classes=C),
               optim=OPTIM, batches=batches)
    return job, jmodel, v


def _shard_gts(batch):
    return [int(batch["gt_valid"][r * 2:(r + 1) * 2].sum())
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every family's job, its one-process steps and its two ranks' (one
    spawn of two ranks for all the jobs)."""
    root = str(tmp_path_factory.mktemp("dp"))
    jobs = {name: dist_check.file_job(
        os.path.join(REPO, "configs", path), HW, 8, WORLD, STEPS, C,
        os.path.join(root, name), options=_options(name), seed=4)
        for name, path in FILES.items()}
    for job in jobs.values():       # full steps: the parameters move
        job["optim"] = OPTIM
    lsnet, jmodel, v = _lsnet_job(jobs["retinanet"]["batches"])
    jobs["lsnet_bbox"] = lsnet
    alone = {name: dist_check.run_steps(job) for name, job in jobs.items()}
    names = sorted(jobs)
    ranked = dist_check.run_ranks([jobs[n] for n in names], WORLD,
                                  os.path.join(root, "ranks"),
                                  timeout=150.0)
    return dict(jobs=jobs, alone=alone, ranks=dict(zip(names, ranked)),
                jax=(jmodel, v))


@pytest.mark.parametrize("name", sorted([*FILES, "lsnet_bbox"]))
def test_two_ranks_step_as_one_process(runs, name):
    job = runs["jobs"][name]
    counts = [_shard_gts(b) for b in job["batches"]]
    assert len(counts) == STEPS and all(a != b for a, b in counts), counts
    alone, ranks = runs["alone"][name], runs["ranks"][name]
    assert len(ranks) == WORLD
    errs = dist_check.compare(ranks, alone, job["state"])
    assert errs["between_ranks"] == 0.0, errs
    assert dist_check.within(errs, TOL), errs
    # the steps did change the parameters
    assert any(not torch.equal(p, job["state"][n])
               for n, p in alone["params"].items())
    for m in alone["metrics"]:
        assert all(np.isfinite(v) for v in m.values())
    if name == "dynamic_rcnn":
        assert {"stat_iou", "stat_beta"} <= set(alone["metrics"][0])


def test_lsnet_first_loss_equals_jax_mesh_step(runs):
    """JAX's jitted step with the batch sharded over a 2-device mesh
    (``PS("data")``): its loss is the global batch's."""
    jmodel, v = runs["jax"]
    batch = runs["jobs"]["lsnet_bbox"]["batches"][0]
    tx, _ = joptim.build_optimizer(0.01, STEPS, [], clip_norm=35.0,
                                   warmup_iters=0)
    mesh = jmesh.make_mesh(n_data=WORLD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "SAMPLING", ["bilinear"])
        mp.setattr(jfd, "SAMPLING_POLICY", {})
        step = j_make_train_step(jmodel, tx, JLossConfig(image_shape=HW,
                                                         num_classes=C),
                                 mesh=mesh, mixed_precision=False)
        with mesh:
            _, metrics = step(create_train_state(to_jax(v), tx),
                              {k: jnp.asarray(x) for k, x in batch.items()})
    want = float(metrics["loss"])
    got = runs["alone"]["lsnet_bbox"]["metrics"][0]["loss"]
    ranked = [r["metrics"][0]["loss"] for r in runs["ranks"]["lsnet_bbox"]]
    for loss in (got, *ranked):
        assert abs(loss - want) <= TOL * abs(want), (loss, want)


def _payloads():
    return [[{"bboxes": np.arange(8, dtype=np.float32).reshape(2, 4),
              "labels": [1, 2]}],
            [],
            [{"bboxes": np.zeros((0, 4), np.float32), "labels": []},
             {"landmarks": np.ones((3, 17, 2), np.float32)}]]


@pytest.mark.parametrize("pack,merge", [("torch", "torch"), ("torch", "jax"),
                                        ("jax", "torch")])
def test_collect_results_wire_format(pack, merge):
    """pack -> pad -> stack -> merge, in rank order, with either
    package's halves: the same wire format."""
    mods = {"torch": pmesh, "jax": jmesh}
    per_rank = _payloads()
    packed = [mods[pack]._pack_results(r) for r in per_rank]
    sizes = np.stack([n for _, n in packed])
    gathered = np.zeros((len(packed), int(sizes.max())), np.uint8)
    for i, (payload, _) in enumerate(packed):
        gathered[i, : payload.size] = payload
    merged = mods[merge]._merge_gathered(gathered, sizes)
    flat = [x for rank in per_rank for x in rank]
    assert len(merged) == len(flat) == 3
    np.testing.assert_array_equal(merged[0]["bboxes"], flat[0]["bboxes"])
    assert merged[0]["labels"] == [1, 2] and merged[1]["labels"] == []
    assert merged[2]["landmarks"].shape == (3, 17, 2)
    for (a, n), (b, m) in zip(packed, (jmesh._pack_results(r)
                                       for r in per_rank)):
        assert a.tobytes() == b.tobytes() and n.tolist() == m.tolist()


def test_one_process_helpers_are_the_identity():
    assert not torch.distributed.is_initialized()
    assert (parallel.world_size(), parallel.rank()) == (1, 0)
    assert parallel.is_main_process()
    data = [{"id": 0}, {"id": 1}]
    out = parallel.collect_results(data)
    assert out == data and out is not data
    x = torch.arange(12.0).reshape(4, 3)
    assert parallel.shard_rows(x) is x
    assert parallel.gather_rows(x) is x
    assert parallel.global_count(x) is x
    assert torch.equal(parallel.batch_mean(x[:, 0]), x[:, 0].mean())
    outs = {"cls": [x], "moment": torch.ones(2)}
    got = parallel.gather_outputs(outs)
    assert got["cls"][0] is x and got["moment"] is outs["moment"]
    grads = (x, torch.ones(3))
    assert all(a is b for a, b in zip(parallel.reduce_gradients(grads),
                                       grads))
    batch = {"image": x, "dyn_beta": torch.tensor(1.0), "img_id": np.ones(4)}
    assert all(v is batch[k] or np.shares_memory(v, batch[k])
               for k, v in parallel.shard_batch_pytree(batch).items())


def test_bootstrap_without_a_launcher_is_a_no_op(monkeypatch):
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    parallel.initialize_distributed(device="cpu")
    parallel.init_launcher("none", device="cpu")
    assert not torch.distributed.is_initialized()


def test_a_bootstrap_that_fails_raises(monkeypatch):
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.init_launcher("pytorch", device="cpu")
    with pytest.raises(ValueError, match="none or pytorch"):
        parallel.init_launcher("slurm", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.initialize_distributed("file:///unused", 2, 0)
    # a store that nobody serves: rank 1 of 2 cannot reach rank 0
    with pytest.raises(Exception, match="timed out"):
        parallel.initialize_distributed("tcp://127.0.0.1:29431", 2, 1,
                                        device="cpu", timeout=2.0)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "notaport")
    with pytest.raises(ValueError):
        parallel.init_launcher("pytorch", device="cpu")
    assert not torch.distributed.is_initialized()
