"""The data-parallel tools on the CPU: ``lsnet_torch/tools/dist_test.sh``
under torchrun with two gloo ranks against ``tools.test`` in one process,
and the port's ``KernelLaunchHook`` through ``tools.train``."""

import json
import os
import subprocess

import numpy as np
import torch

from lsnet_torch import apis
from lsnet_torch.models import build_detector
from lsnet_torch.tools import test as test_tool
from lsnet_torch.tools import train as train_tool
from lsnet_torch.tools.shapes import make_shapes_coco
from lsnet_torch.train.checkpoint import save_checkpoint, train_meta
from lsnet_torch.train.hooks import kernel_wrappers
from lsnet_torch.train.optim import build_optimizer
from lsnet_torch.utils.config import Config
from test_torch_parallel import FILES, HW, REPO, _options
from torch_port_util import write_narrow_config

torch.set_num_threads(1)


def test_kernel_launch_hook_writes_each_read(tmp_path):
    """``custom_hooks=[{'type': 'KernelLaunchHook'}]`` through
    ``tools.train``: one line a step and one an epoch in
    ``launches_rank0.jsonl``, each with the six kernels' counts (0 on the
    CPU: the plain versions launch nothing)."""
    ann, img = make_shapes_coco(str(tmp_path / "data"), 4, seed=0, hw=HW)
    cfg = write_narrow_config(str(tmp_path / "cfg.py"), ann, img, hw=HW,
                              custom_hooks=[dict(type="KernelLaunchHook")],
                              log_interval=1)
    work = str(tmp_path / "work")
    train_tool.main([cfg, "--work-dir", work, "--device", "cpu",
                     "--total-epochs", "1", "--max-iters-per-epoch", "2",
                     "--options", "evaluation.interval=100"])
    with open(os.path.join(work, "launches_rank0.jsonl")) as f:
        reads = [json.loads(line) for line in f]
    assert [(r["mode"], r["step"]) for r in reads] == [
        ("train", 1), ("train", 2), ("epoch", 2)]
    assert all(r[k] == 0 for r in reads for k in kernel_wrappers())


def test_dist_test_gathers_every_rank_detections(tmp_path):
    """``dist_test.sh CFG CKPT 2 --device cpu`` (torchrun, two gloo ranks,
    each decoding every other val image, the detections gathered by
    ``collect_results``) gives ``tools.test``'s metrics in one process.
    The narrow RetinaNet file from seeded weights, whose val GTs are its
    own three best boxes an image, so that the metrics are not 0."""
    ann, img = make_shapes_coco(str(tmp_path / "data"), 6, seed=2, hw=HW)
    val = str(tmp_path / "val.json")
    opts = [f"{k}={v!r}" for k, v in _options("retinanet").items()] + [
        f"data.val.ann_file={val}", f"data.val.img_prefix={img}",
        f"data.val.img_scale={HW[::-1]!r}", "model.bbox_head.num_classes=3",
        "test_cfg.score_thr=0.0"]
    cfg_path = os.path.join(REPO, "configs", FILES["retinanet"])
    cfg = Config.fromfile(cfg_path)
    cfg.merge_from_dict(train_tool.parse_options(opts))
    model = apis.random_weights_(build_detector(cfg.model.to_dict()), 0)
    opt, _ = build_optimizer(model.parameters(), 0.01, 1, [])
    ckpt = save_checkpoint(str(tmp_path / "ckpts"), model, opt, 0,
                           train_meta())
    bundle = apis.init_detector(cfg, ckpt, device="cpu")
    coco = json.load(open(ann))
    coco["annotations"] = []
    for im in coco["images"]:
        det = apis.inference_detector(bundle, os.path.join(
            img, im["file_name"]))
        for i in np.argsort(-det["scores"], kind="stable")[:3]:
            x1, y1, x2, y2 = (float(v) for v in det["bboxes"][i])
            coco["annotations"].append(dict(
                id=len(coco["annotations"]) + 1, image_id=im["id"],
                category_id=int(det["labels"][i]) + 1, iscrowd=0,
                bbox=[x1, y1, x2 - x1, y2 - y1],
                area=(x2 - x1) * (y2 - y1)))
    json.dump(coco, open(val, "w"))
    flags = ["--device", "cpu", "--options", *opts]
    one = test_tool.main([cfg_path, ckpt] + flags)
    out = str(tmp_path / "two.json")
    run = subprocess.run(
        ["bash", os.path.join(REPO, "lsnet_torch", "tools", "dist_test.sh"),
         cfg_path, ckpt, "2", "--out", out] + flags,
        capture_output=True, text=True, timeout=150,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-3000:]
    two = json.load(open(out))
    assert two.keys() == one.keys() and len(one) == 12
    assert one["bbox_mAP"] > 0 and one["bbox_AR@100"] > 0, one
    for k, v in one.items():
        assert abs(two[k] - v) <= 1e-6, (k, two[k], v)
