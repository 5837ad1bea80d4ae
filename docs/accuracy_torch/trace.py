"""Where the port's accuracy runs part from one another: the first steps
of ``lsnet_torch.tools.accuracy_run``'s R50-DCN bbox config (seed 0, 160
train images, B=8, the 36-epoch schedule) from one init and one batch
order, run

* on the CPU in f32 (every K1 call through its plain version),
* on the card in f32 (the kernels), twice,
* on the card in bf16 over f32 masters (the shipped step), twice.

It prints each run's loss and ``grad_norm`` at every step, each run's
loss relative to a reference run's, and after the last step, for each
pair, the largest differences of a parameter tensor as a share of how far
the reference run moved it from the init (the whole model and the
``conv_offset`` tensors apart). Pairs: card f32 against the CPU (the
kernels), card f32 against itself (the atomics' order), bf16 against f32
on the card (the precision), bf16 against itself. All of it goes to
``OUT/trace.json`` too. f32 is full f32: TF32 is off in cuDNN's
convolutions and in matmuls, unless ``--tf32`` leaves PyTorch's default
(TF32 in cuDNN's convolutions).

    python3 docs/accuracy_torch/trace.py steps [--steps 20] [--out DIR]
        [--device cuda|cpu] [--tf32]
    python3 docs/accuracy_torch/trace.py f32 ACCURACY_RUN_ARGS...

``f32`` runs ``lsnet_torch.tools.accuracy_run`` with its arguments and
the train step in f32 (no bf16 casts; PyTorch's default TF32 in
cuDNN's convolutions), and adds ``"train_dtype":
"float32"`` to its ``result.json``. With ``--device cpu`` the card's runs
run on the CPU too (a check of the script, not a trace).
"""

import argparse
import functools
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from lsnet_torch.tools import accuracy_run  # noqa: E402
from lsnet_torch.tools.shapes import make_shapes_coco  # noqa: E402
from lsnet_torch.train import hooks as runner_hooks  # noqa: E402
from lsnet_torch.train import loop as runner_loop  # noqa: E402
from lsnet_torch.train import step as runner_step  # noqa: E402


@runner_hooks.HOOKS.register_module()
class TraceStepsHook(runner_hooks.Hook):
    """Keeps the init and every step's metrics; stops the run after
    ``TraceStepsHook.limit`` steps."""
    priority = 95
    limit = 1
    init, records = {}, []

    def before_train(self, ctx):
        TraceStepsHook.init = state_on_cpu(ctx.model)
        TraceStepsHook.records = []

    def after_iter(self, ctx):
        TraceStepsHook.records.append(dict(ctx.metrics))
        if len(TraceStepsHook.records) >= TraceStepsHook.limit:
            ctx.should_stop = True


def state_on_cpu(model):
    return {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()}


def first_steps(cfg, work, device, mixed_precision, steps):
    """(the init, each step's metrics, the state after the last step) of
    ``train_detector`` on ``cfg``."""
    TraceStepsHook.limit = steps
    saved = runner_loop.make_train_step
    runner_loop.make_train_step = functools.partial(
        runner_step.make_train_step, mixed_precision=mixed_precision)
    try:
        out = runner_loop.train_detector(cfg, work, eval_interval=10 ** 9,
                                         device=device)
    finally:
        runner_loop.make_train_step = saved
    return (TraceStepsHook.init, list(TraceStepsHook.records),
            state_on_cpu(out["model"]))


def drift(got, ref, init, keys, top=6):
    """max|got - ref| / max|ref - init| of each tensor of ``keys``: the
    largest ``top`` and the largest of all."""
    named = sorted((((got[k] - ref[k]).abs().max()
                     / (ref[k] - init[k]).abs().max().clamp(min=1e-30)
                     ).item(), k) for k in keys)
    return {"max": named[-1][0], "median": named[len(named) // 2][0],
            "largest": [(round(s, 6), k) for s, k in named[-top:]]}


def steps_main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="work/accuracy_trace")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train", type=int, default=160)
    ap.add_argument("--tf32", action="store_true")
    opts = ap.parse_args(argv)
    card = runner_loop.runner_device(opts.device)
    torch.backends.cudnn.allow_tf32 = opts.tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(opts.out, exist_ok=True)
    ann, img = make_shapes_coco(os.path.join(opts.out, "data_train"),
                                opts.train, seed=0)
    args = accuracy_run.parse_args(["--task", "bbox", "--dcn", "--epochs",
                                    "36", "--train", str(opts.train)])
    runs = {"cpu_f32": ("cpu", False), "card_f32": (card, False),
            "card_f32_again": (card, False), "card_bf16": (card, True),
            "card_bf16_again": (card, True)}
    got = {}
    for name, (device, mixed) in runs.items():
        cfg = accuracy_run.accuracy_cfg(args, ann, img, ann, img)
        cfg.log_interval = 1
        cfg.custom_hooks = [dict(type="TraceStepsHook")]
        got[name] = first_steps(cfg, os.path.join(opts.out, name), device,
                                mixed, opts.steps)
        print(name, [(round(r["loss"], 5), round(r["grad_norm"], 3))
                     for r in got[name][1]], flush=True)
    init = got["cpu_f32"][0]
    for name, (start, *_) in got.items():
        if any(not torch.equal(start[k], v) for k, v in init.items()):
            raise AssertionError(f"{name} starts from another init")
    keys = [k for k in init if init[k].is_floating_point()
            and not k.endswith(("mean", "var"))]
    offsets = [k for k in keys if "conv_offset" in k]
    pairs = {"card_f32 vs cpu_f32": ("card_f32", "cpu_f32"),
             "card_f32_again vs card_f32": ("card_f32_again", "card_f32"),
             "card_bf16 vs card_f32": ("card_bf16", "card_f32"),
             "card_bf16_again vs card_bf16": ("card_bf16_again",
                                              "card_bf16")}
    report = {"steps": opts.steps, "device": str(card), "tf32": opts.tf32,
              "card": accuracy_run.card_name(card),
              "records": {n: g[1] for n, g in got.items()}, "pairs": {}}
    for label, (a, b) in pairs.items():
        la = [r["loss"] for r in got[a][1]]
        lb = [r["loss"] for r in got[b][1]]
        ga = [r["grad_norm"] for r in got[a][1]]
        gb = [r["grad_norm"] for r in got[b][1]]
        row = {"loss_rel": [abs(x - y) / abs(y) for x, y in zip(la, lb)],
               "grad_norm_rel": [abs(x - y) / abs(y)
                                 for x, y in zip(ga, gb)],
               "params": drift(got[a][2], got[b][2], init, keys),
               "conv_offset": drift(got[a][2], got[b][2], init, offsets)}
        report["pairs"][label] = row
        print(label, json.dumps({
            "loss_rel": [f"{v:.2e}" for v in row["loss_rel"]],
            "grad_norm_rel": [f"{v:.2e}" for v in row["grad_norm_rel"]],
            "params": row["params"], "conv_offset": row["conv_offset"]}),
            flush=True)
    with open(os.path.join(opts.out, "trace.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(report["card"])
    return report


def f32_main(argv):
    runner_loop.make_train_step = functools.partial(
        runner_step.make_train_step, mixed_precision=False)
    result = accuracy_run.main(argv)
    result["train_dtype"] = "float32"
    path = os.path.join(accuracy_run.parse_args(argv).out, "result.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    mode, rest = sys.argv[1], sys.argv[2:]
    {"steps": steps_main, "f32": f32_main}[mode](rest)
