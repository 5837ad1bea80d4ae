"""Parameter count and FLOPs of a detector's forward (the port's
``tools/get_flops.py``).

    python3 -m lsnet_torch.tools.get_flops CONFIG [--shape H W] \
        [--device cuda|cpu]

The forward runs once on a zero (1, H, W, 3) image (the config's
``canvas_shape`` unless ``--shape`` is given) at the training sampling,
under ``torch.utils.flop_counter.FlopCounterMode``, which counts 2 FLOPs a
multiply-add of every convolution and matrix product it sees. The
deformable contractions launch hand-written kernels the counter cannot
see, so each of them is counted by its own product, ``2 * K * (C /
groups) * cout * px``, and whatever the counter saw inside it (the plain
version's einsum on the CPU) is left out: the count is the same on the
card and on the CPU.

It differs from the JAX tool's number, XLA's cost analysis of the
compiled forward: XLA also counts elementwise work (norms, activations,
the sampling's corner weights, the resizes of the FPN), and counts a
contraction as XLA rewrote it. It runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
from typing import Tuple


@contextlib.contextmanager
def _counted_contractions(tally):
    """Route the flat sampling engine's two contractions through wrappers
    that add each call's product to ``tally["dcn"]`` and what the FLOP
    counter saw inside the call to ``tally["inside"]``."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import flat_deform

    def wrap(fn):
        def counted(flat, idx, w, weight, *rest):
            K, px = idx.shape[1], idx.shape[2]
            tally["dcn"] += 2 * K * weight.shape[1] * weight.shape[2] * px
            with FlopCounterMode(display=False) as inner:
                out = fn(flat, idx, w, weight, *rest)
            tally["inside"] += inner.get_total_flops()
            return out
        return counted

    names = ("deform_gather_contract", "deform_gather_grouped_contract")
    saved = {n: getattr(flat_deform, n) for n in names}
    try:
        for n in names:
            setattr(flat_deform, n, wrap(saved[n]))
        yield
    finally:
        for n in names:
            setattr(flat_deform, n, saved[n])


def count(cfg, canvas: Tuple[int, int], device="cuda") -> Tuple[int, int]:
    """(parameters, FLOPs) of ``cfg``'s model on one zero image of
    ``canvas``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import build_detector
    from ..train.loop import runner_device

    device = runner_device(device)
    model = build_detector(cfg.model.to_dict()).to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    images = torch.zeros((1, *canvas, 3), device=device)
    tally = {"dcn": 0, "inside": 0}
    with torch.no_grad(), _counted_contractions(tally), \
            FlopCounterMode(display=False) as counter:
        model(images)
    return n_params, counter.get_total_flops() - tally["inside"] \
        + tally["dcn"]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--shape", type=int, nargs=2, default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..utils.config import Config

    cfg = Config.fromfile(args.config)
    canvas = tuple(args.shape or cfg.get("canvas_shape") or (800, 1344))
    n_params, flops = count(cfg, canvas, args.device)
    print(f"input shape: (1, {canvas[0]}, {canvas[1]}, 3)")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops:  {flops / 1e9:.2f} GFLOPs (FlopCounterMode + the "
          "deformable contractions' products)")
    return n_params, flops


if __name__ == "__main__":
    main()
