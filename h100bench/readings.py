"""The readings a cell's limits are set from, many seeds in one process:
the program's numbers on each seed (a short window at the cell's load,
then the check), the control's (the reference in a lower precision in
the program's place), where asked a planted fault's, and the program's
in float32 (a witness of what bfloat16 alone moves).

    python3 -m h100bench.readings --workload CELL --seeds 1,2,... \
        [--seconds 3] [--control fp8 --control-seeds 7,8,9] \
        [--fault half,shift --fault-seeds 7,8,9] [--f32-seeds 4,5]

Prints one JSON line per reading. Needs the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

from . import harness
from .run import entry_class


def _ints(text: str):
    return [int(s) for s in text.split(",") if s]


def reading(files, seed: int, seconds: float, kind: str, arg=None):
    import torch
    cls = entry_class(files["mix"]["entry"])
    if kind == "f32":
        mix = dict(files["mix"])
        if mix["entry"] == "detect":
            mix["dtype"] = "float32"
        else:
            mix["mixed_precision"] = False
        files = dict(files, mix=mix)
    entry = cls(files, seed, "cuda", arg if kind == "fault" else None)
    t0 = time.time()
    entry.setup()
    torch.cuda.synchronize()
    rec = entry.window(seconds, False)
    out = {"kind": kind, "seed": seed, "arg": arg,
           "setup_and_window_s": time.time() - t0,
           "end_to_end": entry.end_to_end(rec),
           "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    entry.release()
    t0 = time.time()
    if kind == "control":
        out["numbers"] = entry.control_numbers(arg)
    else:
        out["numbers"] = entry.check()
    out["check_s"] = time.time() - t0
    del entry
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--f32-seeds", default="")
    args = ap.parse_args(argv)
    files = harness.cell_files(harness.benchmark(), args.workload)
    plan = [("program", s, None) for s in _ints(args.seeds)]
    plan += [("control", s, args.control) for s in _ints(args.control_seeds)]
    plan += [("fault", s, f) for f in (args.fault or "").split(",") if f
             for s in _ints(args.fault_seeds)]
    plan += [("f32", s, None) for s in _ints(args.f32_seeds)]
    for kind, seed, arg in plan:
        print(json.dumps(reading(files, seed, args.seconds, kind, arg)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
