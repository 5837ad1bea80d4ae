"""The benchmark of lsnet_torch on the H100: one run of one cell.

    python3 -m h100bench.run --workload CELL --seed N --seconds S --trace 0|1

Finds the cell in ``BENCHMARK.json``, its configuration under
``h100bench/configs/``, its traffic mix under ``h100bench/traffic/`` (the
mix names its entry under ``h100bench/entries/``), its limits under
``h100bench/limits/`` and, with ``--trace 1``, each per-layer metric's
reader under ``h100bench/layer_metrics/``. Set-up (weights minted on the
card, the pool of batches, the warm-up) is timed from the process's
start; the window runs ``--seconds``; then the program's state is freed
and its outputs are checked against the plain reference. The last line
of standard output is the result's JSON; the numbers compared, each
beside its limit, end standard error and the result.

It runs on the machine it is started on and needs a CUDA card; without
one, or with fewer cards than the cell asks for, it exits with code 3
and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from . import harness

START = harness.process_start()
# the caches a kernel build could use, at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(harness.ROOT / "build" / "h100bench" / _sub)

def entry_class(name: str):
    """The ``Entry`` of ``h100bench/entries/<name>.py``, the entry a
    traffic mix names."""
    import importlib
    return importlib.import_module(f"h100bench.entries.{name}").Entry


def power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(files, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault=None, out=sys.stdout):
    """One run of a cell after the look for a card: set-up, the window,
    the metrics, then the check. Returns the result (None where a
    forbidden module was loaded). ``fault`` plants one of the entry's
    faults under the timed path (the check's tests)."""
    import torch
    on_card = device != "cpu"
    entry = entry_class(files["mix"]["entry"])(files, seed, device, fault)
    before = time.time() - START
    entry.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.time() - START
    # what set-up made stays: the window's collections skip it
    gc.collect()
    gc.freeze()
    rec = entry.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if _forbidden():
        return None
    chips = files["cell"]["chips"]
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": chips, "memory_peak_bytes": int(peak)}
    if on_card:
        print(f"card: {power_line()}", file=out)
    print(f"set-up parts: start to entry {round(before, 3)}, "
          + ", ".join(f"{n} {t}" for n, t in entry.phases.parts), file=out)
    metrics, breakdown = {}, None
    if trace:
        st = rec["stretch"]
        print(f"profile: {st.retries} retries; {st.batches} batches in "
              f"{st.window_s} s profiled", file=out)
        device_info["busy_s"] = st.busy_s
        device_info["window_s"] = st.window_s
        ctx = entry.layer_context(rec)
        for m in files["per_layer"]:
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": st.top_ops(), "idle_gaps": st.idle_gaps()}
    else:
        values = dict(entry.end_to_end(rec), setup_s=setup_s)
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    lat = sorted(rec["latencies_s"])
    print(f"window: {rec['attempted']} requests in {rec['window_s']} s; "
          f"set-up {setup_s} s; latency s: min {lat[0] if lat else None} "
          f"median {harness.median(lat)} max {lat[-1] if lat else None}",
          file=out)
    entry.release()
    t0 = time.time()
    numbers = entry.check()
    ok, checks = harness.judge(numbers, files["limits"])
    print(f"check: {time.time() - t0} s", file=out)
    if _forbidden():
        return None
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    result = {"correct": ok, "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics,
              "device": device_info}
    if breakdown:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _forbidden() -> bool:
    found = harness.forbidden_modules()
    if found:
        print(f"h100bench: loaded {found}, which the benchmark may not "
              "load", file=sys.stderr)
    return bool(found)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    files = harness.cell_files(harness.benchmark(), args.workload)
    import torch
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(files, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 4
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
