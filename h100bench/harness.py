"""What every entry shares: the benchmark's files by name, the profile of
a steady stretch, and the reading of a device timeline."""

from __future__ import annotations

import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# modules that nothing the benchmark runs may load (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lsnet_tpu",
             "__graft_entry__", "bench", "tools")
PROFILE_TRIES = 16


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(bench: Dict, workload: str, here: Path = HERE) -> Dict:
    """The cell's entry in ``BENCHMARK.json`` with its configuration,
    traffic mix and limits, each found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "config": load_json(here / "configs" / f"{cell['config']}.json"),
        "config_entry": config,
        "mix": load_json(here / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(here / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if workload in m.get("workloads", [workload])],
        "per_layer": [m for m in bench["per_layer"]
                      if workload in m.get("workloads", [workload])],
    }


def metric_reader(name: str, here: Path = HERE) -> Callable:
    """``read(ctx)`` of ``layer_metrics/<name>.py``."""
    import importlib.util
    path = here / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def validate(bench: Dict, here: Path = HERE) -> List[str]:
    """Problems with names, units and the files each name points to."""
    bad = []
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    bad += [f"name {n!r}" for n in names if not NAME.match(n)]
    bad += [f"unit {m['unit']!r}" for m in bench["end_to_end"]
            + bench["per_layer"] if not UNIT.match(m["unit"])]
    for text in ([w["why"] for w in bench["workloads"]]
                 + [c["why"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]]
                 + [c["source"] for c in bench["configs"]]):
        if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
            bad.append(f"text {text[:40]!r}")
    for c in bench["configs"]:
        if not (here.parent / c["file"]).is_file():
            bad.append(f"config file {c['file']}")
    for w in bench["workloads"]:
        for sub, name in (("traffic", w["traffic"]),
                          ("limits", w["name"])):
            if not (here / sub / f"{name}.json").is_file():
                bad.append(f"{sub}/{name}.json")
    for m in bench["per_layer"]:
        if not (here / "layer_metrics" / f"{m['name']}.py").is_file():
            bad.append(f"layer_metrics/{m['name']}.py")
    return bad


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def process_start() -> float:
    """The wall time this process started at (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


class Phases:
    """Seconds of each named part of set-up, each part closed by a
    synchronise, so that the card's work lands in the part that queued
    it."""

    def __init__(self, sync: Callable):
        self.sync, self.t, self.parts = sync, time.time(), []

    def mark(self, name: str) -> None:
        self.sync()
        now = time.time()
        self.parts.append((name, round(now - self.t, 3)))
        self.t = now


# ------------------------------------------------------------------ profile

class Stretch:
    """The profiled stretch of a traced window: the device's operations
    ``ops`` [(name, start_ns, end_ns)], the host's spans [(name, start_ns,
    end_ns)] (wall clock, as the profiler's), the stretch's wall bounds
    and the batches in it."""

    def __init__(self):
        self.ops: List[Tuple[str, int, int]] = []
        self.spans: List[Tuple[str, int, int]] = []
        self.t0 = self.t1 = 0
        self.batches = 0
        self.retries = 0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_time(self, pick: Callable[[str], bool]) -> float:
        """Seconds of the operations whose name ``pick`` takes."""
        return sum(e - s for n, s, e in self.ops if pick(n)) / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        tot: Dict[str, int] = {}
        for n, s, e in self.ops:
            tot[n[:120]] = tot.get(n[:120], 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest idle gaps, each named by the host span it fell in
        and the operation that ended it."""
        ivs = self.busy_intervals()
        edges = [(self.t0, ivs[0][0] if ivs else self.t1)]
        edges += [(a[1], b[0]) for a, b in zip(ivs, ivs[1:])]
        if ivs:
            edges.append((ivs[-1][1], self.t1))
        starts = {s: n for n, s, _ in self.ops}
        gaps = []
        for s, e in edges:
            if e <= s:
                continue
            mid = (s + e) // 2
            span = next((n for n, a, b in self.spans if a <= mid < b),
                        "outside spans")
            after = starts.get(e, "stretch end")
            gaps.append([f"{span} before {after[:60]}", (e - s) / 1e9])
        return sorted(gaps, key=lambda g: -g[1])[:k]


class Profiler:
    """Profiles ``count`` consecutive batches of a window, CUDA activity
    only, once it is started; a profile that lost its device records is
    taken again on the next batches (``PROFILE_TRIES`` times)."""

    def __init__(self, start_at: int, count: int, sync: Callable):
        self.start_at, self.count, self.sync = start_at, count, sync
        self.stretch: Optional[Stretch] = None
        self._prof = None
        self._begun = 0
        self._retries = 0

    @property
    def done(self) -> bool:
        return self.stretch is not None

    @property
    def started(self) -> bool:
        """The profile has begun (the profiler's own cost is on from
        here)."""
        return self.done or self._prof is not None

    def before(self, i: int) -> None:
        if self.done or self._prof is not None or i < self.start_at:
            return
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._spans: List[Tuple[str, int, int]] = []
        self.sync()
        self._t0 = time.time_ns()
        self._begun = i

    def span(self, name: str, start_ns: int, end_ns: int) -> None:
        if self._prof is not None:
            self._spans.append((name, start_ns, end_ns))

    def after(self, i: int) -> None:
        if self._prof is None or i + 1 - self._begun < self.count:
            return
        import torch
        self.sync()
        t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        ops = [(e.name(), e.start_ns(), e.end_ns())
               for e in self._prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()
               and e.duration_ns() > 0]
        self._prof = None
        if not ops:
            self._retries += 1
            print(f"h100bench: profile without device records, retry "
                  f"{self._retries}", file=sys.stderr)
            if self._retries >= PROFILE_TRIES:
                raise RuntimeError(f"{PROFILE_TRIES} profiles in a row "
                                   "without device records")
            return
        st = Stretch()
        st.ops, st.spans, st.t0, st.t1 = ops, self._spans, self._t0, t1
        st.batches, st.retries = self.count, self._retries
        self.stretch = st


# ------------------------------------------------------------------ results

def median(xs: Sequence[float]) -> Optional[float]:
    xs = sorted(xs)
    if not xs:
        return None
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    xs = sorted(xs)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def judge(numbers: Dict[str, float], limits: Dict[str, Dict]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each number beside its limit; correct where every number is finite
    and at most its limit."""
    checks, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= spec["limit"]
        ok &= bool(good)
        checks[name] = {"value": v, "limit": spec["limit"]}
    return ok, checks
