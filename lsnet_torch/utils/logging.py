"""Logging, metrics buffer, environment snapshot (counterpart of
``lsnet_tpu/utils/logging.py``: the same ``*.log.json`` records).

Equivalents of the reference observability stack: ``LogBuffer`` running
averages (`mmcv/mmcv/runner/log_buffer.py`),
``TextLoggerHook`` console+json logging (`runner/hooks/logger/text.py`,
interval 50), and ``collect_env`` (`code/mmdet/utils/collect_env.py`), reporting torch,
CUDA and the devices.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import OrderedDict, defaultdict
from typing import Any, Dict, Optional


class LogBuffer:
    """Windowed running averages of scalar metrics."""

    def __init__(self):
        self.history: Dict[str, list] = defaultdict(list)
        self.output: Dict[str, float] = OrderedDict()
        self.ready = False

    def update(self, values: Dict[str, float]) -> None:
        for k, v in values.items():
            self.history[k].append(float(v))

    def average(self, n: int = 0) -> None:
        for k, vals in self.history.items():
            window = vals[-n:] if n > 0 else vals
            if window:
                self.output[k] = sum(window) / len(window)
        self.ready = True

    def clear(self) -> None:
        self.history.clear()
        self.output.clear()
        self.ready = False


class JsonLogger:
    """Append-only jsonl metrics log + console lines (reference
    TextLoggerHook format: one json record per log interval)."""

    def __init__(self, work_dir: str, interval: int = 50,
                 also_print: bool = True):
        os.makedirs(work_dir, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(work_dir, f"{ts}.log.json")
        self.interval = interval
        self.also_print = also_print
        self.buffer = LogBuffer()
        self._t_last = time.time()

    def log_iter(self, epoch: int, it: int, total_iters: int, lr: float,
                 metrics: Dict[str, float]) -> None:
        self.buffer.update(metrics)
        if (it + 1) % self.interval != 0:
            return
        now = time.time()
        iter_time = (now - self._t_last) / self.interval
        self._t_last = now
        self.buffer.average(self.interval)
        record = OrderedDict(
            mode="train", epoch=epoch, iter=it + 1, lr=round(lr, 6),
            time=round(iter_time, 4))
        record.update({k: round(v, 5) for k, v in self.buffer.output.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.also_print:
            msg = ", ".join(f"{k}: {v}" for k, v in record.items())
            print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)
        self.buffer.clear()

    def log_eval(self, epoch: int, metrics: Dict[str, float]) -> None:
        record = OrderedDict(mode="val", epoch=epoch)
        record.update({k: round(float(v), 5) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.also_print:
            print(f"[eval] {record}", flush=True)


def collect_env() -> Dict[str, Any]:
    """Python, torch and CUDA versions, the devices' name and count."""
    import torch
    info = OrderedDict()
    info["sys.platform"] = sys.platform
    info["python"] = sys.version.replace("\n", "")
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        info["devices"] = ", ".join(torch.cuda.get_device_name(i)
                                    for i in range(n))
        info["device_count"] = n
    else:
        info["devices"] = "cpu"
        info["device_count"] = 0
    return info
