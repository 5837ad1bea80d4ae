"""The detect entry: a closed loop of ``lsnet_torch.apis.detect`` on a
pool of device-resident batches, each batch's detections copied to host
memory before the next is dispatched.

Set-up builds the detector on the device, loads the minted weights,
casts it to the mix's dtype, makes the pool and runs two warm-up
batches. The window dispatches batches until ``seconds`` have passed;
each batch is timed on the host clock from dispatch to its detections
(boxes, scores, labels, validity) in host memory. With ``trace`` the
benchmark's forward hooks record CUDA events around the detector's
forward and after the copy, and a stretch of batches is profiled.

The check, after the window: two batches drawn from the seed among those
the window served (their head maps and detections kept as the window
produced them) are compared with the plain reference: the head's maps
with the reference's float32 forward on the same images and weights
(``maps_rel_err``: the relative L2 gap of one map kind over all levels
of one image, the worst kind and image; the gap of each level alone is
kept as information, since the coarsest levels hold a few dozen points
and read two to three times the pooled gap), and the detections with
the reference's decode + NMS of the program's own maps
(``det_mismatch``: the share of detections on either side with no match
on the other).
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import generate, weights
from ..harness import Phases, Profiler, median, percentile
from ..reference import decode as ref_decode
from ..reference import model as ref_model

MAP_KINDS = ("cls", "bbox_init", "bbox_refine")
# a detection matches when its label is the same and its box and score
# are within these
MATCH_PX = 0.05
MATCH_SCORE = 1e-4


class Detect:
    def __init__(self, files: Dict, seed: int, device: str = "cuda",
                 fault: Optional[str] = None):
        self.files, self.seed, self.device = files, int(seed), device
        self.model_cfg = files["config"]["model"]
        self.mix = files["mix"]
        self.fault = fault
        self.hook_out = None
        self.events: List = []

    # ---------------------------------------------------------------- setup
    def setup(self) -> None:
        self.phases = ph = Phases(self._sync)
        from lsnet_torch import apis
        from lsnet_torch.core.decode import TestConfig
        from lsnet_torch.models import build_detector
        from types import MappingProxyType
        ph.mark("import lsnet_torch")

        self.apis = apis
        mix, dev = self.mix, self.device
        with torch.device("meta"):
            tree = ref_model.build(self.model_cfg)
        w = weights.mint(tree, self.seed, dev)
        ph.mark("weights")
        with torch.device(dev):
            model = build_detector(self.model_cfg)
        model.to(dev)           # buffers made from numpy land on the host
        model.load_state_dict(w, strict=True)
        del w
        self.dtype = getattr(torch, mix["dtype"])
        self.model = model.to(self.dtype).eval()
        ph.mark("model")
        self.pool = generate.pool(mix, self.seed, dev)
        for b in self.pool:
            b["image"] = b["image"].to(self.dtype)
        ph.mark("pool")
        head = self.model_cfg["bbox_head"]
        t = mix["test_cfg"]
        self.tcfg = TestConfig(
            image_shape=tuple(mix["canvas"]),
            num_classes=head["num_classes"], task=head["task"],
            num_vectors=head["num_vectors"],
            point_strides=tuple(head["point_strides"]),
            nms_pre=t["nms_pre"], score_thr=t["score_thr"],
            nms_iou=t["nms_iou"], max_per_img=t["max_per_img"])
        self.sampling = MappingProxyType(dict(mix["sampling"]))
        self.model.register_forward_pre_hook(self._pre)
        self.model.register_forward_hook(self._post)
        self.tracing = False
        for i in range(2):
            self._batch(self.pool[i])
        ph.mark("warm-up")

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _pre(self, mod, args):
        if self.tracing:
            self._cur = {"pre": self._event(), "pre_ns": time.time_ns()}

    def _post(self, mod, args, out):
        self.hook_out = out
        if self.tracing:
            self._cur["post"] = self._event()
            self._cur["post_ns"] = time.time_ns()
        return out

    def _batch(self, b: Dict) -> Dict[str, np.ndarray]:
        det = self.apis.detect(self.model, b["image"], b["img_shape"],
                               b["scale_factor"], self.tcfg, self.sampling)
        if self.fault is not None:
            det = _faulty(det, self.fault)
        host = {"bboxes": det.bboxes.cpu().numpy(),
                "scores": det.scores.cpu().numpy(),
                "labels": det.labels.cpu().numpy(),
                "valid": det.valid.cpu().numpy()}
        return host

    # --------------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> Dict:
        mix = self.mix
        P = len(self.pool)
        keep_n = mix["check_batches"]
        rng = random.Random(self.seed ^ 0x5EED)
        kept: List = []
        lat: List[float] = []
        prof = (Profiler(start_at=int(mix["profile_start"]),
                         count=int(mix["profile_batches"]),
                         sync=self._sync) if trace else None)
        self.tracing = trace
        # the batches before the profile: the layers' spans and the time
        # a batch takes, free of the profiler's cost
        spans: List[Dict] = []
        before: List[float] = []
        t_start = time.perf_counter()
        end = t_start + seconds
        n = 0
        t_last = t_start
        while time.perf_counter() < end or (prof and not prof.done):
            b = self.pool[n % P]
            if prof:
                prof.before(n)
                profiled = prof.started
            t0 = time.perf_counter()
            host = self._batch(b)
            t1 = time.perf_counter()
            if trace:
                cur = self._cur
                cur["done"] = self._event()
                now = time.time_ns()
                if not profiled:
                    spans.append(cur)
                    before.append(t1 - t0)
                prof.span("forward", cur["pre_ns"], cur["post_ns"])
                prof.span("decode_nms", cur["post_ns"], now)
                prof.after(n)
            if t1 <= end:
                lat.append(t1 - t0)
                t_last = t1
            # reservoir: keep_n batches drawn uniformly from the window's
            if len(kept) < keep_n:
                kept.append((n, self.hook_out, host))
            else:
                j = rng.randrange(n + 1)
                if j < keep_n:
                    kept[j] = (n, self.hook_out, host)
            n += 1
        self._sync()
        self.tracing = False
        done = len(lat)
        # the window: from its start to the last batch done inside it
        window_s = t_last - t_start
        self.kept = kept
        rec = {"batches": done, "images": done * mix["batch"],
               "attempted": done, "failed": 0, "window_s": window_s,
               "latencies_s": lat}
        if trace:
            torch.cuda.synchronize()
            rec["forward_ms"] = [s["pre"].elapsed_time(s["post"])
                                 for s in spans]
            rec["decode_nms_ms"] = [s["post"].elapsed_time(s["done"])
                                    for s in spans]
            rec["stretch"] = prof.stretch
            rec["batch_s"] = sum(before) / len(before)
        return rec

    def end_to_end(self, rec: Dict) -> Dict[str, float]:
        return {"detect_img_s": rec["images"] / rec["window_s"],
                "detect_p95_ms": percentile(rec["latencies_s"], 95) * 1e3}

    def layer_context(self, rec: Dict) -> Dict:
        return {"entry": "detect", "model": self.model_cfg, "mix": self.mix,
                "record": rec, "stretch": rec.get("stretch"),
                "median": median}

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.apis
        self.hook_out = None
        import gc
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def reference(self, control: Optional[str] = None):
        """The reference detector in float32 with the run's weights; with
        ``control`` its products' operands rounded to that precision."""
        if self.device != "cpu":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        with torch.device("meta"):
            tree = ref_model.build(self.model_cfg)
        w = weights.mint(tree, self.seed, self.device)
        with torch.device(self.device):
            net = ref_model.build(self.model_cfg)
        net.load_state_dict(w, strict=True)
        net.eval()
        if control:
            from ..control import lowered
            return lowered(net, control)
        return net

    def control_numbers(self, precision: str) -> Dict[str, float]:
        """The control's numbers: the maps and detections of the reference
        in ``precision`` in the program's place."""
        return self.check(precision)

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """The numbers compared; with ``control``, the control's."""
        ref = self.reference()
        ctl = self.reference(control) if control else None
        head = self.model_cfg["bbox_head"]
        t = self.mix["test_cfg"]
        rel = 0.0
        info: Dict[str, float] = {}
        matched = total = 0
        smp = ref_model.INFERENCE if self.mix["sampling"]["backbone"] == \
            "nearest" else ref_model.TRAIN
        for n, outs, host in self.kept:
            b = self.pool[n % len(self.pool)]
            for i in range(b["image"].shape[0]):
                img = b["image"][i:i + 1].float()
                with torch.no_grad():
                    r = ref(img, smp)
                    if ctl is not None:
                        prog = ctl(img, smp)
                        prog_maps = {k: [m[0] for m in prog[k]]
                                     for k in MAP_KINDS}
                    else:
                        prog_maps = {k: [m[i].float() for m in outs[k]]
                                     for k in MAP_KINDS}
                for k in MAP_KINDS:
                    gap = size = 0.0
                    for lvl, (p, q) in enumerate(zip(prog_maps[k], r[k])):
                        d2 = float((p - q[0]).square().sum())
                        r2 = float(q[0].square().sum())
                        gap, size = gap + d2, size + r2
                        key = f"info.{k}.{lvl}"
                        info[key] = max(info.get(key, 0.0),
                                        (d2 / max(r2, 1e-30)) ** 0.5)
                    e = (gap / max(size, 1e-30)) ** 0.5
                    info[f"info.{k}"] = max(info.get(f"info.{k}", 0.0), e)
                    rel = max(rel, e)
                want = ref_decode.detect_one(
                    prog_maps["cls"], prog_maps["bbox_refine"],
                    b["img_shape"][i].tolist(), b["scale_factor"][i].tolist(),
                    strides=head["point_strides"], nms_pre=t["nms_pre"],
                    score_thr=t["score_thr"], iou_thr=t["nms_iou"],
                    max_per_img=t["max_per_img"])
                if ctl is not None:
                    got = want
                else:
                    v = host["valid"][i]
                    got = {"boxes": host["bboxes"][i][v],
                           "scores": host["scores"][i][v],
                           "labels": host["labels"][i][v]}
                m = _matches(got, want)
                matched += 2 * m
                total += len(got["scores"]) + len(want["scores"])
        return {"maps_rel_err": rel,
                "det_mismatch": (total - matched) / max(total, 1), **info}



Entry = Detect

def _matches(got: Dict, want: Dict) -> int:
    """Detections of ``got`` matched one to one in ``want``: same label,
    boxes within MATCH_PX, scores within MATCH_SCORE."""
    used = np.zeros(len(want["scores"]), bool)
    n = 0
    for j in range(len(got["scores"])):
        ok = ((want["labels"] == got["labels"][j]) & ~used
              & (np.abs(want["boxes"] - got["boxes"][j]).max(-1) <= MATCH_PX)
              & (np.abs(want["scores"] - got["scores"][j]) <= MATCH_SCORE))
        hit = np.flatnonzero(ok)
        if len(hit):
            used[hit[0]] = True
            n += 1
    return n


def _faulty(det, fault: str):
    """Planted faults of the check's tests: ``shift`` moves every box by
    two pixels where it is produced; ``half`` serves the first half of
    the batch and leaves the rest empty."""
    from lsnet_torch.core.decode import Detections
    if fault == "shift":
        return det._replace(bboxes=det.bboxes + 2.0)
    if fault == "half":
        B = det.valid.shape[0]
        keep = torch.arange(B, device=det.valid.device) < B // 2
        return Detections(*(x * keep.view(-1, *[1] * (x.dim() - 1))
                            .to(x.dtype) for x in det))
    raise ValueError(f"fault {fault!r}")
