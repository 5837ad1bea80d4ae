"""The train entry: a closed loop of the step that
``lsnet_torch.apis.train_detector_step`` returns, on a pool of
device-resident batches, each step's loss copied to host memory before
the next step.

Set-up builds the detector on the device with the minted float32
weights, builds the step (bf16 compute over the f32 masters, SGD,
clip, warm-up schedule), makes the pool and drives the step through its
first ``checked_steps`` batches (all different): that is the warm-up,
and what the check compares. The window then runs the same step object
on the rest of the pool, cycling. With ``trace`` the benchmark's forward
hooks record CUDA events around the detector's forward inside the step
and after the step's loss reaches the host, and a stretch of steps is
profiled.

The check, after the window, runs the plain reference's three steps from
the same weights on the same batches. The refine stage's assignment
(ATSS over the boxes the init landmarks decode to) is a selection: a
box a rounding apart can pass a threshold or a top-k rank that its
twin misses, and each flip moves the count every term is divided by.
In float32 the program and the reference assign alike (every number
below reads under 1e-3 on the H100); in bfloat16 they do not, and the
flips alone part the losses by up to 26 % and the leaves by up to 177 %,
as far as the fp8 control. So the reference follows the program's
assignment: it assigns, with its own code, from the boxes that the
program's own init maps of each checked step decode to (the forward
hook keeps them), and computes everything else itself. What this skips,
the program's maps, is checked by itself: the first step's head maps
against the reference's (``maps_rel_err``, as the detect entry's). The
other numbers: the first step's gradient norm before the clip
(``grad_norm_gap``), and the median leaf's change after the three steps
(``change_median_gap``). A leaf's gap is the gap between the two norms
over the reference's norm or the median leaf's, whichever is larger;
leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the change.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from .. import generate, weights
from ..harness import Phases, Profiler, median
from ..reference import loss as ref_loss
from ..reference import model as ref_model

TERMS = ("loss_cls", "loss_bbox_init", "loss_bbox_refine")
MAP_KINDS = ("cls", "bbox_init", "bbox_refine")


class Train:
    def __init__(self, files: Dict, seed: int, device: str = "cuda",
                 fault: Optional[str] = None):
        self.files, self.seed, self.device = files, int(seed), device
        self.model_cfg = files["config"]["model"]
        self.mix = files["mix"]
        self.fault = fault
        self.tracing = False
        self._capture = None

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
        if self._capture is not None:
            self._capture.append({k: [m.detach().clone() for m in out[k]]
                                  for k in MAP_KINDS})
        if self.tracing:
            self._cur["post"] = self._event()
            self._cur["post_ns"] = time.time_ns()
        return out

    # ---------------------------------------------------------------- setup
    def setup(self) -> None:
        self.phases = ph = Phases(self._sync)
        from lsnet_torch import apis
        from lsnet_torch.core.loss import LossConfig
        from lsnet_torch.models import build_detector
        from types import MappingProxyType
        ph.mark("import lsnet_torch")

        mix, dev = self.mix, self.device
        head = self.model_cfg["bbox_head"]
        with torch.device("meta"):
            tree = ref_model.build(self.model_cfg)
        w = weights.mint(tree, self.seed, dev)
        ph.mark("weights")
        with torch.device(dev):
            model = build_detector(self.model_cfg)
        model.to(dev)           # buffers made from numpy land on the host
        model.load_state_dict(w, strict=True)
        del w
        self.model = model.train(True)
        loss_cfg = LossConfig(
            image_shape=tuple(mix["canvas"]),
            num_classes=head["num_classes"], task=head["task"],
            num_vectors=head["num_vectors"],
            point_strides=tuple(head["point_strides"]),
            point_base_scale=head["point_base_scale"],
            init_loss_weight=1.0, refine_loss_weight=2.0)
        opt = mix["optimizer"]
        self.step = apis.train_detector_step(
            model, loss_cfg, base_lr=opt["base_lr"],
            mixed_precision=mix.get("mixed_precision", True),
            sampling=MappingProxyType(dict(mix["sampling"])),
            momentum=opt["momentum"], weight_decay=opt["weight_decay"],
            clip_norm=opt["clip"], warmup_iters=opt["warmup_iters"],
            warmup_ratio=opt["warmup_ratio"])
        ph.mark("model and step")
        self.pool = generate.pool(mix, self.seed, dev)
        ph.mark("pool")
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post)
        # the checked steps: the warm-up, and what the check compares
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        params = dict(model.named_parameters())
        p0 = [params[n].detach().clone() for n in names]
        self.prog = {"loss": [], "grad_norm": None, "change_leaf": None,
                     "names": names}
        self._capture = []          # the head's maps of each checked step
        for i in range(mix["checked_steps"]):
            m = self._step(self.pool[i])
            self.prog["loss"].append({k: float(m[k]) for k in TERMS})
            if i == 0:
                self.prog["grad_norm"] = float(m["grad_norm"])
        self.prog["change_leaf"] = [float(torch.linalg.vector_norm(
            params[n].detach() - a)) for n, a in zip(names, p0)]
        self.prog["maps"], self._capture = self._capture, None
        del p0
        ph.mark("checked steps")

    def _step(self, batch: Dict) -> Dict:
        if self.fault == "half":
            half = batch["image"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        if self.fault == "frozen":
            held = [p.detach().clone() for p in self.model.parameters()]
        m = self.step(batch)
        loss = float(m["loss"])            # the step's loss on the host
        if self.fault == "frozen":
            with torch.no_grad():
                for p, h in zip(self.model.parameters(), held):
                    p.copy_(h)
        m = dict(m)
        m["loss"] = loss
        return m

    # --------------------------------------------------------------- window
    def window(self, seconds: float, trace: bool) -> Dict:
        mix = self.mix
        P = len(self.pool)
        first = mix["checked_steps"]
        lat: List[float] = []
        prof = (Profiler(start_at=int(mix["profile_start"]),
                         count=int(mix["profile_batches"]),
                         sync=self._sync) if trace else None)
        self.tracing = trace
        # the steps before the profile: the layers' spans and the time a
        # step takes, free of the profiler's cost
        spans: List[Dict] = []
        before: List[float] = []
        t_start = time.perf_counter()
        end = t_start + seconds
        n = 0
        t_last = t_start
        while time.perf_counter() < end or (prof and not prof.done):
            b = self.pool[first + n % (P - first)]
            if prof:
                prof.before(n)
                profiled = prof.started
            t0 = time.perf_counter()
            self._step(b)
            t1 = time.perf_counter()
            if trace:
                cur = self._cur
                cur["done"] = self._event()
                if not profiled:
                    spans.append(cur)
                    before.append(t1 - t0)
                prof.span("forward", cur["pre_ns"], cur["post_ns"])
                prof.span("loss_backward", cur["post_ns"], time.time_ns())
                prof.after(n)
            if t1 <= end:
                lat.append(t1 - t0)
                t_last = t1
            n += 1
        self._sync()
        self.tracing = False
        rec = {"steps": len(lat), "images": len(lat) * mix["batch"],
               "attempted": len(lat), "failed": 0,
               "window_s": t_last - t_start, "latencies_s": lat}
        if trace:
            torch.cuda.synchronize()
            rec["forward_ms"] = [s["pre"].elapsed_time(s["post"])
                                 for s in spans]
            rec["loss_backward_ms"] = [s["post"].elapsed_time(s["done"])
                                       for s in spans]
            rec["stretch"] = prof.stretch
            rec["batch_s"] = sum(before) / len(before)
        return rec

    def end_to_end(self, rec: Dict) -> Dict[str, float]:
        return {"train_img_s": rec["images"] / rec["window_s"]}

    def layer_context(self, rec: Dict) -> Dict:
        return {"entry": "train", "model": self.model_cfg, "mix": self.mix,
                "record": rec, "stretch": rec.get("stretch"),
                "median": median}

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        del self.model, self.step
        import gc
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def reference_steps(self, control: Optional[str] = None,
                        follow: Optional[Dict] = None) -> Dict:
        """The reference's checked steps from the run's weights on the
        run's batches, one image at a time (float32, TF32 off; with
        ``control`` its products rounded to that precision, and its head's
        maps kept). With ``follow`` (the program's or the control's run)
        the refine stage assigns from the boxes that run's own init maps
        decode to, as that run assigned them, and the first step's maps
        are held against that run's (``maps_rel_err``)."""
        if self.device != "cpu":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        mix, head = self.mix, self.model_cfg["bbox_head"]
        strides = head["point_strides"]
        opt = mix["optimizer"]
        with torch.device("meta"):
            tree = ref_model.build(self.model_cfg)
        w = weights.mint(tree, self.seed, self.device)
        with torch.device(self.device):
            net = ref_model.build(self.model_cfg)
        net.load_state_dict(w, strict=True)
        net.eval()          # GroupNorm and FrozenBatchNorm: the same maths
        del w
        run = net
        if control:
            from ..control import lowered
            run = lowered(net, control)
        names = [n for n, p in net.named_parameters() if p.requires_grad]
        params = [dict(net.named_parameters())[n] for n in names]
        p0 = [p.detach().clone() for p in params]
        bufs: List = [None] * len(params)
        out = {"loss": [], "names": names, "maps": []}
        gap = {k: 0.0 for k in MAP_KINDS}
        for i in range(mix["checked_steps"]):
            b = self.pool[i]
            B = b["image"].shape[0]
            theirs = follow["maps"][i] if follow else None
            args = [(b["gt_bboxes"][j], b["gt_labels"][j].long(),
                     b["gt_valid"][j], b["pad_shape"][j].tolist(), strides,
                     head["num_classes"]) for j in range(B)]
            owners, n_i, n_r = [], 0, 0
            with torch.no_grad():
                for j in range(B):
                    if theirs is not None and j < len(theirs["cls"][0]):
                        init = [m[j] for m in theirs["bbox_init"]]
                    else:
                        init = [m[0] for m in run(b["image"][j:j + 1],
                                                  ref_model.TRAIN)
                                ["bbox_init"]]
                    own = ref_loss.assign(init, args[j][0], args[j][2],
                                          args[j][3], strides)
                    owners.append(own)
                    n_i += max(int((own[0] >= 0).sum()), 1)
                    n_r += max(int((own[1] >= 0).sum()), 1)
            for p in params:
                p.grad = None
            terms = dict.fromkeys(TERMS, 0.0)
            kept = {k: [] for k in MAP_KINDS}
            for j in range(B):
                outs = run(b["image"][j:j + 1], ref_model.TRAIN)
                outs = {k: [m[0] for m in v] for k, v in outs.items()}
                if control:
                    for k in MAP_KINDS:
                        kept[k].append([m.detach() for m in outs[k]])
                if i == 0 and follow and j >= len(theirs["cls"][0]):
                    # an image the run gave no maps for: the whole gap
                    gap = dict.fromkeys(MAP_KINDS, 1.0)
                elif i == 0 and follow:
                    for k in MAP_KINDS:
                        d2 = sum(float((m[j].float() - q.detach())
                                       .square().sum())
                                 for m, q in zip(theirs[k], outs[k]))
                        r2 = sum(float(q.detach().square().sum())
                                 for q in outs[k])
                        gap[k] = max(gap[k], (d2 / max(r2, 1e-30)) ** 0.5)
                t = ref_loss.image_terms(outs, *args[j], owners=owners[j])
                parts = {"loss_cls": t["cls"] / n_r,
                         "loss_bbox_init": 1.0 * t["init"] / n_i,
                         "loss_bbox_refine": 2.0 * t["refine"] / n_r}
                sum(parts.values()).backward()
                for k in TERMS:
                    terms[k] += float(parts[k].detach())
            if control:
                # per level (B, H, W, C), as the program's hook keeps them
                out["maps"].append({k: [torch.stack(lv) for lv in
                                        zip(*kept[k])] for k in MAP_KINDS})
            grads = [p.grad.detach() for p in params]
            norm, clipped = ref_loss.sgd_step(
                params, grads, bufs, i, clip=opt["clip"],
                wd=opt["weight_decay"], momentum=opt["momentum"])
            out["loss"].append(terms)
            if i == 0:
                out["grad_norm"] = float(norm)
                out["grad_leaf"] = [float(torch.linalg.vector_norm(g))
                                    for g in clipped]
        out["change_leaf"] = [float(torch.linalg.vector_norm(p.detach() - a))
                              for p, a in zip(params, p0)]
        if follow:
            out["maps_gap"] = gap
        return out

    def check(self) -> Dict[str, float]:
        return compare(self.prog, self.reference_steps(follow=self.prog))

    def control_numbers(self, precision: str) -> Dict[str, float]:
        """The control's numbers: the reference in ``precision`` in the
        program's place, against the reference."""
        ctl = self.reference_steps(precision)
        return compare(ctl, self.reference_steps(follow=ctl))



Entry = Train

def _leaf_gaps(prog: List[float], ref: List[float],
               keep: List[bool]) -> List[float]:
    """Each kept leaf's gap: the gap between the two norms over the
    reference's norm or the median leaf's, whichever is larger."""
    med = median(ref) or 0.0
    return [abs(p - r) / max(r, med, 1e-30)
            for p, r, k in zip(prog, ref, keep) if k]


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers of a run (``prog``: the program's or the control's)
    against the reference's steps. Leaves whose reference gradient is
    under a thousandth of the median leaf's are left out of the change."""
    if sorted(prog["names"]) != sorted(ref["names"]):
        raise AssertionError("the program and the reference train other "
                             "leaves")
    at = {n: i for i, n in enumerate(ref["names"])}
    grad = [ref["grad_leaf"][at[n]] for n in prog["names"]]
    change = [ref["change_leaf"][at[n]] for n in prog["names"]]
    med = median(grad) or 0.0
    moving = [g >= 1e-3 * med for g in grad]
    gaps = _leaf_gaps(prog["change_leaf"], change, moving)
    return {"maps_rel_err": max(ref["maps_gap"].values()),
            "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"])
            / ref["grad_norm"],
            "change_median_gap": median(gaps)}
