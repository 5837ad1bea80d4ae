"""The one traffic generator: a mix file's parameters and the seed -> a
pool of device-resident batches.

Every seed gets the same multiset of image sizes (and of GT counts), in
an order of its own; the pixels, boxes and labels are drawn from it.
Images are normalised pixels (N(0, 1)) inside the content and 0 in the
padding, as the test pipeline pads them. A content size is an original
landscape image of one of the mix's aspect ratios, resized as
``img_scale`` resizes it (the long side at most ``img_scale[0]``, the
short side at most ``img_scale[1]``) and padded to the canvas.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch


def content_size(orig_h: int, orig_w: int, img_scale) -> tuple:
    long_max, short_max = max(img_scale), min(img_scale)
    f = min(long_max / max(orig_h, orig_w), short_max / min(orig_h, orig_w))
    return int(orig_h * f + 0.5), int(orig_w * f + 0.5), f


def _sizes(mix: Dict, n: int, rng: random.Random) -> List[tuple]:
    """n content sizes: the mix's aspects x original long sides, cycled
    to n and shuffled by the seed."""
    combos = [(a, long) for a in mix["aspects"] for long in mix["orig_long"]]
    out = []
    for i in range(n):
        (aw, ah), long = combos[i % len(combos)]
        orig_w, orig_h = long, int(round(long * ah / aw))
        out.append(content_size(orig_h, orig_w, mix["img_scale"]))
    rng.shuffle(out)
    return out


def _images(sizes, canvas, gen, device) -> torch.Tensor:
    B = len(sizes)
    img = torch.randn(B, canvas[0], canvas[1], 3, generator=gen,
                      device=device)
    h = torch.tensor([s[0] for s in sizes], device=device)
    w = torch.tensor([s[1] for s in sizes], device=device)
    rows = torch.arange(canvas[0], device=device)[None, :, None] < h[:, None,
                                                                     None]
    cols = torch.arange(canvas[1], device=device)[None, None, :] < w[:, None,
                                                                     None]
    return img * (rows & cols)[..., None]


def _gt_counts(mix: Dict, n: int, rng: random.Random) -> List[int]:
    """n GT counts at the quantiles (i + 1/2) / n of a geometric law on
    1, 2, ... with the mix's mean, cut at ``max_gt``; shuffled."""
    p = 1.0 / mix["gt_mean"]
    counts = [min(mix["max_gt"], max(1, math.ceil(
        math.log(1 - (i + 0.5) / n) / math.log(1 - p)))) for i in range(n)]
    rng.shuffle(counts)
    return counts


def _boxes(mix: Dict, count: int, h: int, w: int, gen, device):
    """count boxes: size class by the mix's shares, sqrt(area)
    log-uniform in the class's range, aspect log-uniform, centre uniform
    over the content, clipped to it."""
    shares = torch.tensor([c["share"] for c in mix["size_classes"]],
                          device=device)
    cls = torch.multinomial(shares, count, replacement=True, generator=gen)
    lo = torch.tensor([c["sqrt_area"][0] for c in mix["size_classes"]],
                      device=device).log()[cls]
    hi = torch.tensor([c["sqrt_area"][1] for c in mix["size_classes"]],
                      device=device).log()[cls]
    u = torch.rand(4, count, generator=gen, device=device)
    side = torch.exp(lo + (hi - lo) * u[0])
    ar = torch.exp(math.log(mix["aspect"][0]) + u[1] * math.log(
        mix["aspect"][1] / mix["aspect"][0]))               # h / w
    bw, bh = side / ar.sqrt(), side * ar.sqrt()
    cx, cy = u[2] * w, u[3] * h
    x1 = (cx - bw / 2).clamp(0, w - 2)
    y1 = (cy - bh / 2).clamp(0, h - 2)
    x2 = torch.maximum((cx + bw / 2).clamp(max=w), x1 + 1)
    y2 = torch.maximum((cy + bh / 2).clamp(max=h), y1 + 1)
    return torch.stack([x1, y1, x2, y2], -1)


def pool(mix: Dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The mix's ``pool_batches`` batches of ``batch`` images."""
    rng = random.Random(int(seed))
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 1) % 2 ** 63)
    B, n = mix["batch"], mix["pool_batches"]
    canvas = tuple(mix["canvas"])
    sizes = _sizes(mix, B * n, rng)
    counts = (_gt_counts(mix, B * n, rng) if mix["entry"] == "train"
              else None)
    out = []
    for i in range(n):
        sz = sizes[i * B:(i + 1) * B]
        batch = {
            "image": _images(sz, canvas, gen, device),
            "img_shape": torch.tensor([[h, w] for h, w, _ in sz],
                                      dtype=torch.int32, device=device),
            "scale_factor": torch.tensor([[f] * 4 for *_, f in sz],
                                         dtype=torch.float32, device=device),
        }
        if counts is not None:
            M = mix["max_gt"]
            boxes = torch.zeros(B, M, 4, device=device)
            valid = torch.zeros(B, M, dtype=torch.bool, device=device)
            for b, (h, w, _) in enumerate(sz):
                k = counts[i * B + b]
                boxes[b, :k] = _boxes(mix, k, h, w, gen, device)
                valid[b, :k] = True
            div = mix["pad_divisor"]
            batch.update(
                gt_bboxes=boxes, gt_valid=valid,
                gt_labels=torch.randint(0, mix["num_classes"], (B, M),
                                        generator=gen, device=device
                                        ) * valid,
                pad_shape=torch.tensor(
                    [[-(-h // div) * div, -(-w // div) * div]
                     for h, w, _ in sz], dtype=torch.int32, device=device))
        out.append(batch)
    return out
