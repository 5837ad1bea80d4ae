"""The deformable kernels' calls of one batch, derived from a
configuration's model dict, the batch and the canvas.

K1 (the head's gather + contraction): each DCN block of the cls and bbox
towers is one call over all FPN levels; the pyramid refine that bbox and
cls share is two calls (one corner table, two contractions) over three
source levels per output level. K3 (the backbone's grouped gather +
contraction): one call per block of each DCN stage, the first block
sampling at stride 2 from the map of the stage before. A bilinear site
reads 4 corners a tap, a nearest one 1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .kernels import Call

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def level_shapes(canvas: Sequence[int], strides: Sequence[int]
                 ) -> List[Tuple[int, int]]:
    return [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in strides]


def k1_calls(model: Dict, batch: int, canvas: Sequence[int],
             sampling: Dict[str, str]) -> List[Call]:
    head = model["bbox_head"]
    levels = level_shapes(canvas, head["point_strides"])
    n_px = batch * sum(h * w for h, w in levels)
    c = head["feat_channels"]
    nc = 4 if sampling["tower"] == "bilinear" else 1
    towers = 2 * head["stacked_convs"]
    calls = [Call(n_px, c, nc, 9, n_px, c, c)] * towers
    nc = 4 if sampling["refine"] == "bilinear" else 1
    refine_px = 3 * n_px
    return calls + [Call(n_px, c, nc, 9, refine_px, c,
                         head["point_feat_channels"])] * 2


def k3_calls(model: Dict, batch: int, canvas: Sequence[int],
             sampling: Dict[str, str]) -> List[Call]:
    bb = model["backbone"]
    if bb.get("type") != "ResNeXt" or not any(bb.get("stage_with_dcn", ())):
        return []
    groups, base = bb["groups"], bb["base_width"]
    nc = 4 if sampling["backbone"] == "bilinear" else 1
    h, w = -(-canvas[0] // 4), -(-canvas[1] // 4)     # after the stem
    calls, planes = [], 64
    for si, n in enumerate(STAGE_BLOCKS[bb["depth"]]):
        width = int(planes * base / 64) * groups
        stride = 1 if si == 0 else 2
        ho, wo = -(-h // stride), -(-w // stride)
        if bb["stage_with_dcn"][si]:
            cg = width // groups
            calls.append(Call(batch * h * w, width, nc, 9, batch * ho * wo,
                              cg, width))
            calls += [Call(batch * ho * wo, width, nc, 9, batch * ho * wo,
                           cg, width)] * (n - 1)
        h, w, planes = ho, wo, planes * 2
    return calls
