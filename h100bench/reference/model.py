"""Plain float32 reference of the LSNet bbox detector: ResNet-50 or
ResNeXt-101 64x4d with grouped DCNv2 in c3-c5, FPN with GN, and LSHead
(DCNv2 towers, init branch, cross-level pyramid refine paired with cls).

Written from the published description (LSNet, arXiv 2104.04899; the
mmdet-style configs under ``configs/lsnet/``), in plain torch ops. The
deformable convolutions sample with explicit gathers: every tap reads
its corners from the flattened map, weighs them, and the taps are
contracted with one ``einsum``. Nothing here imports the program under
test. Parameter names and shapes follow the program's module tree, so
one dict of minted weights loads into both.

Layout: modules take NCHW maps; the deformable weights are HWIO
(kh, kw, cin / groups, cout) with group-major cout; offsets are
``[y0, x0, y1, x1, ...]`` per tap, taps row-major.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NEAREST = "nearest"
BILINEAR = "bilinear"
# sampling of each site at inference and in training (the configs'
# deploy default: nearest at the backbone's DCN, bilinear elsewhere)
INFERENCE = {"backbone": NEAREST, "tower": BILINEAR, "refine": BILINEAR}
TRAIN = {"backbone": BILINEAR, "tower": BILINEAR, "refine": BILINEAR}

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


# ----------------------------------------------------------------- sampling

def sample(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
           mode: str) -> torch.Tensor:
    """feat (H, W, C) at positions ys, xs (any shape S) -> (S..., C).
    Zero outside the map. Bilinear: four corners weighted by the tent
    ``1 - |d|``; nearest: the rounded position (half to even)."""
    H, W, C = feat.shape
    flat = feat.reshape(H * W, C)

    def read(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        row = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        return flat[row.reshape(-1)].reshape(*row.shape, C), ok

    if mode == NEAREST:
        v, ok = read(torch.round(ys).long(), torch.round(xs).long())
        return v * ok[..., None]
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    y0, x0 = y0f.long(), x0f.long()
    out = 0.0
    for dy in (0, 1):
        wy = 1.0 - (ys - y0f - dy) if dy == 0 else 1.0 + (ys - y0f - dy)
        for dx in (0, 1):
            wx = 1.0 - (xs - x0f - dx) if dx == 0 else 1.0 + (xs - x0f - dx)
            v, ok = read(y0 + dy, x0 + dx)
            out = out + v * (wy * wx * ok)[..., None]
    return out


def deform_conv(x: torch.Tensor, offset: torch.Tensor,
                mask, weight: torch.Tensor, *, stride: int = 1,
                pad: int = 1, dil: int = 1, groups: int = 1,
                scale: Tuple[float, float] = (1.0, 1.0),
                mode: str = BILINEAR, owner=None) -> torch.Tensor:
    """One image. x (C, H, W); offset (2K, Ho, Wo) [y, x] per tap; mask
    (K, Ho, Wo) or None; weight (kh, kw, C / groups, cout) -> (cout, Ho,
    Wo). Tap (i, j) of output (h, w) reads the input at
    ``((h*stride - pad + i*dil) * scale_h + off_y, ...)``. The calling
    module ``owner`` may carry a ``tally`` list, which receives (the
    product's FLOPs, the weight), and a ``round_fn``, which rounds both
    operands of the product (the control's lower precision)."""
    kh, kw, cg, cout = weight.shape
    K = kh * kw
    _, Ho, Wo = offset.shape
    dev = x.device
    hs = torch.arange(Ho, device=dev, dtype=torch.float32) * stride - pad
    ws = torch.arange(Wo, device=dev, dtype=torch.float32) * stride - pad
    ti = torch.arange(kh, device=dev, dtype=torch.float32) * dil
    tj = torch.arange(kw, device=dev, dtype=torch.float32) * dil
    by = (hs.view(1, Ho, 1) + ti.repeat_interleave(kw).view(K, 1, 1)) \
        * scale[0]
    bx = (ws.view(1, 1, Wo) + tj.repeat(kh).view(K, 1, 1)) * scale[1]
    off = offset.reshape(K, 2, Ho, Wo)
    ys = by + off[:, 0]
    xs = bx + off[:, 1]
    patches = sample(x.permute(1, 2, 0), ys, xs, mode)    # (K, Ho, Wo, C)
    if mask is not None:
        patches = patches * mask[..., None]
    G = groups
    tally = getattr(owner, "tally", None)
    if tally is not None:
        tally.append((2 * K * cg * cout * Ho * Wo, weight))
    round_fn = getattr(owner, "round_fn", None)
    if round_fn is not None:
        patches, weight = round_fn(patches), round_fn(weight)
    p = patches.reshape(K, Ho * Wo, G, cg)
    wk = weight.reshape(K, cg, G, cout // G)
    out = torch.einsum("kpgc,kcgo->pgo", p, wk).reshape(Ho * Wo, cout)
    return out.t().reshape(cout, Ho, Wo)


# ------------------------------------------------------------------- layers

class FrozenBatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.var + 1e-5)
        return x * scale.view(1, -1, 1, 1) + (
            self.bias - self.mean * scale).view(1, -1, 1, 1)


class ModulatedDeformConvPack(nn.Module):
    """DCNv2: ``conv_offset`` gives 2K offsets and K mask logits."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 groups: int = 1, bias: bool = True, site: str = "tower"):
        super().__init__()
        self.stride, self.groups, self.site = stride, groups, site
        self.round_fn = self.tally = None      # see deform_conv
        self.conv_offset = nn.Conv2d(cin, 3 * k * k, k, stride=stride,
                                     padding=k // 2)
        self.weight = nn.Parameter(torch.zeros(k, k, cin // groups, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, sampling):
        K = self.weight.shape[0] * self.weight.shape[1]
        om = self.conv_offset(x)
        outs = []
        for b in range(x.shape[0]):
            outs.append(deform_conv(
                x[b], om[b, :2 * K], torch.sigmoid(om[b, 2 * K:]),
                self.weight, stride=self.stride,
                pad=self.weight.shape[0] // 2, groups=self.groups,
                mode=sampling[self.site], owner=self))
        out = torch.stack(outs)
        if self.bias is not None:
            out = out + self.bias.view(1, -1, 1, 1)
        return out


class ConvModule(nn.Module):
    """conv (no bias) + GroupNorm, no activation (the FPN's)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              bias=False)
        self.norm = nn.GroupNorm(32, cout, eps=1e-5)

    def forward(self, x):
        return self.norm(self.conv(x))


class DCNConvModule(nn.Module):
    """A head tower block: DCNv2 (with bias) + GN + ReLU."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = ModulatedDeformConvPack(c, c, 3, site="tower")
        self.bn = nn.GroupNorm(32, c, eps=1e-5)

    def forward(self, x, sampling):
        return F.relu(self.bn(self.conv(x, sampling)))


# ----------------------------------------------------------------- backbone

class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride, downsample, dcn, groups,
                 base_width):
        super().__init__()
        width = (planes if groups == 1
                 else int(planes * base_width / 64) * groups)
        self.dcn = dcn
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        if dcn:
            self.conv2 = ModulatedDeformConvPack(
                width, width, 3, stride, groups, bias=False, site="backbone")
        else:
            self.conv2 = nn.Conv2d(width, width, 3, stride, 1,
                                   groups=groups, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, planes * 4, 1,
                                             stride, bias=False)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x, sampling):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.conv2(out, sampling) if self.dcn else self.conv2(out)
        out = F.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        idt = (self.downsample_bn(self.downsample_conv(x))
               if self.downsample else x)
        return F.relu(out + idt)


class ResNet(nn.Module):
    """'pytorch' style (stride on the 3x3), frozen stem and stage 1."""

    def __init__(self, depth: int, groups: int = 1, base_width: int = 4,
                 stage_with_dcn=(False,) * 4):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.stages: List[List[str]] = []
        inplanes, planes = 64, 64
        for si, n in enumerate(STAGE_BLOCKS[depth]):
            names = []
            for bi in range(n):
                name = f"layer{si + 1}_{bi}"
                setattr(self, name, Bottleneck(
                    inplanes, planes, (1, 2, 2, 2)[si] if bi == 0 else 1,
                    bi == 0, stage_with_dcn[si], groups, base_width))
                inplanes = planes * 4
                names.append(name)
            self.stages.append(names)
            planes *= 2
        frozen = [self.conv1, self.bn1] + [getattr(self, n)
                                           for n in self.stages[0]]
        for m in frozen:
            for p in m.parameters():
                p.requires_grad_(False)

    def forward(self, x, sampling):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for names in self.stages:
            for n in names:
                x = getattr(self, n)(x, sampling)
            outs.append(x)
        return outs


# --------------------------------------------------------------------- neck

class FPN(nn.Module):
    """Levels c3-c5 (start level 1), two extra stride-2 convs on c5."""

    def __init__(self, in_channels: Sequence[int], out: int = 256):
        super().__init__()
        used = list(in_channels[1:])
        self.n = len(used)
        for i, c in enumerate(used):
            setattr(self, f"lateral_{i}", ConvModule(c, out, 1))
            setattr(self, f"fpn_{i}", ConvModule(out, out, 3))
        self.extra_0 = ConvModule(used[-1], out, 3, 2)
        self.extra_1 = ConvModule(out, out, 3, 2)

    def forward(self, feats):
        used = feats[1:]
        lat = [getattr(self, f"lateral_{i}")(used[i]) for i in range(self.n)]
        for i in range(self.n - 1, 0, -1):
            th, tw = lat[i - 1].shape[-2:]
            H, W = lat[i].shape[-2:]
            r = torch.arange(th, device=lat[i].device) * H // th
            c = torch.arange(tw, device=lat[i].device) * W // tw
            lat[i - 1] = lat[i - 1] + lat[i][:, :, r][:, :, :, c]
        outs = [getattr(self, f"fpn_{i}")(lat[i]) for i in range(self.n)]
        e0 = self.extra_0(used[-1])
        return outs + [e0, self.extra_1(e0)]


# --------------------------------------------------------------------- head

def level_list(lvl: int, n: int) -> List[int]:
    if lvl == 0:
        return [0, 1, 2]
    if lvl == n - 1:
        return [lvl, lvl - 1, lvl - 2]
    return [lvl, lvl - 1, lvl + 1]


def signed_pairs(x: torch.Tensor) -> torch.Tensor:
    """(..., 2P) (neg, pos) slots -> (..., P): the larger slot, negated
    where the neg slot wins or ties."""
    p = x.reshape(*x.shape[:-1], -1, 2)
    val = p.amax(-1)
    return torch.where(p[..., 0] >= p[..., 1], -val, val)


class PairedPyramidDeformConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight_a = nn.Parameter(torch.zeros(3, 3, c, c))
        self.weight_b = nn.Parameter(torch.zeros(3, 3, c, c))


class LSHead(nn.Module):
    """The bbox task: a cls tower and a bbox tower of three DCN blocks,
    the bbox init branch (20 four-slot channels and 4 extra [y, x]
    sampling points), the pyramid refine that bbox and cls share."""

    def __init__(self, num_classes: int = 80, c: int = 256,
                 stacked: int = 3, gradient_mul: float = 0.1):
        super().__init__()
        self.stacked, self.g = stacked, gradient_mul
        self.round_fn = self.tally = None      # see deform_conv
        for prefix in ("cls", "bbox"):
            for i in range(stacked):
                setattr(self, f"{prefix}_convs_{i}", DCNConvModule(c))
        self.pts_bbox_init_conv = nn.Conv2d(c, c, 3, padding=1)
        self.pts_bbox_init_out = nn.Conv2d(c, 20 + 8, 1)
        self.pts_bbox_refine_out = nn.Conv2d(c, 20, 1)
        for key in ("cls", "bbox"):
            setattr(self, f"{key}_af_dcn_conv", nn.Conv2d(3 * c, c, 1))
            setattr(self, f"{key}_feat_conv", nn.Conv2d(c, c, 3, padding=1))
            setattr(self, f"{key}_GN", nn.GroupNorm(32, c, eps=1e-5))
        self.pts_bbox_cls_pair = PairedPyramidDeformConv(c)
        self.pts_cls_out = nn.Conv2d(c, num_classes, 1)

    def forward(self, feats, sampling) -> Dict[str, List[torch.Tensor]]:
        """NCHW levels -> {"cls", "bbox_init", "bbox_refine"}: NHWC level
        maps."""
        n = len(feats)
        tw = {}
        for prefix in ("cls", "bbox"):
            cur = list(feats)
            for i in range(self.stacked):
                blk = getattr(self, f"{prefix}_convs_{i}")
                cur = [blk(f, sampling) for f in cur]
            tw[prefix] = cur
        base = torch.tensor([[i - 1.0, j - 1.0] for i in range(3)
                             for j in range(3)], device=feats[0].device)
        init_sp, dcn_off = [], []
        for f in tw["bbox"]:
            raw = self.pts_bbox_init_out(F.relu(self.pts_bbox_init_conv(f)))
            raw = raw.permute(0, 2, 3, 1)                     # NHWC
            sp = F.softplus(raw[..., :20])
            reg = torch.cat([signed_pairs(sp), raw[..., 20:]], -1)
            mixed = (1 - self.g) * reg.detach() + self.g * reg
            init_sp.append(sp)
            dcn_off.append(mixed - base.reshape(-1))          # (B,H,W,18)
        shapes = [f.shape[-2:] for f in feats]
        pair = self.pts_bbox_cls_pair
        raws = {"bbox": [], "cls": []}
        mode = sampling["refine"]
        for lvl in range(n):
            Ho, Wo = shapes[lvl]
            off = dcn_off[lvl]
            for src in level_list(lvl, n):
                H, W = shapes[src]
                s = (H / Ho, W / Wo)
                # the offsets scale in place across the three sources
                off = (off.reshape(*off.shape[:-1], 9, 2)
                       * torch.tensor(s, device=off.device)
                       ).reshape(off.shape)
                for key, feat, wt in (("bbox", tw["bbox"], pair.weight_a),
                                      ("cls", tw["cls"], pair.weight_b)):
                    raws[key].append(torch.stack([deform_conv(
                        feat[src][b], off[b].permute(2, 0, 1), None, wt,
                        scale=s, mode=mode, owner=self)
                        for b in range(off.shape[0])]))
        out = {"cls": [], "bbox_init": init_sp, "bbox_refine": []}
        for lvl in range(n):
            for key in ("bbox", "cls"):
                x = F.relu(getattr(self, f"{key}_af_dcn_conv")(
                    torch.cat(raws[key][3 * lvl:3 * lvl + 3], 1)))
                x = getattr(self, f"{key}_GN")(
                    x + getattr(self, f"{key}_feat_conv")(tw[key][lvl]))
                conv = (self.pts_bbox_refine_out if key == "bbox"
                        else self.pts_cls_out)
                y = conv(F.relu(x)).permute(0, 2, 3, 1)
                if key == "bbox":
                    out["bbox_refine"].append(
                        F.softplus(y + init_sp[lvl].detach()))
                else:
                    out["cls"].append(y)
        return out


class Detector(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        bb = cfg["backbone"]
        self.backbone = ResNet(bb["depth"], bb.get("groups", 1),
                               bb.get("base_width", 4),
                               tuple(bb.get("stage_with_dcn", (False,) * 4)))
        width = 256
        self.neck = FPN([width * 2 ** i for i in range(4)],
                        cfg["neck"]["out_channels"])
        h = cfg["bbox_head"]
        self.head = LSHead(h["num_classes"], h["feat_channels"],
                           h["stacked_convs"], h["gradient_mul"])

    def forward(self, images: torch.Tensor, sampling):
        """images (B, H, W, 3) -> the head's NHWC level maps."""
        feats = self.backbone(images.permute(0, 3, 1, 2), sampling)
        return self.head(self.neck(feats), sampling)


def build(cfg: dict) -> Detector:
    return Detector(cfg)

