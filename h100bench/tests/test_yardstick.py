"""The yardstick's copies against their originals: the kernels' work and
bounds against the chip smoke test's, at one shape of each site (shapes
only, on the ``meta`` device), and the forward's FLOPs against the
port's ``get_flops`` at a narrow width."""

from __future__ import annotations

import pytest
import torch

from h100bench.work import flops, kernels, sites

SAMPLING = {"backbone": "nearest", "tower": "bilinear", "refine": "bilinear"}
TRAIN = dict.fromkeys(SAMPLING, "bilinear")


def smoke():
    import chip_smoke
    return chip_smoke


def as_args(c: kernels.Call, dtype=torch.bfloat16):
    """The chip smoke test's (flat, idx, w, weight) of a call."""
    m = torch.device("meta")
    return (torch.empty(c.rows, c.C, dtype=dtype, device=m),
            torch.empty(c.nc, c.K, c.px, dtype=torch.int32, device=m),
            torch.empty(c.nc, c.K, c.px, dtype=torch.float32, device=m),
            torch.empty(c.K, c.cin, c.cout, dtype=dtype, device=m))


def site_calls():
    from lsnet_torch import configs
    x101 = configs.x101_flagship_cfg()
    k1 = sites.k1_calls(x101, 2, (800, 1344), SAMPLING)
    k3 = sites.k3_calls(x101, 2, (800, 1344), SAMPLING)
    k3t = sites.k3_calls(x101, 2, (800, 1344), TRAIN)
    # a tower call, a refine call, the stride-2 and a stride-1 grouped call
    # of each stage (c3 at 0 and 1, c4 at 4 and 5, c5 at 27 and 28)
    return [k1[0], k1[-1]] + [k3[i] for i in (0, 1, 4, 5, 27, 28)] + [k3t[5]]


@pytest.mark.parametrize("i", range(9))
def test_work_equals_the_smoke_tests(i):
    cs = smoke()
    c = site_calls()[i]
    args = as_args(c)
    for mine, theirs in ((kernels.work, cs.work),
                         (kernels.work_bwd_data, cs.work_bwd_data),
                         (kernels.work_bwd_weight, cs.work_bwd_weight)):
        assert mine(c) == theirs(args)
        assert kernels.bound_ms(c, mine) == cs.bound_ms(args, theirs)


def test_site_shapes():
    """The shapes the smoke test gives the main path at B=2: its head
    levels and its X-101 stages."""
    cs = smoke()
    from lsnet_torch import configs
    k1 = sites.k1_calls(configs.x101_flagship_cfg(), cs.B, (cs.H, cs.W),
                        SAMPLING)
    px = cs.B * sum(h * w for h, w in cs.LEVELS)
    assert len(k1) == cs.K1_PER_FORWARD["bbox"]
    assert {c.px for c in k1} == {px, 3 * px}
    k3 = sites.k3_calls(configs.x101_flagship_cfg(), cs.B, (cs.H, cs.W),
                        SAMPLING)
    assert len(k3) == cs.GROUPED_PER_FORWARD
    want = []
    for _, (h, w), C, n in cs.X101_STAGES:
        want += [(cs.B * h * w, C // cs.GROUPS, C)] * n
    assert [(c.px, c.cin, c.cout) for c in k3] == want
    assert sites.k3_calls(configs.flagship_r50_cfg(), 2, (800, 1344),
                          SAMPLING) == []


@pytest.mark.parametrize("name", ("flagship_r50_cfg", "x101_flagship_cfg"))
def test_forward_flops_equal_get_flops(name):
    from lsnet_torch import configs
    from lsnet_torch.tools import get_flops
    from lsnet_torch.utils.config import Config
    model = getattr(configs, name)(feat=32, stacked=1)
    canvas = (128, 192)
    _, theirs = get_flops.count(Config(dict(model=model)), canvas,
                                device="cpu")
    mine = flops.count(model, 1, canvas, TRAIN, counter=True)
    assert mine["forward"] == theirs == mine["counter"]
    assert mine["forward"] < mine["train"] < 3 * mine["forward"]
    assert flops.count(model, 3, canvas, TRAIN)["forward"] == 3 * theirs
