"""The port's optical-flow ops (``lsnet_torch/ops/optflow.py``) and
profiling utilities (``lsnet_torch/utils/profiling.py``) against the JAX
package's, on the CPU.

* ``flow_warp`` equals JAX's to 1e-5 in both modes, one image and a batch,
  f32 and uint8 images, with sample points on and around the exclusive
  H-1 / W-1 edge and outside the image (the fill value), and with a fill
  value of its own.
* ``quantize_flow`` / ``dequantize_flow`` give JAX's arrays; ``.flo``
  files and quantised images round-trip and read the same in both
  packages.
* ``profile_time`` prints JAX's format; ``trace`` writes a TensorBoard
  trace file with the block's operators; ``StepTimer`` counts as JAX's.
"""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_torch import ops as p_ops
from lsnet_torch.ops import optflow as p_flow
from lsnet_torch.utils import profiling as p_prof
from lsnet_tpu.ops import optflow as j_flow
from lsnet_tpu.utils import profiling as j_prof


def _edge_flow(rng, shape):
    """Flows that put points on the H-1 / W-1 edge, just inside and out
    of it, at 0 and outside the image, and at random elsewhere."""
    H, W = shape[-3], shape[-2]
    flow = (3.0 * rng.randn(*shape)).astype(np.float32)
    hh, ww = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # row 0: x exactly H - 1 (excluded); row 1: just under H - 1
    flow[..., 0, :, 1] = H - 1 - hh[0]
    flow[..., 1, :, 1] = H - 1 - hh[1] - 1e-3
    # column 0: y exactly W - 1; column 1: just under; column 2: exactly 0
    flow[..., :, 0, 0] = W - 1 - ww[:, 0]
    flow[..., :, 1, 0] = W - 1 - ww[:, 1] - 1e-3
    flow[..., :, 2, 0] = -ww[:, 2]
    # half-way points, where nearest rounds up
    flow[..., 3, :, :] = 0.5
    return flow


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_flow_warp_matches_jax(mode, batched, dtype):
    rng = np.random.RandomState(0)
    shape = (2, 11, 13) if batched else (11, 13)
    img = (rng.rand(*shape, 3) * 255).astype(dtype)
    flow = _edge_flow(rng, (*shape, 2))
    for fill in (0, 7.5):
        want = np.asarray(j_flow.flow_warp(jnp.asarray(img),
                                           jnp.asarray(flow), fill, mode))
        got = p_flow.flow_warp(torch.from_numpy(img), torch.from_numpy(flow),
                               fill, mode)
        assert got.dtype == torch.from_numpy(img).dtype
        assert got.shape == img.shape
        np.testing.assert_allclose(got.numpy().astype(np.float64),
                                   want.astype(np.float64), rtol=1e-5,
                                   atol=1e-5 * 255)
        filled = (got.numpy() == np.asarray(fill, dtype)).all(-1)
        assert filled[..., 0, :].all()          # x == H - 1 is outside
        assert not filled[..., 1, 3:].all()     # just under it is not


def test_flow_warp_rejects_an_unknown_mode():
    img = torch.zeros(4, 4, 1)
    with pytest.raises(ValueError, match="interpolate_mode"):
        p_flow.flow_warp(img, torch.zeros(4, 4, 2), interpolate_mode="cubic")


def test_quantize_matches_jax():
    rng = np.random.RandomState(2)
    flow = (0.03 * rng.uniform(-1, 1, (6, 8, 2))).astype(np.float32)
    for norm in (False, True):
        got = p_flow.quantize_flow(flow, norm=norm)
        want = j_flow.quantize_flow(flow, norm=norm)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            p_flow.dequantize_flow(*got, denorm=norm),
            j_flow.dequantize_flow(*want, denorm=norm))


def test_flow_files_round_trip(tmp_path):
    rng = np.random.RandomState(3)
    flow = rng.randn(5, 7, 2).astype(np.float32)
    path = str(tmp_path / "a.flo")
    p_ops.flowwrite(flow, path)
    np.testing.assert_array_equal(p_ops.flowread(path), flow)
    np.testing.assert_array_equal(j_flow.flowread(path), flow)
    assert p_ops.flowread(flow) is flow
    with pytest.raises(ValueError):
        p_ops.flowread(np.zeros((3, 3, 3), np.float32))
    small = (0.015 * rng.uniform(-1, 1, (6, 8, 2))).astype(np.float32)
    for axis in (0, 1):
        q = str(tmp_path / f"q{axis}.png")
        p_ops.flowwrite(small, q, quantize=True, concat_axis=axis)
        got = p_ops.flowread(q, quantize=True, concat_axis=axis)
        np.testing.assert_array_equal(
            got, j_flow.flowread(q, quantize=True, concat_axis=axis))
        # 1.5 bins of 0.04 / 255 at the image's width of 8
        np.testing.assert_allclose(got, small, atol=1.5 * 0.04 / 255 * 8)


def test_profile_time_prints_jax_format():
    got, want = io.StringIO(), io.StringIO()
    with p_prof.profile_time("trace", "block", stream=got):
        pass
    with j_prof.profile_time("trace", "block", stream=want):
        pass
    g, w = got.getvalue().split(), want.getvalue().split()
    assert g[:3] == w[:3] == ["trace", "block", "elapsed_time"]
    assert g[4:] == w[4:] == ["ms"] and "." in g[3]
    assert len(g[3].split(".")[1]) == 2
    quiet = io.StringIO()
    with p_prof.profile_time("t", "n", enabled=False, stream=quiet):
        pass
    assert quiet.getvalue() == ""


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with p_prof.trace(str(tmp_path)) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert prof is not None
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    events = json.load(open(tmp_path / name))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    with p_prof.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    assert not os.path.exists(tmp_path / "off")


def test_step_timer():
    got, want = p_prof.StepTimer(), j_prof.StepTimer()
    for timer in (got, want):
        timer.mark_data()
        timer.mark_step()
        assert timer.metrics().keys() == {"data_time", "time"}
        assert all(v >= 0 for v in timer.metrics().values())
