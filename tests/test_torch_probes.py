"""The four probes of the port against the JAX probes they replace.

On the CPU the JAX probes run in Pallas interpret mode
(``lsnet_tpu.ops.pallas_dma_gather.probe`` and ``tools/probe_dma2.py``
``probe_a/b/c``, loaded with importlib) and must pass; the port's wrappers
run their plain versions, which must equal the numpy expression each JAX
probe checks itself against, on inputs that equal the JAX probes' inputs
bit for bit. Tolerances: the two copies exact; the sum atol 1e-3 (f32
sums of 8 bf16 values, each exact in f32); the dot rtol 1e-3 (f32 sums of
1,024 products in another order than numpy's).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsnet_tpu.ops import pallas_dma_gather as pdg
from lsnet_torch.ops import probes
from lsnet_torch.tools import probe as probe_tool

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probe_dma2():
    spec = importlib.util.spec_from_file_location(
        "probe_dma2", REPO / "tools" / "probe_dma2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f32(x):
    return x.float().numpy()


def _jax_inputs(name):
    """The inputs as the JAX probes build them (the expressions of
    ``pallas_dma_gather.probe`` and ``probe_dma2.probe_a/b/c``)."""
    if name == "probe_row_copy":
        return (jnp.arange(8 * 128, dtype=jnp.float32).reshape(8, 128),)
    if name == "probe_block_gather":
        x = jnp.arange(32 * 8 * 128, dtype=jnp.float32).reshape(32 * 8, 128)
        return x.astype(jnp.bfloat16), jnp.asarray([5], jnp.int32)
    if name == "probe_subrow_sum":
        x = jnp.arange(16 * 8 * 128, dtype=jnp.float32)
        return (x.reshape(16, 8, 128).astype(jnp.bfloat16),)
    rng = np.random.RandomState(0)
    return (jnp.asarray(rng.randn(16, 8, 128), jnp.bfloat16),
            jnp.asarray(rng.randn(8, 128, 128) / 16, jnp.bfloat16))


def _bits(x):
    """The raw bits of a numpy / jax / torch array, bf16 included."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("name", probes.PROBES)
def test_probe_inputs_equal_the_jax_probes_inputs(name):
    got = probes.probe_inputs(name)
    want = _jax_inputs(name)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == tuple(w_.shape)
        assert str(g.dtype).split(".")[-1] == str(w_.dtype)
        np.testing.assert_array_equal(_bits(g), _bits(w_))


def test_row_copy(probe_dma2):
    assert pdg.probe()                       # the JAX probe, interpret mode
    (x,) = probes.probe_inputs("probe_row_copy")
    got = probes.probe_row_copy(x)
    assert got.shape == (1, 128) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[0], x.numpy()[0])
    assert torch.equal(got, probes.probe_row_copy_ref(x))


def test_block_gather(probe_dma2):
    assert probe_dma2.probe_a()
    x, idx = probes.probe_inputs("probe_block_gather")
    got = probes.probe_block_gather(x, idx)
    assert got.shape == (8, 128) and got.dtype == torch.bfloat16
    assert torch.equal(got, x[40:48])        # exactly x[idx*8 : idx*8+8]
    # many indices, out-of-range ones clamped to the blocks x has
    many = torch.tensor([31, 0, 5, 5, 99, -3], dtype=torch.int32)
    got = probes.probe_block_gather(x, many)
    want = torch.cat([x[i * 8:i * 8 + 8] for i in (31, 0, 5, 5, 31, 0)])
    assert torch.equal(got, want)


def test_subrow_sum(probe_dma2):
    assert probe_dma2.probe_b()
    (x,) = probes.probe_inputs("probe_subrow_sum")
    got = probes.probe_subrow_sum(x)
    assert got.shape == (16, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _f32(x).sum(axis=1), rtol=0,
                               atol=1e-3)


def test_subrow_dot(probe_dma2):
    assert probe_dma2.probe_c()
    x, w = probes.probe_inputs("probe_subrow_dot")
    got = probes.probe_subrow_dot(x, w)
    assert got.shape == (16, 128) and got.dtype == torch.float32
    xf, wf = _f32(x), _f32(w)
    want = sum(xf[:, j, :] @ wf[j] for j in range(8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name,args,error", [
    ("probe_row_copy", (torch.zeros(8),), ValueError),
    ("probe_block_gather", (torch.zeros(12, 128),
                            torch.zeros(1, dtype=torch.int32)), ValueError),
    ("probe_block_gather", (torch.zeros(16, 128),
                            torch.zeros(1, dtype=torch.int64)), TypeError),
    ("probe_subrow_sum", (torch.zeros(16, 8, 128),), TypeError),  # f32
    ("probe_subrow_sum", (torch.zeros(16, 4, 128,
                                      dtype=torch.bfloat16),), ValueError),
    ("probe_subrow_dot", (torch.zeros(16, 8, 128, dtype=torch.bfloat16),
                          torch.zeros(8, 128, 64, dtype=torch.bfloat16)),
     ValueError),
])
def test_wrappers_reject_bad_input(name, args, error):
    with pytest.raises(error):
        getattr(probes, name)(*args)


@pytest.mark.parametrize("nbytes,ok", [(512, True), (2048, True),
                                       (16384, True), (24, False),
                                       (0, False), (16400, False)])
def test_copy_byte_rule(nbytes, ok):
    """The copy kernels move multiples of 16 bytes up to their 16 KB
    shared buffer."""
    if ok:
        probes._check_copy_bytes("a row", nbytes)
    else:
        with pytest.raises(ValueError, match="bytes"):
            probes._check_copy_bytes("a row", nbytes)


def test_probe_inputs_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown probe"):
        probes.probe_inputs("probe_z")


def test_tool_passes_on_the_plain_versions(capsys):
    assert probe_tool.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        *probes.PROBES, "deform_gather_contract"]
    assert all(": OK" in ln for ln in lines)


def test_tool_names_a_failure_and_exits_nonzero(monkeypatch, capsys):
    """A probe that raises becomes a FAIL line, a wrong result a WRONG
    RESULT line; the others still run and the exit code is 1."""
    def boom(x):
        raise RuntimeError("probe_subrow_sum launch failed: CUDA error 9\n"
                           "second line")

    monkeypatch.setattr(probes, "probe_subrow_sum", boom)
    monkeypatch.setattr(probes, "probe_row_copy", lambda x: x[1:2].clone())
    assert probe_tool.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("probe_row_copy: WRONG RESULT")
    assert out[1].startswith("probe_block_gather: OK")
    assert out[2] == ("probe_subrow_sum: FAIL (RuntimeError) "
                      "probe_subrow_sum launch failed: CUDA error 9")
    assert out[3].startswith("probe_subrow_dot: OK")


def test_tool_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_tool.main([]) == 1
    from lsnet_torch.tools import bench_gather
    assert bench_gather.main([]) == 1
