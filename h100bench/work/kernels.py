"""Operations and bytes of the deformable kernels, from their arguments'
shapes, and the least time the H100 could take for them.

Copied from the chip smoke test's ``work``, ``work_bwd_data``,
``work_bwd_weight`` and ``bound_ms``, and written over shapes instead of
tensors. A call is ``Call(rows, C, nc, K, px, cin, cout, elem)``: the
flat feature buffer (rows x C), the corner table (nc corners x K taps x
px output pixels; int32 indices and f32 weights), the weight (K, cin =
C / groups, cout) and the output (px, cout), the features, weight and
output in ``elem`` bytes a number. Each input byte is counted once and
each output byte once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them,
# HBM3 bandwidth
PEAK_OPS = {2: 989e12, 4: 67e12}
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


class Call(NamedTuple):
    rows: int
    C: int
    nc: int
    K: int
    px: int
    cin: int
    cout: int
    elem: int = 2


def work(c: Call) -> Tuple[int, int]:
    """The forward: corner weighting and the products of each output with
    its (K, cin) inputs."""
    ops = 2 * c.K * c.px * c.cin * c.cout + 2 * c.nc * c.K * c.px * c.C
    nbytes = (c.rows * c.C * c.elem + c.nc * c.K * c.px * 4
              + c.nc * c.K * c.px * 4 + c.K * c.cin * c.cout * c.elem
              + c.px * c.cout * c.elem)
    return ops, nbytes


def work_bwd_data(c: Call) -> Tuple[int, int]:
    """bwd-data: the forward's product once (G = dout @ W^T), two passes
    over the corners (the d_w dot products and the weighted scatter); it
    reads flat, the table, the weight and dout and writes d_flat in f32
    and d_w."""
    ops = 2 * c.K * c.px * c.cin * c.cout + 2 * (2 * c.nc * c.K * c.px * c.C)
    nbytes = (c.rows * c.C * c.elem + c.nc * c.K * c.px * 4
              + c.nc * c.K * c.px * 4 + c.K * c.cin * c.cout * c.elem
              + c.px * c.cout * c.elem + c.rows * c.C * 4
              + c.nc * c.K * c.px * 4)
    return ops, nbytes


def work_bwd_weight(c: Call) -> Tuple[int, int]:
    """bwd-weight: the product once (V^T @ dout) and the corner
    weighting; it reads flat, the table and dout and writes d_weight."""
    ops = 2 * c.K * c.px * c.cin * c.cout + 2 * c.nc * c.K * c.px * c.C
    nbytes = (c.rows * c.C * c.elem + c.nc * c.K * c.px * 4
              + c.nc * c.K * c.px * 4 + c.px * c.cout * c.elem
              + c.K * c.cin * c.cout * c.elem)
    return ops, nbytes


def bound_ms(c: Call, fn=work) -> Tuple[float, str]:
    """(the least milliseconds, "operations" or "bytes": which bounds)."""
    ops, nbytes = fn(c)
    t_ops = ops / PEAK_OPS[c.elem] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
