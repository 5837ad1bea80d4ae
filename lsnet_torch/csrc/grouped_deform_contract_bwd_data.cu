// Backward of grouped_deform_contract.cu with respect to its data: d_flat
// and d_w of the grouped function (g(n) = n / outG, C = G * Cg)
//
//   out[p, n] = sum_k sum_{i < Cg} V[k, p, g(n) Cg + i] * W[k, i, n],
//   V[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//
//   G[k, p, ch]              = sum_{n in group(ch)} dout[p, n] W[k, ch % Cg, n]
//   d_flat[idx[c, k, p], :] += w[c, k, p] * G[k, p, :]
//   d_w[c, k, p]             = flat[idx[c, k, p], :] . G[k, p, :]
//
//   flat (R, C), W (K, Cg, cout) compact, dout (px, cout) f32 or bf16;
//   idx, w (nc, K, px); d_flat (R, C) f32, zeroed by the caller; d_w
//   (nc, K, px) f32. Either output pointer may be null.
//
// Replaces the TPU kernel lsnet_tpu/ops/pallas_grouped.py `_make_dv_kernel`
// (the first pallas_call of `_gdc_bwd`), which writes the patch-tensor
// gradient dvals (px, K*C) to device memory for XLA to weight and
// scatter. Here G (= dvals) is built tile by tile in shared memory and
// goes straight into the scatter and the d_w dot products, as vals never
// reaches device memory in the forward.
//
// Bound on the H100: bytes, as the forward (a c4 call reads its input map,
// table and dout and writes an f32 d_flat of twice the map's bytes).
// Design (deform_bwd.cuh, bwd_data_kernel<GROUPED>): block (x, y) owns 64
// pixels and a share y of the cout tiles; each 64-wide cout tile covers
// whole groups and maps to a disjoint 64-channel slice (Cg == outG,
// checked by the wrapper), so columns of d_flat never collide between
// tiles, only rows do. The B tile is built block-diagonal from the
// compact weight. With one share per block d_w needs no atomics, but a c4
// call has only 132 pixel tiles and a c5 call 33, one small block for
// each SM or fewer; so the wrapper cuts the cout tiles into shares until
// about four blocks sit on every SM, and d_w's partial sums are then added
// with one atomic per (c, k, p) and share (measured on an H100: a c4 call
// 3.6 ms with one share, see PERF.md for the split's time).

#include "deform_bwd.cuh"

// C entry; limits checked by the Python wrapper (outG divides 64,
// cout % 64 == 0, 64 / outG * Cg == 64, 1 <= nc <= 4, aligned and
// contiguous pointers). Launches on `stream`; returns cudaGetLastError().
extern "C" int lsnet_grouped_deform_contract_bwd_data(
    const void* flat, const void* idx, const void* w, const void* W,
    const void* dout, void* dflat, void* dw, int C, int Cg, int outG, int nc,
    int K, int px, int cout, int tile_splits, int is_bf16, void* stream) {
  return lsnet::launch_bwd_data<true>(flat, idx, w, W, dout, dflat, dw, C, Cg,
                                      outG, nc, K, px, cout, tile_splits,
                                      is_bf16, stream);
}
