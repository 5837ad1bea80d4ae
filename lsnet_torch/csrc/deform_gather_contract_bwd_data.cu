// Backward of deform_gather_contract.cu with respect to its data: d_flat
// and d_w of
//
//   out[p, :] = sum_k sum_c w[c, k, p] * flat[idx[c, k, p], :] @ W[k]
//
//   G[k, p, :]               = dout[p, :] @ W[k]^T
//   d_flat[idx[c, k, p], :] += w[c, k, p] * G[k, p, :]
//   d_w[c, k, p]             = flat[idx[c, k, p], :] . G[k, p, :]
//
//   flat (R, C), W (K, C, cout), dout (px, cout) f32 or bf16; idx, w
//   (nc, K, px); d_flat (R, C) f32, zeroed by the caller; d_w (nc, K, px)
//   f32. Either output pointer may be null: that gradient is then skipped.
//
// Replaces what the JAX package leaves to XLA: the backward of the TPU
// kernel lsnet_tpu/ops/pallas_dma_gather.py (dma_quad_contract, `_bwd`)
// is jax.vjp of the plain gather + einsum, which writes the (K, px, C)
// cotangent of the patch tensor to device memory and scatter-adds it.
// Here G is built tile by tile in shared memory and never stored. d_w is
// what carries the gradient to the DCN offsets and the DCNv2 mask.
//
// Bound on the H100: at the head's shapes (K = 9, C = cout = 256) the
// product is the forward's (2 K C cout = 1.18 MFLOP per pixel), so the
// bound is tensor-core operations; what the simple design pays on top is
// the scatter: K nc C f32 atomic adds per pixel into rows that mostly sit
// in L2. Design (deform_bwd.cuh, bwd_data_kernel): one block per 64
// pixels (the head's calls have 700 pixel tiles and more, so the wrapper
// takes a single share of the channel tiles), WMMA bf16 / FMA f32 for G,
// d_w reduced inside the block with warp shuffles (no atomics), d_flat
// with 16-byte vector atomics.
// Levers for later work: wgmma, staging dout once per block, sorting or
// segmenting the scatter.

#include "deform_bwd.cuh"

// C entry; shapes are checked by the Python wrapper (C % 32 == 0 for bf16,
// C % 16 == 0 for f32, cout % 8 == 0, 1 <= nc <= 4, pointers 16-byte
// aligned and contiguous). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int lsnet_deform_gather_contract_bwd_data(
    const void* flat, const void* idx, const void* w, const void* W,
    const void* dout, void* dflat, void* dw, int C, int nc, int K, int px,
    int cout, int tile_splits, int is_bf16, void* stream) {
  return lsnet::launch_bwd_data<false>(flat, idx, w, W, dout, dflat, dw, C, 1,
                                       1, nc, K, px, cout, tile_splits, is_bf16,
                                       stream);
}
