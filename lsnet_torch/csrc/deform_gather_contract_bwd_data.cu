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
//   (nc, K, px); d_flat (R, C) f32 and d_w (nc, K, px) f32, both zeroed by
//   the caller. Either output pointer may be null: that gradient is then
//   skipped.
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
// bound is tensor-core operations. Measured on the card, the time of the
// first design went to staging the product's operands (reloaded per tap
// through scalar shared-memory stores, two barriers a chunk, nothing in
// flight meanwhile), not to the scatter's atomics; a window of d_flat in
// shared memory, tried in their place, was slower than the vector atomics
// (PERF.md). Design (deform_bwd.cuh, bwd_data_kernel): one block of 256
// threads per 64 pixels and 64-channel tile, all K taps inside; 64-deep
// chunks of dout and W[k] copied 16 bytes at a time through registers into
// two shared buffers, the next chunk's loads in flight under this chunk's
// WMMA (bf16; FMA f32); W[k] stays transposed and is read as a
// column-major fragment; the next tap's corners and the rows of flat for
// d_w are fetched under the product; d_w by warp shuffles and one atomic
// per corner and channel tile, d_flat by 16-byte vector atomics.
// Levers for later work: wgmma; the dot products' rows are still gathered
// through L2 once per channel tile.

#include "deform_bwd.cuh"

// C entry; shapes are checked by the Python wrapper (C % 32 == 0 for bf16,
// C % 16 == 0 for f32, cout % 8 == 0, 1 <= nc <= 4, pointers 16-byte
// aligned and contiguous). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int lsnet_deform_gather_contract_bwd_data(
    const void* flat, const void* idx, const void* w, const void* W,
    const void* dout, void* dflat, void* dw, int C, int nc, int K, int px,
    int cout, int is_bf16, void* stream) {
  return lsnet::launch_bwd_data<false>(flat, idx, w, W, dout, dflat, dw, C, 1,
                                       1, nc, K, px, cout, is_bf16, stream);
}
