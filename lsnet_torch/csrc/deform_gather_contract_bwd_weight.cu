// Backward of deform_gather_contract.cu with respect to its weight:
//
//   d_W[k] = sum_p V[k, p, :]^T dout[p, :],
//   V[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//
//   flat (R, C), dout (px, cout) f32 or bf16; idx, w (nc, K, px);
//   d_W (K, C, cout) f32, zeroed by the caller.
//
// Replaces what the JAX package leaves to XLA: the `dwstk` part of the
// backward of the TPU kernel lsnet_tpu/ops/pallas_dma_gather.py
// (dma_quad_contract, `_bwd` = jax.vjp of the plain gather + einsum),
// which gathers the (K, px, C) patch tensor into device memory again.
// Here the gather is fused into the operand load, as in the forward.
//
// Bound on the H100: the forward's product once more (tensor-core
// operations at the head's shapes). Design (deform_bwd.cuh,
// bwd_weight_kernel): the sum runs over pixels, and blocks on the card run
// in no order, so px is split over blocks (grid z = tap x split) and each
// block adds its 64 x 64 partial sum into the zeroed f32 d_W with atomics;
// the wrapper picks the split that fills the card. The gather is redone
// for each cout tile, as in the forward; a wider cout tile and wgmma are
// the levers for later work.

#include "deform_bwd.cuh"

// C entry; shapes as for the forward, checked by the Python wrapper.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int lsnet_deform_gather_contract_bwd_weight(
    const void* flat, const void* idx, const void* w, const void* dout,
    void* dW, int C, int nc, int K, int px, int cout, int nsplit, int is_bf16,
    void* stream) {
  return lsnet::launch_bwd_weight<false>(flat, idx, w, dout, dW, C, 1, 1, nc,
                                         K, px, cout, nsplit, is_bf16, stream);
}
