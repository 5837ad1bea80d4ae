// Backward of grouped_deform_contract.cu with respect to its compact
// weight (g(n) = n / outG):
//
//   d_W[k, i, n] = sum_p V[k, p, g(n) Cg + i] * dout[p, n],
//   V[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//
//   flat (R, C), dout (px, cout) f32 or bf16; idx, w (nc, K, px);
//   d_W (K, Cg, cout) f32, zeroed by the caller.
//
// Replaces the TPU kernel lsnet_tpu/ops/pallas_grouped.py `_make_dw_kernel`
// (the second pallas_call of `_gdc_bwd`) together with the einsum that
// pulls the block-diagonal entries back to the compact layout
// (pallas_grouped.py, end of `_gdc_bwd`): one kernel does both. The TPU
// kernel carries its sum from grid step to grid step; blocks on the card
// run in no order, so px is split over blocks and the partial sums are
// added into the zeroed f32 d_W with atomics (no second pass). Its
// ragged-tile masking is kept: rows past px are zero in both operands,
// and their corner rows are not read at all.
//
// Bound on the H100: bytes (input map, table and dout read once). Design
// (deform_bwd.cuh, bwd_weight_kernel<GROUPED>): block (y, z) owns cout
// tile y, whose 64 columns read the 64-channel slice of their groups, tap
// z / nsplit and a share of the px tiles; the full 64 x 64 product is
// taken on the tensor cores and only the entries whose row and column
// share a group are added to d_W[k, ch % Cg, n]. The dead 16 x 16
// fragments could be skipped as in the forward: later work.

#include "deform_bwd.cuh"

// C entry; limits as for the grouped bwd-data entry. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int lsnet_grouped_deform_contract_bwd_weight(
    const void* flat, const void* idx, const void* w, const void* dout,
    void* dW, int C, int Cg, int outG, int nc, int K, int px, int cout,
    int nsplit, int is_bf16, void* stream) {
  return lsnet::launch_bwd_weight<true>(flat, idx, w, dout, dW, C, Cg, outG,
                                        nc, K, px, cout, nsplit, is_bf16,
                                        stream);
}
