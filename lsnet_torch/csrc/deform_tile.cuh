// Device code shared by the fused deformable gather kernels
// (deform_gather_contract.cu, grouped_deform_contract.cu, deform_bwd.cuh):
// the tile sizes, the per-tap corner table load, and the f32 routes'
// gathered and weighted A tile and epilogue.
//
// A block owns one BM px x BN cout output tile. For each tap k it loads its
// pixels' corner rows and weights (load_taps), then, chunk by chunk over
// its channels, builds the weighted corner rows in shared memory
// (gather_tile_f32) and contracts them with a B tile of the weight.
//
// Clipped indices are always read, even when their weight is 0, exactly
// like the XLA reference: a NaN in a clipped row propagates the same way.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace lsnet {

constexpr int BM = 64;     // pixels per block
constexpr int BN = 64;     // output channels per block
constexpr int MAXNC = 4;   // corners per tap

// bf16 WMMA tiles of the backward kernels (deform_bwd.cuh)
constexpr int BK16 = 32;
constexpr int LDA16 = BK16 + 8;   // padded rows (elements), 80 bytes
constexpr int LDB16 = BN + 8;     // 144 bytes
constexpr int LDC = BN + 4;       // f32 tile of accumulators

// f32 route: 256 threads, 4 px x 4 cout each
constexpr int BK32 = 16;
constexpr int LDA32 = BM + 4;

// Per-tap corner rows and weights of this block's pixels into shared memory.
// Pixels past px read row 0 with weight 0 and are never written out.
__device__ __forceinline__ void load_taps(const int* __restrict__ idx,
                                          const float* __restrict__ w,
                                          int nc, int K, int px, int k, int p0,
                                          int* s_idx, float* s_w) {
  for (int t = threadIdx.x; t < nc * BM; t += blockDim.x) {
    const int c = t / BM;
    const int r = t % BM;
    const int p = p0 + r;
    const bool ok = p < px;
    const size_t off = ((size_t)c * K + k) * (size_t)px + (size_t)(ok ? p : 0);
    s_idx[c * BM + r] = ok ? idx[off] : 0;
    s_w[c * BM + r] = ok ? w[off] : 0.f;
  }
}

// f32 A tile, channel-major: As[ch][r] for BM rows x BK32 channels, one
// float4 per thread (blockDim 256).
__device__ __forceinline__ void gather_tile_f32(const float* __restrict__ flat,
                                                int C, int col0, int nc,
                                                const int* s_idx,
                                                const float* s_w,
                                                float (*As)[LDA32]) {
  const int r = threadIdx.x / 4;
  const int cv = (threadIdx.x % 4) * 4;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(
        flat + (size_t)s_idx[c * BM + r] * C + col0 + cv));
    const float wt = s_w[c * BM + r];
    a[0] += wt * f.x;
    a[1] += wt * f.y;
    a[2] += wt * f.z;
    a[3] += wt * f.w;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) As[cv + e][r] = a[e];
}

// f32 epilogue: thread (ty, tx) holds pixels p0 + 4 ty + i, columns
// n0 + 4 tx + j.
__device__ __forceinline__ void store_tile_f32(const float (&acc)[4][4],
                                               int ty, int tx, int p0, int n0,
                                               int px, int cout,
                                               float* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= px) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < cout) out[(size_t)p * cout + n] = acc[i][j];
    }
  }
}

}  // namespace lsnet
