// Fused deformable row gather + corner weighting + per-tap contraction.
//
//   out[p, :] = sum_k sum_c w[c, k, p] * flat[idx[c, k, p], :] @ W[k]
//
//   flat (R, C) f32 or bf16, idx (nc, K, px) int32, w (nc, K, px) f32 with
//   the DCNv2 mask folded in, W (K, C, cout) in flat's dtype,
//   out (px, cout) in flat's dtype; accumulation is f32.
//   nc = 4 (bilinear corners) or 1 (nearest).
//
// Replaces the TPU kernel lsnet_tpu/ops/pallas_dma_gather.py
// (dma_quad_contract / _dma_quad_contract_impl), whose job was to keep the
// (K, px, C) patch tensor out of device memory. The same holds here: the
// weighted corner rows are built in shared memory, one (64 px x BK ch)
// tile at a time, and go straight into the contraction.
//
// Bound on the H100: at the head's shapes (K=9, C=cout=256) the function
// does 2*K*C*cout = 1.18 MFLOP per output pixel against about K*nc*C*2
// bytes of gathered rows, mostly served from L2, so it is bound by
// tensor-core operations, not by device-memory bytes. The bf16 route
// therefore contracts on the tensor cores (WMMA 16x16x16, f32 accumulate);
// the f32 route, which exists for exact checks, uses f32 FMA. This first
// design is simple: one block per 64 px x 64 cout tile, no multi-stage
// pipeline, and the gather is redone for each cout tile. Those are the
// levers for later work (wgmma, TMA/cp.async staging, wider cout tiles).
// The tile sizes, the gather and the epilogues live in deform_tile.cuh,
// shared with the grouped kernel.

#include "deform_tile.cuh"

namespace {

using namespace lsnet;

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(128)
dgc_bf16(const __nv_bfloat16* __restrict__ flat, const int* __restrict__ idx,
         const float* __restrict__ w, const __nv_bfloat16* __restrict__ W,
         __nv_bfloat16* __restrict__ out, int C, int nc, int K, int px,
         int cout) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA16];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK16 * LDB16];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];

  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;          // 4 warps, each 32 x 32
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < K; ++k) {
    __syncthreads();
    load_taps(idx, w, nc, K, px, k, p0, s_idx, s_w);
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += BK16) {
      gather_tile_bf16(flat, C, c0, nc, s_idx, s_w, As);
      // B tile: W[k, c0:c0+32, n0:n0+64]
      for (int v = threadIdx.x; v < BK16 * BN / 8; v += blockDim.x) {
        const int r = v / (BN / 8);
        const int cv = (v % (BN / 8)) * 8;
        const int n = n0 + cv;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n < cout)
          val = __ldg(reinterpret_cast<const uint4*>(
              W + ((size_t)k * C + c0 + r) * cout + n));
        *reinterpret_cast<uint4*>(&Bs[r * LDB16 + cv]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK16; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA16 + kk,
                                 LDA16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB16 + wn + 16 * j, LDB16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  store_tile_bf16(acc, Cs, wm, wn, p0, n0, px, cout, out);
}

// ---------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
dgc_f32(const float* __restrict__ flat, const int* __restrict__ idx,
        const float* __restrict__ w, const float* __restrict__ W,
        float* __restrict__ out, int C, int nc, int K, int px, int cout) {
  __shared__ __align__(16) float As[BK32][LDA32];    // channel-major
  __shared__ __align__(16) float Bs[BK32][BN + 4];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];

  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;            // 4 output channels each
  const int ty = threadIdx.x / 16;            // 4 pixels each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();
    load_taps(idx, w, nc, K, px, k, p0, s_idx, s_w);
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += BK32) {
      gather_tile_f32(flat, C, c0, nc, s_idx, s_w, As);
      {  // B tile: 16 rows x 64 columns = 256 float4
        const int r = threadIdx.x / 16;
        const int cv = (threadIdx.x % 16) * 4;
        const int n = n0 + cv;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < cout)
          val = __ldg(reinterpret_cast<const float4*>(
              W + ((size_t)k * C + c0 + r) * cout + n));
        *reinterpret_cast<float4*>(&Bs[r][cv]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK32; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  store_tile_f32(acc, ty, tx, p0, n0, px, cout, out);
}

}  // namespace

// C entry. Shapes are checked by the Python wrapper: C % 32 == 0 (bf16) or
// C % 16 == 0 (f32), cout % 8 == 0, 1 <= nc <= 4, every pointer 16-byte
// aligned and contiguous. Launches on `stream`; returns cudaGetLastError().
extern "C" int lsnet_deform_gather_contract(const void* flat, const void* idx,
                                            const void* w, const void* W,
                                            void* out, int C, int nc, int K,
                                            int px, int cout, int is_bf16,
                                            void* stream) {
  const dim3 grid((px + BM - 1) / BM, (cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    dgc_bf16<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(W),
        static_cast<__nv_bfloat16*>(out), C, nc, K, px, cout);
  } else {
    dgc_f32<<<grid, 256, 0, s>>>(
        static_cast<const float*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const float*>(W),
        static_cast<float*>(out), C, nc, K, px, cout);
  }
  return static_cast<int>(cudaGetLastError());
}
