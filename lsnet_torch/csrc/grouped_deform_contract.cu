// Fused deformable row gather + corner weighting + grouped contraction.
//
//   out[p, n] = sum_k sum_{ch in group(n)} v[k, p, ch] * W[k, ch % Cg, n],
//   v[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//
//   flat (R, C) f32 or bf16 with group-major channels (C = G * Cg),
//   idx (nc, K, px) int32, w (nc, K, px) f32 with the DCNv2 mask folded
//   in, W (K, Cg, cout) the compact grouped weight in flat's dtype with
//   group-major cout (group(n) = n / outG, outG = cout / G), out (px, cout)
//   in flat's dtype; accumulation is f32. nc = 1 (nearest, the shipped
//   backbone default) or 4 (bilinear).
//
// Replaces the TPU kernel lsnet_tpu/ops/pallas_grouped.py
// (grouped_deform_contract / _gdc_fwd), which contracted an already
// gathered (px, K*C) patch tensor block-diagonally, and, on the JAX
// default route, the dense block-diagonal contraction of flat_deform.py
// (_blockdiag_weight), which pays G x the operations on zeros. Here the
// gather is fused into the contraction, as in deform_gather_contract.cu,
// so the patch tensor never reaches device memory.
//
// Design: one block per 64 px x 64 cout tile. The tile's columns cover the
// groups n0/outG .. (n0+64)/outG - 1 (outG divides 64), which read only the
// input channels [g0*Cg, g0*Cg + S), S = 64/outG * Cg: 64 at every stage of
// X-101-64x4d, where Cg == outG. So each cout tile gathers a disjoint
// channel slice and the gather is not redone per cout tile. The B tile is
// built block-diagonal in shared memory from the compact weight
// (Bs[r][c] = W[k, ch % Cg, n] where group(ch) == group(n), else 0), and
// the WMMA steps whose 16 rows and 16 columns share no group are skipped.
//
// Bound on the H100: these sites are bound by device-memory bytes, not by
// operations. A c4 call (B=2, 50x84, C = cout = 1024, Cg = 16) moves about
// 35 MB of unique input + output against 2.5 GFLOP of grouped products
// (10 us at 3.35 TB/s against 2.5 us at the bf16 peak). The design keeps
// the bytes low (no patch tensor, each input row slice gathered by one
// cout tile) and leaves the operations to WMMA; cp.async/TMA staging of
// the row gather and wgmma are later work.
//
// Limits, checked by the Python wrapper: outG divides 64, cout % 64 == 0,
// S % 32 == 0 (bf16) or S % 16 == 0 (f32), 1 <= nc <= 4, every pointer
// 16-byte aligned and contiguous.

#include "deform_tile.cuh"

namespace {

using namespace lsnet;

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(128)
gdc_bf16(const __nv_bfloat16* __restrict__ flat, const int* __restrict__ idx,
         const float* __restrict__ w, const __nv_bfloat16* __restrict__ W,
         __nv_bfloat16* __restrict__ out, int C, int Cg, int outG, int nc,
         int K, int px, int cout) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA16];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK16 * LDB16];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];

  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ch0 = n0 / outG * Cg;             // first input channel
  const int S = BN / outG * Cg;               // channels of the tile
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
    for (int c0 = 0; c0 < S; c0 += BK16) {
      gather_tile_bf16(flat, C, ch0 + c0, nc, s_idx, s_w, As);
      // B tile, block-diagonal: row r is channel ch0 + c0 + r of the
      // tile's group c_g, column j output n0 + j of group j / outG
      for (int v = threadIdx.x; v < BK16 * BN / 8; v += blockDim.x) {
        const int r = v / (BN / 8);
        const int cv = (v % (BN / 8)) * 8;
        const int c_g = (c0 + r) / Cg;
        const int c_in = c0 + r - c_g * Cg;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            W + ((size_t)k * Cg + c_in) * cout + n0 + cv));
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
        uint4 packed;
        __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          b[e] = (cv + e) / outG == c_g ? h[e] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(&Bs[r * LDB16 + cv]) = packed;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK16; kk += 16) {
        // groups of this step's 16 rows, and whether each of the warp's
        // two 16-column fragments shares one of them
        const int rg0 = (c0 + kk) / Cg;
        const int rg1 = (c0 + kk + 15) / Cg;
        bool live[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          live[j] = (wn + 16 * j) / outG <= rg1 &&
                    rg0 <= (wn + 16 * j + 15) / outG;
        if (!live[0] && !live[1]) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA16 + kk,
                                 LDA16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!live[j]) continue;
          wmma::load_matrix_sync(fb, Bs + kk * LDB16 + wn + 16 * j, LDB16);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
      __syncthreads();
    }
  }
  store_tile_bf16(acc, Cs, wm, wn, p0, n0, px, cout, out);
}

// ---------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
gdc_f32(const float* __restrict__ flat, const int* __restrict__ idx,
        const float* __restrict__ w, const float* __restrict__ W,
        float* __restrict__ out, int C, int Cg, int outG, int nc, int K,
        int px, int cout) {
  __shared__ __align__(16) float As[BK32][LDA32];    // channel-major
  __shared__ __align__(16) float Bs[BK32][BN + 4];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];

  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ch0 = n0 / outG * Cg;
  const int S = BN / outG * Cg;
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
    for (int c0 = 0; c0 < S; c0 += BK32) {
      gather_tile_f32(flat, C, ch0 + c0, nc, s_idx, s_w, As);
      {  // B tile, block-diagonal: 16 rows x 64 columns = 256 float4
        const int r = threadIdx.x / 16;
        const int cv = (threadIdx.x % 16) * 4;
        const int c_g = (c0 + r) / Cg;
        const int c_in = c0 + r - c_g * Cg;
        const float4 f = __ldg(reinterpret_cast<const float4*>(
            W + ((size_t)k * Cg + c_in) * cout + n0 + cv));
        const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Bs[r][cv + e] = (cv + e) / outG == c_g ? v[e] : 0.f;
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

// C entry; the limits above are checked by the Python wrapper. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int lsnet_grouped_deform_contract(const void* flat, const void* idx,
                                             const void* w, const void* W,
                                             void* out, int C, int Cg,
                                             int outG, int nc, int K, int px,
                                             int cout, int is_bf16,
                                             void* stream) {
  const dim3 grid((px + BM - 1) / BM, cout / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gdc_bf16<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(W),
        static_cast<__nv_bfloat16*>(out), C, Cg, outG, nc, K, px, cout);
  } else {
    gdc_f32<<<grid, 256, 0, s>>>(
        static_cast<const float*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const float*>(W),
        static_cast<float*>(out), C, Cg, outG, nc, K, px, cout);
  }
  return static_cast<int>(cudaGetLastError());
}
