// Backward of the fused deformable gather kernels, shared by the four
// sources deform_gather_contract_bwd_{data,weight}.cu and
// grouped_deform_contract_bwd_{data,weight}.cu.
//
// The forward is out = f(flat, w, W) on a corner table (idx, w) of shape
// (nc, K, px):
//
//   V[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//   out[p, n]  = sum_k sum_ch V[k, p, ch] * W[k, ch, n]          (ungrouped)
//   out[p, n]  = sum_k sum_{i < Cg} V[k, p, g(n) Cg + i] * W[k, i, n],
//                g(n) = n / outG                                 (grouped)
//
// With G[k, p, ch] = sum_n dout[p, n] * W[k, ch, n] (grouped: only the n
// of ch's group, W[k, ch % Cg, n]) the three gradients are
//
//   d_flat[idx[c, k, p], :] += w[c, k, p] * G[k, p, :]      (scatter-add)
//   d_w[c, k, p]             = flat[idx[c, k, p], :] . G[k, p, :]
//   d_W[k, ch, n]            = sum_p V[k, p, ch] * dout[p, n]
//                              (grouped: the block-diagonal entries only,
//                              written as d_W[k, ch % Cg, n])
//
// bwd_data_kernel gives d_flat and d_w, bwd_weight_kernel gives d_W. As in
// the forward neither G nor V ever reaches device memory: both are built
// one 64 x 64 tile at a time in shared memory.
//
// Every product is a 64 x 64 f32 tile C = A (64 x inner) * B (inner x 64)
// taken in chunks of BK along the inner dimension. Mma<T> is the product
// of one chunk from shared memory: WMMA 16x16x16 bf16 with f32
// accumulation on 128 threads, or f32 FMA on 256 threads (the exact route
// for checks), with the same tile sizes as the forward kernels;
// bwd_data_kernel takes DataMma<T>, the same product on 256 threads from
// 64-deep chunks. The kernels differ only in how they fill the A and B
// chunks and in what they do with the finished tile.

#pragma once

#include "deform_tile.cuh"

namespace lsnet {

// 16-byte vector load of N elements of T, as floats or as loaded (Raw), and
// 4 channels of a row (Raw4) for the d_w dot product.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  using Raw = float4;
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw zero_raw() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // 4 channels of a row, loaded now and converted later
  using Raw4 = float4;
  static __device__ __forceinline__ Raw4 load4_raw(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void cvt4(Raw4 v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ float cvt(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero_raw() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  using Raw4 = uint2;
  static __device__ __forceinline__ Raw4 load4_raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void cvt4(Raw4 raw, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 cvt(float x) {
    return __float2bfloat16(x);
  }
};

// One BK-deep chunk of the 64 x 64 tile product from shared memory.
//   a(As, m, kk), b(Bs, kk, n): where element (m, kk) of A and (kk, n) of
//   B live in the chunk buffers; zero / step / store: the accumulator.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int THREADS = 128;      // 4 warps of 32 x 32 outputs
  static constexpr int BK = BK16;
  static constexpr int A_ELEMS = BM * LDA16;
  static constexpr int B_ELEMS = BK16 * LDB16;
  struct Acc {
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
        c[2][2];
  };
  static __device__ __forceinline__ T& a(T* As, int m, int kk) {
    return As[m * LDA16 + kk];
  }
  static __device__ __forceinline__ T& b(T* Bs, int kk, int n) {
    return Bs[kk * LDB16 + n];
  }
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc.c[i][j], 0.f);
  }
  static __device__ __forceinline__ void step(Acc& acc, const T* As,
                                              const T* Bs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32;
    const int wn = (warp % 2) * 32;
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm + 16 * i) * LDA16 + kk, LDA16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB16 + wn + 16 * j, LDB16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc.c[i][j], fa[i], fb[j], acc.c[i][j]);
    }
  }
  static __device__ __forceinline__ void store(Acc& acc, float* Cs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 32;
    const int wn = (warp % 2) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                                acc.c[i][j], LDC, wmma::mem_row_major);
  }
};

template <>
struct Mma<float> {
  using T = float;
  static constexpr int THREADS = 256;      // 4 x 4 outputs each
  static constexpr int BK = BK32;
  static constexpr int A_ELEMS = BK32 * LDA32;     // inner-major
  static constexpr int B_ELEMS = BK32 * LDA32;
  struct Acc {
    float c[4][4];
  };
  static __device__ __forceinline__ T& a(T* As, int m, int kk) {
    return As[kk * LDA32 + m];
  }
  static __device__ __forceinline__ T& b(T* Bs, int kk, int n) {
    return Bs[kk * LDA32 + n];
  }
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc.c[i][j] = 0.f;
  }
  static __device__ __forceinline__ void step(Acc& acc, const T* As,
                                              const T* Bs) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * LDA32 + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * LDA32 + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc.c[i][j] = fmaf(a[i], b[j], acc.c[i][j]);
    }
  }
  static __device__ __forceinline__ void store(Acc& acc, float* Cs) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(ty * 4 + i) * LDC + tx * 4 + j] = acc.c[i][j];
  }
};

// The product of bwd_data_kernel, on 256 threads: a 64 x 64 f32 tile from
// chunks A (64 px x BK) and B transposed (Bt: 64 channels x BK, row n is
// column n of B), both filled with 16-byte vectors as they come from
// device memory (put_raw).
template <typename T>
struct DataMma;

// bf16: 64-deep chunks, rows padded to LD; 8 warps of 16 x 32 outputs; WMMA
// reads Bt as a column-major fragment.
template <>
struct DataMma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int BK = 64;
  static constexpr int LD = BK + 8;              // 144 bytes
  static constexpr int ELEMS = BM * LD;
  struct Acc {
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2];
  };
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc.c[j], 0.f);
  }
  static __device__ __forceinline__ void put_raw(T* S, int row, int kv,
                                                 uint4 raw) {
    *reinterpret_cast<uint4*>(&S[row * LD + kv]) = raw;
  }
  static __device__ __forceinline__ void step_bt(Acc& acc, const T* As,
                                                 const T* Bt) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 16;
    const int wn = (warp % 2) * 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb[2];
      wmma::load_matrix_sync(fa, As + wm * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bt + (wn + 16 * j) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc.c[j], fa, fb[j], acc.c[j]);
    }
  }
  static __device__ __forceinline__ void store(Acc& acc, float* Cs) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
    const int wm = (warp / 2) * 16;
    const int wn = (warp % 2) * 32;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + wm * LDC + wn + 16 * j, acc.c[j], LDC,
                              wmma::mem_row_major);
  }
};

// f32: Mma<float>'s FMA product and chunk shape (16 deep, both chunks
// inner-major as its step wants them).
template <>
struct DataMma<float> : Mma<float> {
  static constexpr int ELEMS = A_ELEMS;
  static __device__ __forceinline__ void put_raw(float* S, int row, int kv,
                                                 float4 raw) {
    S[kv * LDA32 + row] = raw.x;
    S[(kv + 1) * LDA32 + row] = raw.y;
    S[(kv + 2) * LDA32 + row] = raw.z;
    S[(kv + 3) * LDA32 + row] = raw.w;
  }
  static __device__ __forceinline__ void step_bt(Acc& acc, const float* As,
                                                 const float* Bt) {
    step(acc, As, Bt);
  }
};

// d_flat's scatter: one 16-byte vector atomic where the toolkit has it
// (sm_90, CUDA 12.1 on), else four scalar ones. f32 atomics add in an
// order that changes from run to run, so d_flat is not bit-reproducible.
__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 &&   \
    (__CUDACC_VER_MAJOR__ > 12 ||                       \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float4*>(p), v);
#else
  atomicAdd(p, v.x);
  atomicAdd(p + 1, v.y);
  atomicAdd(p + 2, v.z);
  atomicAdd(p + 3, v.w);
#endif
}

// ------------------------------------------------------------------ data
// d_flat (f32, zeroed by the caller, may be null) and d_w (f32, zeroed by
// the caller, may be null).
//
// Block (x, y) owns 64 pixels and the 64-channel tile y through every tap:
//   ungrouped: channels [64 y, 64 y + 64), inner = all cout;
//   grouped:   the channel slice of cout tile y (64 wide when Cg == outG,
//              which the wrapper requires), inner = the 64 columns of that
//              tile, B block-diagonal from the compact weight.
// Per tap k it computes the tile G = dout_tile * W[k]^T into shared memory
// and then, 4 threads per pixel and corner, takes the dot product of the
// corner's row slice with G (d_w, one atomic per (c, k, p) and channel
// tile) and adds w * G to the row of d_flat with 16-byte vector atomics.
//
// What the card asked for (measured, PERF.md): the first design's time
// went to staging the product's operands, not to the atomics, and a window
// of d_flat in shared memory (adds combined before they leave the SM,
// tried two ways) was slower than the vector atomics it saved. So the
// chunks of dout and of W[k] go global -> registers -> one of two shared
// buffers as they are (16-byte copies; W[k] stays transposed, a row of W
// is a column of B, and WMMA reads it as a column-major fragment; grouped:
// only the vectors of the row's own group are loaded, the rest are
// zeros). The loads of the next chunk, also the next tap's first, are
// started before this chunk's product and arrive under it, so one barrier
// per chunk is enough; the next tap's corners and the rows of flat for the
// dot products are fetched under the product too. Chunks are 64 deep in
// bf16: a grouped tap is one chunk.
//
// Pixels past px are skipped; clipped corners (weight 0, in-range pixel)
// are read and added to like any other, as autograd of the plain version
// does.
constexpr int BWD_DATA_THREADS = 256;
constexpr int CORNER_LANES = BWD_DATA_THREADS / BM;     // threads per corner
constexpr int CORNER_VECS = BN / 4 / CORNER_LANES;      // float4 per thread
constexpr unsigned FULL_WARP = 0xffffffffu;

template <typename T, bool GROUPED>
__global__ void __launch_bounds__(BWD_DATA_THREADS, 2)
bwd_data_kernel(const T* __restrict__ flat, const int* __restrict__ idx,
                const float* __restrict__ w, const T* __restrict__ W,
                const T* __restrict__ dout, float* __restrict__ dflat,
                float* __restrict__ dw, int C, int Cg, int outG, int nc,
                int K, int px, int cout) {
  using M = DataMma<T>;
  using V = Vec<T>;
  constexpr int VN = V::N;
  constexpr int THREADS = BWD_DATA_THREADS;
  constexpr int VPR = M::BK / VN;                // vectors per chunk row
  constexpr int NV = BM * VPR / THREADS;         // per thread and operand
  static_assert(BM * VPR % THREADS == 0 && BM == BN, "whole vectors");
  static_assert(MAXNC * BM == THREADS, "one corner per thread and tap");
  static_assert(4 * M::ELEMS * sizeof(T) >= BM * LDC * sizeof(float),
                "the G tile takes the chunk buffers' place");
  // two A and two B chunk buffers; the G tile takes their place once a
  // tap's product is done
  __shared__ __align__(128) T chunks[4 * M::ELEMS];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];
  float* Cs = reinterpret_cast<float*>(chunks);

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BM;
  const int WR = GROUPED ? Cg : C;               // rows of W per tap
  const int klo = GROUPED ? blockIdx.y * BN : 0;         // inner range
  const int khi = GROUPED ? klo + BN : cout;
  const int chg0 = GROUPED ? klo / outG * Cg : blockIdx.y * BN;
  const bool need_dflat = dflat != nullptr;
  const bool need_dw = dw != nullptr;

  // this thread's corner of a tap: corner tid / 64 of pixel p0 + tid % 64
  const bool my_tap = tid / BM < nc && p0 + tid % BM < px;
  const size_t tap_off =
      (size_t)(tid / BM) * K * (size_t)px + (my_tap ? p0 + tid % BM : 0);
  int tap_row = 0;
  float tap_w = 0.f;
  if (my_tap) {
    tap_row = idx[tap_off];
    tap_w = w[tap_off];
  }
  // this thread's vectors of an A chunk (dout, zero past px) and of a B
  // chunk (W[k] transposed: row n holds channel chg0 + n's weights;
  // grouped: zero where the columns are another group's, which holds for
  // a whole vector because outG is a multiple of VN)
  const T* a_src[NV];
  const T* b_src[NV];
  int b_own[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int row = (tid + u * THREADS) / VPR;
    const int kv = (tid + u * THREADS) % VPR * VN;
    const int wrow = GROUPED ? row % Cg : chg0 + row;
    a_src[u] = p0 + row < px ? dout + (size_t)(p0 + row) * cout + kv : nullptr;
    b_src[u] = (GROUPED || wrow < C) ? W + (size_t)wrow * cout + kv : nullptr;
    b_own[u] = GROUPED ? klo + row / Cg * outG - kv : 0;  // its first column
  }
  typename V::Raw ra[NV], rb[NV];
  // this thread's share of a corner in the pass after the product
  const int corner_r = tid / CORNER_LANES;
  const int corner_q = tid % CORNER_LANES;
  const bool corner_live = p0 + corner_r < px;
#define LSNET_FETCH_CHUNK(k_, kk0_)                                          \
  _Pragma("unroll") for (int u = 0; u < NV; ++u) {                           \
    const bool in = (kk0_) + (tid + u * THREADS) % VPR * VN < khi;           \
    const int col = (kk0_) - b_own[u];          /* column in its group */    \
    const bool own = !GROUPED || (col >= 0 && col < outG);                   \
    ra[u] = in && a_src[u] ? V::load_raw(a_src[u] + (kk0_)) : V::zero_raw(); \
    rb[u] = in && own && b_src[u]                                            \
                ? V::load_raw(b_src[u] + (size_t)(k_) * WR * cout + (kk0_))  \
                : V::zero_raw();                                             \
  }

  LSNET_FETCH_CHUNK(0, klo)
  int buf = 0;
  for (int k = 0; k < K; ++k) {
    __syncthreads();      // the last tap's readers of the taps and of Cs
    s_idx[tid] = tap_row;
    s_w[tid] = tap_w;
    if (k + 1 < K && my_tap) {                   // the next tap's corner
      tap_row = idx[tap_off + (size_t)(k + 1) * px];
      tap_w = w[tap_off + (size_t)(k + 1) * px];
    }
    typename M::Acc acc;
    M::zero(acc);
    typename V::Raw4 rows[MAXNC][CORNER_VECS] = {};
    for (int kk0 = klo; kk0 < khi; kk0 += M::BK) {
      T* As = chunks + buf * 2 * M::ELEMS;
      T* Bt = As + M::ELEMS;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int row = (tid + u * THREADS) / VPR;
        const int kv = (tid + u * THREADS) % VPR * VN;
        M::put_raw(As, row, kv, ra[u]);
        M::put_raw(Bt, row, kv, rb[u]);
      }
      __syncthreads();
      if (kk0 + M::BK < khi) {
        LSNET_FETCH_CHUNK(k, kk0 + M::BK)
      } else if (k + 1 < K) {
        LSNET_FETCH_CHUNK(k + 1, klo)
      }
      if (kk0 == klo && need_dw && corner_live) {
        // the corners' rows of flat, on their way while the product runs
#pragma unroll
        for (int c = 0; c < MAXNC; ++c)
#pragma unroll
          for (int m = 0; m < CORNER_VECS; ++m) {
            const int ch = chg0 + (corner_q + CORNER_LANES * m) * 4;
            if (c < nc && ch < C)
              rows[c][m] = V::load4_raw(
                  flat + (size_t)s_idx[c * BM + corner_r] * C + ch);
          }
      }
      M::step_bt(acc, As, Bt);
      buf ^= 1;
    }
    __syncthreads();            // every warp is done with the chunk buffers
    M::store(acc, Cs);
    __syncthreads();
    // G tile in Cs: 4 threads per pixel and corner, each 4 float4 of the 64
    // channels (lane q takes vectors q, q + 4, ..: the four lanes of a
    // corner touch 64 contiguous bytes at a time)
#pragma unroll
    for (int c = 0; c < MAXNC; ++c) {
      if (c >= nc) break;
      const size_t row_off = (size_t)s_idx[c * BM + corner_r] * C;
      const float wt = s_w[c * BM + corner_r];
      float dot = 0.f;
#pragma unroll
      for (int m = 0; m < CORNER_VECS; ++m) {
        const int j4 = (corner_q + CORNER_LANES * m) * 4;
        const int ch = chg0 + j4;
        if (corner_live && ch < C) {
          const float4 g =
              *reinterpret_cast<const float4*>(&Cs[corner_r * LDC + j4]);
          if (need_dw) {
            float f[4];
            V::cvt4(rows[c][m], f);
            dot += f[0] * g.x + f[1] * g.y + f[2] * g.z + f[3] * g.w;
          }
          if (need_dflat)
            atomic_add4(dflat + row_off + ch,
                        make_float4(wt * g.x, wt * g.y, wt * g.z, wt * g.w));
        }
      }
      if (need_dw) {
#pragma unroll
        for (int o = CORNER_LANES / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(FULL_WARP, dot, o, CORNER_LANES);
        if (corner_q == 0 && corner_live)
          atomicAdd(dw + ((size_t)c * K + k) * (size_t)px + p0 + corner_r,
                    dot);
      }
    }
  }
#undef LSNET_FETCH_CHUNK
}

// ---------------------------------------------------------------- weight
// d_W (f32, zeroed by the caller): (K, C, cout), or the compact
// (K, Cg, cout) when grouped.
//
// The sum runs over pixels, so the grid splits px: block (x, y, z) owns
// the 64-channel tile x (grouped: the channel slice of cout tile y), the
// cout tile y, the tap z / nsplit and every nsplit-th share of the 64-px
// tiles, and adds its 64 x 64 partial sum into d_W with f32 atomics
// (blocks run in no order on the card, so nothing is carried from one to
// the next; the sum's order, and its last bits, change from run to run).
// A is the gathered, weighted V tile transposed (channels x pixels), B the
// dout tile; rows past px are zero in BOTH (their corner rows are not even
// read), so nothing outside the arrays reaches the sum. Grouped: only the
// entries whose channel and column share a group are added, straight into
// the compact layout.
template <typename T, bool GROUPED>
__global__ void __launch_bounds__(Mma<T>::THREADS)
bwd_weight_kernel(const T* __restrict__ flat, const int* __restrict__ idx,
                  const float* __restrict__ w, const T* __restrict__ dout,
                  float* __restrict__ dW, int C, int Cg, int outG, int nc,
                  int K, int px, int cout, int nsplit) {
  using M = Mma<T>;
  constexpr int VN = Vec<T>::N;
  constexpr int THREADS = M::THREADS;
  __shared__ __align__(32) T As[M::A_ELEMS];
  __shared__ __align__(32) T Bs[M::B_ELEMS];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int k = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int ch0 = GROUPED ? n0 / outG * Cg : blockIdx.x * BN;
  const int ntile = (px + BM - 1) / BM;
  const int per = (ntile + nsplit - 1) / nsplit;
  const int t_lo = split * per;
  const int t_hi = min(ntile, t_lo + per);
  if (t_lo >= t_hi) return;

  typename M::Acc acc;
  M::zero(acc);
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int p0 = tile * BM;
    __syncthreads();
    load_taps(idx, w, nc, K, px, k, p0, s_idx, s_w);
    __syncthreads();
    for (int kk0 = 0; kk0 < BM; kk0 += M::BK) {
      // A(m, kk) = V[k, p0 + kk0 + kk, ch0 + m]
      for (int v = tid; v < M::BK * (BN / VN); v += THREADS) {
        const int kk = v / (BN / VN);
        const int mv = (v % (BN / VN)) * VN;
        const int r = kk0 + kk;
        float a[VN];
#pragma unroll
        for (int e = 0; e < VN; ++e) a[e] = 0.f;
        if (p0 + r < px && ch0 + mv < C) {
          for (int c = 0; c < nc; ++c) {
            float f[VN];
            Vec<T>::load(flat + (size_t)s_idx[c * BM + r] * C + ch0 + mv, f);
            const float wt = s_w[c * BM + r];
#pragma unroll
            for (int e = 0; e < VN; ++e) a[e] += wt * f[e];
          }
        }
#pragma unroll
        for (int e = 0; e < VN; ++e) M::a(As, mv + e, kk) = Vec<T>::cvt(a[e]);
      }
      // B(kk, n) = dout[p0 + kk0 + kk, n0 + n]
      for (int v = tid; v < M::BK * (BN / VN); v += THREADS) {
        const int kk = v / (BN / VN);
        const int nv = (v % (BN / VN)) * VN;
        const int r = kk0 + kk;
        float f[VN];
#pragma unroll
        for (int e = 0; e < VN; ++e) f[e] = 0.f;
        if (p0 + r < px && n0 + nv < cout)
          Vec<T>::load(dout + (size_t)(p0 + r) * cout + n0 + nv, f);
#pragma unroll
        for (int e = 0; e < VN; ++e) M::b(Bs, kk, nv + e) = Vec<T>::cvt(f[e]);
      }
      __syncthreads();
      M::step(acc, As, Bs);
      __syncthreads();
    }
  }
  M::store(acc, Cs);
  __syncthreads();
  const int WR = GROUPED ? Cg : C;
  for (int t = tid; t < BN * BN; t += THREADS) {
    const int m = t / BN;
    const int n = t % BN;
    if (n0 + n >= cout) continue;
    int row;
    if constexpr (GROUPED) {
      if (m / Cg != n / outG) continue;
      row = m % Cg;
    } else {
      row = ch0 + m;
      if (row >= C) continue;
    }
    atomicAdd(dW + ((size_t)k * WR + row) * cout + n0 + n, Cs[m * LDC + n]);
  }
}

// Launchers of the C entries (the bf16 route of K1 bwd-weight has its own
// kernel, deform_gather_contract_bwd_weight.cu).
template <bool GROUPED>
inline int launch_bwd_data(const void* flat, const void* idx, const void* w,
                           const void* W, const void* dout, void* dflat,
                           void* dw, int C, int Cg, int outG, int nc, int K,
                           int px, int cout, int is_bf16, void* stream) {
  const dim3 grid((px + BM - 1) / BM, GROUPED ? cout / BN : (C + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    bwd_data_kernel<T, GROUPED><<<grid, BWD_DATA_THREADS, 0, s>>>(
        static_cast<const T*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const T*>(W),
        static_cast<const T*>(dout), static_cast<float*>(dflat),
        static_cast<float*>(dw), C, Cg, outG, nc, K, px, cout);
  } else {
    using T = float;
    bwd_data_kernel<T, GROUPED><<<grid, BWD_DATA_THREADS, 0, s>>>(
        static_cast<const T*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const T*>(W),
        static_cast<const T*>(dout), static_cast<float*>(dflat),
        static_cast<float*>(dw), C, Cg, outG, nc, K, px, cout);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool GROUPED>
inline int launch_bwd_weight(const void* flat, const void* idx, const void* w,
                             const void* dout, void* dW, int C, int Cg,
                             int outG, int nc, int K, int px, int cout,
                             int nsplit, int is_bf16, void* stream) {
  const dim3 grid(GROUPED ? 1 : (C + BN - 1) / BN, (cout + BN - 1) / BN,
                  K * nsplit);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    bwd_weight_kernel<T, GROUPED><<<grid, Mma<T>::THREADS, 0, s>>>(
        static_cast<const T*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const T*>(dout),
        static_cast<float*>(dW), C, Cg, outG, nc, K, px, cout, nsplit);
  } else {
    using T = float;
    bwd_weight_kernel<T, GROUPED><<<grid, Mma<T>::THREADS, 0, s>>>(
        static_cast<const T*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const T*>(dout),
        static_cast<float*>(dW), C, Cg, outG, nc, K, px, cout, nsplit);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lsnet
