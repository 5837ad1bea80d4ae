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
// for checks), with the same tile sizes as the forward kernels. The
// kernels differ only in how they fill the A and B chunks and in what
// they do with the finished tile.

#pragma once

#include "deform_tile.cuh"

namespace lsnet {

// 16-byte vector load of N elements of T as floats, and 4 channels of a
// row for the d_w dot product.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void load4(const float* p, float* f) {
    load(p, f);
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
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float* f) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
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
// d_flat (f32, zeroed by the caller, may be null) and d_w (may be null).
//
// Block (x, y) owns 64 pixels through every tap and the y-th share of the
// channel tiles. With one share (gridDim.y == 1) d_w[c, k, p], a sum over
// all C channels, is finished inside the block and stored; with more
// shares, which the wrapper takes where 64-px tiles alone would leave most
// of the card idle (px / 64 is 132 at c4 and 33 at c5 of X-101), each
// block adds its partial sum into the zeroed d_w with one atomic per
// (c, k, p). d_flat's rows, which many (c, k, p) share, are always
// accumulated with atomics. Per tap k and per 64-channel tile the block
// computes G = dout_tile * W[k]^T into shared memory:
//   ungrouped: the tile is channels [64 t, 64 t + 64), inner = all cout;
//   grouped:   the tile is the channel slice of cout tile t (64 wide when
//              Cg == outG, which the wrapper requires), inner = the 64
//              columns of that cout tile, B block-diagonal from the
//              compact weight.
// Then each corner c of each pixel reads its row slice for the dot product
// and adds w * G to it. Pixels past px have weight 0, a zero dout row and
// are skipped by the scatter; clipped corners (weight 0, in-range pixel)
// are read and added to like any other, as autograd of the plain version
// does.
template <typename T, bool GROUPED>
__global__ void __launch_bounds__(Mma<T>::THREADS)
bwd_data_kernel(const T* __restrict__ flat, const int* __restrict__ idx,
                const float* __restrict__ w, const T* __restrict__ W,
                const T* __restrict__ dout, float* __restrict__ dflat,
                float* __restrict__ dw, int C, int Cg, int outG, int nc,
                int K, int px, int cout) {
  using M = Mma<T>;
  constexpr int VN = Vec<T>::N;
  constexpr int THREADS = M::THREADS;
  __shared__ __align__(32) T As[M::A_ELEMS];
  __shared__ __align__(32) T Bs[M::B_ELEMS];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];
  __shared__ float s_dw[MAXNC * BM];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * BM;
  const int WR = GROUPED ? Cg : C;               // rows of W per tap
  const int NT = GROUPED ? cout / BN : (C + BN - 1) / BN;
  const int per = (NT + gridDim.y - 1) / gridDim.y;      // tiles per share
  const int tile_lo = blockIdx.y * per;
  const int tile_hi = min(NT, tile_lo + per);
  const bool need_dflat = dflat != nullptr;
  const bool need_dw = dw != nullptr;

  for (int t = tid; t < MAXNC * BM; t += THREADS) s_dw[t] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();
    load_taps(idx, w, nc, K, px, k, p0, s_idx, s_w);
    __syncthreads();
    for (int tile = tile_lo; tile < tile_hi; ++tile) {
      const int klo = GROUPED ? tile * BN : 0;           // inner range
      const int khi = GROUPED ? klo + BN : cout;
      const int chg0 = GROUPED ? klo / outG * Cg : tile * BN;
      typename M::Acc acc;
      M::zero(acc);
      for (int kk0 = klo; kk0 < khi; kk0 += M::BK) {
        // A(m, kk) = dout[p0 + m, kk0 + kk], zero past px
        for (int v = tid; v < BM * (M::BK / VN); v += THREADS) {
          const int m = v / (M::BK / VN);
          const int kv = (v % (M::BK / VN)) * VN;
          float f[VN];
#pragma unroll
          for (int e = 0; e < VN; ++e) f[e] = 0.f;
          if (p0 + m < px && kk0 + kv < khi)
            Vec<T>::load(dout + (size_t)(p0 + m) * cout + kk0 + kv, f);
#pragma unroll
          for (int e = 0; e < VN; ++e) M::a(As, m, kv + e) = Vec<T>::cvt(f[e]);
        }
        // B(kk, n) = W[k, row(n), kk0 + kk]: channel chg0 + n's weights
        for (int v = tid; v < BN * (M::BK / VN); v += THREADS) {
          const int n = v / (M::BK / VN);
          const int kv = (v % (M::BK / VN)) * VN;
          const int wrow = GROUPED ? n % Cg : chg0 + n;
          float f[VN];
#pragma unroll
          for (int e = 0; e < VN; ++e) f[e] = 0.f;
          if (kk0 + kv < khi && (GROUPED || wrow < C))
            Vec<T>::load(W + ((size_t)k * WR + wrow) * cout + kk0 + kv, f);
          if constexpr (GROUPED) {
#pragma unroll
            for (int e = 0; e < VN; ++e)
              if ((kk0 + kv + e - klo) / outG != n / Cg) f[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < VN; ++e) M::b(Bs, kv + e, n) = Vec<T>::cvt(f[e]);
        }
        __syncthreads();
        M::step(acc, As, Bs);
        __syncthreads();
      }
      M::store(acc, Cs);
      __syncthreads();
      // G tile in Cs: 16 threads per pixel, 4 channels each
      for (int c = 0; c < nc; ++c) {
        for (int t = tid; t < BM * (BN / 4); t += THREADS) {
          const int r = t / (BN / 4);
          const int j4 = (t % (BN / 4)) * 4;
          const int ch = chg0 + j4;
          float dot = 0.f;
          if (p0 + r < px && ch < C) {
            const float4 g =
                *reinterpret_cast<const float4*>(&Cs[r * LDC + j4]);
            const size_t off = (size_t)s_idx[c * BM + r] * C + ch;
            if (need_dw) {
              float f[4];
              Vec<T>::load4(flat + off, f);
              dot = f[0] * g.x + f[1] * g.y + f[2] * g.z + f[3] * g.w;
            }
            if (need_dflat) {
              const float wt = s_w[c * BM + r];
              atomic_add4(dflat + off, make_float4(wt * g.x, wt * g.y,
                                                   wt * g.z, wt * g.w));
            }
          }
          if (need_dw) {
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o, 16);
            if ((t & 15) == 0) s_dw[c * BM + r] += dot;
          }
        }
      }
      // the next tile's Cs is written only after the syncs of its product
    }
    __syncthreads();
    if (need_dw) {
      for (int t = tid; t < nc * BM; t += THREADS) {
        const int c = t / BM;
        const int p = p0 + t % BM;
        if (p < px) {
          float* dst = dw + ((size_t)c * K + k) * px + p;
          if (gridDim.y == 1) *dst = s_dw[t];
          else atomicAdd(dst, s_dw[t]);
        }
        s_dw[t] = 0.f;
      }
    }
  }
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

// Launchers shared by the four C entries.
template <bool GROUPED>
inline int launch_bwd_data(const void* flat, const void* idx, const void* w,
                           const void* W, const void* dout, void* dflat,
                           void* dw, int C, int Cg, int outG, int nc, int K,
                           int px, int cout, int tile_splits, int is_bf16,
                           void* stream) {
  const dim3 grid((px + BM - 1) / BM, tile_splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    bwd_data_kernel<T, GROUPED><<<grid, Mma<T>::THREADS, 0, s>>>(
        static_cast<const T*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const T*>(W),
        static_cast<const T*>(dout), static_cast<float*>(dflat),
        static_cast<float*>(dw), C, Cg, outG, nc, K, px, cout);
  } else {
    using T = float;
    bwd_data_kernel<T, GROUPED><<<grid, Mma<T>::THREADS, 0, s>>>(
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
