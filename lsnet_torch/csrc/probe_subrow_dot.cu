// Probe: a tensor-core product taken from the sub-row views of a tile that
// is resident in shared memory, accumulated in f32.
//
//   out[p, :] = sum_j x[p, j, :] @ w[j]     x (P, 8, 128) bf16,
//                                           w (8, 128, 128) bf16,
//                                           out (P, 128) f32
//
// Replaces the TPU probe tools/probe_dma2.py (probe_c): a 2-D dot on the
// view x[:, j, :] of a (TPX, 8, 128) scratch against w[j] with f32
// accumulation on the matrix unit, the contraction of the gather rework.
//
// One kernel body, two launch shapes <TP, NQ, JB, KS>: TP pixels a tile,
// the 128 output columns cut into NQ slices, JB of the 8 sub-rows a block
// (so the sum over j is split across the CL = 8 / JB blocks of a
// thread-block cluster), and the 128-deep product of each sub-row split
// into KS depth slices across the warps of a block. The grid is
// (ceil(P / TP) * NQ, CL), clusters (1, CL, 1). Block (t, q, rank) stages
// the views x[TP t : TP t + TP, j, :] and columns q NB .. q NB + NB - 1 of
// w[j] for its JB sub-rows with 16-byte cp.async copies, one group per j
// in a ring of up to LARGE_STAGES stages (with one sub-row, every copy in
// flight at once and one wait), and multiplies each view by its w[j] with
// WMMA m16n16k16 bf16 fragments into f32 accumulators: a warp owns one
// 16-column strip, one depth slice and every PHASES-th 16-pixel fragment.
// Fragments wholly past P are neither staged nor multiplied (rows of the
// last one past P are zeros). The KS slices are summed in shared memory in
// order; then the CL partial tiles of a tile meet through distributed
// shared memory: after a cluster barrier, rank r reads its 1/CL of the
// tile's pixels from every peer and sums them in rank order (no atomics,
// the same bits every run); a second cluster barrier keeps each block
// resident until its peers have read it.
//
// - Few tiles (the probe's P = 16): <16, 8, 1, 8>. Each of 64 blocks on 64
//   SMs fetches 16 pixels of one view and a 128 x 16 slice of w[j] (4 KB
//   each) at once instead of one block fetching 288 KB in 8 turns, and its
//   8 warps take one 16-deep step each instead of one warp taking 8 in a
//   chain. (TMA boxes in place of the copies were slower here: one thread
//   sets up a barrier and the engine fetches the tensor map before the
//   first byte moves.)
// - At least 64 pixels per SM: <128, 1, 8, 1>. The tiles fill the SMs by
//   themselves, so a block takes all of j in a two-stage ring and there
//   are no partials to move; w is read from L2 once per 128-pixel tile.
//   (The small shape re-reads every pixel's row once per column slice and
//   its blocks are tiny: 370 us at P = 16,384 on the H100.)
//
// Staged rows are padded by 8 elements (16 bytes) so that the rows of a
// fragment fall on different banks. The ring of the large shape takes
// 139,264 bytes (one block an SM), above the 48 KB a kernel gets without
// asking: dynamic shared memory, opted in with cudaFuncSetAttribute. The
// f32 partials reuse the ring.
//
// Bound: 2 * P * 8 * 128 * 128 operations against 2 * P * 1024 bytes of x,
// 256 KB of weights and 4 * P * 128 bytes of output. At the probe's P = 16
// that is 14 operations a byte, and at any P at most 102 (262,144
// operations against 2,560 bytes a pixel), below the H100's 295: bytes
// bound it, and at P = 16 the measured time is the launch's.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

namespace cg = cooperative_groups;

constexpr int J = 8;       // sub-rows of a pixel's row
constexpr int C = 128;     // elements of a sub-row (the product's depth)
constexpr int N = 128;     // output columns
constexpr int LD = C + 8;  // staged row of x, padded
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// the two launch shapes <TP, NQ, JB, KS>
constexpr int SMALL_TP = 16, SMALL_NQ = 8, SMALL_JB = 1, SMALL_KS = 8;
constexpr int LARGE_TP = 128, LARGE_NQ = 1, LARGE_JB = 8, LARGE_KS = 1;
constexpr int LARGE_STAGES = 2;
constexpr int LARGE_MIN_PX = 64;      // pixels per SM that take the large one

template <int TP, int NQ, int JB, int KS>
struct Shape {
  static constexpr int CL = J / JB;              // blocks of a cluster
  static constexpr int STAGES = JB > 1 ? LARGE_STAGES : 1;   // copy ring
  static constexpr int NB = N / NQ;              // output columns of a block
  static constexpr int LDW = NB + 8;             // staged row of w, padded
  static constexpr int STRIPS = NB / 16;         // 16-column strips
  static constexpr int PHASES = WARPS / STRIPS / KS;  // warps on a strip
  static constexpr int FPW = TP / 16 / PHASES;   // fragments of a warp
  static constexpr int X_ELEMS = TP * LD;        // a stage: x, then w[j]
  static constexpr int STAGE_BYTES = (X_ELEMS + C * LDW) * 2;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static_assert(KS * TP * NB * 4 <= SMEM_BYTES, "partials reuse the ring");
  static_assert(STRIPS * PHASES * KS == WARPS && FPW * PHASES * 16 == TP &&
                    C % (16 * KS) == 0,
                "warps tile the block's output and depth");
};

__device__ __forceinline__ void copy16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(static_cast<uint32_t>(
                     __cvta_generic_to_shared(smem_dst))),
                 "l"(src)
               : "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (pending < LARGE_STAGES = 2).
__device__ __forceinline__ void copies_wait(int pending) {
  if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One cp.async group: the view x[p0 : p0 + rows, j, :] (xg = x + p0 * J *
// C) and w[j]'s columns from wg (= w + q * NB) into a stage at xs.
template <class S>
__device__ __forceinline__ void stage_copy(__nv_bfloat16* xs,
                                           const __nv_bfloat16* xg,
                                           const __nv_bfloat16* wg, int rows,
                                           int j) {
  constexpr int XP = C / 8, WP = S::NB / 8;      // 16-byte pieces of a row
  __nv_bfloat16* ws = xs + S::X_ELEMS;
  for (int i = threadIdx.x; i < rows * XP; i += THREADS)
    copy16(xs + (i / XP) * LD + (i % XP) * 8,
           xg + static_cast<size_t>(i / XP) * J * C + j * C + (i % XP) * 8);
  for (int i = threadIdx.x; i < C * WP; i += THREADS)
    copy16(ws + (i / WP) * S::LDW + (i % WP) * 8,
           wg + (static_cast<size_t>(j) * C + i / WP) * N + (i % WP) * 8);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int TP, int NQ, int JB, int KS>
__global__ void __launch_bounds__(THREADS)
probe_subrow_dot_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        float* __restrict__ out, int P) {
  using namespace nvcuda;
  using S = Shape<TP, NQ, JB, KS>;
  extern __shared__ __align__(128) unsigned char smem[];
  // after the product: KS partial tiles (TP, NB), summed into the first
  float* part = reinterpret_cast<float*>(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // = blockIdx.y
  const int q = blockIdx.x % NQ;
  const int p0 = blockIdx.x / NQ * TP;
  const int rows = min(TP, P - p0);
  const int frags = (rows + 15) / 16;    // 16-pixel fragments holding a pixel
  const int warp = threadIdx.x / 32;
  const int strip = warp % S::STRIPS;
  const int phase = warp / S::STRIPS % S::PHASES;
  const int ks = warp / (S::STRIPS * S::PHASES);  // the warp's depth slice
  const __nv_bfloat16* xg = x + static_cast<size_t>(p0) * J * C;
  const __nv_bfloat16* wg = w + q * S::NB;
  auto stage_at = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * S::STAGE_BYTES);
  };

  // rows of the last fragment past P multiply as zeros, in every stage
  for (int s = 0; s < S::STAGES; ++s)
    for (int i = rows * (C / 8) + threadIdx.x; i < frags * 16 * (C / 8);
         i += THREADS)
      *reinterpret_cast<uint4*>(stage_at(s) + (i / (C / 8)) * LD +
                                (i % (C / 8)) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  const int j0 = rank * JB;
  for (int s = 0; s < S::STAGES; ++s)
    stage_copy<S>(stage_at(s), xg, wg, rows, j0 + s);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[S::FPW];
#pragma unroll
  for (int k = 0; k < S::FPW; ++k) wmma::fill_fragment(acc[k], 0.f);
  for (int jj = 0; jj < JB; ++jj) {
    copies_wait(min(S::STAGES - 1, JB - 1 - jj));
    __syncthreads();                      // stage jj % STAGES has landed
    const __nv_bfloat16* xs = stage_at(jj % S::STAGES);
    const __nv_bfloat16* ws = xs + S::X_ELEMS;
    // the warp's depth slice: 16 deep in the small shape (one step, so the
    // code a launch fetches stays short), all 128 in the large one
    constexpr int DEPTH = C / KS;
    const int k0 = KS == 1 ? 0 : ks * DEPTH;
#pragma unroll
    for (int kk = k0; kk < k0 + DEPTH; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fb, ws + kk * S::LDW + strip * 16, S::LDW);
#pragma unroll
      for (int k = 0; k < S::FPW; ++k) {
        const int f = phase + k * S::PHASES;
        if (f < frags) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::load_matrix_sync(fa, xs + f * 16 * LD + kk, LD);
          wmma::mma_sync(acc[k], fa, fb, acc[k]);
        }
      }
    }
    __syncthreads();                      // the stage has been read
    if (jj + S::STAGES < JB)
      stage_copy<S>(stage_at(jj % S::STAGES), xg, wg, rows,
                    j0 + jj + S::STAGES);
  }
#pragma unroll
  for (int k = 0; k < S::FPW; ++k) {
    const int f = phase + k * S::PHASES;
    if (f < frags)
      wmma::store_matrix_sync(part + ks * TP * S::NB + f * 16 * S::NB +
                                  strip * 16,
                              acc[k], S::NB, wmma::mem_row_major);
  }
  if (KS > 1) {                           // the depth slices, in order
    __syncthreads();
    for (int e = threadIdx.x; e < frags * 16 * S::NB; e += THREADS) {
      float s = part[e];
#pragma unroll
      for (int k = 1; k < KS; ++k) s += part[k * TP * S::NB + e];
      part[e] = s;
    }
  }
  cluster.sync();                         // every partial of the tile written

  // rank r sums pixels [lo, hi) of the tile over the CL partials in rank
  // order
  const int per = (rows + S::CL - 1) / S::CL;
  const int lo = min(rows, rank * per);
  const int hi = min(rows, lo + per);
  const float4* peer[S::CL];
#pragma unroll
  for (int r = 0; r < S::CL; ++r)
    peer[r] = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, r));
  constexpr int V = S::NB / 4;            // float4 of a partial row
  float* og = out + static_cast<size_t>(p0) * N + q * S::NB;
  for (int i = lo * V + threadIdx.x; i < hi * V; i += THREADS) {
    float4 v[S::CL];
#pragma unroll
    for (int r = 0; r < S::CL; ++r) v[r] = peer[r][i];
    float4 s = v[0];
#pragma unroll
    for (int r = 1; r < S::CL; ++r) {
      s.x += v[r].x;
      s.y += v[r].y;
      s.z += v[r].z;
      s.w += v[r].w;
    }
    *reinterpret_cast<float4*>(og + (i / V) * N + (i % V) * 4) = s;
  }
  cluster.sync();                         // no peer reads a block that left
}

template <int TP, int NQ, int JB, int KS>
cudaError_t launch(const void* x, const void* w, void* out, int P,
                   cudaStream_t stream) {
  using S = Shape<TP, NQ, JB, KS>;
  auto* kernel = probe_subrow_dot_kernel<TP, NQ, JB, KS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = S::CL;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((P + TP - 1) / TP * NQ, S::CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = S::SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(w),
                           static_cast<float*>(out), P);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// C entry. The Python wrapper checks that x is (P, 8, 128) and w
// (8, 128, 128), bf16, contiguous and 16-byte aligned, P >= 1. The large
// shape once P gives every SM of the current device 64 pixels (its tiles
// then fill at least half the SMs), else the small one; returns the error
// of the device query, the shared-memory opt-in or the launch, or
// cudaGetLastError().
extern "C" int lsnet_probe_subrow_dot(const void* x, const void* w, void* out,
                                      int P, void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((P + LARGE_MIN_PX - 1) / LARGE_MIN_PX >= sms)
    err = launch<LARGE_TP, LARGE_NQ, LARGE_JB, LARGE_KS>(x, w, out, P, s);
  else
    err = launch<SMALL_TP, SMALL_NQ, SMALL_JB, SMALL_KS>(x, w, out, P, s);
  return static_cast<int>(err);
}
