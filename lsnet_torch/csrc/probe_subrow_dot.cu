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
// Here a block stages its 16-pixel tile of x (32 KB) in shared memory once
// and, for each j, stages w[j] (32 KB; all of w is 256 KB and does not
// fit) and multiplies the view x[:, j, :] by it with WMMA m16n16k16 bf16
// fragments: the A fragment is loaded straight from the view, base
// j * 128 elements and leading dimension 8 * 128, with no repacking. Each
// of the 8 warps owns 16 of the 128 output columns and keeps one f32
// accumulator fragment over all j.
//
// The two buffers take 64 KB, above the 48 KB a kernel gets without asking,
// so they are dynamic shared memory and the entry point opts in with
// cudaFuncSetAttribute.
//
// Bound: 2 * P * 8 * 128 * 128 operations against 2 * P * 1024 bytes of x,
// 256 KB of weights and 4 * P * 128 bytes of output. At the probe's P = 16
// that is 14 operations a byte, and at any P at most 102 (262,144
// operations against 2,560 bytes a pixel), below the H100's 295: bytes
// bound it, and at P = 16 the measured time is the launch's.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int TP = 16;     // pixels of a tile: one fragment row
constexpr int J = 8;       // sub-rows of a pixel's row
constexpr int C = 128;     // elements of a sub-row (the product's depth)
constexpr int N = 128;     // output columns
constexpr int X_BYTES = TP * J * C * 2;
constexpr int W_BYTES = C * N * 2;
constexpr int SMEM_BYTES = X_BYTES + W_BYTES;

__device__ __forceinline__ void copy_async(void* smem_dst, const void* src,
                                           int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(dst + i), "l"(s + i)
                 : "memory");
}

__global__ void __launch_bounds__(256)
probe_subrow_dot_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        float* __restrict__ out, int P) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + X_BYTES);

  const int p0 = blockIdx.x * TP;
  const int rows = min(TP, P - p0);
  const int warp = threadIdx.x / 32;
  // rows of the tile past P multiply as zeros
  for (int e = rows * J * C + threadIdx.x; e < TP * J * C; e += blockDim.x)
    xs[e] = __float2bfloat16(0.f);
  copy_async(xs, x + static_cast<size_t>(p0) * J * C, rows * J * C * 2);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  for (int j = 0; j < J; ++j) {
    __syncthreads();                       // the last w[j] has been read
    copy_async(ws, w + static_cast<size_t>(j) * C * N, W_BYTES);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, xs + j * C + kk, J * C);   // x[:, j, kk:]
      wmma::load_matrix_sync(fb, ws + kk * N + warp * 16, N);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  __syncthreads();
  float* cs = reinterpret_cast<float*>(ws);                 // (TP, N) f32
  wmma::store_matrix_sync(cs + warp * 16, acc, N, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * N; e += blockDim.x)
    out[static_cast<size_t>(p0) * N + e] = cs[e];
}

}  // namespace

// C entry. The Python wrapper checks that x is (P, 8, 128) and w
// (8, 128, 128), bf16, contiguous and 16-byte aligned, P >= 1.
// ceil(P / 16) blocks of 256 threads on `stream`; returns the error of the
// shared-memory opt-in or cudaGetLastError().
extern "C" int lsnet_probe_subrow_dot(const void* x, const void* w, void* out,
                                      int P, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_subrow_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_subrow_dot_kernel<<<(P + TP - 1) / TP, 256, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(out), P);
  return static_cast<int>(cudaGetLastError());
}
