// Probe: read the sub-row views of a tile that is resident in shared memory.
//
//   out[p, c] = sum_j float(x[p, j, c])     x (P, 8, 128) bf16, out (P, 128)
//                                           f32
//
// Replaces the TPU probe tools/probe_dma2.py (probe_b): a (TPX, 8, 128)
// bf16 scratch read at each static middle index x[:, j, :], the operand
// view of the gather rework's 8 partial products, summed in f32. Here a
// block stages its 16-pixel tile (32 KB) in shared memory with 16-byte
// cp.async copies and each thread sums its column over j by reading the
// view x[:, j, :] at its strides: pixel stride 8 * 128 elements, base
// j * 128.
//
// Bound: bytes (2 * P * 8 * 128 read, 4 * P * 128 written).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 16;     // pixels of a tile
constexpr int J = 8;       // sub-rows of a pixel's row
constexpr int C = 128;     // elements of a sub-row

__global__ void __launch_bounds__(256)
probe_subrow_sum_kernel(const __nv_bfloat16* __restrict__ x,
                        float* __restrict__ out, int P) {
  __shared__ __align__(16) __nv_bfloat16 xs[TP * J * C];
  const int p0 = blockIdx.x * TP;
  const int rows = min(TP, P - p0);
  const int bytes = rows * J * C * static_cast<int>(sizeof(__nv_bfloat16));
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(x + static_cast<size_t>(p0) * J * C);
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(xs));
  for (int i = threadIdx.x * 16; i < bytes; i += blockDim.x * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(dst + i), "l"(src + i)
                 : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int p = e / C;
    const int c = e % C;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)          // the view x[:, j, :]
      acc += __bfloat162float(xs[p * (J * C) + j * C + c]);
    out[static_cast<size_t>(p0 + p) * C + c] = acc;
  }
}

}  // namespace

// C entry. The Python wrapper checks that x is (P, 8, 128) bf16, contiguous
// and 16-byte aligned, P >= 1. ceil(P / 16) blocks of 256 threads on
// `stream`; returns cudaGetLastError().
extern "C" int lsnet_probe_subrow_sum(const void* x, void* out, int P,
                                      void* stream) {
  probe_subrow_sum_kernel<<<(P + TP - 1) / TP, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), P);
  return static_cast<int>(cudaGetLastError());
}
