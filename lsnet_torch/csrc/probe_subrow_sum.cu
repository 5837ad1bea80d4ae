// Probe: read the sub-row views of a tile that is resident in shared memory.
//
//   out[p, c] = sum_j float(x[p, j, c])     x (P, 8, 128) bf16, out (P, 128)
//                                           f32
//
// Replaces the TPU probe tools/probe_dma2.py (probe_b): a (TPX, 8, 128)
// bf16 scratch read at each static middle index x[:, j, :], the operand
// view of the gather rework's 8 partial products, summed in f32.
//
// Bound: bytes (2 * P * 8 * 128 read, 4 * P * 128 written): 0.05 ms on the
// H100 at P = 65,536. A block that staged one tile, waited for all of it
// and then summed never overlapped its copy with its arithmetic.
//
// A persistent ring of whole tiles. The grid is min(tiles, SMs *
// CTAS_PER_SM) CTAs; CTA b takes tiles b, b + grid, ... of TP pixels. A
// tile is contiguous (TP * 2 KB), so one lane of a producer warp copies it
// with one cp.async.bulk that completes on its stage's full mbarrier, into
// a ring of STAGES tiles in dynamic shared memory: the copies of the next
// tiles are in flight while THREADS consumer threads sum this one. The
// barriers keep the order of CUTLASS's PipelineTmaAsync: the producer
// waits on a stage's empty barrier (one arrival per consumer warp, after
// the warp's reads) before it refills the stage, and the consumers wait on
// its full barrier (one arrival with the tile's bytes) before they read.
// The ragged last tile copies and writes only its rows. Two 32 KB stages
// and three CTAs an SM keep up to 192 KB of x in flight on each SM; x
// carries no L2 policy (at P = 65,536 the H100 took 60.2 us with an
// evict_first hint on it, 57.1 without: tools/bench_probes.py).
//
// A consumer thread takes 8 consecutive columns of one pixel (TP * 16
// threads cover the tile). It reads the eight views x[p, j, c0 : c0 + 8]
// as eight 16-byte shared loads (a quarter-warp reads 128 contiguous
// bytes: no bank conflict), sums each column in f32 in the order j = 0..7
// (the bits of a sum in that order, whatever the launch) and writes its
// 32 bytes of out as two float4 stores.
//
// Every wait is bounded: after WAIT_LIMIT polls the thread traps and the
// launch fails instead of hanging the device.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TP = 16;          // pixels of a tile
constexpr int J = 8;            // sub-rows of a pixel's row
constexpr int C = 128;          // elements of a sub-row
constexpr int VEC = 8;          // columns of a consumer thread (16 bytes)
constexpr int THREADS = 256;    // consumer threads, one producer warp more
constexpr int STAGES = 2;       // tiles of the ring
constexpr int CTAS_PER_SM = 3;
constexpr int WAIT_LIMIT = 1 << 22;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_BYTES = J * C * 2;             // a pixel's row, 2 KB
constexpr int TILE_BYTES = TP * ROW_BYTES;       // 32 KB
constexpr int SMEM_BYTES = STAGES * TILE_BYTES + 2 * STAGES * 8;
static_assert(THREADS == TP * C / VEC, "a thread per 8 columns of a pixel");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(bar), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :
               : "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spin = 0; spin < WAIT_LIMIT && !done; ++spin)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  if (!done) __trap();
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :
      : "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the 8 bf16 of a view x[p, j, c0 : c0 + 8], one 16-byte shared load
__device__ __forceinline__ uint4 view8(const unsigned char* v) {
  return *reinterpret_cast<const uint4*>(v);
}

// adds the two bf16 of w (low half first) to a[0], a[1]; a bf16 is the
// high half of its f32
__device__ __forceinline__ void add2(float* a, uint32_t w) {
  a[0] += __uint_as_float(w << 16);
  a[1] += __uint_as_float(w & 0xffff0000u);
}

__global__ void __launch_bounds__(THREADS + 32)
probe_subrow_sum_kernel(const __nv_bfloat16* __restrict__ x,
                        float* __restrict__ out, int P) {
  extern __shared__ __align__(128) unsigned char ring[];
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t full0 = ring0 + STAGES * TILE_BYTES;   // a barrier a stage
  const uint32_t empty0 = full0 + STAGES * 8;
  const int tiles = (P + TP - 1) / TP;
  // tiles blockIdx.x + k gridDim.x for k < mine
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == THREADS) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= THREADS) {          // the producer warp: one lane
    if (threadIdx.x == THREADS) {
      for (int k = 0; k < mine; ++k) {
        const int s = k % STAGES;
        // use k / STAGES of the stage: wait for the consumers' release of
        // the use before it
        if (k >= STAGES) mbar_wait(empty0 + 8 * s, (k / STAGES - 1) & 1);
        const int p0 = (blockIdx.x + k * gridDim.x) * TP;
        const int bytes = min(TP, P - p0) * ROW_BYTES;
        mbar_arrive_expect(full0 + 8 * s, bytes);
        bulk_load(ring0 + s * TILE_BYTES,
                  x + static_cast<size_t>(p0) * J * C, bytes, full0 + 8 * s);
      }
    }
    return;
  }

  const int p = threadIdx.x / (C / VEC);
  const int c0 = (threadIdx.x % (C / VEC)) * VEC;
  for (int k = 0; k < mine; ++k) {
    const int s = k % STAGES;
    const int p0 = (blockIdx.x + k * gridDim.x) * TP;
    mbar_wait(full0 + 8 * s, (k / STAGES) & 1);
    if (p < P - p0) {
      const unsigned char* row =
          ring + s * TILE_BYTES + p * ROW_BYTES + c0 * 2;
      float a[VEC] = {};
#pragma unroll
      for (int j = 0; j < J; ++j) {      // the view x[:, j, :]
        const uint4 v = view8(row + j * C * 2);
        add2(a + 0, v.x);
        add2(a + 2, v.y);
        add2(a + 4, v.z);
        add2(a + 6, v.w);
      }
      float4* o = reinterpret_cast<float4*>(
          out + static_cast<size_t>(p0 + p) * C + c0);
      o[0] = make_float4(a[0], a[1], a[2], a[3]);
      o[1] = make_float4(a[4], a[5], a[6], a[7]);
    }
    // the warp's reads of the stage are done: release it to the producer
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty0 + 8 * s);
  }
}

}  // namespace

// C entry. The Python wrapper checks that x is (P, 8, 128) bf16, contiguous
// and 16-byte aligned, P >= 1. min(ceil(P / TP), SMs * CTAS_PER_SM) blocks
// of THREADS + 32 threads on `stream`, the ring opted in above 48 KB;
// returns the error of the device query, the opt-in or the launch, or
// cudaGetLastError().
extern "C" int lsnet_probe_subrow_sum(const void* x, void* out, int P,
                                      void* stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_subrow_sum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::min((P + TP - 1) / TP, sms * CTAS_PER_SM);
  probe_subrow_sum_kernel<<<grid, THREADS + 32, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), P);
  return static_cast<int>(cudaGetLastError());
}
