// Probe: one engine-driven copy of a row from device memory to shared
// memory, a wait, then shared memory -> out.
//
//   out[0, :] = x[0, :]        x (rows, cols) of any type,
//                              row_bytes = cols * itemsize, a multiple of 16
//
// Replaces the TPU probe lsnet_tpu/ops/pallas_dma_gather.py (probe), which
// asks whether the toolchain compiles and runs a manual asynchronous copy
// (make_async_copy, start, wait). The Hopper counterpart of that copy is
// the bulk asynchronous copy of the Tensor Memory Accelerator in its
// descriptor-free form: one thread issues cp.async.bulk for the whole row,
// the hardware moves the bytes and reports them to an mbarrier in shared
// memory (complete_tx), and the block waits on the barrier's phase. No
// thread touches the row on its way in. A plain out[i] = x[i] through
// registers would not answer the question.
//
// Bound: bytes (row_bytes in, row_bytes out); at 512 bytes the time is the
// launch's.
//
// A wrong byte count would leave the barrier waiting for ever, so the wait
// is bounded: after WAIT_LIMIT polls the block traps, and the launch fails
// with an error instead of hanging the device.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROW_BYTES = 16384;
constexpr int WAIT_LIMIT = 1 << 22;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(bar), "r"(arrivals)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__global__ void __launch_bounds__(128)
probe_row_copy_kernel(const unsigned char* __restrict__ x,
                      unsigned char* __restrict__ out, int row_bytes) {
  __shared__ __align__(128) unsigned char row[MAX_ROW_BYTES];
  __shared__ __align__(8) uint64_t bar_storage;
  const uint32_t bar = smem_addr(&bar_storage);

  if (threadIdx.x == 0) mbar_init(bar, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    // the one arrival, with the bytes the copy will report
    mbar_arrive_expect(bar, row_bytes);
    bulk_copy_g2s(smem_addr(row), x, row_bytes, bar);
  }
  // every thread waits for the barrier's phase 0 to complete
  uint32_t done = 0;
  for (int spin = 0; spin < WAIT_LIMIT && !done; ++spin)
    done = mbar_try_wait(bar, 0);
  if (!done) __trap();
  for (int i = threadIdx.x * 4; i < row_bytes; i += blockDim.x * 4)
    *reinterpret_cast<uint32_t*>(out + i) =
        *reinterpret_cast<const uint32_t*>(row + i);
}

}  // namespace

// C entry. The Python wrapper checks that x is contiguous and 16-byte
// aligned and that 16 <= row_bytes <= 16384 is a multiple of 16. One block
// on `stream`; returns cudaGetLastError().
extern "C" int lsnet_probe_row_copy(const void* x, void* out, int row_bytes,
                                    void* stream) {
  probe_row_copy_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      row_bytes);
  return static_cast<int>(cudaGetLastError());
}
