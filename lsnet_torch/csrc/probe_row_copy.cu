// Probe: one engine-driven copy of a row from device memory to shared
// memory, a wait, then shared memory -> out by the same engine.
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
// memory (complete_tx), and the warp waits on the barrier's phase. No
// thread touches the row on its way in or out: the same thread hands the
// row back to the engine with a bulk store (cp.async.bulk.global.shared),
// and waits for the engine to have read it before the block exits. A plain
// out[i] = x[i] through registers would not answer the question.
//
// Bound: bytes (row_bytes in, row_bytes out); at 512 bytes the time is the
// launch's, so the kernel keeps the fixed costs around the copy small: one
// warp, the barrier set up by the thread that issues the copy, a warp-level
// sync instead of a block barrier.
//
// A wrong byte count would leave the barrier waiting for ever, so the wait
// is bounded: after WAIT_LIMIT polls the warp traps, and the launch fails
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
  // The initialised barrier must be visible to the async proxy before the
  // copy reports its bytes to it. fence.mbarrier_init (release, cluster
  // scope; the block is a cluster of one) is the fence PTX gives for that,
  // and on the H100 the lighter of the two that order it:
  // fence.proxy.async.shared::cta took 0.014 us longer a launch. A run
  // without any fence was right in 1,000 launches, but nothing in the
  // memory model promises it.
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

__device__ __forceinline__ void bulk_copy_s2g(void* dst, uint32_t src,
                                              uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :
               : "l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
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

__global__ void __launch_bounds__(32)
probe_row_copy_kernel(const unsigned char* __restrict__ x,
                      unsigned char* __restrict__ out, int row_bytes) {
  __shared__ __align__(128) unsigned char row[MAX_ROW_BYTES];
  __shared__ __align__(8) uint64_t bar_storage;
  const uint32_t bar = smem_addr(&bar_storage);

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    // the one arrival, with the bytes the copy will report
    mbar_arrive_expect(bar, row_bytes);
    bulk_copy_g2s(smem_addr(row), x, row_bytes, bar);
  }
  __syncwarp();                 // the other lanes poll an initialised barrier
  // the warp waits for the barrier's phase 0 to complete
  uint32_t done = 0;
  for (int spin = 0; spin < WAIT_LIMIT && !done; ++spin)
    done = mbar_try_wait(bar, 0);
  if (!done) __trap();
  if (threadIdx.x == 0) {
    // Only the async proxy has written the row and only it reads it back,
    // and the completed phase orders the load's writes before this store
    // is issued: no proxy fence between the two.
    bulk_copy_s2g(out, smem_addr(row), row_bytes);
    // the row must stay until the engine has read it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace

// C entry. The Python wrapper checks that x is contiguous and 16-byte
// aligned and that 16 <= row_bytes <= 16384 is a multiple of 16. One warp
// on `stream`; returns cudaGetLastError().
extern "C" int lsnet_probe_row_copy(const void* x, void* out, int row_bytes,
                                    void* stream) {
  probe_row_copy_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      row_bytes);
  return static_cast<int>(cudaGetLastError());
}
