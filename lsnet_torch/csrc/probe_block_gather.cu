// Probe: gather whole row blocks by an index that lives in device memory.
//
//   out[i] = x_blocks[idx[i]]     x_blocks (nblocks, block_bytes), idx (n,)
//                                 int32, clamped to [0, nblocks - 1]
//
// Replaces the TPU probe tools/probe_dma2.py (probe_a): a dynamic, 8-row
// aligned slice x[idx*8 : idx*8+8] of a (rows*8, 128) bf16 array (2,048
// bytes) copied asynchronously to on-chip scratch, with the index known to
// the kernel before its body through scalar prefetch. On Hopper a block
// loads its indices itself: the host never reads them. The probe's own case
// is n = 1, idx = [5]; at many random indices the same kernel measures the
// copy-only rate of the fused gather's row fetch.
//
// Bound: bytes (each distinct block read once, n * block_bytes written,
// 4 n of indices). At 147,456 random 2 KB blocks of a 64 MB table that is
// 0.11 ms on the H100; a block per CTA that fetched, waited and stored in
// turn never overlapped the fetch of one block with the store of the last.
//
// A persistent, engine-driven ring. The grid is min(ceil(n / IDX_CHUNK),
// SMs * CTAS_PER_SM) single-warp CTAs; CTA c owns a contiguous run of
// outputs (n / grid of them, one more for the first n % grid CTAs), so its
// stores stream in order. Each CTA keeps a ring of `stages` =
// min(MAX_STAGES, RING_BYTES / block_bytes) blocks in dynamic shared memory
// (12 at 2 KB, 1 at 16 KB), each stage with its own full mbarrier. Lane 0
// drives the copy engine (the Tensor Memory Accelerator in its
// descriptor-free form): a block comes in by one cp.async.bulk that
// reports its bytes to the stage's barrier, and goes out by one bulk store
// (cp.async.bulk.global.shared::cta.bulk_group) as soon as the barrier's
// phase completes; no thread touches the bytes. A stage is refilled once
// the store that read it has been read out (cp.async.bulk.wait_group.read
// of all but the newest lag = stages / STORE_DIV stores): stages - lag
// loads and up to lag stores are in flight, 18 KB of loads a CTA at 2 KB
// blocks and CTAS_PER_SM of them an SM (Little's law: 3.35 TB/s at about
// 1 us of latency needs about 25 KB an SM). Many small rings beat few
// large ones: at 147,456 blocks the H100 took 219.3 us with 2 CTAs an SM
// of 32 KB rings, 194.2 with 4, 187.7 with 8 of 24 KB and 187.1 with 12 of
// 16 KB (tools/bench_probes.py, its gather_ring* splits).
//
// Indices are read ahead: the warp loads IDX_CHUNK of them at once
// (coalesced, clamped) and the next IDX_CHUNK while those are in flight,
// and lane 0 takes each from its lane with __shfl_sync, so no index round
// trip sits in front of a copy. The table's lines are loaded with an L2
// evict_last policy (147,456 draws from 32,768 blocks read each block
// about 4.5 times) and the output, written once, is stored evict_first.
// Lines kept by evict_last outlive the kernel (a write of 256 MB does not
// evict them; libcuda's cuCtxResetPersistingL2Cache does).
//
// At n = 1, the probe's own case, the ring's set-up is all latency: one
// lane reads the index, sets up one barrier under that load's latency and
// moves the block in and out (ONE: 1.30 us on the H100, the ring 1.58).
//
// A wrong byte count would leave a barrier waiting for ever, so every wait
// is bounded: after WAIT_LIMIT polls the warp traps and the launch fails.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RING_BYTES = 24576;  // the ring of a CTA, in dynamic smem
constexpr int MAX_STAGES = 32;     // the ring's stages at small blocks
constexpr int STORE_DIV = 4;       // stages / STORE_DIV stores may still
                                   // read the ring when it is refilled
constexpr int IDX_CHUNK = 32;      // indices a warp loads at once
constexpr int CTAS_PER_SM = 8;
constexpr int WAIT_LIMIT = 1 << 22;
constexpr int MAX_BLOCK_BYTES = 16384;
static_assert(RING_BYTES >= MAX_BLOCK_BYTES, "a stage at the largest block");
static_assert(RING_BYTES + 8 * MAX_STAGES <= 48 * 1024,
              "the ring fits a launch without the shared-memory opt-in");
static_assert(IDX_CHUNK == 32, "one index a lane");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(bar), "r"(arrivals)
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

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      :
      : "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// waits until at most `pending` (<= N) of this thread's bulk stores still
// read shared memory (wait_group.read takes its count as an immediate)
template <int N>
__device__ __forceinline__ void wait_read(int pending) {
  if constexpr (N > 0) {
    if (pending < N) {
      wait_read<N - 1>(pending);
      return;
    }
  }
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n"
      :
      : "l"(dst), "r"(src), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// ONE: the probe's own n = 1, one output (and CTA) each; else the ring.
template <bool ONE>
__global__ void __launch_bounds__(32)
probe_block_gather_kernel(const unsigned char* __restrict__ x,
                          const int* __restrict__ idx,
                          unsigned char* __restrict__ out, int n, int nblocks,
                          int block_bytes, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  const int lane = threadIdx.x;
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t full0 = ring0 + stages * block_bytes;  // a barrier a stage

  if constexpr (ONE) {
    // the index load first: the barrier's set-up runs under its latency
    if (lane != 0) return;
    const int b = min(max(idx[blockIdx.x], 0), nblocks - 1);
    mbar_init(full0, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_expect(full0, block_bytes);
    bulk_load(ring0, x + static_cast<size_t>(b) * block_bytes, block_bytes,
              full0, policy_evict_last());
    mbar_wait(full0, 0);
    bulk_store(out + static_cast<size_t>(blockIdx.x) * block_bytes, ring0,
               block_bytes, policy_evict_first());
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    return;
  }

  // the outputs [lo, lo + count) of this CTA: n / grid each, one more for
  // the first n % grid CTAs
  const int per = n / gridDim.x, extra = n % gridDim.x;
  const int count = per + (static_cast<int>(blockIdx.x) < extra);
  const int lo = blockIdx.x * per + min(static_cast<int>(blockIdx.x), extra);

  uint64_t keep = 0, stream = 0;
  if (lane == 0) {
    for (int s = 0; s < min(stages, count); ++s) mbar_init(full0 + 8 * s, 1);
    // the initialised barriers must be visible to the async proxy before a
    // copy reports its bytes to them (as in probe_row_copy.cu)
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    keep = policy_evict_last();
    stream = policy_evict_first();
  }
  __syncwarp();

  // lane l holds the clamped index of output lo + IDX_CHUNK c + l of the
  // chunk c in flight (cur) and of chunk c + 1 (nxt)
  auto chunk = [&](int c) {
    const int i = IDX_CHUNK * c + lane;
    const int b = i < count ? idx[lo + i] : 0;
    return min(max(b, 0), nblocks - 1);
  };
  int c = 0, cur = chunk(0), nxt = chunk(1);
  int at = 0, ls = 0;       // lane of the next load's index, its stage
  // load the next output into the next stage (every lane takes part: the
  // index comes from its lane by a shuffle)
  auto load_next = [&]() {
    if (at == IDX_CHUNK) {
      cur = nxt;
      nxt = chunk(++c + 1);
      at = 0;
    }
    const int b = __shfl_sync(0xffffffffu, cur, at++);
    if (lane == 0) {
      const uint32_t bar = full0 + 8 * ls;
      mbar_arrive_expect(bar, block_bytes);
      bulk_load(ring0 + ls * block_bytes,
                x + static_cast<size_t>(b) * block_bytes, block_bytes, bar,
                keep);
    }
    if (++ls == stages) ls = 0;
  };

  const int lag = stages / STORE_DIV;     // stores left reading the ring
  const int ahead = stages - lag;         // loads in flight
  for (int j = 0; j < min(ahead, count); ++j) load_next();
  int s = 0;
  uint32_t phase = 0;                     // of stage s's barrier
  for (int k = 0; k < count; ++k) {
    const bool refill = k + ahead < count;
    if (lane == 0) {
      mbar_wait(full0 + 8 * s, phase);
      // the load completed on the barrier and only the async proxy reads
      // the stage back: no proxy fence between the two
      bulk_store(out + static_cast<size_t>(lo + k) * block_bytes,
                 ring0 + s * block_bytes, block_bytes, stream);
      // stage (k - lag) % stages, refilled next, has been read out
      if (refill) wait_read<MAX_STAGES / STORE_DIV>(lag);
    }
    if (refill) load_next();
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
  // the ring must stay until the engine has read every stage out
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace

// C entry. The Python wrapper checks contiguity, 16-byte alignment and that
// 16 <= block_bytes <= 16384 is a multiple of 16; n >= 1. At n = 1 one CTA
// copies the one block; else the persistent grid runs the ring. On
// `stream`; returns the error of the device query or the launch, or
// cudaGetLastError().
extern "C" int lsnet_probe_block_gather(const void* x, const void* idx,
                                        void* out, int n, int nblocks,
                                        int block_bytes, void* stream) {
  const auto* xs = static_cast<const unsigned char*>(x);
  const auto* is = static_cast<const int*>(idx);
  auto* os = static_cast<unsigned char*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 1) {
    probe_block_gather_kernel<true><<<1, 32, block_bytes + 8, st>>>(
        xs, is, os, n, nblocks, block_bytes, 1);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int stages = std::min(MAX_STAGES, RING_BYTES / block_bytes);
  const int smem = stages * (block_bytes + 8);
  const int grid =
      std::min((n + IDX_CHUNK - 1) / IDX_CHUNK, sms * CTAS_PER_SM);
  probe_block_gather_kernel<false><<<grid, 32, smem, st>>>(
      xs, is, os, n, nblocks, block_bytes, stages);
  return static_cast<int>(cudaGetLastError());
}
