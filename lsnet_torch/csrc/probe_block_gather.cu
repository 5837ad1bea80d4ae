// Probe: gather whole row blocks by an index that lives in device memory.
//
//   out[i] = x_blocks[idx[i]]     x_blocks (nblocks, block_bytes), idx (n,)
//                                 int32, clamped to [0, nblocks - 1]
//
// Replaces the TPU probe tools/probe_dma2.py (probe_a): a dynamic, 8-row
// aligned slice x[idx*8 : idx*8+8] of a (rows*8, 128) bf16 array (2,048
// bytes) copied asynchronously to on-chip scratch, with the index known to
// the kernel before its body through scalar prefetch. On Hopper a block
// loads its own index: the host never reads it. Block i reads idx[i] from
// device memory, issues the block's bytes as 16-byte cp.async copies into
// shared memory (no register staging), waits with cp.async.wait_all and
// writes shared memory to out. The probe's own case is n = 1, idx = [5];
// at many random indices the same kernel measures the copy-only rate of the
// fused gather's row fetch.
//
// Bound: bytes (n * block_bytes read, the same written, 4 n of indices).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_BLOCK_BYTES = 16384;

__global__ void __launch_bounds__(128)
probe_block_gather_kernel(const unsigned char* __restrict__ x,
                          const int* __restrict__ idx,
                          unsigned char* __restrict__ out, int nblocks,
                          int block_bytes) {
  __shared__ __align__(16) unsigned char buf[MAX_BLOCK_BYTES];
  int b = idx[blockIdx.x];
  b = min(max(b, 0), nblocks - 1);
  const unsigned char* src = x + static_cast<size_t>(b) * block_bytes;
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  for (int i = threadIdx.x * 16; i < block_bytes; i += blockDim.x * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :
                 : "r"(dst + i), "l"(src + i)
                 : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  unsigned char* o = out + static_cast<size_t>(blockIdx.x) * block_bytes;
  for (int i = threadIdx.x * 16; i < block_bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(o + i) = *reinterpret_cast<const uint4*>(buf + i);
}

}  // namespace

// C entry. The Python wrapper checks contiguity, 16-byte alignment and that
// 16 <= block_bytes <= 16384 is a multiple of 16; n >= 1 blocks of 128
// threads on `stream`; returns cudaGetLastError().
extern "C" int lsnet_probe_block_gather(const void* x, const void* idx,
                                        void* out, int n, int nblocks,
                                        int block_bytes, void* stream) {
  probe_block_gather_kernel<<<n, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<const int*>(idx),
      static_cast<unsigned char*>(out), nblocks, block_bytes);
  return static_cast<int>(cudaGetLastError());
}
