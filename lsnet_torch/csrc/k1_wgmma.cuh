// Device code of the bf16 routes of K1 forward (deform_gather_contract.cu)
// and K1 bwd-weight (deform_gather_contract_bwd_weight.cu): Hopper's
// warpgroup products (wgmma) on operands staged by the Tensor Memory
// Accelerator (TMA) and by the threads' own gather.
//
// Both functions are one product per tap k of the gathered, weighted
// corner rows
//
//   V[k, p, ch] = sum_c w[c, k, p] * flat[idx[c, k, p], ch]
//
// with a dense operand: out = sum_k V[k] @ W[k] (forward) and
// d_W[k] = V[k]^T @ dout (bwd-weight). A block has two warpgroups
// (256 threads) and 256 output columns (all of cout up to 256; a larger
// cout takes one block row per 256-wide tile), and walks over 64-deep
// chunks of the product's inner dimension:
//
//   forward     block = 128 px; chunk = (tap k, 64 channels); A = V tile
//               (px x channels, K-major), B = W[k] chunk (channels x
//               cout, MN-major, as W lies in memory)
//   bwd-weight  block = (tap k, 128 channels, a share of the 64-px tiles);
//               chunk = 64 px; A = V tile transposed (channels x px,
//               MN-major: the gather writes px rows of channels), B = dout
//               chunk (px x cout, MN-major)
//
// Each warpgroup owns 64 rows of the block's output tile and keeps them in
// 128 f32 accumulator registers a thread (wgmma m64n256k16, bf16 operands
// from shared memory). So every corner row is gathered once per call
// (forward: once per 256 output columns), where the 64 x 64 tiles before
// gathered it once per 64 output columns.
//
// Staging, STAGES chunks deep, one block barrier per chunk:
//   * B chunks come by TMA (tensor maps with the 128-byte swizzle, encoded
//     by the C entries), four 64 x 64 boxes a chunk, issued by one thread
//     STAGES - 1 chunks ahead, complete on an mbarrier per stage. Out of
//     bounds rows and columns (past C, px or cout) arrive as zeros.
//   * A chunks are gathered by the threads, 16-byte corner loads weighted
//     in f32 and stored as bf16 in the same swizzled layout, while the
//     tensor cores run the previous chunk's product (wgmma is
//     asynchronous). The corner table of the next tap (forward) or px tile
//     (bwd-weight) is loaded two chunks ahead into a second buffer.
//
// Clipped rows are read even at weight 0, so a NaN propagates as in XLA.
// Forward: pixels past px read row 0 with weight 0 and are not written.
// bwd-weight: rows past px are zero in both operands (their corners are not
// read; TMA fills dout's rows past px with zeros).
//
// Waits on an mbarrier are bounded and trap, so a wrong byte count fails
// the launch instead of hanging the card.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lsnet {
namespace k1 {

constexpr int WGS = 2;                    // warpgroups of a block
constexpr int THREADS = 128 * WGS;
constexpr int ROWS = 64;                  // rows of a warpgroup (wgmma M)
constexpr int CHUNK = 64;                 // inner depth of a chunk: 128 B
constexpr int NT = 256;                   // output columns of a block
constexpr int BOX = 64;                   // a TMA box is BOX x CHUNK
constexpr int MAXNC = 4;
constexpr int STAGES = 3;
constexpr int A_BYTES = ROWS * CHUNK * 2;            // 8 KB a warpgroup
constexpr int A_STAGE = WGS * A_BYTES;               // 16 KB
constexpr int BOX_BYTES = BOX * CHUNK * 2;           // 8 KB
constexpr int B_STAGE = (NT / BOX) * BOX_BYTES;      // 32 KB
constexpr int EPI_LD = NT + 8;                       // epilogue row (elems)
constexpr int WAIT_LIMIT = 1 << 24;
constexpr int GATHER_ROWS = ROWS * 8 / 128;          // rows a thread fills

// shared memory: B stages | A stages | 2 corner tables | mbarriers
template <int TBL_ROWS>
struct Layout {
  static constexpr int B_OFF = 0;
  static constexpr int A_OFF = STAGES * B_STAGE;
  static constexpr int TBL_OFF = A_OFF + STAGES * A_STAGE;
  static constexpr int TBL_WORDS = 2 * MAXNC * TBL_ROWS;   // idx | w
  static constexpr int BAR_OFF = TBL_OFF + 2 * TBL_WORDS * 4;
  static constexpr int BYTES = BAR_OFF + STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;       // room to align to 1 KB
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory, its start moved up to a 1 KB boundary (the
// 128-byte swizzle repeats every 1 KB, and wgmma and TMA agree on it only
// for tiles that start on one)
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
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

// -------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset (all >> 4), layout type 1 in bits 62-63.
// Every tile starts on a 1 KB boundary, so the base offset is 0.
//   K-major (rows of 64 inner elements): LBO unused, SBO = 1 KB between
//     8-row groups; a 16-deep step advances the start by 32 bytes.
//   MN-major (rows of 64 outer elements, one per inner index): LBO = the
//     stride between 64-wide column blocks (boxes), SBO = 1 KB between
//     8-deep inner groups; a 16-deep step advances the start by 2 KB.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the generic proxy's shared stores (the gathered A tile) become visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma
// fence or wait
__device__ __forceinline__ void pin(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define LSNET_D8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64 x 16) B (16 x 256); TA / TB = 1: the operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, 1, 1, 1, %130, %131;\n"
      : LSNET_D8(0), LSNET_D8(8), LSNET_D8(16), LSNET_D8(24), LSNET_D8(32),
        LSNET_D8(40), LSNET_D8(48), LSNET_D8(56), LSNET_D8(64), LSNET_D8(72),
        LSNET_D8(80), LSNET_D8(88), LSNET_D8(96), LSNET_D8(104),
        LSNET_D8(112), LSNET_D8(120)
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}
#undef LSNET_D8

// The accumulator of a warpgroup's 64 x 256 tile: register i of thread
// (warp wq, lane l) holds row 16 wq + l / 4 + 8 ((i / 2) % 2) and column
// 8 (i / 4) + 2 (l % 4) + i % 2.
__device__ __forceinline__ int acc_row(int i) {
  const int l = threadIdx.x % 32;
  return 16 * ((threadIdx.x % 128) / 32) + l / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// ------------------------------------------------------- corner tables
// One table: idx[c][r] then w[c][r] (as bits), r < TBL_ROWS. Row r holds
// pixel p0 + r of tap k; pixels past px, and corners past nc, hold row 0
// and weight 0. Each thread loads entries tid + THREADS j into registers
// (load) and stores them later (store), so the loads can fly under other
// work.
template <int TBL_ROWS>
struct Table {
  static constexpr int WORDS = 2 * MAXNC * TBL_ROWS;
  static constexpr int PER_THREAD = WORDS / THREADS;
  uint32_t v[PER_THREAD];

  __device__ __forceinline__ void load(const int* __restrict__ idx,
                                       const float* __restrict__ w, int nc,
                                       int K, int px, int k, int p0) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int e = threadIdx.x + THREADS * j;
      const int c = (e / TBL_ROWS) % MAXNC;
      const int p = p0 + e % TBL_ROWS;
      v[j] = 0u;
      if (c < nc && p < px) {
        const size_t off = ((size_t)c * K + k) * (size_t)px + p;
        v[j] = e < MAXNC * TBL_ROWS ? static_cast<uint32_t>(__ldg(idx + off))
                                    : __float_as_uint(__ldg(w + off));
      }
    }
  }
  __device__ __forceinline__ void store(uint32_t* tbl) const {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) tbl[threadIdx.x + THREADS * j] = v[j];
  }
};

// One warpgroup's A tile of a chunk: 64 rows x 64 channels, row r at
// r * 128 bytes, its 16-byte vector v at (v ^ (r % 8)) * 16: the 128-byte
// swizzle that TMA writes and wgmma reads. Row r is table row trow0 + r
// (live when r < live_rows); vector v holds channels ch0 + 8 v, live when
// below C. A live row sums its nc weighted corners in f32; other rows and
// vectors are zero. Thread t fills vector t % 8 of rows t / 8 + 16 j; all
// its corner loads are issued before the first is used.
__device__ __forceinline__ void gather_tile(
    const __nv_bfloat16* __restrict__ flat, int C, int nc,
    const uint32_t* tbl, int tbl_rows, int trow0, int live_rows, int ch0,
    uint8_t* tile) {
  const int t = threadIdx.x % 128;
  const int v = t % 8;
  const int ch = ch0 + 8 * v;
  const bool live_ch = ch < C;
  const uint32_t* tidx = tbl;
  const float* tw = reinterpret_cast<const float*>(tbl + MAXNC * tbl_rows);
  uint4 raw[GATHER_ROWS][MAXNC];
#pragma unroll
  for (int j = 0; j < GATHER_ROWS; ++j) {
    const int r = t / 8 + 16 * j;
    const bool live = live_ch && r < live_rows;
#pragma unroll
    for (int c = 0; c < MAXNC; ++c) {
      raw[j][c] = make_uint4(0u, 0u, 0u, 0u);
      if (live && c < nc)
        raw[j][c] = __ldg(reinterpret_cast<const uint4*>(
            flat + (size_t)tidx[c * tbl_rows + trow0 + r] * C + ch));
    }
  }
#pragma unroll
  for (int j = 0; j < GATHER_ROWS; ++j) {
    const int r = t / 8 + 16 * j;
    const bool live = live_ch && r < live_rows;
    float a[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = 0.f;
#pragma unroll
    for (int c = 0; c < MAXNC; ++c) {
      if (live && c < nc) {
        const float wt = tw[c * tbl_rows + trow0 + r];
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw[j][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          a[2 * e] += wt * f.x;
          a[2 * e + 1] += wt * f.y;
        }
      }
    }
    uint4 packed;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
    *reinterpret_cast<uint4*>(tile + r * 128 + ((v ^ (r % 8)) << 4)) = packed;
  }
}

// One chunk's product for this warpgroup: four 16-deep wgmma steps.
// A is K-major (forward) or MN-major (bwd-weight); B is always MN-major.
template <bool A_MN>
__device__ __forceinline__ void chunk_product(float (&acc)[128],
                                              uint32_t a_tile,
                                              uint32_t b_stage) {
  wgmma_fence();
  pin(acc);
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    const uint64_t da = A_MN ? desc(a_tile + kk * 2048, BOX_BYTES, 1024)
                             : desc(a_tile + kk * 32, 16, 1024);
    const uint64_t db = desc(b_stage + kk * 2048, BOX_BYTES, 1024);
    wgmma_m64n256k16<A_MN ? 1 : 0, 1>(acc, da, db);
  }
  wgmma_commit();
}

// ------------------------------------------------------------- host side
// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that
// nothing links against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first; strides in
// bytes of dimensions 1..rank-1) cut into BOX x CHUNK boxes (1 deep in a
// third dimension), 128-byte swizzle, zeros out of bounds. Returns a CUDA
// error code, 0 on success.
inline int bf16_map(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t box[3] = {BOX, CHUNK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Opts `kernel` in to `bytes` of dynamic shared memory (above 48 KB).
// (once per kernel and process).
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes) {
  static int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  return err;
}

}  // namespace k1
}  // namespace lsnet
