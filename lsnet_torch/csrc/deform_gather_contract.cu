// Fused deformable row gather + corner weighting + per-tap contraction.
//
//   out[p, :] = sum_k sum_c w[c, k, p] * flat[idx[c, k, p], :] @ W[k]
//
//   flat (R, C) f32 or bf16, idx (nc, K, px) int32, w (nc, K, px) f32 with
//   the DCNv2 mask folded in, W (K, C, cout) in flat's dtype,
//   out (px, cout) in flat's dtype; accumulation is f32.
//   nc = 4 (bilinear corners) or 1 (nearest).
//
// Replaces the TPU kernel lsnet_tpu/ops/pallas_dma_gather.py
// (dma_quad_contract / _dma_quad_contract_impl), whose job was to keep the
// (K, px, C) patch tensor out of device memory. The same holds here: the
// weighted corner rows are built in shared memory a chunk at a time and go
// straight into the contraction. Like the TPU kernel, whose output block is
// (TPX, cout), a block here owns all of cout (up to 256).
//
// Bound on the H100: at the head's shapes (K=9, C=cout=256) the product is
// 2*K*C*cout = 1.18 MFLOP per output pixel, 52.8 GFLOP for a 44,800-px
// tower call (0.05 ms at the bf16 peak); the corner rows it gathers, 4 x 9
// x 512 B a pixel (826 MB), come mostly from L2 and set the time of a
// design that reads them once. The bf16 route (dgc_bf16_wgmma, device code
// in k1_wgmma.cuh) therefore gathers every corner row once for all 256
// output columns (a block of 128 px x 256 cout, two warpgroups of 64 px),
// contracts on the tensor cores with wgmma m64n256k16 (f32 accumulators in
// registers), brings W's chunks in by TMA three stages deep and gathers the
// next chunk while the current product runs. The earlier design it replaces
// took a 64 x 64 output tile per block (the gather redone for each of the
// four cout tiles) and staged each 32-deep chunk synchronously for WMMA.
// The f32 route, which exists for exact checks, keeps that tile and uses
// f32 FMA; its gather and epilogue live in deform_tile.cuh, shared with the
// grouped kernel.

#include "deform_tile.cuh"
#include "k1_wgmma.cuh"

namespace {

using namespace lsnet;

// ---------------------------------------------------------------- bf16
// Block (x, y): pixels 128 x .. 128 x + 127 (warpgroup g the 64 from
// 128 x + 64 g), output columns 256 y .. 256 y + 255. Chunk i is tap
// i / nch, channels 64 (i % nch) ..; B comes from the (cout, C, K) tensor
// map of W in 64 x 64 boxes (boxes past cout are not loaded: their columns
// are not written out).
__global__ void __launch_bounds__(k1::THREADS, 1)
dgc_bf16_wgmma(const __nv_bfloat16* __restrict__ flat,
               const int* __restrict__ idx, const float* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int C, int nc, int K, int px,
               int cout, const __grid_constant__ CUtensorMap wmap) {
  using namespace k1;
  constexpr int TBL_ROWS = WGS * ROWS;
  using L = Layout<TBL_ROWS>;
  using Tbl = Table<TBL_ROWS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_base(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  uint32_t* tbl = reinterpret_cast<uint32_t*>(sm + L::TBL_OFF);
  const uint32_t bar0 = s0 + L::BAR_OFF;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int p0 = blockIdx.x * TBL_ROWS;
  const int n0 = blockIdx.y * NT;
  const int nch = (C + CHUNK - 1) / CHUNK;
  const int n = K * nch;
  const int boxes = min(NT / BOX, (cout - n0 + BOX - 1) / BOX);

#define LSNET_LOAD_B(i, stage)                                           \
  do {                                                                    \
    const uint32_t bar_ = bar0 + 8 * (stage);                             \
    mbar_expect(bar_, boxes * BOX_BYTES);                                 \
    for (int q = 0; q < boxes; ++q)                                       \
      tma_3d(s0 + L::B_OFF + (stage) * B_STAGE + q * BOX_BYTES, &wmap,    \
             bar_, n0 + q * BOX, ((i) % nch) * CHUNK, (i) / nch);         \
  } while (0)
#define LSNET_GATHER(i)                                                   \
  gather_tile(flat, C, nc, tbl + (((i) / nch) & 1) * Tbl::WORDS,          \
              TBL_ROWS, ROWS * wg, ROWS, ((i) % nch) * CHUNK,             \
              sm + L::A_OFF + ((i) % STAGES) * A_STAGE + wg * A_BYTES)

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    Tbl t;
    t.load(idx, w, nc, K, px, 0, p0);
    t.store(tbl);
    if (nch == 1 && K > 1) {
      t.load(idx, w, nc, K, px, 1, p0);
      t.store(tbl + Tbl::WORDS);
    }
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < min(STAGES, n); ++s) LSNET_LOAD_B(s, s);
  LSNET_GATHER(0);
  fence_async_smem();
  __syncthreads();

  float acc[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    mbar_wait(bar0 + 8 * s, (i / STAGES) & 1);
    chunk_product<false>(acc, s0 + L::A_OFF + s * A_STAGE + wg * A_BYTES,
                         s0 + L::B_OFF + s * B_STAGE);
    // under the product: the next chunk's A tile and, when chunk i + 2
    // starts a tap, that tap's corner table
    const bool next_tap = i + 2 < n && (i + 2) % nch == 0;
    Tbl t;
    if (next_tap) t.load(idx, w, nc, K, px, (i + 2) / nch, p0);
    if (i + 1 < n) LSNET_GATHER(i + 1);
    if (next_tap) t.store(tbl + (((i + 2) / nch) & 1) * Tbl::WORDS);
    wgmma_wait_all();
    pin(acc);
    fence_async_smem();
    __syncthreads();
    if (tid == 0 && i + STAGES < n) LSNET_LOAD_B(i + STAGES, s);
  }
#undef LSNET_LOAD_B
#undef LSNET_GATHER

  // epilogue: bf16 tile through the (now idle) B stages, 16-byte stores
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(sm + L::B_OFF);
#pragma unroll
  for (int j = 0; j < 128; j += 2)
    *reinterpret_cast<__nv_bfloat162*>(
        cs + (ROWS * wg + acc_row(j)) * EPI_LD + acc_col(j)) =
        __floats2bfloat162_rn(acc[j], acc[j + 1]);
  __syncthreads();
  for (int e = tid; e < TBL_ROWS * (NT / 8); e += THREADS) {
    const int r = e / (NT / 8);
    const int col = (e % (NT / 8)) * 8;
    const int p = p0 + r;
    const int nn = n0 + col;
    if (p < px && nn < cout)
      *reinterpret_cast<uint4*>(out + (size_t)p * cout + nn) =
          *reinterpret_cast<const uint4*>(cs + r * EPI_LD + col);
  }
}

// the bf16 epilogue tile fits in the B stages
static_assert(k1::WGS * k1::ROWS * k1::EPI_LD * 2 <=
                  k1::Layout<k1::WGS * k1::ROWS>::A_OFF,
              "epilogue tile");

// ---------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
dgc_f32(const float* __restrict__ flat, const int* __restrict__ idx,
        const float* __restrict__ w, const float* __restrict__ W,
        float* __restrict__ out, int C, int nc, int K, int px, int cout) {
  __shared__ __align__(16) float As[BK32][LDA32];    // channel-major
  __shared__ __align__(16) float Bs[BK32][BN + 4];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];

  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;            // 4 output channels each
  const int ty = threadIdx.x / 16;            // 4 pixels each
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();
    load_taps(idx, w, nc, K, px, k, p0, s_idx, s_w);
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += BK32) {
      gather_tile_f32(flat, C, c0, nc, s_idx, s_w, As);
      {  // B tile: 16 rows x 64 columns = 256 float4
        const int r = threadIdx.x / 16;
        const int cv = (threadIdx.x % 16) * 4;
        const int n = n0 + cv;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < cout)
          val = __ldg(reinterpret_cast<const float4*>(
              W + ((size_t)k * C + c0 + r) * cout + n));
        *reinterpret_cast<float4*>(&Bs[r][cv]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK32; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  store_tile_f32(acc, ty, tx, p0, n0, px, cout, out);
}

}  // namespace

// C entry. Shapes are checked by the Python wrapper: C % 32 == 0 (bf16) or
// C % 16 == 0 (f32), cout % 8 == 0, 1 <= nc <= 4, every pointer 16-byte
// aligned and contiguous. Launches on `stream`; returns the error of the
// tensor map or of the shared-memory opt-in, or cudaGetLastError().
extern "C" int lsnet_deform_gather_contract(const void* flat, const void* idx,
                                            const void* w, const void* W,
                                            void* out, int C, int nc, int K,
                                            int px, int cout, int is_bf16,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using namespace k1;
    constexpr int SMEM = Layout<WGS * ROWS>::ALLOC;
    CUtensorMap wmap;
    const cuuint64_t dims[3] = {(cuuint64_t)cout, (cuuint64_t)C,
                                (cuuint64_t)K};
    const cuuint64_t strides[2] = {(cuuint64_t)cout * 2,
                                   (cuuint64_t)C * cout * 2};
    int err = bf16_map(&wmap, W, 3, dims, strides);
    if (err == 0) err = allow_smem(dgc_bf16_wgmma, SMEM);
    if (err != 0) return err;
    const dim3 grid((px + WGS * ROWS - 1) / (WGS * ROWS), (cout + NT - 1) / NT);
    dgc_bf16_wgmma<<<grid, THREADS, SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out), C, nc,
        K, px, cout, wmap);
  } else {
    const dim3 grid((px + BM - 1) / BM, (cout + BN - 1) / BN);
    dgc_f32<<<grid, 256, 0, s>>>(
        static_cast<const float*>(flat), static_cast<const int*>(idx),
        static_cast<const float*>(w), static_cast<const float*>(W),
        static_cast<float*>(out), C, nc, K, px, cout);
  }
  return static_cast<int>(cudaGetLastError());
}
