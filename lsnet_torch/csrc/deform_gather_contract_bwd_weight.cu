// Backward of deform_gather_contract.cu with respect to its weight:
//
//   d_W[k] = sum_p V[k, p, :]^T dout[p, :],
//   V[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//
//   flat (R, C), dout (px, cout) f32 or bf16; idx, w (nc, K, px);
//   d_W (K, C, cout) f32, zeroed by the caller.
//
// Replaces what the JAX package leaves to XLA: the `dwstk` part of the
// backward of the TPU kernel lsnet_tpu/ops/pallas_dma_gather.py
// (dma_quad_contract, `_bwd` = jax.vjp of the plain gather + einsum),
// which gathers the (K, px, C) patch tensor into device memory again.
// Here the gather is fused into the operand load, as in the forward.
//
// Bound on the H100: the forward's product once more (52.8 GFLOP for a
// 44,800-px tower call) against the same gathered corner rows, mostly from
// L2: one gather pass sets the time. The bf16 route (bwd_weight_kernel_wgmma,
// device code in k1_wgmma.cuh) gathers V once per call: block (x, y, z)
// owns channels 128 x .. 128 x + 127 (warpgroup g the 64 from 128 x + 64 g)
// and output columns 256 y .., tap z / nsplit and every nsplit-th share of
// the 64-px tiles, and reads dout (C / 128) x K times by TMA. Chunk i is
// the share's i-th px tile: A = the gathered V tile (px rows of channels,
// the MN-major transposed operand), B = the dout tile (px rows of cout,
// MN-major), wgmma m64n256k16 into f32 registers, three stages deep, the
// next tile gathered under the current product. The sum runs over pixels
// and blocks run in no order, so each block adds its 128 x 256 partial sum
// into the zeroed f32 d_W with vector atomics (red.global.add.v4.f32); the
// sum's order, and its last bits, change from run to run. The wrapper
// picks the split (ops/deform_gather.py, px_splits). The design it replaces
// took 64 x 64 tiles of d_W (V gathered once per 64 output columns, dout
// read 36 times) with synchronous, element-by-element staging for WMMA.
// The f32 route keeps that body (deform_bwd.cuh, bwd_weight_kernel<float,
// false>) for exact checks.

#include "deform_bwd.cuh"
#include "k1_wgmma.cuh"

namespace {

using namespace lsnet;

__global__ void __launch_bounds__(k1::THREADS, 1)
bwd_weight_kernel_wgmma(const __nv_bfloat16* __restrict__ flat,
                        const int* __restrict__ idx,
                        const float* __restrict__ w, float* __restrict__ dW,
                        int C, int nc, int K, int px, int cout, int nsplit,
                        const __grid_constant__ CUtensorMap dmap) {
  using namespace k1;
  constexpr int TBL_ROWS = CHUNK;
  using L = Layout<TBL_ROWS>;
  using Tbl = Table<TBL_ROWS>;
  extern __shared__ uint8_t smem_raw[];
  const int ch0 = blockIdx.x * (WGS * ROWS);
  const int n0 = blockIdx.y * NT;
  const int k = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int ntile = (px + CHUNK - 1) / CHUNK;
  const int per = (ntile + nsplit - 1) / nsplit;
  const int t_lo = split * per;
  const int n = min(ntile, t_lo + per) - t_lo;
  if (n <= 0) return;

  uint8_t* sm = smem_base(smem_raw);
  const uint32_t s0 = smem_u32(sm);
  uint32_t* tbl = reinterpret_cast<uint32_t*>(sm + L::TBL_OFF);
  const uint32_t bar0 = s0 + L::BAR_OFF;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int boxes = min(NT / BOX, (cout - n0 + BOX - 1) / BOX);

#define LSNET_P0(i) ((t_lo + (i)) * CHUNK)
#define LSNET_LOAD_B(i, stage)                                           \
  do {                                                                    \
    const uint32_t bar_ = bar0 + 8 * (stage);                             \
    mbar_expect(bar_, boxes * BOX_BYTES);                                 \
    for (int q = 0; q < boxes; ++q)                                       \
      tma_2d(s0 + L::B_OFF + (stage) * B_STAGE + q * BOX_BYTES, &dmap,    \
             bar_, n0 + q * BOX, LSNET_P0(i));                            \
  } while (0)
#define LSNET_GATHER(i)                                                   \
  gather_tile(flat, C, nc, tbl + ((i) & 1) * Tbl::WORDS, TBL_ROWS, 0,     \
              px - LSNET_P0(i), ch0 + ROWS * wg,                          \
              sm + L::A_OFF + ((i) % STAGES) * A_STAGE + wg * A_BYTES)

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    Tbl t;
    t.load(idx, w, nc, K, px, k, LSNET_P0(0));
    t.store(tbl);
    if (n > 1) {
      t.load(idx, w, nc, K, px, k, LSNET_P0(1));
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
    chunk_product<true>(acc, s0 + L::A_OFF + s * A_STAGE + wg * A_BYTES,
                        s0 + L::B_OFF + s * B_STAGE);
    // under the product: the next tile's A and the corner table of the
    // tile after it
    Tbl t;
    if (i + 2 < n) t.load(idx, w, nc, K, px, k, LSNET_P0(i + 2));
    if (i + 1 < n) LSNET_GATHER(i + 1);
    if (i + 2 < n) t.store(tbl + (i & 1) * Tbl::WORDS);
    wgmma_wait_all();
    pin(acc);
    fence_async_smem();
    __syncthreads();
    if (tid == 0 && i + STAGES < n) LSNET_LOAD_B(i + STAGES, s);
  }
#undef LSNET_P0
#undef LSNET_LOAD_B
#undef LSNET_GATHER

  // epilogue: the f32 partial sum through the (now idle) B and A stages,
  // then one 16-byte atomic add per 4 columns
  constexpr int LD = EPI_LD;
  float* cs = reinterpret_cast<float*>(sm + L::B_OFF);
#pragma unroll
  for (int j = 0; j < 128; j += 2)
    *reinterpret_cast<float2*>(cs + (ROWS * wg + acc_row(j)) * LD +
                               acc_col(j)) = make_float2(acc[j], acc[j + 1]);
  __syncthreads();
  for (int e = tid; e < WGS * ROWS * (NT / 4); e += THREADS) {
    const int r = e / (NT / 4);
    const int col = (e % (NT / 4)) * 4;
    const int ch = ch0 + r;
    const int nn = n0 + col;
    if (ch < C && nn < cout)
      atomicAdd(reinterpret_cast<float4*>(dW + ((size_t)k * C + ch) * cout +
                                          nn),
                *reinterpret_cast<const float4*>(cs + r * LD + col));
  }
}

// the f32 epilogue tile fits in the B and A stages
static_assert(k1::WGS * k1::ROWS * k1::EPI_LD * 4 <=
                  k1::Layout<k1::CHUNK>::TBL_OFF,
              "epilogue tile");

}  // namespace

// C entry; shapes as for the forward, checked by the Python wrapper. The
// bf16 route takes ceil(C / 128) x ceil(cout / 256) x K * nsplit blocks,
// the f32 route the 64 x 64 tiles of bwd_weight_kernel. Launches on
// `stream`; returns the error of the tensor map or of the shared-memory
// opt-in, or cudaGetLastError().
extern "C" int lsnet_deform_gather_contract_bwd_weight(
    const void* flat, const void* idx, const void* w, const void* dout,
    void* dW, int C, int nc, int K, int px, int cout, int nsplit, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    using lsnet::BN;
    const dim3 grid((C + BN - 1) / BN, (cout + BN - 1) / BN, K * nsplit);
    lsnet::bwd_weight_kernel<float, false>
        <<<grid, lsnet::Mma<float>::THREADS, 0, s>>>(
            static_cast<const float*>(flat), static_cast<const int*>(idx),
            static_cast<const float*>(w), static_cast<const float*>(dout),
            static_cast<float*>(dW), C, 1, 1, nc, K, px, cout, nsplit);
    return static_cast<int>(cudaGetLastError());
  }
  using namespace lsnet::k1;
  constexpr int SMEM = Layout<CHUNK>::ALLOC;
  CUtensorMap dmap;
  const cuuint64_t dims[2] = {(cuuint64_t)cout, (cuuint64_t)px};
  const cuuint64_t strides[1] = {(cuuint64_t)cout * 2};
  int err = bf16_map(&dmap, dout, 2, dims, strides);
  if (err == 0) err = allow_smem(bwd_weight_kernel_wgmma, SMEM);
  if (err != 0) return err;
  const dim3 grid((C + WGS * ROWS - 1) / (WGS * ROWS), (cout + NT - 1) / NT,
                  K * nsplit);
  bwd_weight_kernel_wgmma<<<grid, THREADS, SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(flat), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<float*>(dW), C, nc, K, px,
      cout, nsplit, dmap);
  return static_cast<int>(cudaGetLastError());
}
