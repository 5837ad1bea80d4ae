// Fused deformable row gather + corner weighting + grouped contraction.
//
//   out[p, n] = sum_k sum_{ch in group(n)} v[k, p, ch] * W[k, ch % Cg, n],
//   v[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//
//   flat (R, C) f32 or bf16 with group-major channels (C = G * Cg),
//   idx (nc, K, px) int32, w (nc, K, px) f32 with the DCNv2 mask folded
//   in, W (K, Cg, cout) the compact grouped weight in flat's dtype with
//   group-major cout (group(n) = n / outG, outG = cout / G), out (px, cout)
//   in flat's dtype; accumulation is f32. nc = 1 (nearest, the shipped
//   backbone default) or 4 (bilinear).
//
// Replaces the TPU kernel lsnet_tpu/ops/pallas_grouped.py
// (grouped_deform_contract / _gdc_fwd), which contracted an already
// gathered (px, K*C) patch tensor block-diagonally, and, on the JAX
// default route, the dense block-diagonal contraction of flat_deform.py
// (_blockdiag_weight), which pays G x the operations on zeros. Here the
// gather is fused into the contraction, as in deform_gather_contract.cu,
// so the patch tensor never reaches device memory.
//
// Bound on the H100: bytes, not operations. A c4 call (B=2, 50x84, C =
// cout = 1024, Cg = 16) needs about 35 MB of unique input and output
// (10.5 us at 3.35 TB/s) against 2.5 GFLOP of grouped products (2.5 us at
// the bf16 peak); but it reads every corner row through L2 once per tap
// (9 taps x 8400 px x 2 KB rows = 155 MB at nearest, 4x that bilinear),
// so what sets its pace is how many of those row loads are in flight and
// the SM's work on them, not the device memory's rate.
//
// bf16 design (gdc_bf16): one block of 4 warps per 64 px x 64 cout tile.
// The tile's columns cover the groups n0/outG .. (n0+64)/outG - 1 (outG
// divides 64), which read only the input channels [ch0, ch0 + S), S =
// 64/outG * Cg: 64 at every stage of X-101-64x4d (Cg == outG), so each
// cout tile gathers a disjoint channel slice. The work is cut into steps
// (tap k, slice s of SW = 64 channels, or 32 where S is not a multiple of
// 64); a corner row of a step is one 128-byte line, 8 x 16 bytes.
//  - The block's corner table (idx and w, all K taps) comes first, by
//    4-byte cp.async; pixels past px read row 0 with weight 0 (zero fill).
//  - A ring of STAGES = 2 steps in shared memory, filled by 16-byte
//    cp.async: the raw corner rows of the step (16-byte
//    chunks swizzled so that ldmatrix reads 8 rows without bank conflicts)
//    and the compact weight rows W[k, i, n0:n0+64] it needs (i over the Cg
//    rows of the groups, or the step's own rows where Cg > SW). While step
//    t is multiplied, the loads of steps t+1 .. t+STAGES-1 are in flight.
//    One cp.async group a step and one barrier a step: a slot is refilled
//    only after every warp is past the products that read it.
//  - Each warp owns 16 px x 64 cout. Its A fragments come by ldmatrix from
//    the raw rows of each corner and are weighted in registers, in f32
//    (sum over the nc corners of w x row), then rounded once to bf16. A
//    clipped index is read even when its weight is 0, so a NaN propagates
//    as in the reference.
//  - Products by mma.sync m16n8k16 (bf16, f32 accumulators), B by
//    ldmatrix.trans from the compact weight rows; the block-diagonal B is
//    never stored. Where Cg == outG is 8, 16 or 32 (every X-101 stage) the
//    column blocks each 16-deep step meets and the rows it reads are fixed
//    at compile time; otherwise they are found at run time, B's elements
//    of other groups set to 0 in registers and the 8-wide column blocks
//    that share no group with the step skipped.
//  - Epilogue: the bf16 outputs through the ring's memory, then 16-byte
//    stores of the rows below px.
// Split readings on an H100 80GB HBM3 (tools/bench_grouped.py --split):
// the kernel this one replaced ran a block's 18 rounds (gather, B tile
// from L2, barriers, WMMA) one after another, and no one part set its
// pace; here the loads are off that chain. A nearest X-101 forward takes
// 1.96 ms (parent 6.72): 53 % of that without the weighting and products,
// 67 % without the corner-row copies, 80 % without the A loads from the
// ring, 86 % without the weight rows, 96 % without the stores.
// The weight rows go through the ring, not into shared memory of their
// own once a block: at one slice a tile (every X-101 stage) a step copies
// its tap's rows once a block either way, and holding all K taps (10-41
// KB a block) lost: 9 % slower nearest (c5 34 %, 3 blocks an SM for 4),
// 12 % bilinear (c5 1 block for 2). 128-px blocks
// of 8 warps halve the weight rows per pixel and gain 6 % at c3 and c4
// nearest, but lose 19 % at c5 (fewer blocks than the card holds) and
// 13 % bilinear (one block an SM).
// The f32 route (gdc_f32, no main path runs it) keeps the earlier design:
// 32-channel chunks gathered by __ldg, the B tile built in shared memory
// per chunk, FMA products.
//
// Limits, checked by the Python wrapper: outG divides 64, cout % 64 == 0,
// S % 32 == 0 (bf16) or S % 16 == 0 (f32), 1 <= nc <= 4, every pointer
// 16-byte aligned and contiguous. The bf16 route's shared memory grows
// with nc x K; past the card's limit its launch fails (bf16_plan).

#include "async_mma.cuh"
#include "deform_tile.cuh"

namespace {

using namespace lsnet;

// ---------------------------------------------------------------- bf16
constexpr int PX = BM;          // pixels of a gdc_bf16 block
constexpr int GT = PX / 16 * 32;  // its threads: a warp per 16 px
constexpr int LDS = BN + 8;     // weight rows and output tile: 144 bytes
// steps the ring holds: a third gains nothing at nearest and halves the
// blocks an SM bilinear
constexpr int STAGES = 2;

// x / d for 0 <= x < 2^22, inv = 1.f / d: (x + 0.5) / d lies at least
// 0.5 / d from an integer, far more than the product's rounding
__device__ __forceinline__ int div_f(int x, float inv) {
  return static_cast<int>((static_cast<float>(x) + 0.5f) * inv);
}

// keep the low / high bf16 of a pair
__device__ __forceinline__ uint32_t keep2(uint32_t x, bool lo, bool hi) {
  return x & ((lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u));
}

// Shared memory (dynamic), in this order: the table (idx, then w; nc x K
// x PX each), STAGES slots of [corner rows nc x PX x SW, chunks swizzled |
// weight rows WR x LDS], at least the PX x LDS output tile that the
// epilogue stages there (Bf16Plan::smem).
template <int SW, int CG>
__global__ void __launch_bounds__(GT)
gdc_bf16(const __nv_bfloat16* __restrict__ flat, const int* __restrict__ idx,
         const float* __restrict__ w, const __nv_bfloat16* __restrict__ W,
         __nv_bfloat16* __restrict__ out, int C, int Cg, int outG, int nc,
         int K, int px, int cout, int WR) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VPR = SW / 8;                 // 16-byte vectors per row
  const int tbl = nc * K * PX;
  int* s_idx = reinterpret_cast<int*>(smem);
  float* s_w = reinterpret_cast<float*>(s_idx + tbl);
  const int rows_elems = nc * PX * SW;
  const int slot_elems = rows_elems + WR * LDS;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(s_w + tbl);

  const int p0 = blockIdx.x * PX;
  const int n0 = blockIdx.y * BN;
  const int ch0 = n0 / outG * Cg;             // first input channel
  const int S = BN / outG * Cg;               // channels of the tile
  const int NS = S / SW;                      // slices
  const int steps = K * NS;
  const bool per_row = Cg > SW;               // weight rows: one per channel
  const float inv_cg = 1.f / Cg;
  const float inv_og = 1.f / outG;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;                  // rows 16 warp .. 16 warp + 15

  for (int e = tid; e < tbl; e += GT) {       // e = (c K + k) PX + r
    const int r = e % PX;
    const int p = p0 + r;
    const bool ok = p < px;
    const size_t off = (size_t)(e / PX) * px + (ok ? p : 0);
    cp_async4(s_idx + e, idx + off, ok);
    cp_async4(s_w + e, w + off, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // step t's compact weight rows W[k, i, n0:n0+64] to dst: i over the Cg
  // rows of the groups, or the step's own SW rows where Cg > SW
  auto copy_w = [&](int t, __nv_bfloat16* dst) {
    const int k = t / NS;
    const int wbase = per_row ? (t - k * NS) * SW : 0;
    for (int v = tid; v < WR * (BN / 8); v += GT) {
      const int q = v / (BN / 8);
      const int j = v % (BN / 8);
      cp_async16(dst + q * LDS + j * 8,
                 W + ((size_t)k * Cg + (wbase + q) % Cg) * cout + n0 + j * 8);
    }
  };

  // One cp.async group: step t's corner rows and weight rows into slot
  // t % STAGES (an empty group past the last step keeps the count).
  auto issue = [&](int t) {
    if (t < steps) {
      const int k = t / NS;
      __nv_bfloat16* slot = ring + (t % STAGES) * slot_elems;
      const __nv_bfloat16* src = flat + ch0 + (t - k * NS) * SW;
      // v = (c PX + r) VPR + j: chunk j of corner c's row for pixel r
      for (int v = tid; v < nc * PX * VPR; v += GT) {
        const int cr = v / VPR;
        const int c = cr / PX;
        const int j = v % VPR;
        const int row = s_idx[(c * K + k) * PX + cr - c * PX];
        cp_async16(slot + cr * SW + swz<SW>(cr, j) * 8,
                   src + (size_t)row * C + j * 8);
      }
      copy_w(t, slot + rows_elems);
    }
    cp_async_commit();
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  const int g8 = lane >> 2;                   // fragment row / column
  const int t4 = lane & 3;
  for (int u = 0; u < STAGES - 1; ++u) issue(u);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();            // step t landed; slot (t - 1) % STAGES free
    issue(t + STAGES - 1);
    const int k = t / NS;
    const __nv_bfloat16* slot = ring + (t % STAGES) * slot_elems;

    // A fragments, weighted in registers: rows g8 and g8 + 8 of the warp's
    // 16, summed over the corners in f32 (w x row) and rounded once to bf16
    float wt[MAXNC][2];
#pragma unroll
    for (int c = 0; c < MAXNC; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wt[c][h] = c < nc ? s_w[(c * K + k) * PX + warp * 16 + g8 + 8 * h]
                          : 0.f;
    auto weighted_a = [&](int kk, uint32_t (&a)[4]) {
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
      const int row = warp * 16 + (lane & 15);
      const int j = kk / 8 + (lane >> 4);
#pragma unroll
      for (int c = 0; c < MAXNC; ++c) {
        if (c >= nc) break;
        uint32_t r[4];
        ldsm_x4(r, slot + (c * PX + row) * SW + swz<SW>(c * PX + row, j) * 8);
        // r[e]: row g8 (e even) or g8 + 8 (e odd), two channels
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[2 * e] += wt[c][e & 1] * __uint_as_float(r[e] << 16);
          f[2 * e + 1] += wt[c][e & 1] * __uint_as_float(r[e] & 0xffff0000u);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
        a[e] = *reinterpret_cast<const uint32_t*>(&h);
      }
    };

    // products: the warp's 16 px x 64 cout against the step's SW channels
    const __nv_bfloat16* wrow = slot + rows_elems;
    if constexpr (CG > 0) {
      // Cg == outG == CG, one 64-channel slice: B is block-diagonal in CG x
      // CG blocks, so which 8-wide column blocks a 16-deep step meets and
      // which staged rows it reads are known here
#pragma unroll
      for (int kk = 0; kk < SW; kk += 16) {
        uint32_t a[4];
        weighted_a(kk, a);
        if constexpr (CG == 8) {
          // rows kk .. kk+7 (group kk/8) meet column block kk/8 alone,
          // rows kk+8 .. kk+15 block kk/8 + 1: the other half of each B
          // fragment is 0
          uint32_t b[2];
          ldsm_x2_trans(b, wrow + (lane & 7) * LDS +
                               (kk / 8 + ((lane >> 3) & 1)) * 8);
          const uint32_t lo[2] = {b[0], 0u}, hi[2] = {0u, b[1]};
          mma16816(acc[kk / 8], a, lo);
          mma16816(acc[kk / 8 + 1], a, hi);
        } else {
          // rows kk .. kk+15 are rows kk % CG .. of group kk / CG, which
          // meets the CG / 8 column blocks from kk / CG x CG / 8
          constexpr int NB = CG / 8;
#pragma unroll
          for (int h = 0; h < NB; h += 2) {
            const int nb = kk / CG * NB + h;
            uint32_t b[4];
            ldsm_x4_trans(b, wrow + (kk % CG + (lane & 15)) * LDS +
                                 (nb + (lane >> 4)) * 8);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            mma16816(acc[nb], a, b0);
            mma16816(acc[nb + 1], a, b1);
          }
        }
      }
    } else {
      const int s = t - k * NS;
#pragma unroll
      for (int kk = 0; kk < SW; kk += 16) {
        const int r0 = s * SW + kk;           // tile channel of the step
        const int rg_lo = div_f(r0, inv_cg);
        const int rg_hi = div_f(r0 + 15, inv_cg);
        // 8-wide column blocks whose groups meet [rg_lo, rg_hi]
        const int nb_lo = rg_lo * outG / 8;
        const int nb_hi = ((rg_hi + 1) * outG - 1) / 8;
        uint32_t a[4];
        weighted_a(kk, a);
        // this lane's weight row for ldmatrix: channel r0 + (lane & 15)
        const int rc = r0 + (lane & 15);
        const int q = per_row ? kk + (lane & 15)
                              : rc - div_f(rc, inv_cg) * Cg;
        const __nv_bfloat16* brow = wrow + q * LDS;
        // groups of this thread's four B elements: channels r0 + 2 t4 +
        // {0, 1, 8, 9}
        const int e0 = r0 + 2 * t4;
        const int ge0 = div_f(e0, inv_cg), ge1 = div_f(e0 + 1, inv_cg);
        const int ge8 = div_f(e0 + 8, inv_cg), ge9 = div_f(e0 + 9, inv_cg);
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb) {
          if (nb < nb_lo || nb > nb_hi) continue;
          uint32_t b[2];
          ldsm_x2_trans(b, brow + nb * 8);
          const int cgp = div_f(nb * 8 + g8, inv_og);
          b[0] = keep2(b[0], ge0 == cgp, ge1 == cgp);
          b[1] = keep2(b[1], ge8 == cgp, ge9 == cgp);
          mma16816(acc[nb], a, b);
        }
      }
    }
  }

  // epilogue: once every warp is past its last products, each warp's 16
  // rows of bf16 outputs go through the ring's memory, then out in 16-byte
  // stores below px
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* Cs = ring + warp * 16 * LDS;
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    *reinterpret_cast<__nv_bfloat162*>(Cs + g8 * LDS + nb * 8 + 2 * t4) =
        __floats2bfloat162_rn(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<__nv_bfloat162*>(Cs + (g8 + 8) * LDS + nb * 8 +
                                       2 * t4) =
        __floats2bfloat162_rn(acc[nb][2], acc[nb][3]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * (BN / 8) / 32; ++it) {
    const int v = lane + it * 32;
    const int r = v / (BN / 8);
    const int j = v % (BN / 8);
    const int p = p0 + warp * 16 + r;
    if (p < px)
      *reinterpret_cast<uint4*>(out + (size_t)p * cout + n0 + j * 8) =
          *reinterpret_cast<const uint4*>(Cs + r * LDS + j * 8);
  }
}

// How gdc_bf16 cuts a call whose cout tile reads S = 64 / outG * Cg
// channels: sw channels a step (64, or 32 where S is no multiple of 64),
// wr weight rows a step (the Cg rows of the groups, or the step's own sw
// rows where Cg > sw), cg the group width its products know at compile
// time (Cg where Cg == outG is 8, 16 or 32, as at every X-101 stage; 0:
// the general products), and the bytes of its dynamic shared memory.
struct Bf16Plan {
  int sw, wr, cg;
  size_t smem;
};

Bf16Plan bf16_plan(int Cg, int outG, int nc, int K) {
  Bf16Plan p;
  const int S = BN / outG * Cg;
  p.sw = S % 64 == 0 ? 64 : 32;
  p.wr = Cg < p.sw ? Cg : p.sw;
  p.cg = Cg == outG && (Cg == 8 || Cg == 16 || Cg == 32) ? Cg : 0;
  const size_t ring = (size_t)STAGES * (nc * PX * p.sw + p.wr * LDS) * 2;
  const size_t out_tile = (size_t)PX * LDS * 2;
  p.smem = (size_t)nc * K * PX * 8 + (ring > out_tile ? ring : out_tile);
  return p;
}

// A table too large for a block's shared memory is refused here
// (cudaErrorInvalidValue), before any call that would leave an error behind.
template <int SW, int CG>
int launch_bf16(const void* flat, const void* idx, const void* w,
                const void* W, void* out, int C, int Cg, int outG, int nc,
                int K, int px, int cout, const Bf16Plan& p, cudaStream_t s) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.smem > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  e = cudaFuncSetAttribute(
      gdc_bf16<SW, CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((px + PX - 1) / PX, cout / BN);
  gdc_bf16<SW, CG><<<grid, GT, p.smem, s>>>(
      static_cast<const __nv_bfloat16*>(flat), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(W),
      static_cast<__nv_bfloat16*>(out), C, Cg, outG, nc, K, px, cout, p.wr);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- f32
__global__ void __launch_bounds__(256)
gdc_f32(const float* __restrict__ flat, const int* __restrict__ idx,
        const float* __restrict__ w, const float* __restrict__ W,
        float* __restrict__ out, int C, int Cg, int outG, int nc, int K,
        int px, int cout) {
  __shared__ __align__(16) float As[BK32][LDA32];    // channel-major
  __shared__ __align__(16) float Bs[BK32][BN + 4];
  __shared__ int s_idx[MAXNC * BM];
  __shared__ float s_w[MAXNC * BM];

  const int p0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ch0 = n0 / outG * Cg;
  const int S = BN / outG * Cg;
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
    for (int c0 = 0; c0 < S; c0 += BK32) {
      gather_tile_f32(flat, C, ch0 + c0, nc, s_idx, s_w, As);
      {  // B tile, block-diagonal: 16 rows x 64 columns = 256 float4
        const int r = threadIdx.x / 16;
        const int cv = (threadIdx.x % 16) * 4;
        const int c_g = (c0 + r) / Cg;
        const int c_in = c0 + r - c_g * Cg;
        const float4 f = __ldg(reinterpret_cast<const float4*>(
            W + ((size_t)k * Cg + c_in) * cout + n0 + cv));
        const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Bs[r][cv + e] = (cv + e) / outG == c_g ? v[e] : 0.f;
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

// C entry; the limits above, but for the bf16 route's shared memory, are
// checked by the Python wrapper. Launches on `stream`; returns the CUDA
// error of the launch (0 if none).
extern "C" int lsnet_grouped_deform_contract(const void* flat, const void* idx,
                                             const void* w, const void* W,
                                             void* out, int C, int Cg,
                                             int outG, int nc, int K, int px,
                                             int cout, int is_bf16,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const Bf16Plan p = bf16_plan(Cg, outG, nc, K);
#define GDC_BF16(SW_, CG_)                                                  \
  if (p.sw == SW_ && p.cg == CG_)                                           \
    return launch_bf16<SW_, CG_>(flat, idx, w, W, out, C, Cg, outG, nc, K,  \
                                 px, cout, p, s);
    GDC_BF16(64, 8) GDC_BF16(64, 16) GDC_BF16(64, 32)
    GDC_BF16(64, 0) GDC_BF16(32, 0)
#undef GDC_BF16
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((px + BM - 1) / BM, cout / BN);
  gdc_f32<<<grid, 256, 0, s>>>(
      static_cast<const float*>(flat), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const float*>(W),
      static_cast<float*>(out), C, Cg, outG, nc, K, px, cout);
  return static_cast<int>(cudaGetLastError());
}
