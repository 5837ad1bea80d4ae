// Backward of grouped_deform_contract.cu with respect to its compact
// weight (g(n) = n / outG):
//
//   d_W[k, i, n] = sum_p V[k, p, g(n) Cg + i] * dout[p, n],
//   V[k, p, :] = sum_c w[c, k, p] * flat[idx[c, k, p], :]
//
//   flat (R, C), dout (px, cout) f32 or bf16; idx, w (nc, K, px);
//   d_W (K, Cg, cout) f32, zeroed by the caller.
//
// Replaces the TPU kernel lsnet_tpu/ops/pallas_grouped.py `_make_dw_kernel`
// (the second pallas_call of `_gdc_bwd`) together with the einsum that
// pulls the block-diagonal entries back to the compact layout
// (pallas_grouped.py, end of `_gdc_bwd`): one kernel does both. The TPU
// kernel carries its sum from grid step to grid step; blocks on the card
// run in no order, so px is split over blocks and the partial sums are
// added into the zeroed f32 d_W with atomics (no second pass). Its
// ragged-tile masking is kept: rows past px are zero in both operands,
// and their corner rows are not read at all.
//
// Bound on the H100: bytes (input map, table and dout read once). What
// sets the pace is the L2: a c4 call reads every corner row once per tap,
// 9 taps x 4 corners x 8400 px x 2 KB = 619 MB bilinear, the same rows as
// the forward, plus dout once per block of taps.
//
// bf16 design (gdw_bf16), where Cg == outG is 8, 16 or 32 (every X-101
// stage): the forward's ring, transposed to a sum over pixels. A block of
// 4 warps owns one 64-wide cout tile, whose columns read the 64-channel
// slice [n0, n0 + 64) alone, a group of TAPS taps and a share of the 64-px
// tiles; its steps are (px tile, tap).
//  - The corner table of a step (idx and w, nc x 64) comes by 4-byte
//    cp.async one group ahead of the step's rows, since their addresses
//    are read from it.
//  - A ring of STAGES steps in shared memory, filled by 16-byte cp.async:
//    the nc raw corner rows of 64 px (a row of the slice is one 128-byte
//    line, its 16-byte chunks swizzled for ldmatrix) and, with the first
//    tap of a px tile, its 64 px x 64 cout dout tile, which then serves all
//    TAPS taps. While step t is multiplied, the loads of step t + 1 are in
//    flight. One cp.async group and one barrier a step: a slot is refilled
//    only after every warp is past the products that read it. Pixels past
//    px are zero-filled in both (no byte read): a NaN in row 0 cannot
//    reach the sum, where the plain version has no such pixel.
//  - Warp w owns channels [16 w, 16 w + 16) and only the columns of their
//    groups, fixed at compile time: Cg 16 columns [16 w, 16 w + 16) (2 n8
//    tiles), Cg 32 the 32 columns of its group (4 n8 tiles), Cg 8 columns
//    [16 w, 16 w + 16), where each m16n8 product keeps the 8 rows of its
//    own group (half of it dead, against 7/8 in a full 64 x 64 product).
//  - A = V^T by ldmatrix.trans from the raw corner rows: the two bf16 of
//    one A register are two adjacent pixels, so each is weighted by its
//    own corner weight, summed over the corners in f32 and rounded once to
//    bf16. A clipped corner (weight 0) of a live pixel is read and
//    multiplied, so a NaN there propagates as in the plain version.
//    B = dout by ldmatrix.trans. Products by mma.sync m16n8k16, f32
//    accumulators in registers, TAPS x 2 or 4 n8 tiles a warp.
//  - Epilogue: each warp adds its accumulators straight into d_W[k, ch %
//    Cg, n] with 8-byte f32 atomics (no 64 x 64 tile in shared memory).
// The host chooses the px shares (ops/grouped.py, gdw_px_splits) so that
// two blocks an SM fill the card on every stage.
//
// Every other shape, and the f32 route (no main path runs it; the exact
// route for checks), keep the generic kernel (deform_bwd.cuh,
// bwd_weight_kernel<GROUPED>): block (y, z) owns cout tile y, tap z /
// nsplit and a share of the px tiles; the full 64 x 64 product is taken and
// only the entries whose row and column share a group are added.

#include "async_mma.cuh"
#include "deform_bwd.cuh"

namespace {

using namespace lsnet;

constexpr int GW = 128;           // threads: 4 warps of 16 channels
constexpr int PXT = BM;           // pixels of a step
constexpr int TAPS = 3;           // taps a block; a dout tile serves them all
constexpr int STAGES = 2;         // steps of the ring
// corner tables held at once: step v's table comes with group v - STAGES
// + 1, issued at step v - 2 (STAGES - 1), and is read until step v
constexpr int TSLOTS = 2 * STAGES - 1;
constexpr int TILE = PXT * BN;    // elements of a 64 x 64 bf16 tile (8 KB)

// Dynamic shared memory of gdw_bf16: STAGES ring slots of nc corner-row
// tiles, STAGES dout tiles, TSLOTS tables of [idx nc x 64 | w nc x 64].
size_t gdw_smem(int nc) {
  return (size_t)STAGES * (nc + 1) * TILE * 2 + (size_t)TSLOTS * nc * PXT * 8;
}

// 8-byte f32 atomic where the toolkit has it (sm_90, CUDA 12.1 on)
__device__ __forceinline__ void atomic_add2(float* p, float x, float y) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 &&   \
    (__CUDACC_VER_MAJOR__ > 12 ||                       \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
#else
  atomicAdd(p, x);
  atomicAdd(p + 1, y);
#endif
}

template <int CG>
__global__ void __launch_bounds__(GW)
gdw_bf16(const __nv_bfloat16* __restrict__ flat, const int* __restrict__ idx,
         const float* __restrict__ w, const __nv_bfloat16* __restrict__ dout,
         float* __restrict__ dW, int C, int nc, int K, int px, int cout,
         int nsplit) {
  constexpr int NT = CG == 32 ? 4 : 2;        // n8 column tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dtile = ring + STAGES * nc * TILE;
  int* tables = reinterpret_cast<int*>(dtile + STAGES * TILE);
  const int tbl = 2 * nc * PXT;

  const int n0 = blockIdx.x * BN;             // also the slice's channel 0
  const int k0 = blockIdx.y * TAPS;
  const int nt = min(TAPS, K - k0);
  const int ntile = (px + PXT - 1) / PXT;
  const int per = (ntile + nsplit - 1) / nsplit;
  const int j0 = blockIdx.z * per;
  const int nj = min(ntile, j0 + per) - j0;   // px tiles of the block
  if (nj <= 0) return;
  const int steps = nj * TAPS;                // step v: tile v / TAPS, tap
  const int tid = threadIdx.x;                //   v % TAPS (none past nt)
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // step v's corner table into slot v % TSLOTS; pixels past px: row 0,
  // weight 0
  auto copy_table = [&](int v) {
    if (v >= steps || v % TAPS >= nt) return;
    const int k = k0 + v % TAPS;
    const int p0 = (j0 + v / TAPS) * PXT;
    int* s_idx = tables + (v % TSLOTS) * tbl;
    float* s_w = reinterpret_cast<float*>(s_idx + nc * PXT);
    for (int e = tid; e < nc * PXT; e += GW) {  // e = c PXT + r
      const int p = p0 + e % PXT;
      const bool ok = p < px;
      const size_t off = ((size_t)(e / PXT) * K + k) * px + (ok ? p : 0);
      cp_async4(s_idx + e, idx + off, ok);
      cp_async4(s_w + e, w + off, ok);
    }
  };

  // One cp.async group: step v's corner rows into slot v % STAGES, the
  // dout tile of its pixels where v is the tile's first tap, and the table
  // of step v + STAGES - 1 (an empty group past the last step keeps the
  // count).
  auto issue = [&](int v) {
    if (v < steps) {
      const int j = v / TAPS;
      const int p0 = (j0 + j) * PXT;
      if (v % TAPS < nt) {
        const int* s_idx = tables + (v % TSLOTS) * tbl;
        __nv_bfloat16* slot = ring + (v % STAGES) * nc * TILE;
        // q = (c PXT + r) 8 + chunk: chunk of corner c's row for pixel r
        for (int q = tid; q < nc * PXT * 8; q += GW) {
          const int cr = q >> 3;
          const int ch = q & 7;
          cp_async16z(slot + cr * BN + swz<64>(cr, ch) * 8,
                      flat + (size_t)s_idx[cr] * C + n0 + ch * 8,
                      p0 + cr % PXT < px);
        }
      }
      if (v % TAPS == 0) {
        __nv_bfloat16* dst = dtile + (j % STAGES) * TILE;
        for (int q = tid; q < PXT * 8; q += GW) {
          const int r = q >> 3;
          const int ch = q & 7;
          const bool ok = p0 + r < px;
          cp_async16z(dst + r * BN + swz<64>(r, ch) * 8,
                      dout + (size_t)(ok ? p0 + r : 0) * cout + n0 + ch * 8,
                      ok);
        }
      }
    }
    copy_table(v + STAGES - 1);
    cp_async_commit();
  };

  float acc[TAPS][NT][4];
#pragma unroll
  for (int tau = 0; tau < TAPS; ++tau)
#pragma unroll
    for (int h = 0; h < NT; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tau][h][e] = 0.f;

  for (int u = 0; u < STAGES - 1; ++u) copy_table(u);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int u = 0; u < STAGES - 1; ++u) issue(u);

  const int g8 = lane >> 2;                   // fragment row / column
  const int t4 = lane & 3;
  // this lane's ldmatrix row: A matrices (px 0-7 | 8-15) x (the warp's two
  // 8-channel chunks), B matrices (px 0-7 | 8-15) x (two n8 tiles)
  const int ra = (lane & 7) + ((lane >> 4) << 3);
  const int ja = 2 * warp + ((lane >> 3) & 1);
  const int rb = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int cb = CG == 32 ? (warp >> 1) * 32 : warp * 16;  // first column
  for (int j = 0; j < nj; ++j) {
#pragma unroll
    for (int tau = 0; tau < TAPS; ++tau) {
      const int u = j * TAPS + tau;
      cp_async_wait<STAGES - 2>();
      __syncthreads();          // step u landed; slot (u - 1) % STAGES free
      issue(u + STAGES - 1);
      if (tau >= nt) continue;
      const __nv_bfloat16* slot = ring + (u % STAGES) * nc * TILE;
      const float* s_w =
          reinterpret_cast<const float*>(tables + (u % TSLOTS) * tbl) +
          nc * PXT;
      const __nv_bfloat16* dt = dtile + (j % STAGES) * TILE;
#pragma unroll
      for (int kc = 0; kc < PXT / 16; ++kc) {
        // A = V^T for the warp's 16 channels x 16 px: r[e] holds one
        // channel at pixels 2 t4, 2 t4 + 1 (e < 2) or 2 t4 + 8, + 9 (e >= 2),
        // low and high half; each pixel takes its own corner weight
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = 0.f;
#pragma unroll
        for (int c = 0; c < MAXNC; ++c) {
          if (c >= nc) break;
          const float* wc = s_w + c * PXT + kc * 16 + 2 * t4;
          const float2 wlo = *reinterpret_cast<const float2*>(wc);
          const float2 whi = *reinterpret_cast<const float2*>(wc + 8);
          const int cr = c * PXT + kc * 16 + ra;
          uint32_t r[4];
          ldsm_x4_trans(r, slot + cr * BN + swz<64>(cr, ja) * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 wt = e < 2 ? wlo : whi;
            f[2 * e] += wt.x * __uint_as_float(r[e] << 16);
            f[2 * e + 1] += wt.y * __uint_as_float(r[e] & 0xffff0000u);
          }
        }
        uint32_t a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h2 =
              __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
          a[e] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        // B = dout, 16 px x the warp's columns, two n8 tiles a load
        const int pb = kc * 16 + rb;
#pragma unroll
        for (int h = 0; h < NT; h += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, dt + pb * BN +
                               swz<64>(pb, cb / 8 + h + (lane >> 4)) * 8);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma16816(acc[tau][h], a, b0);
          mma16816(acc[tau][h + 1], a, b1);
        }
      }
    }
  }

  // epilogue: accumulator (row g8 | g8 + 8, columns 2 t4, 2 t4 + 1) of n8
  // tile h is d_W[k, i, n0 + cb + 8 h + 2 t4 ..], i the row's channel % Cg
  cp_async_wait<0>();
#pragma unroll
  for (int tau = 0; tau < TAPS; ++tau) {
    if (tau >= nt) break;
    float* dk = dW + (size_t)(k0 + tau) * CG * cout + n0 + cb + 2 * t4;
#pragma unroll
    for (int h = 0; h < NT; ++h) {
      if constexpr (CG == 8) {
        // tile 0 keeps the rows of group 2 w (g8), tile 1 those of group
        // 2 w + 1 (g8 + 8): row g8 of its own group either way
        atomic_add2(dk + (size_t)g8 * cout + 8 * h, acc[tau][h][2 * h],
                    acc[tau][h][2 * h + 1]);
      } else {
        const int i = warp * 16 % CG + g8;
        atomic_add2(dk + (size_t)i * cout + 8 * h, acc[tau][h][0],
                    acc[tau][h][1]);
        atomic_add2(dk + (size_t)(i + 8) * cout + 8 * h, acc[tau][h][2],
                    acc[tau][h][3]);
      }
    }
  }
}

template <int CG>
int launch_gdw(const void* flat, const void* idx, const void* w,
               const void* dout, void* dW, int C, int nc, int K, int px,
               int cout, int nsplit, cudaStream_t s) {
  const size_t smem = gdw_smem(nc);
  cudaError_t e = cudaFuncSetAttribute(
      gdw_bf16<CG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(cout / BN, (K + TAPS - 1) / TAPS, nsplit);
  gdw_bf16<CG><<<grid, GW, smem, s>>>(
      static_cast<const __nv_bfloat16*>(flat), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(dW), C, nc, K, px, cout, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry; limits as for the grouped bwd-data entry (Cg == outG, checked
// by the Python wrapper). bf16 with Cg == outG in {8, 16, 32} launches
// gdw_bf16, nsplit px shares (ops/grouped.py, gdw_px_splits); everything
// else the generic kernel. Launches on `stream`; returns the launch's CUDA
// error (0 if none).
extern "C" int lsnet_grouped_deform_contract_bwd_weight(
    const void* flat, const void* idx, const void* w, const void* dout,
    void* dW, int C, int Cg, int outG, int nc, int K, int px, int cout,
    int nsplit, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && Cg == outG) {
    switch (Cg) {
      case 8:
        return launch_gdw<8>(flat, idx, w, dout, dW, C, nc, K, px, cout,
                             nsplit, s);
      case 16:
        return launch_gdw<16>(flat, idx, w, dout, dW, C, nc, K, px, cout,
                              nsplit, s);
      case 32:
        return launch_gdw<32>(flat, idx, w, dout, dW, C, nc, K, px, cout,
                              nsplit, s);
    }
  }
  return lsnet::launch_bwd_weight<true>(flat, idx, w, dout, dW, C, Cg, outG,
                                        nc, K, px, cout, nsplit, is_bf16,
                                        stream);
}
