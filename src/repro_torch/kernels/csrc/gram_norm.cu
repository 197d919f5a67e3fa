// Per-example ghost norms, alone (repro_gram_norm), fused with the
// weighted contribution (repro_gram_norm_fused) and for an embedding
// gather (repro_gram_norm_tokmask, last), as hand-written kernels for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram_norm.py : gram_norm
//           (Pallas body _gram_kernel), and gram_norm_fused
//           (Pallas body _gram_fused_kernel).
//
//   n[b] = ||dy_b^T x_b||_F^2        [+ ||sum_t dy_bt||^2   with a bias]
//        = sum_{t, t'} (x_bt . x_bt') (dy_bt . dy_bt') [+ ...]
//   c    = sum_b w_b x_b^T dy_b      (Di x Do, row-major; fused only)
//   cb   = sum_b w_b sum_t dy_bt     (Do; zeros without a bias; fused only)
//
// x is (B, T, Di) and dy (B, T, Do), f32 or bf16, each read through its
// own three strides with 64-bit offsets, so the transposed im2col view of
// a conv layer, (B, C K, T) seen as (B, T, C K), is read in place; w is
// (B,) f32.  The per-example gradient never reaches device memory.
//
// What bounds it on this card: operations, except at T = 1.  The norm
// needs the cheaper of two contractions per example: the per-example
// product x_b^T dy_b (2 T Di Do FLOP) or the Gram pair x_b x_b^T,
// dy_b dy_b^T over the token pairs t <= t' (T (T + 1) (Di + Do) FLOP).
// At AlexNet's conv0 (T = 3969, Di = 363, Do = 64) the product is 37x
// cheaper; at conv2-4 (T = 225) the symmetric Gram is 1.5-3x cheaper.
// At T = 1 (the fc layers) the norm is rank-1, ||x_b||^2 ||dy_b||^2, and
// bytes bound it.  The fused outputs need the product itself.
//
// What the design does about it.  ops.gram_route picks the route per call
// (route below: 0 rank-1, 1 direct product, 2 symmetric Gram):
//   * the per-example product core (direct_kernel, direct_wgmma_kernel):
//     one block of 256 threads per 128 x 64 tile of x_b^T dy_b (Di rows,
//     Do columns) and z-slice, walking t in stages (a last, partial stage
//     multiplies only its rows).  A z-slice is one
//     example and one chunk of T for the norm (T is cut into S chunks
//     where the tiles alone would leave SMs idle, as at conv0: each chunk
//     writes its tile, and split_sum_kernel adds the chunks in order
//     before squaring), or one group of examples for the fused pass
//     (each group writes its own slot of c, summed in order by
//     sum_groups_kernel).  The tile's square-sum goes to a per-(b, tile)
//     partial; with w, w_b times the tile accumulates in registers.
//       f32: CUDA-core FMAs (TF32 would miss rtol 1e-4; the core is
//       fma_core.cuh's, shared with pe_conv_grad_1d), an 8 x 4
//       register tile per thread fed by 16-byte shared-memory reads
//       along the tile's rows, the operands staged 32 deep through a
//       3-stage cp.async ring that runs on from one example into the
//       next: 16-byte copies where the feature axis is contiguous and
//       16-byte aligned, else 4-byte copies along the contiguous axis,
//       transposed into the tile (AlexNet's im2col views are t-major
//       with T odd, so they take these);
//       bf16: wgmma m64n64k16 with f32 accumulators, two warpgroups each
//       owning 64 rows, x_b^T as a K-major (t contiguous) or MN-major
//       (Di contiguous) A operand and dy_b as a K-major or MN-major B,
//       from 128-byte-swizzled tiles 64 deep through a 2-stage ring
//       (16-byte cp.async where aligned, plain loads otherwise);
//   * the symmetric Gram (gram_kernel): one block per tile pair j >= i of
//     64 token rows and example, both Grams formed in registers (4 x 4 a
//     thread) with the same staging and ring (16-byte copies where t is
//     contiguous and aligned), the off-diagonal pairs counted twice.
//     bf16 stays on FMAs here (plain loads, f32 arithmetic);
//   * rank-1 (rank1_kernel): one block per example reads x_b and dy_b
//     once.
// The bias terms come from the column sums sum_t dy_bt (colsum_kernel),
// one read of dy.  Every sum is taken in a fixed order (register tiles
// in t order, a warp butterfly and then warp 0 over the warps, partials
// per example in order): no fp32 atomics, and two runs on the same inputs
// are bitwise equal.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "fma_core.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace fma_core;  // NT (threads of every block here), BK, STAGES
using bf16 = __nv_bfloat16;

constexpr int DBM = 128;     // direct tile: Di rows
constexpr int DBN = 64;      //              Do columns
constexpr int TILE_E = DBM * DBN;
constexpr int GT = 64;       // Gram tile: GT x GT token pairs
constexpr int WK = 64;       // t depth of a wgmma stage

// Sum of v over the block in a fixed order: a butterfly inside each warp,
// then thread 0 adds the warps' sums in order.  Valid in thread 0.
// NTH: the block's threads.
template <int NTH = NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NTH / 32; ++w) s += red[w];
  return s;
}

// ---------------------------------------------------------------------------
// The FMA cores: fma_core.cuh's tile_stream over Stagers of the operands.

// The z-slice of a product-core block: examples [b0, b1), t in [t0, t1).
// Norm only (w == null): z = b S + s, chunk s of T; fused: z = group.
struct Slice {
  int b0, b1, t0, t1;
};
__device__ __forceinline__ Slice slice_of(int z, const float* w, int B,
                                          int Tn, int Bg, int S,
                                          int tchunk) {
  if (w) return {z * Bg, min(B, (z + 1) * Bg), 0, Tn};
  const int t0 = (z % S) * tchunk;
  return {z / S, z / S + 1, t0, min(Tn, t0 + tchunk)};
}

// Per-example product core on f32 FMAs.  Grid (Di-tiles x Do-tiles,
// z-slices).  W: the fused pass (w given).  (A 128 x 128 tile, 8 x 8 a
// thread, needs about 190 registers and so runs one block an SM; it
// measured slower than this one.)
template <bool W>
__global__ void __launch_bounds__(NT, 2) direct_kernel(
    const float* __restrict__ x, long long sxb, long long sxt, long long sxi,
    const float* __restrict__ dy, long long syb, long long syt,
    long long syo, int B, int Tn, int Di, int Do, int Bg, int S, int tchunk,
    int xmode, int ymode, const float* __restrict__ w,
    float* __restrict__ partial, float* __restrict__ split,
    float* __restrict__ cc) {
  constexpr int TN = 4, BN = DBN;
  extern __shared__ __align__(16) float ring[];
  float* As = ring;
  float* Bs = ring + STAGES * BK * pitch<DBM>();
  __shared__ float red[NT / 32];
  const int tx = tile_tx(), ty = tile_ty();
  const int n_tiles = gridDim.x, tile = blockIdx.x;
  const int nO = (Do + BN - 1) / BN;
  const int i0 = (tile / nO) * DBM, o0 = (tile % nO) * BN;
  const Slice sl = slice_of(blockIdx.y, w, B, Tn, Bg, S, tchunk);
  // A(k = t, m = i) = x[b, t, i]; B(k = t, n = o) = dy[b, t, o].
  const Stager<DBM, float> sx(x + sl.b0 * sxb, sxt, sxi, sxb, sl.t1, Di,
                              sl.t0, i0, xmode);
  const Stager<BN, float> sy(dy + sl.b0 * syb, syt, syo, syb, sl.t1, Do,
                             sl.t0, o0, ymode);
  float acc[8][TN], cacc[8][TN] = {};
  tile_stream<8, TN>(
      sx, sy, sl.b1 - sl.b0, sl.t1 - sl.t0, As, Bs, acc,
      [&](int e, float (&a)[8][TN]) {
        const int b = sl.b0 + e;
        if (S == 1) {
          float sq = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) sq = fmaf(a[r][c], a[r][c], sq);
          sq = block_sum(sq, red);
          if (threadIdx.x == 0) partial[(size_t)b * n_tiles + tile] = sq;
        } else {
          float* dst =
              split + ((size_t)blockIdx.y * n_tiles + tile) * TILE_E;
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c)
              dst[frag_row(ty, r) * BN + frag_row(tx, c)] = a[r][c];
        }
        if constexpr (W) {
          const float wb = w[b];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c)
              cacc[r][c] = fmaf(wb, a[r][c], cacc[r][c]);
        }
      });
  if constexpr (W) {
    float* c = cc + (size_t)blockIdx.y * Di * Do;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + frag_row(ty, r);
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int o = o0 + frag_row(tx, q);
        if (i < Di && o < Do) c[(size_t)i * Do + o] = cacc[r][q];
      }
    }
  }
}

// Symmetric Gram pair.  Grid (tile pairs j >= i of GT token rows, B).
// The contraction runs over features: A(k = f, m = t) = x[b, t, f].
template <typename T>
__global__ void __launch_bounds__(NT, 2) gram_kernel(
    const T* __restrict__ x, long long sxb, long long sxt, long long sxi,
    const T* __restrict__ dy, long long syb, long long syt, long long syo,
    int Tn, int Di, int Do, int xmode, int ymode,
    float* __restrict__ partial) {
  extern __shared__ __align__(16) float ring[];
  float* As = ring;
  float* Bs = ring + STAGES * BK * pitch<GT>();
  __shared__ float red[NT / 32];
  const int nT = (Tn + GT - 1) / GT;
  int p = blockIdx.x, i = 0;
  while (p >= nT - i) {
    p -= nT - i;
    ++i;
  }
  const int j = i + p, b = blockIdx.y;
  const T* xb = x + b * sxb;
  const T* yb = dy + b * syb;
  auto none = [](int, float (&)[4][4]) {};
  float gx[4][4], gy[4][4];
  tile_stream<4, 4>(Stager<GT, T>(xb, sxi, sxt, 0, Di, Tn, 0, i * GT, xmode),
                    Stager<GT, T>(xb, sxi, sxt, 0, Di, Tn, 0, j * GT, xmode),
                    1, Di, As, Bs, gx, none);
  tile_stream<4, 4>(Stager<GT, T>(yb, syo, syt, 0, Do, Tn, 0, i * GT, ymode),
                    Stager<GT, T>(yb, syo, syt, 0, Do, Tn, 0, j * GT, ymode),
                    1, Do, As, Bs, gy, none);
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s = fmaf(gx[r][c], gy[r][c], s);
  s = block_sum(s, red);
  if (threadIdx.x == 0)
    partial[(size_t)b * gridDim.x + blockIdx.x] = (i == j ? 1.f : 2.f) * s;
}

// ---------------------------------------------------------------------------
// The per-example product core on the tensor cores (bf16).
constexpr int WX = DBM * WK * 2;  // bytes of an x tile (128 x 64 bf16)
constexpr int WY = DBN * WK * 2;  // bytes of a dy tile (64 x 64)
constexpr int WSMEM = 2 * (WX + WY) + 1024;

// The row-major view V(r, c) = src[r sr + c sc], rows [r0, r0 + R) and
// columns [c0, c0 + C), into the swizzled tile at dst; entries with
// r >= Rn or c >= Cn are 0.  vec: 16-byte cp.async (sc = 1; sr, c0 and
// src 16-byte aligned); else plain loads and a 16-byte shared store.
template <int R, int C>
__device__ __forceinline__ void load_sw(uint32_t dst,
                                        const bf16* __restrict__ src,
                                        long long sr, long long sc, int r0,
                                        int Rn, int c0, int Cn, bool vec) {
  constexpr int CPR = C / 8, N = R * CPR;
  static_assert(N % NT == 0, "chunks must divide over threads");
#pragma unroll
  for (int i = 0; i < N / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / CPR, c = e % CPR;
    const int row = r0 + r, col = c0 + 8 * c;
    const uint32_t d = dst + chunk_off<R>(r, c);
    if (vec) {
      const int valid = row < Rn ? min(max(Cn - col, 0), 8) : 0;
      cp_async16(d, valid ? src + (long long)row * sr + col : src,
                 2 * valid);
    } else {
      const bf16* rp = src + (long long)row * sr + (long long)col * sc;
      const int n = row < Rn ? min(max(Cn - col, 0), 8) : 0;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t lo =
            2 * q < n ? __bfloat16_as_ushort(rp[2 * q * sc]) : 0;
        const uint32_t hi =
            2 * q + 1 < n ? __bfloat16_as_ushort(rp[(2 * q + 1) * sc]) : 0;
        v[q] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(d),
                   "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                   : "memory");
    }
  }
}

// Grid and outputs as direct_kernel.  XT / YT: x's / dy's t axis is the
// contiguous one, so its tile is [feature][t] and a K-major operand; else
// [t][feature], MN-major.  Warpgroup g owns rows 64 g .. 64 g + 63; a
// thread holds rows row0, row0 + 8 and columns 8 j + col0 + {0, 1} of
// them (wgmma's accumulator fragment).
template <bool XT, bool YT>
__global__ void __launch_bounds__(NT) direct_wgmma_kernel(
    const bf16* __restrict__ x, long long sxb, long long sxt, long long sxi,
    const bf16* __restrict__ dy, long long syb, long long syt, long long syo,
    int B, int Tn, int Di, int Do, int Bg, int S, int tchunk, int xvec,
    int yvec, const float* __restrict__ w, float* __restrict__ partial,
    float* __restrict__ split, float* __restrict__ cc) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float red[NT / 32];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int n_tiles = gridDim.x, tile = blockIdx.x;
  const int nO = (Do + DBN - 1) / DBN;
  const int i0 = (tile / nO) * DBM, o0 = (tile % nO) * DBN;
  const Slice sl = slice_of(blockIdx.y, w, B, Tn, Bg, S, tchunk);
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = 64 * wgi + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  float cacc[32] = {};
  for (int b = sl.b0; b < sl.b1; ++b) {
    const bf16* xb = x + b * sxb;
    const bf16* yb = dy + b * syb;
    float acc[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] = 0.f;
    const int nk = (sl.t1 - sl.t0 + WK - 1) / WK;
    auto load = [&](int c) {
      const uint32_t xs = base + (c % 2) * (WX + WY), ys = xs + WX;
      const int tc = sl.t0 + c * WK;
      if (XT)
        load_sw<DBM, WK>(xs, xb, sxi, sxt, i0, Di, tc, sl.t1, xvec);
      else
        load_sw<WK, DBM>(xs, xb, sxt, sxi, tc, sl.t1, i0, Di, xvec);
      if (YT)
        load_sw<DBN, WK>(ys, yb, syo, syt, o0, Do, tc, sl.t1, yvec);
      else
        load_sw<WK, DBN>(ys, yb, syt, syo, tc, sl.t1, o0, Do, yvec);
      cp_commit();
    };
    load(0);
    for (int c = 0; c < nk; ++c) {
      if (c + 1 < nk) {
        load(c + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      fence_async_smem();
      __syncthreads();
      const uint32_t xs = base + (c % 2) * (WX + WY), ys = xs + WX;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        const uint64_t da = XT ? kmajor<DBM>(xs, 64 * wgi, kk)
                               : mnmajor<WK>(xs + wgi * (WK * 128), kk);
        const uint64_t db = YT ? kmajor<DBN>(ys, 0, kk) : mnmajor<WK>(ys, kk);
        mma_ss<XT ? 0 : 1, YT ? 0 : 1>(acc, da, db);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(acc);
      __syncthreads();  // both warpgroups are done with this stage
    }
    if (S == 1) {
      float sq = 0.f;
#pragma unroll
      for (int q = 0; q < 32; ++q) sq = fmaf(acc[q], acc[q], sq);
      sq = block_sum(sq, red);
      if (threadIdx.x == 0) partial[(size_t)b * n_tiles + tile] = sq;
    } else {
      float* dst = split + ((size_t)blockIdx.y * n_tiles + tile) * TILE_E;
#pragma unroll
      for (int q = 0; q < 32; ++q)
        dst[(row0 + 8 * ((q / 2) % 2)) * DBN + 8 * (q / 4) + col0 + q % 2] =
            acc[q];
    }
    if (w) {
      const float wb = w[b];
#pragma unroll
      for (int q = 0; q < 32; ++q) cacc[q] = fmaf(wb, acc[q], cacc[q]);
    }
  }
  if (w) {
    float* c = cc + (size_t)blockIdx.y * Di * Do;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const int i = i0 + row0 + 8 * ((q / 2) % 2);
      const int o = o0 + 8 * (q / 4) + col0 + q % 2;
      if (i < Di && o < Do) c[(size_t)i * Do + o] = cacc[q];
    }
  }
}

// ---------------------------------------------------------------------------
// Small passes.

// partial[b][tile] = sum_e (sum_{s < S} split[b S + s][tile][e])^2.
// Grid (n_tiles, B).
__global__ void __launch_bounds__(NT) split_sum_kernel(
    const float* __restrict__ split, float* __restrict__ partial, int S) {
  __shared__ float red[NT / 32];
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  float sq = 0.f;
  for (int e = threadIdx.x; e < TILE_E; e += NT) {
    float v = 0.f;
    for (int s = 0; s < S; ++s)
      v += split[((size_t)(b * S + s) * n_tiles + tile) * TILE_E + e];
    sq = fmaf(v, v, sq);
  }
  sq = block_sum(sq, red);
  if (threadIdx.x == 0) partial[(size_t)b * n_tiles + tile] = sq;
}

// colsum[b][o] = sum_t dy[b, t, o], in t order per lane.  Grid
// (ceil(Do / 32), B).
template <typename T>
__global__ void __launch_bounds__(NT) colsum_kernel(
    const T* __restrict__ dy, long long syb, long long syt, long long syo,
    int Tn, int Do, float* __restrict__ colsum) {
  __shared__ float red[NT / 32][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, ob = blockIdx.x * 32;
  const T* yb = dy + b * syb;
  if (syt == 1) {  // t contiguous: a warp sums 4 columns, lanes along t
    for (int q = 0; q < 4; ++q) {
      const int o = ob + 4 * warp + q;
      if (o >= Do) break;
      float s = 0.f;
      for (int t = lane; t < Tn; t += 32) s += to_f32(yb[t + o * syo]);
#pragma unroll
      for (int k = 16; k > 0; k >>= 1) s += __shfl_xor_sync(0xffffffffu, s, k);
      if (lane == 0) colsum[(size_t)b * Do + o] = s;
    }
    return;
  }
  const int o = ob + lane;  // lanes along columns, warps along t
  float s = 0.f;
  if (o < Do)
    for (int t = warp; t < Tn; t += NT / 32) s += to_f32(yb[t * syt + o * syo]);
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && o < Do) {
    float v = 0.f;
    for (int k = 0; k < NT / 32; ++k) v += red[k][lane];
    colsum[(size_t)b * Do + o] = v;
  }
}

// out[b] = sum_j partial[b][j] [+ ||colsum[b]||^2], in a fixed order.
// Grid B.
__global__ void __launch_bounds__(NT) finish_kernel(
    const float* __restrict__ partial, int n, const float* __restrict__ colsum,
    int Do, float* __restrict__ out) {
  __shared__ float red[NT / 32];
  const int b = blockIdx.x;
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += NT) s += partial[(size_t)b * n + j];
  if (colsum)
    for (int o = threadIdx.x; o < Do; o += NT) {
      const float v = colsum[(size_t)b * Do + o];
      s = fmaf(v, v, s);
    }
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[b] = s;
}

// This thread's part of sum_i v[i s]^2, i < n: 8 loads in flight, summed
// in a fixed order.
template <typename T>
__device__ __forceinline__ float sumsq(const T* __restrict__ v, long long s,
                                       int n) {
  float acc[8] = {};
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * NT) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * NT;
      const float f = i < n ? to_f32(v[i * s]) : 0.f;
      acc[u] = fmaf(f, f, acc[u]);
    }
  }
  float t = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) t += acc[u];
  return t;
}

// out[b] = ||x_b||^2 ||dy_b||^2 [+ ||dy_b||^2] at T = 1.  Grid B.
template <typename T>
__global__ void __launch_bounds__(NT) rank1_kernel(
    const T* __restrict__ x, long long sxb, long long sxi,
    const T* __restrict__ dy, long long syb, long long syo, int Di, int Do,
    int has_bias, float* __restrict__ out) {
  __shared__ float red[NT / 32];
  const int b = blockIdx.x;
  const float sx = block_sum(sumsq(x + b * sxb, sxi, Di), red);
  const float sy = block_sum(sumsq(dy + b * syb, syo, Do), red);
  if (threadIdx.x == 0) out[b] = has_bias ? fmaf(sx, sy, sy) : sx * sy;
}

// out[e] = sum over g = 0 .. G-1, in order, of part[g * n + e].
__global__ void __launch_bounds__(NT) sum_groups_kernel(
    const float* __restrict__ part, float* __restrict__ out, long long n,
    int G) {
  for (long long e = blockIdx.x * (long long)NT + threadIdx.x; e < n;
       e += (long long)gridDim.x * NT) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += part[g * n + e];
    out[e] = s;
  }
}

// cb[o] = sum_b w[b] colsum[b][o], in b order.
__global__ void __launch_bounds__(NT) bias_contrib_kernel(
    const float* __restrict__ colsum, const float* __restrict__ w,
    float* __restrict__ cb, int B, int Do) {
  const int o = blockIdx.x * NT + threadIdx.x;
  if (o >= Do) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s = fmaf(w[b], colsum[(size_t)b * Do + o], s);
  cb[o] = s;
}

// ---------------------------------------------------------------------------
// Launchers.

struct Operands {
  const void* x;
  long long sxb, sxt, sxi;
  const void* dy;
  long long syb, syt, syo;
  int B, Tn, Di, Do;
  int x_tmajor, y_tmajor, xmode, ymode, is_bf16;
  cudaStream_t s;
};

int launch_colsum(const Operands& a, float* colsum) {
  dim3 grid((a.Do + 31) / 32, a.B);
  if (a.is_bf16)
    colsum_kernel<bf16><<<grid, NT, 0, a.s>>>(
        static_cast<const bf16*>(a.dy), a.syb, a.syt, a.syo, a.Tn, a.Do,
        colsum);
  else
    colsum_kernel<float><<<grid, NT, 0, a.s>>>(
        static_cast<const float*>(a.dy), a.syb, a.syt, a.syo, a.Tn, a.Do,
        colsum);
  return static_cast<int>(cudaGetLastError());
}

template <bool XT, bool YT>
int launch_wgmma(const Operands& a, dim3 grid, int Bg, int S, int tchunk,
                 const float* w, float* partial, float* split, float* cc) {
  auto kern = direct_wgmma_kernel<XT, YT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NT, WSMEM, a.s>>>(
      static_cast<const bf16*>(a.x), a.sxb, a.sxt, a.sxi,
      static_cast<const bf16*>(a.dy), a.syb, a.syt, a.syo, a.B, a.Tn, a.Di,
      a.Do, Bg, S, tchunk, a.xmode == 16, a.ymode == 16, w, partial, split,
      cc);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the FMA cores' rings.
constexpr int DIRECT_SMEM = STAGES * BK * (pitch<DBM>() + pitch<DBN>()) * 4;
constexpr int GRAM_SMEM = STAGES * BK * 2 * pitch<GT>() * 4;

int launch_fma(const Operands& a, dim3 grid, int Bg, int S, int tchunk,
               const float* w, float* partial, float* split, float* cc) {
  auto kern = w ? direct_kernel<true> : direct_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DIRECT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, NT, DIRECT_SMEM, a.s>>>(
      static_cast<const float*>(a.x), a.sxb, a.sxt, a.sxi,
      static_cast<const float*>(a.dy), a.syb, a.syt, a.syo, a.B, a.Tn, a.Di,
      a.Do, Bg, S, tchunk, a.xmode, a.ymode, w, partial, split, cc);
  return static_cast<int>(cudaGetLastError());
}

// The per-example product core over grid (n_tiles, z-slices): bf16 on
// wgmma (instantiated for its operands' layouts), f32 on FMAs.
int launch_direct(const Operands& a, dim3 grid, int Bg, int S, int tchunk,
                  const float* w, float* partial, float* split, float* cc) {
  const int xt = a.x_tmajor != 0, yt = a.y_tmajor != 0;
#define REPRO_ARGS a, grid, Bg, S, tchunk, w, partial, split, cc
  if (!a.is_bf16) return launch_fma(REPRO_ARGS);
  if (xt && yt) return launch_wgmma<true, true>(REPRO_ARGS);
  if (xt) return launch_wgmma<true, false>(REPRO_ARGS);
  if (yt) return launch_wgmma<false, true>(REPRO_ARGS);
  return launch_wgmma<false, false>(REPRO_ARGS);
#undef REPRO_ARGS
}

template <typename T>
int launch_gram(const Operands& a, float* partial) {
  const int nT = (a.Tn + GT - 1) / GT;
  dim3 grid(nT * (nT + 1) / 2, a.B);
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, GRAM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_kernel<T><<<grid, NT, GRAM_SMEM, a.s>>>(
      static_cast<const T*>(a.x), a.sxb, a.sxt, a.sxi,
      static_cast<const T*>(a.dy), a.syb, a.syt, a.syo, a.Tn, a.Di, a.Do,
      a.xmode, a.ymode, partial);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, T, Di) with element strides (sxb, sxt, sxi); dy: (B, T, Do) with
// (syb, syt, syo); the same type (is_bf16).  x_tmajor / y_tmajor: t is
// the operand's contiguous axis (else its feature axis, or neither);
// xmode / ymode: 16 where 16-byte copies along that axis are aligned,
// else 4 (f32) or 0 (bf16).  route: 0 rank-1 (T = 1), 1 direct, 2 Gram.
// Direct: partial (B, n_tiles) f32 with n_tiles = ceil(Di / 128) *
// ceil(Do / 64); T cut into `splits` chunks of `tchunk` rows, and with
// splits > 1 split is (B * splits, n_tiles, 128 * 64) f32 scratch.  Gram:
// partial (B, nT (nT + 1) / 2) with nT = ceil(T / 64).  colsum: (B, Do) f32
// scratch with a bias (routes 1 and 2), else null.  out: (B,) f32.  B, T,
// Di and Do must be positive.  Returns cudaGetLastError() after the
// launches (0 = launched).
extern "C" int repro_gram_norm(
    const void* x, long long sxb, long long sxt, long long sxi,
    const void* dy, long long syb, long long syt, long long syo,
    void* partial, void* split, void* colsum, void* out, int B, int Tn,
    int Di, int Do, int route, int splits, int tchunk, int x_tmajor,
    int y_tmajor, int xmode, int ymode, int has_bias, int is_bf16,
    void* stream) {
  const Operands a{x,  sxb, sxt, sxi, dy, syb, syt, syo, B,
                   Tn, Di,  Do,  x_tmajor, y_tmajor, xmode, ymode, is_bf16,
                   static_cast<cudaStream_t>(stream)};
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  if (route == 0) {
    if (is_bf16)
      rank1_kernel<bf16><<<B, NT, 0, a.s>>>(
          static_cast<const bf16*>(x), sxb, sxi, static_cast<const bf16*>(dy),
          syb, syo, Di, Do, has_bias, of);
    else
      rank1_kernel<float><<<B, NT, 0, a.s>>>(
          static_cast<const float*>(x), sxb, sxi,
          static_cast<const float*>(dy), syb, syo, Di, Do, has_bias, of);
    return static_cast<int>(cudaGetLastError());
  }
  float* cs = has_bias ? static_cast<float*>(colsum) : nullptr;
  int rc = 0;
  if (cs && (rc = launch_colsum(a, cs))) return rc;
  int n;
  if (route == 1) {
    const int n_tiles = ((Di + DBM - 1) / DBM) * ((Do + DBN - 1) / DBN);
    float* sp = static_cast<float*>(split);
    rc = launch_direct(a, dim3(n_tiles, B * splits), 1, splits, tchunk,
                       nullptr, pf, sp, nullptr);
    if (rc) return rc;
    if (splits > 1) {
      split_sum_kernel<<<dim3(n_tiles, B), NT, 0, a.s>>>(sp, pf, splits);
      if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
    }
    n = n_tiles;
  } else {
    rc = is_bf16 ? launch_gram<bf16>(a, pf) : launch_gram<float>(a, pf);
    if (rc) return rc;
    const int nT = (Tn + GT - 1) / GT;
    n = nT * (nT + 1) / 2;
  }
  finish_kernel<<<B, NT, 0, a.s>>>(pf, n, cs, Do, of);
  return static_cast<int>(cudaGetLastError());
}

// Operands as repro_gram_norm; w: (B,) f32; partial: (B, n_tiles) f32
// scratch; colsum: (B, Do) f32 scratch with a bias, else null; out: (B,)
// f32 norms; c: (Di, Do) f32; cb: (Do,) f32, written with a bias; groups:
// G >= 1 groups of ceil(B / G) examples, none empty; cpart: (G, Di * Do)
// f32 scratch, or c itself when G = 1.  B, T, Di and Do must be positive.
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int repro_gram_norm_fused(
    const void* x, long long sxb, long long sxt, long long sxi,
    const void* dy, long long syb, long long syt, long long syo,
    const void* w, void* partial, void* colsum, void* out, void* c,
    void* cb, void* cpart, int B, int Tn, int Di, int Do, int groups,
    int x_tmajor, int y_tmajor, int xmode, int ymode, int has_bias,
    int is_bf16, void* stream) {
  const Operands a{x,  sxb, sxt, sxi, dy, syb, syt, syo, B,
                   Tn, Di,  Do,  x_tmajor, y_tmajor, xmode, ymode, is_bf16,
                   static_cast<cudaStream_t>(stream)};
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  float* cs = has_bias ? static_cast<float*>(colsum) : nullptr;
  float* dst = static_cast<float*>(groups > 1 ? cpart : c);
  int rc = 0;
  if (cs && (rc = launch_colsum(a, cs))) return rc;
  const int n_tiles = ((Di + DBM - 1) / DBM) * ((Do + DBN - 1) / DBN);
  const int Bg = (B + groups - 1) / groups;
  rc = launch_direct(a, dim3(n_tiles, groups), Bg, 1, Tn, wf, pf, nullptr,
                     dst);
  if (rc) return rc;
  if (groups > 1) {
    const long long n = (long long)Di * Do;
    const long long blocks = (n + NT - 1) / NT;
    sum_groups_kernel<<<blocks < 4096 ? blocks : 4096, NT, 0, a.s>>>(
        dst, static_cast<float*>(c), n, groups);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  }
  if (cs) {
    bias_contrib_kernel<<<(Do + NT - 1) / NT, NT, 0, a.s>>>(
        cs, wf, static_cast<float*>(cb), B, Do);
    if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  }
  finish_kernel<<<B, NT, 0, a.s>>>(pf, n_tiles, cs, Do,
                                   static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Embedding-gather ghost norm.
//
// Replaces: src/repro/kernels/gram_norm.py : gram_norm_tokmask
//           (Pallas body _gram_tokmask_kernel).
//
//   out[b] = sum_{t, t' < T} [id_bt == id_bt'] (dy_bt . dy_bt')
//          = sum_v ||sum_{t: id_bt = v} dy_bt||^2
//
// ids is (B, T) int32, dy (B, T, D) f32 or bf16; the output is (B,) f32.
// The TPU wrapper pads T with id -1 and zero rows; here every one of the
// T positions is a real token, so any id value, -1 included, counts.
//
// What bounds it on this card: bytes.  The right-hand side needs one
// read of dy (B T D values) and about 2 T D FLOP per example, whatever
// the ids: 33.5 MB and 0.010 ms at Llama-3.2-1B's embedding cotangent
// (B = 8, T = 1024, D = 2048, bf16).  The TPU kernel's masked Gram does
// 2 T^2 D FLOP per example instead.
//
// What the design does about it: the right-hand side, as a sorted
// segment sum (route "sorted", ops.tokmask_route, T up to 16 384):
//   * tokmask_sort_kernel, one block of 1024 threads an example, sorts
//     the (id, t) pairs by id, then t, with a bitonic sort of 64-bit keys
//     in shared memory (8 bytes a pair: 128 KB at the cap), and writes
//     the order to a (B, T) scratch, bit 31 marking each segment's last
//     token (a segment: the tokens of one id);
//   * tokmask_segsum_kernel, grid (slices of 64 sorted tokens x chunks of
//     1024 features, B), 128 threads a block, 8 features a thread read as
//     16-byte vectors: a block owns the segments that start in its slice
//     and runs past the slice's end to finish its last one, so no
//     segment is split and no host-side plan is needed; it adds a
//     segment's rows in f32 in t order (8 rows' loads in flight), adds
//     the square of that sum to a running total, and writes one partial
//     per (example, slice, chunk) after a fixed-order block sum;
//   * finish_kernel adds each example's partials in a fixed order.
// dy is read once; no atomics, and two launches are bitwise equal.  The
// time does not depend on how often ids repeat, except that one id
// repeated through a whole example leaves the work to one slice.
//
// Above the sort's cap (route "gram") the masked-Gram tiles of the TPU
// kernel remain: one block per (i-tile, j-tile, example) of 64 x 64 token
// pairs, the id mask applied to the dy dy^T tile before the block's
// fixed-order sum; a block whose ids never match writes a zero partial
// without reading dy.  Partials go to a (B, nT, nT) scratch that
// finish_kernel adds per example in a fixed order.
namespace {

constexpr int TOK_SORT_NT = 1024;    // threads of a sort block
constexpr int TOK_SORT_CAP = 16384;  // pairs a sort block takes (128 KB)
constexpr int TOK_SLICE = 64;        // sorted tokens a segment block starts
constexpr int TOK_NT = 128;          // threads of a segment block
constexpr int TOK_CHUNK = 8 * TOK_NT;  // features of a segment block
constexpr int TOK_U = 8;             // rows in flight in a segment block

// order[b][i] = t of example b's i-th (id, t) pair in ascending order,
// bit 31 set where pair i is the last of its id.  Grid B; Tp2 is the
// power of two at or above T, at least 32 and at most TOK_SORT_CAP.  The
// bitonic network's exchanges across 32 or more positions go through
// shared memory, one barrier each; the rest stay in a warp (shuffles).
__global__ void __launch_bounds__(TOK_SORT_NT) tokmask_sort_kernel(
    const int* __restrict__ ids, int* __restrict__ order, int Tn, int Tp2) {
  extern __shared__ unsigned long long keys[];
  const int b = blockIdx.x;
  const int* idb = ids + (size_t)b * Tn;
  for (int i = threadIdx.x; i < Tp2; i += TOK_SORT_NT)
    keys[i] = i < Tn ? ((unsigned long long)((unsigned)idb[i] ^ 0x80000000u)
                        << 32) | (unsigned)i
                     : ~0ull;  // past T: after every real pair
  __syncthreads();
  for (int k = 2; k <= Tp2; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int i = threadIdx.x; i < Tp2; i += TOK_SORT_NT) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = keys[i], c = keys[l];
          if ((a > c) == ((i & k) == 0)) keys[i] = c, keys[l] = a;
        }
      }
      __syncthreads();
    }
    // Tp2 is a multiple of 32, so whole warps run this loop.
    for (int i = threadIdx.x; i < Tp2; i += TOK_SORT_NT) {
      unsigned long long key = keys[i];
      for (int j = min(k >> 1, 16); j > 0; j >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, j);
        // The lower position of a pair keeps the smaller key in an
        // ascending run ((i & k) == 0), the larger in a descending one.
        key = (((i & j) == 0) == ((i & k) == 0)) ? min(key, other)
                                                 : max(key, other);
      }
      keys[i] = key;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < Tn; i += TOK_SORT_NT) {
    const unsigned long long key = keys[i];
    const bool last = i + 1 == Tn || (keys[i + 1] >> 32) != (key >> 32);
    order[(size_t)b * Tn + i] =
        (int)(key & 0x7fffffffu) | (last ? (int)0x80000000u : 0);
  }
}

// Row t's features f0 .. f0 + 7 of dy_b, as f32 (0 past D).  VEC: 16-byte
// loads (D a multiple of 8 for bf16, of 4 for f32, and dy 16-byte
// aligned).
template <typename T, bool VEC>
__device__ __forceinline__ void tok_row(const T* __restrict__ row, int f0,
                                        int D, float (&v)[8]) {
  if constexpr (VEC && std::is_same<T, bf16>::value) {
    if (f0 < D) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + f0));
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[2 * e] = __uint_as_float(w[e] << 16);
        v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
  } else if constexpr (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f0 + 4 * h < D)
        q = __ldg(reinterpret_cast<const float4*>(row + f0 + 4 * h));
      v[4 * h] = q.x, v[4 * h + 1] = q.y, v[4 * h + 2] = q.z,
      v[4 * h + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = f0 + e < D ? to_f32(row[f0 + e]) : 0.f;
  }
}

// partial[(b nS + s) nC + c] = the sum, over the segments that start at
// sorted positions [s TOK_SLICE, (s + 1) TOK_SLICE) of example b, of the
// squared norm of the segment's summed rows, features of chunk c.  Grid
// (nS nC, B).
template <typename T, bool VEC>
__global__ void __launch_bounds__(TOK_NT) tokmask_segsum_kernel(
    const int* __restrict__ order, const T* __restrict__ dy,
    float* __restrict__ partial, int Tn, int D) {
  __shared__ float red[TOK_NT / 32];
  const int b = blockIdx.y, nC = (D + TOK_CHUNK - 1) / TOK_CHUNK;
  const int sl = blockIdx.x / nC, c = blockIdx.x % nC;
  const int* ob = order + (size_t)b * Tn;
  const T* yb = dy + (size_t)b * Tn * D;
  const int f0 = c * TOK_CHUNK + 8 * threadIdx.x;
  const int i1 = min(Tn, (sl + 1) * TOK_SLICE);
  // The first segment that starts in the slice (a position whose
  // predecessor ended a segment); the tail of an earlier one is skipped.
  int i = sl * TOK_SLICE;
  while (i < i1 && i > 0 && ob[i - 1] >= 0) ++i;
  bool done = i >= i1;
  float seg[8] = {}, tot[8] = {};
  // The order entries of the next TOK_U positions load while this step's
  // rows do.
  int nxt[TOK_U];
  auto entries = [&](int i0) {
#pragma unroll
    for (int u = 0; u < TOK_U; ++u)
      nxt[u] = i0 + u < Tn ? ob[i0 + u] : (int)0x80000000u;
  };
  if (!done) entries(i);
  while (!done) {
    int t[TOK_U];
    bool last[TOK_U];
    float v[TOK_U][8];
#pragma unroll
    for (int u = 0; u < TOK_U; ++u) {
      t[u] = nxt[u] & 0x7fffffff;
      last[u] = nxt[u] < 0;
    }
#pragma unroll
    for (int u = 0; u < TOK_U; ++u)
      tok_row<T, VEC>(yb + (size_t)t[u] * D, i + u < Tn ? f0 : D, D, v[u]);
    entries(i + TOK_U);
    // In sorted order, which is t order within a segment; the block stops
    // after the last token of the last segment that started in the slice.
#pragma unroll
    for (int u = 0; u < TOK_U; ++u) {
      if (done) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) seg[e] += v[u][e];
      if (last[u]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          tot[e] = fmaf(seg[e], seg[e], tot[e]);
          seg[e] = 0.f;
        }
        done = i + u + 1 >= i1;
      }
    }
    i += TOK_U;
  }
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) s += tot[e];
  s = block_sum<TOK_NT>(s, red);
  if (threadIdx.x == 0) partial[(size_t)b * gridDim.x + blockIdx.x] = s;
}

// The "gram" route, above the sort's cap.
constexpr int TBK = 16;  // depth of a staged chunk of features

// acc[i][j] = sum_k A[i0 + ty + 16 i, k] * A[j0 + tx + 16 j, k] for a
// (Tn, F) row-major A; rows past Tn count as zero.
template <typename T>
__device__ __forceinline__ void gram_tile(const T* __restrict__ A, int Tn,
                                          int F, int i0, int j0,
                                          float (*Si)[GT + 1],
                                          float (*Sj)[GT + 1],
                                          float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lk = tid % TBK;
  const int lm0 = tid / TBK;  // 0..15
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < F; k0 += TBK) {
    const int k = k0 + lk;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = lm0 + 16 * q;
      const int ti = i0 + m;
      const int tj = j0 + m;
      Si[lk][m] = (k < F && ti < Tn) ? to_f32(A[(size_t)ti * F + k]) : 0.f;
      Sj[lk][m] = (k < F && tj < Tn) ? to_f32(A[(size_t)tj * F + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Si[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Sj[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) tokmask_partial_kernel(
    const int* __restrict__ ids, const T* __restrict__ dy,
    float* __restrict__ partial, int Tn, int D) {
  const int nT = gridDim.x;
  const int bj = blockIdx.x;
  const int bi = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  __shared__ float Si[TBK][GT + 1];
  __shared__ float Sj[TBK][GT + 1];
  __shared__ int idi[GT];
  __shared__ int idj[GT];
  __shared__ float red[NT / 32];

  const int* idb = ids + (size_t)b * Tn;
  if (tid < GT) {
    const int t = bi * GT + tid;
    idi[tid] = t < Tn ? idb[t] : 0;
  } else if (tid < 2 * GT) {
    const int t = bj * GT + tid - GT;
    idj[tid - GT] = t < Tn ? idb[t] : 0;
  }
  __syncthreads();
  // This thread's 4 x 4 pairs (rows ty + 16 i, columns tx + 16 j).
  unsigned match = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ri = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = tx + 16 * j;
      if (bi * GT + ri < Tn && bj * GT + cj < Tn && idi[ri] == idj[cj])
        match |= 1u << (4 * i + j);
    }
  }
  if (!__syncthreads_or(match != 0)) {
    if (tid == 0) partial[((size_t)b * nT + bi) * nT + bj] = 0.f;
    return;
  }
  float gy[4][4];
  gram_tile(dy + (size_t)b * Tn * D, Tn, D, bi * GT, bj * GT, Si, Sj, gy);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (match & (1u << (4 * i + j))) s += gy[i][j];
  s = block_sum(s, red);
  if (tid == 0) partial[((size_t)b * nT + bi) * nT + bj] = s;
}

template <typename T>
int launch_tok_sorted(const int* ids, const T* dy, int* order, float* pf,
                      int B, int Tn, int D, bool vec, cudaStream_t s) {
  if (Tn > TOK_SORT_CAP) return static_cast<int>(cudaErrorInvalidValue);
  int tp2 = 32;
  while (tp2 < Tn) tp2 <<= 1;
  const int smem = tp2 * 8;
  cudaError_t err = cudaFuncSetAttribute(
      tokmask_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tokmask_sort_kernel<<<B, TOK_SORT_NT, smem, s>>>(ids, order, Tn, tp2);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int nS = (Tn + TOK_SLICE - 1) / TOK_SLICE;
  const int nC = (D + TOK_CHUNK - 1) / TOK_CHUNK;
  dim3 grid(nS * nC, B);
  if (vec)
    tokmask_segsum_kernel<T, true><<<grid, TOK_NT, 0, s>>>(order, dy, pf,
                                                          Tn, D);
  else
    tokmask_segsum_kernel<T, false><<<grid, TOK_NT, 0, s>>>(order, dy, pf,
                                                           Tn, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tok_gram(const int* ids, const T* dy, float* pf, int B, int Tn,
                    int D, cudaStream_t s) {
  const int nT = (Tn + GT - 1) / GT;
  tokmask_partial_kernel<T><<<dim3(nT, nT, B), NT, 0, s>>>(ids, dy, pf, Tn,
                                                           D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids: (B, T) int32, dy: (B, T, D), contiguous, dy's type by is_bf16; out:
// (B,) f32.  route 0 ("sorted", T <= 16 384): order is a (B, T) int32
// scratch and partial (B, ceil(T / 64) * ceil(D / 1024)) f32; vec: dy's
// rows take 16-byte loads (D a multiple of 8 for bf16, of 4 for f32, dy
// 16-byte aligned).  route 1 ("gram"): partial (B, nT, nT) f32 with
// nT = ceil(T / 64); order unused.  B, T and D positive.  Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int repro_gram_norm_tokmask(const void* ids, const void* dy,
                                       void* order, void* partial,
                                       void* out, int B, int Tn, int D,
                                       int route, int vec, int is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idp = static_cast<const int*>(ids);
  float* pf = static_cast<float*>(partial);
  int* op = static_cast<int*>(order);
  int rc, n;
  if (route == 0) {
    rc = is_bf16 ? launch_tok_sorted(idp, static_cast<const bf16*>(dy), op,
                                     pf, B, Tn, D, vec != 0, s)
                 : launch_tok_sorted(idp, static_cast<const float*>(dy), op,
                                     pf, B, Tn, D, vec != 0, s);
    n = ((Tn + TOK_SLICE - 1) / TOK_SLICE) *
        ((D + TOK_CHUNK - 1) / TOK_CHUNK);
  } else {
    rc = is_bf16 ? launch_tok_gram(idp, static_cast<const bf16*>(dy), pf, B,
                                   Tn, D, s)
                 : launch_tok_gram(idp, static_cast<const float*>(dy), pf, B,
                                   Tn, D, s);
    const int nT = (Tn + GT - 1) / GT;
    n = nT * nT;
  }
  if (rc) return rc;
  finish_kernel<<<B, NT, 0, s>>>(pf, n, nullptr, 0, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
