// Per-example 2-D and 1-D convolution weight gradients (the paper's
// Algorithm 2) as hand-written kernels for Hopper (sm_90a): the 2-D one
// here, the 1-D one below.
//
// Replaces: src/repro/kernels/pe_conv_grad.py : pe_conv_grad_2d
//           (Pallas body _kernel_2d).
//
//   out[b, d, c, kh, kw] = sum_{h, w} x[b, c, h + kh, w + kw] * dy[b, d, h, w]
//
// x is the padded input (B, C, H, W), dy the output cotangent
// (B, D, H', W') with H' = H - KH + 1, W' = W - KW + 1 (stride and
// dilation 1, groups 1: the wrapper routes every other conv elsewhere).
// Inputs are f32 or bf16; the output is f32.
//
// Per example this is one GEMM whose row-major output is the output's
// layout:
//   out_b (D x C*KH*KW) = dy_b (D x H'W') * im2col(x_b)^T (H'W' x C*KH*KW).
//
// What bounds it on this card: operations.  AlexNet's conv1-4 (B = 32)
// do 4.96e10 FLOP against about 0.4 GB of inputs and output; the f32
// route runs three TF32 products for each f32 one, 1.49e11 FLOP at the
// TF32 rate of 495 TFLOP/s: 0.301 ms, against 0.12 ms for the bytes.
//
// What the design does about it: the products run on the tensor cores
// (wgmma m64n64, both operands K-major from 128-byte-swizzled shared
// memory), for both input types.
//   f32 inputs, 3xTF32: each staged value v is split once into
//   hi = tf32(v) and lo = tf32(v - hi), rounded to nearest
//   (cvt.rna.tf32.f32; wgmma reads only the top 19 bits), and a stage
//   sums lo.hi + hi.lo + hi.hi.  bf16 inputs: one bf16 product, exact
//   in f32.
//   A stage is one 128-byte row of each operand (32 f32 or 64 bf16 of
//   the H'W' contraction, four k-steps); its products start from zero and
//   are added to an f32 accumulator in registers, so the tensor cores'
//   own accumulation (which does not round to nearest) spans 32 or 64
//   terms, never the whole sum.  The result meets the f64-based bound of
//   kernels/bounds.py at every length.
//   Operands are gathered into registers one stage ahead (plain 4- or
//   2-byte loads: H'W' is odd at AlexNet's shapes, so dy's rows are not
//   16-byte aligned, and the im2col column (c, kh, kw) at depth
//   p = (h, w) reads x[c, h + kh, w + kw], its offset in x_b taken from
//   a table in shared memory), split while the tensor cores run the
//   current stage, and stored as 16-byte vectors into the other buffer
//   of a 2-stage ring; no patch matrix reaches device memory.
//   Tiles: 128 x 64 (two warpgroups of 64 rows), or 64 x 128 (two
//   warpgroups of 64 columns) where D leaves a 128-row tile a quarter
//   empty (conv1's D = 192); at 128 registers and 97 KB of shared memory
//   two blocks share an SM, so one block's stage boundary (wait, add,
//   barrier) and its first loads and last stores run under the other's
//   products.  (128 x 128 and 64 x 256 tiles, one block an SM, and a
//   4-stage cp.async ring with the split in place both ran slower on
//   AlexNet's shapes: PERF.md.)  The output leaves as
//   16-byte vectors along C*KH*KW (a lane swap pairs each thread's two
//   columns with its neighbour's).
// Every output's sum stays in one block in a fixed order, with no
// atomics: two launches are bitwise equal.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "fma_core.cuh"
#include "hopper.cuh"

namespace {

namespace hp = hopper;
using bf16 = __nv_bfloat16;

constexpr int C2_NT = 256;  // threads of a 2-D block: two warpgroups

// Rows of an output tile along D, for both kernels: 64 where D leaves at
// least a quarter of the 128-row tiles' rows empty, else 128.
int tile_rows(int D) {
  const int pd = (D + 127) / 128 * 128;
  return 4 * (pd - D) >= pd ? 64 : 128;
}

template <typename T, int BM>
struct Conv2d {
  static constexpr bool F32 = std::is_same<T, float>::value;
  // Columns of the tile: each warpgroup's product is 64 x 64, the two
  // stacked along D (BM = 128) or along C KH KW (BM = 64).
  static constexpr int BN = BM == 128 ? 64 : 128;
  static constexpr int KS = 128 / sizeof(T);     // depth of a stage
  static constexpr int G = 16 / sizeof(T);       // values of a chunk
  static constexpr int NA = BM / 32, NB = BN / 32;  // a thread's chunks
  static constexpr int TA = BM * 128, TB = BN * 128;  // bytes of a tile
  // A stage: A (hi, lo) then B (hi, lo) for f32; A then B for bf16.
  static constexpr int STAGE = (F32 ? 2 : 1) * (TA + TB);
  static constexpr int SMEM = 2 * STAGE + 1024;
};

__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits_of(bf16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}
__device__ __forceinline__ void st_shared4(uint32_t addr,
                                           const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// Grid (D-tiles x (C KH KW)-tiles, B).  Warpgroup g owns rows 64 g of a
// 128 x 64 tile (BM = 128) or columns 64 g of a 64 x 128 one (BM = 64);
// a thread holds rows row0, row0 + 8 and columns 8 j + col0 + {0, 1} of
// its warpgroup's 64 x 64 (wgmma's accumulator fragment).
template <typename T, int BM>
__global__ void __launch_bounds__(C2_NT, 2) pe_conv_grad_2d_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    float* __restrict__ out, int C, int H, int W, int D, int Wp, int P,
    int KH, int KW, int tilesN) {
  using K = Conv2d<T, BM>;
  constexpr int BN = K::BN, KS = K::KS, G = K::G, NA = K::NA, NB = K::NB;
  constexpr int TA = K::TA, TB = K::TB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int coff[BN];  // x_b offset of im2col column n0 + i, or -1
  const uint32_t base = (hp::smem_u32(smem_raw) + 1023) & ~1023u;
  const int b = blockIdx.y;
  const int m0 = (blockIdx.x / tilesN) * BM, n0 = (blockIdx.x % tilesN) * BN;
  const int KK = KH * KW, N = C * KK;
  const T* xb = x + (size_t)b * C * H * W;
  const T* dyb = dy + (size_t)b * D * P;
  const int tid = threadIdx.x;
  for (int i = tid; i < BN; i += C2_NT) {
    const int n = n0 + i;
    int o = -1;
    if (n < N) {
      const int c = n / KK, r = n - c * KK, kh = r / KW;
      o = c * H * W + kh * W + (r - kh * KW);
    }
    coff[i] = o;
  }
  __syncthreads();
  // This thread loads chunk column kc (values kc G .. kc G + G - 1 of a
  // stage) of rows rb + 32 i of each operand: a warp covers 4 rows of 128
  // bytes.
  const int kc = tid % 8, rb = tid / 8;
  // Stage s's values, as bits (f32: one a word; bf16: two).
  uint32_t pre[NA + NB][4];
  auto load = [&](int s) {
    const int p0 = s * KS + kc * G;
    int roff[G];
    bool pv[G];
    int h = p0 / Wp, w = p0 - h * Wp;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      pv[u] = p0 + u < P;
      roff[u] = h * W + w;
      if (++w == Wp) w = 0, ++h;
    }
    auto put = [&](uint32_t (&dst)[4], int u, uint32_t v) {
      if constexpr (K::F32)
        dst[u] = v;
      else
        dst[u / 2] |= v << (16 * (u % 2));
    };
#pragma unroll
    for (int i = 0; i < NA + NB; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[i][q] = 0;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int m = m0 + rb + 32 * i;
      const T* src = dyb + (size_t)m * P + p0;
#pragma unroll
      for (int u = 0; u < G; ++u)
        put(pre[i], u, pv[u] && m < D ? bits_of(src[u]) : 0u);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int co = coff[rb + 32 * i];
#pragma unroll
      for (int u = 0; u < G; ++u)
        put(pre[NA + i], u, pv[u] && co >= 0 ? bits_of(xb[co + roff[u]])
                                             : 0u);
    }
  };
  // The values in pre into ring buffer `buf`, split into TF32 hi and lo
  // for f32.
  auto store = [&](int buf) {
    const uint32_t sb = base + buf * K::STAGE;
#pragma unroll
    for (int i = 0; i < NA + NB; ++i) {
      const bool a = i < NA;
      const int row = rb + 32 * (a ? i : i - NA);
      const uint32_t off =
          a ? hp::chunk_off<BM>(row, kc) : hp::chunk_off<BN>(row, kc);
      if constexpr (K::F32) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = __uint_as_float(pre[i][q]);
          hi[q] = tf32_rna(v);
          lo[q] = tf32_rna(v - __uint_as_float(hi[q]));
        }
        st_shared4(sb + (a ? 0 : 2 * TA) + off, hi);
        st_shared4(sb + (a ? TA : 2 * TA + TB) + off, lo);
      } else {
        st_shared4(sb + (a ? 0 : TA) + off, pre[i]);
      }
    }
  };

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int arow = BM == 128 ? 64 * wg : 0, bcol = BM == 128 ? 0 : 64 * wg;
  // One stage's products, from zero, into st.
  auto products = [&](uint32_t sb, float (&st)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (K::F32) {
        const uint64_t ah = hp::kmajor<BM>(sb, arow, kk);
        const uint64_t al = hp::kmajor<BM>(sb + TA, arow, kk);
        const uint64_t bh = hp::kmajor<BN>(sb + 2 * TA, bcol, kk);
        const uint64_t bl = hp::kmajor<BN>(sb + 2 * TA + TB, bcol, kk);
        hp::mma_ss64_tf32(st, al, bh, kk);
        hp::mma_ss64_tf32(st, ah, bl, 1);
        hp::mma_ss64_tf32(st, ah, bh, 1);
      } else {
        hp::mma_ss64_bf16(st, hp::kmajor<BM>(sb, arow, kk),
                          hp::kmajor<BN>(sb + TA, bcol, kk), kk);
      }
    }
  };

  float acc[32], st[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f, st[q] = 0.f;
  const int ns = (P + KS - 1) / KS;
  load(0);
  store(0);
  hp::fence_async_smem();
  __syncthreads();
  if (ns > 1) load(1);
  for (int s = 0; s < ns; ++s) {
    hp::reg_fence(st);
    hp::wg_fence();
    products(base + (s & 1) * K::STAGE, st);
    hp::wg_commit();
    // While the tensor cores run stage s: stage s + 1 into the other
    // buffer (its last readers, stage s - 1's products, are done), and
    // stage s + 2's loads in flight.
    if (s + 1 < ns) store((s + 1) & 1);
    if (s + 2 < ns) load(s + 2);
    hp::wg_wait<0>();
    hp::reg_fence(st);
#pragma unroll
    for (int q = 0; q < 32; ++q) acc[q] += st[q];
    hp::fence_async_smem();
    __syncthreads();
  }

  // Epilogue: lanes 2i and 2i + 1 swap halves, so each holds four
  // consecutive columns of one row (the even lane row0, the odd row0 + 8).
  const int odd = lane & 1;
  const int m = m0 + arow + 16 * warp + lane / 4 + 8 * odd;
  const int nc = n0 + bcol + 2 * (lane % 4) - 2 * odd;
  float* orow = out + ((size_t)b * D + (m < D ? m : 0)) * N;
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // Every lane takes part in the swaps, rows past D included.
    const float g0 = __shfl_xor_sync(0xffffffffu,
                                     odd ? acc[4 * j] : acc[4 * j + 2], 1);
    const float g1 = __shfl_xor_sync(0xffffffffu,
                                     odd ? acc[4 * j + 1] : acc[4 * j + 3], 1);
    const float4 v =
        odd ? make_float4(g0, g1, acc[4 * j + 2], acc[4 * j + 3])
            : make_float4(acc[4 * j], acc[4 * j + 1], g0, g1);
    const int n = nc + 8 * j;
    if (m >= D) continue;
    if (vec) {
      if (n < N) *reinterpret_cast<float4*>(orow + n) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < N) orow[n + q] = e[q];
    }
  }
}

template <typename T, int BM>
int launch_2d(const void* x, const void* dy, void* out, int B, int C, int H,
              int W, int D, int Hp, int Wp, int KH, int KW, cudaStream_t s) {
  using K = Conv2d<T, BM>;
  auto kern = pe_conv_grad_2d_kernel<T, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tilesN = (C * KH * KW + K::BN - 1) / K::BN;
  dim3 grid(((D + BM - 1) / BM) * tilesN, B);
  kern<<<grid, C2_NT, K::SMEM, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(out), C, H, W, D, Wp, Hp * Wp, KH, KW, tilesN);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_2d(const void* x, const void* dy, void* out, int B, int C, int H,
              int W, int D, int Hp, int Wp, int KH, int KW, cudaStream_t s) {
  if (tile_rows(D) == 64)
    return launch_2d<T, 64>(x, dy, out, B, C, H, W, D, Hp, Wp, KH, KW, s);
  return launch_2d<T, 128>(x, dy, out, B, C, H, W, D, Hp, Wp, KH, KW, s);
}

}  // namespace

// x: (B, C, H, W) padded, dy: (B, D, Hp, Wp), out: (B, D, C, KH, KW) f32,
// all contiguous on the current device, every size positive.  is_bf16
// selects the input type.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int repro_pe_conv_grad_2d(const void* x, const void* dy, void* out,
                                     int B, int C, int H, int W, int D,
                                     int Hp, int Wp, int KH, int KW,
                                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_2d<bf16>(x, dy, out, B, C, H, W, D, Hp, Wp, KH,
                                   KW, s)
                 : launch_2d<float>(x, dy, out, B, C, H, W, D, Hp, Wp, KH,
                                    KW, s);
}

// ---------------------------------------------------------------------------
// Per-example 1-D convolution weight gradients.
//
// Replaces: src/repro/kernels/pe_conv_grad.py : pe_conv_grad_1d
//           (Pallas body _kernel_1d).
//
//   out[b, d, c, k] = sum_t x[b, c, t + k] * dy[b, d, t]
//
// x is the padded input (B, C, T), dy the output cotangent (B, D, T')
// with T' = T - K + 1 (stride and dilation 1, groups 1).  Inputs are f32
// or bf16; products and sums are f32.  Per example this is one GEMM:
//   out_b (D x C*K) = dy_b (D x T') * X_b (T' x C*K),  X_b[t, (c, k)] =
//   x[b, c, t + k],
// the TPU kernel's K shifted (bd x T') * (T' x C) products laid side by
// side, so one tile loop serves every k.  Both operands run along t, the
// contraction: both are K-major.
//
// What bounds it on this card: operations.  The 1-D lane's five layers
// (B = 32, T' = 4096) do 2.035e11 FLOP against about 0.5 GB of inputs
// and outputs: 3.04 ms at the 67 TFLOP/s of f32 FMAs.
//
// What the design does about it: pe_conv_grad_1d_kernel is the
// per-example product core of fma_core.cuh (shared with gram_norm.cu):
// an output tile (d rows, (c, k) columns; 128 x 128 (f32), 128 x 64
// (bf16) or 64 x 64 by shape, tile_shape below) per block of 256
// threads, 8 x 8, 8 x 4 or 4 x 4 f32 accumulators a thread fed by
// 16-byte shared-memory reads, both operands staged 32 deep along t
// through a 3-stage cp.async ring.
// dy rows are copied 4 bytes a thread along t; the shifted x operand is
// gathered while staging (column (c, k) at depth t reads x[c, t + k],
// each thread's column offsets formed once), a warp covering 8 t by 4
// columns, so the shifted copies never reach device memory.
// Each output is one sequential f32 sum over t, in order: two runs are
// bitwise equal, with no atomics.  At the lane's shapes it matched the
// plain version (cuBLAS through torch.einsum) bit for bit on an
// NVIDIA H100 80GB HBM3 with torch 2.11+cu128; cuBLAS's order is not
// documented, so that is an observation, not a property (PERF.md).
// T' is not cut into chunks where the tiles leave SMs idle (the lane's
// first layer, D = 64 by C*K = 33, runs B blocks): a chunked sum is
// another summation order.
//
// A 3xTF32 wgmma design was built and measured in its place (PERF.md)
// and dropped, because the bound the kernels were held to then (rtol
// 1e-4 of the plain version with a floor of 1e-7 of the largest entry)
// lay below the f32 rounding of a 4096-term sum.  The f64-based bound of
// kernels/bounds.py admits it; the 2-D kernel above runs that design.
namespace {

namespace fc = fma_core;

// The output tile, 16 TM rows (output channels d) by 16 TN columns
// ((c, k)), as 10 TM + TN: 64 x 64 (4 x 4 accumulators a thread) where D
// leaves at least a quarter of the 128-row tiles' rows empty (the lane's
// D = 64 and 192); else 128 x 128 (8 x 8, one block an SM) for f32 (the
// lane's conv2-4) and 128 x 64 (8 x 4, two blocks an SM) for bf16, whose
// plain loads need the registers that 8 x 8 would take.  PERF.md has the
// shapes' times on the lane.
int tile_shape(int D, bool bf16) {
  if (tile_rows(D) == 64) return 44;
  return bf16 ? 84 : 88;
}
template <int TM, int TN>
constexpr int p1_smem() {
  return fc::STAGES * fc::BK * (fc::pitch<16 * TM>() + fc::pitch<16 * TN>()) *
         4;
}

// Grid (D-tiles x (C K)-tiles, B).
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(fc::NT, TM * TN > 32 ? 1 : 2)
    pe_conv_grad_1d_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           float* __restrict__ out, int C, int Tn, int D,
                           int Tp, int K) {
  constexpr int P1M = 16 * TM, P1N = 16 * TN;
  extern __shared__ __align__(16) float ring[];
  float* As = ring;
  float* Bs = ring + fc::STAGES * fc::BK * fc::pitch<P1M>();
  const int b = blockIdx.y, N = C * K;
  const int nN = (N + P1N - 1) / P1N;
  const int d0 = (blockIdx.x / nN) * P1M, n0 = (blockIdx.x % nN) * P1N;
  const int mode = std::is_same<T, float>::value ? 4 : 0;
  // A(k = t, m = d) = dy[b, d, t]; B(k = t, n = c K + k) = x[b, c, t + k].
  const fc::Stager<P1M, T> sa(dy + (size_t)b * D * Tp, 1, Tp, 0, Tp, D, 0,
                              d0, mode);
  const fc::Stager<P1N, T, true> sb(x + (size_t)b * C * Tn, 1, Tn, 0, Tp,
                                    N, 0, n0, mode, K);
  float acc[TM][TN];
  fc::tile_stream<TM, TN>(sa, sb, 1, Tp, As, Bs, acc,
                          [&](int, float (&a)[TM][TN]) {
    const int tx = fc::tile_tx(), ty = fc::tile_ty();
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int d = d0 + fc::frag_row(ty, r);
      if (d >= D) continue;
      float* orow = out + ((size_t)b * D + d) * N;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int n = n0 + fc::frag_row(tx, c);
        if (n < N) orow[n] = a[r][c];
      }
    }
  });
}

template <typename T, int TM, int TN>
int launch_1d(const void* x, const void* dy, void* out, int B, int C,
              int Tn, int D, int Tp, int K, cudaStream_t s) {
  auto kern = pe_conv_grad_1d_kernel<T, TM, TN>;
  constexpr int smem = p1_smem<TM, TN>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int N = C * K;
  dim3 grid(((D + 16 * TM - 1) / (16 * TM)) * ((N + 16 * TN - 1) / (16 * TN)),
            B);
  kern<<<grid, fc::NT, smem, s>>>(static_cast<const T*>(x),
                                  static_cast<const T*>(dy),
                                  static_cast<float*>(out), C, Tn, D, Tp, K);
  return static_cast<int>(cudaGetLastError());
}
template <typename T>
int launch_1d(const void* x, const void* dy, void* out, int B, int C,
              int Tn, int D, int Tp, int K, cudaStream_t s) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (tile_shape(D, !f32) == 44)
    return launch_1d<T, 4, 4>(x, dy, out, B, C, Tn, D, Tp, K, s);
  if constexpr (f32)
    return launch_1d<T, 8, 8>(x, dy, out, B, C, Tn, D, Tp, K, s);
  else
    return launch_1d<T, 8, 4>(x, dy, out, B, C, Tn, D, Tp, K, s);
}

}  // namespace

// x: (B, C, T) padded, dy: (B, D, Tp) with Tp = T - K + 1, out: (B, D, C, K)
// f32, all contiguous on the current device, B, C, D, Tp and K positive.
// is_bf16 selects the input type.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int repro_pe_conv_grad_1d(const void* x, const void* dy, void* out,
                                     int B, int C, int Tn, int D, int Tp,
                                     int K, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_1d<__nv_bfloat16>(x, dy, out, B, C, Tn, D, Tp, K, s)
                 : launch_1d<float>(x, dy, out, B, C, Tn, D, Tp, K, s);
}

