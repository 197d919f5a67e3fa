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
// Inputs are f32 or bf16; products and sums are f32.
//
// Per example this is one GEMM:
//   out_b (D x C*KH*KW) = dy_b (D x H'W') * im2col(x_b)^T (H'W' x C*KH*KW).
//
// What bounds it on this card: operations.  At AlexNet's conv1 (B = 32)
// the GEMMs do 1.9e10 FLOP against 73 MB of inputs and output, some 260
// FLOP per byte, far above the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte.
//
// What the design does about it: a 64 x 64 output tile per block, 256
// threads, a 4 x 4 register tile per thread accumulated with f32 FMA; the
// H'W' reduction runs in 16-deep chunks staged in shared memory, so each
// staged value feeds 64 FMAs.  The im2col operand is gathered implicitly
// from x while staging ((c, kh, kw) and (h, w) map to x[c, h+kh, w+kw]),
// so no patch matrix ever reaches device memory.  The whole reduction
// stays inside one block, so the result is deterministic.  It does not
// use the tensor cores: f32 parity with the reference comes first, and a
// TF32/bf16 wgmma version is later work (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "fma_core.cuh"

namespace {

constexpr int BM = 64;   // rows of the output tile (output channels d)
constexpr int BN = 64;   // columns of the output tile ((c, kh, kw))
constexpr int BK = 16;   // depth of one staged chunk of (h, w)
constexpr int NT = 256;  // threads per block (16 x 16, 4 x 4 outputs each)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT) pe_conv_grad_2d_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    float* __restrict__ out, int C, int H, int W, int D, int Hp, int Wp,
    int KH, int KW) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KK = KH * KW;
  const int N = C * KK;
  const int P = Hp * Wp;
  const T* xb = x + (size_t)b * C * H * W;
  const T* dyb = dy + (size_t)b * D * P;

  // +1 column of padding keeps the transposed stores of As conflict-free.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // Loader for the gathered x tile: thread -> one column n, four depths.
  const int ln = tid % BN;
  const int lk0 = tid / BN;  // 0..3
  int xcol = -1;             // offset of x[c, kh, kw] for column n0 + ln
  {
    const int n = n0 + ln;
    if (n < N) {
      const int c = n / KK;
      const int r = n - c * KK;
      const int kh = r / KW;
      const int kw = r - kh * KW;
      xcol = c * H * W + kh * W + kw;
    }
  }
  // Loader for the dy tile: thread -> one depth, four rows.
  const int ak = tid % BK;
  const int am0 = tid / BK;  // 0..15

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = 0; p0 < P; p0 += BK) {
    {
      const int p = p0 + ak;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = am0 + 16 * i;
        float v = 0.f;
        if (p < P && m0 + m < D) v = to_f32(dyb[(size_t)(m0 + m) * P + p]);
        As[ak][m] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lk0 + 4 * i;
      const int p = p0 + k;
      float v = 0.f;
      if (p < P && xcol >= 0) {
        const int h = p / Wp;
        const int w = p - h * Wp;
        v = to_f32(xb[xcol + h * W + w]);
      }
      Bs[k][ln] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= D) continue;
    float* orow = out + ((size_t)b * D + m) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) orow[n] = acc[i][j];
    }
  }
}

}  // namespace

// x: (B, C, H, W) padded, dy: (B, D, Hp, Wp), out: (B, D, C, KH, KW) f32,
// all contiguous on the current device.  is_bf16 selects the input type.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_pe_conv_grad_2d(const void* x, const void* dy, void* out,
                                     int B, int C, int H, int W, int D,
                                     int Hp, int Wp, int KH, int KW,
                                     int is_bf16, void* stream) {
  const int N = C * KH * KW;
  dim3 grid((N + BN - 1) / BN, (D + BM - 1) / BM, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pe_conv_grad_2d_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(out), C,
        H, W, D, Hp, Wp, KH, KW);
  } else {
    pe_conv_grad_2d_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(out), C, H, W, D, Hp, Wp, KH, KW);
  }
  return static_cast<int>(cudaGetLastError());
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
// A 3xTF32 wgmma design was built and measured in its place (PERF.md):
// its sums run 8 products at a time, so near zero its outputs differ
// from the plain version by more than chip_smoke.py's absolute floor
// (1e-7 of the largest entry), and it was dropped.
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
  const int pd = (D + 127) / 128 * 128;
  if (4 * (pd - D) >= pd) return 44;
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

