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
// side, so one tile loop serves every k.
//
// What bounds it on this card: operations.  On the 1-D lane's widest layer
// (B = 32, T' = 4096, C = 384, D = 256, K = 3) the GEMMs do 7.7e10 FLOP
// against about 0.2 GB of inputs and output.
//
// What the design does about it: the 2-D kernel's blocking (a 64 x 64
// output tile per block, 256 threads with 4 x 4 f32 accumulators, the t
// reduction in 16-deep chunks staged in shared memory), with the shifted
// x operand gathered while staging: column (c, k) at depth t reads
// x[c, t + k], so the shifted copies never reach device memory.  Each
// output tile is summed over all of t by one block, in order: two runs
// are bitwise equal, with no atomics.  Not yet done: tensor cores, and
// more than one block per example where D x C*K is a single tile (the
// lane's first layer, 64 x 33, runs B blocks).
namespace {

template <typename T>
__global__ void __launch_bounds__(NT) pe_conv_grad_1d_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    float* __restrict__ out, int C, int Tn, int D, int Tp, int K) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int N = C * K;
  const T* xb = x + (size_t)b * C * Tn;
  const T* dyb = dy + (size_t)b * D * Tp;

  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // Loader for the shifted x tile: thread -> one column n, four depths.
  const int ln = tid % BN;
  const int lk0 = tid / BN;  // 0..3
  int xcol = -1;             // offset of x[c, k] for column n0 + ln
  if (n0 + ln < N) {
    const int c = (n0 + ln) / K;
    xcol = c * Tn + (n0 + ln - c * K);
  }
  // Loader for the dy tile: thread -> one depth, four rows.
  const int ak = tid % BK;
  const int am0 = tid / BK;  // 0..15

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < Tp; t0 += BK) {
    {
      const int t = t0 + ak;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = am0 + 16 * i;
        float v = 0.f;
        if (t < Tp && m0 + m < D) v = to_f32(dyb[(size_t)(m0 + m) * Tp + t]);
        As[ak][m] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lk0 + 4 * i;
      const int t = t0 + k;
      Bs[k][ln] = (t < Tp && xcol >= 0) ? to_f32(xb[xcol + t]) : 0.f;
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

// x: (B, C, T) padded, dy: (B, D, Tp) with Tp = T - K + 1, out: (B, D, C, K)
// f32, all contiguous on the current device.  is_bf16 selects the input
// type.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_pe_conv_grad_1d(const void* x, const void* dy, void* out,
                                     int B, int C, int Tn, int D, int Tp,
                                     int K, int is_bf16, void* stream) {
  const int N = C * K;
  dim3 grid((N + BN - 1) / BN, (D + BM - 1) / BM, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    pe_conv_grad_1d_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(out), C,
        Tn, D, Tp, K);
  } else {
    pe_conv_grad_1d_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(out), C, Tn, D, Tp, K);
  }
  return static_cast<int>(cudaGetLastError());
}
