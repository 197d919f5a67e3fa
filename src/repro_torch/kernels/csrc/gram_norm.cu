// Per-example ghost norms by the Gram identity, as one hand-written
// kernel pair for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram_norm.py : gram_norm
//           (Pallas body _gram_kernel).
//
//   out[b] = sum_{t, t'} (x_bt . x_bt') (dy_bt . dy_bt')
//            [+ sum_{t, t'} dy_bt . dy_bt'   with a bias]
//          = ||dy_b^T x_b||_F^2 [+ ||sum_t dy_bt||^2]
//
// x is (B, T, Di), dy is (B, T, Do), f32 or bf16; the output is (B,) f32.
// The per-example gradient (Di x Do) and the T x T Gram matrices never
// reach device memory.
//
// What bounds it on this card: operations.  The Gram tiles cost
// 2 B T^2 (Di + Do) FLOP for B T (Di + Do) values read, so T FLOP per
// value: at AlexNet's conv0 (B = 32, T = 3969) that is 4.3e11 FLOP
// against 0.2 GB.  Only the fc layers (T = 1) are bound by bytes.
//
// What the design does about it: one block per (i-tile, j-tile, example)
// with 64 x 64 tiles of x x^T and dy dy^T built in registers (4 x 4 per
// thread, f32 FMA) from 16-deep chunks staged in shared memory, then
// sum(gx * gy) reduced inside the block by a fixed tree.  Blocks write
// one partial each to a (B, nT, nT) scratch, and a second kernel sums
// each example's partials in a fixed order: no fp32 atomics, so the
// result is deterministic.  T needs no padding (rows past T load as 0),
// so T = 1 runs as one tile.  Not yet done: the symmetry of the Gram
// (only j >= i tiles, off-diagonal ones twice) would halve the work, and
// the tensor cores are unused (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BT = 64;   // rows (t) of a Gram tile
constexpr int BK = 16;   // depth of one staged chunk of features
constexpr int NT = 256;  // threads per block (16 x 16, 4 x 4 entries each)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc[i][j] = sum_k A[i0 + ty + 16 i, k] * A[j0 + tx + 16 j, k] for a
// (Tn, F) row-major A; rows past Tn count as zero.
template <typename T>
__device__ __forceinline__ void gram_tile(const T* __restrict__ A, int Tn,
                                          int F, int i0, int j0,
                                          float (*Si)[BT + 1],
                                          float (*Sj)[BT + 1],
                                          float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lk = tid % BK;
  const int lm0 = tid / BK;  // 0..15
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < F; k0 += BK) {
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
    for (int kk = 0; kk < BK; ++kk) {
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

// Fixed-order tree sum of red[0..NT) into red[0].
__device__ __forceinline__ void block_tree_sum(float* red) {
  __syncthreads();
#pragma unroll
  for (int stride = NT / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) gram_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    float* __restrict__ partial, int Tn, int Di, int Do, int has_bias) {
  const int nT = gridDim.x;
  const int bj = blockIdx.x;
  const int bi = blockIdx.y;
  const int b = blockIdx.z;
  __shared__ float Si[BK][BT + 1];
  __shared__ float Sj[BK][BT + 1];
  __shared__ float red[NT];

  float gx[4][4], gy[4][4];
  gram_tile(x + (size_t)b * Tn * Di, Tn, Di, bi * BT, bj * BT, Si, Sj, gx);
  gram_tile(dy + (size_t)b * Tn * Do, Tn, Do, bi * BT, bj * BT, Si, Sj, gy);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s += has_bias ? fmaf(gx[i][j], gy[i][j], gy[i][j]) : gx[i][j] * gy[i][j];
  red[threadIdx.x] = s;
  block_tree_sum(red);
  if (threadIdx.x == 0) partial[((size_t)b * nT + bi) * nT + bj] = red[0];
}

// out[b] = sum of example b's n partials, in a fixed order.
__global__ void __launch_bounds__(NT) gram_sum_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int n) {
  __shared__ float red[NT];
  const float* pb = partial + (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int t = threadIdx.x; t < n; t += NT) s += pb[t];
  red[threadIdx.x] = s;
  block_tree_sum(red);
  if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

}  // namespace

// x: (B, T, Di), dy: (B, T, Do), contiguous, same type (is_bf16);
// partial: (B, nT, nT) f32 scratch with nT = ceil(T / 64); out: (B,) f32.
// Returns cudaGetLastError() after both launches (0 = launched).
extern "C" int repro_gram_norm(const void* x, const void* dy, void* partial,
                               void* out, int B, int Tn, int Di, int Do,
                               int has_bias, int is_bf16, void* stream) {
  const int nT = (Tn + BT - 1) / BT;
  dim3 grid(nT, nT, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    gram_partial_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), static_cast<float*>(partial),
        Tn, Di, Do, has_bias);
  } else {
    gram_partial_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(partial), Tn, Di, Do, has_bias);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_sum_kernel<<<B, NT, 0, s>>>(static_cast<const float*>(partial),
                                   static_cast<float*>(out), nT * nT);
  return static_cast<int>(cudaGetLastError());
}
