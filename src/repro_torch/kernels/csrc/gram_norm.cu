// Per-example ghost norms, alone (repro_gram_norm), fused with the
// weighted contribution (repro_gram_norm_fused, below) and for an
// embedding gather (repro_gram_norm_tokmask, last), as hand-written
// kernels for Hopper (sm_90a).
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

// ---------------------------------------------------------------------------
// Fused ghost norm + weighted contribution.
//
// Replaces: src/repro/kernels/gram_norm.py : gram_norm_fused
//           (Pallas body _gram_fused_kernel).
//
//   n[b] = ||x_b^T dy_b||_F^2   [+ ||sum_t dy_bt||^2   with a bias]
//   c    = sum_b w_b x_b^T dy_b                (Di x Do, row-major)
//   cb   = sum_b w_b sum_t dy_bt               (Do; zeros without a bias)
//
// x is (B, T, Di) and dy (B, T, Do), f32 or bf16, each read through its
// own three strides, so the transposed im2col view of a conv layer,
// (B, C K, T) seen as (B, T, C K), is read in place; w is (B,) f32.
//
// What bounds it on this card: operations.  Both outputs come from the
// per-example products x_b^T dy_b, 2 B T Di Do FLOP (at AlexNet's conv3,
// B = 32, T = 225, Di = 3456, Do = 256: 1.3e10 FLOP for 0.11 GB read).
// The TPU kernel's Gram route would cost 2 B T^2 (Di + Do) more.
//
// What the design does about it: the work is exactly those products.
// One block owns one 64 x 64 tile of the contribution (Di-tile, Do-tile)
// for one group of examples, and walks that group in order.  For example
// b it forms its tile of x_b^T dy_b in registers (4 x 4 per thread, f32
// FMA) from 16-row chunks of t staged in shared memory, adds the tile's
// square-sum to a per-(b, tile) partial (fixed tree inside the block),
// and adds w_b times the tile to a register accumulator that it writes
// once at the end.  The blocks of Di-tile 0 also sum their dy columns
// over t, for the bias terms.  The (Di, Do) tiles alone are 144-216
// blocks at AlexNet's conv2-4, about one per SM, too few to hide the
// load latency; so the batch is split into G groups (the wrapper picks
// G from the tile count and the SM count), each group's contribution
// goes to its own slot, and sum_groups_kernel adds the G slots in order.
// The norm partials are summed per example by gram_sum_kernel in a fixed
// order.  No fp32 atomics: two runs on the same inputs are bitwise
// equal.  Not yet done: tensor cores.
namespace {

constexpr int FT = 64;  // rows (Di) and columns (Do) of a contribution tile

// Stage rows t0 .. t0+BK of columns f0 .. f0+FT of a (T, F) operand read
// through strides (st, sf) into S[t][f]; out-of-range entries are 0.
// Threads walk the operand's contiguous axis fastest.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ A, long long st,
                                      long long sf, int Tn, int F, int t0,
                                      int f0, float (*S)[FT + 1]) {
  const bool t_fast = (st == 1 && sf != 1);
  for (int e = threadIdx.x; e < BK * FT; e += NT) {
    const int kt = t_fast ? e % BK : e / FT;
    const int kf = t_fast ? e / BK : e % FT;
    const int t = t0 + kt;
    const int f = f0 + kf;
    S[kt][kf] = (t < Tn && f < F) ? to_f32(A[t * st + f * sf]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) gram_fused_kernel(
    const T* __restrict__ x, long long sxb, long long sxt, long long sxi,
    const T* __restrict__ dy, long long syb, long long syt, long long syo,
    const float* __restrict__ w, float* __restrict__ partial,
    float* __restrict__ cc, int B, int Bg, int Tn, int Di, int Do,
    int has_bias) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int o0 = blockIdx.x * FT;
  const int i0 = blockIdx.y * FT;
  const int n_tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const bool bias_block = has_bias && blockIdx.y == 0 && tid < FT;
  __shared__ float Xs[BK][FT + 1];
  __shared__ float Ys[BK][FT + 1];
  __shared__ float red[NT];

  float cacc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) cacc[r][q] = 0.f;
  float cbacc = 0.f;

  const int b1 = min(B, (blockIdx.z + 1) * Bg);
  for (int b = blockIdx.z * Bg; b < b1; ++b) {
    const T* xb = x + b * sxb;
    const T* yb = dy + b * syb;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    float colsum = 0.f;
    for (int t0 = 0; t0 < Tn; t0 += BK) {
      stage(xb, sxt, sxi, Tn, Di, t0, i0, Xs);
      stage(yb, syt, syo, Tn, Do, t0, o0, Ys);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = Xs[kk][ty + 16 * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = Ys[kk][tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], v[q], acc[r][q]);
      }
      if (bias_block) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) colsum += Ys[kk][tid];
      }
      __syncthreads();
    }
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) s = fmaf(acc[r][q], acc[r][q], s);
    if (bias_block) s = fmaf(colsum, colsum, s);
    red[tid] = s;
    block_tree_sum(red);
    if (tid == 0) partial[(size_t)b * n_tiles + tile] = red[0];
    const float wb = w[b];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) cacc[r][q] = fmaf(wb, acc[r][q], cacc[r][q]);
    cbacc = fmaf(wb, colsum, cbacc);
  }

  // This group's slot: c (Di x Do), then cb (Do).
  float* c = cc + (size_t)blockIdx.z * ((size_t)Di * Do + Do);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = o0 + tx + 16 * q;
      if (i < Di && o < Do) c[(size_t)i * Do + o] = cacc[r][q];
    }
  }
  if (blockIdx.y == 0 && tid < FT && o0 + tid < Do)
    c[(size_t)Di * Do + o0 + tid] = cbacc;
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

}  // namespace

// x: (B, T, Di) with element strides (sxb, sxt, sxi); dy: (B, T, Do) with
// (syb, syt, syo); both the same type (is_bf16); w: (B,) f32; partial:
// (B, ceil(Di / 64) * ceil(Do / 64)) f32 scratch; out: (B,) f32 norms;
// cc: (Di * Do + Do,) f32, the contribution c (Di, Do) then cb (Do,);
// groups: G >= 1 groups of ceil(B / G) examples, G <= B; cpart:
// (G, Di * Do + Do) f32 scratch, or cc itself when G = 1.  B, Di and Do
// must be positive.  Returns cudaGetLastError() after the launches
// (0 = launched).
extern "C" int repro_gram_norm_fused(
    const void* x, long long sxb, long long sxt, long long sxi,
    const void* dy, long long syb, long long syt, long long syo,
    const void* w, void* partial, void* out, void* cc, void* cpart, int B,
    int Tn, int Di, int Do, int groups, int has_bias, int is_bf16,
    void* stream) {
  const int Bg = (B + groups - 1) / groups;
  dim3 grid((Do + FT - 1) / FT, (Di + FT - 1) / FT, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  float* dst = static_cast<float*>(groups > 1 ? cpart : cc);
  if (is_bf16) {
    gram_fused_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sxb, sxt, sxi,
        static_cast<const __nv_bfloat16*>(dy), syb, syt, syo, wf, pf, dst,
        B, Bg, Tn, Di, Do, has_bias);
  } else {
    gram_fused_kernel<float><<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), sxb, sxt, sxi,
        static_cast<const float*>(dy), syb, syt, syo, wf, pf, dst, B, Bg,
        Tn, Di, Do, has_bias);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups > 1) {
    const long long n = (long long)Di * Do + Do;
    const long long blocks = (n + NT - 1) / NT;
    sum_groups_kernel<<<blocks < 4096 ? blocks : 4096, NT, 0, s>>>(
        dst, static_cast<float*>(cc), n, groups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_sum_kernel<<<B, NT, 0, s>>>(pf, static_cast<float*>(out),
                                   grid.x * grid.y);
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
// The TPU wrapper pads T with id -1 and zero rows; here rows past T are
// masked inside the kernel (they load as 0 and never match), so any id
// value, -1 included, is a real token.
//
// What bounds it on this card: bytes, for the data it is run on.  The
// masked Gram route costs 2 T^2 D FLOP per example whatever the ids, but
// the function needs only the pairs of equal ids: with ids drawn from a
// large vocabulary that is about the diagonal, 2 T D per example, and the
// read of dy (B T D values) dominates.  With heavily repeated ids the
// pairs approach T^2 and the work approaches the Gram's.
//
// What the design does about it: gram_norm's blocking, one block per
// (i-tile, j-tile, example) of 64 x 64 token pairs, with the id mask
// applied to the dy dy^T tile before the block's fixed-order tree sum; a
// block first compares its 64 x 64 ids and, if no pair matches, writes a
// zero partial without touching dy, so random ids cost about the
// diagonal tiles only.  Partials go to a (B, nT, nT) scratch that
// gram_sum_kernel adds per example in a fixed order: no atomics, two runs
// are bitwise equal.  Not yet done: tensor cores, the Gram's symmetry,
// and a sort-based (segment-sum) route that reads dy once.
namespace {

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
  __shared__ float Si[BK][BT + 1];
  __shared__ float Sj[BK][BT + 1];
  __shared__ int idi[BT];
  __shared__ int idj[BT];
  __shared__ float red[NT];

  const int* idb = ids + (size_t)b * Tn;
  if (tid < BT) {
    const int t = bi * BT + tid;
    idi[tid] = t < Tn ? idb[t] : 0;
  } else if (tid < 2 * BT) {
    const int t = bj * BT + tid - BT;
    idj[tid - BT] = t < Tn ? idb[t] : 0;
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
      if (bi * BT + ri < Tn && bj * BT + cj < Tn && idi[ri] == idj[cj])
        match |= 1u << (4 * i + j);
    }
  }
  if (!__syncthreads_or(match != 0)) {
    if (tid == 0) partial[((size_t)b * nT + bi) * nT + bj] = 0.f;
    return;
  }
  float gy[4][4];
  gram_tile(dy + (size_t)b * Tn * D, Tn, D, bi * BT, bj * BT, Si, Sj, gy);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (match & (1u << (4 * i + j))) s += gy[i][j];
  red[tid] = s;
  block_tree_sum(red);
  if (tid == 0) partial[((size_t)b * nT + bi) * nT + bj] = red[0];
}

}  // namespace

// ids: (B, T) int32, dy: (B, T, D), contiguous, dy's type by is_bf16;
// partial: (B, nT, nT) f32 scratch with nT = ceil(T / 64); out: (B,) f32.
// Returns cudaGetLastError() after both launches (0 = launched).
extern "C" int repro_gram_norm_tokmask(const void* ids, const void* dy,
                                       void* partial, void* out, int B,
                                       int Tn, int D, int is_bf16,
                                       void* stream) {
  const int nT = (Tn + BT - 1) / BT;
  dim3 grid(nT, nT, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idp = static_cast<const int*>(ids);
  float* pf = static_cast<float*>(partial);
  if (is_bf16) {
    tokmask_partial_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        idp, static_cast<const __nv_bfloat16*>(dy), pf, Tn, D);
  } else {
    tokmask_partial_kernel<float><<<grid, NT, 0, s>>>(
        idp, static_cast<const float*>(dy), pf, Tn, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_sum_kernel<<<B, NT, 0, s>>>(pf, static_cast<float*>(out), nT * nT);
  return static_cast<int>(cudaGetLastError());
}
