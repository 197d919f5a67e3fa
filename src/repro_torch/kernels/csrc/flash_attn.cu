// Blockwise (flash) attention, forward and backward, as hand-written
// kernels for Hopper (sm_90a): causal or full GQA attention by online
// softmax, without the (T, S) score matrix in device memory.
//
// Replaces: src/repro/kernels/flash_attn.py
//   flash_fwd_wgmma, flash_fwd_kernel  <- _fwd_call / _flash_kernel  (o, lse)
//   flash_dq_wgmma, flash_dq_kernel    <- _bwd_call / _flash_dq_kernel  (dq)
//   flash_dkv_wgmma, flash_dkv_kernel  <- _bwd_call / _flash_dkv_kernel
//                                                              (dk, dv)
// launched by repro_flash_fwd and repro_flash_bwd (which = 1 or 2);
// repro_flash_design names the kernel a call takes.
//
// q is (B, T, H, hd), k and v are (B, S, Hkv, hd), do is (B, T, H, hd),
// all f32 or bf16, read through their (b, t, h) strides (the last axis
// is contiguous), so the (B, T, H, hd) layout of the model needs no
// transpose.  Query head h reads KV head h / rep (rep = H / Hkv).
// lse and delta are (B, H, T) f32; o and dq come out (B, T, H, hd), dk
// and dv (B, S, Hkv, hd), contiguous, in the inputs' dtype.
//
//   forward:  s = q.k^T * scale (-1e30 where a key lies past the query
//             under the causal mask), online softmax over key tiles with
//             (m, l, acc) in f32, P cast to v's dtype before P.V,
//             o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
//   dq:       P = exp(s - lse), dS = P * (dO.V^T - delta) * scale,
//             dq = sum over key tiles of dS.K (dS cast to k's dtype);
//   dk, dv:   dv = sum P^T.dO, dk = sum dS^T.Q over every query tile of
//             the rep query heads of one KV head, in order.
//
// Two designs (repro_flash_design; ops.flash_design names the same):
//   "wgmma"  bf16 inputs at head_dim 64 or 128, all three kernels: the
//            tensor cores, below;
//   "fma"    everything else: f32 inputs (the tensor cores would take
//            them as TF32, which misses the f32 lanes' rtol 1e-4) and
//            bf16 at head_dim 16 and 32 (no model here uses them).  It is
//            built for every dtype and head_dim, so that
//            repro_flash_fma_only can time it against the wgmma design.
//
// What bounds it on this card.  bf16 at Llama-3.2-1B's shape (B = 8,
// T = S = 1024, H = 32, hd = 64, causal): the forward is 34 GFLOP of
// tensor-core work (0.035 ms at 989 TFLOP/s) against 0.13 GB to move
// (0.040 ms at 3.35 TB/s), so bytes, barely; dq is 52 GFLOP (0.052 ms)
// against 0.17 GB (0.050 ms), and dk/dv 69 GFLOP (0.070 ms) against
// 0.2 GB, so operations.  All three sit near the ridge, so the products
// must run on the tensor cores and the tiles must arrive while the
// previous tile computes.  f32 inputs are bound by the 67 TFLOP/s of f32
// FMAs.
//
// The wgmma design (FlashAttention-3's forward, without warp
// specialisation):
//   * tiles are bf16 in shared memory with the 128-byte swizzle (the
//     16-byte chunk c of row r sits at chunk c ^ (r % 8); a 128-column
//     row is two 64-column halves, each its own block of rows), filled by
//     cp.async 16 bytes a thread with rows past the end zero-filled,
//     through a ring of stages (3 in the forward, 2 in dk/dv): tile
//     i + 1 loads while tile i computes;
//   * forward: one block of two warpgroups (64 query rows each) per
//     (128-row query tile, head, example), causal blocks heaviest first
//     (reversed blockIdx.x).  Q loads once; K and V tiles of 64 keys
//     go through a 3-stage ring.  S = Q.K^T is wgmma m64n64k16 with both
//     operands in shared memory; the online softmax runs on the
//     accumulator in registers (a row's max and sum reduce over the 4
//     lanes that hold it); P is rounded to bf16 once a tile, against the
//     running max, and repacked in registers as the A operand of
//     O += P.V (wgmma with A from registers, V read as an MN-major B).
//     S of tile j and P.V of tile j - 1 start together, so the
//     second runs during the softmax of the first.  Only diagonal and
//     ragged tiles are masked.  64 KB of shared memory at hd 64, 128 KB
//     at 128;
//   * dq: the forward's skeleton without the online softmax.  One block
//     of two warpgroups per (128-row query tile, head, example), causal
//     blocks heaviest first; Q and dO load once, the thread's lse and
//     delta rows stay in registers, K and V tiles of 64 keys ring through
//     3 stages.  S = Q.K^T and dP = dO.V^T (both operands in shared
//     memory), P = exp(S * scale - lse) straight from the saved lse,
//     dS = P * (dP - delta) * scale rounded to bf16 and repacked as the
//     A operand of dQ += dS.K (K read as an MN-major B, as the forward
//     reads V).  S and dP of tile j start together with dS.K of tile
//     j - 1, so dS.K runs on the tensor cores during tile j's
//     elementwise work.  dQ stays in f32 registers for the whole walk
//     and is written once.  80 KB of shared memory at hd 64, 160 KB at
//     128;
//   * dk/dv: one warpgroup per (64-key tile, KV head, example).  K and V
//     load once; Q, dO and the lse and delta rows of each (query head,
//     query tile) pair ring.  It computes the transposes directly:
//     S^T = K.Q^T and dP^T = V.dO^T (both operands in shared memory),
//     P^T = exp(S^T * scale - lse), dS^T = P^T * (dP^T - delta) * scale,
//     each rounded to bf16 and repacked as the A operand of
//     dV += P^T.dO and dK += dS^T.Q (A in registers, Q and dO read
//     MN-major).  dK and dV stay in registers for the whole walk.
//   Each output row belongs to one warpgroup and is summed in a fixed
//   order: no atomics, and two runs are bitwise equal.
//
// The fma design (the first port): one block of 256 threads per
// (64-row tile, head, example), 64 x 64 tiles staged in shared memory
// as f32 (rows padded by one float, so the column walks are free of
// bank conflicts), every product in f32 registers; the same loops, in
// the same order, and no atomics.  Both designs skip the key (query)
// tiles wholly past a block's causal diagonal, which changes nothing
// (their P is exactly 0).  The tile sizes differ from the TPU kernel's bq / bk
// (512); the wrapper keeps the bq / bk contract (query padding, the
// key-length check).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;    // rows of a tile (queries; keys in dk/dv)
constexpr int BN = 64;    // columns of a score tile
constexpr int NT = 256;   // threads: 16 x 16, 4 x 4 scores each
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16(v);
}
// v rounded to T and back (the kernels' casts before a product).
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return to_f32(from_f32<T>(v));
}

// Max / sum over the 16 lanes that share one score row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows [r0, r0 + BM) x hd of a (B, L, heads, hd) tensor at (b, head)
// into an f32 tile with row stride HD + 1; rows at or past L are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          long long sb, long long sl,
                                          long long sh, int b, int head,
                                          int r0, int L) {
  const T* base = src + (long long)b * sb + (long long)head * sh;
  for (int e = threadIdx.x; e < BM * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int l = r0 + r;
    dst[r * (HD + 1) + d] =
        l < L ? to_f32(base[(long long)l * sl + d]) : 0.f;
  }
}

// s[i][j] = A[ty + 16 i] . Bt[tx + 16 j] over hd, for f32 tiles with
// row stride HD + 1.
template <int HD>
__device__ __forceinline__ void tile_dots(const float* A, const float* Bt,
                                          int ty, int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bt[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// ---------------------------------------------------------------------------
// The fma design.  Forward: one block per (query tile, head, example).

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, long long qb, long long qt,
                 long long qh, const T* __restrict__ k, long long kb,
                 long long kt, long long kh, const T* __restrict__ v,
                 long long vb, long long vt, long long vh,
                 T* __restrict__ o, float* __restrict__ lse, int T_, int S,
                 int H, int rep, int causal, float scale) {
  constexpr int DJ = HD / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ks = Qs + BM * (HD + 1);
  float* Vs = Ks + BN * (HD + 1);
  float* Ps = Vs + BN * (HD + 1);  // BM x (BN + 1)
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD>(Qs, q, qb, qt, qh, b, h, q0, T_);
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int kend = causal ? min(S, q0 + BM) : S;
  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps are consumed
    load_tile<T, HD>(Ks, k, kb, kt, kh, b, hk, k0, S);
    load_tile<T, HD>(Vs, v, vb, vt, vh, b, hk, k0, S);
    __syncthreads();
    float s[4][4];
    tile_dots<HD>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (causal && kk > t) val = NEG;
        s[i][j] = val;
        if (kk < S) mx = fmaxf(mx, val);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tx + 16 * j;
        const float p = kk < S ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = round_as<T>(p);
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    const int kn = min(BN, S - k0);
    for (int c = 0; c < kn; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * (HD + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BN + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * T_ + t) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / lc);
    if (tx == 0) lse[((long long)b * H + h) * T_ + t] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (query tile, head, example), looping over key tiles.

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, long long qb, long long qt,
                long long qh, const T* __restrict__ k, long long kb,
                long long kt, long long kh, const T* __restrict__ v,
                long long vb, long long vt, long long vh,
                const T* __restrict__ dout, long long db, long long dt,
                long long dh, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int T_,
                int S, int H, int rep, int causal, float scale) {
  constexpr int DJ = HD / 16;
  extern __shared__ float sm[];
  float* Qs = sm;
  float* Ds = Qs + BM * (HD + 1);   // dO tile
  float* Ks = Ds + BM * (HD + 1);
  float* Vs = Ks + BN * (HD + 1);
  float* Ss = Vs + BN * (HD + 1);   // dS tile, BM x (BN + 1)
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD>(Qs, q, qb, qt, qh, b, h, q0, T_);
  load_tile<T, HD>(Ds, dout, db, dt, dh, b, h, q0, T_);
  float lr[4], dr[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    const long long row = ((long long)b * H + h) * T_ + t;
    lr[i] = t < T_ ? lse[row] : 0.f;
    dr[i] = t < T_ ? delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  const int kend = causal ? min(S, q0 + BM) : S;
  for (int k0 = 0; k0 < kend; k0 += BN) {
    __syncthreads();
    load_tile<T, HD>(Ks, k, kb, kt, kh, b, hk, k0, S);
    load_tile<T, HD>(Vs, v, vb, vt, vh, b, hk, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<HD>(Qs, Ks, ty, tx, s);
    tile_dots<HD>(Ds, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (causal && kk > t) val = NEG;
        const float p = kk < S ? expf(val - lr[i]) : 0.f;
        const float ds = p * (dp[i][j] - dr[i]) * scale;
        Ss[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = round_as<T>(ds);
      }
    }
    __syncthreads();
    const int kn = min(BN, S - k0);
    for (int c = 0; c < kn; ++c) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * (HD + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float g = Ss[(ty + 16 * i) * (BN + 1) + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(g, kv[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_) continue;
    T* row = dq + (((long long)b * T_ + t) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (key tile, KV head, example), walking the
// (query head of the group, query tile) pairs in order.

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, long long qb, long long qt,
                 long long qh, const T* __restrict__ k, long long kb,
                 long long kt, long long kh, const T* __restrict__ v,
                 long long vb, long long vt, long long vh,
                 const T* __restrict__ dout, long long db, long long dt,
                 long long dh, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int T_, int S, int H, int rep,
                 int causal, float scale) {
  constexpr int DJ = HD / 16;
  extern __shared__ float sm[];
  float* Ks = sm;
  float* Vs = Ks + BN * (HD + 1);
  float* Qs = Vs + BN * (HD + 1);
  float* Ds = Qs + BM * (HD + 1);   // dO tile
  float* Ps = Ds + BM * (HD + 1);   // BM x (BN + 1), [query][key]
  float* Ss = Ps + BM * (BN + 1);   // dS, same layout
  float* Lq = Ss + BM * (BN + 1);   // lse of the query tile
  float* Dq = Lq + BM;              // delta of the query tile
  const int k0 = blockIdx.x * BN, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / rep;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, HD>(Ks, k, kb, kt, kh, b, hk, k0, S);
  load_tile<T, HD>(Vs, v, vb, vt, vh, b, hk, k0, S);
  float ak[4][DJ], av[4][DJ];   // rows: keys ty + 16 i; columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) ak[i][j] = av[i][j] = 0.f;
  const int qstart = causal ? (k0 / BM) * BM : 0;
  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int q0 = qstart; q0 < T_; q0 += BM) {
      __syncthreads();  // the previous pair's tiles are consumed
      load_tile<T, HD>(Qs, q, qb, qt, qh, b, h, q0, T_);
      load_tile<T, HD>(Ds, dout, db, dt, dh, b, h, q0, T_);
      for (int e = threadIdx.x; e < BM; e += NT) {
        const int t = q0 + e;
        const long long row = ((long long)b * H + h) * T_ + t;
        Lq[e] = t < T_ ? lse[row] : 0.f;
        Dq[e] = t < T_ ? delta[row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      tile_dots<HD>(Qs, Ks, ty, tx, s);   // rows: queries, columns: keys
      tile_dots<HD>(Ds, Vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = ty + 16 * i;
        const int t = q0 + qi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = k0 + tx + 16 * j;
          float val = s[i][j] * scale;
          if (causal && kk > t) val = NEG;
          const bool live = t < T_ && kk < S;
          const float p = live ? expf(val - Lq[qi]) : 0.f;
          const float ds = p * (dp[i][j] - Dq[qi]) * scale;
          Ps[qi * (BN + 1) + tx + 16 * j] = round_as<T>(p);
          Ss[qi * (BN + 1) + tx + 16 * j] = round_as<T>(ds);
        }
      }
      __syncthreads();
      const int qn = min(BM, T_ - q0);
      for (int c = 0; c < qn; ++c) {
        float qv[DJ], gv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          qv[j] = Qs[c * (HD + 1) + tx + 16 * j];
          gv[j] = Ds[c * (HD + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[c * (BN + 1) + ty + 16 * i];
          const float g = Ss[c * (BN + 1) + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            av[i][j] = fmaf(p, gv[j], av[i][j]);
            ak[i][j] = fmaf(g, qv[j], ak[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_ = k0 + ty + 16 * i;
    if (s_ >= S) continue;
    const long long off = (((long long)b * S + s_) * Hkv + hk) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = from_f32<T>(ak[i][j]);
      dv[off + tx + 16 * j] = from_f32<T>(av[i][j]);
    }
  }
}

constexpr size_t fwd_smem(int hd) {
  return sizeof(float) * (size_t)(BM * (hd + 1) + 2 * BN * (hd + 1) +
                                  BM * (BN + 1));
}
constexpr size_t dq_smem(int hd) {
  return sizeof(float) * (size_t)(2 * BM * (hd + 1) + 2 * BN * (hd + 1) +
                                  BM * (BN + 1));
}
constexpr size_t dkv_smem(int hd) {
  return sizeof(float) * (size_t)(2 * BN * (hd + 1) + 2 * BM * (hd + 1) +
                                  2 * BM * (BN + 1) + 2 * BM);
}

// ---------------------------------------------------------------------------
// The wgmma design: bf16 inputs, head_dim 64 or 128.

namespace wg {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FWD_BQ = 128;  // query rows of a forward block (2 warpgroups)
constexpr int FWD_NT = 256;
constexpr int FWD_STAGES = 3;  // K / V ring of the forward
constexpr int TILE = 64;     // key rows of a K / V tile; query rows in dk/dv
constexpr int DKV_NT = 128;

using namespace hopper;

// Rows [r0, r0 + R) x HD of a bf16 tensor (row stride ld elements, row 0
// at src) into the swizzled tile at dst; rows at or past L are zero.
template <int R, int HD, int NTH>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          long long ld, int r0, int L) {
  constexpr int CPR = HD / 8;
  static_assert((R * CPR) % NTH == 0, "chunks must divide over threads");
#pragma unroll
  for (int i = 0; i < R * CPR / NTH; ++i) {
    const int e = threadIdx.x + i * NTH;
    const int r = e / CPR, c = e % CPR;
    const int row = r0 + r;
    const bf16* g = src + (long long)min(row, L - 1) * ld + c * 8;
    cp_async16(dst + chunk_off<R>(r, c), g, row < L ? 16 : 0);
  }
}

// 2^x on the special-function unit (subnormal results flush to 0: a P
// that small is 0 against the row's max).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of a product over the 64 columns of a 64 x 64
// accumulator: the accumulator's fragment (rows r, r + 8; columns
// 8 j + 2 (lane % 4) + {0, 1}) is the A fragment of k-step j / 2, so the
// repack is a rounding to bf16 in place.
__device__ __forceinline__ void to_a(const float (&d)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

template <int HD>
constexpr int fwd_smem() {
  // Q, the (K, V) ring, alignment
  return (FWD_BQ + 2 * FWD_STAGES * TILE) * HD * 2 + 1024;
}
template <int HD>
constexpr int dq_smem() {
  // Q, dO, the (K, V) ring, alignment
  return (2 * FWD_BQ + 2 * FWD_STAGES * TILE) * HD * 2 + 1024;
}
template <int HD>
constexpr int dkv_smem() {
  return 6 * TILE * HD * 2 + 2 * 2 * TILE * 4 + 1024;  // K, V, 2 x (Q, dO),
}                                                      // 2 x (lse, delta)

// Forward: one block per (128-row query tile, head, example).
template <int HD>
__global__ void __launch_bounds__(FWD_NT, HD == 64 ? 2 : 1)
flash_fwd_wgmma(const bf16* __restrict__ q, long long qb, long long qt,
                long long qh, const bf16* __restrict__ k, long long kb,
                long long kt, long long kh, const bf16* __restrict__ v,
                long long vb, long long vt, long long vh,
                bf16* __restrict__ o, float* __restrict__ lse, int T_, int S,
                int H, int rep, int causal, float scale) {
  constexpr int KT = TILE * HD * 2;  // bytes of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Ks = Qs + FWD_BQ * HD * 2;  // stage st at Ks + st * KT
  const uint32_t Vs = Ks + FWD_STAGES * KT;
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * FWD_BQ, h = blockIdx.y, b = blockIdx.z;
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int qw = q0 + 64 * wgi;                // this warpgroup's rows
  const int row0 = qw + 16 * warp + lane / 4;  // this thread's: row0, +8
  const int col0 = 2 * (lane % 4);             // columns col0, +1 of 8

  const bf16* kp = k + b * kb + (h / rep) * kh;
  const bf16* vp = v + b * vb + (h / rep) * vh;
  load_tile<FWD_BQ, HD, FWD_NT>(Qs, q + b * qb + h * qh, qt, q0, T_);
  load_tile<TILE, HD, FWD_NT>(Ks, kp, kt, 0, S);
  load_tile<TILE, HD, FWD_NT>(Vs, vp, vt, 0, S);
  cp_commit();
  const int kend = causal ? min(S, q0 + FWD_BQ) : S;
  const int ntiles = (kend + TILE - 1) / TILE;

  float acc[HD / 2];  // O, unnormalised
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float s[32];        // S of the current tile, then its P in f32
  uint32_t pa[4][4] = {};  // P of the previous tile, bf16 A fragments
  // m is the running max of the raw scores q.k (scale > 0 commutes with
  // max); P = 2^(s * c - m * c) with c = scale * log2(e).
  const float c = scale * LOG2E;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];

  // Tile j has landed for every thread and tile j - 2 is consumed, so
  // its stage takes tile j + 1.
  auto ring = [&](int j) {
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (j + 1 < ntiles) {
      const int nx = (j + 1) % FWD_STAGES;
      load_tile<TILE, HD, FWD_NT>(Ks + nx * KT, kp, kt, (j + 1) * TILE, S);
      load_tile<TILE, HD, FWD_NT>(Vs + nx * KT, vp, vt, (j + 1) * TILE, S);
      cp_commit();
    }
  };
  // Starts S = Q.K_j^T into s.
  auto start_s = [&](int j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    reg_fence(s);
    reg_fence(acc);
    reg_fence(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(s, kmajor<FWD_BQ>(Qs, 64 * wgi, kk),
             kmajor<TILE>(Ks + (j % FWD_STAGES) * KT, 0, kk));
    wg_commit();
  };
  // Starts O += P.V_j from pa.
  auto start_pv = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(acc, pa[kk], mnmajor<TILE>(Vs + (j % FWD_STAGES) * KT, kk));
    wg_commit();
  };
  // The online softmax of tile j on s: (m, l) updated, alpha the factor
  // that carries O to the new max, P left in s.  `masked` (a
  // std::bool_constant) is true only for the diagonal tile under the
  // causal mask and a ragged last tile: the other tiles run no mask code.
  auto softmax = [&](int j, auto masked) {
    const int k0 = j * TILE;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // the last column of the tile that is a key, and (causal) that
      // this row may see
      const int last_key = S - 1 - k0, last_seen = row0 + 8 * rr - k0;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& val = s[4 * jj + 2 * rr + e];
          if constexpr (decltype(masked)::value) {
            const int col = 8 * jj + col0 + e;
            if (col > last_key)
              val = -INFINITY;  // no key: out of max and sum
            else if (causal && col > last_seen)
              val = NEG;
          }
          mx = fmaxf(mx, val);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float mc = m_new * c;
      alpha[rr] = ex2((m[rr] - m_new) * c);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[4 * jj + 2 * rr + e], c, -mc));
          s[4 * jj + 2 * rr + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[rr] = l[rr] * alpha[rr] + rs;
      m[rr] = m_new;
    }
  };

  // Step j starts S_j and O += P_{j-1}.V_{j-1} together, so the second
  // runs on the tensor cores during the softmax of the first.  Both
  // warpgroups run every tile of the block: the one tile wholly past the
  // first warpgroup's diagonal is masked to P = 0 and changes nothing,
  // and no product sits in a branch that could diverge (ptxas would
  // serialize the wgmma pipeline).
  auto softmax_tile = [&](int j) {
    const int k0 = j * TILE;
    if ((causal && k0 + TILE - 1 > qw) || k0 + TILE > S)
      softmax(j, std::true_type{});
    else
      softmax(j, std::false_type{});
  };
  ring(0);
  start_s(0);
  wg_wait<0>();
  reg_fence(s);
  softmax_tile(0);
  to_a(s, pa);  // P in bf16, against the running max
  for (int j = 1; j < ntiles; ++j) {
    ring(j);
    start_s(j);
    start_pv(j - 1);
    wg_wait<1>();  // S_j is done, P_{j-1}.V_{j-1} may still run
    reg_fence(s);
    softmax_tile(j);
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    to_a(s, pa);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[4 * i] *= alpha[0];
      acc[4 * i + 1] *= alpha[0];
      acc[4 * i + 2] *= alpha[1];
      acc[4 * i + 3] *= alpha[1];
    }
  }
  reg_fence(acc);
  reg_fence(pa);
  wg_fence();
  start_pv(ntiles - 1);
  wg_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = row0 + 8 * rr;
    if (t >= T_) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
    bf16* orow = o + (((long long)b * T_ + t) * H + h) * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * rr] / lc,
                                acc[4 * j + 2 * rr + 1] / lc);
    if (lane % 4 == 0)
      lse[((long long)b * H + h) * T_ + t] = m[rr] * scale + logf(lc);
  }
}

// dq: one block per (128-row query tile, head, example), walking the key
// tiles in order.
template <int HD>
__global__ void __launch_bounds__(FWD_NT, 1)
flash_dq_wgmma(const bf16* __restrict__ q, long long qb, long long qt,
               long long qh, const bf16* __restrict__ k, long long kb,
               long long kt, long long kh, const bf16* __restrict__ v,
               long long vb, long long vt, long long vh,
               const bf16* __restrict__ dout, long long db, long long dt,
               long long dh, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dq, int T_,
               int S, int H, int rep, int causal, float scale) {
  constexpr int KT = TILE * HD * 2;  // bytes of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Ds = Qs + FWD_BQ * HD * 2;  // dO
  const uint32_t Ks = Ds + FWD_BQ * HD * 2;  // stage st at Ks + st * KT
  const uint32_t Vs = Ks + FWD_STAGES * KT;
  const int qtile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qtile * FWD_BQ, h = blockIdx.y, b = blockIdx.z;
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int qw = q0 + 64 * wgi;                // this warpgroup's rows
  const int row0 = qw + 16 * warp + lane / 4;  // this thread's: row0, +8
  const int col0 = 2 * (lane % 4);             // columns col0, +1 of 8

  const bf16* kp = k + b * kb + (h / rep) * kh;
  const bf16* vp = v + b * vb + (h / rep) * vh;
  load_tile<FWD_BQ, HD, FWD_NT>(Qs, q + b * qb + h * qh, qt, q0, T_);
  load_tile<FWD_BQ, HD, FWD_NT>(Ds, dout + b * db + h * dh, dt, q0, T_);
  load_tile<TILE, HD, FWD_NT>(Ks, kp, kt, 0, S);
  load_tile<TILE, HD, FWD_NT>(Vs, vp, vt, 0, S);
  cp_commit();
  const int kend = causal ? min(S, q0 + FWD_BQ) : S;
  const int ntiles = (kend + TILE - 1) / TILE;

  // P = 2^(s * c - lse * log2(e)) with c = scale * log2(e); rows past T
  // have Q = dO = 0 and lse = delta = 0, so their dS is 0.
  const float c = scale * LOG2E;
  float lq[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = row0 + 8 * rr;
    const long long row = ((long long)b * H + h) * T_ + t;
    lq[rr] = t < T_ ? lse[row] * LOG2E : 0.f;
    dl[rr] = t < T_ ? delta[row] : 0.f;
  }
  float acc[HD / 2];  // dQ
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];     // S and dP of the current tile, then P and dS
  uint32_t da[4][4] = {};  // dS of the previous tile, bf16 A fragments

  // Tile j has landed for every thread and tile j - 2 is consumed, so
  // its stage takes tile j + 1.
  auto ring = [&](int j) {
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();
    if (j + 1 < ntiles) {
      const int nx = (j + 1) % FWD_STAGES;
      load_tile<TILE, HD, FWD_NT>(Ks + nx * KT, kp, kt, (j + 1) * TILE, S);
      load_tile<TILE, HD, FWD_NT>(Vs + nx * KT, vp, vt, (j + 1) * TILE, S);
      cp_commit();
    }
  };
  // Starts S = Q.K_j^T into s and dP = dO.V_j^T into dp.
  auto start_sdp = [&](int j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    reg_fence(acc);
    reg_fence(da);
    wg_fence();
    const uint32_t ks = Ks + (j % FWD_STAGES) * KT;
    const uint32_t vs = Vs + (j % FWD_STAGES) * KT;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(s, kmajor<FWD_BQ>(Qs, 64 * wgi, kk), kmajor<TILE>(ks, 0, kk));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(dp, kmajor<FWD_BQ>(Ds, 64 * wgi, kk), kmajor<TILE>(vs, 0, kk));
    wg_commit();
  };
  // Starts dQ += dS.K_j from da.
  auto start_dq = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs(acc, da[kk], mnmajor<TILE>(Ks + (j % FWD_STAGES) * KT, kk));
    wg_commit();
  };
  // P and dS of tile j into s and dp.  `masked` (a std::bool_constant) is
  // true only for the diagonal tile under the causal mask and a ragged
  // last tile: the other tiles run no mask code.
  auto grads = [&](int j, auto masked) {
    const int k0 = j * TILE;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      // the last column of the tile that is a key, and (causal) that
      // this row may see
      const int last_key = S - 1 - k0, last_seen = row0 + 8 * rr - k0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * rr + e;
          float p;
          if constexpr (decltype(masked)::value) {
            const int col = 8 * jj + col0 + e;
            const float val = causal && col > last_seen ? NEG : s[i];
            p = col > last_key ? 0.f : ex2(fmaf(val, c, -lq[rr]));
          } else {
            p = ex2(fmaf(s[i], c, -lq[rr]));
          }
          dp[i] = p * (dp[i] - dl[rr]) * scale;
        }
    }
  };
  auto grads_tile = [&](int j) {
    const int k0 = j * TILE;
    if ((causal && k0 + TILE - 1 > qw) || k0 + TILE > S)
      grads(j, std::true_type{});
    else
      grads(j, std::false_type{});
  };

  // Step j starts S_j, dP_j and dQ += dS_{j-1}.K_{j-1} together, so the
  // third runs on the tensor cores during the elementwise work of the
  // first two.  As in the forward, both warpgroups run every tile of the
  // block (the one tile wholly past the first warpgroup's diagonal gives
  // dS = 0).
  ring(0);
  start_sdp(0);
  wg_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  grads_tile(0);
  to_a(dp, da);  // dS in bf16
  for (int j = 1; j < ntiles; ++j) {
    ring(j);
    start_sdp(j);
    start_dq(j - 1);
    wg_wait<1>();  // S_j and dP_j are done, dS_{j-1}.K_{j-1} may still run
    reg_fence(s);
    reg_fence(dp);
    grads_tile(j);
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(da);
    to_a(dp, da);
  }
  reg_fence(acc);
  reg_fence(da);
  wg_fence();
  start_dq(ntiles - 1);
  wg_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = row0 + 8 * rr;
    if (t >= T_) continue;
    bf16* row = dq + (((long long)b * T_ + t) * H + h) * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
  }
}

// dk, dv: one warpgroup per (64-key tile, KV head, example), walking the
// (query head of the group, query tile) pairs in order.
template <int HD>
__global__ void __launch_bounds__(DKV_NT, 1)
flash_dkv_wgmma(const bf16* __restrict__ q, long long qb, long long qt,
                long long qh, const bf16* __restrict__ k, long long kb,
                long long kt, long long kh, const bf16* __restrict__ v,
                long long vb, long long vt, long long vh,
                const bf16* __restrict__ dout, long long db, long long dt,
                long long dh, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int T_, int S, int H, int rep,
                int causal, float scale) {
  constexpr int TB = TILE * HD * 2;  // bytes of a 64-row tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t Ks = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t Vs = Ks + TB;
  const uint32_t Qs = Vs + TB;      // stage st at Qs + st * TB
  const uint32_t Ds = Qs + 2 * TB;  // dO, stage st at Ds + st * TB
  const uint32_t Rs = Ds + 2 * TB;  // stage st: lse[64], delta[64]
  const float* rows =
      reinterpret_cast<const float*>(smem_raw + (Rs - smem_u32(smem_raw)));
  const int k0 = blockIdx.x * TILE, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's: key0, +8
  const int col0 = 2 * (lane % 4);             // columns col0, +1 of 8

  load_tile<TILE, HD, DKV_NT>(Ks, k + b * kb + hk * kh, kt, k0, S);
  load_tile<TILE, HD, DKV_NT>(Vs, v + b * vb + hk * vh, vt, k0, S);
  const int qstart = causal ? k0 : 0;  // the diagonal query tile
  const int nqt = qstart < T_ ? (T_ - qstart + TILE - 1) / TILE : 0;
  const int npairs = rep * nqt;
  // Pair i: query head hk * rep + i / nqt, query tile qstart + 64 (i % nqt).
  auto load_pair = [&](int i, int st) {
    const int h = hk * rep + i / nqt, q0 = qstart + TILE * (i % nqt);
    load_tile<TILE, HD, DKV_NT>(Qs + st * TB, q + b * qb + h * qh, qt, q0,
                                T_);
    load_tile<TILE, HD, DKV_NT>(Ds + st * TB, dout + b * db + h * dh, dt, q0,
                                T_);
    const int t = q0 + (threadIdx.x & (TILE - 1));
    const float* src = (threadIdx.x < TILE ? lse : delta) +
                       ((long long)b * H + h) * T_ + min(t, T_ - 1);
    cp_async4(Rs + st * 2 * TILE * 4 + threadIdx.x * 4, src,
              t < T_ ? 4 : 0);
  };
  if (npairs > 0) load_pair(0, 0);
  cp_commit();

  float ak[HD / 2], av[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) ak[i] = av[i] = 0.f;
  const float c = scale * LOG2E;  // P = 2^(s * c - lse * log2(e))
  for (int it = 0; it < npairs; ++it) {
    const int st = it & 1;
    cp_wait<0>();  // pair it has landed
    fence_async_smem();
    __syncthreads();  // ... for every thread, and pair it - 1 is consumed
    if (it + 1 < npairs) {  // so its stage takes pair it + 1
      load_pair(it + 1, st ^ 1);
      cp_commit();
    }
    const int q0 = qstart + TILE * (it % nqt);
    const uint32_t qs = Qs + st * TB, ds = Ds + st * TB;
    const float* lr = rows + st * 2 * TILE;
    const float* dr = lr + TILE;
    float s[32], dp[32];  // S^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(s, kmajor<TILE>(Ks, 0, kk), kmajor<TILE>(qs, 0, kk));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      mma_ss(dp, kmajor<TILE>(Vs, 0, kk), kmajor<TILE>(ds, 0, kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // P^T and dS^T into s and dp; `masked` (a std::bool_constant) is
    // true only for the diagonal query tile under the causal mask and
    // ragged tiles: the other pairs run no mask code.
    auto grads = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * j + col0 + e;  // query within the tile
          const float lq = lr[qi] * LOG2E, dq_ = dr[qi];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = 4 * j + 2 * rr + e;
            float p;
            if constexpr (decltype(masked)::value) {
              const int key = key0 + 8 * rr, t = q0 + qi;
              const float val = causal && key > t ? NEG : s[i];
              p = t < T_ && key < S ? ex2(fmaf(val, c, -lq)) : 0.f;
            } else {
              p = ex2(fmaf(s[i], c, -lq));
            }
            dp[i] = p * (dp[i] - dq_) * scale;
            s[i] = p;
          }
        }
    };
    if ((causal && k0 + TILE - 1 > q0) || q0 + TILE > T_ || k0 + TILE > S)
      grads(std::true_type{});
    else
      grads(std::false_type{});
    uint32_t pa[4][4], da[4][4];
    to_a(s, pa);   // P^T in bf16
    to_a(dp, da);  // dS^T in bf16
    reg_fence(pa);
    reg_fence(da);
    reg_fence(av);
    reg_fence(ak);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(av, pa[kk], mnmajor<TILE>(ds, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs(ak, da[kk], mnmajor<TILE>(qs, kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(av);
    reg_fence(ak);
  }
  cp_wait<0>();  // K and V, when no query tile reaches this key tile
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = key0 + 8 * rr;
    if (key >= S) continue;
    const long long off = (((long long)b * S + key) * Hkv + hk) * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
          __floats2bfloat162_rn(ak[4 * j + 2 * rr], ak[4 * j + 2 * rr + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
          __floats2bfloat162_rn(av[4 * j + 2 * rr], av[4 * j + 2 * rr + 1]);
    }
  }
}

}  // namespace wg

struct Args {
  const void *q, *k, *v, *dout;
  long long qs[3], ks[3], vs[3], ds[3];
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, Tq, Sk, H, rep, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_fwd(const Args& a) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = fwd_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + BM - 1) / BM, a.H, a.B);
  kern<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, a.qs[0], a.qs[1], a.qs[2], (const T*)a.k, a.ks[0],
      a.ks[1], a.ks[2], (const T*)a.v, a.vs[0], a.vs[1], a.vs[2], (T*)a.o,
      a.lse_out, a.Tq, a.Sk, a.H, a.rep, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const Args& a) {
  auto kern = flash_dq_kernel<T, HD>;
  const size_t smem = dq_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + BM - 1) / BM, a.H, a.B);
  kern<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, a.qs[0], a.qs[1], a.qs[2], (const T*)a.k, a.ks[0],
      a.ks[1], a.ks[2], (const T*)a.v, a.vs[0], a.vs[1], a.vs[2],
      (const T*)a.dout, a.ds[0], a.ds[1], a.ds[2], a.lse_in, a.delta,
      (T*)a.dq, a.Tq, a.Sk, a.H, a.rep, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const Args& a) {
  auto kern = flash_dkv_kernel<T, HD>;
  const size_t smem = dkv_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + BN - 1) / BN, a.H / a.rep, a.B);
  kern<<<grid, NT, smem, a.stream>>>(
      (const T*)a.q, a.qs[0], a.qs[1], a.qs[2], (const T*)a.k, a.ks[0],
      a.ks[1], a.ks[2], (const T*)a.v, a.vs[0], a.vs[1], a.vs[2],
      (const T*)a.dout, a.ds[0], a.ds[1], a.ds[2], a.lse_in, a.delta,
      (T*)a.dk, (T*)a.dv, a.Tq, a.Sk, a.H, a.rep, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_fwd_wgmma(const Args& a) {
  auto kern = wg::flash_fwd_wgmma<HD>;
  const int smem = wg::fwd_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + wg::FWD_BQ - 1) / wg::FWD_BQ, a.H, a.B);
  kern<<<grid, wg::FWD_NT, smem, a.stream>>>(
      (const wg::bf16*)a.q, a.qs[0], a.qs[1], a.qs[2], (const wg::bf16*)a.k,
      a.ks[0], a.ks[1], a.ks[2], (const wg::bf16*)a.v, a.vs[0], a.vs[1],
      a.vs[2], (wg::bf16*)a.o, a.lse_out, a.Tq, a.Sk, a.H, a.rep, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_wgmma(const Args& a) {
  auto kern = wg::flash_dq_wgmma<HD>;
  const int smem = wg::dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Tq + wg::FWD_BQ - 1) / wg::FWD_BQ, a.H, a.B);
  kern<<<grid, wg::FWD_NT, smem, a.stream>>>(
      (const wg::bf16*)a.q, a.qs[0], a.qs[1], a.qs[2], (const wg::bf16*)a.k,
      a.ks[0], a.ks[1], a.ks[2], (const wg::bf16*)a.v, a.vs[0], a.vs[1],
      a.vs[2], (const wg::bf16*)a.dout, a.ds[0], a.ds[1], a.ds[2],
      a.lse_in, a.delta, (wg::bf16*)a.dq, a.Tq, a.Sk, a.H, a.rep, a.causal,
      a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv_wgmma(const Args& a) {
  auto kern = wg::flash_dkv_wgmma<HD>;
  const int smem = wg::dkv_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sk + wg::TILE - 1) / wg::TILE, a.H / a.rep, a.B);
  kern<<<grid, wg::DKV_NT, smem, a.stream>>>(
      (const wg::bf16*)a.q, a.qs[0], a.qs[1], a.qs[2], (const wg::bf16*)a.k,
      a.ks[0], a.ks[1], a.ks[2], (const wg::bf16*)a.v, a.vs[0], a.vs[1],
      a.vs[2], (const wg::bf16*)a.dout, a.ds[0], a.ds[1], a.ds[2],
      a.lse_in, a.delta, (wg::bf16*)a.dk, (wg::bf16*)a.dv, a.Tq, a.Sk, a.H,
      a.rep, a.causal, a.scale);
  return (int)cudaGetLastError();
}

// The wgmma design takes bf16 calls of every kernel at head_dim 64 and
// 128; every other call takes the fma design.
bool wgmma_design(int hd, int bf16) {
  return bf16 && (hd == 64 || hd == 128);
}

// cp.async moves 16 bytes: rows must start 16-byte aligned.
bool rows_aligned(const void* p, const long long* st) {
  return (uintptr_t)p % 16 == 0 && st[0] % 8 == 0 && st[1] % 8 == 0 &&
         st[2] % 8 == 0;
}

// The fma design; which: 0 forward, 1 dq, 2 dk/dv.
template <typename T, int HD>
int launch_fma(int which, const Args& a) {
  if (which == 1) return launch_dq<T, HD>(a);
  return which == 0 ? launch_fwd<T, HD>(a) : launch_dkv<T, HD>(a);
}

// Set by repro_flash_fma_only: every call takes the fma design.
bool fma_only = false;

template <typename T>
int dispatch(int which, int hd, const Args& a) {
#define REPRO_FLASH_CASE(HD) \
  case HD:                   \
    return launch_fma<T, HD>(which, a);
  switch (hd) {
    REPRO_FLASH_CASE(16)
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

int run(int which, int hd, int bf16, const Args& a) {
  if (a.B == 0 || a.Tq == 0 || a.Sk == 0 || a.H == 0) return 0;
  if (!fma_only && wgmma_design(hd, bf16)) {
    if (!rows_aligned(a.q, a.qs) || !rows_aligned(a.k, a.ks) ||
        !rows_aligned(a.v, a.vs) ||
        (which != 0 && !rows_aligned(a.dout, a.ds)))
      return (int)cudaErrorMisalignedAddress;
    if (which == 0)
      return hd == 64 ? launch_fwd_wgmma<64>(a) : launch_fwd_wgmma<128>(a);
    if (which == 1)
      return hd == 64 ? launch_dq_wgmma<64>(a) : launch_dq_wgmma<128>(a);
    return hd == 64 ? launch_dkv_wgmma<64>(a) : launch_dkv_wgmma<128>(a);
  }
  return bf16 ? dispatch<__nv_bfloat16>(which, hd, a)
              : dispatch<float>(which, hd, a);
}

}  // namespace

extern "C" {

// 1 if a call (which: 0 forward, 1 dq, 2 dk/dv) takes the wgmma design,
// 0 if the fma design.
int repro_flash_design(int which, int hd, int bf16) {
  (void)which;  // every kernel has both designs
  return wgmma_design(hd, bf16) ? 1 : 0;
}

// on = 1: every later call takes the fma design, until a call with
// on = 0.  It times the fma design against the wgmma design on the same
// inputs (chip_smoke.py); the wrappers in ops.py never set it.
int repro_flash_fma_only(int on) {
  fma_only = on != 0;
  return 0;
}

// o (B, T, H, hd) and lse (B, H, T) f32 from q, k, v.
int repro_flash_fwd(const void* q, long long qb, long long qt, long long qh,
                    const void* k, long long kb, long long kt, long long kh,
                    const void* v, long long vb, long long vt, long long vh,
                    void* o, float* lse, int B, int T, int S, int H, int Hkv,
                    int hd, int causal, int bf16, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v;
  a.qs[0] = qb; a.qs[1] = qt; a.qs[2] = qh;
  a.ks[0] = kb; a.ks[1] = kt; a.ks[2] = kh;
  a.vs[0] = vb; a.vs[1] = vt; a.vs[2] = vh;
  a.o = o; a.lse_out = lse;
  a.B = B; a.Tq = T; a.Sk = S; a.H = H; a.rep = H / Hkv; a.causal = causal;
  a.scale = 1.0f / sqrtf((float)hd);
  a.stream = (cudaStream_t)stream;
  return run(0, hd, bf16, a);
}

// dq (B, T, H, hd) (which = 1), or dk and dv (B, S, Hkv, hd) (which = 2),
// from q, k, v, dO, lse and delta = rowsum(dO * O) (B, H, T) f32.
int repro_flash_bwd(int which, const void* q, long long qb, long long qt,
                    long long qh, const void* k, long long kb, long long kt,
                    long long kh, const void* v, long long vb, long long vt,
                    long long vh, const void* dout, long long db,
                    long long dt, long long dh, const float* lse,
                    const float* delta, void* dq, void* dk, void* dv, int B,
                    int T, int S, int H, int Hkv, int hd, int causal,
                    int bf16, void* stream) {
  if (which != 1 && which != 2) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.qs[0] = qb; a.qs[1] = qt; a.qs[2] = qh;
  a.ks[0] = kb; a.ks[1] = kt; a.ks[2] = kh;
  a.vs[0] = vb; a.vs[1] = vt; a.vs[2] = vh;
  a.ds[0] = db; a.ds[1] = dt; a.ds[2] = dh;
  a.lse_in = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.Tq = T; a.Sk = S; a.H = H; a.rep = H / Hkv; a.causal = causal;
  a.scale = 1.0f / sqrtf((float)hd);
  a.stream = (cudaStream_t)stream;
  return run(which, hd, bf16, a);
}

}  // extern "C"
