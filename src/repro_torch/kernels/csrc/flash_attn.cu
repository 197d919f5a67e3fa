// Blockwise (flash) attention, forward and backward, as hand-written
// kernels for Hopper (sm_90a): causal or full GQA attention by online
// softmax, without the (T, S) score matrix in device memory.
//
// Replaces: src/repro/kernels/flash_attn.py
//   flash_fwd_kernel  <- _fwd_call / _flash_kernel      (o, lse)
//   flash_dq_kernel   <- _bwd_call / _flash_dq_kernel   (dq)
//   flash_dkv_kernel  <- _bwd_call / _flash_dkv_kernel  (dk, dv)
// launched by repro_flash_fwd and repro_flash_bwd (which = 1 or 2).
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
// What bounds it on this card: for f32 inputs, operations (the forward
// does 2 hd-deep products per (query, key) pair, dq 3, dk/dv 4, over half
// the pairs under the causal mask).  For
// bf16 inputs the tensor cores could do that work in about the time it
// takes to read q, k, v and dO once: at Llama-3.2-1B's shape (B = 8,
// T = S = 1024, H = 32, hd = 64) the forward is 34 GFLOP against 0.13 GB,
// 0.035 ms of bf16 operations and 0.040 ms of bytes.
//
// What the design does about it: one block of 256 threads per
// (query tile, head, example) for the forward and dq, and per (key tile,
// KV head, example) for dk/dv, with 64 x 64 tiles staged in shared
// memory as f32 (rows padded by one float, so the column walks are free
// of bank conflicts) and every product computed in f32 registers, 4 x 4
// scores or 4 x hd/16 accumulators per thread.  The TPU kernels carry
// their accumulators across a sequential grid axis; here that axis is a
// loop inside the block, so each output tile is summed by one block in a
// fixed order: no atomics, and two runs are bitwise equal.  Under the
// causal mask the loops skip the tiles that lie wholly past the
// diagonal, which changes nothing (their P is exactly 0).  The tile
// sizes (64) differ from the TPU kernel's bq / bk (512); the wrapper
// keeps the bq / bk contract (query padding, the key-length check).
// Not yet done: the tensor cores (mma / wgmma), which would lift the
// f32 FMA ceiling by an order of magnitude.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>

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
// Forward: one block per (query tile, head, example).

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

// which: 0 forward, 1 dq, 2 dk/dv.
template <typename T>
int dispatch(int which, int hd, const Args& a) {
#define REPRO_FLASH_CASE(HD)                                   \
  case HD:                                                     \
    return which == 0 ? launch_fwd<T, HD>(a)                   \
                      : which == 1 ? launch_dq<T, HD>(a)       \
                                   : launch_dkv<T, HD>(a);
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
  return bf16 ? dispatch<__nv_bfloat16>(which, hd, a)
              : dispatch<float>(which, hd, a);
}

}  // namespace

extern "C" {

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
