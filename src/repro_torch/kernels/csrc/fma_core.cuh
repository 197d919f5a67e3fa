// The f32 FMA product core shared by gram_norm.cu (gram_norm's direct
// and Gram routes, gram_norm_fused in f32) and pe_conv_grad.cu
// (pe_conv_grad_1d): a block of 256 threads streams two operands
// A(k, m) and B(k, n) through a cp.async ring in shared memory and sums
// acc[r][c] = sum over k of A(k, row r) * B(k, row c) in registers, one
// fmaf per k in k order.  Each output is one sequential f32 sum, so two
// runs on the same inputs are bitwise equal.  build.py hashes this header
// with every source that includes it.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace fma_core {

constexpr int NT = 256;    // threads of a block
constexpr int BK = 32;     // contraction depth of a stage
constexpr int STAGES = 3;  // depth of the cp.async ring

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Shared tiles hold f32 in one layout: an operand A(k, m) (k the
// contraction, m the tile's BM rows) at s[k * (BM + 4) + m], so a thread
// reads its rows as 16-byte vectors along m; with the 4 floats of
// padding, a warp's 4-byte copies along k (8 k by 4 m, below) land in 32
// distinct banks.
template <int BM>
__host__ __device__ constexpr int pitch() {
  return BM + 4;
}

// One operand's staging.  Copies A(k, m) = base[k sk + col(m)] for k in
// [k0, K) and m in [m0, min(m0 + BM, M)), BK values of k a stage, for
// consecutive examples bstep apart; entries outside are 0.  col(m) is
// m sm, or, for a gathered operand (G), (m / kw) sm + m % kw: the
// shifted rows x[c, k + t] of a 1-D convolution's input, column
// m = c kw + k (then sk = 1).  mode 16: 16-byte cp.async, 4 m a copy
// (sm = 1, rows 16-byte aligned; not with G); 4: 4-byte cp.async (f32),
// consecutive threads along the operand's contiguous axis (k when
// sk = 1, else m); 0: plain loads (bf16), as 4.  The addresses are formed
// once; a stage adds one offset.
template <int BM, typename T, bool G = false>
struct Stager {
  static constexpr int ROWS = BM;
  static constexpr int COPIES = BK * BM / NT;  // a thread's, at mode 4 or 0
  const T* base;  // a valid address, for empty copies
  const T* p;     // this thread's first copy at stage 0
  long long step, di, bstep;
  int soff, sdi, k, kdi, m, mdi, K, M, mode;
  int goff[G ? COPIES : 1];  // G: offset of copy i's column

  __device__ __forceinline__ Stager(const T* base_, long long sk,
                                    long long sm, long long bstep_, int K_,
                                    int M_, int k0, int m0, int mode_,
                                    int kw = 0)
      : base(base_), bstep(bstep_), K(K_), M(M_) {
    const int tid = threadIdx.x;
    mode = !std::is_same<T, float>::value ? 0
           : (mode_ == 16 && (sm != 1 || G)) ? 4
                                             : mode_;
    if (mode == 16) {
      kdi = NT / (BM / 4), mdi = 0;
      k = tid / (BM / 4), m = 4 * (tid % (BM / 4));
    } else if (sk == 1) {
      // A warp covers 8 k by 4 m: 32-byte runs along k, and the copies
      // land in 32 distinct banks.
      const int lane = tid % 32, warp = tid / 32;
      kdi = 0, mdi = NT / BK;
      k = lane % 8 + 8 * (warp % (BK / 8));
      m = lane / 8 + 4 * (warp / (BK / 8));
    } else {
      kdi = NT / BM, mdi = 0, k = tid / BM, m = tid % BM;
    }
    soff = k * pitch<BM>() + m;
    sdi = kdi * pitch<BM>() + mdi;
    k += k0;
    m += m0;
    step = (long long)BK * sk;
    if constexpr (G) {
#pragma unroll
      for (int i = 0; i < COPIES; ++i) {
        const int mi = min(m + i * mdi, M - 1);
        goff[i] = (mi / kw) * (int)sm + mi % kw;
      }
      p = base + k;
      di = 0;
    } else {
      p = base + (long long)k * sk + (long long)m * sm;
      di = (long long)kdi * sk + (long long)mdi * sm;
    }
  }

  // Stage c of example e (counted from the first) into the tile s.
  __device__ __forceinline__ void operator()(float* s, int e, int c) const {
    const T* pc = p + e * bstep + c * step;
    const int kc = k + c * BK;
    if (mode == 16) {
      const uint32_t sb = hopper::smem_u32(s + soff);
#pragma unroll
      for (int i = 0; i < BK * BM / 4 / NT; ++i) {
        const int n = kc + i * kdi < K ? min(max(M - m, 0), 4) : 0;
        hopper::cp_async16(sb + 4 * i * sdi, n ? pc + i * di : base, 4 * n);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < COPIES; ++i) {
      const bool ok = kc + i * kdi < K && m + i * mdi < M;
      const T* src;
      if constexpr (G)
        src = pc + goff[i];
      else
        src = pc + i * di;
      if constexpr (std::is_same<T, float>::value)
        hopper::cp_async4(hopper::smem_u32(s + soff + i * sdi),
                          ok ? src : base, ok ? 4 : 0);
      else
        s[soff + i * sdi] = ok ? to_f32(*src) : 0.f;
    }
  }
};

// The thread's coordinates (tx, ty) in the 16 x 16 grid of a block: a
// warp covers 4 tx by 8 ty, so its fragment reads touch 8 rows of A and
// 4 of B, one shared-memory wavefront each.
__device__ __forceinline__ int tile_tx() {
  return (threadIdx.x / 32) % 4 * 4 + threadIdx.x % 4;
}
__device__ __forceinline__ int tile_ty() {
  return (threadIdx.x / 128) * 8 + (threadIdx.x % 32) / 4;
}

// Row of the tile held at fragment row r by thread coordinate q (ty for
// A, tx for B): two 16-byte vectors of 4 rows, 64 rows apart.
__device__ __forceinline__ int frag_row(int q, int r) {
  return 64 * (r / 4) + 4 * q + r % 4;
}

// Runs nb examples' products one after another through one STAGES-deep
// ring, klen rows of k each: acc[r][c] = sum over k of
// A(k, frag_row(ty, r)) * B(k, frag_row(tx, c)), in k order, then
// epi(e, acc) at the end of example e; acc keeps the last example's
// product.  The next example's stages load while the current one
// finishes; an example's last stage multiplies only its rows (AlexNet's
// T = 225 and 961 leave 1 of 32).  Every thread of the block calls it;
// the ring is free again when it returns.
template <int TM, int TN, typename SA, typename SB, typename Epi>
__device__ __forceinline__ void tile_stream(const SA& sa, const SB& sb,
                                            int nb, int klen, float* As,
                                            float* Bs, float (&acc)[TM][TN],
                                            Epi epi) {
  static_assert(SA::ROWS == 16 * TM && SB::ROWS == 16 * TN,
                "the stagers' rows must match the register tile");
  constexpr int PA = pitch<16 * TM>(), PB = pitch<16 * TN>();
  constexpr int SA_ = BK * PA, SB_ = BK * PB;
  const int tx = tile_tx(), ty = tile_ty();
  const int nk = (klen + BK - 1) / BK;
  const int rem = klen - (nk - 1) * BK;  // rows of an example's last stage
  const int n = nb * nk;
  int le = 0, lc = 0;  // the next stage to load: example, stage
  auto load = [&](int slot) {
    sa(As + slot * SA_, le, lc);
    sb(Bs + slot * SB_, le, lc);
    if (++lc == nk) lc = 0, ++le;
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s);
    hopper::cp_commit();
  }
  int ce = 0, cc = 0;  // the stage to compute
  for (int s = 0; s < n; ++s) {
    hopper::cp_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is consumed
    if (s + STAGES - 1 < n) load((s + STAGES - 1) % STAGES);
    hopper::cp_commit();
    if (cc == 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
    }
    const float* as = As + (s % STAGES) * SA_ + 4 * ty;
    const float* bs = Bs + (s % STAGES) * SB_ + 4 * tx;
    // Fragments of step kk + 1 load while step kk multiplies.
    float av[2][TM], bv[2][TN];
    auto frags = [&](int kk, float* a, float* b) {
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 f =
            *reinterpret_cast<const float4*>(as + kk * PA + 64 * g);
        a[4 * g] = f.x, a[4 * g + 1] = f.y, a[4 * g + 2] = f.z,
        a[4 * g + 3] = f.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 f =
            *reinterpret_cast<const float4*>(bs + kk * PB + 64 * g);
        b[4 * g] = f.x, b[4 * g + 1] = f.y, b[4 * g + 2] = f.z,
        b[4 * g + 3] = f.w;
      }
    };
    auto fma_step = [&](const float* a, const float* b) {
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    };
    if (cc < nk - 1 || rem == BK) {
      frags(0, av[0], bv[0]);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        if (kk + 1 < BK) frags(kk + 1, av[(kk + 1) % 2], bv[(kk + 1) % 2]);
        fma_step(av[kk % 2], bv[kk % 2]);
      }
    } else {
      for (int kk = 0; kk < rem; ++kk) {
        frags(kk, av[0], bv[0]);
        fma_step(av[0], bv[0]);
      }
    }
    if (++cc == nk) {
      epi(ce, acc);
      cc = 0;
      ++ce;
    }
  }
  hopper::cp_wait<0>();
  __syncthreads();
}

}  // namespace fma_core
