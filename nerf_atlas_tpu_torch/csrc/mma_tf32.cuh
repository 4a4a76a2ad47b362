// The dense products of the backward kernels K2/K3 (render_bwd.cu), K7b
// (render_ae_bwd.cu), K8b (render_volsdf_bwd.cu) and K9b
// (render_dyn_bwd.cu) on Hopper's tensor cores, in split TF32: a whole
// SkipConnMLP's forward (`mlp_fwd`, the backward's recompute) and VJP
// (`mlp_bwd`), and the eikonal's transpose chain and its adjoint
// (`mlp_input_grad`, `mlp_input_grad_adjoint`). K1 runs its products by
// wgmma (wgmma_tf32.cuh, which takes the split and cp.async from here);
// K7f, K8f and K9f keep render_common.cuh's float32 FMA products;
// render_ae.cuh, render_dyn.cuh and render_volsdf.cuh include this header
// for the TC pack's offsets and `TcMlp`, which only the backward kernels
// instantiate.
//
// Split TF32. A float32 a is split into hi = tf32(a) and lo = tf32(a − hi)
// (tf32: round to nearest, ties away from zero, to 10 stored mantissa bits,
// the rounding of cvt.rna.tf32.f32, done here on the bits); a − hi is exact
// in float32, and |a − (hi + lo)| ≤ 2^-22·|a|. A product a·b is formed as
// lo_a·hi_b + hi_a·lo_b + hi_a·hi_b by `mma.sync.aligned.m16n8k8` (TF32
// inputs, float32 accumulation; each 16-deep slice into a fresh
// accumulator added to the running float32 sum, `mma_slice`); the
// dropped lo_a·lo_b is ≤ 2^-22·|ab|.
// So each term carries ≤ ~3·2^-22·|ab| (7e-7 relative) where float32 FMAs
// carry 2^-24: the dot products are not float32-exact, and
// `testing.split_tf32_matmul` emulates them on the CPU to hold the plain
// K3 so computed against the float32 one (tests/test_torch_tf32_split.py).
// mma.sync here, wgmma in K1: the backward's products have the tile's
// points on N (forward and input gradient) or on K (weight gradient),
// with the weights (forward, input gradient) or the activations (weight
// gradient) as A, so both operands come from the feature-major [row][PS]
// tiles or the fragment-ordered TC pack; mma.sync takes either from
// registers, and its m16n8k8 shape pads the narrow layers (33, 4 or 3
// outputs, 19..96 init rows) to 16 or 8. A forward alone can put the
// points on M and the outputs on N instead, which is K1's wgmma form
// (A from registers, N padded to 8, wgmma_tf32.cuh); moving these
// products to it is ROADMAP's next step for the backward.
//
// The three products of a Dense layer (W [in][out], a 64-point tile):
//   forward    Z[o][p]  = Σ_k W[k][o]·X[k][p] (+ b[o])    A = Wᵀ (staged)
//   input grad dX[k][p] = Σ_n W[k][n]·G[n][p]             A = W  (staged)
//   weight     dW[k][n] += Σ_p X[k][p]·G[n][p]             A = X, B = Gᵀ
// The staged operand is the weights, pre-split by the wrapper into the
// "TC pack" (render.py `tc_pack`): per product a block A [Mp][Kp] (both
// padded to 16 with zeros) in slices of SK = 16 k, each slice's hi part
// then its lo part, each part in fragment order: for each k-step kk of 8,
// m-tile mt of 16 and lane (g = lane / 4, t = lane % 4) the lane's four
// m16n8k8 A values A[16mt + g][8kk + t], A[16mt + g + 8][8kk + t],
// A[16mt + g][8kk + t + 4], A[16mt + g + 8][8kk + t + 4], so a lane loads
// its fragment with one 16-byte read and a warp's reads are contiguous.
// `gemm_staged` streams the slices into shared memory with cp.async, one
// slice ahead of the mma (double-buffered), in place of reading the
// weights through L1 for every tile; the buffers lie in the activation
// rows the product does not read (the caller's `stage`). The activations
// and gradients are split in registers as their fragments are loaded.
//
// Warp tiling (8 warps, an output [M][64]): warp w takes the points
// 32·(w & 1) .. + 31 (four n-tiles of 8) and the m-tiles (w >> 1) + 4i.
// Every output element is owned by one thread, and every sum runs in a
// fixed order: the results are the same bits from launch to launch.

#pragma once

#include <stdint.h>

#include "render_common.cuh"

namespace tc {

using namespace render;

constexpr int SK = 16;          // k rows per staged slice: two mma k-steps

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }

// ---- the TC pack (render.py `tc_pack` builds it) ----
// A block of k × m (A[m][k], padded): hi and lo, so 2·Kp·Mp floats.
__host__ __device__ constexpr long block_floats(int k, int m) {
  return 2L * pad16(k) * pad16(m);
}
// Dense layer j of a SkipConnMLP (FI init rows, H wide, NL hidden layers,
// NOUT outputs): j = 0 layer_in, 1..NL hidden, NL + 1 layer_out; its
// input rows from the hidden state (kh) and from the init feature (kf).
__host__ __device__ constexpr int layer_kh(int h, int j) {
  return j == 0 ? 0 : h;
}
__host__ __device__ constexpr int layer_kf(int fi, int nl, int j) {
  return j == 0 ? fi : (j <= nl && skip_at(j - 1, nl)) ? fi : 0;
}
__host__ __device__ constexpr int layer_out(int h, int nl, int nout, int j) {
  return j == nl + 1 ? nout : h;
}
// Per layer, in order: FWD [pad16(kh) + pad16(kf)][out] (A[m = out][k =
// in]), BWD_H [out][kh] (A[m = hidden input][k = out]), BWD_F [out][kf].
// In an MLP whose forward products run in three parts (THREE), FWD holds
// the raw float32 weights (one part), split in registers.
__host__ __device__ constexpr long fwd_floats(int kh, int kf, int out,
                                              bool three = false) {
  return (three ? 1L : 2L) * (pad16(kh) + pad16(kf)) * pad16(out);
}
__host__ __device__ constexpr long layer_floats(int kh, int kf, int out,
                                                bool three = false) {
  return fwd_floats(kh, kf, out, three) + block_floats(out, kh)
         + block_floats(out, kf);
}
__host__ __device__ constexpr long tc_offset(int fi, int h, int nl, int nout,
                                             int j, bool three = false) {
  long off = 0;
  for (int i = 0; i < j; ++i)
    off += layer_floats(layer_kh(h, i), layer_kf(fi, nl, i),
                        layer_out(h, nl, nout, i), three);
  return off;
}
__host__ __device__ constexpr long tc_mlp_floats(int fi, int h, int nl,
                                                 int nout,
                                                 bool three = false) {
  return tc_offset(fi, h, nl, nout, nl + 2, three);
}
// shared-memory floats `gemm_staged` stages an M-row product through: two
// slices
__host__ __device__ constexpr int stage_floats(int m) {
  return 2 * 2 * SK * pad16(m);
}

// ---- fragments ----

// tf32(x) as the bits of a float32 whose low 13 bits are 0 (round to
// nearest, ties away from zero: the magnitude's bits + half an ulp)
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// Three parts: x − hi and (x − hi) − mid are exact in float32, and |x −
// (hi + mid + lo)| ≤ 2^-33·|x|
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = tf32_bits(x);
  const float r = x - __uint_as_float(hi);
  mid = tf32_bits(r);
  lo = tf32_bits(r - __uint_as_float(mid));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b over one slice (two k-steps of 8) in split TF32: the six
// products (per k-step the small terms first) into a fresh accumulator,
// then one round-to-nearest float32 add into d. The tensor cores' own
// accumulation truncates; fed the running sum, it would cut |d| toward
// zero at every product (a drift over a 256-long dot product), where this
// cuts only the slice's own partial sum, whose sign varies from slice to
// slice, and leaves d's rounding to the FADD.
__device__ __forceinline__ void mma_slice(float (&d)[4],
                                          const uint32_t (&ah)[2][4],
                                          const uint32_t (&al)[2][4],
                                          const uint32_t (&bh)[2][2],
                                          const uint32_t (&bl)[2][2]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    mma(t, al[kk], bh[kk][0], bh[kk][1]);
    mma(t, ah[kk], bl[kk][0], bl[kk][1]);
    mma(t, ah[kk], bh[kk][0], bh[kk][1]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] += t[c];
}

// d += a·b over one slice in three parts: the six products whose terms
// are ≥ 2^-22·|ab| (lo·hi, hi·lo, mid·mid, mid·hi, hi·mid, hi·hi, the
// small first; the dropped ones are ≤ ~3·2^-33·|ab|) into a fresh
// accumulator, then one float32 add into d, as `mma_slice`
__device__ __forceinline__ void mma_slice3(float (&d)[4],
                                           const uint32_t (&ah)[2][4],
                                           const uint32_t (&am)[2][4],
                                           const uint32_t (&al)[2][4],
                                           const uint32_t (&bh)[2][2],
                                           const uint32_t (&bm)[2][2],
                                           const uint32_t (&bl)[2][2]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    mma(t, al[kk], bh[kk][0], bh[kk][1]);
    mma(t, ah[kk], bl[kk][0], bl[kk][1]);
    mma(t, am[kk], bm[kk][0], bm[kk][1]);
    mma(t, am[kk], bh[kk][0], bh[kk][1]);
    mma(t, ah[kk], bm[kk][0], bm[kk][1]);
    mma(t, ah[kk], bh[kk][0], bh[kk][1]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) d[c] += t[c];
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The accumulators of an [M][64] output: MTW m-tiles per warp, four
// n-tiles of 8 points, the m16n8 fragment's four floats: (row g, points
// 2t and 2t + 1) and (row g + 8, the same points), g = lane / 4, t = lane
// % 4.
template <int M>
struct Acc {
  static constexpr int MT = pad16(M) / 16;
  static constexpr int MTW = (MT + 3) / 4;
  float v[MTW][4][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[i][n][c] = 0.0f;
  }

  // fn(n, h, m, j) for the output pairs (m, j), (m, j + 1) of m-tile i,
  // held in v[i][n][2h], v[i][n][2h + 1], for m < M (j even)
  template <class Fn>
  __device__ __forceinline__ void each_slot(int i, Fn fn) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int mt = (warp >> 1) + 4 * i;
    if (mt >= MT) return;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int j = 32 * (warp & 1) + 8 * n + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * mt + g + 8 * h;
        if (m < M) fn(n, h, m, j);
      }
    }
  }

  // fn(m, j, v0, v1): outputs (m, j) and (m, j + 1) for m < M, j even
  template <class Fn>
  __device__ __forceinline__ void each(Fn fn) const {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
      each_slot(i, [&](int n, int h, int m, int j) {
        fn(m, j, v[i][n][2 * h], v[i][n][2 * h + 1]);
      });
  }
};

// acc = A·B over the tile's 64 points: A the TC-pack block `blk` (SK-deep
// slices, hi then lo, in fragment order; with THREE the raw weights, split
// into three parts in registers, as B then is), B rows k < KA from b0 and
// rows pad16(KA) + r, r < KB, from b1 (row stride PS; rows past KA or KB
// read as 0). The slices pass through `stage` (stage_floats(M) floats of
// shared memory, two buffers) by cp.async, one slice ahead. Starts and
// ends with a barrier: the caller may then overwrite b0, b1 and stage.
template <int M, int KA, int KB, bool THREE = false>
__device__ __forceinline__ void gemm_staged(const float* __restrict__ blk,
                                            float* stage, const float* b0,
                                            const float* b1, Acc<M>& acc) {
  constexpr int MP = pad16(M), MT = Acc<M>::MT, KAP = pad16(KA);
  constexpr int SLICES = (KAP + pad16(KB)) / SK;
  constexpr int PARTS = THREE ? 1 : 2;              // staged parts per slice
  constexpr int SBUF = PARTS * SK * MP;             // one slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p_w = 32 * (warp & 1) + g;
  auto issue = [&](int s) {
    const float* src = blk + (long)s * SBUF;
    float* dst = stage + (s & 1) * SBUF;
    for (int c = threadIdx.x; c < SBUF / 4; c += THREADS)
      cp_async16(dst + 4 * c, src + 4 * c);
    cp_async_commit();
  };
  acc.zero();
  __syncthreads();
  issue(0);
  for (int s = 0; s < SLICES; ++s) {
    if (s + 1 < SLICES) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sa = stage + (s & 1) * SBUF + 4 * lane;
    const bool first = s * SK < KAP;
    const float* bs = first ? b0 : b1;
    const int r0 = (first ? s * SK : s * SK - KAP) + t;
    const int rows = first ? KA : KB;
    if constexpr (THREE) {
      uint32_t bh[4][2][2], bm[4][2][2], bl[4][2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = r0 + 8 * kk;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int p = p_w + 8 * n;
          split3(r < rows ? bs[r * PS + p] : 0.0f, bh[n][kk][0],
                 bm[n][kk][0], bl[n][kk][0]);
          split3(r + 4 < rows ? bs[(r + 4) * PS + p] : 0.0f, bh[n][kk][1],
                 bm[n][kk][1], bl[n][kk][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < Acc<M>::MTW; ++i) {
        const int mt = (warp >> 1) + 4 * i;
        if (mt >= MT) continue;
        uint32_t ah[2][4], am[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float4 v =
              *reinterpret_cast<const float4*>(sa + (kk * MT + mt) * 128);
          split3(v.x, ah[kk][0], am[kk][0], al[kk][0]);
          split3(v.y, ah[kk][1], am[kk][1], al[kk][1]);
          split3(v.z, ah[kk][2], am[kk][2], al[kk][2]);
          split3(v.w, ah[kk][3], am[kk][3], al[kk][3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_slice3(acc.v[i][n], ah, am, al, bh[n], bm[n], bl[n]);
      }
    } else {
      uint32_t bh[4][2][2], bl[4][2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = r0 + 8 * kk;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int p = p_w + 8 * n;
          split(r < rows ? bs[r * PS + p] : 0.0f, bh[n][kk][0], bl[n][kk][0]);
          split(r + 4 < rows ? bs[(r + 4) * PS + p] : 0.0f, bh[n][kk][1],
                bl[n][kk][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < Acc<M>::MTW; ++i) {
        const int mt = (warp >> 1) + 4 * i;
        if (mt >= MT) continue;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float4 h =
              *reinterpret_cast<const float4*>(sa + (kk * MT + mt) * 128);
          const float4 l = *reinterpret_cast<const float4*>(
              sa + SK * MP + (kk * MT + mt) * 128);
          ah[kk][0] = __float_as_uint(h.x); ah[kk][1] = __float_as_uint(h.y);
          ah[kk][2] = __float_as_uint(h.z); ah[kk][3] = __float_as_uint(h.w);
          al[kk][0] = __float_as_uint(l.x); al[kk][1] = __float_as_uint(l.y);
          al[kk][2] = __float_as_uint(l.z); al[kk][3] = __float_as_uint(l.w);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_slice(acc.v[i][n], ah, al, bh[n], bl[n]);
      }
    }
    __syncthreads();
  }
}

// pw[m·N + n] += Σ_p A[m][p]·G[n][p] over the tile's 64 points, m < M, n <
// N (A and G rows PS floats apart, in shared memory; pw in the block's
// partial), in chunks of 64 columns. Each entry of pw is owned by one
// thread.
template <int M, int N>
__device__ __forceinline__ void gemm_dw(const float* A, const float* G,
                                        float* __restrict__ pw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int n0 = 0; n0 < N; n0 += 64) {
    Acc<M> acc;
    acc.zero();
#pragma unroll 1
    for (int k0 = t; k0 < TILE; k0 += SK) {
      uint32_t bh[4][2][2], bl[4][2][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = n0 + 32 * (warp & 1) + 8 * n + g;
        const float* gr = G + col * PS + k0;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          split(col < N ? gr[8 * kk] : 0.0f, bh[n][kk][0], bl[n][kk][0]);
          split(col < N ? gr[8 * kk + 4] : 0.0f, bh[n][kk][1], bl[n][kk][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < Acc<M>::MTW; ++i) {
        const int mt = (warp >> 1) + 4 * i;
        if (mt >= Acc<M>::MT) continue;
        const int m = 16 * mt + g;
        const float* x0 = A + m * PS + k0;
        const float* x1 = x0 + 8 * PS;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          split(m < M ? x0[8 * kk] : 0.0f, ah[kk][0], al[kk][0]);
          split(m + 8 < M ? x1[8 * kk] : 0.0f, ah[kk][1], al[kk][1]);
          split(m < M ? x0[8 * kk + 4] : 0.0f, ah[kk][2], al[kk][2]);
          split(m + 8 < M ? x1[8 * kk + 4] : 0.0f, ah[kk][3], al[kk][3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_slice(acc.v[i][n], ah, al, bh[n], bl[n]);
      }
    }
    // per m-tile, its 16 reads of the partial first, then the adds and
    // writes: the reads are independent, so their latency is paid once
    // per m-tile, not once per entry
#pragma unroll
    for (int i = 0; i < Acc<M>::MTW; ++i) {
      float old[4][4];
      acc.each_slot(i, [&](int n, int h, int m, int j) {
        const float* d = pw + (long)m * N + n0 + j;
        old[n][2 * h] = n0 + j < N ? d[0] : 0.0f;
        old[n][2 * h + 1] = n0 + j + 1 < N ? d[1] : 0.0f;
      });
      acc.each_slot(i, [&](int n, int h, int m, int j) {
        float* d = pw + (long)m * N + n0 + j;
        if (n0 + j < N) d[0] = old[n][2 * h] + acc.v[i][n][2 * h];
        if (n0 + j + 1 < N) d[1] = old[n][2 * h + 1] + acc.v[i][n][2 * h + 1];
      });
    }
  }
}

// pb[n] += Σ_p G[n][p] (p in order) for n < N: the bias gradient
template <int N>
__device__ __forceinline__ void bias_grad(const float* G,
                                          float* __restrict__ pb) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float s = 0.0f;
    for (int p = 0; p < TILE; ++p) s += G[n * PS + p];
    pb[n] += s;
  }
}

// ---- a whole SkipConnMLP (render_common.cuh's mlp_fwd and the VJP, with
// the products above) ----

// Hidden layers I..NL-1 of `mlp_fwd`.
template <int FI, int H, int NL, int NOUT, int ACT, bool THREE, int I>
__device__ __forceinline__ void mlp_hidden_fwd(const float* FA,
                                               const float* __restrict__ w,
                                               const float* __restrict__ tcp,
                                               float* X, float* zst,
                                               float* stage) {
  if constexpr (I < NL) {
    constexpr int KF = skip_at(I, NL) ? FI : 0;
    const float* __restrict__ b =
        w + mlp_offset(FI, H, NL, I + 1) + (long)(H + KF) * H;
    float* z = zst + (long)(I + 1) * H * TILE;
    Acc<H> acc;
    gemm_staged<H, H, KF, THREE>(tcp + tc_offset(FI, H, NL, NOUT, I + 1, THREE),
                                 stage, X, FA, acc);
    acc.each([&](int m, int j, float v0, float v1) {
      const float bm = __ldg(b + m);
      const float z0 = v0 + bm, z1 = v1 + bm;
      *reinterpret_cast<float2*>(z + m * TILE + j) = make_float2(z0, z1);
      *reinterpret_cast<float2*>(X + m * PS + j) =
          make_float2(activate<ACT>(z0), activate<ACT>(z1));
    });
    mlp_hidden_fwd<FI, H, NL, NOUT, ACT, THREE, I + 1>(FA, w, tcp, X, zst,
                                                       stage);
  }
}

// A SkipConnMLP on the tile: init feature F (FI rows) and act(F) in FA ->
// its raw output in X rows 0..NOUT-1; the pre-activations of layer_in and
// the hidden layers go to the stash rows zst 0 .. (NL + 1)·H. w: the
// packed weights at the MLP's layer_in (the biases), tcp: its TC pack
// (THREE: its forward blocks raw, the products in three parts); stage:
// stage_floats(max(H, NOUT)) floats of shared memory that none of F, FA,
// X overlaps. Ends with a barrier.
template <int FI, int H, int NL, int NOUT, int ACT, bool THREE = false>
__device__ __forceinline__ void mlp_fwd(const float* F, const float* FA,
                                        const float* __restrict__ w,
                                        const float* __restrict__ tcp,
                                        float* X, float* zst, float* stage) {
  {
    const float* __restrict__ b = w + (long)FI * H;
    Acc<H> acc;
    gemm_staged<H, FI, 0, THREE>(tcp, stage, F, nullptr, acc);
    acc.each([&](int m, int j, float v0, float v1) {
      const float bm = __ldg(b + m);
      const float z0 = v0 + bm, z1 = v1 + bm;
      *reinterpret_cast<float2*>(zst + m * TILE + j) = make_float2(z0, z1);
      *reinterpret_cast<float2*>(X + m * PS + j) =
          make_float2(activate<ACT>(z0), activate<ACT>(z1));
    });
  }
  mlp_hidden_fwd<FI, H, NL, NOUT, ACT, THREE, 0>(FA, w, tcp, X, zst, stage);
  {
    const float* __restrict__ b =
        w + mlp_offset(FI, H, NL, NL + 1) + (long)H * NOUT;
    Acc<NOUT> acc;
    gemm_staged<NOUT, H, 0, THREE>(
        tcp + tc_offset(FI, H, NL, NOUT, NL + 1, THREE), stage, X, nullptr,
        acc);
    acc.each([&](int m, int j, float v0, float v1) {
      const float bm = __ldg(b + m);
      *reinterpret_cast<float2*>(X + m * PS + j) =
          make_float2(v0 + bm, v1 + bm);
    });
  }
  __syncthreads();
}

// G[m][p] = v · act'(z[m][p]) for the input gradient acc (z: stash rows;
// per m-tile every read first, so that their latency overlaps)
template <int M, int ACT>
__device__ __forceinline__ void store_dz(const Acc<M>& acc, float* G,
                                         const float* __restrict__ z) {
#pragma unroll
  for (int i = 0; i < Acc<M>::MTW; ++i) {
    float2 zz[4][2];
    acc.each_slot(i, [&](int n, int h, int m, int j) {
      zz[n][h] = *reinterpret_cast<const float2*>(z + m * TILE + j);
    });
    acc.each_slot(i, [&](int n, int h, int m, int j) {
      *reinterpret_cast<float2*>(G + m * PS + j) =
          make_float2(acc.v[i][n][2 * h] * act_grad<ACT>(zz[n][h].x),
                      acc.v[i][n][2 * h + 1] * act_grad<ACT>(zz[n][h].y));
    });
  }
}

// Hidden layers I..0 of `mlp_bwd`, last first. On entry G holds the
// gradient of hidden layer I's pre-activation.
template <int FI, int H, int NL, int NOUT, int ACT, bool WANT_DF, bool THREE,
          int I>
__device__ __forceinline__ void mlp_hidden_bwd(float* X, float* G,
                                               const float* F,
                                               const float* FA, float* DF,
                                               const float* __restrict__ tcp,
                                               float* __restrict__ pw,
                                               const float* __restrict__ zst) {
  if constexpr (I >= 0) {
    constexpr bool SKIP = skip_at(I, NL);
    constexpr int KF = SKIP ? FI : 0;
    constexpr long OFF = mlp_offset(FI, H, NL, I + 1);
    constexpr long TC = tc_offset(FI, H, NL, NOUT, I + 1, THREE);
    constexpr long TC_H = TC + fwd_floats(H, KF, H, THREE);
    const float* __restrict__ z_prev = zst + (long)I * H * TILE;
    load_act<ACT>(z_prev, H, X);
    __syncthreads();
    gemm_dw<H, H>(X, G, pw + OFF);
    if constexpr (SKIP) gemm_dw<FI, H>(FA, G, pw + OFF + (long)H * H);
    bias_grad<H>(G, pw + OFF + (long)(H + KF) * H);
    if constexpr (SKIP && WANT_DF) {
      Acc<FI> acc;
      gemm_staged<FI, H, 0>(tcp + TC_H + block_floats(H, H), X, G, nullptr,
                            acc);
      acc.each([&](int m, int j, float v0, float v1) {
        float* d = DF + m * PS + j;
        d[0] += v0 * act_grad<ACT>(F[m * PS + j]);
        d[1] += v1 * act_grad<ACT>(F[m * PS + j + 1]);
      });
    }
    {
      Acc<H> acc;
      gemm_staged<H, H, 0>(tcp + TC_H, X, G, nullptr, acc);
      store_dz<H, ACT>(acc, G, z_prev);
    }
    mlp_hidden_bwd<FI, H, NL, NOUT, ACT, WANT_DF, THREE, I - 1>(
        X, G, F, FA, DF, tcp, pw, zst);
  }
}

// The VJP of `mlp_fwd` on one tile. On entry G rows 0..NOUT-1 hold the
// output gradient, X = act(the last hidden pre-activation), F / FA the
// init feature and its activation, DF (when WANT_DF) their gradient so
// far, zst the stashed pre-activations; tcp and pw point at the MLP's TC
// pack (THREE: its forward blocks raw, as `mlp_fwd` takes them) and at its
// layer_in in the block's partial row. Weight and bias gradients add into
// pw; with WANT_DF the init feature's gradient adds into DF. X is
// overwritten: it stages the weights of the input-gradient products. Ends
// with a barrier.
template <int FI, int H, int NL, int NOUT, int ACT, bool WANT_DF,
          bool THREE = false>
__device__ __forceinline__ void mlp_bwd(float* X, float* G, const float* F,
                                        const float* FA, float* DF,
                                        const float* __restrict__ tcp,
                                        float* __restrict__ pw,
                                        const float* __restrict__ zst) {
  constexpr long OUT = mlp_offset(FI, H, NL, NL + 1);
  constexpr long TC_OUT = tc_offset(FI, H, NL, NOUT, NL + 1, THREE);
  gemm_dw<H, NOUT>(X, G, pw + OUT);
  bias_grad<NOUT>(G, pw + OUT + (long)H * NOUT);
  {
    Acc<H> acc;
    gemm_staged<H, NOUT, 0>(tcp + TC_OUT + fwd_floats(H, 0, NOUT, THREE), X,
                            G, nullptr, acc);
    store_dz<H, ACT>(acc, G, zst + (long)NL * H * TILE);
  }
  mlp_hidden_bwd<FI, H, NL, NOUT, ACT, WANT_DF, THREE, NL - 1>(
      X, G, F, FA, DF, tcp, pw, zst);
  __syncthreads();                    // G: layer_in's pre-activation grad
  gemm_dw<FI, H>(F, G, pw);
  bias_grad<H>(G, pw + (long)FI * H);
  if constexpr (WANT_DF) {
    Acc<FI> acc;
    gemm_staged<FI, H, 0>(tcp + fwd_floats(0, FI, H, THREE), X, G, nullptr,
                          acc);
    acc.each([&](int m, int j, float v0, float v1) {
      float* d = DF + m * PS + j;
      d[0] += v0;
      d[1] += v1;
    });
  }
  __syncthreads();
}

// The product of render_common.cuh's `FmaMlp` in a backward kernel's
// recompute: `mlp_fwd` above, the MLP's TC pack at tcw + TC (THREE: in
// three parts), its weights staged through `stage` (stage_floats of the
// widest layer; it must not overlap F, FA or X). zst must be the tile's
// stash rows (not null).
struct TcMlp {
  const float* __restrict__ tcw;
  float* stage;
  template <int FI, int H, int NL, int NOUT, int ACT, long TC, bool THREE>
  __device__ __forceinline__ void fwd(const float* F, const float* FA,
                                      const float* __restrict__ w, float* X,
                                      float* zst) const {
    mlp_fwd<FI, H, NL, NOUT, ACT, THREE>(F, FA, w, tcw + TC, X, zst, stage);
  }
};

// ---- the input gradient of one output column and its adjoint (VolSDF's
// eikonal; render_common.cuh states the chain) on the tensor cores ----

// Hidden layers I..0 of `mlp_input_grad`, last first. On entry G holds
// u_{I+1}.
template <int FI, int H, int NL, int NOUT, int ACT, bool THREE, int I>
__device__ __forceinline__ void mlp_input_grad_hidden(
    float* X, float* G, const float* F, float* DF,
    const float* __restrict__ tcp, const float* __restrict__ zst,
    float* __restrict__ ust) {
  if constexpr (I >= 0) {
    constexpr bool SKIP = skip_at(I, NL);
    constexpr int KF = SKIP ? FI : 0;
    constexpr long TC_H = tc_offset(FI, H, NL, NOUT, I + 1, THREE)
                          + fwd_floats(H, KF, H, THREE);
    __syncthreads();
    store_rows(G, H, ust + (long)(I + 1) * H * TILE);
    if constexpr (SKIP) {
      // DF += act'(init) ⊙ (W_I,f u_{I+1})
      Acc<FI> acc;
      gemm_staged<FI, H, 0>(tcp + TC_H + block_floats(H, H), X, G, nullptr,
                            acc);
      acc.each([&](int m, int j, float v0, float v1) {
        float* d = DF + m * PS + j;
        d[0] += v0 * act_grad<ACT>(F[m * PS + j]);
        d[1] += v1 * act_grad<ACT>(F[m * PS + j + 1]);
      });
    }
    {
      // G <- u_I = a'_I ⊙ (W_I,h u_{I+1})
      Acc<H> acc;
      gemm_staged<H, H, 0>(tcp + TC_H, X, G, nullptr, acc);
      store_dz<H, ACT>(acc, G, zst + (long)I * H * TILE);
    }
    mlp_input_grad_hidden<FI, H, NL, NOUT, ACT, THREE, I - 1>(X, G, F, DF, tcp,
                                                             zst, ust);
  }
}

// The transpose chain on one tile (render_common.cuh's `mlp_input_grad`
// with the input-gradient products above, A = W staged from the TC pack's
// input-gradient blocks). On entry G rows 0..H-1 hold u_NL (`seed_column`),
// F the init feature (FI rows) and DF zeros; zst is the forward's
// pre-activation stash, tcp the MLP's TC pack (THREE as `mlp_bwd`). On
// return DF holds d out_c / d init and u_i is at rows i·H of `ust`
// (global, (NL + 1)·H rows of TILE floats) for the adjoint. X stages the
// weights; X and G are overwritten. Ends with a barrier.
template <int FI, int H, int NL, int NOUT, int ACT, bool THREE = false>
__device__ __forceinline__ void mlp_input_grad(float* X, float* G,
                                               const float* F, float* DF,
                                               const float* __restrict__ tcp,
                                               const float* __restrict__ zst,
                                               float* __restrict__ ust) {
  mlp_input_grad_hidden<FI, H, NL, NOUT, ACT, THREE, NL - 1>(X, G, F, DF, tcp,
                                                             zst, ust);
  __syncthreads();
  store_rows(G, H, ust);
  {
    // DF += W_in u_0
    Acc<FI> acc;
    gemm_staged<FI, H, 0>(tcp + fwd_floats(0, FI, H, THREE), X, G, nullptr,
                          acc);
    acc.each([&](int m, int j, float v0, float v1) {
      float* d = DF + m * PS + j;
      d[0] += v0;
      d[1] += v1;
    });
  }
  __syncthreads();
}

// G[m][p] <- the product acc (no bias, no activation): a cotangent row
// block of the adjoint sweep
template <int M>
__device__ __forceinline__ void store_acc(const Acc<M>& acc, float* G) {
  acc.each([&](int m, int j, float v0, float v1) {
    *reinterpret_cast<float2*>(G + m * PS + j) = make_float2(v0, v1);
  });
}

// Hidden layers I..NL-1 of `mlp_input_grad_adjoint`, first first. On
// entry G holds cu_I.
template <int FI, int H, int NL, int NOUT, int ACT, bool THREE, int I>
__device__ __forceinline__ void mlp_input_grad_adjoint_hidden(
    float* X, float* G, const float* CF, const float* __restrict__ tcp,
    float* __restrict__ pw, const float* __restrict__ zst,
    const float* __restrict__ ust) {
  if constexpr (I < NL) {
    constexpr bool SKIP = skip_at(I, NL);
    constexpr int KF = SKIP ? FI : 0;
    constexpr long OFF = mlp_offset(FI, H, NL, I + 1);
    // ĉ_I = cu_I ⊙ a'_I -> X
    __syncthreads();
    for (int i = threadIdx.x; i < H * TILE; i += THREADS) {
      const int n = i / TILE, p = i % TILE;
      X[n * PS + p] = G[n * PS + p] *
                      act_grad<ACT>(zst[((long)I * H + n) * TILE + p]);
    }
    __syncthreads();
    // G <- u_{I+1}; dW_I,h += ĉ_I u_{I+1}ᵀ, dW_I,f += ĉ_f u_{I+1}ᵀ
    load_act<ACT_NONE>(ust + (long)(I + 1) * H * TILE, H, G);
    __syncthreads();
    gemm_dw<H, H>(X, G, pw + OFF);
    if constexpr (SKIP) gemm_dw<FI, H>(CF, G, pw + OFF + (long)H * H);
    {
      // G <- cu_{I+1} = W_I,hᵀ ĉ_I (+ W_I,fᵀ ĉ_f): the forward block, its
      // slices staged through G once the weight gradients have read it
      Acc<H> acc;
      gemm_staged<H, H, KF, THREE>(
          tcp + tc_offset(FI, H, NL, NOUT, I + 1, THREE), G, X, CF, acc);
      store_acc<H>(acc, G);
    }
    mlp_input_grad_adjoint_hidden<FI, H, NL, NOUT, ACT, THREE, I + 1>(
        X, G, CF, tcp, pw, zst, ust);
  }
}

// The weight gradient of a loss L on `mlp_input_grad`'s result, given C =
// ∂L/∂(d out_c / d init) (FI rows, shared): render_common.cuh's sweep up
// the chain (cu_i = ∂L/∂u_i; with leaky-relu each W enters the input
// gradient linearly, a.e.), its forward-like products cu_{i+1} = Wᵀ ĉ_i
// from the TC pack's forward blocks and its rank-64 updates dW_in += C
// u_0ᵀ, dW_i,h += ĉ_i u_{i+1}ᵀ, dW_i,f += ĉ_f u_{i+1}ᵀ (ĉ_i = cu_i ⊙ a'_i,
// ĉ_f = C ⊙ act'(init)) by `gemm_dw`, u_i read back from `ust` into G;
// for layer_out its column c only, dW_out[n][c] += Σ_p cu_NL ⊙ a'_NL (a
// sum over the points on the CUDA cores). The biases take none. F holds
// the init feature, CF receives ĉ_f, X and G are overwritten (G stages
// the weights); tcp is the MLP's TC pack (THREE: the forward-like products
// in three parts, from its raw forward blocks), pw the block's partial at
// its layer_in, zst and ust the stashes of the forward and of
// `mlp_input_grad`. Ends with a barrier.
template <int FI, int H, int NL, int NOUT, int ACT, bool THREE = false>
__device__ __forceinline__ void mlp_input_grad_adjoint(
    float* X, float* G, const float* F, const float* C, float* CF,
    const float* __restrict__ tcp, float* __restrict__ pw,
    const float* __restrict__ zst, const float* __restrict__ ust, int c) {
  for (int i = threadIdx.x; i < FI * TILE; i += THREADS) {
    const int k = i / TILE, p = i % TILE;
    CF[k * PS + p] = C[k * PS + p] * act_grad<ACT>(F[k * PS + p]);
  }
  load_act<ACT_NONE>(ust, H, G);
  __syncthreads();
  gemm_dw<FI, H>(C, G, pw);
  {
    // G <- cu_0 = W_inᵀ C
    Acc<H> acc;
    gemm_staged<H, FI, 0, THREE>(tcp, G, C, nullptr, acc);
    store_acc<H>(acc, G);
  }
  mlp_input_grad_adjoint_hidden<FI, H, NL, NOUT, ACT, THREE, 0>(
      X, G, CF, tcp, pw, zst, ust);
  __syncthreads();
  constexpr long OUT = mlp_offset(FI, H, NL, NL + 1);
  for (int n = threadIdx.x; n < H; n += THREADS) {
    const float* z = zst + ((long)NL * H + n) * TILE;
    float s = 0.0f;
    for (int p = 0; p < TILE; ++p) s += G[n * PS + p] * act_grad<ACT>(z[p]);
    pw[OUT + (long)n * NOUT + c] += s;
  }
  __syncthreads();
}

}  // namespace tc
