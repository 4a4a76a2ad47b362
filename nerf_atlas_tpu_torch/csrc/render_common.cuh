// Device code shared by the eight render kernels: K1 (render_fwd.cu), K2/K3
// (render_bwd.cu), K7f (render_ae_fwd.cu), K7b (render_ae_bwd.cu), K8f
// (render_volsdf_fwd.cu), K8b (render_volsdf_bwd.cu), K9f
// (render_dyn_fwd.cu) and K9b (render_dyn_bwd.cu).
//
// Activations of a 64-point tile live feature-major in shared memory
// ([row][PS], 64 points per row); weights are read per layer through
// L1/L2. The building blocks (the float32 FMA products of K7f, K8f and
// K9f; the backward kernels K2/K3, K7b, K8b and K9b take their MLP
// products from mma_tf32.cuh, K1 from wgmma_tf32.cuh):
//   - the activations and the rgb activation with its derivative;
//   - the sample point and the per-ray constants;
//   - forward Dense layers (`dense_fwd`, optionally stashing the
//     pre-activations) and whole SkipConnMLPs (`mlp_fwd`);
//   - the input gradient of a layer (`dense_bwd`) and, through it, the
//     gradient of one output column of a SkipConnMLP with respect to its
//     input by the transpose chain (`mlp_input_grad`): K8f's eikonal
//     column;
//   - the positional encoding and MipNeRF's integrated positional
//     encoding of a tile (`posenc_rows`, `ipe_moments`, `ipe_rows`);
//   - the block-order sum of the partial rows (`reduce_partials_kernel`).
// Every float operation that the plain torch versions round separately
// (the sample points, the posenc phases, the IPE moments) is an explicit
// round-to-nearest intrinsic here, so nvcc cannot contract it into an FMA.

#pragma once

#include <cuda_runtime.h>

namespace render {

constexpr int TILE = 64;          // sample points per tile
constexpr int THREADS = 256;      // 8 warps x 8 points = one tile
constexpr int PS = TILE + 4;      // row stride (floats) of shared tiles

static_assert(THREADS == 32 * (TILE / 8), "dense: 8 points per warp");

enum Act { ACT_NONE = 0, ACT_LEAKY = 1, ACT_SIN30 = 2 };
enum Mode { MODE_Z = 0, MODE_FADD = 1, MODE_ADD = 2 };

// ---- packed weight layouts: each Dense layer as W [in][out] row-major
// followed by its bias [out]; the backward's transposed copy has each W
// block as [out][in] at the same offset.
__host__ __device__ constexpr long dense_size(int in, int out) {
  return (long)in * out + out;
}

// SkipConnMLP wiring (nn/mlp.py): hidden layer i's input gains the init
// feature when i % 3 == 0, except the last layer.
__host__ __device__ constexpr bool skip_at(int i, int n_layers) {
  return i % 3 == 0 && i != n_layers - 1;
}

// Offset of Dense layer k (0 = layer_in, 1..NL = hidden, NL + 1 = out) of
// a SkipConnMLP (FI init rows, H wide, NL hidden layers) from its start.
__host__ __device__ constexpr long mlp_offset(int fi, int h, int nl, int k) {
  long off = 0;
  for (int j = 0; j < k; ++j)
    off += j == 0 ? dense_size(fi, h)
                  : dense_size(h + (skip_at(j - 1, nl) ? fi : 0), h);
  return off;
}

__host__ __device__ constexpr long mlp_size(int fi, int h, int nl, int out) {
  return mlp_offset(fi, h, nl, nl + 1) + dense_size(h, out);
}

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_LEAKY) return fmaxf(v, 0.01f * v);
  if (ACT == ACT_SIN30) return sinf(30.0f * v);
  return v;
}

// d act / d v, with autograd's convention at the leaky kink (0.01 at 0)
template <int ACT>
__device__ __forceinline__ float act_grad(float v) {
  if (ACT == ACT_LEAKY) return v > 0.0f ? 1.0f : 0.01f;
  if (ACT == ACT_SIN30) return 30.0f * cosf(30.0f * v);
  return 1.0f;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// ops/math.py sigmoid kinds, indexed like FUSED_SIGMOID_KINDS: the value
// and its derivative
__device__ __forceinline__ float rgb_act(float v, int kind, float* grad) {
  const float eps = 1e-2f;
  if (kind <= 3) {
    const float s = sigmoid(v);
    const float ds = s * (1.0f - s);
    switch (kind) {
      case 0: *grad = ds * (1.0f - 2.0f * eps);                   // thin
              return s * (1.0f - 2.0f * eps) + 2.0f * eps;
      case 1: *grad = ds * (1.0f + 2.0f * eps);                   // fat
              return s * (1.0f + 2.0f * eps) - eps;
      case 2: *grad = ds; return s;                               // normal
      default: *grad = ds; return s + eps;                        // upshifted
    }
  }
  switch (kind) {
    case 4: { const float t = tanhf(v); *grad = 1.0f - t * t; return t; }
    case 5: *grad = v > 0.0f ? 1.0f : 0.0f; return fmaxf(v, 0.0f);
    case 6: *grad = v > 0.0f ? 1.0f : 0.0f; return fmaxf(v, 0.0f) + eps;
    default: *grad = v > 0.0f ? 1.0f : 0.01f; return fmaxf(v, 0.01f * v);
  }
}

// The sample point r_o + t·r_d, rounded as the plain torch version rounds
// it (one IEEE op per torch op, no FMA contraction): the encoders
// multiply it by up to 2^15, so a contracted FMA would move their phases.
__device__ __forceinline__ float sample_point(float o, float t, float d) {
  return __fadd_rn(o, __fmul_rn(t, d));
}

// Per-ray constants: s[0..5] = the ray, s[6], s[7] = its elevation and
// azimuth (ops/math.py:dir_to_elev_azim).
__device__ __forceinline__ void ray_setup(const float* __restrict__ ray,
                                          float* s) {
#pragma unroll
  for (int c = 0; c < 6; ++c) s[c] = ray[c];
  const float norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
  const float inv = 1.0f / fmaxf(norm, 1e-12f);
  const float lim = 1.0f - 1e-6f;
  const float x = fminf(fmaxf(s[3] * inv, -lim), lim);
  const float y = fminf(fmaxf(s[4] * inv, -lim), lim);
  const float z = fminf(fmaxf(s[5] * inv, -lim), lim);
  s[6] = acosf(z);
  s[7] = atan2f(y, x);
}

// acc[j][i] += sum_k x[k][p0 + i] * w[k * LDW + lane + 32 j]
template <int K, int NOUT, int NJ, int LDW>
__device__ __forceinline__ void accumulate(const float* x,
                                           const float* __restrict__ w,
                                           int lane, int p0,
                                           float (&acc)[NJ][8]) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 x0 = *reinterpret_cast<const float4*>(x + k * PS + p0);
    const float4 x1 = *reinterpret_cast<const float4*>(x + k * PS + p0 + 4);
    const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = lane + 32 * j;
      const float wv = (o < NOUT) ? __ldg(w + (long)k * LDW + o) : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(xs[i], wv, acc[j][i]);
    }
  }
}

// Forward layer: dst[o][p] = act(z), z = b[o] + sum_k a[k][p] w[k][o] +
// sum_k f[k][p] w[KA + k][o] for the tile's 64 points and o < NOUT; with
// `zst` the pre-activation z also goes to the stash rows zst[o][p]. `w` is
// [KA + KF][NOUT] row-major with the bias after it. dst may alias a: every
// read finishes before the barrier that precedes the writes.
template <int KA, int KF, int NOUT, int ACT>
__device__ __forceinline__ void dense_fwd(const float* a, const float* f,
                                          const float* __restrict__ w,
                                          float* dst, float* zst) {
  constexpr int NJ = (NOUT + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * 8;
  const float* __restrict__ b = w + (long)(KA + KF) * NOUT;
  float acc[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = lane + 32 * j;
    const float bj = o < NOUT ? __ldg(b + o) : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = bj;
  }
  accumulate<KA, NOUT, NJ, NOUT>(a, w, lane, p0, acc);
  if (KF > 0) accumulate<KF, NOUT, NJ, NOUT>(f, w + (long)KA * NOUT, lane,
                                             p0, acc);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = lane + 32 * j;
    if (o < NOUT) {
      if (zst != nullptr) {
        *reinterpret_cast<float4*>(zst + o * TILE + p0) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        *reinterpret_cast<float4*>(zst + o * TILE + p0 + 4) =
            make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      }
      float4 v0, v1;
      v0.x = activate<ACT>(acc[j][0]); v0.y = activate<ACT>(acc[j][1]);
      v0.z = activate<ACT>(acc[j][2]); v0.w = activate<ACT>(acc[j][3]);
      v1.x = activate<ACT>(acc[j][4]); v1.y = activate<ACT>(acc[j][5]);
      v1.z = activate<ACT>(acc[j][6]); v1.w = activate<ACT>(acc[j][7]);
      *reinterpret_cast<float4*>(dst + o * PS + p0) = v0;
      *reinterpret_cast<float4*>(dst + o * PS + p0 + 4) = v1;
    }
  }
  __syncthreads();
}

// Hidden layers I..NL-1 of a SkipConnMLP in place in X (H rows), the skip
// layers reading act(init feature) from FA (FI rows); `w` points at the
// MLP's layer_in. With `zst`, hidden layer i's pre-activation goes to
// stash rows (i + 1)·H.
template <int H, int FI, int NL, int ACT, int I = 0>
__device__ __forceinline__ void mlp_hidden_fwd(float* X, const float* FA,
                                               const float* __restrict__ w,
                                               float* zst) {
  if constexpr (I < NL) {
    dense_fwd<H, skip_at(I, NL) ? FI : 0, H, ACT>(
        X, FA, w + mlp_offset(FI, H, NL, I + 1), X,
        zst != nullptr ? zst + (long)(I + 1) * H * TILE : nullptr);
    mlp_hidden_fwd<H, FI, NL, ACT, I + 1>(X, FA, w, zst);
  }
}

// A whole SkipConnMLP on the tile: init feature F (FI rows) and act(F) in
// FA -> its raw output in X rows 0..NOUT-1 (X holds H rows). With `zst`,
// the pre-activations of layer_in and the hidden layers go to the stash
// rows 0 .. (NL + 1)·H.
template <int FI, int H, int NL, int NOUT, int ACT>
__device__ __forceinline__ void mlp_fwd(const float* F, const float* FA,
                                        const float* __restrict__ w,
                                        float* X, float* zst) {
  dense_fwd<FI, 0, H, ACT>(F, nullptr, w, X, zst);
  mlp_hidden_fwd<H, FI, NL, ACT>(X, FA, w, zst);
  dense_fwd<H, 0, NOUT, ACT_NONE>(X, nullptr, w + mlp_offset(FI, H, NL, NL + 1),
                                  X, nullptr);
}

// The product of a whole SkipConnMLP in the forward helpers that a forward
// and a backward kernel share (render_dyn.cuh, render_volsdf.cuh): this
// one, the float32 FMAs of `mlp_fwd` (the forward kernels, the default),
// or mma_tf32.cuh's `tc::TcMlp` (the backward kernels' recompute). TC is
// the MLP's offset in the backward's TC pack and THREE whether its forward
// runs in three parts; FmaMlp reads neither.
struct FmaMlp {
  template <int FI, int H, int NL, int NOUT, int ACT, long TC, bool THREE>
  __device__ __forceinline__ void fwd(const float* F, const float* FA,
                                      const float* __restrict__ w, float* X,
                                      float* zst) const {
    mlp_fwd<FI, H, NL, NOUT, ACT>(F, FA, w, X, zst);
  }
};

// dst[r][p] = act(src[r][p]) for rows r < rows of the tile
template <int ACT>
__device__ __forceinline__ void act_rows(const float* src, float* dst,
                                         int rows) {
  for (int i = threadIdx.x; i < rows * TILE; i += THREADS) {
    const int idx = (i / TILE) * PS + (i % TILE);
    dst[idx] = activate<ACT>(src[idx]);
  }
}

// Rows 3 .. 3 + 6·NF of F from its rows 0..2 (the sample points): the
// positional encoding, dim-major, sin then cos: row 3 + j = sin(ph_j),
// row 3 + 3·NF + j = cos(ph_j), ph_j = p_{j / NF}·f_{j % NF} rounded once,
// f = the host's float32 2^linspace bands (nn/encoders.py), accurate
// sinf/cosf.
template <int NF>
__device__ __forceinline__ void posenc_rows(float* F, const float* fq) {
  constexpr int PE = 3 * NF;
  for (int i = threadIdx.x; i < PE * TILE; i += THREADS) {
    const int j = i / TILE, p = i % TILE;
    const float ph = __fmul_rn(F[(j / NF) * PS + p], fq[j % NF]);
    F[(3 + j) * PS + p] = sinf(ph);
    F[(3 + PE + j) * PS + p] = cosf(ph);
  }
}

// MipNeRF's Gaussian of sample `step` of ray s (ops/mip.py, in the plain
// version's order of operations): the segment [t0, t1] of `mip_segments`
// (the tail reuses the last finite width, clamped at 1e-5: not the 1e10
// tail the compositing uses), the conical frustum's (CONE) or the
// cylinder's moments at radius 1e-3, lifted along r_d -> mean[3] and the
// diagonal covariance cov[3]. `ts` is the ray's own row of sample
// positions: t1 and the tail's last two positions come from it too.
template <bool CONE>
__device__ __forceinline__ void ipe_moments(const float* s,
                                            const float* __restrict__ ts,
                                            int step, int steps,
                                            float* mean, float* cov) {
  const float t0 = ts[step];
  float t1;
  if (step + 1 < steps) {
    t1 = ts[step + 1];
  } else {
    const float last = __fsub_rn(ts[steps - 1], ts[steps - 2]);
    t1 = __fadd_rn(ts[steps - 1], fmaxf(last, 1e-5f));
  }
  const float rad = 1e-3f;
  float t_mean, t_var, r_var;
  if constexpr (CONE) {
    const float mu = __fmul_rn(__fadd_rn(t1, t0), 0.5f);
    const float hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
    const float mu2 = __fmul_rn(mu, mu);
    const float hw2 = __fmul_rn(hw, hw);
    const float hw4 = __fmul_rn(hw2, hw2);
    const float denom = __fadd_rn(__fmul_rn(3.0f, mu2), hw2);
    t_mean = __fadd_rn(mu, __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, mu), hw2),
                                     denom));
    const float num = __fmul_rn(hw4, __fsub_rn(__fmul_rn(12.0f, mu2), hw2));
    t_var = __fsub_rn(__fdiv_rn(hw2, 3.0f),
                      __fmul_rn((float)(4.0 / 15.0),
                                __fdiv_rn(num, __fmul_rn(denom, denom))));
    const float inner = __fsub_rn(
        __fadd_rn(__fmul_rn(mu2, 0.25f), __fmul_rn((float)(5.0 / 12.0), hw2)),
        __fdiv_rn(__fmul_rn((float)(4.0 / 15.0), hw4), denom));
    r_var = __fmul_rn(__fmul_rn(rad, rad), inner);
  } else {
    t_mean = __fmul_rn(__fadd_rn(t1, t0), 0.5f);
    const float d = __fsub_rn(t1, t0);
    t_var = __fdiv_rn(__fmul_rn(d, d), 12.0f);
    r_var = __fmul_rn(__fmul_rn(rad, rad), 0.25f);
  }
  float outer[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) outer[c] = __fmul_rn(s[3 + c], s[3 + c]);
  const float magn_sq = fmaxf(__fadd_rn(__fadd_rn(outer[0], outer[1]),
                                        outer[2]), 1e-10f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mean[c] = sample_point(s[c], t_mean, s[3 + c]);
    const float null_c = __fsub_rn(1.0f, __fdiv_rn(outer[c], magn_sq));
    cov[c] = __fadd_rn(__fmul_rn(t_var, outer[c]), __fmul_rn(r_var, null_c));
  }
}

// Rows 0..95 of F from the moments in M (rows 0..2 the mean, 3..5 the
// covariance): the integrated positional encoding at the scales 2^0..2^15,
// scale-major / axis-minor: row j = E[sin(y)], row 48 + j = E[sin(y +
// π/2)], y = mean_c·2^k, var = cov_c·4^k, j = 3k + c, E[sin] = exp(-var/2)
// · sin. The cosine half follows the JAX oracle (ops/mip.py), which takes
// sin(y + π/2), not cos(y) as the Pallas kernel does; at y ≈ 1e4 the two
// differ by up to ~5e-4.
__device__ __forceinline__ void ipe_rows(float* F, const float* M) {
  constexpr int DEGS = 16;
  const float half_pi = (float)(0.5 * 3.14159265358979323846);
  for (int i = threadIdx.x; i < 3 * DEGS * TILE; i += THREADS) {
    const int j = i / TILE, p = i % TILE;
    const int k = j / 3, c = j % 3;
    const float y = __fmul_rn(M[c * PS + p], (float)(1 << k));
    const float var = __fmul_rn(M[(3 + c) * PS + p],
                                (float)(1LL << (2 * k)));
    const float att = expf(__fmul_rn(-0.5f, var));
    F[j * PS + p] = __fmul_rn(att, sinf(y));
    F[(3 * DEGS + j) * PS + p] = __fmul_rn(att, sinf(__fadd_rn(y, half_pi)));
  }
}

// ---- the backward's building blocks ----

// Input gradient of a layer: r[k][p] = sum_{n < NIN} G[n][p] wt[n][k] for
// k < NOUT (wt row-major with row stride LDW, i.e. the layer's W
// transposed). MODE_Z: dst[k][p] = r · act'(z[k][p]), z from the stash
// rows zst (dst may alias G). MODE_FADD: dst[k][p] += r · act'(f[k][p]),
// f = the shared init feature rows. MODE_ADD: dst[k][p] += r.
template <int NIN, int NOUT, int LDW, int ACT, int MODE>
__device__ __forceinline__ void dense_bwd(const float* G,
                                          const float* __restrict__ wt,
                                          float* dst,
                                          const float* __restrict__ zst,
                                          const float* f) {
  constexpr int NJ = (NOUT + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * 8;
  float acc[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
  }
  accumulate<NIN, NOUT, NJ, LDW>(G, wt, lane, p0, acc);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = lane + 32 * j;
    if (o < NOUT) {
      float* d = dst + o * PS + p0;
      if (MODE == MODE_Z) {
        const float4 z0 = *reinterpret_cast<const float4*>(zst + o * TILE + p0);
        const float4 z1 =
            *reinterpret_cast<const float4*>(zst + o * TILE + p0 + 4);
        const float zs[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = acc[j][i] * act_grad<ACT>(zs[i]);
      } else if (MODE == MODE_FADD) {
        const float* fr = f + o * PS + p0;
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] += acc[j][i] * act_grad<ACT>(fr[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] += acc[j][i];
      }
    }
  }
  __syncthreads();
}

// X[r][p] = act(z[r][p]) for rows r < rows, z = stash rows
template <int ACT>
__device__ __forceinline__ void load_act(const float* __restrict__ z,
                                         int rows, float* X) {
  for (int i = threadIdx.x; i < rows * (TILE / 4); i += THREADS) {
    const int r = i / (TILE / 4), c = (i % (TILE / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(z + r * TILE + c);
    v.x = activate<ACT>(v.x); v.y = activate<ACT>(v.y);
    v.z = activate<ACT>(v.z); v.w = activate<ACT>(v.w);
    *reinterpret_cast<float4*>(X + r * PS + c) = v;
  }
}

// ---- the input gradient of one output column (VolSDF's ∇ₓsdf) ----
//
// For the output column c of a SkipConnMLP and one point, with h_i the
// pre-activation of layer_in (i = 0) and of hidden layer i − 1 (i >= 1)
// and a'_i = act'(h_i): u_NL = a'_NL ⊙ W_out[:, c] and, down the chain,
// u_i = a'_i ⊙ (W_i,h u_{i+1}), where W_i = [W_i,h ; W_i,f] is hidden
// layer i (W_i,f its init-feature rows at a skip layer); then
// d out_c / d init = Σ_skip act'(init) ⊙ (W_i,f u_{i+1}) + W_in u_0.

// G rows n < H <- w_col[LD·n] · act'(z[n][p]): the chain's seed u_NL,
// w_col = column c of layer_out (row c of its transposed copy, LD = 1, or
// of W_out itself, LD = its width), z = the last hidden pre-activation's
// stash rows.
template <int H, int ACT, int LD = 1>
__device__ __forceinline__ void seed_column(float* G,
                                            const float* __restrict__ w_col,
                                            const float* __restrict__ z) {
  for (int i = threadIdx.x; i < H * TILE; i += THREADS) {
    const int n = i / TILE, p = i % TILE;
    G[n * PS + p] = __ldg(w_col + LD * n) * act_grad<ACT>(z[n * TILE + p]);
  }
}

// rows < rows of G -> dst (row stride TILE, global memory)
__device__ __forceinline__ void store_rows(const float* G, int rows,
                                           float* __restrict__ dst) {
  for (int i = threadIdx.x; i < rows * (TILE / 4); i += THREADS) {
    const int r = i / (TILE / 4), c = (i % (TILE / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * TILE + c) =
        *reinterpret_cast<const float4*>(G + r * PS + c);
  }
}

// Hidden layers I..0 of `mlp_input_grad`, last first.
template <int FI, int H, int NL, int ACT, int I>
__device__ __forceinline__ void mlp_input_grad_hidden(
    float* G, const float* F, float* DF, const float* __restrict__ wt,
    const float* __restrict__ zst) {
  if constexpr (I >= 0) {
    constexpr bool SKIP = skip_at(I, NL);
    constexpr int KT = H + (SKIP ? FI : 0);
    constexpr long OFF = mlp_offset(FI, H, NL, I + 1);
    if (SKIP)
      dense_bwd<H, FI, KT, ACT, MODE_FADD>(G, wt + OFF + H, DF, nullptr, F);
    dense_bwd<H, H, KT, ACT, MODE_Z>(G, wt + OFF, G, zst + (long)I * H * TILE,
                                     nullptr);
    mlp_input_grad_hidden<FI, H, NL, ACT, I - 1>(G, F, DF, wt, zst);
  }
}

// The transpose chain on one tile. On entry G rows 0..H-1 hold u_NL
// (`seed_column`), F the init feature (FI rows) and DF zeros; zst is the
// forward's pre-activation stash (`mlp_fwd`'s rows), wt the MLP's
// transposed weights at its layer_in. On return DF holds d out_c / d
// init. G is overwritten.
template <int FI, int H, int NL, int ACT>
__device__ __forceinline__ void mlp_input_grad(float* G, const float* F,
                                               float* DF,
                                               const float* __restrict__ wt,
                                               const float* __restrict__ zst) {
  mlp_input_grad_hidden<FI, H, NL, ACT, NL - 1>(G, F, DF, wt, zst);
  dense_bwd<H, FI, FI, ACT_NONE, MODE_ADD>(G, wt, DF, nullptr, nullptr);
}

// out[i] = sum over blocks b (in order) of partial[b][i], i < wp (a
// template, so that only the backward sources that launch it compile it)
template <int = 0>
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int blocks,
                                       long wp) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wp) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(long)b * wp + i];
  out[i] = s;
}

}  // namespace render
