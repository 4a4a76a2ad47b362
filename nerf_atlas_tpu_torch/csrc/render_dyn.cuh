// Device code shared by K9f (render_dyn_fwd.cu) and K9b (render_dyn_bwd.cu):
// the D-NeRF / Spline-NeRF architecture and its packed weight layout, the
// warp's Fourier rows and de Casteljau, which both kernels run; the
// Bernstein weights, and K9b's recompute of one 64-point tile (the warp,
// the rigidity gate and the canonical PlainNeRF chain, its products on the
// tensor cores: mma_tf32.cuh `TcMlp`). K9f runs the same chain by wgmma
// (render_dyn_fwd.cu, wgmma_tf32.cuh). The per-layer building blocks are
// render_common.cuh's and mma_tf32.cuh's, the canonical model's layout, CP
// encode and encoder backward render_plain.cuh's.
//
// The chain of one sample point (nerf_atlas_tpu/ops/pallas/render_dyn.py
// `_warp_fwd`, `_dyn_kernel`; models/dyn.py DynamicNeRF):
//   p = r_o + t_s·r_d, rounded after the product and after the sum; t =
//     the ray's time
//   -> the warp's init feature [x ‖ sin y ‖ cos y], x = (p, t) (Δx, 68
//      rows) or p (spline, 67 rows), y_j = 2π·(Σ_d x_d·B_dj) with every
//      product and sum rounded on its own, in dimension order, accurate
//      sinf/cosf
//   -> warp SkipConnMLP -> 256×5, leaky-relu 0.01, skips at layers 0 and
//      3 -> Δx (3) or the control points P_1..P_{S−1} (packed at 30
//      columns), de Casteljau at t in the plain version's lerp order
//      (β_j·(1 − t) + β_{j+1}·t, P_0 = 0)
//   -> gate = σ(rigidity(p)), rigidity a 3 -> 64×3 -> 1 SkipConnMLP;
//      dp = spl·gate, x' = p + dp
//   -> the canonical PlainNeRF on x' (cp: CP encode of the [-1, 1] box;
//      posenc: 10 bands), density MLP 256×5 -> 33, siren View 128×5 on
//      [x' ‖ elev, azim ‖ feats]
#pragma once

#include "mma_tf32.cuh"
#include "render_plain.cuh"

#ifndef RENDER_DYN_ENC
#error "build render_dyn_*.cu with -DRENDER_DYN_ENC=<0 cp | 2 posenc>"
#endif
#ifndef RENDER_DYN_SPLINE
#error "build render_dyn_*.cu with -DRENDER_DYN_SPLINE=<0 dx | 1 spline>"
#endif

namespace dyn {

using namespace plain;

constexpr int ENC = RENDER_DYN_ENC;
constexpr bool SPLINE = RENDER_DYN_SPLINE != 0;
static_assert(ENC == ENC_CP || ENC == ENC_POSENC,
              "the D-NeRF kernels take the cp or posenc canonical");

using C = Layout<ENC>;                       // the canonical PlainNeRF
constexpr int W_FREQS = 32;
constexpr int W_IN = SPLINE ? 3 : 4;         // x = p (spline) or (p, t)
constexpr int W_FI = W_IN + 2 * W_FREQS;     // 67 or 68
constexpr int W_HIDDEN = 256;
constexpr int W_LAYERS = 5;
constexpr int MAX_SPLINE = 11;               // ops/kernels/render_dyn.py
constexpr int W_OUT = SPLINE ? 3 * (MAX_SPLINE - 1) : 3;
constexpr int G_HIDDEN = 64;
constexpr int G_LAYERS = 3;
constexpr int F_ROWS = 68;                   // >= W_FI, C::FEAT_IN, R_IN
static_assert(W_FI <= F_ROWS && C::FEAT_IN <= F_ROWS && R_IN <= F_ROWS,
              "init feature rows");
static_assert(W_OUT <= 32, "the warp's output: one column per lane");

// ---- packed weight layout (ops/kernels/render_dyn.py:pack_weights): B
// [W_IN][32], the warp MLP, the rigidity MLP (each Dense W [in][out]
// row-major then its bias), then the canonical PlainNeRF as K1 packs it.
constexpr long FB = 0;
constexpr long W_MLP = FB + W_IN * W_FREQS;
constexpr long G_MLP = W_MLP + mlp_size(W_FI, W_HIDDEN, W_LAYERS, W_OUT);
constexpr long CANON = G_MLP + mlp_size(3, G_HIDDEN, G_LAYERS, 1);
constexpr long TOTAL = CANON + C::TOTAL;

// ---- K9b's TC pack (render_dyn.py Layout.tc_mlps, mma_tf32.cuh): the
// warp MLP's, the rigidity MLP's, the canonical density and View MLPs'.
// The three MLPs with leaky-relu kinks keep their forward blocks raw and
// run their forward products in three parts (LEAKY_THREE): the backward's
// act′ pattern comes from the recompute, and the rays the kink rule clears
// (testing.dyn_kink_free_rays, margin 10 float32 round-offs) assume
// float32-grade pre-activations.
constexpr bool LEAKY_THREE = true;
constexpr long TC_W = 0;
constexpr long TC_G = TC_W + tc::tc_mlp_floats(W_FI, W_HIDDEN, W_LAYERS, W_OUT,
                                               LEAKY_THREE);
constexpr long TC_D = TC_G + tc::tc_mlp_floats(3, G_HIDDEN, G_LAYERS, 1,
                                               LEAKY_THREE);
constexpr long TC_R = TC_D + tc::tc_mlp_floats(C::FEAT_IN, C::D_HIDDEN,
                                               C::D_LAYERS, C::D_OUT_W,
                                               LEAKY_THREE);
constexpr long TC_TOTAL =
    TC_R + tc::tc_mlp_floats(R_IN, R_HIDDEN, R_LAYERS, R_OUT_W);

// ---- per point, beside the MLP tiles: rows of A (shared, [A_ROWS][PS])
constexpr int A_P = 0;                       // p, 3 rows
constexpr int A_T = 3;                       // t
constexpr int A_SPL = 4;                     // spl = Δx before the gate, 3
constexpr int A_GATE = 7;                    // σ(rigidity(p))
constexpr int A_ROWS = 8;

// ---- a tile's stash (K9b), in rows of TILE floats
constexpr int ST_W = 0;                                  // warp z_in..z_4
constexpr int ST_G = ST_W + (W_LAYERS + 1) * W_HIDDEN;   // rigidity z
constexpr int ST_FW = ST_G + (G_LAYERS + 1) * G_HIDDEN;  // warp init
constexpr int ST_A = ST_FW + W_FI;                       // A rows
constexpr int ST_D = ST_A + A_ROWS;                      // density z
constexpr int ST_R = ST_D + (C::D_LAYERS + 1) * C::D_HIDDEN;  // View z
constexpr int ST_FD = ST_R + (R_LAYERS + 1) * R_HIDDEN;  // density init
constexpr int ST_FR = ST_FD + C::FEAT_IN;                // View init
constexpr int ST_ROWS = ST_FR + R_IN;
constexpr long ST_TILE = (long)ST_ROWS * TILE;

// F rows W_IN .. W_FI − 1 <- sin and cos of the warp's Fourier phases of
// the tile's x (F rows 0 .. W_IN − 1); fb = B [W_IN][32] (shared).
__device__ __forceinline__ void fourier_rows(float* F, const float* fb) {
  for (int i = threadIdx.x; i < W_FREQS * TILE; i += THREADS) {
    const int j = i / TILE, p = i % TILE;
    float xb = __fmul_rn(F[p], fb[j]);
#pragma unroll
    for (int d = 1; d < W_IN; ++d)
      xb = __fadd_rn(xb, __fmul_rn(F[d * PS + p], fb[d * W_FREQS + j]));
    const float y = __fmul_rn(xb, 6.283185307179586f);   // float32(2π)
    F[(W_IN + j) * PS + p] = sinf(y);
    F[(W_IN + W_FREQS + j) * PS + p] = cosf(y);
  }
}

// The warp's displacement before the gate at time t from the warp MLP's
// outputs o (rows of H, column p): Δx (o rows 0..2), or de Casteljau over
// P_0 = 0, P_j = o rows 3(j−1) .. 3j − 1, in the plain version's lerp
// order.
__device__ __forceinline__ void spline_eval(const float* H, int p, float t,
                                            int spline_points,
                                            float (&spl)[3]) {
  if constexpr (!SPLINE) {
#pragma unroll
    for (int c = 0; c < 3; ++c) spl[c] = H[c * PS + p];
  } else {
    const float m1t = __fsub_rn(1.0f, t);
    for (int c = 0; c < 3; ++c) {
      float b[MAX_SPLINE];
      b[0] = 0.0f;
      for (int j = 1; j < spline_points; ++j) b[j] = H[(3 * (j - 1) + c) * PS + p];
      for (int level = 1; level < spline_points; ++level)
        for (int j = 0; j < spline_points - level; ++j)
          b[j] = __fadd_rn(__fmul_rn(b[j], m1t), __fmul_rn(b[j + 1], t));
      spl[c] = b[0];
    }
  }
}

// B_{j,n}(t) = C(n, j)·t^j·(1 − t)^{n−j} for j = 1..n, n = S − 1, into
// w[0..n−1] (render_dyn.py `_bernstein_weights`): the weight of control
// point j in the curve de Casteljau evaluates, i.e. its adjoint.
__device__ __forceinline__ void bernstein_weights(float t, int n,
                                                  float (&w)[MAX_SPLINE]) {
  float tp[MAX_SPLINE], op[MAX_SPLINE];
  tp[0] = t;
  op[0] = 1.0f - t;
  for (int k = 1; k < n; ++k) {
    tp[k] = tp[k - 1] * t;
    op[k] = op[k - 1] * op[0];
  }
  float comb = 1.0f;                         // C(n, j), built up in j
  for (int j = 1; j <= n; ++j) {
    comb = comb * (float)(n - j + 1) / (float)j;
    float v = comb * tp[j - 1];
    if (n - j > 0) v = v * op[n - j - 1];
    w[j - 1] = v;
  }
}

// The warp and the gate of one tile: the block's sample points q0 .. q0 +
// 63 (of n_pts; padding points repeat the last one). H [256][PS], F and FA
// [F_ROWS][PS] and A [A_ROWS][PS] are shared; ray_s [rays][8] holds the
// block's rays (`ray_setup`), ray_t their times, fb = B. On return F rows
// 0..2 hold the warped points x' = p + dp, A the rows above, and each real
// point's mean over the axes of dp² is at res[RS·q + RM]. With `st` (the
// tile's stash) the warp's and the rigidity's pre-activations, the warp's
// init feature and the A rows go there too. `mlp` runs the two MLPs
// (`tc::TcMlp`, with `st`).
template <int RS, int RM, class Mlp>
__device__ void warp_forward(float* H, float* F, float* FA, float* A,
                             const float* ray_s, const float* ray_t,
                             const float* __restrict__ ts, const float* fb,
                             const float* __restrict__ w, int spline_points,
                             int q0, int n_pts, int steps, float* res,
                             float* st, Mlp mlp) {
  const int tid = threadIdx.x;
  if (tid < TILE) {
    const int q = min(q0 + tid, n_pts - 1);
    const float* s = ray_s + 8 * (q / steps);
    const float tt = ts[q % steps];
    const float t = ray_t[q / steps];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float p = sample_point(s[c], tt, s[3 + c]);
      F[c * PS + tid] = p;
      A[(A_P + c) * PS + tid] = p;
    }
    if constexpr (!SPLINE) F[3 * PS + tid] = t;
    A[A_T * PS + tid] = t;
  }
  __syncthreads();
  fourier_rows(F, fb);
  __syncthreads();
  for (int i = tid; i < W_FI * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    const float v = F[row * PS + p];
    FA[row * PS + p] = activate<ACT_LEAKY>(v);
    if (st != nullptr) st[(ST_FW + row) * TILE + p] = v;
  }
  __syncthreads();
  mlp.template fwd<W_FI, W_HIDDEN, W_LAYERS, W_OUT, ACT_LEAKY, TC_W,
                   LEAKY_THREE>(
      F, FA, w + W_MLP, H, st != nullptr ? st + ST_W * TILE : nullptr);
  if (tid < TILE) {
    float spl[3];
    spline_eval(H, tid, A[A_T * PS + tid], spline_points, spl);
#pragma unroll
    for (int c = 0; c < 3; ++c) A[(A_SPL + c) * PS + tid] = spl[c];
  }
  __syncthreads();
  // the rigidity MLP reads p and leaky(p): F and FA rows 0..2
  mlp.template fwd<3, G_HIDDEN, G_LAYERS, 1, ACT_LEAKY, TC_G, LEAKY_THREE>(
      F, FA, w + G_MLP, H, st != nullptr ? st + ST_G * TILE : nullptr);
  if (tid < TILE) {
    const float gate = sigmoid(H[tid]);
    A[A_GATE * PS + tid] = gate;
    float sq[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float dp = __fmul_rn(A[(A_SPL + c) * PS + tid], gate);
      F[c * PS + tid] = __fadd_rn(A[(A_P + c) * PS + tid], dp);
      sq[c] = __fmul_rn(dp, dp);
    }
    if (q0 + tid < n_pts)
      res[RS * (q0 + tid) + RM] = __fdiv_rn(__fadd_rn(__fadd_rn(sq[0], sq[1]),
                                                      sq[2]), 3.0f);
  }
  __syncthreads();
  if (st != nullptr) {
    for (int i = tid; i < A_ROWS * TILE; i += THREADS) {
      const int row = i / TILE, p = i % TILE;
      st[(ST_A + row) * TILE + p] = A[row * PS + p];
    }
  }
}

// The canonical PlainNeRF on the tile's warped points (F rows 0..2, as
// `warp_forward` leaves them): each real point's raw density goes to
// res[RS·q], its raw rgb to res[RS·q + 1..3]. With `st` the density and
// View MLPs' pre-activations and both init features go to the tile's
// stash. F rows 0..2 keep x' (the View reads them). `mlp` as in
// `warp_forward`.
template <int RS, class Mlp>
__device__ void canonical_forward(float* H, float* F, float* FA,
                                  const float* ray_s,
                                  const float* __restrict__ w,
                                  const float* fq, int q0, int n_pts,
                                  int steps, float* res, float* st,
                                  Mlp mlp) {
  const int tid = threadIdx.x;
  const float* __restrict__ wc = w + CANON;
  if constexpr (ENC == ENC_CP) {
    cp_encode_rows(F, wc);
  } else {
    posenc_rows<C::N_FREQS>(F, fq);
  }
  __syncthreads();
  for (int i = tid; i < C::FEAT_IN * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    const float v = F[row * PS + p];
    FA[row * PS + p] = activate<ACT_LEAKY>(v);
    if (st != nullptr) st[(ST_FD + row) * TILE + p] = v;
  }
  __syncthreads();
  mlp.template fwd<C::FEAT_IN, C::D_HIDDEN, C::D_LAYERS, C::D_OUT_W,
                   ACT_LEAKY, TC_D, LEAKY_THREE>(
      F, FA, wc + C::D_IN, H, st != nullptr ? st + ST_D * TILE : nullptr);
  // raw density; the View's init feature [x' ‖ elev, azim ‖ feats]
  if (tid < TILE) {
    const int q = q0 + tid;
    if (q < n_pts) res[RS * q] = H[tid];
    const float* s = ray_s + 8 * (min(q, n_pts - 1) / steps);
    F[3 * PS + tid] = s[6];
    F[4 * PS + tid] = s[7];
  }
  for (int i = tid; i < INTERMEDIATE * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    F[(5 + row) * PS + p] = H[(1 + row) * PS + p];
  }
  __syncthreads();
  for (int i = tid; i < R_IN * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    const float v = F[row * PS + p];
    FA[row * PS + p] = activate<ACT_SIN30>(v);
    if (st != nullptr) st[(ST_FR + row) * TILE + p] = v;
  }
  __syncthreads();
  mlp.template fwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30, TC_R, false>(
      F, FA, wc + C::R_IN_, H, st != nullptr ? st + ST_R * TILE : nullptr);
  if (tid < TILE && q0 + tid < n_pts) {
#pragma unroll
    for (int c = 0; c < 3; ++c) res[RS * (q0 + tid) + 1 + c] = H[c * PS + tid];
  }
  __syncthreads();
}

}  // namespace dyn
