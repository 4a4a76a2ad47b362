// Device code shared by K8f (render_volsdf_fwd.cu) and K8b
// (render_volsdf_bwd.cu): the VolSDF architecture and its packed weight
// layout, the per-point steps both kernels round as the plain version
// does (the SDF init feature, the sphere bias, the Laplace density), the
// eikonal's per-point steps, and K8b's forward of one 64-point tile (its
// recompute). No float32-FMA MLP code remains: K8f's products and its
// transpose chain of ∇ₓsdf are wgmma_tf32.cuh's, K8b's recompute, chain
// and adjoint mma_tf32.cuh's.
//
// The chain of one sample point (nerf_atlas_tpu/ops/pallas/
// render_volsdf.py `_vs_chain_fwd`, models/volsdf.py VolSDF):
//   p = r_o + t·r_d, rounded after the product and after the sum
//   -> random Fourier features: y_j = 2π·((p_0 B_0j + p_1 B_1j) + p_2 B_2j),
//      every product and sum rounded on its own, accurate sinf/cosf
//      -> SDF init [p ‖ sin y ‖ cos y] (67)
//   -> SDF SkipConnMLP 67 -> 256×6 -> 33, leaky-relu 0.01, skips at
//      layers 0 and 3
//   -> sdf = out_0 + (‖p‖ − 1) (sphere init; the squares summed in axis
//      order, IEEE sqrt), latent = out_1..32
//   -> σ = LaplaceCDF(−sdf, s)/s: scaled = −sdf/s, e2 = ½·exp(−|scaled|),
//      cdf = e2 (scaled <= 0) or 1 − e2
//   -> siren View MLP on [p ‖ elev, azim ‖ latent] (37) -> 128×5 -> 3
// The eikonal of a point: g = ∇ₓsdf = d out_0 / d p + 2π·Σ_j (d out_0/d
// sin y_j · cos y_j − d out_0/d cos y_j · sin y_j)·B[:, j] + p/max(‖p‖,
// 1e-12), the first two through the MLP's transpose chain; its residual
// e = (‖g‖ − 1)².
#pragma once

#include "mma_tf32.cuh"
#include "render_common.cuh"

namespace vs {

using namespace render;

constexpr int N_FREQS = 32;
constexpr int S_IN = 3 + 2 * N_FREQS;          // 67: p ‖ sin ‖ cos
constexpr int S_HIDDEN = 256;
constexpr int S_LAYERS = 6;
constexpr int LATENT = 32;
constexpr int S_OUT = 1 + LATENT;              // sdf ‖ latent
constexpr int R_IN = 3 + 2 + LATENT;           // 37: p ‖ elaz ‖ latent
constexpr int R_HIDDEN = 128;
constexpr int R_LAYERS = 5;
constexpr int R_OUT = 3;
constexpr int F_ROWS = 68;                     // >= S_IN, R_IN
constexpr float TWO_PI = 6.283185307179586f;   // float32(2π)

static_assert(S_IN <= F_ROWS && R_IN <= F_ROWS, "init feature rows");

// ---- packed weight layout (ops/kernels/render_volsdf.py:pack_weights):
// the scale s, B [3][32] row-major, then the SDF MLP's and the View MLP's
// Dense layers, each W [in][out] row-major followed by its bias.
constexpr long SCALE = 0;
constexpr long FB = 1;
constexpr long S_MLP = FB + 3 * N_FREQS;                        // 97
constexpr long R_MLP = S_MLP + mlp_size(S_IN, S_HIDDEN, S_LAYERS, S_OUT);
constexpr long TOTAL = R_MLP + mlp_size(R_IN, R_HIDDEN, R_LAYERS, R_OUT);
constexpr long S_OUT_W = S_MLP + mlp_offset(S_IN, S_HIDDEN, S_LAYERS,
                                            S_LAYERS + 1);      // layer_out

// ---- K8b's TC pack (render_volsdf.py TC_MLPS, mma_tf32.cuh): the SDF
// MLP's, its forward blocks raw (S_THREE: its recompute and the eikonal
// adjoint's forward-like products run in three parts), then the View MLP's
constexpr bool S_THREE = true;
constexpr long TC_S = 0;
constexpr long TC_R =
    TC_S + tc::tc_mlp_floats(S_IN, S_HIDDEN, S_LAYERS, S_OUT, S_THREE);
constexpr long TC_TOTAL =
    TC_R + tc::tc_mlp_floats(R_IN, R_HIDDEN, R_LAYERS, R_OUT);

// ---- K8b's stash of a tile, in rows of TILE floats: the SDF MLP's
// pre-activations, then the View MLP's and the two init features
constexpr int ST_S = 0;                                  // z_in, z_0..z_5
constexpr int ST_R = ST_S + (S_LAYERS + 1) * S_HIDDEN;   // View z_in..z_4
constexpr int ST_FS = ST_R + (R_LAYERS + 1) * R_HIDDEN;  // SDF init
constexpr int ST_FR = ST_FS + S_IN;                      // View init
constexpr int ST_ROWS = ST_FR + R_IN;                    // 2,664
constexpr long ST_TILE = (long)ST_ROWS * TILE;
// the eikonal adjoint's u-stash: u_0..u_6
constexpr long U_TILE = (long)(S_LAYERS + 1) * S_HIDDEN * TILE;

// F rows 0..66 <- the SDF init feature of the block's points q0 .. q0 + 63
// (of n_pts; padding points repeat the last one); fb = B [3][32].
__device__ __forceinline__ void sdf_init_rows(float* F, const float* ray_s,
                                              const float* __restrict__ ts,
                                              const float* fb, int q0,
                                              int n_pts, int steps) {
  const int tid = threadIdx.x;
  if (tid < TILE) {
    const int q = min(q0 + tid, n_pts - 1);
    const float* s = ray_s + 8 * (q / steps);
    const float t = ts[q % steps];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      F[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
  }
  __syncthreads();
  for (int i = tid; i < N_FREQS * TILE; i += THREADS) {
    const int j = i / TILE, p = i % TILE;
    const float xb = __fadd_rn(__fadd_rn(__fmul_rn(F[p], fb[j]),
                                         __fmul_rn(F[PS + p], fb[N_FREQS + j])),
                               __fmul_rn(F[2 * PS + p], fb[2 * N_FREQS + j]));
    const float y = __fmul_rn(xb, TWO_PI);
    F[(3 + j) * PS + p] = sinf(y);
    F[(3 + N_FREQS + j) * PS + p] = cosf(y);
  }
  __syncthreads();
}

// ‖p‖ of point p (column p of F rows 0..2), as sphere_bias rounds it
__device__ __forceinline__ float point_norm(const float* F, int p) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(F[p], F[p]),
                                        __fmul_rn(F[PS + p], F[PS + p])),
                              __fmul_rn(F[2 * PS + p], F[2 * PS + p])));
}

// σ = LaplaceCDF(−sdf, s)/s and the two values its partials reuse
__device__ __forceinline__ float laplace_density(float sdf, float s,
                                                 float* e2, float* cdf) {
  const float scaled = __fdiv_rn(-sdf, s);
  *e2 = __fmul_rn(0.5f, expf(-fabsf(scaled)));
  *cdf = scaled <= 0.0f ? *e2 : __fsub_rn(1.0f, *e2);
  return __fdiv_rn(*cdf, s);
}

// K8b's forward of one tile: the block's sample points q0 .. q0 + 63 (of
// n_pts). H [S_HIDDEN][PS], F and FA [F_ROWS][PS] are shared-memory
// buffers; ray_s [rays][8] holds the block's rays (`ray_setup`), w the
// packed weights with B copied to fb. Each real point's σ goes to res[RS·q],
// its raw rgb to res[RS·q + 1..3] and its sdf to res[RS·q + 4]. With `st`
// (the tile's stash) the SDF MLP's pre-activations go there too, and with
// `full` the View MLP's and both init features. `mlp` (`tc::TcMlp`) runs
// the two MLPs.
template <int RS, class Mlp>
__device__ void tile_forward(float* H, float* F, float* FA,
                             const float* ray_s,
                             const float* __restrict__ ts, const float* fb,
                             const float* __restrict__ w, float s,
                             bool sphere, int q0, int n_pts, int steps,
                             float* res, float* st, bool full,
                             Mlp mlp) {
  const int tid = threadIdx.x;
  sdf_init_rows(F, ray_s, ts, fb, q0, n_pts, steps);
  for (int i = tid; i < S_IN * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    const float v = F[row * PS + p];
    FA[row * PS + p] = activate<ACT_LEAKY>(v);
    if (full) st[(ST_FS + row) * TILE + p] = v;
  }
  __syncthreads();
  mlp.template fwd<S_IN, S_HIDDEN, S_LAYERS, S_OUT, ACT_LEAKY, TC_S, S_THREE>(
      F, FA, w + S_MLP, H, st != nullptr ? st + ST_S * TILE : nullptr);

  // ---- sdf and σ; the View's init feature [p ‖ elev, azim ‖ latent]
  if (tid < TILE) {
    const int q = q0 + tid;
    float sdf = H[tid];
    if (sphere) sdf = __fadd_rn(sdf, __fsub_rn(point_norm(F, tid), 1.0f));
    float e2, cdf;
    const float sigma = laplace_density(sdf, s, &e2, &cdf);
    if (q < n_pts) {
      res[RS * q] = sigma;
      res[RS * q + 4] = sdf;
    }
    const float* rs = ray_s + 8 * (min(q, n_pts - 1) / steps);
    F[3 * PS + tid] = rs[6];
    F[4 * PS + tid] = rs[7];
  }
  for (int i = tid; i < LATENT * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    F[(5 + row) * PS + p] = H[(1 + row) * PS + p];
  }
  __syncthreads();
  for (int i = tid; i < R_IN * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    const float v = F[row * PS + p];
    FA[row * PS + p] = activate<ACT_SIN30>(v);
    if (full) st[(ST_FR + row) * TILE + p] = v;
  }
  __syncthreads();
  mlp.template fwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT, ACT_SIN30, TC_R, false>(
      F, FA, w + R_MLP, H, full ? st + ST_R * TILE : nullptr);
  if (tid < TILE && q0 + tid < n_pts) {
#pragma unroll
    for (int c = 0; c < 3; ++c) res[RS * (q0 + tid) + 1 + c] = H[c * PS + tid];
  }
  __syncthreads();
}

// Point p's g = ∇ₓsdf from DF (d out_0 / d init) and F (p ‖ sin ‖ cos);
// returns e = (‖g‖ − 1)² and, in de, ∂e/∂g.
__device__ __forceinline__ float eikonal_point(const float* F,
                                               const float* DF,
                                               const float* fb, bool sphere,
                                               int p, float* de) {
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 0; j < N_FREQS; ++j) {
    const float t = DF[(3 + j) * PS + p] * F[(3 + N_FREQS + j) * PS + p]
                    - DF[(3 + N_FREQS + j) * PS + p] * F[(3 + j) * PS + p];
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = fmaf(t, fb[c * N_FREQS + j], acc[c]);
  }
  float g[3];
  const float inv = sphere ? 1.0f / fmaxf(point_norm(F, p), 1e-12f) : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    g[c] = DF[c * PS + p] + TWO_PI * acc[c] + F[c * PS + p] * inv;
  const float r = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
  const float k = 2.0f * (r - 1.0f) / fmaxf(r, 1e-12f);
#pragma unroll
  for (int c = 0; c < 3; ++c) de[c] = k * g[c];
  return (r - 1.0f) * (r - 1.0f);
}

// DF rows 0..66 of point p <- ∂L/∂(d out_0 / d init) for the cotangent c
// = ∂L/∂g: c on the point's rows, and through the Fourier jacobian
// cB_j·cos y_j on the sin rows, −cB_j·sin y_j on the cos rows, cB = 2π·cB.
__device__ __forceinline__ void eikonal_cotangent(const float* F, float* DF,
                                                  const float* fb,
                                                  const float (&c)[3],
                                                  int p) {
  for (int j = 0; j < N_FREQS; ++j) {
    const float cb = TWO_PI * (c[0] * fb[j] + c[1] * fb[N_FREQS + j]
                               + c[2] * fb[2 * N_FREQS + j]);
    DF[(3 + j) * PS + p] = cb * F[(3 + N_FREQS + j) * PS + p];
    DF[(3 + N_FREQS + j) * PS + p] = -cb * F[(3 + j) * PS + p];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) DF[k * PS + p] = c[k];
}

}  // namespace vs
