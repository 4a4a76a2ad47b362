// Device code shared by K7f (render_ae_fwd.cu) and K7b (render_ae_bwd.cu):
// the NeRFAE architecture, its packed weight layout, K7b's TC pack and the
// latent's norm, which both kernels take in the same order; and K7b's
// recompute of one 64-point tile, its products on the tensor cores
// (mma_tf32.cuh `TcMlp`, split TF32), stashing what its backward reads.
// K7f runs the same chain by wgmma (render_ae_fwd.cu, wgmma_tf32.cuh).
//
// The chain of one sample point (nerf_atlas_tpu/ops/pallas/render_ae.py
// `_ae_chain_fwd`, models/nerf.py NeRFAE):
//   p = r_o + t·r_d, rounded after the product and after the sum
//   -> posenc: 8 bands f_k = the host's float32 2^linspace(0, 6, 8),
//      phase p_c·f_k rounded once, accurate sinf/cosf, dim-major, sin
//      then cos -> encoder init [p ‖ sin ‖ cos] (51)
//   -> encoder SkipConnMLP 51 -> 256×5 -> 32, leaky-relu 0.01, skips at
//      layers 0 and 3
//   -> y = x / max(‖x‖, 1e-6)
//   -> density_tfm SkipConnMLP 32 -> 128×4 -> 33, skip at layer 0
//   -> siren View MLP on [p ‖ elev, azim ‖ y ‖ feats] (69) -> 128×5 -> 3
//
#pragma once

#include "mma_tf32.cuh"
#include "render_common.cuh"

namespace ae {

using namespace render;

constexpr int N_FREQS = 8;
constexpr int PE = 3 * N_FREQS;              // 24 phases per point
constexpr int E_IN = 3 + 2 * PE;             // 51: p ‖ sin ‖ cos
constexpr int E_HIDDEN = 256;
constexpr int E_LAYERS = 5;
constexpr int ENC = 32;                      // encoding_size
constexpr int D_HIDDEN = 128;
constexpr int D_LAYERS = 4;
constexpr int INTERMEDIATE = 32;
constexpr int D_OUT_W = 1 + INTERMEDIATE;    // density ‖ 32 features
constexpr int R_IN = 3 + 2 + ENC + INTERMEDIATE;  // 69
constexpr int R_HIDDEN = 128;
constexpr int R_LAYERS = 5;
constexpr int R_OUT_W = 3;
constexpr int R_ENC = 5;                     // refl-init rows of the latent
constexpr int R_FEAT = R_ENC + ENC;          // ... and of the features
constexpr int F_ROWS = 72;                   // >= max(E_IN, R_IN)

static_assert(E_IN <= F_ROWS && R_IN <= F_ROWS, "init feature rows");

// ---- packed weight layout (ops/kernels/render_ae.py:pack_weights_ae, in
// `_flatten_params_ae` order: encode, density_tfm, refl.mlp): each Dense
// layer as W [in][out] row-major followed by its bias [out].
constexpr long E_IN_ = 0;
constexpr long E_L0 = E_IN_ + dense_size(E_IN, E_HIDDEN);
constexpr long E_L1 = E_L0 + dense_size(E_HIDDEN + E_IN, E_HIDDEN);
constexpr long E_L2 = E_L1 + dense_size(E_HIDDEN, E_HIDDEN);
constexpr long E_L3 = E_L2 + dense_size(E_HIDDEN, E_HIDDEN);
constexpr long E_L4 = E_L3 + dense_size(E_HIDDEN + E_IN, E_HIDDEN);
constexpr long E_OUT = E_L4 + dense_size(E_HIDDEN, E_HIDDEN);
constexpr long D_IN_ = E_OUT + dense_size(E_HIDDEN, ENC);
constexpr long D_L0 = D_IN_ + dense_size(ENC, D_HIDDEN);
constexpr long D_L1 = D_L0 + dense_size(D_HIDDEN + ENC, D_HIDDEN);
constexpr long D_L2 = D_L1 + dense_size(D_HIDDEN, D_HIDDEN);
constexpr long D_L3 = D_L2 + dense_size(D_HIDDEN, D_HIDDEN);
constexpr long D_OUT = D_L3 + dense_size(D_HIDDEN, D_HIDDEN);
constexpr long R_IN_ = D_OUT + dense_size(D_HIDDEN, D_OUT_W);
constexpr long R_L0 = R_IN_ + dense_size(R_IN, R_HIDDEN);
constexpr long R_L1 = R_L0 + dense_size(R_HIDDEN + R_IN, R_HIDDEN);
constexpr long R_L2 = R_L1 + dense_size(R_HIDDEN, R_HIDDEN);
constexpr long R_L3 = R_L2 + dense_size(R_HIDDEN, R_HIDDEN);
constexpr long R_L4 = R_L3 + dense_size(R_HIDDEN + R_IN, R_HIDDEN);
constexpr long R_OUT = R_L4 + dense_size(R_HIDDEN, R_HIDDEN);
constexpr long TOTAL = R_OUT + dense_size(R_HIDDEN, R_OUT_W);  // 564,804

// ---- K7b's TC pack (render_ae.py TC_MLPS, mma_tf32.cuh): the encoder's
// and density_tfm's, their forward blocks raw (the recompute runs their
// products in three parts: the backward's act′ comes from its
// pre-activations), then the View's
constexpr bool E_THREE = true;
constexpr bool D_THREE = true;
constexpr bool R_THREE = false;
constexpr long TC_E = 0;
constexpr long TC_D =
    TC_E + tc::tc_mlp_floats(E_IN, E_HIDDEN, E_LAYERS, ENC, E_THREE);
constexpr long TC_R =
    TC_D + tc::tc_mlp_floats(ENC, D_HIDDEN, D_LAYERS, D_OUT_W, D_THREE);
constexpr long TC_TOTAL =
    TC_R + tc::tc_mlp_floats(R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, R_THREE);

static_assert(mlp_offset(E_IN, E_HIDDEN, E_LAYERS, E_LAYERS + 1) + E_IN_
              == E_OUT && mlp_offset(ENC, D_HIDDEN, D_LAYERS, D_LAYERS + 1)
              + D_IN_ == D_OUT && mlp_offset(R_IN, R_HIDDEN, R_LAYERS,
              R_LAYERS + 1) + R_IN_ == R_OUT, "SkipConnMLP wiring");

// ---- the backward's stash of one tile, in rows of TILE floats
constexpr int ST_E = 0;                         // encoder z_in, z_0..z_4
constexpr int ST_D = ST_E + 6 * E_HIDDEN;       // density_tfm z_in, z_0..z_3
constexpr int ST_R = ST_D + 5 * D_HIDDEN;       // View z_in, z_0..z_4
constexpr int ST_FE = ST_R + 6 * R_HIDDEN;      // encoder init feature
constexpr int ST_X = ST_FE + E_IN;              // raw encoding
constexpr int ST_FR = ST_X + ENC;               // View init feature
constexpr int ST_ROWS = ST_FR + R_IN;           // 3096
constexpr long ST_TILE = (long)ST_ROWS * TILE;  // floats per tile

// ‖x‖ of one point's raw encoding (ENC values at stride `stride`), summed
// in one fixed order: the forward and the backward call this on the same
// values and get the same bits.
__device__ __forceinline__ float latent_norm(const float* x, int stride) {
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < ENC; ++k) s = fmaf(x[k * stride], x[k * stride], s);
  return sqrtf(s);
}

// The forward of one tile: the block's sample points q0 .. q0 + 63 (of
// n_pts; padding points repeat the last one). H [E_HIDDEN][PS], Fb and FA
// [F_ROWS][PS] are shared-memory buffers; ray_s [rays][8] holds the
// block's rays (`ray_setup`), fq the 8 frequencies. Each real point's raw
// density goes to res[RS·q] and its raw rgb to res[RS·q + 1..3]. With
// `st` (the backward's stash of this tile), every MLP pre-activation, the
// encoder's init feature, the raw encoding and the View's init feature go
// there too. On return Fb rows 0..68 hold the View's init feature. `mlp`
// runs the three MLPs (`tc::TcMlp`, with `st`).
template <int RS, class Mlp>
__device__ void tile_forward(float* H, float* Fb, float* FA,
                             const float* ray_s,
                             const float* __restrict__ ts, const float* fq,
                             const float* __restrict__ w, int q0, int n_pts,
                             int steps, float* res, float* st,
                             Mlp mlp) {
  const int tid = threadIdx.x;
  // ---- sample points -> rows 0..2 ----
  if (tid < TILE) {
    const int q = min(q0 + tid, n_pts - 1);
    const float* s = ray_s + 8 * (q / steps);
    const float t = ts[q % steps];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      Fb[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
  }
  __syncthreads();
  // ---- posenc: rows 3 + j = sin(phase_j), rows 27 + j = cos(phase_j),
  // phase_j = p_{j / 8} · f_{j % 8} ----
  posenc_rows<N_FREQS>(Fb, fq);
  __syncthreads();
  for (int i = tid; i < E_IN * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    const float v = Fb[row * PS + p];
    FA[row * PS + p] = activate<ACT_LEAKY>(v);
    if (st != nullptr) st[(ST_FE + row) * TILE + p] = v;
  }
  __syncthreads();

  // ---- encoder (skips at layers 0 and 3); the raw encoding lands in Fb
  // rows 5..36, where the View's init feature takes the latent ----
  float* ze = st != nullptr ? st + ST_E * TILE : nullptr;
  mlp.template fwd<E_IN, E_HIDDEN, E_LAYERS, ENC, ACT_LEAKY, TC_E, E_THREE>(
      Fb, FA, w + E_IN_, H, ze);
  for (int i = tid; i < ENC * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    Fb[(R_ENC + row) * PS + p] = H[row * PS + p];
  }
  __syncthreads();

  // ---- normalize: one thread per point ----
  if (tid < TILE) {
    float* x = Fb + R_ENC * PS + tid;
    const float m = fmaxf(latent_norm(x, PS), 1e-6f);
    for (int k = 0; k < ENC; ++k) {
      const float v = x[k * PS];
      if (st != nullptr) st[(ST_X + k) * TILE + tid] = v;
      x[k * PS] = v / m;
    }
  }
  __syncthreads();
  act_rows<ACT_LEAKY>(Fb + R_ENC * PS, FA + R_ENC * PS, ENC);
  __syncthreads();

  // ---- density_tfm (skip at layer 0) ----
  float* zd = st != nullptr ? st + ST_D * TILE : nullptr;
  mlp.template fwd<ENC, D_HIDDEN, D_LAYERS, D_OUT_W, ACT_LEAKY, TC_D,
                   D_THREE>(Fb + R_ENC * PS, FA + R_ENC * PS, w + D_IN_, H,
                            zd);

  // ---- raw density; View init feature [p ‖ elev, azim ‖ latent ‖ feats]
  if (tid < TILE) {
    const int q = q0 + tid;
    if (q < n_pts) res[RS * q] = H[tid];
    const float* s = ray_s + 8 * (min(q, n_pts - 1) / steps);
    Fb[3 * PS + tid] = s[6];
    Fb[4 * PS + tid] = s[7];
  }
  for (int i = tid; i < INTERMEDIATE * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    Fb[(R_FEAT + row) * PS + p] = H[(1 + row) * PS + p];
  }
  __syncthreads();
  for (int i = tid; i < R_IN * TILE; i += THREADS) {
    const int row = i / TILE, p = i % TILE;
    const float v = Fb[row * PS + p];
    FA[row * PS + p] = activate<ACT_SIN30>(v);
    if (st != nullptr) st[(ST_FR + row) * TILE + p] = v;
  }
  __syncthreads();

  // ---- siren View MLP (skips at layers 0 and 3) ----
  float* zr = st != nullptr ? st + ST_R * TILE : nullptr;
  mlp.template fwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30, TC_R,
                   R_THREE>(Fb, FA, w + R_IN_, H, zr);
  if (tid < TILE && q0 + tid < n_pts) {
#pragma unroll
    for (int c = 0; c < 3; ++c) res[RS * (q0 + tid) + 1 + c] = H[c * PS + tid];
  }
  __syncthreads();
}

}  // namespace ae
