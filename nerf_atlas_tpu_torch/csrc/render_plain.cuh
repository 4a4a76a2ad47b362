// The PlainNeRF / TinyNeRF render shared by K1 (render_fwd.cu), K2/K3
// (render_bwd.cu) and, as D-NeRF's canonical model, K9f / K9b
// (render_dyn_fwd.cu, render_dyn_bwd.cu): the architecture constants, the
// encoder modes (render.py ENC_KINDS), the packed weight layout of each
// mode, the init feature of a tile in the parameter-free modes, the CP
// encode of a tile rounded as the plain version rounds it, and the
// encoders' backward: the CP line gradients and the gradient of the
// features with respect to the encoded point (CP and posenc).

#pragma once

#include "render_common.cuh"

namespace plain {

using namespace render;

constexpr int RANK = 8;
constexpr int N_LEVELS = 4;       // resolutions 16 << l
constexpr int CP_DIM = N_LEVELS * RANK;     // 32
constexpr int HASH_FEATS = 16;              // 8 levels × 2 features
constexpr int INTERMEDIATE = 32;
constexpr int R_IN = 3 + 2 + INTERMEDIATE;  // 37
constexpr int R_HIDDEN = 128;
constexpr int R_LAYERS = 5;
constexpr int R_OUT_W = 3;
constexpr int MIP_FEATS = 96;               // 2 · 3 · 16 scales
// render.py ENC_KINDS
enum Enc { ENC_CP = 0, ENC_HASH = 1, ENC_POSENC = 2, ENC_TINY = 3,
           ENC_CONE = 4, ENC_CYLINDER = 5, N_ENC = 6 };
constexpr int MAX_FREQS = 16;

static_assert(THREADS == TILE * N_LEVELS, "CP: one (point, level) per "
              "thread");

// level l holds [3][16 << l][RANK]; levels 0..l-1 hold 3·RANK·16·(2^l - 1)
__host__ __device__ constexpr long line_offset(int l) {
  return 3L * RANK * 16 * ((1L << l) - 1);
}

// ---- packed weight layout (nerf_atlas_tpu_torch/ops/kernels/render.py:
// pack_weights): CP lines (cp only), then each Dense layer of the density
// MLP (tiny: its one MLP) and of the View MLP (not tiny) as W [in][out]
// row-major followed by its bias [out]. The backward's transposed copy
// `wt` has each W block as [out][in] at the same offset.
template <int ENC>
struct Layout {
  static constexpr bool MIP = ENC == ENC_CONE || ENC == ENC_CYLINDER;
  static constexpr bool VIEW = ENC != ENC_TINY;
  static constexpr int N_FREQS = ENC == ENC_POSENC ? 10
                                 : ENC == ENC_TINY ? 8 : 0;
  static constexpr int FEAT_IN =
      ENC == ENC_CP ? 3 + CP_DIM : ENC == ENC_HASH ? 3 + HASH_FEATS
      : MIP ? MIP_FEATS : 3 + 6 * N_FREQS;
  static constexpr int D_HIDDEN = ENC == ENC_TINY ? 128 : 256;
  static constexpr int D_LAYERS = ENC == ENC_TINY ? 6 : 5;
  static constexpr int D_OUT_W = ENC == ENC_TINY ? 4 : 1 + INTERMEDIATE;
  static constexpr int LINES =                    // 5760 (cp), 0 (others)
      ENC == ENC_CP ? (int)line_offset(N_LEVELS) : 0;
  static constexpr long D_IN = LINES;
  static constexpr long R_IN_ =
      D_IN + mlp_size(FEAT_IN, D_HIDDEN, D_LAYERS, D_OUT_W);
  static constexpr long TOTAL =
      R_IN_ + (VIEW ? mlp_size(R_IN, R_HIDDEN, R_LAYERS, R_OUT_W) : 0);
  // shared-memory rows: the hidden buffer, the init feature and its
  // activation (cp and hash keep K1's original 40)
  static constexpr int H_ROWS = D_HIDDEN > R_HIDDEN ? D_HIDDEN : R_HIDDEN;
  static constexpr int F_ROWS =
      ENC == ENC_CP || ENC == ENC_HASH ? 40 : (FEAT_IN + 3) / 4 * 4;
  static_assert(FEAT_IN <= F_ROWS && R_IN <= F_ROWS, "init feature rows");
};

// The sample positions (or segment lengths) of ray `ray` of a launch: the
// one shared row of a [T] grid (stride 0) or the ray's own row of [N, T]
// (stride T). A ray past the ragged edge reads the last ray's row, as its
// constants repeat the last ray's, so the last block stays inside [N, T].
__device__ __forceinline__ const float* ray_row(const float* __restrict__ p,
                                                int stride, int ray,
                                                int n_rays) {
  return p + (long)stride * min(ray, n_rays - 1);
}

// The init feature of a tile in the posenc, tiny and mip modes, the same
// in K1 and in K2/K3's forward: points q0 .. q0 + 63 of the block of rays
// from ray0 (padding points repeat the last one) -> F rows 0..FEAT_IN-1;
// each point reads its ray's row of ts (`ray_row`); mip uses S (rows
// 0..5) as scratch for its Gaussian moments.
template <int ENC>
__device__ __forceinline__ void encode_tile(float* F, float* S,
                                            const float* ray_s,
                                            const float* __restrict__ ts,
                                            int ts_stride, int ray0,
                                            int n_rays, const float* fq,
                                            int q0, int n_pts, int steps) {
  using L = Layout<ENC>;
  const int tid = threadIdx.x;
  if (tid < TILE) {
    const int q = min(q0 + tid, n_pts - 1);
    const float* s = ray_s + 8 * (q / steps);
    const float* row = ray_row(ts, ts_stride, ray0 + q / steps, n_rays);
    if constexpr (L::MIP) {
      float mean[3], cov[3];
      ipe_moments<ENC == ENC_CONE>(s, row, q % steps, steps, mean, cov);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        S[c * PS + tid] = mean[c];
        S[(3 + c) * PS + tid] = cov[c];
      }
    } else {
      const float t = row[q % steps];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        F[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
    }
  }
  __syncthreads();
  if constexpr (L::MIP) {
    ipe_rows(F, S);
  } else {
    posenc_rows<L::N_FREQS>(F, fq);
  }
}

// ---- the CP encode, rounded as the plain torch version rounds it (one
// IEEE op per torch op, no FMA contraction): the clamp((p + 1)·0.5) box,
// the tap and its fraction, (l0·(1 − fr)) + (l1·fr), and the product over
// the axes. The init features then agree bit for bit, so no leaky-relu
// input there sits on the other side of its kink in one of the two
// implementations.

// tap i0 (and i1 = min(i0 + 1, R - 1)) and fraction of coordinate x on a
// line of res_l entries
__device__ __forceinline__ float cp_tap(float x, int res_l, int* i0,
                                        int* i1) {
  const float xn = fminf(fmaxf(__fmul_rn(__fadd_rn(x, 1.0f), 0.5f), 0.0f),
                         1.0f);
  const float v = __fmul_rn(xn, (float)(res_l - 1));
  *i0 = min((int)floorf(v), res_l - 1);
  *i1 = min(*i0 + 1, res_l - 1);
  return __fsub_rn(v, (float)*i0);
}

__device__ __forceinline__ float cp_lerp(float l0, float l1, float fr) {
  return __fadd_rn(__fmul_rn(l0, __fsub_rn(1.0f, fr)), __fmul_rn(l1, fr));
}

// F rows 3 + 8 l + k <- the CP features of the tile's points (F rows 0..2),
// one (point, level) per thread; w points at the CP lines.
__device__ __forceinline__ void cp_encode_rows(float* F,
                                               const float* __restrict__ w) {
  const int p = threadIdx.x & (TILE - 1);
  const int l = threadIdx.x / TILE;
  const int res_l = 16 << l;
  const float* __restrict__ lines = w + line_offset(l);  // [3][R][8]
  float f[RANK];
#pragma unroll
  for (int k = 0; k < RANK; ++k) f[k] = 1.0f;
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    int i0, i1;
    const float fr = cp_tap(F[axis * PS + p], res_l, &i0, &i1);
    const float* __restrict__ l0 = lines + (axis * res_l + i0) * RANK;
    const float* __restrict__ l1 = lines + (axis * res_l + i1) * RANK;
#pragma unroll
    for (int k = 0; k < RANK; ++k)
      f[k] = __fmul_rn(f[k], cp_lerp(__ldg(l0 + k), __ldg(l1 + k), fr));
  }
#pragma unroll
  for (int k = 0; k < RANK; ++k) F[(3 + l * RANK + k) * PS + p] = f[k];
}

// The CP encoder's backward on a tile: F rows 0..2 hold the encoded
// points, DF rows 3..34 the features' cotangent d enc. The line gradients
// add into LG (the block's [LINES] accumulator in shared memory): each
// (point, level) thread stages its factor gradients and taps in X rows
// 0..119, then one thread per (level, axis, rank) scatters them in point
// order. With WANT_POS, d enc / d point adds into DF rows 0..2 (render.py
// `_cp_bwd(want_dpts=True)`): per axis a, level l and rank k, d enc_lk ·
// f_b·f_c · (l1 − l0)·(R_l − 1) (the derivative of the 2-tap lerp in its
// coordinate; 0 where the tap clamps at the last entry), summed over the
// levels (X rows 120..131), times the box's 0.5 where the clamp to [0, 1]
// passes its input (0 outside the box).
template <bool WANT_POS>
__device__ __forceinline__ void cp_backward(const float* F, float* DF,
                                            float* X, float* LG,
                                            const float* __restrict__ w) {
  const int tid = threadIdx.x;
  {
    const int p = tid & (TILE - 1);
    const int l = tid / TILE;
    const int res_l = 16 << l;
    const float* __restrict__ lines = w + line_offset(l);
    float f[3][RANK];
    float fr[3];
    int i0s[3], i1s[3];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      fr[axis] = cp_tap(F[axis * PS + p], res_l, &i0s[axis], &i1s[axis]);
      const float* __restrict__ l0 = lines + (axis * res_l + i0s[axis]) * RANK;
      const float* __restrict__ l1 = lines + (axis * res_l + i1s[axis]) * RANK;
#pragma unroll
      for (int k = 0; k < RANK; ++k)
        f[axis][k] = cp_lerp(__ldg(l0 + k), __ldg(l1 + k), fr[axis]);
    }
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
      const int b = axis == 0 ? 1 : 0, c = axis == 2 ? 1 : 2;
      const float* __restrict__ l0 = lines + (axis * res_l + i0s[axis]) * RANK;
      const float* __restrict__ l1 = lines + (axis * res_l + i1s[axis]) * RANK;
      float pos = 0.0f;
#pragma unroll
      for (int k = 0; k < RANK; ++k) {
        const float d = DF[(3 + l * RANK + k) * PS + p] * f[b][k] * f[c][k];
        X[((l * 3 + axis) * RANK + k) * PS + p] = d;
        if (WANT_POS) pos += d * (__ldg(l1 + k) - __ldg(l0 + k));
      }
      X[(96 + l * 3 + axis) * PS + p] = (float)i0s[axis];
      X[(108 + l * 3 + axis) * PS + p] = fr[axis];
      if (WANT_POS) X[(120 + l * 3 + axis) * PS + p] = pos * (float)(res_l - 1);
    }
  }
  __syncthreads();
  constexpr int SCATTER = 3 * N_LEVELS * RANK;              // 96 threads
  if (tid < SCATTER) {
    const int l = tid / (3 * RANK), axis = (tid / RANK) % 3;
    const int k = tid % RANK;
    const int res_l = 16 << l;
    float* lg = LG + line_offset(l) + axis * res_l * RANK + k;
    const float* df = X + tid * PS;
    const float* i0r = X + (96 + l * 3 + axis) * PS;
    const float* frr = X + (108 + l * 3 + axis) * PS;
    for (int p = 0; p < TILE; ++p) {
      const int i0 = (int)i0r[p];
      const int i1 = min(i0 + 1, res_l - 1);
      lg[i0 * RANK] += df[p] * (1.0f - frr[p]);
      lg[i1 * RANK] += df[p] * frr[p];
    }
  } else if (WANT_POS) {
    for (int i = tid - SCATTER; i < 3 * TILE; i += THREADS - SCATTER) {
      const int axis = i / TILE, p = i % TILE;
      const float u = __fmul_rn(__fadd_rn(F[axis * PS + p], 1.0f), 0.5f);
      if (u >= 0.0f && u <= 1.0f) {
        float s = 0.0f;
#pragma unroll
        for (int l = 0; l < N_LEVELS; ++l) s += X[(120 + l * 3 + axis) * PS + p];
        DF[axis * PS + p] += 0.5f * s;
      }
    }
  }
  __syncthreads();
}

// The posenc bands' backward on a tile (render.py `_posenc_bwd`): F rows
// 3 + j and 3 + 3·NF + j hold sin and cos of ph_j = p_{j / NF}·f_{j % NF},
// DF the same rows' cotangent; d ph_j = d sin_j·cos_j − d cos_j·sin_j, and
// Σ_f d ph·f adds into DF row j / NF (the point's coordinate).
template <int NF>
__device__ __forceinline__ void posenc_position_grad(const float* F,
                                                     float* DF,
                                                     const float* fq) {
  constexpr int PE = 3 * NF;
  for (int i = threadIdx.x; i < 3 * TILE; i += THREADS) {
    const int axis = i / TILE, p = i % TILE;
    float s = 0.0f;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int j = axis * NF + f;
      const float dph = DF[(3 + j) * PS + p] * F[(3 + PE + j) * PS + p]
                        - DF[(3 + PE + j) * PS + p] * F[(3 + j) * PS + p];
      s += dph * fq[f];
    }
    DF[axis * PS + p] += s;
  }
  __syncthreads();
}

}  // namespace plain
