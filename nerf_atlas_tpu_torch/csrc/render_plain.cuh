// The PlainNeRF / TinyNeRF render shared by K1 (render_fwd.cu) and K2/K3
// (render_bwd.cu): the architecture constants, the encoder modes (render.py
// ENC_KINDS), the packed weight layout of each mode and the init feature
// of a tile in the parameter-free modes.

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

// The init feature of a tile in the posenc, tiny and mip modes, the same
// in K1 and in K2/K3's forward: points q0 .. q0 + 63 of the block
// (padding points repeat the last one) -> F rows 0..FEAT_IN-1; mip uses S
// (rows 0..5) as scratch for its Gaussian moments.
template <int ENC>
__device__ __forceinline__ void encode_tile(float* F, float* S,
                                            const float* ray_s,
                                            const float* __restrict__ ts,
                                            const float* fq, int q0,
                                            int n_pts, int steps) {
  using L = Layout<ENC>;
  const int tid = threadIdx.x;
  if (tid < TILE) {
    const int q = min(q0 + tid, n_pts - 1);
    const float* s = ray_s + 8 * (q / steps);
    if constexpr (L::MIP) {
      float mean[3], cov[3];
      ipe_moments<ENC == ENC_CONE>(s, ts, q % steps, steps, mean, cov);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        S[c * PS + tid] = mean[c];
        S[(3 + c) * PS + tid] = cov[c];
      }
    } else {
      const float t = ts[q % steps];
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

}  // namespace plain
