// K2/K3: backward of the fused PlainNeRF / TinyNeRF render on Hopper, in
// six instantiations: enc_kind "cp", "hash", "posenc", "tiny", "cone" and
// "cylinder" (K1's, render_fwd.cu).
//
// Replaces nerf_atlas_tpu/ops/pallas/render.py:_render_bwd_kernel (every
// enc_kind, [1, T] or [B, T] ts: K1's shared or per-ray sample positions,
// by the same row stride), both of its modes, in one source:
//   mode G (K2, the autograd backward of K1): takes the output cotangent
//     g [N, 4] (rgb ‖ acc) and returns d(Σ g·out)/d(weights);
//   mode L (K3, the one-kernel train step): takes target [N, 3] and
//     loss_scale = 1/(3N), computes loss = loss_scale·Σ(out_rgb − target)²
//     from its own forward and back-propagates the cotangent
//     2·loss_scale·(out_rgb − target) (0 on acc).
// Both return the float32 gradient of the packed weight vector (the
// layout of ops/kernels/render.py:pack_weights); rays and ts get none.
// The hash mode reads each sample point's 16 hash-grid features (feats
// [N·T, 16], K5f's output) where cp encodes, has no line gradients, and
// writes dfeat [N·T, 16], the density MLP's input cotangent on those
// feature columns (the raw-point columns dropped), for K5b. The posenc,
// tiny and mip encoders have no parameters: those modes write MLP weight
// gradients only and form no input cotangent of the density MLP. Tiny
// has no View MLP: its one MLP's output cotangent is [dσ ‖ d rgb_raw].
//
// Per block of rays (max(1, 64/T) rays, as in K1), in two passes:
//   pass 1 re-runs K1's forward tile by tile (64 sample points per tile:
//     the same encoders, split skip matmuls, accurate sinf, elev/azim
//     in-kernel) and stashes every MLP pre-activation and both init
//     features in a per-block scratch in global memory;
//   then one thread per ray composites front to back (α, transmittance,
//     outputs, the cotangent, the loss) and walks back to front with the
//     suffix sum S_t = Σ_{s>t} A_s w_s: dα = A·T − S/max(1−α, 1e-10),
//     dσ = dα·Δt‖r_d‖·(1−α), d density = dσ·sigmoid(density − 1);
//   pass 2 walks the tiles again and chains the hand VJPs: rgb activation
//     → View MLP (sin(30h), derivative 30·cos(30h) with accurate cosf)
//     → density MLP (leaky-relu 0.01) → CP line gradients (cp) or the
//     feature cotangent dfeat (hash).
//
// What bounds it: compute, about three times K1's (the forward, then per
// layer the input-gradient and the weight-gradient products; the density
// MLP's input gradient is skipped where no encoder parameter needs it),
// plus the stash (608 KB per 64-point tile for cp, written once and read
// once) and the per-block weight-gradient partials.
//
// Design (simple and exact, not yet fast): float32 FMAs on the CUDA
// cores, one 256-thread block per SM (cp: about 197 KB of shared memory:
// two 256-row activation/gradient tiles, the init features, their
// activations and gradient, and the CP line gradients; mip's 96-row init
// feature takes ~218 KB). The grid is at most one block per SM; each
// block loops over ray blocks. The weight gradient is deterministic:
// every block accumulates into its own partial row of WEIGHT_COUNT + 1
// floats (each entry owned by one thread, tiles in a fixed order; the CP
// line gradients first in shared memory, one thread per (level, axis,
// rank) walking the points in order), and a second kernel sums the rows
// in block order. No float atomics anywhere.
//
// Plain C interface for ctypes (built with nvcc into a shared library).
// build.py compiles it once per mode, with -DRENDER_BWD_ENC=<enc>, so
// that the six instantiations compile in parallel; a library holds and
// launches its own mode only.

#include "render_plain.cuh"

#ifndef RENDER_BWD_ENC
#error "build render_bwd.cu with -DRENDER_BWD_ENC=<mode>"
#endif

using namespace plain;

namespace {

constexpr int SMEM_FLOATS = 232448 / 4;     // a block's shared memory
constexpr int STEP_CAP = 1024;

static_assert(3 * N_LEVELS * RANK <= THREADS, "CP bwd: one thread per "
              "(level, axis, rank)");
static_assert(RENDER_BWD_ENC >= 0 && RENDER_BWD_ENC < N_ENC,
              "RENDER_BWD_ENC: an index of render.py ENC_KINDS");

// Layout<ENC> and what the backward adds: the stash of one tile and the
// longest ray shared memory holds.
template <int ENC>
struct BwdLayout : Layout<ENC> {
  using L = Layout<ENC>;
  // the density MLP's input cotangent: the CP lines' and K5b's
  static constexpr bool WANT_DF = ENC == ENC_CP || ENC == ENC_HASH;
  static constexpr long WP = L::TOTAL + 1;        // partial row: grads ‖ loss
  // ---- stash rows per tile (each row holds TILE floats)
  static constexpr int ST_D = 0;                  // density z_in, z_0..
  static constexpr int ST_R =                     // View z_in, z_0..z_4
      ST_D + (L::D_LAYERS + 1) * L::D_HIDDEN;
  static constexpr int ST_FD =                    // density init feature
      ST_R + (L::VIEW ? (R_LAYERS + 1) * R_HIDDEN : 0);
  static constexpr int ST_FR = ST_FD + L::FEAT_IN;  // View init feature
  static constexpr int ST_ROWS = ST_FR + (L::VIEW ? R_IN : 0);  // 2376 (cp)
  static constexpr long ST_TILE = (long)ST_ROWS * TILE;  // floats per tile
  // the longest ray whose 8 floats per point still fit in shared memory
  static constexpr int FIXED =
      (2 * L::H_ROWS + 3 * L::F_ROWS) * PS + L::LINES + 13 + MAX_FREQS;
  static constexpr int MAX_STEPS =
      (SMEM_FLOATS - FIXED) / 8 < STEP_CAP ? (SMEM_FLOATS - FIXED) / 8
                                           : STEP_CAP;
};

template <int ENC>
size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)BwdLayout<ENC>::FIXED
                          + 8 * (size_t)rays_per_block * steps
                          + 13 * (size_t)(rays_per_block - 1));
}

template <int ENC>
__global__ void __launch_bounds__(THREADS, 1)
render_bwd_kernel(const float* __restrict__ rays,
                  const float* __restrict__ ts,
                  const float* __restrict__ dists,
                  const float* __restrict__ w,
                  const float* __restrict__ wt,
                  const float* __restrict__ gin,
                  const float* __restrict__ feats,
                  const float* __restrict__ freqs,
                  float* __restrict__ dfeat,
                  float* __restrict__ partial,
                  float* __restrict__ stash,
                  int n_rays, int steps, int ts_stride, int rays_per_block,
                  int n_rb, int tiles, int sigmoid_kind, int sky_white,
                  int loss_mode, float loss_scale) {
  using L = BwdLayout<ENC>;
  constexpr int FEAT_IN = L::FEAT_IN;
  constexpr int F_ROWS = L::F_ROWS;
  constexpr int LINE_TOTAL = L::LINES;
  constexpr long WP = L::WP;
  constexpr int ST_FD = L::ST_FD;
  constexpr int ST_FR = L::ST_FR;
  constexpr long ST_TILE = L::ST_TILE;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);        // [H_ROWS][PS]
  float* G = X + L::H_ROWS * PS;                     // [H_ROWS][PS]
  float* F = G + L::H_ROWS * PS;                     // [F_ROWS][PS]
  float* FA = F + F_ROWS * PS;                       // act(F)
  float* DF = FA + F_ROWS * PS;                      // d F
  float* LG = DF + F_ROWS * PS;                      // [LINE_TOTAL]
  float* fq = LG + LINE_TOTAL;                       // [MAX_FREQS]
  float* res = fq + MAX_FREQS;                       // [points][8]
  float* ray_s = res + 8 * rays_per_block * steps;   // [rays][8]
  float* ray_g = ray_s + 8 * rays_per_block;         // [rays][4]
  float* ray_l = ray_g + 4 * rays_per_block;         // [rays]

  const int tid = threadIdx.x;
  const int n_pts = rays_per_block * steps;
  float* part = partial + (long)blockIdx.x * WP;
  float* st_block = stash + (long)blockIdx.x * tiles * ST_TILE;
  float loss_acc = 0.0f;
  for (int i = tid; i < LINE_TOTAL; i += THREADS) LG[i] = 0.0f;
  if (tid < L::N_FREQS) fq[tid] = freqs[tid];

  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const int ray0 = rb * rays_per_block;
    // per-ray constants; rays past the ragged edge repeat the last ray and
    // get a zero cotangent
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const int ray = min(ray0 + r, n_rays - 1);
      ray_setup(rays + 6L * ray, ray_s + 8 * r);
      float* gr = ray_g + 4 * r;
      if (loss_mode) {
        for (int c = 0; c < 3; ++c) gr[c] = gin[3L * ray + c];
        gr[3] = 0.0f;
      } else {
        for (int c = 0; c < 4; ++c) gr[c] = gin[4L * ray + c];
      }
    }
    __syncthreads();

    // ---- pass 1: forward, stashing the chain ----
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      float* st = st_block + tile * ST_TILE;
      if constexpr (ENC == ENC_CP || ENC == ENC_HASH) {
        if (tid < TILE) {
          const int q = min(q0 + tid, n_pts - 1);
          const float* s = ray_s + 8 * (q / steps);
          const float t =
              ray_row(ts, ts_stride, ray0 + q / steps, n_rays)[q % steps];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            F[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
        }
        if constexpr (ENC == ENC_HASH) {
          // hash features -> rows 3..18 (padding rows repeat the last point)
          for (int i = tid; i < TILE * HASH_FEATS; i += THREADS) {
            const int p = i / HASH_FEATS, j = i % HASH_FEATS;
            const int q = min(q0 + p, n_pts - 1);
            const long g = (long)min(ray0 + q / steps, n_rays - 1) * steps
                           + q % steps;
            F[(3 + j) * PS + p] = __ldg(feats + g * HASH_FEATS + j);
          }
        }
        __syncthreads();
        if constexpr (ENC == ENC_CP) {
          // CP encode (render_plain.cuh): rows 3 + 8 l + k, rounded as the
          // plain version rounds it
          cp_encode_rows(F, w);
        }
      } else {
        encode_tile<ENC>(F, X, ray_s, ts, ts_stride, ray0, n_rays, fq, q0,
                         n_pts, steps);
      }
      __syncthreads();
      for (int i = tid; i < FEAT_IN * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = F[row * PS + p];
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
        st[(ST_FD + row) * TILE + p] = v;
      }
      __syncthreads();

      mlp_fwd<FEAT_IN, L::D_HIDDEN, L::D_LAYERS, L::D_OUT_W, ACT_LEAKY>(
          F, FA, w + L::D_IN, X, st + L::ST_D * TILE);

      if constexpr (!L::VIEW) {
        // tiny: density and rgb (raw) straight from the MLP's outputs
        if (tid < TILE && q0 + tid < n_pts) {
#pragma unroll
          for (int c = 0; c < 4; ++c) res[8 * (q0 + tid) + c] = X[c * PS + tid];
        }
      } else {
        // density (raw); View init feature [p ‖ elev, azim ‖ feats]
        if (tid < TILE) {
          const int q = q0 + tid;
          if (q < n_pts) res[8 * q] = X[tid];
          const int qc = min(q, n_pts - 1);
          const float* s = ray_s + 8 * (qc / steps);
          if constexpr (L::MIP) {
            // mip's init feature holds no p: the point again, rounded alike
            const float t = ray_row(ts, ts_stride, ray0 + qc / steps,
                                    n_rays)[qc % steps];
#pragma unroll
            for (int c = 0; c < 3; ++c)
              F[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
          }
          F[3 * PS + tid] = s[6];
          F[4 * PS + tid] = s[7];
        }
        for (int i = tid; i < INTERMEDIATE * TILE; i += THREADS) {
          const int row = i / TILE, p = i % TILE;
          F[(5 + row) * PS + p] = X[(1 + row) * PS + p];
        }
        __syncthreads();
        for (int i = tid; i < R_IN * TILE; i += THREADS) {
          const int row = i / TILE, p = i % TILE;
          const float v = F[row * PS + p];
          FA[row * PS + p] = activate<ACT_SIN30>(v);
          st[(ST_FR + row) * TILE + p] = v;
        }
        __syncthreads();

        mlp_fwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30>(
            F, FA, w + L::R_IN_, X, st + L::ST_R * TILE);
        if (tid < TILE && q0 + tid < n_pts) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            res[8 * (q0 + tid) + 1 + c] = X[c * PS + tid];
        }
      }
      __syncthreads();
    }

    // ---- compositing, its cotangent and VJP: one thread per ray ----
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const bool valid = ray0 + r < n_rays;
      const float* s = ray_s + 8 * r;
      const float* dr = ray_row(dists, ts_stride, ray0 + r, n_rays);
      const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
      float* e = res + 8 * r * steps;
      float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
      float out[3] = {0.0f, 0.0f, 0.0f};
      for (int t = 0; t < steps; ++t) {
        float* et = e + 8 * t;
        const float alpha = 1.0f - expf(-softplus(et[0] - 1.0f)
                                        * (dr[t] * rd_norm));
        const float wt_ = alpha * trans;
        float dummy;
        acc += wt_;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          out[c] += wt_ * rgb_act(et[1 + c], sigmoid_kind, &dummy);
        et[4] = alpha;
        et[5] = trans;
        trans *= fmaxf(1.0f - alpha, 1e-10f);
        w_last = wt_;
      }
      const float sky = sky_white ? 1.0f - (acc - w_last) : 0.0f;
      const float* gr = ray_g + 4 * r;
      float g[4];
      float sq = 0.0f;
      if (loss_mode) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float diff = out[c] + sky - gr[c];
          sq += diff * diff;
          g[c] = 2.0f * loss_scale * diff;
        }
        g[3] = 0.0f;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = gr[c];
      }
      if (!valid) {
        sq = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = 0.0f;
      }
      ray_l[r] = loss_scale * sq;
      float S = 0.0f;                               // Σ_{s>t} A_s w_s
      for (int t = steps - 1; t >= 0; --t) {
        float* et = e + 8 * t;
        const float alpha = et[4], tr = et[5];
        const float wt_ = alpha * tr;
        const float mask = (sky_white && t < steps - 1) ? 1.0f : 0.0f;
        float rgb[3], drgb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = rgb_act(et[1 + c], sigmoid_kind,
                                                     &drgb[c]);
        const float A = g[3] + g[0] * (rgb[0] - mask) + g[1] * (rgb[1] - mask)
                        + g[2] * (rgb[2] - mask);
        const float dalpha = A * tr - S / fmaxf(1.0f - alpha, 1e-10f);
        S += A * wt_;
        const float dsig = dalpha * (dr[t] * rd_norm) * (1.0f - alpha);
        et[4] = dsig * sigmoid(et[0] - 1.0f);       // d density (raw)
#pragma unroll
        for (int c = 0; c < 3; ++c) et[5 + c] = g[c] * wt_ * drgb[c];
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < rays_per_block; ++r) loss_acc += ray_l[r];
    }

    // ---- pass 2: hand VJP of the MLPs and the CP encoder, per tile ----
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      const float* st = st_block + tile * ST_TILE;
      const float* zd = st + L::ST_D * TILE;

      if constexpr (!L::VIEW) {
        // tiny: G <- [d density ‖ d rgb_raw] (zero on padding points)
        for (int i = tid; i < 4 * TILE; i += THREADS) {
          const int row = i / TILE, p = i % TILE;
          G[row * PS + p] = q0 + p < n_pts ? res[8 * (q0 + p) + 4 + row]
                                           : 0.0f;
        }
      } else {
        const float* zr = st + L::ST_R * TILE;
        // View MLP: G <- d rgb_raw (zero on the tile's padding points)
        for (int i = tid; i < F_ROWS * TILE; i += THREADS) {
          const int row = i / TILE, p = i % TILE;
          const float v = row < R_IN ? st[(ST_FR + row) * TILE + p] : 0.0f;
          F[row * PS + p] = v;
          FA[row * PS + p] = activate<ACT_SIN30>(v);
          DF[row * PS + p] = 0.0f;
        }
        if (tid < TILE) {
          const int q = q0 + tid;
#pragma unroll
          for (int c = 0; c < 3; ++c)
            G[c * PS + tid] = q < n_pts ? res[8 * q + 5 + c] : 0.0f;
        }
        load_act<ACT_SIN30>(zr + R_LAYERS * R_HIDDEN * TILE, R_HIDDEN, X);
        __syncthreads();
        mlp_bwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30, true>(
            X, G, F, FA, DF, wt + L::R_IN_, part + L::R_IN_, zr);

        // density MLP: G <- [d density ‖ d feats (DF rows 5..36)]
        for (int i = tid; i < L::D_OUT_W * TILE; i += THREADS) {
          const int row = i / TILE, p = i % TILE;
          float v;
          if (row == 0) {
            v = q0 + p < n_pts ? res[8 * (q0 + p) + 4] : 0.0f;
          } else {
            v = DF[(4 + row) * PS + p];
          }
          G[row * PS + p] = v;
        }
      }
      __syncthreads();
      for (int i = tid; i < F_ROWS * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = row < FEAT_IN ? st[(ST_FD + row) * TILE + p] : 0.0f;
        F[row * PS + p] = v;
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
        if (L::WANT_DF) DF[row * PS + p] = 0.0f;
      }
      load_act<ACT_LEAKY>(zd + L::D_LAYERS * L::D_HIDDEN * TILE, L::D_HIDDEN,
                          X);
      __syncthreads();
      mlp_bwd<FEAT_IN, L::D_HIDDEN, L::D_LAYERS, L::D_OUT_W, ACT_LEAKY,
              L::WANT_DF>(X, G, F, FA, DF, wt + L::D_IN, part + L::D_IN, zd);

      if constexpr (ENC == ENC_HASH) {
        // dfeat = DF rows 3..18 for the points of real rays (a padding
        // ray repeats the last ray and must not overwrite its row)
        for (int i = tid; i < TILE * HASH_FEATS; i += THREADS) {
          const int p = i / HASH_FEATS, j = i % HASH_FEATS;
          const int q = q0 + p;
          if (q < n_pts && ray0 + q / steps < n_rays)
            dfeat[((long)ray0 * steps + q) * HASH_FEATS + j] =
                DF[(3 + j) * PS + p];
        }
        __syncthreads();
      } else if constexpr (ENC == ENC_CP) {
        // CP lines: d enc = DF rows 3..34 -> LG (render_plain.cuh)
        cp_backward<false>(F, DF, X, LG, w);
      }
    }
  }

  // the CP line gradients and the loss go to this block's partial once
  for (int i = tid; i < LINE_TOTAL; i += THREADS) part[i] = LG[i];
  if (tid == 0) part[L::TOTAL] = loss_acc;
}

template <int ENC>
int launch(const float* rays, const float* ts, const float* dists,
           const float* weights, const float* weights_t, const float* gin,
           const float* feats, const float* freqs, float* dfeat, float* out,
           float* partial, float* stash, int n_rays, int steps, int ts_stride,
           int blocks, int sigmoid_kind, int sky_white, int loss_mode,
           float loss_scale, cudaStream_t s) {
  constexpr long WP = BwdLayout<ENC>::WP;
  if (steps > BwdLayout<ENC>::MAX_STEPS) return cudaErrorInvalidValue;
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const int n_rb = (n_rays + rays_per_block - 1) / rays_per_block;
  if (blocks > n_rb) return cudaErrorInvalidValue;
  const int tiles = (rays_per_block * steps + TILE - 1) / TILE;
  const size_t smem = smem_bytes<ENC>(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_bwd_kernel<ENC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)blocks * WP, s);
  if (err != cudaSuccess) return err;
  render_bwd_kernel<ENC><<<blocks, THREADS, smem, s>>>(
      rays, ts, dists, weights, weights_t, gin, feats, freqs, dfeat, partial,
      stash, n_rays, steps, ts_stride, rays_per_block, n_rb, tiles,
      sigmoid_kind, sky_white, loss_mode, loss_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<><<<(int)((WP + 255) / 256), 256, 0, s>>>(
      partial, out, blocks, WP);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define RENDER_BWD_SWITCH(EXPR, FALLBACK)                                   \
  switch (enc) {                                                            \
    case ENC_CP: { constexpr int E = ENC_CP; return EXPR; }                 \
    case ENC_HASH: { constexpr int E = ENC_HASH; return EXPR; }             \
    case ENC_POSENC: { constexpr int E = ENC_POSENC; return EXPR; }         \
    case ENC_TINY: { constexpr int E = ENC_TINY; return EXPR; }             \
    case ENC_CONE: { constexpr int E = ENC_CONE; return EXPR; }             \
    case ENC_CYLINDER: { constexpr int E = ENC_CYLINDER; return EXPR; }     \
    default: return FALLBACK;                                               \
  }

// Floats in the packed weight buffer the kernel expects for `enc` (the
// index of render.py ENC_KINDS); -1 for an unknown enc.
long long render_bwd_weight_count(int enc) {
  RENDER_BWD_SWITCH(Layout<E>::TOTAL, -1)
}

// Floats of stash per 64-point tile (the wrapper sizes the scratch).
long long render_bwd_stash_floats_per_tile(int enc) {
  RENDER_BWD_SWITCH(BwdLayout<E>::ST_TILE, -1)
}

// The most sample points per ray `enc` takes (shared memory holds 8
// floats per point of a ray).
int render_bwd_max_steps(int enc) {
  RENDER_BWD_SWITCH(BwdLayout<E>::MAX_STEPS, -1)
}

// The posenc bands the kernel expects in `freqs` for `enc` (0: none).
int render_bwd_freq_count(int enc) {
  RENDER_BWD_SWITCH(Layout<E>::N_FREQS, -1)
}

// The mode this library launches (RENDER_BWD_ENC).
int render_bwd_built_enc() { return RENDER_BWD_ENC; }

const char* render_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one backward on `stream`; returns the cudaError_t of the
// launches. ts, dists: [steps] shared by every ray (ts_stride 0) or [N,
// steps] per ray (ts_stride = steps). gin: g [N, 4] (loss_mode 0) or
// target [N, 3] (loss_mode 1).
// feats, dfeat: [N·steps, 16] for enc hash, else unused; freqs: the
// posenc bands (`render_bwd_freq_count`) for enc posenc and tiny, else
// unused. out: [weight count + 1] (gradient ‖ loss). partial: blocks ×
// (weight count + 1) floats; stash: blocks × tiles ×
// stash_floats_per_tile(enc) floats, tiles = ceil(rays_per_block · steps /
// 64), rays_per_block = max(1, 64 / steps).
int render_bwd_launch(const float* rays, const float* ts, const float* dists,
                      const float* weights, const float* weights_t,
                      const float* gin, const float* feats,
                      const float* freqs, float* dfeat, float* out,
                      float* partial, float* stash, int n_rays, int steps,
                      int ts_stride, int blocks, int sigmoid_kind,
                      int sky_white, int loss_mode, float loss_scale,
                      int enc, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || (ts_stride != 0 && ts_stride != steps) || sigmoid_kind < 0
      || sigmoid_kind > 7 || blocks <= 0
      || enc != RENDER_BWD_ENC
      || (enc == ENC_HASH && (feats == nullptr || dfeat == nullptr))
      || (render_bwd_freq_count(enc) > 0 && freqs == nullptr))
    return cudaErrorInvalidValue;
  return launch<RENDER_BWD_ENC>(
      rays, ts, dists, weights, weights_t, gin, feats, freqs, dfeat, out,
      partial, stash, n_rays, steps, ts_stride, blocks, sigmoid_kind,
      sky_white, loss_mode, loss_scale, static_cast<cudaStream_t>(stream));
}

#undef RENDER_BWD_SWITCH

}  // extern "C"
