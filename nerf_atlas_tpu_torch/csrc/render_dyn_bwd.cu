// K9b: backward of the fused D-NeRF / Spline-NeRF render on Hopper, built
// once per (canonical encoder, warp kind) as K9f is (-DRENDER_DYN_ENC,
// -DRENDER_DYN_SPLINE).
//
// Replaces nerf_atlas_tpu/ops/pallas/render_dyn.py:_dyn_bwd_kernel, both
// of its modes, in one source:
//   mode G (the autograd backward of K9f): takes the output cotangent
//     g [N, 4] (rgb ‖ acc), with want_dp [N, 5] (‖ the cotangent of K9f's
//     dp² column), and returns d(Σ g·out)/d(weights);
//   mode L (the one-kernel train step): takes target [N, 3], loss_scale =
//     1/(3N) and dp_coeff = dp_weight/N; computes loss = loss_scale·Σ(out_rgb
//     − target)² (+ dp_coeff·Σ_rays the ray's mean dp², with want_dp) from
//     its own forward and back-propagates 2·loss_scale·(out_rgb − target)
//     (0 on acc) and dp_coeff per ray on the dp² column.
// Both return the float32 gradient of the packed weight vector (the layout
// of render_dyn.cuh / ops/kernels/render_dyn.py:pack_weights); B's entries
// are 0 (B takes no gradient), and so are the spline's padding columns;
// rays, times and ts get none.
//
// Per block of rays (max(1, 64/T) rays, as in K9f), in two passes:
//   pass 1 re-runs K9f's chain tile by tile (render_dyn.cuh
//     `warp_forward`, `canonical_forward`, its MLP products on the
//     tensor cores) and stashes every MLP pre-activation of the four
//     MLPs, the three init features and the per-point p, t, Δx and gate
//     (4,244 rows of 64 floats, 1.09 MB per tile for cp) in a per-block
//     scratch in global memory;
//   then one thread per ray composites front to back (α, transmittance,
//     outputs, the cotangent, the loss) and walks back to front with the
//     suffix sum S_t = Σ_{s>t} A_s w_s (render_bwd.cu's code) to d density
//     and d rgb;
//   pass 2 walks the tiles again and chains the hand VJPs: the View MLP
//     (sin(30h)), whose input gradient gives d feats and, on its rows 0..2,
//     d x'; the density MLP (leaky-relu 0.01), whose input gradient gives
//     d x' on its raw rows 0..2 and d enc; the encoder: CP line gradients
//     and d enc/d x' (render_plain.cuh `cp_backward<true>`) or the posenc
//     bands' derivative (`posenc_position_grad`); then d dp = d x' (+
//     g₅·2·dp/(3T) for the dp² column), d spl = d dp·gate, d gate = Σ d
//     dp·spl times σ′ = gate·(1 − gate); for the spline d spl scatters to
//     control point j by its Bernstein weight B_{j,S−1}(t) (the adjoint of
//     de Casteljau's linear map; P_0 has no slot); then the warp MLP's and
//     the rigidity MLP's weight gradients (`tc::mlp_bwd`; their input
//     cotangents are not formed: the sample points are leaves and B is
//     fixed).
//
// What bounds it: compute, ~5.0 MFLOP per sample point (the forward, then
// per layer the input-gradient and the weight-gradient products, less the
// input gradients no output needs: the warp's and the rigidity's onto
// their init features, the View's onto elev/azim), plus the stash (written
// once, read once) and the per-block weight-gradient partials. On the
// tensor cores each multiply-add is three TF32 products (six in the
// leaky MLPs' forward ones), against the TF32 peak.
//
// Design (render_bwd.cu's): every MLP product (the recompute, the input
// and the weight gradients) runs on the tensor cores in split TF32
// (mma_tf32.cuh, ~3·2^-22 relative per term; the wrapper pre-splits the
// weights into the TC pack, render_dyn.py `Layout.tc_mlps`); the warp's,
// the rigidity's and the density MLP's forward products, whose
// pre-activations decide the leaky-relu slopes, in three parts
// (render_dyn.cuh `LEAKY_THREE`, ≲ 2^-32 per term). Products are staged by
// cp.async through rows the product does not read: in pass 1 the G rows
// above the per-point rows A (the warp's 256-wide products take 16,384 of
// G's 16,864 free floats), in pass 2 the X rows once each layer's weight
// gradient has read them. The warp's Fourier rows, the encoders, the CP
// line gradients, the position gradients, the gate, the Bernstein adjoint
// and the compositing stay float32 on the CUDA cores, rounded as before.
// One 256-thread block per SM (~213 KB of shared memory for cp: two
// 256-row activation/gradient tiles, three 68-row init-feature tiles and
// the CP line gradients). The grid is at most one block per SM; each
// block loops over ray blocks. The gradient is deterministic: every block
// accumulates into its own partial row of TOTAL + 1 floats (each entry
// owned by one thread, tiles in a fixed order; the CP line gradients first
// in shared memory; the loss summed by one thread in double) and a second
// kernel sums the rows in block order. No float atomics anywhere: two
// launches are bit-identical.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "mma_tf32.cuh"
#include "render_dyn.cuh"

using namespace dyn;

namespace {

constexpr int SMEM_FLOATS = 232448 / 4;      // a block's shared memory
constexpr int STEP_CAP = 1024;
constexpr int RS = 9;                        // per point, see pass 1
constexpr int RAY_FLOATS = 16;               // ray_s 8, ray_g 5, loss, t
constexpr long WP = TOTAL + 1;               // partial row: grads ‖ loss
// the longest ray whose RS floats per point still fit in shared memory
// (B takes 4 rows of 32 in both warp kinds: one step limit per encoder)
constexpr int FIXED = (2 * W_HIDDEN + 3 * F_ROWS) * PS + C::LINES
                      + 4 * W_FREQS + MAX_FREQS + RAY_FLOATS;
constexpr int MAX_STEPS = (SMEM_FLOATS - FIXED) / RS < STEP_CAP
                              ? (SMEM_FLOATS - FIXED) / RS : STEP_CAP;
// pass 1 stages the products' weights in the G rows above A; pass 2 in X
static_assert(A_ROWS * PS + tc::stage_floats(W_HIDDEN) <= W_HIDDEN * PS,
              "weight staging");

size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)FIXED + RS * (size_t)rays_per_block * steps
                          + RAY_FLOATS * (size_t)(rays_per_block - 1));
}

__global__ void __launch_bounds__(THREADS, 1)
render_dyn_bwd_kernel(const float* __restrict__ rays,
                      const float* __restrict__ times,
                      const float* __restrict__ ts,
                      const float* __restrict__ dists,
                      const float* __restrict__ w,
                      const float* __restrict__ tcw,
                      const float* __restrict__ gin,
                      const float* __restrict__ freqs,
                      float* __restrict__ partial,
                      float* __restrict__ stash,
                      int n_rays, int steps, int rays_per_block, int n_rb,
                      int tiles, int spline_points, int sigmoid_kind,
                      int sky_white, int want_dp, int loss_mode,
                      float loss_scale, float dp_coeff) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);        // [256][PS]
  float* G = X + W_HIDDEN * PS;                      // [256][PS]
  float* F = G + W_HIDDEN * PS;                      // [F_ROWS][PS]
  float* FA = F + F_ROWS * PS;                       // act(F)
  float* DF = FA + F_ROWS * PS;                      // d F
  float* LG = DF + F_ROWS * PS;                      // [C::LINES]
  float* fb = LG + C::LINES;                         // B [W_IN][32]
  float* fq = fb + 4 * W_FREQS;                      // [MAX_FREQS]
  float* res = fq + MAX_FREQS;                       // [points][RS]
  float* ray_s = res + RS * rays_per_block * steps;  // [rays][8]
  float* ray_g = ray_s + 8 * rays_per_block;         // [rays][5]
  float* ray_l = ray_g + 5 * rays_per_block;         // [rays] loss
  float* ray_t = ray_l + rays_per_block;             // [rays] time

  const int tid = threadIdx.x;
  const int n_pts = rays_per_block * steps;
  const int g_cols = want_dp ? 5 : 4;
  float* part = partial + (long)blockIdx.x * WP;
  float* st_block = stash + (long)blockIdx.x * tiles * ST_TILE;
  double loss_acc = 0.0;
  for (int i = tid; i < C::LINES; i += THREADS) LG[i] = 0.0f;
  for (int i = tid; i < W_IN * W_FREQS; i += THREADS) fb[i] = w[FB + i];
  if (tid < C::N_FREQS) fq[tid] = freqs[tid];

  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const int ray0 = rb * rays_per_block;
    // per-ray constants; rays past the ragged edge repeat the last ray and
    // get a zero cotangent
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const int ray = min(ray0 + r, n_rays - 1);
      ray_setup(rays + 6L * ray, ray_s + 8 * r);
      ray_t[r] = times[ray];
      float* gr = ray_g + 5 * r;
      for (int c = 0; c < 5; ++c) gr[c] = 0.0f;
      if (loss_mode) {
        for (int c = 0; c < 3; ++c) gr[c] = gin[3L * ray + c];
      } else {
        for (int c = 0; c < g_cols; ++c) gr[c] = gin[(long)g_cols * ray + c];
      }
    }
    __syncthreads();

    // ---- pass 1: forward, stashing the chain; res per point: density
    // raw, rgb raw, ·, ·, ·, ·, dp² (RS·q + 8) ----
    const tc::TcMlp mlp{tcw, G + A_ROWS * PS};
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      float* st = st_block + tile * ST_TILE;
      warp_forward<RS, 8>(X, F, FA, G, ray_s, ray_t, ts, fb, w,
                          spline_points, q0, n_pts, steps, res, st, mlp);
      canonical_forward<RS>(X, F, FA, ray_s, w, fq, q0, n_pts, steps, res,
                            st, mlp);
    }

    // ---- compositing, its cotangent and VJP: one thread per ray; res per
    // point becomes ·, ·, ·, ·, d density, d rgb raw (5..7); ray_g[4]
    // the ray's dp² cotangent ----
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const bool valid = ray0 + r < n_rays;
      const float* s = ray_s + 8 * r;
      const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
      float* e = res + RS * r * steps;
      float trans = 1.0f, acc = 0.0f, w_last = 0.0f, msum = 0.0f;
      float out[3] = {0.0f, 0.0f, 0.0f};
      for (int t = 0; t < steps; ++t) {
        float* et = e + RS * t;
        const float alpha = 1.0f - expf(-softplus(et[0] - 1.0f)
                                        * (dists[t] * rd_norm));
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
        msum += et[8];
      }
      const float sky = sky_white ? 1.0f - (acc - w_last) : 0.0f;
      float* gr = ray_g + 5 * r;
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
        gr[4] = want_dp ? dp_coeff : 0.0f;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = gr[c];
      }
      float loss = loss_scale * sq;
      if (loss_mode && want_dp) loss += dp_coeff * (msum / steps);
      if (!valid) {
        loss = 0.0f;
        gr[4] = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = 0.0f;
      }
      ray_l[r] = loss;
      float S = 0.0f;                               // Σ_{s>t} A_s w_s
      for (int t = steps - 1; t >= 0; --t) {
        float* et = e + RS * t;
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
        const float dsig = dalpha * (dists[t] * rd_norm) * (1.0f - alpha);
        et[4] = dsig * sigmoid(et[0] - 1.0f);       // d density (raw)
#pragma unroll
        for (int c = 0; c < 3; ++c) et[5 + c] = g[c] * wt_ * drgb[c];
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < rays_per_block; ++r) loss_acc += ray_l[r];
    }

    // ---- pass 2: hand VJP of the canonical chain, the encoder, the gate,
    // the spline and the warp and rigidity MLPs, per tile ----
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      const float* st = st_block + tile * ST_TILE;
      const float* zr = st + ST_R * TILE;
      const float* zd = st + ST_D * TILE;
      const float* zw = st + ST_W * TILE;
      const float* zg = st + ST_G * TILE;
      const float* sa = st + ST_A * TILE;
      const float* __restrict__ wc = w + CANON;

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
          G[c * PS + tid] = q < n_pts ? res[RS * q + 5 + c] : 0.0f;
      }
      load_act<ACT_SIN30>(zr + R_LAYERS * R_HIDDEN * TILE, R_HIDDEN, X);
      __syncthreads();
      tc::mlp_bwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30, true>(
          X, G, F, FA, DF, tcw + TC_R, part + CANON + C::R_IN_, zr);

      // density MLP: G <- [d density ‖ d feats (DF rows 5..36)]; DF keeps
      // the View's d x' on rows 0..2
      for (int i = tid; i < C::D_OUT_W * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        G[row * PS + p] = row == 0
            ? (q0 + p < n_pts ? res[RS * (q0 + p) + 4] : 0.0f)
            : DF[(4 + row) * PS + p];
      }
      __syncthreads();
      for (int i = tid; i < F_ROWS * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = row < C::FEAT_IN ? st[(ST_FD + row) * TILE + p]
                                         : 0.0f;
        F[row * PS + p] = v;
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
        if (row >= 3) DF[row * PS + p] = 0.0f;
      }
      load_act<ACT_LEAKY>(zd + C::D_LAYERS * C::D_HIDDEN * TILE, C::D_HIDDEN,
                          X);
      __syncthreads();
      tc::mlp_bwd<C::FEAT_IN, C::D_HIDDEN, C::D_LAYERS, C::D_OUT_W,
                  ACT_LEAKY, true, LEAKY_THREE>(X, G, F, FA, DF, tcw + TC_D,
                                                part + CANON + C::D_IN, zd);

      // the encoder: line gradients and d enc/d x' (cp), or the bands'
      // derivative (posenc), into DF rows 0..2
      if constexpr (ENC == ENC_CP) {
        cp_backward<true>(F, DF, X, LG, wc);
      } else {
        posenc_position_grad<C::N_FREQS>(F, DF, fq);
      }

      // d x' -> d dp (+ the dp² column's adjoint) -> the gate, the spline
      // and the warp's output cotangent (G rows 0..W_OUT-1); the
      // rigidity's output cotangent to DF row 3
      if (tid < TILE) {
        const int q = q0 + tid;
        const int r = min(q, n_pts - 1) / steps;
        const bool real = q < n_pts && ray0 + r < n_rays;
        const float gate = sa[A_GATE * TILE + tid];
        const float t = sa[A_T * TILE + tid];
        const float cd = ray_g[5 * r + 4] / steps;
        float dspl[3], dgate = 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float spl = sa[(A_SPL + c) * TILE + tid];
          const float dp = __fmul_rn(spl, gate);
          const float ddp = real ? DF[c * PS + tid]
                                   + cd * ((2.0f / 3.0f) * dp)
                                 : 0.0f;
          dspl[c] = ddp * gate;
          dgate += ddp * spl;
        }
        DF[3 * PS + tid] = dgate * gate * (1.0f - gate);
        if constexpr (SPLINE) {
          float bw[MAX_SPLINE];
          bernstein_weights(t, spline_points - 1, bw);
          for (int j = 0; j < MAX_SPLINE - 1; ++j) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
              G[(3 * j + c) * PS + tid] = j < spline_points - 1
                                              ? bw[j] * dspl[c] : 0.0f;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c) G[c * PS + tid] = dspl[c];
        }
      }
      // the warp MLP: F <- its init feature (rows 0..2 = p), FA <- leaky
      for (int i = tid; i < W_FI * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = st[(ST_FW + row) * TILE + p];
        F[row * PS + p] = v;
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
      }
      load_act<ACT_LEAKY>(zw + W_LAYERS * W_HIDDEN * TILE, W_HIDDEN, X);
      __syncthreads();
      tc::mlp_bwd<W_FI, W_HIDDEN, W_LAYERS, W_OUT, ACT_LEAKY, false,
                  LEAKY_THREE>(X, G, F, FA, DF, tcw + TC_W, part + W_MLP, zw);

      // the rigidity MLP on p (F rows 0..2, FA = leaky(p))
      if (tid < TILE) G[tid] = DF[3 * PS + tid];
      load_act<ACT_LEAKY>(zg + G_LAYERS * G_HIDDEN * TILE, G_HIDDEN, X);
      __syncthreads();
      tc::mlp_bwd<3, G_HIDDEN, G_LAYERS, 1, ACT_LEAKY, false, LEAKY_THREE>(
          X, G, F, FA, DF, tcw + TC_G, part + G_MLP, zg);
    }
  }

  // the CP line gradients and the loss go to this block's partial once
  for (int i = tid; i < C::LINES; i += THREADS) part[CANON + i] = LG[i];
  if (tid == 0) part[TOTAL] = (float)loss_acc;
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects.
long long render_dyn_bwd_weight_count() { return TOTAL; }

// Floats of the TC pack (render_dyn.py `Layout.tc_mlps`) it expects.
long long render_dyn_bwd_tc_floats() { return TC_TOTAL; }

// Floats of stash per 64-point tile (the wrapper sizes the scratch).
long long render_dyn_bwd_stash_floats_per_tile() { return ST_TILE; }

// The most sample points per ray (shared memory holds RS floats per point
// of a ray).
int render_dyn_bwd_max_steps() { return MAX_STEPS; }

int render_dyn_bwd_max_spline() { return MAX_SPLINE; }

// The variant this library launches (RENDER_DYN_ENC, RENDER_DYN_SPLINE).
int render_dyn_bwd_built_enc() { return ENC; }

int render_dyn_bwd_built_spline() { return SPLINE ? 1 : 0; }

const char* render_dyn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one backward on `stream`; returns the cudaError_t of the
// launches. gin: g [N, 4] or, with want_dp, [N, 5] (loss_mode 0), or
// target [N, 3] (loss_mode 1). freqs: the posenc bands for the posenc
// canonical, else unused. weights: the packed vector (B, the biases and
// the CP lines are read from it); tcw: its TC pack (`tc_floats` floats,
// 16-byte aligned). out: [TOTAL + 1] (gradient ‖ loss). partial:
// blocks × (TOTAL + 1) floats; stash: blocks × tiles ×
// stash_floats_per_tile floats, tiles = ceil(rays_per_block · steps / 64),
// rays_per_block = max(1, 64 / steps).
int render_dyn_bwd_launch(const float* rays, const float* times,
                          const float* ts, const float* dists,
                          const float* weights, const float* tcw,
                          const float* gin, const float* freqs, float* out,
                          float* partial, float* stash, int n_rays,
                          int steps, int blocks, int spline_points,
                          int sigmoid_kind, int sky_white, int want_dp,
                          int loss_mode, float loss_scale, float dp_coeff,
                          void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || blocks <= 0
      || (SPLINE ? (spline_points < 2 || spline_points > MAX_SPLINE)
                 : spline_points != 0)
      || (C::N_FREQS > 0 && freqs == nullptr)
      || reinterpret_cast<uintptr_t>(tcw) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const int n_rb = (n_rays + rays_per_block - 1) / rays_per_block;
  if (blocks > n_rb) return cudaErrorInvalidValue;
  const int tiles = (rays_per_block * steps + TILE - 1) / TILE;
  const size_t smem = smem_bytes(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_dyn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)blocks * WP, s);
  if (err != cudaSuccess) return err;
  render_dyn_bwd_kernel<<<blocks, THREADS, smem, s>>>(
      rays, times, ts, dists, weights, tcw, gin, freqs, partial, stash,
      n_rays, steps, rays_per_block, n_rb, tiles, spline_points,
      sigmoid_kind, sky_white, want_dp, loss_mode, loss_scale, dp_coeff);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<><<<(int)((WP + 255) / 256), 256, 0, s>>>(
      partial, out, blocks, WP);
  return cudaGetLastError();
}

}  // extern "C"
