// K8b: backward of the fused VolSDF render on Hopper, with the eikonal.
//
// Replaces nerf_atlas_tpu/ops/pallas/render_volsdf.py:_vs_bwd_kernel, both
// of its modes, in one source:
//   mode G (the autograd backward of K8f): takes the output cotangent
//     g [N, 4] (rgb ‖ acc), with want_eikonal [N, 5] (‖ the cotangent of
//     K8f's eikonal column), and returns d(Σ g·out)/d(weights);
//   mode L (the one-kernel train step): takes target [N, 3],
//     loss_scale = 1/(3N) and eik_cot = eikonal weight / N; computes
//     loss = loss_scale·Σ(out_rgb − target)² (+ eik_cot·Σ_rays the ray's
//     mean eikonal residual with want_eikonal) from its own forward and
//     back-propagates the cotangents 2·loss_scale·(out_rgb − target) (0 on
//     acc) and eik_cot per ray.
// Both return the float32 gradient of the packed weight vector (the layout
// of render_volsdf.cuh / ops/kernels/render_volsdf.py:pack_weights): the
// scale s at entry 0, B's entries 0 (B takes no gradient); rays and ts
// get none.
//
// Per block of rays (max(1, 64/T) rays, as in K8f), in two passes:
//   pass 1 re-runs K8f's forward tile by tile (render_volsdf.cuh
//     `tile_forward`: the same code, its MLP products on the tensor cores)
//     and stashes every MLP pre-activation and both init features (2,664
//     rows of 64 floats, 682 KB per tile) in a per-block scratch in global
//     memory;
//   then one thread per ray composites front to back (α, transmittance,
//     outputs, the cotangent, the loss) and walks back to front with the
//     suffix sum S_t = Σ_{s>t} A_s w_s (render_bwd.cu's code) to dσ, which
//     relu gates; the Laplace density's partials give dsdf = dσ·(−e2/s²)
//     and the ray's share of ∂L/∂s, Σ dσ·(e2·sdf/s³ − cdf/s²);
//   pass 2 walks the tiles again and chains the hand VJPs: rgb activation
//     → View MLP (sin(30h), derivative 30·cos(30h)), whose input gradient
//     on the latent columns 5..36 joins dsdf as the SDF MLP's output
//     cotangent → SDF MLP (leaky-relu 0.01). The SDF MLP's input
//     cotangent is not formed (B is fixed, the points are inputs). With
//     want_eikonal, per tile: the transpose chain ∇ₓsdf (mma_tf32.cuh
//     `tc::mlp_input_grad`, its u_i into a per-block u-stash of 458 KB in
//     global memory), each point's e = (‖g‖ − 1)² and ∂e/∂g times the
//     ray's eikonal cotangent / T, that cotangent back through the
//     Fourier jacobian, then the adjoint sweep up the chain
//     (`tc::mlp_input_grad_adjoint`: forward-like products, rank-64 weight
//     updates, no bias gradient, layer_out's column 0 only).
//
// What bounds it: compute, 3.3 MFLOP per sample point without the
// eikonal (the forward, then per layer the input-gradient and the
// weight-gradient products) and 6.0 MFLOP with it (the transpose chain,
// its adjoint's forward-like products and its weight updates), plus the
// stashes (written once, read once) and the per-block weight-gradient
// partials. On the tensor cores each multiply-add is three TF32 products
// (six in the SDF MLP's forward ones), against the TF32 peak.
//
// Design (render_bwd.cu's): every MLP product (the recompute, the input and
// the weight gradients, the eikonal's transpose chain, its adjoint's
// forward-like products and rank-64 updates) runs on the tensor cores in
// split TF32 (mma_tf32.cuh, ~3·2^-22 relative per term; the wrapper
// pre-splits the weights into the TC pack, render_volsdf.py `TC_MLPS`),
// staged by cp.async through rows the product does not read (G in pass 1
// and in the adjoint, X in the VJPs and the chain). The SDF MLP's forward
// products, the recompute's and the adjoint's, run in three parts
// (hi/mid/lo, six TF32 products, ≲ 2^-32 per term): the eikonal's act′
// pattern comes from the recompute's pre-activations, and with two parts
// their rounding moved the eikonal's weight gradient past its float32
// floor on the CPU emulation (tests/test_torch_tf32_split.py). The Fourier
// rows, the Laplace partials, the eikonal's per-point steps and the
// compositing stay float32 on the CUDA cores. One 256-thread block per SM
// (~198 KB of shared memory: two 256-row activation/gradient tiles and
// three 68-row init feature tiles). The grid is at most one block per SM;
// each block loops over ray blocks. The gradient is deterministic: every
// block accumulates into its own partial row of TOTAL + 1 floats (each
// entry owned by one thread, tiles in a fixed order; ∂L/∂s and the loss
// summed by one thread in double) and a second kernel sums the rows in
// block order. No float atomics anywhere: two launches are bit-identical.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "mma_tf32.cuh"
#include "render_volsdf.cuh"

using namespace vs;

namespace {

constexpr int MAX_STEPS = 512;               // shared memory for res
constexpr int RS = 9;                        // per point, see pass 1
constexpr long WP = TOTAL + 1;               // partial row: grads ‖ loss
static_assert(tc::stage_floats(S_HIDDEN) <= S_HIDDEN * PS, "weight staging");

size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)(2 * S_HIDDEN + 3 * F_ROWS) * PS
                          + RS * (size_t)rays_per_block * steps
                          + 15 * (size_t)rays_per_block + 3 * N_FREQS + TILE);
}

__global__ void __launch_bounds__(THREADS, 1)
render_volsdf_bwd_kernel(const float* __restrict__ rays,
                         const float* __restrict__ ts,
                         const float* __restrict__ dists,
                         const float* __restrict__ w,
                         const float* __restrict__ tcw,
                         const float* __restrict__ gin,
                         float* __restrict__ partial,
                         float* __restrict__ stash,
                         int n_rays, int steps, int rays_per_block, int n_rb,
                         int tiles, int sigmoid_kind, int sky_white,
                         int sphere, int want_eikonal, int loss_mode,
                         float loss_scale, float eik_cot) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);        // [S_HIDDEN][PS]
  float* G = X + S_HIDDEN * PS;                      // [S_HIDDEN][PS]
  float* F = G + S_HIDDEN * PS;                      // [F_ROWS][PS]
  float* FA = F + F_ROWS * PS;                       // act(F)
  float* DF = FA + F_ROWS * PS;                      // d F
  float* res = DF + F_ROWS * PS;                     // [points][RS]
  float* ray_s = res + RS * rays_per_block * steps;  // [rays][8]
  float* ray_g = ray_s + 8 * rays_per_block;         // [rays][5]
  float* ray_l = ray_g + 5 * rays_per_block;         // [rays] loss
  float* ray_d = ray_l + rays_per_block;             // [rays] ∂L/∂s
  float* fb = ray_d + rays_per_block;                // B [3][32]
  float* eikp = fb + 3 * N_FREQS;                    // [TILE]

  const int tid = threadIdx.x;
  const int n_pts = rays_per_block * steps;
  const float s = w[SCALE];
  const int g_cols = want_eikonal ? 5 : 4;
  float* part = partial + (long)blockIdx.x * WP;
  float* st_block = stash + (long)blockIdx.x * (tiles * ST_TILE + U_TILE);
  float* ust = st_block + tiles * ST_TILE;
  double loss_acc = 0.0, ds_acc = 0.0;
  for (int i = tid; i < 3 * N_FREQS; i += THREADS) fb[i] = w[FB + i];

  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const int ray0 = rb * rays_per_block;
    // per-ray constants; rays past the ragged edge repeat the last ray and
    // get a zero cotangent
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const int ray = min(ray0 + r, n_rays - 1);
      ray_setup(rays + 6L * ray, ray_s + 8 * r);
      float* gr = ray_g + 5 * r;
      for (int c = 0; c < 5; ++c) gr[c] = 0.0f;
      if (loss_mode) {
        for (int c = 0; c < 3; ++c) gr[c] = gin[3L * ray + c];
      } else {
        for (int c = 0; c < g_cols; ++c) gr[c] = gin[(long)g_cols * ray + c];
      }
    }
    __syncthreads();

    // ---- pass 1: forward, stashing the chain; res per point: σ, rgb raw,
    // sdf, then α and the transmittance ----
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile)
      tile_forward<RS>(X, F, FA, ray_s, ts, fb, w, s, sphere != 0, q0, n_pts,
                       steps, res, st_block + tile * ST_TILE, true,
                       tc::TcMlp{tcw, G});

    // ---- compositing, its cotangent and VJP, the Laplace partials: one
    // thread per ray; res per point becomes dsdf, ·, ·, ·, ·, d rgb raw ----
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const bool valid = ray0 + r < n_rays;
      const float* rs = ray_s + 8 * r;
      const float rd_norm = sqrtf(rs[3] * rs[3] + rs[4] * rs[4]
                                  + rs[5] * rs[5]);
      float* e = res + RS * r * steps;
      float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
      float out[3] = {0.0f, 0.0f, 0.0f};
      for (int t = 0; t < steps; ++t) {
        float* et = e + RS * t;
        const float alpha = 1.0f - expf(-fmaxf(et[0], 0.0f)
                                        * (dists[t] * rd_norm));
        const float wt_ = alpha * trans;
        float dummy;
        acc += wt_;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          out[c] += wt_ * rgb_act(et[1 + c], sigmoid_kind, &dummy);
        et[5] = alpha;
        et[6] = trans;
        trans *= fmaxf(1.0f - alpha, 1e-10f);
        w_last = wt_;
      }
      const float sky = sky_white ? 1.0f - (acc - w_last) : 0.0f;
      const float* gr = ray_g + 5 * r;
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
      float ds = 0.0f;
      const float s2 = s * s;
      for (int t = steps - 1; t >= 0; --t) {
        float* et = e + RS * t;
        const float alpha = et[5], tr = et[6];
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
        const float dsig = et[0] > 0.0f
            ? dalpha * (dists[t] * rd_norm) * (1.0f - alpha) : 0.0f;
        const float sdf = et[4];
        float e2, cdf;
        laplace_density(sdf, s, &e2, &cdf);
        et[0] = dsig * (-e2 / s2);                  // d sdf
        ds += dsig * (e2 * sdf / (s2 * s) - cdf / s2);
#pragma unroll
        for (int c = 0; c < 3; ++c) et[5 + c] = g[c] * wt_ * drgb[c];
      }
      ray_d[r] = ds;
    }
    __syncthreads();
    if (tid == 0) {
      for (int r = 0; r < rays_per_block; ++r) {
        loss_acc += ray_l[r];
        ds_acc += ray_d[r];
      }
    }

    // ---- pass 2: hand VJP of the two MLPs, then the eikonal ----
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      const float* st = st_block + tile * ST_TILE;
      const float* zr = st + ST_R * TILE;
      const float* zs = st + ST_S * TILE;
      constexpr int RZ = R_HIDDEN * TILE, SZ = S_HIDDEN * TILE;

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
      load_act<ACT_SIN30>(zr + R_LAYERS * RZ, R_HIDDEN, X);
      __syncthreads();
      tc::mlp_bwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT, ACT_SIN30, true>(
          X, G, F, FA, DF, tcw + TC_R, part + R_MLP, zr);

      // SDF MLP: G <- [d sdf ‖ d latent (DF rows 5..36)]; F <- its init
      // feature, FA <- leaky(F)
      for (int i = tid; i < S_OUT * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        G[row * PS + p] = row == 0
            ? (q0 + p < n_pts ? res[RS * (q0 + p)] : 0.0f)
            : DF[(4 + row) * PS + p];
      }
      for (int i = tid; i < S_IN * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = st[(ST_FS + row) * TILE + p];
        F[row * PS + p] = v;
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
      }
      load_act<ACT_LEAKY>(zs + S_LAYERS * SZ, S_HIDDEN, X);
      __syncthreads();
      tc::mlp_bwd<S_IN, S_HIDDEN, S_LAYERS, S_OUT, ACT_LEAKY, false, S_THREE>(
          X, G, F, FA, DF, tcw + TC_S, part + S_MLP, zs);

      if (want_eikonal) {
        // g = ∇ₓsdf by the transpose chain, seeded with column 0 of the SDF
        // MLP's layer_out (u_i to the u-stash)
        for (int i = tid; i < S_IN * TILE; i += THREADS)
          DF[(i / TILE) * PS + i % TILE] = 0.0f;
        seed_column<S_HIDDEN, ACT_LEAKY, S_OUT>(G, w + S_OUT_W,
                                                zs + S_LAYERS * SZ);
        __syncthreads();
        tc::mlp_input_grad<S_IN, S_HIDDEN, S_LAYERS, S_OUT, ACT_LEAKY,
                           S_THREE>(X, G, F, DF, tcw + TC_S, zs, ust);
        if (tid < TILE) {
          const int q = q0 + tid;
          const int r = min(q, n_pts - 1) / steps;
          const bool real = q < n_pts && ray0 + r < n_rays;
          float de[3], c[3];
          const float e = eikonal_point(F, DF, fb, sphere != 0, tid, de);
          const float ce = real ? (loss_mode ? eik_cot : ray_g[5 * r + 4])
                                      / steps
                                : 0.0f;
          eikp[tid] = loss_mode && real ? eik_cot * e / steps : 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k) c[k] = ce * de[k];
          eikonal_cotangent(F, DF, fb, c, tid);
        }
        __syncthreads();
        if (tid == 0) {
          for (int p = 0; p < TILE; ++p) loss_acc += eikp[p];
        }
        tc::mlp_input_grad_adjoint<S_IN, S_HIDDEN, S_LAYERS, S_OUT, ACT_LEAKY,
                                   S_THREE>(X, G, F, DF, FA, tcw + TC_S,
                                            part + S_MLP, zs, ust, 0);
      }
    }
  }

  // ∂L/∂s and the loss go to this block's partial once
  if (tid == 0) {
    part[SCALE] = (float)ds_acc;
    part[TOTAL] = (float)loss_acc;
  }
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects.
long long render_volsdf_bwd_weight_count() { return TOTAL; }

// Floats of the TC pack (render_volsdf.py `TC_MLPS`) it expects.
long long render_volsdf_bwd_tc_floats() { return TC_TOTAL; }

// Floats of stash per 64-point tile, and of u-stash per block (the
// wrapper sizes the scratch).
long long render_volsdf_bwd_stash_floats_per_tile() { return ST_TILE; }

long long render_volsdf_bwd_ustash_floats_per_block() { return U_TILE; }

int render_volsdf_bwd_max_steps() { return MAX_STEPS; }

const char* render_volsdf_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one backward on `stream`; returns the cudaError_t of the
// launches. gin: g [N, 4] or, with want_eikonal, [N, 5] (loss_mode 0), or
// target [N, 3] (loss_mode 1). weights: the packed vector (s, B, the
// biases and layer_out's column 0 are read from it); tcw: its TC pack
// (`tc_floats` floats, 16-byte aligned). out: [TOTAL + 1] (gradient ‖
// loss).
// partial: blocks × (TOTAL + 1) floats; stash: blocks × (tiles ×
// stash_floats_per_tile + ustash_floats_per_block) floats, tiles =
// ceil(rays_per_block · steps / 64), rays_per_block = max(1, 64 / steps).
int render_volsdf_bwd_launch(const float* rays, const float* ts,
                             const float* dists, const float* weights,
                             const float* tcw, const float* gin,
                             float* out, float* partial, float* stash,
                             int n_rays, int steps, int blocks,
                             int sigmoid_kind, int sky_white, int sphere,
                             int want_eikonal, int loss_mode,
                             float loss_scale, float eik_cot, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || blocks <= 0 || reinterpret_cast<uintptr_t>(tcw) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const int n_rb = (n_rays + rays_per_block - 1) / rays_per_block;
  if (blocks > n_rb) return cudaErrorInvalidValue;
  const int tiles = (rays_per_block * steps + TILE - 1) / TILE;
  const size_t smem = smem_bytes(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_volsdf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)blocks * WP, s);
  if (err != cudaSuccess) return err;
  render_volsdf_bwd_kernel<<<blocks, THREADS, smem, s>>>(
      rays, ts, dists, weights, tcw, gin, partial, stash, n_rays, steps,
      rays_per_block, n_rb, tiles, sigmoid_kind, sky_white, sphere,
      want_eikonal, loss_mode, loss_scale, eik_cot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<><<<(int)((WP + 255) / 256), 256, 0, s>>>(
      partial, out, blocks, WP);
  return cudaGetLastError();
}

}  // extern "C"
