// K7b: backward of the fused NeRFAE render on Hopper.
//
// Replaces nerf_atlas_tpu/ops/pallas/render_ae.py:_ae_bwd_kernel, both of
// its modes, in one source:
//   mode G (the autograd backward of K7f): takes the output cotangent
//     g [N, 4] (rgb ‖ acc) and returns d(Σ g·out)/d(weights);
//   mode L (the one-kernel train step): takes target [N, 3] and
//     loss_scale = 1/(3N), computes loss = loss_scale·Σ(out_rgb − target)²
//     from its own forward and back-propagates the cotangent
//     2·loss_scale·(out_rgb − target) (0 on acc).
// Both return the float32 gradient of the packed weight vector (the
// layout of render_ae.cuh / ops/kernels/render_ae.py:pack_weights_ae);
// rays and ts get none.
//
// Per block of rays (max(1, 64/T) rays, as in K7f), in two passes:
//   pass 1 re-runs K7f's forward tile by tile (render_ae.cuh
//     `tile_forward`: the same code, its MLP products on the tensor cores)
//     and stashes every MLP pre-activation, the encoder's init feature,
//     the raw encoding and the View's init feature (3,096 rows of 64
//     floats, 793 KB per tile) in a per-block scratch in global memory;
//   then one thread per ray composites front to back (α, transmittance,
//     outputs, the cotangent, the loss) and walks back to front with the
//     suffix sum S_t = Σ_{s>t} A_s w_s (render_bwd.cu's code);
//   pass 2 walks the tiles again and chains the VJPs (mma_tf32.cuh
//     `mlp_bwd`): rgb activation → View MLP (sin(30h), derivative
//     30·cos(30h) with accurate cosf) → density_tfm (leaky-relu 0.01),
//     whose input gradient adds onto the View's latent columns 5..36 → the
//     normalize VJP dx = g/m − x·(x·g)·[n > 1e-6]/(m²·n), n = ‖x‖, m =
//     max(n, 1e-6) (a plain branch for the clamp) → the encoder. The
//     encoder's input cotangent is not formed (posenc has no parameters).
//
// What bounds it: compute, about three times K7f's (the forward, then per
// layer the input-gradient and the weight-gradient products), 3.37 MFLOP
// per sample point, plus the stash (written once, read once) and the
// per-block weight-gradient partials. On the tensor cores each
// multiply-add is three TF32 products (six in the encoder's and
// density_tfm's forward ones), against the TF32 peak.
//
// Design (render_bwd.cu's and K8b's): every MLP product (the recompute,
// the input and the weight gradients) runs on the tensor cores in split
// TF32 (mma_tf32.cuh, ~3·2^-22 relative per term; the wrapper pre-splits
// the weights into the TC pack, render_ae.py `TC_MLPS`), staged by
// cp.async through rows the product does not read (G in pass 1, X in the
// VJPs). The encoder's and density_tfm's forward products run in three
// parts (hi/mid/lo, six TF32 products, ≲ 2^-32 per term): the backward's
// act′ pattern over 13 leaky-relu layers comes from the recompute's
// pre-activations, as in K9b, where a two-part recompute once moved a
// chip check past its gate; the CPU emulation, which cannot show the
// tensor cores' truncating sums, reads the same distance with two or
// three parts (tests/test_torch_tf32_split.py). The normalize VJP and
// `latent_norm`'s fixed order, the compositing and its suffix sum stay
// float32 on the CUDA cores. One
// 256-thread block per SM (~200 KB of shared memory: two 256-row
// activation/gradient tiles and three 72-row init feature tiles). The
// grid is at most one block per SM; each block loops over ray blocks. The
// weight gradient is deterministic: every block accumulates into its own
// partial row of TOTAL + 1 floats (each entry owned by one thread, tiles
// in a fixed order) and a second kernel sums the rows in block order. No
// float atomics anywhere: two launches are bit-identical.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_ae.cuh"

using namespace ae;

namespace {

constexpr int MAX_STEPS = 512;               // shared memory for res
constexpr long WP = TOTAL + 1;               // partial row: grads ‖ loss
static_assert(tc::stage_floats(E_HIDDEN) <= E_HIDDEN * PS, "weight staging");

size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)(2 * E_HIDDEN + 3 * F_ROWS) * PS
                          + 8 * (size_t)rays_per_block * steps
                          + 13 * (size_t)rays_per_block + N_FREQS);
}

__global__ void __launch_bounds__(THREADS, 1)
render_ae_bwd_kernel(const float* __restrict__ rays,
                     const float* __restrict__ ts,
                     const float* __restrict__ dists,
                     const float* __restrict__ freqs,
                     const float* __restrict__ w,
                     const float* __restrict__ tcw,
                     const float* __restrict__ gin,
                     float* __restrict__ partial,
                     float* __restrict__ stash,
                     int n_rays, int steps, int rays_per_block, int n_rb,
                     int tiles, int sigmoid_kind, int sky_white,
                     int loss_mode, float loss_scale) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);        // [E_HIDDEN][PS]
  float* G = X + E_HIDDEN * PS;                      // [E_HIDDEN][PS]
  float* F = G + E_HIDDEN * PS;                      // [F_ROWS][PS]
  float* FA = F + F_ROWS * PS;                       // act(F)
  float* DF = FA + F_ROWS * PS;                      // d F
  float* res = DF + F_ROWS * PS;                     // [points][8]
  float* ray_s = res + 8 * rays_per_block * steps;   // [rays][8]
  float* ray_g = ray_s + 8 * rays_per_block;         // [rays][4]
  float* ray_l = ray_g + 4 * rays_per_block;         // [rays]
  float* fq = ray_l + rays_per_block;                // [N_FREQS]

  const int tid = threadIdx.x;
  const int n_pts = rays_per_block * steps;
  float* part = partial + (long)blockIdx.x * WP;
  float* st_block = stash + (long)blockIdx.x * tiles * ST_TILE;
  float loss_acc = 0.0f;
  if (tid < N_FREQS) fq[tid] = freqs[tid];

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
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile)
      tile_forward<8>(X, F, FA, ray_s, ts, fq, w, q0, n_pts, steps, res,
                      st_block + tile * ST_TILE, tc::TcMlp{tcw, G});

    // ---- compositing, its cotangent and VJP: one thread per ray ----
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const bool valid = ray0 + r < n_rays;
      const float* s = ray_s + 8 * r;
      const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
      float* e = res + 8 * r * steps;
      float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
      float out[3] = {0.0f, 0.0f, 0.0f};
      for (int t = 0; t < steps; ++t) {
        float* et = e + 8 * t;
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

    // ---- pass 2: the VJP of the three MLPs and the normalize ----
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      const float* st = st_block + tile * ST_TILE;
      const float* zr = st + ST_R * TILE;
      const float* zd = st + ST_D * TILE;
      const float* ze = st + ST_E * TILE;

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
      tc::mlp_bwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30, true,
                  R_THREE>(X, G, F, FA, DF, tcw + TC_R, part + R_IN_, zr);

      // density_tfm: G <- [d density ‖ d feats (DF rows 37..68)]; its init
      // feature is the latent, F rows 5..36, whose gradient DF rows 5..36
      // already holds the View's part; FA rows 5..36 <- leaky(latent)
      for (int i = tid; i < D_OUT_W * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        float v;
        if (row == 0) {
          v = q0 + p < n_pts ? res[8 * (q0 + p) + 4] : 0.0f;
        } else {
          v = DF[(R_FEAT - 1 + row) * PS + p];
        }
        G[row * PS + p] = v;
      }
      act_rows<ACT_LEAKY>(F + R_ENC * PS, FA + R_ENC * PS, ENC);
      load_act<ACT_LEAKY>(zd + D_LAYERS * D_HIDDEN * TILE, D_HIDDEN, X);
      __syncthreads();
      float* DFd = DF + R_ENC * PS;
      tc::mlp_bwd<ENC, D_HIDDEN, D_LAYERS, D_OUT_W, ACT_LEAKY, true, D_THREE>(
          X, G, F + R_ENC * PS, FA + R_ENC * PS, DFd, tcw + TC_D,
          part + D_IN_, zd);

      // normalize VJP: G rows 0..31 <- d raw encoding, one thread per point
      if (tid < TILE) {
        const float* x = st + ST_X * TILE + tid;
        const float* g = DFd + tid;
        const float n = latent_norm(x, TILE);
        const float m = fmaxf(n, 1e-6f);
        float xg = 0.0f;
        for (int k = 0; k < ENC; ++k) xg = fmaf(x[k * TILE], g[k * PS], xg);
        const float c = n > 1e-6f ? xg / (m * m * n) : 0.0f;
        for (int k = 0; k < ENC; ++k)
          G[k * PS + tid] = g[k * PS] / m - x[k * TILE] * c;
      }
      // encoder: F <- its init feature, FA <- leaky(F)
      for (int i = tid; i < E_IN * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = st[(ST_FE + row) * TILE + p];
        F[row * PS + p] = v;
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
      }
      load_act<ACT_LEAKY>(ze + E_LAYERS * E_HIDDEN * TILE, E_HIDDEN, X);
      __syncthreads();
      tc::mlp_bwd<E_IN, E_HIDDEN, E_LAYERS, ENC, ACT_LEAKY, false, E_THREE>(
          X, G, F, FA, DF, tcw + TC_E, part + E_IN_, ze);
    }
  }

  // the loss goes to this block's partial once
  if (tid == 0) part[TOTAL] = loss_acc;
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects.
long long render_ae_bwd_weight_count() { return TOTAL; }

// Floats of the TC pack (render_ae.py `TC_MLPS`) it expects.
long long render_ae_bwd_tc_floats() { return TC_TOTAL; }

// Floats of stash per 64-point tile (the wrapper sizes the scratch).
long long render_ae_bwd_stash_floats_per_tile() { return ST_TILE; }

int render_ae_bwd_max_steps() { return MAX_STEPS; }

const char* render_ae_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one backward on `stream`; returns the cudaError_t of the
// launches. gin: g [N, 4] (loss_mode 0) or target [N, 3] (loss_mode 1).
// freqs [8]: the posenc bands. weights: the packed vector (the biases
// are read from it); tcw: its TC pack (`tc_floats` floats, 16-byte
// aligned). out: [TOTAL + 1] (gradient ‖ loss).
// partial: blocks × (TOTAL + 1) floats; stash: blocks × tiles ×
// stash_floats_per_tile floats, tiles = ceil(rays_per_block · steps / 64),
// rays_per_block = max(1, 64 / steps).
int render_ae_bwd_launch(const float* rays, const float* ts,
                         const float* dists, const float* freqs,
                         const float* weights, const float* tcw,
                         const float* gin, float* out, float* partial,
                         float* stash, int n_rays, int steps, int blocks,
                         int sigmoid_kind, int sky_white, int loss_mode,
                         float loss_scale, void* stream) {
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
      render_ae_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)blocks * WP, s);
  if (err != cudaSuccess) return err;
  render_ae_bwd_kernel<<<blocks, THREADS, smem, s>>>(
      rays, ts, dists, freqs, weights, tcw, gin, partial, stash, n_rays,
      steps, rays_per_block, n_rb, tiles, sigmoid_kind, sky_white, loss_mode,
      loss_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<><<<(int)((WP + 255) / 256), 256, 0, s>>>(
      partial, out, blocks, WP);
  return cudaGetLastError();
}

}  // extern "C"
