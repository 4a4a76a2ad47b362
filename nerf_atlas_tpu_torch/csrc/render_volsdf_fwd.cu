// K8f: fused forward render of VolSDF on Hopper.
//
// Replaces nerf_atlas_tpu/ops/pallas/render_volsdf.py:_vs_kernel. One
// launch renders rays [N, 6] -> [N, 4] (rgb ‖ acc) at the T shared sample
// positions ts: per sample point the chain of render_volsdf.cuh (Fourier
// features -> SDF MLP 256×6 -> sphere bias -> Laplace density with the
// learned scale -> siren View 128×5), then σ = relu(density), the rgb
// activation (FUSED_SIGMOID_KINDS) and per-ray compositing: alpha = 1 −
// exp(−σ·Δt·‖r_d‖), running transmittance product of max(1 − alpha,
// 1e-10); a white sky adds the leftover transmittance excluding the 1e10
// tail. With want_eikonal the output is [N, 5]: column 4 is the ray's
// mean over its points of (‖∇ₓsdf‖ − 1)², ∇ₓsdf by the SDF MLP's transpose
// chain (render_common.cuh `mlp_input_grad`) through the Fourier jacobian
// and the sphere bias.
//
// What bounds it: compute. 549,632 multiply-adds per sample point (SDF
// MLP 453,120, View 96,512), 1.10 MFLOP, i.e. 4.61 TFLOP per 65536×64
// call, against 2.2 MB of float32 weights that every block re-reads
// through L1/L2; the eikonal adds the transpose chain, ~0.45 M more.
//
// Design (K1's, simple and exact, not yet fast): float32 FMAs on the CUDA
// cores. A block of 256 threads owns max(1, 64/T) rays at a time and
// walks their points in tiles of 64; the tile's activations stay in
// shared memory feature-major (a 256-row buffer and two 68-row
// init-feature buffers, ~108 KB, two blocks per SM). Each thread keeps an
// 8-point × (out/32)-output register tile; a warp reads one weight row
// per input feature. The Fourier phases and the sphere bias are rounded
// as the plain version rounds them, sinf/cosf/expf are the accurate ones.
// For the eikonal, the SDF pre-activations of the tile go to a per-block
// scratch in global memory (458 KB), the SDF init feature is rebuilt
// after the View, and the chain runs in the freed buffers; such a launch
// has at most two blocks per SM, each looping over ray blocks. One thread
// per ray composites front to back. The TPU kernel's MXU forms (the bf16
// weights, `_dot_exact`, the sin approximations) have no counterpart.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_volsdf.cuh"

using namespace vs;

namespace {

constexpr int MAX_STEPS = 2048;
constexpr int RS = 5;                  // per point: σ, rgb raw, sdf / e

size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)(S_HIDDEN + 2 * F_ROWS) * PS
                          + RS * (size_t)rays_per_block * steps
                          + 8 * (size_t)rays_per_block + 3 * N_FREQS);
}

__global__ void __launch_bounds__(THREADS, 2)
render_volsdf_fwd_kernel(const float* __restrict__ rays,
                         const float* __restrict__ ts,
                         const float* __restrict__ dists,
                         const float* __restrict__ w,
                         const float* __restrict__ wt,
                         float* __restrict__ stash,
                         float* __restrict__ out,
                         int n_rays, int steps, int rays_per_block, int n_rb,
                         int sigmoid_kind, int sky_white, int sphere,
                         int want_eikonal) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);       // [S_HIDDEN][PS]
  float* F = H + S_HIDDEN * PS;                     // [F_ROWS][PS] init
  float* FA = F + F_ROWS * PS;                      // act(init) / d init
  float* res = FA + F_ROWS * PS;                    // [points][RS]
  float* ray_s = res + RS * rays_per_block * steps; // [rays][8]
  float* fb = ray_s + 8 * rays_per_block;           // B [3][32]

  const int tid = threadIdx.x;
  const int n_pts = rays_per_block * steps;
  const float s = w[SCALE];
  float* zst = want_eikonal ? stash + (long)blockIdx.x * ST_SDF_TILE
                            : nullptr;
  for (int i = tid; i < 3 * N_FREQS; i += THREADS) fb[i] = w[FB + i];

  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const int ray0 = rb * rays_per_block;
    // per-ray constants; rays past the ragged edge repeat the last ray and
    // are never written out
    for (int r = tid; r < rays_per_block; r += THREADS)
      ray_setup(rays + 6L * min(ray0 + r, n_rays - 1), ray_s + 8 * r);
    __syncthreads();

    for (int q0 = 0; q0 < n_pts; q0 += TILE) {
      tile_forward<RS>(H, F, FA, ray_s, ts, fb, w, s, sphere != 0, q0, n_pts,
                       steps, res, zst, false);
      if (want_eikonal) {
        sdf_init_rows(F, ray_s, ts, fb, q0, n_pts, steps);
        sdf_input_grad(H, F, FA, wt, zst);
        if (tid < TILE && q0 + tid < n_pts) {
          float de[3];
          res[RS * (q0 + tid) + 4] = eikonal_point(F, FA, fb, sphere != 0,
                                                   tid, de);
        }
        __syncthreads();
      }
    }

    // ---- compositing: one thread per ray, front to back ----
    const int r = tid;
    if (r < rays_per_block && ray0 + r < n_rays) {
      const float* rs = ray_s + 8 * r;
      const float rd_norm = sqrtf(rs[3] * rs[3] + rs[4] * rs[4]
                                  + rs[5] * rs[5]);
      float trans = 1.0f, acc = 0.0f, w_last = 0.0f, eik = 0.0f;
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dummy;
      for (int t = 0; t < steps; ++t) {
        const float* e = res + RS * (r * steps + t);
        const float sigma = fmaxf(e[0], 0.0f);
        const float alpha = 1.0f - expf(-sigma * (dists[t] * rd_norm));
        const float wt_ = alpha * trans;
        acc += wt_;
        c0 += wt_ * rgb_act(e[1], sigmoid_kind, &dummy);
        c1 += wt_ * rgb_act(e[2], sigmoid_kind, &dummy);
        c2 += wt_ * rgb_act(e[3], sigmoid_kind, &dummy);
        trans *= fmaxf(1.0f - alpha, 1e-10f);
        w_last = wt_;
        eik += e[4];
      }
      const float sky = sky_white ? 1.0f - (acc - w_last) : 0.0f;
      const int cols = want_eikonal ? 5 : 4;
      float* o = out + (long)cols * (ray0 + r);
      o[0] = c0 + sky;
      o[1] = c1 + sky;
      o[2] = c2 + sky;
      o[3] = acc;
      if (want_eikonal) o[4] = eik / steps;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects.
long long render_volsdf_fwd_weight_count() { return TOTAL; }

// Floats of eikonal scratch per block (the wrapper sizes it).
long long render_volsdf_fwd_stash_floats_per_block() { return ST_SDF_TILE; }

int render_volsdf_fwd_max_steps() { return MAX_STEPS; }

const char* render_volsdf_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one render on `stream`; returns the cudaError_t of the launch.
// rays [n_rays, 6], ts and dists [steps], weights [TOTAL], out [n_rays,
// 4] (want_eikonal: [n_rays, 5], and then weights_t, the transposed
// weights, and stash, blocks × stash_floats_per_block floats). blocks:
// the grid, at most the number of ray blocks (max(1, 64/steps) rays each).
int render_volsdf_fwd_launch(const float* rays, const float* ts,
                             const float* dists, const float* weights,
                             const float* weights_t, float* stash, float* out,
                             int n_rays, int steps, int blocks,
                             int sigmoid_kind, int sky_white, int sphere,
                             int want_eikonal, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const int n_rb = (n_rays + rays_per_block - 1) / rays_per_block;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || blocks <= 0 || blocks > n_rb
      || (want_eikonal && (weights_t == nullptr || stash == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_volsdf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_volsdf_fwd_kernel<<<blocks, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      rays, ts, dists, weights, weights_t, stash, out, n_rays, steps,
      rays_per_block, n_rb, sigmoid_kind, sky_white, sphere, want_eikonal);
  return cudaGetLastError();
}

}  // extern "C"
