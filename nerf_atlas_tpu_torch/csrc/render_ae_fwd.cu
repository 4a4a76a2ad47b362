// K7f: fused forward render of NeRFAE on Hopper.
//
// Replaces nerf_atlas_tpu/ops/pallas/render_ae.py:_ae_kernel. One launch
// renders rays [N, 6] -> [N, 4] (rgb ‖ acc) at the T shared sample
// positions ts: per sample point the chain of render_ae.cuh (posenc ->
// encoder 256×5 -> L2-normalize -> density_tfm 128×4 -> siren View 128×5),
// then sigma = softplus(density − 1), the rgb activation
// (FUSED_SIGMOID_KINDS) and per-ray compositing: alpha = 1 − exp(−sigma·
// Δt·‖r_d‖), running transmittance product of max(1 − alpha, 1e-10); a
// white sky adds the leftover transmittance excluding the 1e10 tail.
//
// What bounds it: compute. 561,792 multiply-adds per sample point
// (encoder 375,040, density_tfm 77,952, View 108,800), 1.124 MFLOP, i.e.
// 4.71 TFLOP per 65536×64 call, against 2.26 MB of float32 weights that
// every block re-reads through L1/L2.
//
// Design (K1's, simple and exact, not yet fast): float32 FMAs on the CUDA
// cores. A block of 256 threads owns max(1, 64/T) rays and walks their
// points in tiles of 64; the tile's activations stay in shared memory
// feature-major for the whole chain (a 256-row buffer and two 72-row
// init-feature buffers, ~109 KB, two blocks per SM). Each thread keeps
// an 8-point × (out/32)-output register tile; a warp reads one weight row
// per input feature. posenc and the normalize run in the kernel with the
// plain version's roundings: one rounded multiply per phase, accurate
// sinf/cosf, the norm clamped at 1e-6 by a branch. One thread per ray
// composites front to back. The TPU kernel's MXU forms (the iota
// selector and exact-f32 dot of its posenc, the bf16 weights, the sin
// approximations) have no counterpart here.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_ae.cuh"

using namespace ae;

namespace {

constexpr int MAX_STEPS = 2048;

size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)(E_HIDDEN + 2 * F_ROWS) * PS
                          + 4 * (size_t)rays_per_block * steps
                          + 8 * (size_t)rays_per_block + N_FREQS);
}

__global__ void __launch_bounds__(THREADS, 2)
render_ae_fwd_kernel(const float* __restrict__ rays,
                     const float* __restrict__ ts,
                     const float* __restrict__ dists,
                     const float* __restrict__ freqs,
                     const float* __restrict__ w,
                     float* __restrict__ out,
                     int n_rays, int steps, int rays_per_block,
                     int sigmoid_kind, int sky_white) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);       // [E_HIDDEN][PS]
  float* Fb = H + E_HIDDEN * PS;                    // [F_ROWS][PS] init
  float* FA = Fb + F_ROWS * PS;                     // [F_ROWS][PS] act(init)
  float* res = FA + F_ROWS * PS;                    // [points][4] raw
  float* ray_s = res + 4 * rays_per_block * steps;  // [rays][8]
  float* fq = ray_s + 8 * rays_per_block;           // [N_FREQS]

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;

  // per-ray constants; rays past the ragged edge repeat the last ray and
  // are never written out
  for (int r = tid; r < rays_per_block; r += THREADS)
    ray_setup(rays + 6L * min(ray0 + r, n_rays - 1), ray_s + 8 * r);
  if (tid < N_FREQS) fq[tid] = freqs[tid];
  __syncthreads();

  for (int q0 = 0; q0 < n_pts; q0 += TILE)
    tile_forward<4>(H, Fb, FA, ray_s, ts, fq, w, q0, n_pts, steps, res,
                    nullptr);

  // ---- compositing: one thread per ray, front to back ----
  const int r = tid;
  if (r < rays_per_block && ray0 + r < n_rays) {
    const float* s = ray_s + 8 * r;
    const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
    float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dummy;
    for (int t = 0; t < steps; ++t) {
      const float* e = res + 4 * (r * steps + t);
      const float sigma = softplus(e[0] - 1.0f);
      const float alpha = 1.0f - expf(-sigma * (dists[t] * rd_norm));
      const float wt = alpha * trans;
      acc += wt;
      c0 += wt * rgb_act(e[1], sigmoid_kind, &dummy);
      c1 += wt * rgb_act(e[2], sigmoid_kind, &dummy);
      c2 += wt * rgb_act(e[3], sigmoid_kind, &dummy);
      trans *= fmaxf(1.0f - alpha, 1e-10f);
      w_last = wt;
    }
    const float sky = sky_white ? 1.0f - (acc - w_last) : 0.0f;
    float* o = out + 4L * (ray0 + r);
    o[0] = c0 + sky;
    o[1] = c1 + sky;
    o[2] = c2 + sky;
    o[3] = acc;
  }
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects.
long long render_ae_fwd_weight_count() { return TOTAL; }

int render_ae_fwd_max_steps() { return MAX_STEPS; }

const char* render_ae_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one render on `stream`; returns the cudaError_t of the launch.
// rays [n_rays, 6], ts and dists [steps], freqs [8] (the posenc bands),
// weights [TOTAL], out [n_rays, 4].
int render_ae_fwd_launch(const float* rays, const float* ts,
                         const float* dists, const float* freqs,
                         const float* weights, float* out, int n_rays,
                         int steps, int sigmoid_kind, int sky_white,
                         void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7)
    return cudaErrorInvalidValue;
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const size_t smem = smem_bytes(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_ae_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  render_ae_fwd_kernel<<<blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      rays, ts, dists, freqs, weights, out, n_rays, steps, rays_per_block,
      sigmoid_kind, sky_white);
  return cudaGetLastError();
}

}  // extern "C"
