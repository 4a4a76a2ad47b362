// K9f: fused forward render of D-NeRF and Spline-NeRF on Hopper, built once
// per (canonical encoder, warp kind): -DRENDER_DYN_ENC=<0 cp | 2 posenc>
// -DRENDER_DYN_SPLINE=<0 Δx | 1 spline>, four libraries compiled in
// parallel.
//
// Replaces nerf_atlas_tpu/ops/pallas/render_dyn.py:_dyn_kernel. One launch
// renders rays [N, 6] at each ray's time times [N] -> [N, 4] (rgb ‖ acc)
// at the T shared sample positions ts: per sample point the chain of
// render_dyn.cuh (the warp's Fourier features -> warp MLP 256×5 -> Δx or
// de Casteljau at t -> × σ(rigidity MLP 64×3) -> the canonical PlainNeRF's
// CP or posenc chain on p + dp -> density MLP 256×5 -> siren View 128×5),
// then σ = softplus(density − 1), the rgb activation (FUSED_SIGMOID_KINDS)
// and per-ray compositing: alpha = 1 − exp(−σ·Δt·‖r_d‖), running
// transmittance product of max(1 − alpha, 1e-10); a white sky adds the
// leftover transmittance excluding the 1e10 tail. With want_dp the output
// is [N, 5]: column 4 is the ray's mean over its T points and 3 axes of
// dp² (the --dp-weight regularizer's term).
//
// What bounds it: compute. Per sample point the warp MLP costs 380,672
// multiply-adds (Δx; the spline 386,816 with its 30 packed outputs, of
// which S = 4 needs 381,440), the rigidity MLP 12,736, the canonical
// chain 459,520 (cp) or 481,024 (posenc): ~1.71 MFLOP, 7.2 TFLOP per
// 65536×64 call, against 3.5 MB of float32 weights that every block
// re-reads through L1/L2.
//
// Design (K1's, simple and exact, not yet fast): float32 FMAs on the CUDA
// cores. A block of 256 threads owns max(1, 64/T) rays and walks their
// points in tiles of 64; the tile's activations stay in shared memory
// feature-major (a 256-row buffer, two 68-row init-feature buffers and 8
// rows of per-point values, ~109 KB, two blocks per SM), each thread
// keeping an 8-point × (out/32)-output register tile and a warp reading
// one weight row per input feature. The Fourier phases, the sample
// points, de Casteljau's lerps, dp and p + dp and the CP encode are rounded
// as the plain version rounds them; sinf/cosf/expf are the accurate ones.
// The spline warp's layer_out is packed at 30 columns (MAX_SPLINE = 11),
// so S is a run-time argument. One thread per ray composites front to
// back. The TPU kernel's MXU forms (the bf16 weights, the packed CP
// block-diagonal and its hat-basis matmul, the sin approximations, the
// 8-ray blocks) have no counterpart.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_dyn.cuh"

using namespace dyn;

namespace {

constexpr int MAX_STEPS = 2048;
constexpr int RS = 5;                  // per point: density, rgb raw, dp²

size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)(W_HIDDEN + 2 * F_ROWS + A_ROWS) * PS
                          + RS * (size_t)rays_per_block * steps
                          + 9 * (size_t)rays_per_block + W_IN * W_FREQS
                          + MAX_FREQS);
}

__global__ void __launch_bounds__(THREADS, 2)
render_dyn_fwd_kernel(const float* __restrict__ rays,
                      const float* __restrict__ times,
                      const float* __restrict__ ts,
                      const float* __restrict__ dists,
                      const float* __restrict__ w,
                      const float* __restrict__ freqs,
                      float* __restrict__ out,
                      int n_rays, int steps, int rays_per_block,
                      int spline_points, int sigmoid_kind, int sky_white,
                      int want_dp) {
  extern __shared__ float4 smem4[];
  float* H = reinterpret_cast<float*>(smem4);       // [256][PS]
  float* F = H + W_HIDDEN * PS;                     // [F_ROWS][PS] init
  float* FA = F + F_ROWS * PS;                      // act(init)
  float* A = FA + F_ROWS * PS;                      // [A_ROWS][PS]
  float* res = A + A_ROWS * PS;                     // [points][RS]
  float* ray_s = res + RS * rays_per_block * steps; // [rays][8]
  float* ray_t = ray_s + 8 * rays_per_block;        // [rays] time
  float* fb = ray_t + rays_per_block;               // B [W_IN][32]
  float* fq = fb + W_IN * W_FREQS;                  // posenc bands

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;

  // per-ray constants; rays past the ragged edge repeat the last ray and
  // are never written out
  for (int r = tid; r < rays_per_block; r += THREADS) {
    const int ray = min(ray0 + r, n_rays - 1);
    ray_setup(rays + 6L * ray, ray_s + 8 * r);
    ray_t[r] = times[ray];
  }
  for (int i = tid; i < W_IN * W_FREQS; i += THREADS) fb[i] = w[FB + i];
  if (tid < C::N_FREQS) fq[tid] = freqs[tid];
  __syncthreads();

  for (int q0 = 0; q0 < n_pts; q0 += TILE) {
    warp_forward<RS, 4>(H, F, FA, A, ray_s, ray_t, ts, fb, w, spline_points,
                        q0, n_pts, steps, res, nullptr);
    canonical_forward<RS>(H, F, FA, ray_s, w, fq, q0, n_pts, steps, res,
                          nullptr);
  }

  // ---- compositing: one thread per ray, front to back ----
  const int r = tid;
  if (r < rays_per_block && ray0 + r < n_rays) {
    const float* s = ray_s + 8 * r;
    const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
    float trans = 1.0f, acc = 0.0f, w_last = 0.0f, msum = 0.0f;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, dummy;
    for (int t = 0; t < steps; ++t) {
      const float* e = res + RS * (r * steps + t);
      const float alpha = 1.0f - expf(-softplus(e[0] - 1.0f)
                                      * (dists[t] * rd_norm));
      const float wt = alpha * trans;
      acc += wt;
      c0 += wt * rgb_act(e[1], sigmoid_kind, &dummy);
      c1 += wt * rgb_act(e[2], sigmoid_kind, &dummy);
      c2 += wt * rgb_act(e[3], sigmoid_kind, &dummy);
      trans *= fmaxf(1.0f - alpha, 1e-10f);
      w_last = wt;
      msum += e[4];
    }
    const float sky = sky_white ? 1.0f - (acc - w_last) : 0.0f;
    const int cols = want_dp ? 5 : 4;
    float* o = out + (long)cols * (ray0 + r);
    o[0] = c0 + sky;
    o[1] = c1 + sky;
    o[2] = c2 + sky;
    o[3] = acc;
    if (want_dp) o[4] = msum / steps;
  }
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects.
long long render_dyn_fwd_weight_count() { return TOTAL; }

int render_dyn_fwd_max_steps() { return MAX_STEPS; }

int render_dyn_fwd_max_spline() { return MAX_SPLINE; }

// The variant this library launches (RENDER_DYN_ENC, RENDER_DYN_SPLINE).
int render_dyn_fwd_built_enc() { return ENC; }

int render_dyn_fwd_built_spline() { return SPLINE ? 1 : 0; }

const char* render_dyn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one render on `stream`; returns the cudaError_t of the launch.
// rays [n_rays, 6], times [n_rays], ts and dists [steps], weights [TOTAL],
// freqs: the posenc bands for the posenc canonical (else unused), out
// [n_rays, 4] (want_dp: [n_rays, 5]). spline_points: 0 for the Δx build,
// 2..MAX_SPLINE for the spline build.
int render_dyn_fwd_launch(const float* rays, const float* times,
                          const float* ts, const float* dists,
                          const float* weights, const float* freqs,
                          float* out, int n_rays, int steps,
                          int spline_points, int sigmoid_kind, int sky_white,
                          int want_dp, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || (SPLINE ? (spline_points < 2 || spline_points > MAX_SPLINE)
                 : spline_points != 0)
      || (C::N_FREQS > 0 && freqs == nullptr))
    return cudaErrorInvalidValue;
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const size_t smem = smem_bytes(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_dyn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  render_dyn_fwd_kernel<<<blocks, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      rays, times, ts, dists, weights, freqs, out, n_rays, steps,
      rays_per_block, spline_points, sigmoid_kind, sky_white, want_dp);
  return cudaGetLastError();
}

}  // extern "C"
