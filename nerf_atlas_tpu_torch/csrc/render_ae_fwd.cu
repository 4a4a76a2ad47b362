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
// 4.71 TFLOP per 65536×64 call; in split TF32 three TF32 products per
// multiply-add, 28.6 ms at the TF32 tensor-core peak (495 TFLOP/s). On an
// H100 80GB HBM3 at 700 W a call takes ~121 ms, ~4.3× that bound, the same
// ~0.8 µs per staged weight unit as K1 and K9f (PERF.md §6–§7).
//
// Design (K1's, render_fwd.cu): every MLP product on the tensor cores by
// TF32 `wgmma` in split TF32 (wgmma_tf32.cuh: a fresh accumulator per
// 8-deep k-step). A block of 256 threads (two warpgroups) owns max(1,
// 128/T) rays and walks their points 128 at a time: two 64-point tiles,
// one per warpgroup, each with a 256-row hidden buffer and a 72-row init
// buffer (the encoder's [p ‖ sin ‖ cos], then the View's [p ‖ elev, azim
// ‖ latent ‖ feats], whose latent rows density_tfm reads) in dynamic
// shared memory, ~178.4 KB for both; the ring of weight units (6 of 8 KB)
// takes what is left of 227 KB. The three MLPs run by `wg::mlp_fwd` on
// each warpgroup's tile, their weights streamed from the wrapper's wgmma
// pack (render.py `wgmma_pack_mlps` of render_ae.py `TC_MLPS`, 4.62 MB
// hi and lo) so that every staged unit serves the block's 128 points; a
// skip layer applies the init feature's activation as it loads it.
// posenc runs tile by tile with the whole block, the normalize per
// warpgroup through render_ae.cuh's `latent_norm` (K7b's recompute sums
// the same values in the same order), both with the plain version's
// roundings: one rounded multiply per phase, accurate sinf/cosf, the norm
// clamped at 1e-6. After each 128 points one thread per ray composites
// that pass's samples front to back, its transmittance, sums and last
// weight held in registers from pass to pass: the same operations in the
// same order as one sequential pass. Each output element is owned by one
// thread and every sum runs in a fixed order: two launches give the same
// bits. The TPU kernel's MXU forms (the iota selector and exact-f32 dot
// of its posenc, the bf16 weights, the sin approximations) have no
// counterpart here.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_ae.cuh"
#include "wgmma_tf32.cuh"

using namespace ae;

namespace {

constexpr int MAX_STEPS = 2048;
constexpr int PTS = 2 * TILE;          // points per pass: a tile per warpgroup
constexpr int RS = 4;                  // per point: density, rgb raw

static_assert(D_HIDDEN <= E_HIDDEN && R_HIDDEN <= E_HIDDEN, "hidden rows");

// The wgmma pack (render.py `wgmma_pack_mlps` of render_ae.py `TC_MLPS`):
// the encoder's, density_tfm's, then the View's.
constexpr long PK_E = 0;
constexpr long PK_D = PK_E + wg::mlp_floats(E_IN, E_HIDDEN, E_LAYERS, ENC);
constexpr long PK_R = PK_D + wg::mlp_floats(ENC, D_HIDDEN, D_LAYERS,
                                            D_OUT_W);
constexpr long PK_TOTAL =
    PK_R + wg::mlp_floats(R_IN, R_HIDDEN, R_LAYERS, R_OUT_W);

// Shared memory: both tiles' hidden and init rows, the ring of weight
// units, the pass's results, the rays and the bands; the ring takes what
// the rest leaves of the block's 227 KB, up to 8 units.
constexpr long SMEM_MAX = 232448;
__host__ __device__ constexpr long fixed_floats(int rays_per_block) {
  return 2L * (E_HIDDEN + F_ROWS) * PS + RS * PTS + 8L * rays_per_block
         + N_FREQS;
}
__host__ __device__ constexpr int ring_units() {
  const long room = SMEM_MAX / 4 - fixed_floats(PTS / 2);
  const long units = room / wg::UNIT_FLOATS;
  return units > 8 ? 8 : (int)units;
}

size_t smem_bytes(int rays_per_block) {
  return sizeof(float) * (fixed_floats(rays_per_block)
                          + (long)ring_units() * wg::UNIT_FLOATS);
}

__global__ void __launch_bounds__(THREADS, 1)
render_ae_fwd_kernel(const float* __restrict__ rays,
                     const float* __restrict__ ts,
                     const float* __restrict__ dists,
                     const float* __restrict__ freqs,
                     const float* __restrict__ w,
                     const float* __restrict__ wp,
                     float* __restrict__ out,
                     int n_rays, int steps, int rays_per_block,
                     int sigmoid_kind, int sky_white) {
  constexpr int S = ring_units();
  static_assert(S >= 2, "shared memory for a ring of weight units");
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);   // [2][E_HIDDEN][PS]
  float* fbuf = hbuf + 2 * E_HIDDEN * PS;           // [2][F_ROWS][PS]
  float* stage = fbuf + 2 * F_ROWS * PS;            // the weight units
  float* res = stage + S * wg::UNIT_FLOATS;         // [PTS][RS] raw
  float* ray_s = res + RS * PTS;                    // [rays][8]
  float* fq = ray_s + 8 * rays_per_block;           // [N_FREQS]

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;
  // this warpgroup's tile: its hidden rows, its init feature
  const int wgi = tid / wg::WG_THREADS, wtid = tid % wg::WG_THREADS;
  float* H = hbuf + wgi * E_HIDDEN * PS;
  float* Fw = fbuf + wgi * F_ROWS * PS;

  // per-ray constants; rays past the ragged edge repeat the last ray and
  // are never written out
  for (int r = tid; r < rays_per_block; r += THREADS)
    ray_setup(rays + 6L * min(ray0 + r, n_rays - 1), ray_s + 8 * r);
  if (tid < N_FREQS) fq[tid] = freqs[tid];
  __syncthreads();

  // the compositing of ray `tid`, carried from pass to pass
  float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;

  for (int q0 = 0; q0 < n_pts; q0 += PTS) {
    // ---- the encoder's init feature of both tiles (the whole block, tile
    // by tile; padding points repeat the block's last point): the sample
    // points (rounded as the plain version rounds them) -> rows 0..2, then
    // posenc: rows 3 + j = sin(phase_j), rows 27 + j = cos(phase_j) ----
    for (int tt = 0; tt < 2; ++tt) {
      float* F = fbuf + tt * F_ROWS * PS;
      if (tid < TILE) {
        const int q = min(q0 + TILE * tt + tid, n_pts - 1);
        const float* s = ray_s + 8 * (q / steps);
        const float t = ts[q % steps];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          F[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
      }
      __syncthreads();
      posenc_rows<N_FREQS>(F, fq);
      __syncthreads();
    }

    // ---- the encoder (skips at layers 0 and 3), a tile per warpgroup ->
    // the raw encoding in H rows 0..31 ----
    wg::mlp_fwd<S, E_IN, E_HIDDEN, E_LAYERS, ENC, ACT_LEAKY>(
        Fw, w + E_IN_, wp + PK_E, H, stage);

    // ---- normalize, one thread per point: the latent y = x / max(‖x‖,
    // 1e-6) -> F rows R_ENC.., where the View's init feature takes it ----
    if (wtid < TILE) {
      const float m = fmaxf(latent_norm(H + wtid, PS), 1e-6f);
      for (int k = 0; k < ENC; ++k)
        Fw[(R_ENC + k) * PS + wtid] = H[k * PS + wtid] / m;
    }

    // ---- density_tfm (skip at layer 0) on the latent ----
    wg::mlp_fwd<S, ENC, D_HIDDEN, D_LAYERS, D_OUT_W, ACT_LEAKY>(
        Fw + R_ENC * PS, w + D_IN_, wp + PK_D, H, stage);

    // ---- raw density; the View's init feature [p ‖ elev, azim ‖ latent ‖
    // feats] ----
    const int qw = q0 + TILE * wgi;                 // the tile's first point
    float* rw = res + RS * TILE * wgi;              // its points' results
    if (wtid < TILE) {
      const int q = qw + wtid;
      if (q < n_pts) rw[RS * wtid] = H[wtid];
      const float* s = ray_s + 8 * (min(q, n_pts - 1) / steps);
      Fw[3 * PS + wtid] = s[6];
      Fw[4 * PS + wtid] = s[7];
    }
    for (int i = wtid; i < INTERMEDIATE * TILE; i += wg::WG_THREADS) {
      const int row = i / TILE, p = i % TILE;
      Fw[(R_FEAT + row) * PS + p] = H[(1 + row) * PS + p];
    }

    // ---- siren View MLP (skips at layers 0 and 3) -> raw rgb ----
    wg::mlp_fwd<S, R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30>(
        Fw, w + R_IN_, wp + PK_R, H, stage);
    if (wtid < TILE && qw + wtid < n_pts) {
#pragma unroll
      for (int c = 0; c < 3; ++c) rw[RS * wtid + 1 + c] = H[c * PS + wtid];
    }
    __syncthreads();

    // ---- compositing of this pass's samples: one thread per ray, front to
    // back ----
    const int r = tid;
    if (r < rays_per_block && ray0 + r < n_rays) {
      const float* s = ray_s + 8 * r;
      const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
      const int t_end = min(steps, q0 + PTS - r * steps);
      float dummy;
      for (int t = max(0, q0 - r * steps); t < t_end; ++t) {
        const float* e = res + RS * (r * steps + t - q0);
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
    }
    __syncthreads();
  }

  const int r = tid;
  if (r < rays_per_block && ray0 + r < n_rays) {
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

// Floats of the wgmma pack (render.py `wgmma_pack_mlps` of render_ae.py
// `TC_MLPS`) the kernel expects.
long long render_ae_fwd_pack_floats() { return PK_TOTAL; }

int render_ae_fwd_max_steps() { return MAX_STEPS; }

const char* render_ae_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one render on `stream`; returns the cudaError_t of the launch.
// rays [n_rays, 6], ts and dists [steps], freqs [8] (the posenc bands),
// weights [TOTAL], wp: the weights' wgmma pack (`render_ae_fwd_pack_floats`
// floats, 16-byte aligned), out [n_rays, 4].
int render_ae_fwd_launch(const float* rays, const float* ts,
                         const float* dists, const float* freqs,
                         const float* weights, const float* wp, float* out,
                         int n_rays, int steps, int sigmoid_kind,
                         int sky_white, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16)
    return cudaErrorInvalidValue;
  const int rays_per_block = steps >= PTS ? 1 : PTS / steps;
  const size_t smem = smem_bytes(rays_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      render_ae_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  render_ae_fwd_kernel<<<blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      rays, ts, dists, freqs, weights, wp, out, n_rays, steps,
      rays_per_block, sigmoid_kind, sky_white);
  return cudaGetLastError();
}

}  // extern "C"
