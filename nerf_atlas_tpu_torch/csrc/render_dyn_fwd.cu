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
// 65536×64 call; in split TF32 three TF32 products per multiply-add, 43.6
// ms at the TF32 tensor-core peak (495 TFLOP/s). On an H100 80GB HBM3 at
// 700 W a cp Δx call takes ~168 ms, ~3.9× that bound, as K1 sits at ~4×
// its own: each staged weight unit costs ~0.8 µs whatever its width, a
// fixed cost per unit (the block barrier, the wgmma waits, the A loads)
// rather than the tensor work or the 231 GB of L2 reads (PERF.md §6–§7).
//
// Design (K1's, render_fwd.cu): every MLP product on the tensor cores by
// TF32 `wgmma` in split TF32 (wgmma_tf32.cuh: a fresh accumulator per
// 8-deep k-step). A block of 256 threads (two warpgroups) owns max(1,
// 128/T) rays and walks their points 128 at a time: two 64-point tiles,
// one per warpgroup, each with a 256-row hidden buffer, a 68-row init
// buffer (the warp's [x ‖ sin ‖ cos], then the canonical's init feature,
// then the View's) and the 8 per-point rows of render_dyn.cuh (p, t, Δx)
// in dynamic shared memory, ~180.6 KB for both; the ring of weight units
// (5 of 8 KB) takes what is left of 227 KB. The four MLPs (warp,
// rigidity, density, View) run by `wg::mlp_fwd` on each warpgroup's tile,
// their weights streamed from the wrapper's wgmma pack (render.py
// `wgmma_pack_mlps` of render_dyn.py `Layout.tc_mlps`, 7.06 MB for cp Δx
// to 7.20 MB for posenc spline, hi and lo) so that every staged unit
// serves the block's 128 points; a skip layer applies the init feature's
// activation as it loads it. The elementwise steps run tile by tile with
// the whole block (the sample points, the warp's Fourier rows, the CP
// encode or posenc) or per warpgroup (de Casteljau, the gate, p + dp, the
// View's init feature), rounded as the plain version rounds them:
// render_dyn.cuh's `fourier_rows`, `spline_eval`, render_plain.cuh's
// `cp_encode_rows`, render_common.cuh's `posenc_rows`; sinf/cosf/expf are
// the accurate ones. The spline warp's layer_out is packed at 30 columns
// (MAX_SPLINE = 11), so S is a run-time argument. After each 128 points
// one thread per ray composites that pass's samples front to back, its
// transmittance, sums, last weight and dp² sum held in registers from
// pass to pass: the same operations in the same order as one sequential
// pass. Each output element is owned by one thread and every sum runs in
// a fixed order: two launches give the same bits. The TPU kernel's MXU
// forms (the bf16 weights, the packed CP block-diagonal and its hat-basis
// matmul, the sin approximations, the 8-ray blocks) have no counterpart.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_dyn.cuh"
#include "wgmma_tf32.cuh"

using namespace dyn;

namespace {

constexpr int MAX_STEPS = 2048;
constexpr int PTS = 2 * TILE;          // points per pass: a tile per warpgroup
constexpr int RS = 5;                  // per point: density, rgb raw, dp²
constexpr int H_ROWS = W_HIDDEN;       // the widest MLP

static_assert(C::D_HIDDEN <= H_ROWS && R_HIDDEN <= H_ROWS &&
              G_HIDDEN <= H_ROWS, "hidden rows");

// The wgmma pack (render.py `wgmma_pack_mlps` of render_dyn.py
// `Layout.tc_mlps`): the warp MLP's, the rigidity MLP's, then the
// canonical density and View MLPs'.
constexpr long PK_W = 0;
constexpr long PK_G =
    PK_W + wg::mlp_floats(W_FI, W_HIDDEN, W_LAYERS, W_OUT);
constexpr long PK_D = PK_G + wg::mlp_floats(3, G_HIDDEN, G_LAYERS, 1);
constexpr long PK_R = PK_D + wg::mlp_floats(C::FEAT_IN, C::D_HIDDEN,
                                            C::D_LAYERS, C::D_OUT_W);
constexpr long PK_TOTAL =
    PK_R + wg::mlp_floats(R_IN, R_HIDDEN, R_LAYERS, R_OUT_W);

// Shared memory: both tiles' hidden, init and A rows, the ring of weight
// units, the pass's results, the rays, their times, B and the bands; the
// ring takes what the rest leaves of the block's 227 KB, up to 8 units.
constexpr long SMEM_MAX = 232448;
__host__ __device__ constexpr long fixed_floats(int rays_per_block) {
  return 2L * (H_ROWS + F_ROWS + A_ROWS) * PS + RS * PTS
         + 9L * rays_per_block + W_IN * W_FREQS + MAX_FREQS;
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
render_dyn_fwd_kernel(const float* __restrict__ rays,
                      const float* __restrict__ times,
                      const float* __restrict__ ts,
                      const float* __restrict__ dists,
                      const float* __restrict__ w,
                      const float* __restrict__ wp,
                      const float* __restrict__ freqs,
                      float* __restrict__ out,
                      int n_rays, int steps, int rays_per_block,
                      int spline_points, int sigmoid_kind, int sky_white,
                      int want_dp) {
  constexpr int S = ring_units();
  static_assert(S >= 2, "shared memory for a ring of weight units");
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);   // [2][H_ROWS][PS]
  float* fbuf = hbuf + 2 * H_ROWS * PS;             // [2][F_ROWS][PS]
  float* abuf = fbuf + 2 * F_ROWS * PS;             // [2][A_ROWS][PS]
  float* stage = abuf + 2 * A_ROWS * PS;            // the weight units
  float* res = stage + S * wg::UNIT_FLOATS;         // [PTS][RS]
  float* ray_s = res + RS * PTS;                    // [rays][8]
  float* ray_t = ray_s + 8 * rays_per_block;        // [rays] time
  float* fb = ray_t + rays_per_block;               // B [W_IN][32]
  float* fq = fb + W_IN * W_FREQS;                  // posenc bands

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;
  // this warpgroup's tile: its hidden, init and A rows
  const int wgi = tid / wg::WG_THREADS, wtid = tid % wg::WG_THREADS;
  float* H = hbuf + wgi * H_ROWS * PS;
  float* Fw = fbuf + wgi * F_ROWS * PS;
  float* Aw = abuf + wgi * A_ROWS * PS;
  const float* __restrict__ wc = w + CANON;

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

  // the compositing of ray `tid`, carried from pass to pass
  float trans = 1.0f, acc = 0.0f, w_last = 0.0f, msum = 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;

  for (int q0 = 0; q0 < n_pts; q0 += PTS) {
    // ---- the warp's init feature of both tiles (the whole block, tile by
    // tile; padding points repeat the block's last point): p (rounded as
    // the plain version rounds it) and, for Δx, t -> F rows 0..W_IN-1 and
    // A rows, then the Fourier rows ----
    for (int tt = 0; tt < 2; ++tt) {
      float* F = fbuf + tt * F_ROWS * PS;
      float* A = abuf + tt * A_ROWS * PS;
      if (tid < TILE) {
        const int q = min(q0 + TILE * tt + tid, n_pts - 1);
        const float* s = ray_s + 8 * (q / steps);
        const float t_s = ts[q % steps];
        const float t = ray_t[q / steps];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float p = sample_point(s[c], t_s, s[3 + c]);
          F[c * PS + tid] = p;
          A[(A_P + c) * PS + tid] = p;
        }
        if constexpr (!SPLINE) F[3 * PS + tid] = t;
        A[A_T * PS + tid] = t;
      }
      __syncthreads();
      fourier_rows(F, fb);
      __syncthreads();
    }

    // ---- the warp MLP, a tile per warpgroup -> Δx or the control points,
    // de Casteljau at t -> A rows A_SPL ----
    wg::mlp_fwd<S, W_FI, W_HIDDEN, W_LAYERS, W_OUT, ACT_LEAKY>(
        Fw, w + W_MLP, wp + PK_W, H, stage);
    if (wtid < TILE) {
      float spl[3];
      spline_eval(H, wtid, Aw[A_T * PS + wtid], spline_points, spl);
#pragma unroll
      for (int c = 0; c < 3; ++c) Aw[(A_SPL + c) * PS + wtid] = spl[c];
    }

    // ---- the rigidity MLP on p (F rows 0..2); dp = spl·σ(rigidity), x'
    // = p + dp -> F rows 0..2, the point's mean of dp² -> its result ----
    wg::mlp_fwd<S, 3, G_HIDDEN, G_LAYERS, 1, ACT_LEAKY>(Fw, w + G_MLP,
                                                        wp + PK_G, H, stage);
    const int qw = q0 + TILE * wgi;                 // the tile's first point
    float* rw = res + RS * TILE * wgi;              // its points' results
    if (wtid < TILE) {
      const float gate = sigmoid(H[wtid]);
      float sq[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float dp = __fmul_rn(Aw[(A_SPL + c) * PS + wtid], gate);
        Fw[c * PS + wtid] = __fadd_rn(Aw[(A_P + c) * PS + wtid], dp);
        sq[c] = __fmul_rn(dp, dp);
      }
      if (qw + wtid < n_pts)
        rw[RS * wtid + 4] = __fdiv_rn(__fadd_rn(__fadd_rn(sq[0], sq[1]),
                                                sq[2]), 3.0f);
    }
    __syncthreads();

    // ---- the canonical's init feature at x' (the whole block, tile by
    // tile): [x' ‖ CP encode] or [x' ‖ posenc] ----
    for (int tt = 0; tt < 2; ++tt) {
      float* F = fbuf + tt * F_ROWS * PS;
      if constexpr (ENC == ENC_CP) {
        cp_encode_rows(F, wc);
      } else {
        posenc_rows<C::N_FREQS>(F, fq);
      }
    }
    __syncthreads();

    // ---- the canonical density MLP (skips at layers 0 and 3) ----
    wg::mlp_fwd<S, C::FEAT_IN, C::D_HIDDEN, C::D_LAYERS, C::D_OUT_W,
                ACT_LEAKY>(Fw, wc + C::D_IN, wp + PK_D, H, stage);

    // ---- raw density; the View's init feature [x' ‖ elev, azim ‖ feats]
    if (wtid < TILE) {
      const int q = qw + wtid;
      if (q < n_pts) rw[RS * wtid] = H[wtid];
      const float* s = ray_s + 8 * (min(q, n_pts - 1) / steps);
      Fw[3 * PS + wtid] = s[6];
      Fw[4 * PS + wtid] = s[7];
    }
    for (int i = wtid; i < INTERMEDIATE * TILE; i += wg::WG_THREADS) {
      const int row = i / TILE, p = i % TILE;
      Fw[(5 + row) * PS + p] = H[(1 + row) * PS + p];
    }

    // ---- siren View MLP -> raw rgb ----
    wg::mlp_fwd<S, R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30>(
        Fw, wc + C::R_IN_, wp + PK_R, H, stage);
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
    }
    __syncthreads();
  }

  const int r = tid;
  if (r < rays_per_block && ray0 + r < n_rays) {
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

// Floats of the wgmma pack (render.py `wgmma_pack_mlps` of render_dyn.py
// `Layout.tc_mlps`) the kernel expects.
long long render_dyn_fwd_pack_floats() { return PK_TOTAL; }

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
// wp: the weights' wgmma pack (`render_dyn_fwd_pack_floats` floats,
// 16-byte aligned), freqs: the posenc bands for the posenc canonical (else
// unused), out [n_rays, 4] (want_dp: [n_rays, 5]). spline_points: 0 for
// the Δx build, 2..MAX_SPLINE for the spline build.
int render_dyn_fwd_launch(const float* rays, const float* times,
                          const float* ts, const float* dists,
                          const float* weights, const float* wp,
                          const float* freqs, float* out, int n_rays,
                          int steps, int spline_points, int sigmoid_kind,
                          int sky_white, int want_dp, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || (SPLINE ? (spline_points < 2 || spline_points > MAX_SPLINE)
                 : spline_points != 0)
      || (C::N_FREQS > 0 && freqs == nullptr)
      || wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16)
    return cudaErrorInvalidValue;
  const int rays_per_block = steps >= PTS ? 1 : PTS / steps;
  const size_t smem = smem_bytes(rays_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      render_dyn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  render_dyn_fwd_kernel<<<blocks, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      rays, times, ts, dists, weights, wp, freqs, out, n_rays, steps,
      rays_per_block, spline_points, sigmoid_kind, sky_white, want_dp);
  return cudaGetLastError();
}

}  // extern "C"
