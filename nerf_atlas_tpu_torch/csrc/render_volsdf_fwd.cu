// K8f: fused forward render of VolSDF on Hopper, built once per mode:
// -DRENDER_VOLSDF_EIKONAL=<0 | 1> (render_volsdf.py `fwd_defines`), two
// libraries compiled in parallel.
//
// Replaces nerf_atlas_tpu/ops/pallas/render_volsdf.py:_vs_kernel. One
// launch renders rays [N, 6] -> [N, 4] (rgb ‖ acc) at the T shared sample
// positions ts: per sample point the chain of render_volsdf.cuh (Fourier
// features -> SDF MLP 256×6 -> sphere bias -> Laplace density with the
// learned scale -> siren View 128×5), then σ = relu(density), the rgb
// activation (FUSED_SIGMOID_KINDS) and per-ray compositing: alpha = 1 −
// exp(−σ·Δt·‖r_d‖), running transmittance product of max(1 − alpha,
// 1e-10); a white sky adds the leftover transmittance excluding the 1e10
// tail. The eikonal build renders [N, 5]: column 4 is the ray's mean over
// its points of (‖∇ₓsdf‖ − 1)², ∇ₓsdf by the SDF MLP's transpose chain
// (wgmma_tf32.cuh `mlp_input_grad`) through the Fourier jacobian and the
// sphere bias (render_volsdf.cuh `eikonal_point`).
//
// What bounds it: compute. 549,632 multiply-adds per sample point (SDF
// MLP 453,120, View 96,512), 1.10 MFLOP, 4.61 TFLOP per 65536×64 call; in
// split TF32 three TF32 products per multiply-add, 27.9 ms at the TF32
// tensor-core peak (495 TFLOP/s). The eikonal's chain adds 444,928
// (8.34 TFLOP per call with the forward, 50.6 ms). On an NVIDIA H100
// 80GB HBM3 at 700 W a call takes 117.4 ms (the eikonal build 203.0 ms),
// 4.2× (4.0×) that bound, as K1, K7f and K9f sit at theirs: each staged
// weight unit costs a fixed ~0.8 µs whatever its width (PERF.md §6–§7),
// and a 128-point pass stages 566 units (the eikonal's chain 480 more).
//
// Design (K1's, render_fwd.cu, as K9f and K7f): every MLP product on the
// tensor cores by TF32 `wgmma` in split TF32 (wgmma_tf32.cuh: a fresh
// accumulator per 8-deep k-step). A block of 256 threads (two
// warpgroups) owns max(1, 128/T) rays and walks their points 128 at a
// time: two 64-point tiles, one per warpgroup, each with a 256-row hidden
// buffer H and a 68-row init buffer F (the SDF's init feature [p ‖ sin ‖
// cos], then the View's [p ‖ elev, azim ‖ latent]) in dynamic shared
// memory, ~176 KB for both; the ring of weight units (6 of 8 KB) takes
// what is left of 227 KB. Both MLPs run by `wg::mlp_fwd` on each
// warpgroup's tile, their weights streamed from the wrapper's wgmma pack
// (render.py `wgmma_pack_mlps` of render_volsdf.py TC_MLPS, 4.53 MB, hi
// and lo) so that every staged unit serves the block's 128 points; a skip
// layer applies leaky-relu to the init feature as it loads it. The sample
// points and the Fourier rows run tile by tile with the whole block
// (`sdf_init_rows`), σ, the sphere bias and the View's init feature per
// warpgroup, rounded as the plain version rounds them (the Fourier
// phases, `point_norm`, `laplace_density`; sinf/cosf/expf the accurate
// ones).
//
// The eikonal. Leaky-relu's act′ is the sign of its input, which its
// output keeps, so the SDF forward keeps one bit per activation of each
// layer (`wg::sign_rows` after each layer), and the init feature's too:
// 14,872 bytes per tile in a global scratch of one slot (two tiles) per
// SM id, a few MB whatever the rays: each block claims a free slot when it
// starts (`claim_slot`, its SM's) and frees it when it ends, so the grid
// covers every ray block. After the
// View, the chain runs on
// the tensor cores by the same products with A = u from the tile's H rows
// and B = each layer's W [out][in] from the wrapper's chain pack
// (render.py `wgmma_layout_index(..., transposed=True)`, 3.59 MB), then
// u_I = act′ ⊙ the product (`wg::apply_slopes`); d out_0 / d init
// accumulates in F, and the SDF init feature is rebuilt in H for
// `eikonal_point`.
//
// After each 128 points one thread per ray composites that pass's
// samples front to back, its transmittance, sums, last weight and
// eikonal sum held in registers from pass to pass: the same operations in
// the same order as one sequential pass. Each output element is owned by
// one thread and every sum runs in a fixed order: two launches give the
// same bits. The TPU kernel's MXU forms (the bf16 weights, `_dot_exact`,
// the sin approximations) have no counterpart.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_volsdf.cuh"
#include "wgmma_tf32.cuh"

#ifndef RENDER_VOLSDF_EIKONAL
#error "build with -DRENDER_VOLSDF_EIKONAL=<0|1> (render_volsdf.py fwd_defines)"
#endif

using namespace vs;

namespace {

constexpr bool EIK = RENDER_VOLSDF_EIKONAL != 0;
constexpr int MAX_STEPS = 2048;
constexpr int PTS = 2 * TILE;          // points per pass: a tile per warpgroup
constexpr int RS = 5;                  // per point: σ, rgb raw, eikonal e

// The wgmma pack (render.py `wgmma_pack_mlps` of render_volsdf.py
// TC_MLPS): the SDF MLP's, then the View MLP's. The eikonal build also
// takes the SDF MLP's chain pack (`wg::t_mlp_floats` floats).
constexpr long PK_S = 0;
constexpr long PK_R =
    PK_S + wg::mlp_floats(S_IN, S_HIDDEN, S_LAYERS, S_OUT);
constexpr long PK_TOTAL =
    PK_R + wg::mlp_floats(R_IN, R_HIDDEN, R_LAYERS, R_OUT);
constexpr long PK_CHAIN = wg::t_mlp_floats(S_IN, S_HIDDEN, S_LAYERS);

// A tile's signs (`wg::sign_rows`), 8 bytes a row: the SDF MLP's layer_in
// and hidden activations (rows L·256 + n, L = 0 layer_in, 1..6 the hidden
// layers), then its init feature's.
constexpr long SIGNS_INIT = 8L * (S_LAYERS + 1) * S_HIDDEN;
constexpr long SIGN_BYTES = SIGNS_INIT + 8L * S_IN;          // 14,872

// Shared memory: both tiles' hidden and init rows, the ring of weight
// units, the pass's results, the rays and B (and, in the eikonal build,
// the block's slot); the ring takes what the rest leaves of the block's
// 227 KB, up to 8 units.
constexpr long SMEM_MAX = 232448;
__host__ __device__ constexpr long fixed_floats(int rays_per_block) {
  return 2L * (S_HIDDEN + F_ROWS) * PS + RS * PTS + 8L * rays_per_block
         + 3 * N_FREQS + (EIK ? 4 : 0);
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

// The eikonal build's sign scratch: a slot of two tiles' signs per SM id
// (%nsmid of them: the ids need not be contiguous, so there may be more
// than SMs), and at least one per block that can be resident at once. A
// block claims a free slot as it starts, its SM's first, and frees it as
// it ends; `busy` [slots] starts at 0. So a block finds its SM's slot
// free, the block before it on that SM having freed it, unless it was
// preempted and resumed on another SM; then it takes the next free one.
// The search ends: one is free or about to be; a block that still finds
// none after 2^24 tries traps (an error of the launch, not a hang).
// `word`: a word of the block's dynamic shared memory (a static __shared__
// variable would sit before it and move the dynamic buffers off their
// alignment).
__device__ int claim_slot(int* busy, int slots, int* word) {
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    int s = (int)(smid % (unsigned)slots);
    for (int tries = 0; atomicCAS(busy + s, 0, 1) != 0; ++tries) {
      if (tries >= (1 << 24)) __trap();
      s = s + 1 == slots ? 0 : s + 1;
    }
    __threadfence();
    *word = s;
  }
  __syncthreads();
  return *word;
}

__device__ void free_slot(int* busy, int slot) {
  __threadfence();                 // this block's signs before the release
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(busy + slot, 0);
}

__global__ void __launch_bounds__(THREADS, 1)
render_volsdf_fwd_kernel(const float* __restrict__ rays,
                         const float* __restrict__ ts,
                         const float* __restrict__ dists,
                         const float* __restrict__ w,
                         const float* __restrict__ wp,
                         const float* __restrict__ wc,
                         uint8_t* __restrict__ stash,
                         int* __restrict__ busy,
                         float* __restrict__ out,
                         int n_rays, int steps, int rays_per_block,
                         int sigmoid_kind, int sky_white, int sphere,
                         int slots) {
  constexpr int S = ring_units();
  static_assert(S >= 2, "shared memory for a ring of weight units");
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);   // [2][S_HIDDEN][PS]
  float* fbuf = hbuf + 2 * S_HIDDEN * PS;           // [2][F_ROWS][PS]
  float* stage = fbuf + 2 * F_ROWS * PS;            // the weight units
  float* res = stage + S * wg::UNIT_FLOATS;         // [PTS][RS]
  float* ray_s = res + RS * PTS;                    // [rays][8]
  float* fb = ray_s + 8 * rays_per_block;           // B [3][32]
  int* slot_word = reinterpret_cast<int*>(fb + 3 * N_FREQS);  // EIK

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;
  // this warpgroup's tile: its hidden and init rows and its signs
  const int wgi = tid / wg::WG_THREADS, wtid = tid % wg::WG_THREADS;
  float* H = hbuf + wgi * S_HIDDEN * PS;
  float* F = fbuf + wgi * F_ROWS * PS;
  int slot = 0;
  if constexpr (EIK) slot = claim_slot(busy, slots, slot_word);
  uint8_t* signs = EIK ? stash + (2L * slot + wgi) * SIGN_BYTES : nullptr;
  const float s = w[SCALE];

  // per-ray constants; rays past the ragged edge repeat the last ray and
  // are never written out
  for (int r = tid; r < rays_per_block; r += THREADS)
    ray_setup(rays + 6L * min(ray0 + r, n_rays - 1), ray_s + 8 * r);
  for (int i = tid; i < 3 * N_FREQS; i += THREADS) fb[i] = w[FB + i];
  __syncthreads();

  // the compositing of ray `tid`, carried from pass to pass
  float trans = 1.0f, acc = 0.0f, w_last = 0.0f, eik = 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;

  for (int q0 = 0; q0 < n_pts; q0 += PTS) {
    // ---- the SDF init feature of both tiles (the whole block, tile by
    // tile; padding points repeat the block's last point) ----
    for (int tt = 0; tt < 2; ++tt)
      sdf_init_rows(fbuf + tt * F_ROWS * PS, ray_s, ts, fb, q0 + TILE * tt,
                    n_pts, steps);
    if constexpr (EIK) wg::sign_rows(F, S_IN, signs + SIGNS_INIT);

    // ---- the SDF MLP, a tile per warpgroup (the eikonal build keeps its
    // signs) ----
    wg::mlp_fwd<S, S_IN, S_HIDDEN, S_LAYERS, S_OUT, ACT_LEAKY, EIK>(
        F, w + S_MLP, wp + PK_S, H, stage, signs);

    // ---- sdf and σ; the View's init feature [p ‖ elev, azim ‖ latent]
    const int qw = q0 + TILE * wgi;                 // the tile's first point
    float* rw = res + RS * TILE * wgi;              // its points' results
    if (wtid < TILE) {
      const int q = qw + wtid;
      float sdf = H[wtid];
      if (sphere) sdf = __fadd_rn(sdf, __fsub_rn(point_norm(F, wtid), 1.0f));
      float e2, cdf;
      const float sigma = laplace_density(sdf, s, &e2, &cdf);
      if (q < n_pts) rw[RS * wtid] = sigma;
      const float* rs = ray_s + 8 * (min(q, n_pts - 1) / steps);
      F[3 * PS + wtid] = rs[6];
      F[4 * PS + wtid] = rs[7];
    }
    for (int i = wtid; i < LATENT * TILE; i += wg::WG_THREADS) {
      const int row = i / TILE, p = i % TILE;
      F[(5 + row) * PS + p] = H[(1 + row) * PS + p];
    }

    // ---- siren View MLP -> raw rgb ----
    wg::mlp_fwd<S, R_IN, R_HIDDEN, R_LAYERS, R_OUT, ACT_SIN30>(
        F, w + R_MLP, wp + PK_R, H, stage);
    if (wtid < TILE && qw + wtid < n_pts) {
#pragma unroll
      for (int c = 0; c < 3; ++c) rw[RS * wtid + 1 + c] = H[c * PS + wtid];
    }

    if constexpr (EIK) {
      // ---- the eikonal: d out_0 / d init into F by the transpose chain,
      // then the SDF init feature again, into H (the whole block, tile by
      // tile), for each point's residual ----
      wg::mlp_input_grad<S, S_IN, S_HIDDEN, S_LAYERS, S_OUT>(
          H, F, w + S_MLP, wc, stage, signs);
      for (int tt = 0; tt < 2; ++tt)
        sdf_init_rows(hbuf + tt * S_HIDDEN * PS, ray_s, ts, fb,
                      q0 + TILE * tt, n_pts, steps);
      if (wtid < TILE && qw + wtid < n_pts) {
        float de[3];
        rw[RS * wtid + 4] = eikonal_point(H, F, fb, sphere != 0, wtid, de);
      }
    }
    __syncthreads();

    // ---- compositing of this pass's samples: one thread per ray, front to
    // back ----
    const int r = tid;
    if (r < rays_per_block && ray0 + r < n_rays) {
      const float* rs = ray_s + 8 * r;
      const float rd_norm = sqrtf(rs[3] * rs[3] + rs[4] * rs[4]
                                  + rs[5] * rs[5]);
      const int t_end = min(steps, q0 + PTS - r * steps);
      float dummy;
      for (int t = max(0, q0 - r * steps); t < t_end; ++t) {
        const float* e = res + RS * (r * steps + t - q0);
        const float sigma = fmaxf(e[0], 0.0f);
        const float alpha = 1.0f - expf(-sigma * (dists[t] * rd_norm));
        const float wt = alpha * trans;
        acc += wt;
        c0 += wt * rgb_act(e[1], sigmoid_kind, &dummy);
        c1 += wt * rgb_act(e[2], sigmoid_kind, &dummy);
        c2 += wt * rgb_act(e[3], sigmoid_kind, &dummy);
        trans *= fmaxf(1.0f - alpha, 1e-10f);
        w_last = wt;
        if constexpr (EIK) eik += e[4];
      }
    }
    __syncthreads();
  }

  const int r = tid;
  if (r < rays_per_block && ray0 + r < n_rays) {
    const float sky = sky_white ? 1.0f - (acc - w_last) : 0.0f;
    const int cols = EIK ? 5 : 4;
    float* o = out + (long)cols * (ray0 + r);
    o[0] = c0 + sky;
    o[1] = c1 + sky;
    o[2] = c2 + sky;
    o[3] = acc;
    if constexpr (EIK) o[4] = eik / steps;
  }
  if constexpr (EIK) free_slot(busy, slot);
}

// Blocks of the kernel that can be resident on the current device at once
// (its fewest rays per block: the least shared memory).
cudaError_t resident_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(render_volsdf_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(PTS / 2)));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, render_volsdf_fwd_kernel, THREADS, smem_bytes(1));
  *blocks = sms * per_sm;
  return err;
}

__global__ void nsmid_kernel(int* n) {
  unsigned v;
  asm volatile("mov.u32 %0, %%nsmid;" : "=r"(v));
  *n = (int)v;
}

// The SM ids of the current device (%nsmid), read by a one-thread launch.
cudaError_t sm_ids(int* n) {
  int* d = nullptr;
  cudaError_t err = cudaMalloc(&d, sizeof(int));
  if (err == cudaSuccess) {
    nsmid_kernel<<<1, 1>>>(d);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess)
    err = cudaMemcpy(n, d, sizeof(int), cudaMemcpyDeviceToHost);
  if (d != nullptr) cudaFree(d);
  return err;
}

// Ray blocks (the grid) of a launch on n_rays rays of `steps` samples.
int grid_blocks(int n_rays, int steps) {
  const int rays_per_block = steps >= PTS ? 1 : PTS / steps;
  return (n_rays + rays_per_block - 1) / rays_per_block;
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects.
long long render_volsdf_fwd_weight_count() { return TOTAL; }

// Floats of the wgmma pack (render.py `wgmma_pack_mlps` of
// render_volsdf.py TC_MLPS) and, in the eikonal build, of the chain pack
// (`wgmma_layout_index(..., transposed=True)` of the SDF MLP; else 0).
long long render_volsdf_fwd_pack_floats() { return PK_TOTAL; }

long long render_volsdf_fwd_chain_floats() { return EIK ? PK_CHAIN : 0; }

// Bytes of a slot of the sign scratch (two tiles; 0 without the eikonal).
long long render_volsdf_fwd_stash_bytes_per_slot() {
  return EIK ? 2 * SIGN_BYTES : 0;
}

// Slots of the sign scratch for launches on the current device: its SM
// ids, and at least the blocks it can hold at once (0 without the
// eikonal); < 0: -cudaError_t.
int render_volsdf_fwd_stash_slots() {
  if (!EIK) return 0;
  int blocks = 0, ids = 0;
  cudaError_t err = resident_blocks(&blocks);
  if (err == cudaSuccess) err = sm_ids(&ids);
  return err != cudaSuccess ? -static_cast<int>(err)
                            : (ids > blocks ? ids : blocks);
}

int render_volsdf_fwd_max_steps() { return MAX_STEPS; }

const char* render_volsdf_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one render on `stream`; returns the cudaError_t of the launch.
// rays [n_rays, 6], ts and dists [steps], weights [TOTAL], wp: the
// weights' wgmma pack (`render_volsdf_fwd_pack_floats` floats, 16-byte
// aligned), out [n_rays, 4] (the eikonal build: [n_rays, 5], and then wc,
// the chain pack, 16-byte aligned; stash, `slots` ×
// `render_volsdf_fwd_stash_bytes_per_slot` bytes, and busy, `slots` ints
// set to 0, with slots >= `render_volsdf_fwd_stash_slots`).
int render_volsdf_fwd_launch(const float* rays, const float* ts,
                             const float* dists, const float* weights,
                             const float* wp, const float* wc, void* stash,
                             int* busy, float* out, int n_rays, int steps,
                             int sigmoid_kind, int sky_white, int sphere,
                             int slots, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16
      || (EIK && (wc == nullptr || reinterpret_cast<uintptr_t>(wc) % 16
                  || stash == nullptr || busy == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if constexpr (EIK) {
    int blocks = 0;
    err = resident_blocks(&blocks);
    if (err != cudaSuccess) return err;
    if (blocks < 1 || slots < blocks) return cudaErrorInvalidValue;
  }
  const int rays_per_block = steps >= PTS ? 1 : PTS / steps;
  const size_t smem = smem_bytes(rays_per_block);
  err = cudaFuncSetAttribute(
      render_volsdf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  render_volsdf_fwd_kernel<<<grid_blocks(n_rays, steps), THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      rays, ts, dists, weights, wp, wc, static_cast<uint8_t*>(stash), busy,
      out, n_rays, steps, rays_per_block, sigmoid_kind, sky_white, sphere,
      slots);
  return cudaGetLastError();
}

}  // extern "C"
