// K1: fused forward render of PlainNeRF and TinyNeRF on Hopper, in six
// instantiations: enc_kind "cp", "hash", "posenc", "tiny", "cone" and
// "cylinder".
//
// Replaces nerf_atlas_tpu/ops/pallas/render.py:_render_kernel (every
// enc_kind, its [1, T] and [B, T] ts and its want_weights output). One
// launch renders rays [N, 6] -> [N, 4] (rgb ‖ acc), and on request the
// compositing weights [N, T] (CoarseFineNeRF's coarse pass samples its
// fine positions from them):
//   p = r_o + t·r_d for the T sample positions, shared by every ray ([T]
//   ts and dists, row stride 0) or each ray's own ([N, T], stride T: the
//   fine pass's merged positions; a ray past the ragged edge reads the
//   last ray's row)
//   -> the density MLP's init feature:
//      cp: CP encode (4 levels × rank 8, 2-tap linear interpolation per
//        axis, product over the three axes) -> [p ‖ cp] (35);
//      hash: the point's 16 hash-grid features (K5f's output, feats
//        [N·T, 16]) -> [p ‖ feats] (19);
//      posenc: 10 bands 2^linspace(0, 6, 10) -> [p ‖ sin ‖ cos] (63);
//      tiny: 8 bands 2^linspace(0, 6, 8) -> [p ‖ sin ‖ cos] (51);
//      cone / cylinder: MipNeRF's integrated positional encoding of the
//        segment's conical-frustum / cylinder Gaussian at 16 scales
//        2^0..2^15 (render_common.cuh `ipe_moments`, `ipe_rows`), 96
//        features that replace the encoded point;
//      every mode but cp rounds p after the product and after the sum
//   -> density SkipConnMLP FEAT_IN -> 256×5 -> 33 (tiny: 128×6 -> 4),
//      leaky-relu 0.01, skip concat [h ; init] at layers 0 and 3 (split
//      into two matmuls)
//   -> siren View MLP on [p ‖ elev, azim ‖ feats] (37) -> 128×5 -> 3,
//      activation sin(30·h) (tiny: none; rgb = the MLP's outputs 1..3)
//   -> rgb activation (FUSED_SIGMOID_KINDS), sigma = softplus(density-1)
//   -> per-ray compositing: alpha = 1 - exp(-sigma·Δt·‖r_d‖), running
//      transmittance product of max(1 - alpha, 1e-10), weight alpha·T
//      (written out when asked); a white sky adds the leftover
//      transmittance excluding the 1e10 tail sample.
//
// What bounds it: compute. Each sample point costs 0.89-1.01 MFLOP of
// matmul for the PlainNeRF modes (459,520 multiply-adds for cp, 447,232
// for hash, 481,024 for posenc, 506,368 for mip) and 0.24 MFLOP for tiny
// (118,400), ≈37.7 TFLOP for an 800×800×64 cp frame, against 0.5-2 MB of
// f32 weights that every block re-reads; the hash mode also reads 64 B of
// features per point.
//
// First design (simple and exact, not yet fast): float32 FMAs on the
// CUDA cores, no tensor cores. A block of 256 threads owns
// max(1, 64/T) rays and walks their points in tiles of 64. The tile's
// activations stay in dynamic shared memory for the whole MLP chain,
// stored feature-major [feature][64 points] so that a thread reads its 8
// points with two float4 broadcasts. Each thread keeps an 8-point ×
// (out/32)-output register tile; a warp reads one weight row (coalesced,
// through L1/L2 where the weights stay resident) per input feature. A
// layer writes its activated output back over its own input after a
// barrier, so one hidden buffer serves every layer. Per-point sigma/rgb
// collect in shared memory and one thread per ray composites
// sequentially: no cross-block reduction and no scan workaround. Every
// mode but mip fits two blocks in an SM (cp ~93 KB of shared memory per
// block); mip's 96 init rows and their activations (~123 KB) take one.
// The TPU kernel's MXU forms (the posenc / IPE selector matmuls, the
// exact-f32 dot, the bf16 weights, the sin approximations) have no
// counterpart here: the phases are rounded multiplies and sinf/cosf are
// accurate. bf16 tensor-core MMAs (mma.sync / wgmma) are the next step.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_plain.cuh"

using namespace plain;

namespace {

constexpr int MAX_STEPS = 2048;

template <int ENC>
size_t smem_bytes(int rays_per_block, int steps) {
  using L = Layout<ENC>;
  return sizeof(float) * ((size_t)(L::H_ROWS + 2 * L::F_ROWS) * PS
                          + 4 * (size_t)rays_per_block * steps
                          + 8 * (size_t)rays_per_block + MAX_FREQS);
}

// two blocks per SM but for mip, whose 96-row init feature and its
// activation take ~123 KB of shared memory
template <int ENC>
__global__ void __launch_bounds__(THREADS, Layout<ENC>::MIP ? 1 : 2)
render_fwd_kernel(const float* __restrict__ rays,
                  const float* __restrict__ ts,
                  const float* __restrict__ dists,
                  const float* __restrict__ w,
                  const float* __restrict__ feats,
                  const float* __restrict__ freqs,
                  float* __restrict__ out,
                  float* __restrict__ wout,
                  int n_rays, int steps, int ts_stride, int rays_per_block,
                  int sigmoid_kind, int sky_white) {
  using L = Layout<ENC>;
  constexpr int FEAT_IN = L::FEAT_IN;
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);   // [H_ROWS][PS]
  float* fbuf = hbuf + L::H_ROWS * PS;              // [F_ROWS][PS] init feat
  float* fact = fbuf + L::F_ROWS * PS;              // [F_ROWS][PS] act(init)
  float* res = fact + L::F_ROWS * PS;               // [points][4] sigma, rgb
  float* ray_s = res + 4 * rays_per_block * steps;  // [rays][8] o, d, elaz
  float* fq = ray_s + 8 * rays_per_block;           // [MAX_FREQS] bands

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;

  // per-ray constants; rays past the ragged edge repeat the last ray and
  // are never written out
  for (int r = tid; r < rays_per_block; r += THREADS)
    ray_setup(rays + 6L * min(ray0 + r, n_rays - 1), ray_s + 8 * r);
  if (tid < L::N_FREQS) fq[tid] = freqs[tid];
  __syncthreads();

  for (int q0 = 0; q0 < n_pts; q0 += TILE) {
    if constexpr (ENC == ENC_CP || ENC == ENC_HASH) {
      // ---- sample points (padding rows repeat the block's last point) --
      if (tid < TILE) {
        const int q = min(q0 + tid, n_pts - 1);
        const float* s = ray_s + 8 * (q / steps);
        const float t =
            ray_row(ts, ts_stride, ray0 + q / steps, n_rays)[q % steps];
        if constexpr (ENC == ENC_CP) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            fbuf[c * PS + tid] = s[c] + t * s[3 + c];
        } else {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            fbuf[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
        }
      }
      if constexpr (ENC == ENC_HASH) {
        // ---- hash features -> rows 3..18 (padding rows repeat the last
        // point, as the sample points do) ----
        for (int i = tid; i < TILE * HASH_FEATS; i += THREADS) {
          const int p = i / HASH_FEATS, j = i % HASH_FEATS;
          const int q = min(q0 + p, n_pts - 1);
          const long g = (long)min(ray0 + q / steps, n_rays - 1) * steps
                         + q % steps;
          fbuf[(3 + j) * PS + p] = __ldg(feats + g * HASH_FEATS + j);
        }
      }
      __syncthreads();

      // ---- CP encode: one (point, level) per thread -> rows 3 + 8 l + k
      if constexpr (ENC == ENC_CP) {
        const int p = tid & (TILE - 1);
        const int l = tid / TILE;
        const int res_l = 16 << l;
        const float* __restrict__ lines = w + line_offset(l);  // [3][R][8]
        float f[RANK];
#pragma unroll
        for (int k = 0; k < RANK; ++k) f[k] = 1.0f;
#pragma unroll
        for (int axis = 0; axis < 3; ++axis) {
          const float xn = fminf(fmaxf((fbuf[axis * PS + p] + 1.0f) * 0.5f,
                                       0.0f), 1.0f);
          const float v = xn * (float)(res_l - 1);
          const int i0 = min((int)floorf(v), res_l - 1);
          const int i1 = min(i0 + 1, res_l - 1);
          const float fr = v - (float)i0;
          const float* __restrict__ l0 = lines + (axis * res_l + i0) * RANK;
          const float* __restrict__ l1 = lines + (axis * res_l + i1) * RANK;
#pragma unroll
          for (int k = 0; k < RANK; ++k)
            f[k] *= __ldg(l0 + k) * (1.0f - fr) + __ldg(l1 + k) * fr;
        }
#pragma unroll
        for (int k = 0; k < RANK; ++k)
          fbuf[(3 + l * RANK + k) * PS + p] = f[k];
      }
    } else {
      encode_tile<ENC>(fbuf, hbuf, ray_s, ts, ts_stride, ray0, n_rays, fq,
                       q0, n_pts, steps);
    }
    __syncthreads();
    act_rows<ACT_LEAKY>(fbuf, fact, FEAT_IN);
    __syncthreads();

    // ---- density MLP (skips at layers 0 and 3) ----
    mlp_fwd<FEAT_IN, L::D_HIDDEN, L::D_LAYERS, L::D_OUT_W, ACT_LEAKY>(
        fbuf, fact, w + L::D_IN, hbuf, nullptr);

    if constexpr (!L::VIEW) {
      // ---- tiny: sigma and rgb straight from the MLP's outputs ----
      if (tid < TILE && q0 + tid < n_pts) {
        float* e = res + 4 * (q0 + tid);
        float dummy;
        e[0] = softplus(hbuf[tid] - 1.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          e[1 + c] = rgb_act(hbuf[(1 + c) * PS + tid], sigmoid_kind, &dummy);
      }
    } else {
      // ---- sigma; refl init feature [p ‖ elev, azim ‖ feats] ----
      if (tid < TILE) {
        const int q = q0 + tid;
        if (q < n_pts) res[4 * q] = softplus(hbuf[tid] - 1.0f);
        const int qc = min(q, n_pts - 1);
        const float* s = ray_s + 8 * (qc / steps);
        if constexpr (L::MIP) {
          // mip's init feature holds no p: the point again, rounded alike
          const float t =
              ray_row(ts, ts_stride, ray0 + qc / steps, n_rays)[qc % steps];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            fbuf[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
        }
        fbuf[3 * PS + tid] = s[6];
        fbuf[4 * PS + tid] = s[7];
      }
      for (int i = tid; i < INTERMEDIATE * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        fbuf[(5 + row) * PS + p] = hbuf[(1 + row) * PS + p];
      }
      __syncthreads();
      act_rows<ACT_SIN30>(fbuf, fact, R_IN);
      __syncthreads();

      // ---- siren View MLP ----
      mlp_fwd<R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30>(
          fbuf, fact, w + L::R_IN_, hbuf, nullptr);

      if (tid < TILE && q0 + tid < n_pts) {
        float dummy;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          res[4 * (q0 + tid) + 1 + c] = rgb_act(hbuf[c * PS + tid],
                                                sigmoid_kind, &dummy);
      }
    }
    __syncthreads();
  }

  // ---- compositing: one thread per ray, front to back; with `wout`
  // each sample's weight to [N, T] ----
  const int r = tid;
  if (r < rays_per_block && ray0 + r < n_rays) {
    const float* s = ray_s + 8 * r;
    const float* dr = ray_row(dists, ts_stride, ray0 + r, n_rays);
    float* wr = wout == nullptr ? nullptr : wout + (long)(ray0 + r) * steps;
    const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
    float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int t = 0; t < steps; ++t) {
      const float* e = res + 4 * (r * steps + t);
      const float alpha = 1.0f - expf(-e[0] * (dr[t] * rd_norm));
      const float wt = alpha * trans;
      if (wr != nullptr) wr[t] = wt;
      acc += wt;
      c0 += wt * e[1];
      c1 += wt * e[2];
      c2 += wt * e[3];
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

template <int ENC>
int launch(const float* rays, const float* ts, const float* dists,
           const float* weights, const float* feats, const float* freqs,
           float* out, float* wout, int n_rays, int steps, int ts_stride,
           int sigmoid_kind, int sky_white, cudaStream_t stream) {
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const size_t smem = smem_bytes<ENC>(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_fwd_kernel<ENC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  render_fwd_kernel<ENC><<<blocks, THREADS, smem, stream>>>(
      rays, ts, dists, weights, feats, freqs, out, wout, n_rays, steps,
      ts_stride, rays_per_block, sigmoid_kind, sky_white);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects for `enc` (the
// index of render.py ENC_KINDS); -1 for an unknown enc.
long long render_fwd_weight_count(int enc) {
  switch (enc) {
    case ENC_CP: return Layout<ENC_CP>::TOTAL;
    case ENC_HASH: return Layout<ENC_HASH>::TOTAL;
    case ENC_POSENC: return Layout<ENC_POSENC>::TOTAL;
    case ENC_TINY: return Layout<ENC_TINY>::TOTAL;
    case ENC_CONE: return Layout<ENC_CONE>::TOTAL;
    case ENC_CYLINDER: return Layout<ENC_CYLINDER>::TOTAL;
    default: return -1;
  }
}

// The posenc bands the kernel expects in `freqs` for `enc` (0: none).
int render_fwd_freq_count(int enc) {
  return enc == ENC_POSENC ? Layout<ENC_POSENC>::N_FREQS
         : enc == ENC_TINY ? Layout<ENC_TINY>::N_FREQS : 0;
}

const char* render_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one render on `stream`; returns the cudaError_t of the launch.
// ts, dists: [steps] shared by every ray (ts_stride 0) or [n_rays, steps]
// per ray (ts_stride = steps); wout: the compositing weights [n_rays,
// steps], or null for none; feats: [n_rays·steps, 16] for enc hash, else
// unused; freqs: the posenc bands (`render_fwd_freq_count`) for enc posenc
// and tiny, else unused.
int render_fwd_launch(const float* rays, const float* ts, const float* dists,
                      const float* weights, const float* feats,
                      const float* freqs, float* out, float* wout,
                      int n_rays, int steps, int ts_stride, int sigmoid_kind,
                      int sky_white, int enc, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || (ts_stride != 0 && ts_stride != steps)
      || sigmoid_kind < 0 || sigmoid_kind > 7
      || enc < 0 || enc >= N_ENC
      || (enc == ENC_HASH && feats == nullptr)
      || (render_fwd_freq_count(enc) > 0 && freqs == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RENDER_FWD_CASE(E)                                                  \
  case E: return launch<E>(rays, ts, dists, weights, feats, freqs, out,    \
                           wout, n_rays, steps, ts_stride, sigmoid_kind,    \
                           sky_white, s);
  switch (enc) {
    RENDER_FWD_CASE(ENC_CP)
    RENDER_FWD_CASE(ENC_HASH)
    RENDER_FWD_CASE(ENC_POSENC)
    RENDER_FWD_CASE(ENC_TINY)
    RENDER_FWD_CASE(ENC_CONE)
    RENDER_FWD_CASE(ENC_CYLINDER)
    default: return cudaErrorInvalidValue;
  }
#undef RENDER_FWD_CASE
}

}  // extern "C"
