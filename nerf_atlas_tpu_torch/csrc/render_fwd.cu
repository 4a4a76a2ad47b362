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
// (118,400), ≈37.7 TFLOP for an 800×800×64 cp frame; on the tensor cores
// in split TF32 each multiply-add is three TF32 products, against the
// TF32 peak (~3× the float32 operations at 495 TFLOP/s). The weights
// (0.5-2 MB of float32, twice that pre-split) stream through shared
// memory once per 128 points; the hash mode also reads 64 B of features
// per point.
//
// Design: every MLP product on the tensor cores by TF32 `wgmma`
// (wgmma_tf32.cuh: split TF32, a fresh accumulator per 16-deep slice). A
// block of 256 threads (two warpgroups) owns max(1, 128/T) rays and walks
// their points 128 at a time: two 64-point tiles, one per warpgroup (the
// tile is one wgmma's M), each with its activations in dynamic shared
// memory for the whole MLP chain, feature-major [feature][64 points] as
// the encoders (render_plain.cuh, render_common.cuh) write them. A
// warpgroup loads its A fragments from its tile and splits them in
// registers (the init feature's activation at a skip layer applied as it
// loads); both warpgroups read each staged unit of the pre-split weights
// (the wrapper's wgmma pack), so every unit serves 128 points; a layer
// writes its activated output back over its own input after a barrier,
// so one hidden buffer per tile serves every layer. Per-point sigma/rgb
// collect in shared memory, and after each 128 points one thread per ray
// composites that pass's samples front to back, its running
// transmittance, sums and last weight held in registers from pass to
// pass: the same operations in the same order as one sequential pass, no
// cross-block reduction. One block per SM: two 256-row hidden tiles, two
// init tiles and a ring of 4-8 weight units fill its 227 KB of shared
// memory. What bounds it now is not known without a profiler: at ~24% of
// the TF32 peak, a running accumulator without the per-k-step adds (which
// misses the gate) is only a few percent faster, so the products' own
// waits are not it; the per-unit block barrier and the weight stream (125
// GB of L2 reads per 65536×64 cp call) are the candidates.
// The TPU kernel's MXU forms (the posenc / IPE selector matmuls, the
// exact-f32 dot, the bf16 weights, the sin approximations) have no
// counterpart here: the phases are rounded multiplies and sinf/cosf are
// accurate.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include "render_plain.cuh"
#include "wgmma_tf32.cuh"

using namespace plain;

namespace {

constexpr int MAX_STEPS = 2048;
constexpr int PTS = 2 * TILE;      // points per pass: a tile per warpgroup

// The wgmma pack of mode ENC (render.py `wgmma_pack`): the density MLP's
// (tiny: the one MLP's), then the View MLP's.
template <int ENC>
struct Pack {
  using L = Layout<ENC>;
  static constexpr long R = wg::mlp_floats(L::FEAT_IN, L::D_HIDDEN,
                                           L::D_LAYERS, L::D_OUT_W);
  static constexpr long TOTAL =
      R + (L::VIEW ? wg::mlp_floats(R_IN, R_HIDDEN, R_LAYERS, R_OUT_W) : 0);
};

// Shared memory: both tiles' hidden and init rows, the ring of weight
// units, the pass's results, the rays and the bands; the ring takes what
// the rest leaves of the block's 227 KB, up to 8 units (mip 4, posenc 6,
// the others 8).
constexpr long SMEM_MAX = 232448;
template <int ENC>
__host__ __device__ constexpr long fixed_floats(int rays_per_block) {
  using L = Layout<ENC>;
  return 2L * (L::H_ROWS + L::F_ROWS) * PS + 4 * PTS + 8L * rays_per_block
         + MAX_FREQS;
}
template <int ENC>
__host__ __device__ constexpr int ring_units() {
  const long room = SMEM_MAX / 4 - fixed_floats<ENC>(PTS / 2);
  const long units = room / wg::UNIT_FLOATS;
  return units > 8 ? 8 : (int)units;
}

template <int ENC>
size_t smem_bytes(int rays_per_block) {
  return sizeof(float) * (fixed_floats<ENC>(rays_per_block)
                          + (long)ring_units<ENC>() * wg::UNIT_FLOATS);
}

template <int ENC>
__global__ void __launch_bounds__(THREADS, 1)
render_fwd_kernel(const float* __restrict__ rays,
                  const float* __restrict__ ts,
                  const float* __restrict__ dists,
                  const float* __restrict__ w,
                  const float* __restrict__ wp,
                  const float* __restrict__ feats,
                  const float* __restrict__ freqs,
                  float* __restrict__ out,
                  float* __restrict__ wout,
                  int n_rays, int steps, int ts_stride, int rays_per_block,
                  int sigmoid_kind, int sky_white) {
  using L = Layout<ENC>;
  constexpr int FEAT_IN = L::FEAT_IN;
  constexpr int S = ring_units<ENC>();
  static_assert(S >= 2, "shared memory for a ring of weight units");
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);   // [2][H_ROWS][PS]
  float* fbuf = hbuf + 2 * L::H_ROWS * PS;          // [2][F_ROWS][PS]
  float* stage = fbuf + 2 * L::F_ROWS * PS;         // the weight units
  float* res = stage + S * wg::UNIT_FLOATS;         // [PTS][4] sigma, rgb
  float* ray_s = res + 4 * PTS;                     // [rays][8] o, d, elaz
  float* fq = ray_s + 8 * rays_per_block;           // [MAX_FREQS] bands

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;
  // this warpgroup's tile: its hidden rows, its init feature
  const int wgi = tid / wg::WG_THREADS, wtid = tid % wg::WG_THREADS;
  float* H = hbuf + wgi * L::H_ROWS * PS;
  float* Fw = fbuf + wgi * L::F_ROWS * PS;

  // per-ray constants; rays past the ragged edge repeat the last ray and
  // are never written out
  for (int r = tid; r < rays_per_block; r += THREADS)
    ray_setup(rays + 6L * min(ray0 + r, n_rays - 1), ray_s + 8 * r);
  if (tid < L::N_FREQS) fq[tid] = freqs[tid];
  __syncthreads();

  // the compositing of ray `tid`, carried from pass to pass
  float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;

  for (int q0 = 0; q0 < n_pts; q0 += PTS) {
    // ---- the init feature of both tiles (the whole block, tile by tile;
    // padding rows repeat the block's last point) ----
    for (int tt = 0; tt < 2; ++tt) {
      const int qt = q0 + TILE * tt;
      float* fb = fbuf + tt * L::F_ROWS * PS;
      if constexpr (ENC == ENC_CP || ENC == ENC_HASH) {
        // ---- sample points ----
        if (tid < TILE) {
          const int q = min(qt + tid, n_pts - 1);
          const float* s = ray_s + 8 * (q / steps);
          const float t =
              ray_row(ts, ts_stride, ray0 + q / steps, n_rays)[q % steps];
          if constexpr (ENC == ENC_CP) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
              fb[c * PS + tid] = s[c] + t * s[3 + c];
          } else {
#pragma unroll
            for (int c = 0; c < 3; ++c)
              fb[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
          }
        }
        if constexpr (ENC == ENC_HASH) {
          // ---- hash features -> rows 3..18 ----
          for (int i = tid; i < TILE * HASH_FEATS; i += THREADS) {
            const int p = i / HASH_FEATS, j = i % HASH_FEATS;
            const int q = min(qt + p, n_pts - 1);
            const long g = (long)min(ray0 + q / steps, n_rays - 1) * steps
                           + q % steps;
            fb[(3 + j) * PS + p] = __ldg(feats + g * HASH_FEATS + j);
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
            const float xn = fminf(fmaxf((fb[axis * PS + p] + 1.0f) * 0.5f,
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
            fb[(3 + l * RANK + k) * PS + p] = f[k];
        }
      } else {
        encode_tile<ENC>(fb, hbuf + tt * L::H_ROWS * PS, ray_s, ts,
                         ts_stride, ray0, n_rays, fq, qt, n_pts, steps);
      }
      __syncthreads();
    }

    // ---- density MLP (skips at layers 0 and 3), a tile per warpgroup --
    wg::mlp_fwd<S, FEAT_IN, L::D_HIDDEN, L::D_LAYERS, L::D_OUT_W, ACT_LEAKY>(
        Fw, w + L::D_IN, wp, H, stage);

    const int qw = q0 + TILE * wgi;                 // the tile's first point
    float* rw = res + 4 * TILE * wgi;               // its points' results
    if constexpr (!L::VIEW) {
      // ---- tiny: sigma and rgb straight from the MLP's outputs ----
      if (wtid < TILE && qw + wtid < n_pts) {
        float* e = rw + 4 * wtid;
        float dummy;
        e[0] = softplus(H[wtid] - 1.0f);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          e[1 + c] = rgb_act(H[(1 + c) * PS + wtid], sigmoid_kind, &dummy);
      }
    } else {
      // ---- sigma; refl init feature [p ‖ elev, azim ‖ feats] ----
      if (wtid < TILE) {
        const int q = qw + wtid;
        if (q < n_pts) rw[4 * wtid] = softplus(H[wtid] - 1.0f);
        const int qc = min(q, n_pts - 1);
        const float* s = ray_s + 8 * (qc / steps);
        if constexpr (L::MIP) {
          // mip's init feature holds no p: the point again, rounded alike
          const float t =
              ray_row(ts, ts_stride, ray0 + qc / steps, n_rays)[qc % steps];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            Fw[c * PS + wtid] = sample_point(s[c], t, s[3 + c]);
        }
        Fw[3 * PS + wtid] = s[6];
        Fw[4 * PS + wtid] = s[7];
      }
      for (int i = wtid; i < INTERMEDIATE * TILE; i += wg::WG_THREADS) {
        const int row = i / TILE, p = i % TILE;
        Fw[(5 + row) * PS + p] = H[(1 + row) * PS + p];
      }

      // ---- siren View MLP ----
      wg::mlp_fwd<S, R_IN, R_HIDDEN, R_LAYERS, R_OUT_W, ACT_SIN30>(
          Fw, w + L::R_IN_, wp + Pack<ENC>::R, H, stage);

      if (wtid < TILE && qw + wtid < n_pts) {
        float dummy;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rw[4 * wtid + 1 + c] = rgb_act(H[c * PS + wtid], sigmoid_kind,
                                         &dummy);
      }
    }
    __syncthreads();

    // ---- compositing of this pass's samples: one thread per ray, front to
    // back; with `wout` each sample's weight to [N, T] ----
    const int r = tid;
    if (r < rays_per_block && ray0 + r < n_rays) {
      const float* s = ray_s + 8 * r;
      const float* dr = ray_row(dists, ts_stride, ray0 + r, n_rays);
      float* wr = wout == nullptr ? nullptr : wout + (long)(ray0 + r) * steps;
      const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
      const int t_end = min(steps, q0 + PTS - r * steps);
      for (int t = max(0, q0 - r * steps); t < t_end; ++t) {
        const float* e = res + 4 * (r * steps + t - q0);
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

template <int ENC>
int launch(const float* rays, const float* ts, const float* dists,
           const float* weights, const float* wp, const float* feats,
           const float* freqs, float* out, float* wout, int n_rays, int steps,
           int ts_stride, int sigmoid_kind, int sky_white,
           cudaStream_t stream) {
  const int rays_per_block = steps >= PTS ? 1 : PTS / steps;
  const size_t smem = smem_bytes<ENC>(rays_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      render_fwd_kernel<ENC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  render_fwd_kernel<ENC><<<blocks, THREADS, smem, stream>>>(
      rays, ts, dists, weights, wp, feats, freqs, out, wout, n_rays, steps,
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

// Floats of the wgmma pack (render.py `wgmma_pack`) the kernel expects
// for `enc`; -1 for an unknown enc.
long long render_fwd_pack_floats(int enc) {
  switch (enc) {
    case ENC_CP: return Pack<ENC_CP>::TOTAL;
    case ENC_HASH: return Pack<ENC_HASH>::TOTAL;
    case ENC_POSENC: return Pack<ENC_POSENC>::TOTAL;
    case ENC_TINY: return Pack<ENC_TINY>::TOTAL;
    case ENC_CONE: return Pack<ENC_CONE>::TOTAL;
    case ENC_CYLINDER: return Pack<ENC_CYLINDER>::TOTAL;
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
// and tiny, else unused; wp: the weights' wgmma pack
// (`render_fwd_pack_floats` floats, 16-byte aligned).
int render_fwd_launch(const float* rays, const float* ts, const float* dists,
                      const float* weights, const float* wp,
                      const float* feats, const float* freqs, float* out,
                      float* wout, int n_rays, int steps, int ts_stride,
                      int sigmoid_kind, int sky_white, int enc,
                      void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || (ts_stride != 0 && ts_stride != steps)
      || sigmoid_kind < 0 || sigmoid_kind > 7
      || enc < 0 || enc >= N_ENC
      || (enc == ENC_HASH && feats == nullptr)
      || (render_fwd_freq_count(enc) > 0 && freqs == nullptr)
      || wp == nullptr || reinterpret_cast<uintptr_t>(wp) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RENDER_FWD_CASE(E)                                                  \
  case E: return launch<E>(rays, ts, dists, weights, wp, feats, freqs,     \
                           out, wout, n_rays, steps, ts_stride,             \
                           sigmoid_kind, sky_white, s);
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
