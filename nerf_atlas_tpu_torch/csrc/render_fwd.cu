// K1: fused forward render of the flagship PlainNeRF on Hopper, in two
// instantiations: enc_kind "cp" and "hash".
//
// Replaces nerf_atlas_tpu/ops/pallas/render.py:_render_kernel (enc_kind
// "cp" and "hash"). One launch renders rays [N, 6] -> [N, 4] (rgb ‖ acc):
//   p = r_o + t·r_d for the T shared sample positions
//   -> cp: CP encode (4 levels × rank 8, 2-tap linear interpolation per
//      axis, product over the three axes) -> init feature [p ‖ cp] (35);
//      hash: read the point's 16 hash-grid features (K5f's output, feats
//      [N·T, 16]) -> init feature [p ‖ feats] (19), with p rounded after
//      the product and after the sum, the bits K5f encoded
//   -> density SkipConnMLP FEAT_IN -> 256×5 -> 33, leaky-relu 0.01, skip
//      concat [h ; init] at layers 0 and 3 (split into two matmuls)
//   -> siren View MLP on [p ‖ elev, azim ‖ feats] (37) -> 128×5 -> 3,
//      activation sin(30·h)
//   -> rgb activation (FUSED_SIGMOID_KINDS), sigma = softplus(density-1)
//   -> per-ray compositing: alpha = 1 - exp(-sigma·Δt·‖r_d‖), running
//      transmittance product of max(1 - alpha, 1e-10); a white sky adds
//      the leftover transmittance excluding the 1e10 tail sample.
//
// What bounds it: compute. Each sample point costs about 0.92 MFLOP of
// matmul (459,520 multiply-adds for cp, 451,328 for hash), ≈37.7 TFLOP
// for an 800×800×64 frame, against ~1.9 MB of f32 weights that every
// block re-reads; the hash mode also reads 64 B of features per point.
//
// First design (simple and exact, not yet fast): float32 FMAs on the
// CUDA cores, no tensor cores. A block of 256 threads owns
// max(1, 64/T) rays and walks their points in tiles of 64. The tile's
// activations stay in dynamic shared memory for the whole MLP chain,
// stored feature-major [feature][64 points] so that a thread reads its 8
// points with two float4 broadcasts. Each thread keeps an 8-point ×
// (out/32)-output register tile; a warp reads one weight row (coalesced,
// through L1/L2 where the 1.9 MB of weights stay resident) per input
// feature. A layer writes its activated output back over its own input
// after a barrier, so one 256-row buffer serves every layer. Per-point
// sigma/rgb collect in shared memory and one thread per ray composites
// sequentially: no cross-block reduction and no scan workaround.
// ~93 KB of shared memory per block lets two blocks share an SM.
// bf16 tensor-core MMAs (mma.sync / wgmma) are the next step.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // sample points per tile
constexpr int THREADS = 256;      // 8 warps x 8 points = one tile
constexpr int PS = TILE + 4;      // row stride (floats) of activation rows
constexpr int RANK = 8;
constexpr int N_LEVELS = 4;       // resolutions 16 << l
constexpr int CP_DIM = N_LEVELS * RANK;     // 32
constexpr int HASH_FEATS = 16;              // 8 levels × 2 features
constexpr int HIDDEN = 256;
constexpr int D_OUT_W = 33;                 // density ‖ 32 features
constexpr int INTERMEDIATE = 32;
constexpr int R_IN = 3 + 2 + INTERMEDIATE;  // 37
constexpr int R_HIDDEN = 128;
constexpr int R_OUT_W = 3;
constexpr int F_ROWS = 40;                  // >= max(FEAT_IN, R_IN)
enum Enc { ENC_CP = 0, ENC_HASH = 1 };      // render.py ENC_KINDS
constexpr int MAX_STEPS = 2048;

static_assert(THREADS == TILE * N_LEVELS, "CP encode: one (point, level) "
              "per thread");
static_assert(THREADS == 32 * (TILE / 8), "dense: 8 points per warp");

enum Act { ACT_NONE = 0, ACT_LEAKY = 1, ACT_SIN30 = 2 };

// ---- packed weight layout (nerf_atlas_tpu_torch/ops/kernels/render.py:
// pack_weights): CP lines (cp only), then each Dense layer as W [in][out]
// row-major followed by its bias [out].
__host__ __device__ constexpr long dense_size(int in, int out) {
  return (long)in * out + out;
}
// level l holds [3][16 << l][RANK]; levels 0..l-1 hold 3·RANK·16·(2^l - 1)
__host__ __device__ constexpr long line_offset(int l) {
  return 3L * RANK * 16 * ((1L << l) - 1);
}
template <int ENC>
struct Layout {
  static constexpr int FEAT_IN = ENC == ENC_CP ? 3 + CP_DIM : 3 + HASH_FEATS;
  static constexpr long D_IN = ENC == ENC_CP ? line_offset(N_LEVELS) : 0;
  static constexpr long D_L0 = D_IN + dense_size(FEAT_IN, HIDDEN);
  static constexpr long D_L1 = D_L0 + dense_size(HIDDEN + FEAT_IN, HIDDEN);
  static constexpr long D_L2 = D_L1 + dense_size(HIDDEN, HIDDEN);
  static constexpr long D_L3 = D_L2 + dense_size(HIDDEN, HIDDEN);
  static constexpr long D_L4 = D_L3 + dense_size(HIDDEN + FEAT_IN, HIDDEN);
  static constexpr long D_OUT = D_L4 + dense_size(HIDDEN, HIDDEN);
  static constexpr long R_IN_ = D_OUT + dense_size(HIDDEN, D_OUT_W);
  static constexpr long R_L0 = R_IN_ + dense_size(R_IN, R_HIDDEN);
  static constexpr long R_L1 = R_L0 + dense_size(R_HIDDEN + R_IN, R_HIDDEN);
  static constexpr long R_L2 = R_L1 + dense_size(R_HIDDEN, R_HIDDEN);
  static constexpr long R_L3 = R_L2 + dense_size(R_HIDDEN, R_HIDDEN);
  static constexpr long R_L4 = R_L3 + dense_size(R_HIDDEN + R_IN, R_HIDDEN);
  static constexpr long R_OUT = R_L4 + dense_size(R_HIDDEN, R_HIDDEN);
  static constexpr long TOTAL = R_OUT + dense_size(R_HIDDEN, R_OUT_W);
  static_assert(FEAT_IN <= F_ROWS, "init feature rows");
};

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_LEAKY) return fmaxf(v, 0.01f * v);
  if (ACT == ACT_SIN30) return sinf(30.0f * v);
  return v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ops/math.py sigmoid kinds, indexed like FUSED_SIGMOID_KINDS
__device__ __forceinline__ float rgb_act(float v, int kind) {
  const float eps = 1e-2f;
  switch (kind) {
    case 0: return sigmoid(v) * (1.0f - 2.0f * eps) + 2.0f * eps;  // thin
    case 1: return sigmoid(v) * (1.0f + 2.0f * eps) - eps;         // fat
    case 2: return sigmoid(v);                                     // normal
    case 3: return sigmoid(v) + eps;                               // upshifted
    case 4: return tanhf(v);                                       // tanh
    case 5: return fmaxf(v, 0.0f);                                 // relu
    case 6: return fmaxf(v, 0.0f) + eps;                           // upshifted_relu
    default: return fmaxf(v, 0.01f * v);                           // leaky_relu
  }
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// acc[j][i] += sum_k x[k][p0 + i] * w[k][lane + 32 j]
template <int K, int NOUT, int NJ>
__device__ __forceinline__ void accumulate(const float* x,
                                           const float* __restrict__ w,
                                           int lane, int p0,
                                           float (&acc)[NJ][8]) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 x0 = *reinterpret_cast<const float4*>(x + k * PS + p0);
    const float4 x1 = *reinterpret_cast<const float4*>(x + k * PS + p0 + 4);
    const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = lane + 32 * j;
      const float wv = (o < NOUT) ? __ldg(w + (long)k * NOUT + o) : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(xs[i], wv, acc[j][i]);
    }
  }
}

// dst[o][p] = act(b[o] + sum_k a[k][p] w[k][o] + sum_k f[k][p] w[KA + k][o])
// for the tile's 64 points and o < NOUT. `w` is [KA + KF][NOUT] row-major
// with the bias after it. dst may alias a: every read finishes before the
// barrier that precedes the writes.
template <int KA, int KF, int NOUT, int ACT>
__device__ __forceinline__ void dense(const float* a, const float* f,
                                      const float* __restrict__ w,
                                      float* dst) {
  constexpr int NJ = (NOUT + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * 8;
  const float* __restrict__ b = w + (long)(KA + KF) * NOUT;
  float acc[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = lane + 32 * j;
    const float bj = (o < NOUT) ? __ldg(b + o) : 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = bj;
  }
  accumulate<KA, NOUT, NJ>(a, w, lane, p0, acc);
  if (KF > 0) accumulate<KF, NOUT, NJ>(f, w + (long)KA * NOUT, lane, p0, acc);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = lane + 32 * j;
    if (o < NOUT) {
      float4 v0, v1;
      v0.x = activate<ACT>(acc[j][0]); v0.y = activate<ACT>(acc[j][1]);
      v0.z = activate<ACT>(acc[j][2]); v0.w = activate<ACT>(acc[j][3]);
      v1.x = activate<ACT>(acc[j][4]); v1.y = activate<ACT>(acc[j][5]);
      v1.z = activate<ACT>(acc[j][6]); v1.w = activate<ACT>(acc[j][7]);
      *reinterpret_cast<float4*>(dst + o * PS + p0) = v0;
      *reinterpret_cast<float4*>(dst + o * PS + p0 + 4) = v1;
    }
  }
  __syncthreads();
}

size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)(HIDDEN + 2 * F_ROWS) * PS
                          + 4 * (size_t)rays_per_block * steps
                          + 8 * (size_t)rays_per_block);
}

template <int ENC>
__global__ void __launch_bounds__(THREADS, 2)
render_fwd_kernel(const float* __restrict__ rays,
                  const float* __restrict__ ts,
                  const float* __restrict__ dists,
                  const float* __restrict__ w,
                  const float* __restrict__ feats,
                  float* __restrict__ out,
                  int n_rays, int steps, int rays_per_block,
                  int sigmoid_kind, int sky_white) {
  using L = Layout<ENC>;
  constexpr int FEAT_IN = L::FEAT_IN;
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);   // [HIDDEN][PS]
  float* fbuf = hbuf + HIDDEN * PS;                 // [F_ROWS][PS] init feat
  float* fact = fbuf + F_ROWS * PS;                 // [F_ROWS][PS] act(init)
  float* res = fact + F_ROWS * PS;                  // [points][4] sigma, rgb
  float* ray_s = res + 4 * rays_per_block * steps;  // [rays][8] o, d, elaz

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rays_per_block;
  const int n_pts = rays_per_block * steps;

  // per-ray constants; rays past the ragged edge repeat the last ray and
  // are never written out
  for (int r = tid; r < rays_per_block; r += THREADS) {
    const float* ray = rays + 6L * min(ray0 + r, n_rays - 1);
    float* s = ray_s + 8 * r;
#pragma unroll
    for (int c = 0; c < 6; ++c) s[c] = ray[c];
    // ops/math.py:dir_to_elev_azim
    const float norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
    const float inv = 1.0f / fmaxf(norm, 1e-12f);
    const float lim = 1.0f - 1e-6f;
    const float x = fminf(fmaxf(s[3] * inv, -lim), lim);
    const float y = fminf(fmaxf(s[4] * inv, -lim), lim);
    const float z = fminf(fmaxf(s[5] * inv, -lim), lim);
    s[6] = acosf(z);
    s[7] = atan2f(y, x);
  }
  __syncthreads();

  for (int q0 = 0; q0 < n_pts; q0 += TILE) {
    // ---- sample points (padding rows repeat the block's last point) ----
    if (tid < TILE) {
      const int q = min(q0 + tid, n_pts - 1);
      const float* s = ray_s + 8 * (q / steps);
      const float t = ts[q % steps];
      if constexpr (ENC == ENC_CP) {
#pragma unroll
        for (int c = 0; c < 3; ++c) fbuf[c * PS + tid] = s[c] + t * s[3 + c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          fbuf[c * PS + tid] = __fadd_rn(s[c], __fmul_rn(t, s[3 + c]));
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

    // ---- CP encode: one (point, level) per thread -> rows 3 + 8 l + k ----
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
      for (int k = 0; k < RANK; ++k) fbuf[(3 + l * RANK + k) * PS + p] = f[k];
    }
    __syncthreads();
    for (int i = tid; i < FEAT_IN * TILE; i += THREADS) {
      const int idx = (i / TILE) * PS + (i % TILE);
      fact[idx] = activate<ACT_LEAKY>(fbuf[idx]);
    }
    __syncthreads();

    // ---- density MLP (skips at layers 0 and 3) ----
    dense<FEAT_IN, 0, HIDDEN, ACT_LEAKY>(fbuf, nullptr, w + L::D_IN, hbuf);
    dense<HIDDEN, FEAT_IN, HIDDEN, ACT_LEAKY>(hbuf, fact, w + L::D_L0, hbuf);
    dense<HIDDEN, 0, HIDDEN, ACT_LEAKY>(hbuf, nullptr, w + L::D_L1, hbuf);
    dense<HIDDEN, 0, HIDDEN, ACT_LEAKY>(hbuf, nullptr, w + L::D_L2, hbuf);
    dense<HIDDEN, FEAT_IN, HIDDEN, ACT_LEAKY>(hbuf, fact, w + L::D_L3, hbuf);
    dense<HIDDEN, 0, HIDDEN, ACT_LEAKY>(hbuf, nullptr, w + L::D_L4, hbuf);
    dense<HIDDEN, 0, D_OUT_W, ACT_NONE>(hbuf, nullptr, w + L::D_OUT, hbuf);

    // ---- sigma; refl init feature [p ‖ elev, azim ‖ feats] ----
    if (tid < TILE) {
      const int q = q0 + tid;
      if (q < n_pts) res[4 * q] = softplus(hbuf[tid] - 1.0f);
      const float* s = ray_s + 8 * (min(q, n_pts - 1) / steps);
      fbuf[3 * PS + tid] = s[6];
      fbuf[4 * PS + tid] = s[7];
    }
    for (int i = tid; i < INTERMEDIATE * TILE; i += THREADS) {
      const int row = i / TILE, p = i % TILE;
      fbuf[(5 + row) * PS + p] = hbuf[(1 + row) * PS + p];
    }
    __syncthreads();
    for (int i = tid; i < R_IN * TILE; i += THREADS) {
      const int idx = (i / TILE) * PS + (i % TILE);
      fact[idx] = activate<ACT_SIN30>(fbuf[idx]);
    }
    __syncthreads();

    // ---- siren View MLP ----
    dense<R_IN, 0, R_HIDDEN, ACT_SIN30>(fbuf, nullptr, w + L::R_IN_, hbuf);
    dense<R_HIDDEN, R_IN, R_HIDDEN, ACT_SIN30>(hbuf, fact, w + L::R_L0, hbuf);
    dense<R_HIDDEN, 0, R_HIDDEN, ACT_SIN30>(hbuf, nullptr, w + L::R_L1, hbuf);
    dense<R_HIDDEN, 0, R_HIDDEN, ACT_SIN30>(hbuf, nullptr, w + L::R_L2, hbuf);
    dense<R_HIDDEN, R_IN, R_HIDDEN, ACT_SIN30>(hbuf, fact, w + L::R_L3, hbuf);
    dense<R_HIDDEN, 0, R_HIDDEN, ACT_SIN30>(hbuf, nullptr, w + L::R_L4, hbuf);
    dense<R_HIDDEN, 0, R_OUT_W, ACT_NONE>(hbuf, nullptr, w + L::R_OUT, hbuf);

    if (tid < TILE && q0 + tid < n_pts) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        res[4 * (q0 + tid) + 1 + c] = rgb_act(hbuf[c * PS + tid], sigmoid_kind);
    }
    __syncthreads();
  }

  // ---- compositing: one thread per ray, front to back ----
  const int r = tid;
  if (r < rays_per_block && ray0 + r < n_rays) {
    const float* s = ray_s + 8 * r;
    const float rd_norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
    float trans = 1.0f, acc = 0.0f, w_last = 0.0f;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int t = 0; t < steps; ++t) {
      const float* e = res + 4 * (r * steps + t);
      const float alpha = 1.0f - expf(-e[0] * (dists[t] * rd_norm));
      const float wt = alpha * trans;
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
           const float* weights, const float* feats, float* out, int n_rays,
           int steps, int sigmoid_kind, int sky_white, cudaStream_t stream) {
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const size_t smem = smem_bytes(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_fwd_kernel<ENC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
  render_fwd_kernel<ENC><<<blocks, THREADS, smem, stream>>>(
      rays, ts, dists, weights, feats, out, n_rays, steps, rays_per_block,
      sigmoid_kind, sky_white);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects for `enc`
// (0 cp, 1 hash).
long long render_fwd_weight_count(int enc) {
  return enc == ENC_CP ? Layout<ENC_CP>::TOTAL : Layout<ENC_HASH>::TOTAL;
}

const char* render_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one render on `stream`; returns the cudaError_t of the launch.
// enc 0 (cp): feats unused; enc 1 (hash): feats [n_rays·steps, 16].
int render_fwd_launch(const float* rays, const float* ts, const float* dists,
                      const float* weights, const float* feats, float* out,
                      int n_rays, int steps, int sigmoid_kind, int sky_white,
                      int enc, void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || (enc != ENC_CP && enc != ENC_HASH)
      || (enc == ENC_HASH && feats == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return enc == ENC_CP
      ? launch<ENC_CP>(rays, ts, dists, weights, feats, out, n_rays, steps,
                       sigmoid_kind, sky_white, s)
      : launch<ENC_HASH>(rays, ts, dists, weights, feats, out, n_rays, steps,
                         sigmoid_kind, sky_white, s);
}

}  // extern "C"
