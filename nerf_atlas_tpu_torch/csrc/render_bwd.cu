// K2/K3: backward of the fused PlainNeRF render on Hopper, in two
// instantiations: enc_kind "cp" and "hash".
//
// Replaces nerf_atlas_tpu/ops/pallas/render.py:_render_bwd_kernel
// (enc_kind "cp" and "hash"), both of its modes, in one source:
//   mode G (K2, the autograd backward of K1): takes the output cotangent
//     g [N, 4] (rgb ‖ acc) and returns d(Σ g·out)/d(weights);
//   mode L (K3, the one-kernel train step): takes target [N, 3] and
//     loss_scale = 1/(3N), computes loss = loss_scale·Σ(out_rgb − target)²
//     from its own forward and back-propagates the cotangent
//     2·loss_scale·(out_rgb − target) (0 on acc).
// Both return the float32 gradient of the packed weight vector (the
// layout of ops/kernels/render.py:pack_weights); rays and ts get none.
// The hash mode reads each sample point's 16 hash-grid features (feats
// [N·T, 16], K5f's output) where cp encodes, has no line gradients, and
// writes dfeat [N·T, 16], the density MLP's input cotangent on those
// feature columns (the raw-point columns dropped), for K5b.
//
// Per block of rays (max(1, 64/T) rays, as in K1), in two passes:
//   pass 1 re-runs K1's forward tile by tile (64 sample points per tile:
//     the same 2-tap CP gather, split skip matmuls, accurate sinf, elev/
//     azim in-kernel) and stashes every MLP pre-activation and both init
//     features in a per-block scratch in global memory;
//   then one thread per ray composites front to back (α, transmittance,
//     outputs, the cotangent, the loss) and walks back to front with the
//     suffix sum S_t = Σ_{s>t} A_s w_s: dα = A·T − S/max(1−α, 1e-10),
//     dσ = dα·Δt‖r_d‖·(1−α), d density = dσ·sigmoid(density − 1);
//   pass 2 walks the tiles again and chains the hand VJPs: rgb activation
//     → View MLP (sin(30h), derivative 30·cos(30h) with accurate cosf)
//     → density MLP (leaky-relu 0.01) → CP line gradients (cp) or the
//     feature cotangent dfeat (hash).
//
// What bounds it: compute, about three times K1's (the forward, then per
// layer the input-gradient and the weight-gradient products, each
// 0.92 MFLOP per sample point), plus the stash (608 KB per 64-point tile,
// written once and read once) and the per-block weight-gradient partials.
//
// Design (simple and exact, not yet fast): float32 FMAs on the CUDA
// cores, one 256-thread block per SM (about 197 KB of shared memory:
// two 256-row activation/gradient tiles, the init features, their
// activations and gradient, and the CP line gradients). The grid is at
// most one block per SM; each block loops over ray blocks. The weight
// gradient is deterministic: every block accumulates into its own
// partial row of WEIGHT_COUNT + 1 floats (each entry owned by one
// thread, tiles in a fixed order; the CP line gradients first in shared
// memory, one thread per (level, axis, rank) walking the points in
// order), and a second kernel sums the rows in block order. No float
// atomics anywhere.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // sample points per tile
constexpr int THREADS = 256;      // 8 warps x 8 points = one tile
constexpr int PS = TILE + 4;      // row stride (floats) of shared tiles
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
constexpr int MAX_STEPS = 1024;             // shared memory for res
enum Enc { ENC_CP = 0, ENC_HASH = 1 };      // render.py ENC_KINDS

static_assert(THREADS == TILE * N_LEVELS, "CP: one (point, level) per "
              "thread");
static_assert(THREADS == 32 * (TILE / 8), "dense: 8 points per warp");
static_assert(3 * N_LEVELS * RANK <= THREADS, "CP bwd: one thread per "
              "(level, axis, rank)");

enum Act { ACT_NONE = 0, ACT_LEAKY = 1, ACT_SIN30 = 2 };
enum Mode { MODE_Z = 0, MODE_FADD = 1, MODE_ADD = 2 };

// ---- packed weight layout (ops/kernels/render.py:pack_weights), the same
// as csrc/render_fwd.cu: CP lines (cp only), then each Dense layer as W
// [in][out] row-major followed by its bias [out]. The transposed copy `wt`
// the wrapper passes has each W block as [out][in] at the same offset.
__host__ __device__ constexpr long dense_size(int in, int out) {
  return (long)in * out + out;
}
__host__ __device__ constexpr long line_offset(int l) {
  return 3L * RANK * 16 * ((1L << l) - 1);
}
// ---- stash rows per tile (each row holds TILE floats)
constexpr int ST_D = 0;                           // density z_in, z_0..z_4
constexpr int ST_R = ST_D + 6 * HIDDEN;           // View z_in, z_0..z_4
constexpr int ST_FD = ST_R + 6 * R_HIDDEN;        // density init feature

template <int ENC>
struct Layout {
  static constexpr int FEAT_IN = ENC == ENC_CP ? 3 + CP_DIM : 3 + HASH_FEATS;
  static constexpr int LINES =                    // 5760 (cp), 0 (hash)
      ENC == ENC_CP ? (int)line_offset(N_LEVELS) : 0;
  static constexpr long D_IN = LINES;
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
  static constexpr long WP = TOTAL + 1;           // partial row: grads ‖ loss
  static constexpr int ST_FR = ST_FD + FEAT_IN;   // View init feature
  static constexpr int ST_ROWS = ST_FR + R_IN;    // 2376 (cp), 2360 (hash)
  static constexpr long ST_TILE = (long)ST_ROWS * TILE;  // floats per tile
  static_assert(FEAT_IN <= F_ROWS, "init feature rows");
};

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_LEAKY) return fmaxf(v, 0.01f * v);
  if (ACT == ACT_SIN30) return sinf(30.0f * v);
  return v;
}

// d act / d v, with autograd's convention at the leaky kink (0.01 at 0)
template <int ACT>
__device__ __forceinline__ float act_grad(float v) {
  if (ACT == ACT_LEAKY) return v > 0.0f ? 1.0f : 0.01f;
  if (ACT == ACT_SIN30) return 30.0f * cosf(30.0f * v);
  return 1.0f;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// ops/math.py sigmoid kinds, indexed like FUSED_SIGMOID_KINDS: the value
// and its derivative
__device__ __forceinline__ float rgb_act(float v, int kind, float* grad) {
  const float eps = 1e-2f;
  if (kind <= 3) {
    const float s = sigmoid(v);
    const float ds = s * (1.0f - s);
    switch (kind) {
      case 0: *grad = ds * (1.0f - 2.0f * eps);                   // thin
              return s * (1.0f - 2.0f * eps) + 2.0f * eps;
      case 1: *grad = ds * (1.0f + 2.0f * eps);                   // fat
              return s * (1.0f + 2.0f * eps) - eps;
      case 2: *grad = ds; return s;                               // normal
      default: *grad = ds; return s + eps;                        // upshifted
    }
  }
  switch (kind) {
    case 4: { const float t = tanhf(v); *grad = 1.0f - t * t; return t; }
    case 5: *grad = v > 0.0f ? 1.0f : 0.0f; return fmaxf(v, 0.0f);
    case 6: *grad = v > 0.0f ? 1.0f : 0.0f; return fmaxf(v, 0.0f) + eps;
    default: *grad = v > 0.0f ? 1.0f : 0.01f; return fmaxf(v, 0.01f * v);
  }
}

// The sample point and its CP encoding are rounded exactly as the plain
// torch version rounds them (one IEEE op per torch op, no FMA
// contraction): r_o + t·r_d, the clamp((p + 1)·0.5) box, the tap and its
// fraction, (l0·(1 − fr)) + (l1·fr), and the product over the axes. The
// init features then agree bit for bit, so no leaky-relu input there sits
// on the other side of its kink in one of the two implementations.
__device__ __forceinline__ float sample_point(float o, float t, float d) {
  return __fadd_rn(o, __fmul_rn(t, d));
}

// tap i0 (and i1 = min(i0 + 1, R - 1)) and fraction of coordinate x on a
// line of res_l entries
__device__ __forceinline__ float cp_tap(float x, int res_l, int* i0,
                                        int* i1) {
  const float xn = fminf(fmaxf(__fmul_rn(__fadd_rn(x, 1.0f), 0.5f), 0.0f),
                         1.0f);
  const float v = __fmul_rn(xn, (float)(res_l - 1));
  *i0 = min((int)floorf(v), res_l - 1);
  *i1 = min(*i0 + 1, res_l - 1);
  return __fsub_rn(v, (float)*i0);
}

__device__ __forceinline__ float cp_lerp(float l0, float l1, float fr) {
  return __fadd_rn(__fmul_rn(l0, __fsub_rn(1.0f, fr)), __fmul_rn(l1, fr));
}

// acc[j][i] += sum_k x[k][p0 + i] * w[k * LDW + lane + 32 j]
template <int K, int NOUT, int NJ, int LDW>
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
      const float wv = (o < NOUT) ? __ldg(w + (long)k * LDW + o) : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(xs[i], wv, acc[j][i]);
    }
  }
}

// Forward layer (K1's `dense`): dst[o][p] = act(z), z = b[o] +
// sum_k a[k][p] w[k][o] + sum_k f[k][p] w[KA + k][o]; with `zst` the
// pre-activation z also goes to the stash rows zst[o][p]. dst may alias a.
template <int KA, int KF, int NOUT, int ACT>
__device__ __forceinline__ void dense_fwd(const float* a, const float* f,
                                          const float* __restrict__ w,
                                          float* dst, float* zst) {
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
  accumulate<KA, NOUT, NJ, NOUT>(a, w, lane, p0, acc);
  if (KF > 0) accumulate<KF, NOUT, NJ, NOUT>(f, w + (long)KA * NOUT, lane,
                                             p0, acc);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = lane + 32 * j;
    if (o < NOUT) {
      if (zst != nullptr) {
        *reinterpret_cast<float4*>(zst + o * TILE + p0) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        *reinterpret_cast<float4*>(zst + o * TILE + p0 + 4) =
            make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      }
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

// Input gradient of a layer: r[k][p] = sum_{n < NIN} G[n][p] wt[n][k] for
// k < NOUT (wt row-major with row stride LDW, i.e. the layer's W
// transposed). MODE_Z: dst[k][p] = r · act'(z[k][p]), z from the stash
// rows zst (dst may alias G). MODE_FADD: dst[k][p] += r · act'(f[k][p]),
// f = the shared init feature rows. MODE_ADD: dst[k][p] += r.
template <int NIN, int NOUT, int LDW, int ACT, int MODE>
__device__ __forceinline__ void dense_bwd(const float* G,
                                          const float* __restrict__ wt,
                                          float* dst,
                                          const float* __restrict__ zst,
                                          const float* f) {
  constexpr int NJ = (NOUT + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int p0 = (threadIdx.x >> 5) * 8;
  float acc[NJ][8];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
  }
  accumulate<NIN, NOUT, NJ, LDW>(G, wt, lane, p0, acc);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int o = lane + 32 * j;
    if (o < NOUT) {
      float* d = dst + o * PS + p0;
      if (MODE == MODE_Z) {
        const float4 z0 = *reinterpret_cast<const float4*>(zst + o * TILE + p0);
        const float4 z1 =
            *reinterpret_cast<const float4*>(zst + o * TILE + p0 + 4);
        const float zs[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = acc[j][i] * act_grad<ACT>(zs[i]);
      } else if (MODE == MODE_FADD) {
        const float* fr = f + o * PS + p0;
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] += acc[j][i] * act_grad<ACT>(fr[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] += acc[j][i];
      }
    }
  }
  __syncthreads();
}

// Weight gradient, wide layers (N = 256 or 128): this thread owns column
// n of rows k = ks, ks + NS, ... < K and holds the layer's output
// gradient g[p] = G[n][p] in registers; pw[k * N + n] += sum_p X[k][p] g[p]
// (pw = the block's partial at the layer's first row of this segment).
template <int N>
__device__ __forceinline__ void dw_cols(const float* X, int K,
                                        const float (&g)[TILE],
                                        float* __restrict__ pw) {
  constexpr int NS = THREADS / N;
  const int n = threadIdx.x % N;
  const int ks = threadIdx.x / N;
  for (int k = ks; k < K; k += NS) {
    const float* x = X + k * PS;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int p = 0; p < TILE; p += 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + p);
      a0 = fmaf(v.x, g[p], a0);
      a1 = fmaf(v.y, g[p + 1], a1);
      a2 = fmaf(v.z, g[p + 2], a2);
      a3 = fmaf(v.w, g[p + 3], a3);
    }
    pw[(long)k * N + n] += (a0 + a1) + (a2 + a3);
  }
}

template <int N>
__device__ __forceinline__ void load_col(const float* G, float (&g)[TILE]) {
  const float* row = G + (threadIdx.x % N) * PS;
#pragma unroll
  for (int p = 0; p < TILE; p += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + p);
    g[p] = v.x; g[p + 1] = v.y; g[p + 2] = v.z; g[p + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void db_col(const float (&g)[TILE],
                                       float* __restrict__ pb) {
  if (threadIdx.x / N == 0) {
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < TILE; ++p) s += g[p];
    pb[threadIdx.x % N] += s;
  }
}

// Weight + bias gradient of a narrow output layer [K][N] (N = 33 or 3):
// entries e = k * N + n spread over the threads, both operands from
// shared memory.
template <int K, int N>
__device__ __forceinline__ void dw_small(const float* X, const float* G,
                                         float* __restrict__ pw) {
  for (int e = threadIdx.x; e < K * N; e += THREADS) {
    const float* x = X + (e / N) * PS;
    const float* g = G + (e % N) * PS;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int p = 0; p < TILE; p += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(x + p);
      const float4 gv = *reinterpret_cast<const float4*>(g + p);
      a0 = fmaf(xv.x, gv.x, a0);
      a1 = fmaf(xv.y, gv.y, a1);
      a2 = fmaf(xv.z, gv.z, a2);
      a3 = fmaf(xv.w, gv.w, a3);
    }
    pw[e] += (a0 + a1) + (a2 + a3);
  }
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float s = 0.0f;
    for (int p = 0; p < TILE; ++p) s += G[n * PS + p];
    pw[(long)K * N + n] += s;
  }
}

// X[r][p] = act(z[r][p]) for rows r < rows, z = stash rows
template <int ACT>
__device__ __forceinline__ void load_act(const float* __restrict__ z,
                                         int rows, float* X) {
  for (int i = threadIdx.x; i < rows * (TILE / 4); i += THREADS) {
    const int r = i / (TILE / 4), c = (i % (TILE / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(z + r * TILE + c);
    v.x = activate<ACT>(v.x); v.y = activate<ACT>(v.y);
    v.z = activate<ACT>(v.z); v.w = activate<ACT>(v.w);
    *reinterpret_cast<float4*>(X + r * PS + c) = v;
  }
}

// Backward of hidden layer i of a SkipConnMLP (H wide, init feature FI
// rows in F / act(F) in FA), with its output gradient in G: weight and
// bias gradients into the partial, the skip rows' input gradient into
// DF, and G <- the gradient of the previous layer's pre-activation z_prev.
template <int H, int FI, bool SKIP, int ACT>
__device__ __forceinline__ void hidden_bwd(float* X, float* G,
                                           const float* F, const float* FA,
                                           float* DF,
                                           const float* __restrict__ wt,
                                           float* __restrict__ pw,
                                           const float* __restrict__ z_prev) {
  constexpr int KT = H + (SKIP ? FI : 0);
  load_act<ACT>(z_prev, H, X);
  __syncthreads();
  {
    float g[TILE];
    load_col<H>(G, g);
    dw_cols<H>(X, H, g, pw);
    if (SKIP) dw_cols<H>(FA, FI, g, pw + (long)H * H);
    db_col<H>(g, pw + (long)KT * H);
  }
  if (SKIP) dense_bwd<H, FI, KT, ACT, MODE_FADD>(G, wt + H, DF, nullptr, F);
  dense_bwd<H, H, KT, ACT, MODE_Z>(G, wt, G, z_prev, nullptr);
}

// Backward of layer_in (input = the raw init feature F, FI rows).
template <int H, int FI>
__device__ __forceinline__ void input_bwd(const float* G, const float* F,
                                          float* DF,
                                          const float* __restrict__ wt,
                                          float* __restrict__ pw) {
  {
    float g[TILE];
    load_col<H>(G, g);
    dw_cols<H>(F, FI, g, pw);
    db_col<H>(g, pw + (long)FI * H);
  }
  dense_bwd<H, FI, FI, ACT_NONE, MODE_ADD>(G, wt, DF, nullptr, nullptr);
}

template <int ENC>
size_t smem_bytes(int rays_per_block, int steps) {
  return sizeof(float) * ((size_t)(2 * HIDDEN + 3 * F_ROWS) * PS
                          + Layout<ENC>::LINES
                          + 8 * (size_t)rays_per_block * steps
                          + 13 * (size_t)rays_per_block);
}

template <int ENC>
__global__ void __launch_bounds__(THREADS, 1)
render_bwd_kernel(const float* __restrict__ rays,
                  const float* __restrict__ ts,
                  const float* __restrict__ dists,
                  const float* __restrict__ w,
                  const float* __restrict__ wt,
                  const float* __restrict__ gin,
                  const float* __restrict__ feats,
                  float* __restrict__ dfeat,
                  float* __restrict__ partial,
                  float* __restrict__ stash,
                  int n_rays, int steps, int rays_per_block, int n_rb,
                  int tiles, int sigmoid_kind, int sky_white, int loss_mode,
                  float loss_scale) {
  using L = Layout<ENC>;
  constexpr int FEAT_IN = L::FEAT_IN;
  constexpr int LINE_TOTAL = L::LINES;
  constexpr long WP = L::WP;
  constexpr int ST_FR = L::ST_FR;
  constexpr long ST_TILE = L::ST_TILE;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);        // [HIDDEN][PS]
  float* G = X + HIDDEN * PS;                        // [HIDDEN][PS]
  float* F = G + HIDDEN * PS;                        // [F_ROWS][PS]
  float* FA = F + F_ROWS * PS;                       // act(F)
  float* DF = FA + F_ROWS * PS;                      // d F
  float* LG = DF + F_ROWS * PS;                      // [LINE_TOTAL]
  float* res = LG + LINE_TOTAL;                      // [points][8]
  float* ray_s = res + 8 * rays_per_block * steps;   // [rays][8]
  float* ray_g = ray_s + 8 * rays_per_block;         // [rays][4]
  float* ray_l = ray_g + 4 * rays_per_block;         // [rays]

  const int tid = threadIdx.x;
  const int n_pts = rays_per_block * steps;
  float* part = partial + (long)blockIdx.x * WP;
  float* st_block = stash + (long)blockIdx.x * tiles * ST_TILE;
  float loss_acc = 0.0f;
  for (int i = tid; i < LINE_TOTAL; i += THREADS) LG[i] = 0.0f;

  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const int ray0 = rb * rays_per_block;
    // per-ray constants; rays past the ragged edge repeat the last ray and
    // get a zero cotangent
    for (int r = tid; r < rays_per_block; r += THREADS) {
      const int ray = min(ray0 + r, n_rays - 1);
      const float* src = rays + 6L * ray;
      float* s = ray_s + 8 * r;
#pragma unroll
      for (int c = 0; c < 6; ++c) s[c] = src[c];
      const float norm = sqrtf(s[3] * s[3] + s[4] * s[4] + s[5] * s[5]);
      const float inv = 1.0f / fmaxf(norm, 1e-12f);
      const float lim = 1.0f - 1e-6f;
      const float x = fminf(fmaxf(s[3] * inv, -lim), lim);
      const float y = fminf(fmaxf(s[4] * inv, -lim), lim);
      const float z = fminf(fmaxf(s[5] * inv, -lim), lim);
      s[6] = acosf(z);
      s[7] = atan2f(y, x);
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
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      float* st = st_block + tile * ST_TILE;
      if (tid < TILE) {
        const int q = min(q0 + tid, n_pts - 1);
        const float* s = ray_s + 8 * (q / steps);
        const float t = ts[q % steps];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          F[c * PS + tid] = sample_point(s[c], t, s[3 + c]);
      }
      if constexpr (ENC == ENC_HASH) {
        // hash features -> rows 3..18 (padding rows repeat the last point)
        for (int i = tid; i < TILE * HASH_FEATS; i += THREADS) {
          const int p = i / HASH_FEATS, j = i % HASH_FEATS;
          const int q = min(q0 + p, n_pts - 1);
          const long g = (long)min(ray0 + q / steps, n_rays - 1) * steps
                         + q % steps;
          F[(3 + j) * PS + p] = __ldg(feats + g * HASH_FEATS + j);
        }
      }
      __syncthreads();
      if constexpr (ENC == ENC_CP) {
        // CP encode: one (point, level) per thread -> rows 3 + 8 l + k
        const int p = tid & (TILE - 1);
        const int l = tid / TILE;
        const int res_l = 16 << l;
        const float* __restrict__ lines = w + line_offset(l);
        float f[RANK];
#pragma unroll
        for (int k = 0; k < RANK; ++k) f[k] = 1.0f;
#pragma unroll
        for (int axis = 0; axis < 3; ++axis) {
          int i0, i1;
          const float fr = cp_tap(F[axis * PS + p], res_l, &i0, &i1);
          const float* __restrict__ l0 = lines + (axis * res_l + i0) * RANK;
          const float* __restrict__ l1 = lines + (axis * res_l + i1) * RANK;
#pragma unroll
          for (int k = 0; k < RANK; ++k)
            f[k] = __fmul_rn(f[k], cp_lerp(__ldg(l0 + k), __ldg(l1 + k), fr));
        }
#pragma unroll
        for (int k = 0; k < RANK; ++k) F[(3 + l * RANK + k) * PS + p] = f[k];
      }
      __syncthreads();
      for (int i = tid; i < FEAT_IN * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = F[row * PS + p];
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
        st[(ST_FD + row) * TILE + p] = v;
      }
      __syncthreads();

      float* zd = st + ST_D * TILE;
      dense_fwd<FEAT_IN, 0, HIDDEN, ACT_LEAKY>(F, nullptr, w + L::D_IN, X,
                                               zd);
      dense_fwd<HIDDEN, FEAT_IN, HIDDEN, ACT_LEAKY>(X, FA, w + L::D_L0, X,
                                                    zd + 1 * HIDDEN * TILE);
      dense_fwd<HIDDEN, 0, HIDDEN, ACT_LEAKY>(X, nullptr, w + L::D_L1, X,
                                              zd + 2 * HIDDEN * TILE);
      dense_fwd<HIDDEN, 0, HIDDEN, ACT_LEAKY>(X, nullptr, w + L::D_L2, X,
                                              zd + 3 * HIDDEN * TILE);
      dense_fwd<HIDDEN, FEAT_IN, HIDDEN, ACT_LEAKY>(X, FA, w + L::D_L3, X,
                                                    zd + 4 * HIDDEN * TILE);
      dense_fwd<HIDDEN, 0, HIDDEN, ACT_LEAKY>(X, nullptr, w + L::D_L4, X,
                                              zd + 5 * HIDDEN * TILE);
      dense_fwd<HIDDEN, 0, D_OUT_W, ACT_NONE>(X, nullptr, w + L::D_OUT, X,
                                              nullptr);

      // density (raw); View init feature [p ‖ elev, azim ‖ feats]
      if (tid < TILE) {
        const int q = q0 + tid;
        if (q < n_pts) res[8 * q] = X[tid];
        const float* s = ray_s + 8 * (min(q, n_pts - 1) / steps);
        F[3 * PS + tid] = s[6];
        F[4 * PS + tid] = s[7];
      }
      for (int i = tid; i < INTERMEDIATE * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        F[(5 + row) * PS + p] = X[(1 + row) * PS + p];
      }
      __syncthreads();
      for (int i = tid; i < R_IN * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = F[row * PS + p];
        FA[row * PS + p] = activate<ACT_SIN30>(v);
        st[(ST_FR + row) * TILE + p] = v;
      }
      __syncthreads();

      float* zr = st + ST_R * TILE;
      dense_fwd<R_IN, 0, R_HIDDEN, ACT_SIN30>(F, nullptr, w + L::R_IN_, X,
                                              zr);
      dense_fwd<R_HIDDEN, R_IN, R_HIDDEN, ACT_SIN30>(
          X, FA, w + L::R_L0, X, zr + 1 * R_HIDDEN * TILE);
      dense_fwd<R_HIDDEN, 0, R_HIDDEN, ACT_SIN30>(
          X, nullptr, w + L::R_L1, X, zr + 2 * R_HIDDEN * TILE);
      dense_fwd<R_HIDDEN, 0, R_HIDDEN, ACT_SIN30>(
          X, nullptr, w + L::R_L2, X, zr + 3 * R_HIDDEN * TILE);
      dense_fwd<R_HIDDEN, R_IN, R_HIDDEN, ACT_SIN30>(
          X, FA, w + L::R_L3, X, zr + 4 * R_HIDDEN * TILE);
      dense_fwd<R_HIDDEN, 0, R_HIDDEN, ACT_SIN30>(
          X, nullptr, w + L::R_L4, X, zr + 5 * R_HIDDEN * TILE);
      dense_fwd<R_HIDDEN, 0, R_OUT_W, ACT_NONE>(X, nullptr, w + L::R_OUT, X,
                                                nullptr);
      if (tid < TILE && q0 + tid < n_pts) {
#pragma unroll
        for (int c = 0; c < 3; ++c) res[8 * (q0 + tid) + 1 + c] = X[c * PS + tid];
      }
      __syncthreads();
    }

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

    // ---- pass 2: hand VJP of the MLPs and the CP encoder, per tile ----
    for (int q0 = 0, tile = 0; q0 < n_pts; q0 += TILE, ++tile) {
      const float* st = st_block + tile * ST_TILE;
      const float* zr = st + ST_R * TILE;
      const float* zd = st + ST_D * TILE;

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
      load_act<ACT_SIN30>(zr + 5 * R_HIDDEN * TILE, R_HIDDEN, X);
      __syncthreads();
      dw_small<R_HIDDEN, R_OUT_W>(X, G, part + L::R_OUT);
      dense_bwd<R_OUT_W, R_HIDDEN, R_HIDDEN, ACT_SIN30, MODE_Z>(
          G, wt + L::R_OUT, G, zr + 5 * R_HIDDEN * TILE, nullptr);
      hidden_bwd<R_HIDDEN, R_IN, false, ACT_SIN30>(
          X, G, F, FA, DF, wt + L::R_L4, part + L::R_L4,
          zr + 4 * R_HIDDEN * TILE);
      hidden_bwd<R_HIDDEN, R_IN, true, ACT_SIN30>(
          X, G, F, FA, DF, wt + L::R_L3, part + L::R_L3,
          zr + 3 * R_HIDDEN * TILE);
      hidden_bwd<R_HIDDEN, R_IN, false, ACT_SIN30>(
          X, G, F, FA, DF, wt + L::R_L2, part + L::R_L2,
          zr + 2 * R_HIDDEN * TILE);
      hidden_bwd<R_HIDDEN, R_IN, false, ACT_SIN30>(
          X, G, F, FA, DF, wt + L::R_L1, part + L::R_L1,
          zr + 1 * R_HIDDEN * TILE);
      hidden_bwd<R_HIDDEN, R_IN, true, ACT_SIN30>(
          X, G, F, FA, DF, wt + L::R_L0, part + L::R_L0, zr);
      input_bwd<R_HIDDEN, R_IN>(G, F, DF, wt + L::R_IN_, part + L::R_IN_);

      // density MLP: G <- [d density ‖ d feats (DF rows 5..36)]
      for (int i = tid; i < D_OUT_W * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        float v;
        if (row == 0) {
          v = q0 + p < n_pts ? res[8 * (q0 + p) + 4] : 0.0f;
        } else {
          v = DF[(4 + row) * PS + p];
        }
        G[row * PS + p] = v;
      }
      __syncthreads();
      for (int i = tid; i < F_ROWS * TILE; i += THREADS) {
        const int row = i / TILE, p = i % TILE;
        const float v = row < FEAT_IN ? st[(ST_FD + row) * TILE + p] : 0.0f;
        F[row * PS + p] = v;
        FA[row * PS + p] = activate<ACT_LEAKY>(v);
        DF[row * PS + p] = 0.0f;
      }
      load_act<ACT_LEAKY>(zd + 5 * HIDDEN * TILE, HIDDEN, X);
      __syncthreads();
      dw_small<HIDDEN, D_OUT_W>(X, G, part + L::D_OUT);
      dense_bwd<D_OUT_W, HIDDEN, HIDDEN, ACT_LEAKY, MODE_Z>(
          G, wt + L::D_OUT, G, zd + 5 * HIDDEN * TILE, nullptr);
      hidden_bwd<HIDDEN, FEAT_IN, false, ACT_LEAKY>(
          X, G, F, FA, DF, wt + L::D_L4, part + L::D_L4,
          zd + 4 * HIDDEN * TILE);
      hidden_bwd<HIDDEN, FEAT_IN, true, ACT_LEAKY>(
          X, G, F, FA, DF, wt + L::D_L3, part + L::D_L3,
          zd + 3 * HIDDEN * TILE);
      hidden_bwd<HIDDEN, FEAT_IN, false, ACT_LEAKY>(
          X, G, F, FA, DF, wt + L::D_L2, part + L::D_L2,
          zd + 2 * HIDDEN * TILE);
      hidden_bwd<HIDDEN, FEAT_IN, false, ACT_LEAKY>(
          X, G, F, FA, DF, wt + L::D_L1, part + L::D_L1,
          zd + 1 * HIDDEN * TILE);
      hidden_bwd<HIDDEN, FEAT_IN, true, ACT_LEAKY>(
          X, G, F, FA, DF, wt + L::D_L0, part + L::D_L0, zd);
      input_bwd<HIDDEN, FEAT_IN>(G, F, DF, wt + L::D_IN, part + L::D_IN);

      if constexpr (ENC == ENC_HASH) {
        // dfeat = DF rows 3..18 for the points of real rays (a padding
        // ray repeats the last ray and must not overwrite its row)
        for (int i = tid; i < TILE * HASH_FEATS; i += THREADS) {
          const int p = i / HASH_FEATS, j = i % HASH_FEATS;
          const int q = q0 + p;
          if (q < n_pts && ray0 + q / steps < n_rays)
            dfeat[((long)ray0 * steps + q) * HASH_FEATS + j] =
                DF[(3 + j) * PS + p];
        }
        __syncthreads();
      } else {
        // CP lines: d enc = DF rows 3..34. Stage per point the factor
        // gradients and taps in X, then one thread per (level, axis, rank)
        // scatters them in point order into LG.
        {
          const int p = tid & (TILE - 1);
          const int l = tid / TILE;
          const int res_l = 16 << l;
          const float* __restrict__ lines = w + line_offset(l);
          float f[3][RANK];
          float fr[3];
          int i0s[3];
#pragma unroll
          for (int axis = 0; axis < 3; ++axis) {
            int i0, i1;
            fr[axis] = cp_tap(F[axis * PS + p], res_l, &i0, &i1);
            i0s[axis] = i0;
            const float* __restrict__ l0 = lines + (axis * res_l + i0) * RANK;
            const float* __restrict__ l1 = lines + (axis * res_l + i1) * RANK;
#pragma unroll
            for (int k = 0; k < RANK; ++k)
              f[axis][k] = cp_lerp(__ldg(l0 + k), __ldg(l1 + k), fr[axis]);
          }
#pragma unroll
          for (int axis = 0; axis < 3; ++axis) {
            const int b = axis == 0 ? 1 : 0, c = axis == 2 ? 1 : 2;
#pragma unroll
            for (int k = 0; k < RANK; ++k) {
              const float denc = DF[(3 + l * RANK + k) * PS + p];
              X[((l * 3 + axis) * RANK + k) * PS + p] =
                  denc * f[b][k] * f[c][k];
            }
            X[(96 + l * 3 + axis) * PS + p] = (float)i0s[axis];
            X[(108 + l * 3 + axis) * PS + p] = fr[axis];
          }
        }
        __syncthreads();
        if (tid < 3 * N_LEVELS * RANK) {
          const int l = tid / (3 * RANK), axis = (tid / RANK) % 3;
          const int k = tid % RANK;
          const int res_l = 16 << l;
          float* lg = LG + line_offset(l) + axis * res_l * RANK + k;
          const float* df = X + tid * PS;
          const float* i0r = X + (96 + l * 3 + axis) * PS;
          const float* frr = X + (108 + l * 3 + axis) * PS;
          for (int p = 0; p < TILE; ++p) {
            const int i0 = (int)i0r[p];
            const int i1 = min(i0 + 1, res_l - 1);
            lg[i0 * RANK] += df[p] * (1.0f - frr[p]);
            lg[i1 * RANK] += df[p] * frr[p];
          }
        }
        __syncthreads();
      }
    }
  }

  // the CP line gradients and the loss go to this block's partial once
  for (int i = tid; i < LINE_TOTAL; i += THREADS) part[i] = LG[i];
  if (tid == 0) part[L::TOTAL] = loss_acc;
}

// out[i] = sum over blocks b (in order) of partial[b][i], i < wp
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int blocks,
                                       long wp) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wp) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(long)b * wp + i];
  out[i] = s;
}

template <int ENC>
int launch(const float* rays, const float* ts, const float* dists,
           const float* weights, const float* weights_t, const float* gin,
           const float* feats, float* dfeat, float* out, float* partial,
           float* stash, int n_rays, int steps, int blocks, int sigmoid_kind,
           int sky_white, int loss_mode, float loss_scale, cudaStream_t s) {
  constexpr long WP = Layout<ENC>::WP;
  const int rays_per_block = steps >= TILE ? 1 : TILE / steps;
  const int n_rb = (n_rays + rays_per_block - 1) / rays_per_block;
  if (blocks > n_rb) return cudaErrorInvalidValue;
  const int tiles = (rays_per_block * steps + TILE - 1) / TILE;
  const size_t smem = smem_bytes<ENC>(rays_per_block, steps);
  cudaError_t err = cudaFuncSetAttribute(
      render_bwd_kernel<ENC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(partial, 0, sizeof(float) * (size_t)blocks * WP, s);
  if (err != cudaSuccess) return err;
  render_bwd_kernel<ENC><<<blocks, THREADS, smem, s>>>(
      rays, ts, dists, weights, weights_t, gin, feats, dfeat, partial, stash,
      n_rays, steps, rays_per_block, n_rb, tiles, sigmoid_kind, sky_white,
      loss_mode, loss_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(int)((WP + 255) / 256), 256, 0, s>>>(
      partial, out, blocks, WP);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats in the packed weight buffer the kernel expects for `enc`
// (0 cp, 1 hash).
long long render_bwd_weight_count(int enc) {
  return enc == ENC_CP ? Layout<ENC_CP>::TOTAL : Layout<ENC_HASH>::TOTAL;
}

// Floats of stash per 64-point tile (the wrapper sizes the scratch).
long long render_bwd_stash_floats_per_tile(int enc) {
  return enc == ENC_CP ? Layout<ENC_CP>::ST_TILE : Layout<ENC_HASH>::ST_TILE;
}

int render_bwd_max_steps() { return MAX_STEPS; }

const char* render_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues one backward on `stream`; returns the cudaError_t of the
// launches. gin: g [N, 4] (loss_mode 0) or target [N, 3] (loss_mode 1).
// enc 0 (cp): feats, dfeat unused; enc 1 (hash): feats and dfeat
// [N·steps, 16]. out: [weight count + 1] (gradient ‖ loss). partial:
// blocks × (weight count + 1) floats; stash: blocks × tiles ×
// stash_floats_per_tile(enc) floats, tiles = ceil(rays_per_block · steps /
// 64), rays_per_block = max(1, 64 / steps).
int render_bwd_launch(const float* rays, const float* ts, const float* dists,
                      const float* weights, const float* weights_t,
                      const float* gin, const float* feats, float* dfeat,
                      float* out, float* partial, float* stash, int n_rays,
                      int steps, int blocks, int sigmoid_kind, int sky_white,
                      int loss_mode, float loss_scale, int enc,
                      void* stream) {
  if (n_rays <= 0) return cudaSuccess;
  if (steps < 2 || steps > MAX_STEPS || sigmoid_kind < 0 || sigmoid_kind > 7
      || blocks <= 0 || (enc != ENC_CP && enc != ENC_HASH)
      || (enc == ENC_HASH && (feats == nullptr || dfeat == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return enc == ENC_CP
      ? launch<ENC_CP>(rays, ts, dists, weights, weights_t, gin, feats,
                       dfeat, out, partial, stash, n_rays, steps, blocks,
                       sigmoid_kind, sky_white, loss_mode, loss_scale, s)
      : launch<ENC_HASH>(rays, ts, dists, weights, weights_t, gin, feats,
                         dfeat, out, partial, stash, n_rays, steps, blocks,
                         sigmoid_kind, sky_white, loss_mode, loss_scale, s);
}

}  // extern "C"
