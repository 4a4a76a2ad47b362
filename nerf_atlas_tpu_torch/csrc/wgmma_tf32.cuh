// The dense products of the forward kernels K1 (render_fwd.cu), K7f
// (render_ae_fwd.cu), K8f (render_volsdf_fwd.cu) and K9f
// (render_dyn_fwd.cu) on Hopper's tensor cores: a whole SkipConnMLP's
// forward by `wgmma.mma_async` in split TF32, and K8f's eikonal column,
// the input gradient of the SDF's output by the transpose chain
// (`mlp_input_grad`).
//
// Split TF32, as mma_tf32.cuh forms it for the backward kernels: each
// float32 operand a is split into hi = tf32(a) and lo = tf32(a − hi), and
// a product a·b is lo_a·hi_b + hi_a·lo_b + hi_a·hi_b (TF32 inputs, float32
// accumulation; the dropped lo_a·lo_b is ≤ 2^-22·|ab|), each 8-deep
// k-step into a fresh accumulator that one round-to-nearest float32 add
// carries into the running sum (the tensor cores' own accumulation
// truncates; a 16-deep slice per accumulator, as mma_tf32.cuh takes it,
// lay further from the float64 products on K1's checks).
// ~3·2^-22 relative per term where a float32 FMA carries 2^-24:
// `testing.split_tf32_matmul` emulates it on the CPU
// (tests/test_torch_tf32_split.py holds the plain K1, K7f, K8f with its
// eikonal column, and K9f so computed to their gates).
//
// Why wgmma and this form. A block holds two 64-point tiles, one per
// warpgroup: the tile's points are one wgmma's M (64), the layer's outputs
// its N (a 64-wide sub-product of a 256- or 128-wide layer, or the whole
// padded width of a narrow one: 33 → 40, 32 and 30 → 32, 4, 3 and 1 → 8;
// no padding to 64),
// the input features its K, 8 per instruction. A, the activations, comes
// from registers: each thread loads its fragment from the tile's
// feature-major [row][PS] rows (render_common.cuh's layout, which the
// encoders, the skip concat and the compositing share with K2/K3) and
// splits it in registers; a register fragment is K-major, as TF32 wgmma
// requires, whatever the tile's layout. B, the weights, is Wᵀ [out][in]
// (K-major), pre-split by the wrapper into hi and lo in wgmma's canonical
// layout without swizzle (the "wgmma pack", render.py `wgmma_pack`): per
// layer, per 64-wide sub-product and per 16-deep slice, a unit of hi then
// lo, each [k-chunk of 4 (4)][n-group of 8 (NS/8)][8 n][4 k] (a core
// matrix of 8 rows of 16 bytes per (k-chunk, n-group)); a k-step's
// descriptor starts at its k-chunk pair, LBO = the k-chunks' distance,
// SBO = 128 bytes. The units stream through a ring of shared-memory slots
// by cp.async, several ahead of the products (as many as the mode's
// shared memory holds: one unit of tensor work is shorter than the L2's
// latency), and both warpgroups read each staged unit: every staged byte
// serves the block's 128 points.
//
// Each output element is owned by one thread, and every sum runs in a
// fixed order: the results are the same bits from launch to launch.

#pragma once

#include <stdint.h>

#include "mma_tf32.cuh"
#include "render_common.cuh"

namespace wg {

using namespace render;

constexpr int SK = 16;                 // k rows per staged unit: 2 k-steps
constexpr int NS_MAX = 64;             // outputs per sub-product
constexpr int WG_THREADS = 128;        // one warpgroup: one 64-point tile
constexpr int UNIT_FLOATS = 2 * SK * NS_MAX;   // a staged unit: hi and lo

static_assert(THREADS == 2 * WG_THREADS, "two warpgroups, two tiles");

__host__ __device__ constexpr int pad8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }
// a sub-product's N: 64, or the whole padded width below that
__host__ __device__ constexpr int sub_n(int out) {
  return pad8(out) < NS_MAX ? pad8(out) : NS_MAX;
}

// ---- the wgmma pack (render.py `wgmma_layout_index` builds it) ----
// Dense layer j of a SkipConnMLP (mma_tf32.cuh `layer_kh`, `layer_kf`,
// `layer_out`): [pad16(kh) + pad16(kf) k rows][pad8(out)], hi and lo.
__host__ __device__ constexpr long layer_floats(int kh, int kf, int out) {
  return 2L * (pad16(kh) + pad16(kf)) * pad8(out);
}
__host__ __device__ constexpr long layer_offset(int fi, int h, int nl,
                                                int nout, int j) {
  long off = 0;
  for (int i = 0; i < j; ++i)
    off += layer_floats(tc::layer_kh(h, i), tc::layer_kf(fi, nl, i),
                        tc::layer_out(h, nl, nout, i));
  return off;
}
__host__ __device__ constexpr long mlp_floats(int fi, int h, int nl,
                                              int nout) {
  return layer_offset(fi, h, nl, nout, nl + 2);
}

// ---- the instructions ----

// wgmma's shared-memory matrix descriptor without swizzle: the start
// address, LBO (the distance of a core matrix's neighbour along K) and SBO
// (along N), in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const float* p, int lbo_bytes,
                                              int sbo_bytes) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4)
         | ((uint64_t)(lbo_bytes >> 4) << 16)
         | ((uint64_t)(sbo_bytes >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// orders the generic-proxy writes (cp.async) to shared memory before the
// async proxy's (wgmma's) reads of it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x, opaque to the compiler: what a layer derives from it (descriptors,
// staging addresses) is computed in the layer and not hoisted out of the
// kernel's loop into registers that then spill
template <class T>
__device__ __forceinline__ T* opaque(T* x) {
  uint64_t v = reinterpret_cast<uint64_t>(x);
  asm volatile("mov.b64 %0, %0;\n" : "+l"(v));
  return reinterpret_cast<T*>(v);
}

// keeps the compiler from moving a read of an accumulator register across
// the wait that completes it
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A·B for a 64 × N × 8 step: A the thread's four TF32 values
// (rows g and g + 8 of its warp's 16, k = t and t + 4), B the descriptor;
// scale_d = 0 overwrites d. d[4j + c]: row g (c < 2) or g + 8, column 8j +
// 2t + (c & 1).
template <int N>
struct Mma;

template <>
struct Mma<64> {
  __device__ __forceinline__ static void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<40> {
  __device__ __forceinline__ static void run(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<8> {
  __device__ __forceinline__ static void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ---- a whole SkipConnMLP on a warpgroup's tile ----

// The product of a Dense layer on the warpgroup's 64 points: for n < NOUT,
// epi(n, m, Σ_k A[k][m]·B[k][n]) once per output, A rows k < KA from `a`
// and rows KA + r, r < KB, ACT_B(f[r][m]) (act of the init feature at a
// skip layer, the raw feature at layer_in), B the wgmma-pack block `blk`.
// The units pass through `stage` (S · UNIT_FLOATS floats, a ring of S
// units that both warpgroups read) by cp.async, S − 1 ahead of the
// products, one block barrier per unit. Each k-step's three products go
// into a fresh accumulator that one float32 add carries into the sum.
// Both warpgroups call it together; epi runs after every read of `a`, so
// it may write over a. Starts and ends with a barrier. The caller makes
// blk and stage `opaque`.
template <int S, int KA, int KB, int NOUT, int ACT_B, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ blk,
                                        float* stage, const float* a,
                                        const float* f, Epi epi) {
  constexpr int NS = sub_n(NOUT), SUBS = pad8(NOUT) / NS;
  constexpr int KAP = pad16(KA), SLICES = (KAP + pad16(KB)) / SK;
  constexpr int UNITS = SUBS * SLICES, UNIT = 2 * SK * NS;
  constexpr int LBO = NS / 8 * 128, SBO = 128;
  static_assert(pad8(NOUT) % NS == 0 && NS % 8 == 0, "sub-products");
  static_assert(S >= 2, "a ring of two units at least");
  const int wtid = threadIdx.x & (WG_THREADS - 1);
  const int lane = wtid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (wtid >> 5) + g;
  // unit u into ring slot u % S (a thread with no chunk commits an empty
  // group, so that every thread counts the same groups)
  auto issue = [&](int u) {
    if (u < UNITS) {
      const float* src = blk + (long)u * UNIT;
      float* d = stage + (u % S) * UNIT_FLOATS;
      for (int c = threadIdx.x; c < UNIT / 4; c += THREADS)
        tc::cp_async16(d + 4 * c, src + 4 * c);
    }
    tc::cp_async_commit();
  };
  float acc[SUBS][NS / 2];
#pragma unroll
  for (int s = 0; s < SUBS; ++s)
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[s][i] = 0.0f;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < S - 1; ++u) issue(u);
#pragma unroll
  for (int sub = 0; sub < SUBS; ++sub) {
#pragma unroll 1
    for (int s = 0; s < SLICES; ++s) {
      const int u = sub * SLICES + s;
      // this thread's copies of unit u have landed; after the barrier
      // everyone's have, and every read of slot (u − 1) % S is done
      tc::cp_async_wait<S - 2>();
      fence_proxy_async();
      __syncthreads();
      issue(u + S - 1);
      // A: this thread's values of the slice's two k-steps, split
      const bool first = s * SK < KAP;
      const float* src = first ? a : f;
      const int rows = first ? KA : KB;
      const int r0 = (first ? s * SK : s * SK - KAP) + t;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = r0 + 8 * kk;
        float v[4];
        v[0] = r < rows ? src[r * PS + m0] : 0.0f;
        v[1] = r < rows ? src[r * PS + m0 + 8] : 0.0f;
        v[2] = r + 4 < rows ? src[(r + 4) * PS + m0] : 0.0f;
        v[3] = r + 4 < rows ? src[(r + 4) * PS + m0 + 8] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tc::split(first ? v[i] : activate<ACT_B>(v[i]), ah[kk][i],
                    al[kk][i]);
      }
      // per k-step: lo·hi, hi·lo, hi·hi into a fresh accumulator
      const float* su = stage + (u % S) * UNIT_FLOATS;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t bh = smem_desc(su + 2 * kk * (NS / 8) * 32, LBO, SBO);
        const uint64_t bl =
            smem_desc(su + SK * NS + 2 * kk * (NS / 8) * 32, LBO, SBO);
        float part[NS / 2];
        wgmma_fence();
        Mma<NS>::run(part, al[kk], bh, 0);
        Mma<NS>::run(part, ah[kk], bl, 1);
        Mma<NS>::run(part, ah[kk], bh, 1);
        wgmma_commit();
        wgmma_wait();
        fence_operand(part);
#pragma unroll
        for (int i = 0; i < NS / 2; ++i) acc[sub][i] += part[i];
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();
  // every read of a done: the outputs over it
#pragma unroll
  for (int sub = 0; sub < SUBS; ++sub) {
#pragma unroll
    for (int j = 0; j < NS / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = sub * NS + 8 * j + 2 * t + (c & 1);
        const int m = m0 + 8 * (c >> 1);
        if (n < NOUT) epi(n, m, acc[sub][4 * j + c]);
      }
    }
  }
  __syncthreads();
}

// ---- the sign stash of a leaky-relu MLP (K8f's eikonal column: act′ is 1
// or 0.01 by the sign of its input, and leaky-relu keeps the sign, so the
// activations give it) ----
//
// A row of a tile's signs is 8 bytes: bit g of byte k is 1 where the
// row's value at point 8k + g is > 0.

// The signs of the warpgroup's rows r < rows of x ([row][PS]).
__device__ __forceinline__ void sign_rows(const float* x, int rows,
                                          uint8_t* signs) {
  for (int i = threadIdx.x & (WG_THREADS - 1); i < 8 * rows;
       i += WG_THREADS) {
    const float* v = x + (i >> 3) * PS + 8 * (i & 7);
    uint32_t byte = 0;
#pragma unroll
    for (int g = 0; g < 8; ++g) byte |= (v[g] > 0.0f ? 1u : 0u) << g;
    signs[i] = (uint8_t)byte;
  }
}

// act′ of a leaky-relu at row n, point m of the tile whose signs are `s`
__device__ __forceinline__ float slope(const uint8_t* s, int n, int m) {
  return (s[8 * n + (m >> 3)] >> (m & 7)) & 1 ? 1.0f : 0.01f;
}

// x[n][m] *= act′ for the warpgroup's rows n < rows of x, signs `s`
__device__ __forceinline__ void apply_slopes(float* x, int rows,
                                             const uint8_t* s) {
  for (int i = threadIdx.x & (WG_THREADS - 1); i < rows * TILE;
       i += WG_THREADS) {
    const int n = i / TILE, m = i % TILE;
    x[n * PS + m] *= slope(s, n, m);
  }
}

// Dense layer: dst[n][p] = ACT(b[n] + `product`) for the warpgroup's 64
// points and n < NOUT; `blk` the layer's wgmma pack, `b` its bias. Both
// warpgroups call it together; dst may alias a. Starts and ends with a
// barrier.
template <int S, int KA, int KB, int NOUT, int ACT, int ACT_B>
__device__ __forceinline__ void dense(const float* __restrict__ blk,
                                      const float* __restrict__ b,
                                      float* stage, const float* a,
                                      const float* f, float* dst) {
  blk = opaque(blk);
  b = opaque(b);
  stage = opaque(stage);
  product<S, KA, KB, NOUT, ACT_B>(blk, stage, a, f,
                                  [&](int n, int m, float acc) {
    dst[n * PS + m] = activate<ACT>(acc + __ldg(b + n));
  });
}

// Hidden layers I..NL-1 of `mlp_fwd`.
template <int S, int FI, int H, int NL, int NOUT, int ACT, bool SIGNS,
          int I>
__device__ __forceinline__ void mlp_hidden_fwd(const float* F,
                                               const float* __restrict__ w,
                                               const float* __restrict__ wp,
                                               float* X, float* stage,
                                               uint8_t* signs) {
  if constexpr (I < NL) {
    constexpr int KF = skip_at(I, NL) ? FI : 0;
    dense<S, H, KF, H, ACT, ACT>(
        wp + layer_offset(FI, H, NL, NOUT, I + 1),
        w + mlp_offset(FI, H, NL, I + 1) + (long)(H + KF) * H, stage, X, F,
        X);
    if constexpr (SIGNS) sign_rows(X, H, signs + 8L * (I + 1) * H);
    mlp_hidden_fwd<S, FI, H, NL, NOUT, ACT, SIGNS, I + 1>(F, w, wp, X, stage,
                                                          signs);
  }
}

// A SkipConnMLP on the warpgroup's tile: init feature F (FI rows, raw; the
// skip layers apply ACT to it as they load it) -> its raw output in X rows
// 0..NOUT-1 (X holds H rows). w: the packed weights at the MLP's layer_in
// (the biases), wp: its wgmma pack; stage: S · UNIT_FLOATS floats of
// shared memory that neither warpgroup's F or X overlaps. With SIGNS
// (ACT_LEAKY), the signs of layer_in's and of each hidden layer's
// activations, those of their pre-activations, go to `signs`, (NL + 1)·H
// rows (`mlp_input_grad` reads them). Both warpgroups call it together,
// each on its own tile.
template <int S, int FI, int H, int NL, int NOUT, int ACT, bool SIGNS = false>
__device__ __forceinline__ void mlp_fwd(const float* F,
                                        const float* __restrict__ w,
                                        const float* __restrict__ wp,
                                        float* X, float* stage,
                                        uint8_t* signs = nullptr) {
  static_assert(!SIGNS || ACT == ACT_LEAKY, "signs give leaky-relu's act′");
  dense<S, 0, FI, H, ACT, ACT_NONE>(wp, w + (long)FI * H, stage, nullptr, F,
                                    X);
  if constexpr (SIGNS) sign_rows(X, H, signs);
  mlp_hidden_fwd<S, FI, H, NL, NOUT, ACT, SIGNS, 0>(F, w, wp, X, stage,
                                                    signs);
  dense<S, H, 0, NOUT, ACT_NONE, ACT_NONE>(
      wp + layer_offset(FI, H, NL, NOUT, NL + 1),
      w + mlp_offset(FI, H, NL, NL + 1) + (long)H * NOUT, stage, X, nullptr,
      X);
}

// ---- the input gradient of one output column by the transpose chain
// (render_common.cuh states it): VolSDF's ∇ₓsdf, K8f's eikonal column ----

// The chain pack (render.py `wgmma_layout_index(..., transposed=True)`):
// per Dense layer j = 0..NL of a SkipConnMLP (not layer_out), B = W as [k
// = out][n = in], K-major, in the wgmma pack's form: its kh hidden
// columns, then its kf init-feature columns as two blocks, the first
// `kf_head(kf)` and the rest (67 -> 64 + 3: a sub-product's N is 64 or,
// below that, the width padded to 8).
__host__ __device__ constexpr int kf_head(int kf) {
  return kf / NS_MAX * NS_MAX;
}
__host__ __device__ constexpr long t_block_floats(int k, int n) {
  return n == 0 ? 0 : 2L * pad16(k) * pad8(n);
}
__host__ __device__ constexpr long t_layer_floats(int kh, int kf, int out) {
  return t_block_floats(out, kh) + t_block_floats(out, kf_head(kf))
         + t_block_floats(out, kf - kf_head(kf));
}
__host__ __device__ constexpr long t_layer_offset(int fi, int h, int nl,
                                                  int j) {
  long off = 0;
  for (int i = 0; i < j; ++i)
    off += t_layer_floats(tc::layer_kh(h, i), tc::layer_kf(fi, nl, i), h);
  return off;
}
__host__ __device__ constexpr long t_mlp_floats(int fi, int h, int nl) {
  return t_layer_offset(fi, h, nl, nl + 1);
}

// DF rows n < N += the product of u (G, K rows) and the init-feature
// columns at `blk` (`kf_head`'s two blocks), times act′(init) from the
// init feature's signs `fs` with SLOPE.
template <int S, int K, int N, bool SLOPE>
__device__ __forceinline__ void init_rows_grad(const float* __restrict__ blk,
                                               float* stage, const float* G,
                                               float* DF,
                                               const uint8_t* fs) {
  constexpr int HEAD = kf_head(N);
  auto add = [&](int n, int m, float v) {
    DF[n * PS + m] += SLOPE ? v * slope(fs, n, m) : v;
  };
  if constexpr (HEAD > 0)
    product<S, K, 0, HEAD, ACT_NONE>(opaque(blk), opaque(stage), G, nullptr,
                                     add);
  if constexpr (N > HEAD)
    product<S, K, 0, N - HEAD, ACT_NONE>(
        opaque(blk + t_block_floats(K, HEAD)), opaque(stage), G, nullptr,
        [&](int n, int m, float v) { add(HEAD + n, m, v); });
}

// Hidden layers I..0 of `mlp_input_grad`, last first. On entry G holds
// u_{I+1}.
template <int S, int FI, int H, int NL, int I>
__device__ __forceinline__ void mlp_input_grad_hidden(
    float* G, float* DF, const float* __restrict__ wc, float* stage,
    const uint8_t* signs) {
  if constexpr (I >= 0) {
    const float* blk = wc + t_layer_offset(FI, H, NL, I + 1);
    if constexpr (skip_at(I, NL)) {
      // DF += act′(init) ⊙ (W_I,f u_{I+1})
      init_rows_grad<S, H, FI, true>(blk + t_block_floats(H, H), stage, G,
                                     DF, signs + 8L * (NL + 1) * H);
    }
    // G <- u_I = a′_I ⊙ (W_I,h u_{I+1}), act′ after the product (in its
    // epilogue, the sign loads beside the 128 accumulators spill)
    product<S, H, 0, H, ACT_NONE>(opaque(blk), opaque(stage), G, nullptr,
                                  [&](int n, int m, float v) {
      G[n * PS + m] = v;
    });
    apply_slopes(G, H, signs + 8L * I * H);
    mlp_input_grad_hidden<S, FI, H, NL, I - 1>(G, DF, wc, stage, signs);
  }
}

// d out_0 / d init of the warpgroup's tile into DF rows 0..FI-1 for a
// leaky-relu SkipConnMLP: each product by wgmma in split TF32, A = u from
// the tile's rows of G, B = the layer's W [k = out][n = in] from the chain
// pack `wc`, then times act′ (no bias). The seed
// u_NL = a′_NL ⊙ W_out[:, 0] comes from the packed weights w (at the
// MLP's layer_in), every act′ from `signs`: as `mlp_fwd` with SIGNS wrote
// them, then the init feature's (FI rows, `sign_rows`). G (H rows) is
// overwritten; stage as `mlp_fwd`'s. Both warpgroups call it together.
// Starts and ends with a barrier.
template <int S, int FI, int H, int NL, int NOUT>
__device__ __forceinline__ void mlp_input_grad(float* G, float* DF,
                                               const float* __restrict__ w,
                                               const float* __restrict__ wc,
                                               float* stage,
                                               const uint8_t* signs) {
  const int wtid = threadIdx.x & (WG_THREADS - 1);
  const float* w_col = w + mlp_offset(FI, H, NL, NL + 1);
  const uint8_t* zs = signs + 8L * NL * H;
  __syncthreads();
  for (int i = wtid; i < H * TILE; i += WG_THREADS) {
    const int n = i / TILE, m = i % TILE;
    G[n * PS + m] = __ldg(w_col + (long)NOUT * n) * slope(zs, n, m);
  }
  for (int i = wtid; i < FI * TILE; i += WG_THREADS)
    DF[(i / TILE) * PS + i % TILE] = 0.0f;
  mlp_input_grad_hidden<S, FI, H, NL, NL - 1>(G, DF, wc, stage, signs);
  init_rows_grad<S, H, FI, false>(wc, stage, G, DF, nullptr);  // W_in u_0
}

}  // namespace wg
