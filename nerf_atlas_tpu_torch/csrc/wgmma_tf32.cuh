// The dense products of K1 (render_fwd.cu) on Hopper's tensor cores: a
// whole SkipConnMLP's forward by `wgmma.mma_async` in split TF32.
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
// (tests/test_torch_tf32_split.py holds the plain K1 so computed to K1's
// gate).
//
// Why wgmma and this form. A block holds two 64-point tiles, one per
// warpgroup: the tile's points are one wgmma's M (64), the layer's outputs
// its N (a 64-wide sub-product of a 256- or 128-wide layer, or the whole
// padded width of a narrow one: 33 → 40, 4 and 3 → 8; no padding to 64),
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

// Dense layer: dst[n][p] = ACT(z), z = b[n] + Σ_k A[k][p]·W[k][n] for the
// warpgroup's 64 points and n < NOUT, A rows k < KA from `a` and rows KA +
// r, r < KB, ACT_B(f[r][p]) (act of the init feature at a skip layer, the
// raw feature at layer_in); `blk` the layer's wgmma pack, `b` its bias.
// The units pass through `stage` (S · UNIT_FLOATS floats, a ring of S
// units that both warpgroups read) by cp.async, S − 1 ahead of the
// products, one block barrier per unit. Each k-step's three products go
// into a fresh accumulator that one float32 add carries into the sum.
// Both warpgroups call it together; dst may alias a. Starts and ends
// with a barrier.
template <int S, int KA, int KB, int NOUT, int ACT, int ACT_B>
__device__ __forceinline__ void dense(const float* __restrict__ blk,
                                      const float* __restrict__ b,
                                      float* stage, const float* a,
                                      const float* f, float* dst) {
  blk = opaque(blk);
  b = opaque(b);
  stage = opaque(stage);
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
        if (n < NOUT)
          dst[n * PS + m] = activate<ACT>(acc[sub][4 * j + c] + __ldg(b + n));
      }
    }
  }
  __syncthreads();
}

// Hidden layers I..NL-1 of `mlp_fwd`.
template <int S, int FI, int H, int NL, int NOUT, int ACT, int I>
__device__ __forceinline__ void mlp_hidden_fwd(const float* F,
                                               const float* __restrict__ w,
                                               const float* __restrict__ wp,
                                               float* X, float* stage) {
  if constexpr (I < NL) {
    constexpr int KF = skip_at(I, NL) ? FI : 0;
    dense<S, H, KF, H, ACT, ACT>(
        wp + layer_offset(FI, H, NL, NOUT, I + 1),
        w + mlp_offset(FI, H, NL, I + 1) + (long)(H + KF) * H, stage, X, F,
        X);
    mlp_hidden_fwd<S, FI, H, NL, NOUT, ACT, I + 1>(F, w, wp, X, stage);
  }
}

// A SkipConnMLP on the warpgroup's tile: init feature F (FI rows, raw; the
// skip layers apply ACT to it as they load it) -> its raw output in X rows
// 0..NOUT-1 (X holds H rows). w: the packed weights at the MLP's layer_in
// (the biases), wp: its wgmma pack; stage: S · UNIT_FLOATS floats of
// shared memory that neither warpgroup's F or X overlaps. Both
// warpgroups call it together, each on its own tile.
template <int S, int FI, int H, int NL, int NOUT, int ACT>
__device__ __forceinline__ void mlp_fwd(const float* F,
                                        const float* __restrict__ w,
                                        const float* __restrict__ wp,
                                        float* X, float* stage) {
  dense<S, 0, FI, H, ACT, ACT_NONE>(wp, w + (long)FI * H, stage, nullptr, F,
                                    X);
  mlp_hidden_fwd<S, FI, H, NL, NOUT, ACT, 0>(F, w, wp, X, stage);
  dense<S, H, 0, NOUT, ACT_NONE, ACT_NONE>(
      wp + layer_offset(FI, H, NL, NOUT, NL + 1),
      w + mlp_offset(FI, H, NL, NL + 1) + (long)H * NOUT, stage, X, nullptr,
      X);
}

}  // namespace wg
