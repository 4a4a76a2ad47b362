// K5f / K5b: the NGP hash-grid lookup and its table gradient on Hopper.
//
// Replaces nerf_atlas_tpu/ops/pallas/hash_encode.py:_hash_fwd_kernel (K5f,
// called by _fwd_call) and :_hash_bwd_kernel (K5b, _bwd_call), for every
// power-of-two table size (the TPU kernels take T <= 2^16 only).
//   hash_fwd: table [L·T, 2] f32, pts [P, 3] f32 -> features [P, L·2] f32
//   hash_bwd: dfeat [P, L·2] f32, pts [P, 3] f32 -> dtable [L·T, 2] f32
// with L = 8 levels at the resolutions the wrapper passes (round(16·2^i)).
// Per (point, level): xn = clip((x − bbox_min)/(bbox_max − bbox_min), 0, 1),
// v = xn·(res − 1), lo = floor(v), frac = v − lo; corner c takes bit
// (c >> a) & 1 on axis a, clamped at res − 1; its row is (z·res + y)·res + x
// when res³ <= T, else x·1 ^ y·2654435761 ^ z·805459861 in uint32, then
// & (T − 1) + l·T; its weight is w_x·w_y·w_z (w = frac or 1 − frac). The
// forward sums table[row]·w over c = 0..7 in that order.
//
// Every float operation is an explicit round-to-nearest intrinsic, in the
// order of the plain torch version (ops/kernels/hash_encode.py) and of
// nerf_atlas_tpu.nn.HashEncoder: no FMA contraction, so a point on a grid
// line floors to the same cell and the features agree bit for bit.
//
// What bounds K5f on this card. Its bytes bound is 0.10 ms per
// 4,194,304-point eval chunk at T = 2^19 (12 B of point in, 64 B of
// features out, each distinct table row touched read once, at 3.35 TB/s),
// but a chunk makes 268M scattered 8-byte table reads (8 corners of 8
// levels per point), each worth a 32-byte L2 sector, while the table (32
// MB at 2^19) shares the 50 MB L2 with 268 MB of features streaming out.
// So the cost is the gather: how many loads and distinct sectors each warp
// asks for, how many of them are in flight, and the table's L2 residency.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py --k5f-against):
// the table's re-read after a 256 MB write costs nothing measurable, and
// with this design ~86% of the time is per-point work that a table held
// in L1 (T = 2) costs as much; the mapping below took the gather's own
// share from ~0.49 ms a chunk to ~0.06.
//
// K5f's design, against each cost:
// - A block takes FWD_PTS consecutive points, a point per thread. Their
//   normalised coordinates are computed once per point and axis (cell_of's
//   operations, so the same bits) into shared memory. Warp w takes points
//   32w..32w + 31 through the 8 levels in turn: the lanes of every load
//   share a level, its resolution and the dense/hash choice, and at the
//   coarse levels neighbouring samples of a ray fall in the same cells, so
//   a load asks for fewer distinct sectors. A warp walks all 8 levels with
//   no block barrier between them, and each thread issues a level's loads
//   before it uses the first. The rows and weights are corner()'s, K5b's.
// - Corner pairs along x: corners c and c|1 (c even) differ only in x.
//   When their rows are the two halves of one aligned pair, 2k and 2k + 1
//   in either order (decided from the rows themselves: row c|1 == row c ^
//   1), one 16-byte load serves both. That holds where lo_x is even and x
//   is not clamped: in a dense level row c is then even, and in a hashed
//   one x ^ 1 flips bit 0 of the hash only (& (T − 1) keeps it), while
//   bit 0 itself also takes y's and z's, so row c is odd half the time.
//   It never holds at T = 1. Every pair issues the 16-byte load of the
//   aligned pair that holds row c, and the lanes whose pair is not joined
//   add one predicated 8-byte load of row c|1 into fresh registers (so it
//   waits on no earlier load): two instructions per pair, no branch, about
//   three loads' requests where there were four.
// - The table's loads carry an L2 evict-last policy (createpolicy,
//   ld.global.nc.L2::cache_hint); points are read and features written
//   evict-first (ld.global.cs, st.global.cs), so the streams do not push
//   the table out of L2. No device setting and no access-policy window.
// - The tile's features are staged in shared memory (swizzled so that
//   neither the 8-byte writes nor the 16-byte reads conflict on banks)
//   and written as contiguous 16-byte stores.
// - The products and sums keep their order (c = 0..7, __fmul_rn /
//   __fadd_rn), so the features equal the plain version's bit for bit.
// Neither TMA nor wgmma serves here: TMA copies tiles of a regular grid,
// not 8-byte rows at hashed addresses, and there is no product to run.
// The tools are wide loads, cache policy and L2 residency.
//
// K5b's bound is bytes as well: each (point, level) reads 8 B of dfeat
// and 12 B of its point and adds into 8 rows.
//
// K5b (order-free and deterministic): the table gradient is accumulated
// in 64-bit fixed point, one scale per (level, feature), so that integer
// addition, which is associative, makes the result independent of the
// order of the adds: the same bits from any launch, grid or permutation
// of the points. Three kernels:
//   1. hash_bwd_max_kernel: m = max |dfeat| per (level, feature), an
//      atomicMax on the bits of a non-negative float (order-free);
//   2. hash_bwd_kernel: 2^e with e the largest integer such that
//      m·P·2^e < 2^61 (P points; `fixed_exp`). Each contribution
//      v = w·dfeat (one float32 product, as the plain version rounds it)
//      becomes the integer q = rn(v·2^e) (exact scaling in double, one
//      rounding). A block owns one level and 256 points; it combines the
//      rows its 2048 corners touch in a shared-memory hash table (4096
//      slots, 64-bit shared atomics) and then issues one pair of global
//      64-bit integer adds per distinct row;
//   3. hash_bwd_convert_kernel: dtable = float(q_sum·2^-e).
// Range: Σ over a row of |v| ≤ Σ_p |dfeat_p|·Σ_c w_c ≤ (1 + 2^-20)·m·P, so
// a row's sum stays under 2^61·(1 + 2^-20) + 4P < 2^62 (and the adds wrap
// in two's complement, so partial sums may overflow on the way).
// Error: each contribution is rounded once, by at most 2^-(e+1) ≤
// m·P·2^-61; a row of n contributions is off by at most n·m·P·2^-61 from
// the exact sum of its float32 products, before the final rounding to
// float32. At the train step's P = 262,144 points that is 2^-43·m ≈
// 1.1e-13·m per contribution, below the float32 rounding of the product
// itself (up to 2^-24·m) and far below the 1e-5 per-level gate. The
// plain version sums the same products in float32 with index_add_.
// Non-finite cotangents of a (level, feature) give NaN in its column.
// No float atomics, no library kernel; the wrapper allocates the integer
// table and the maxima (zeroed) and the output.
//
// Plain C interface for ctypes (built with nvcc into a shared library).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LEVELS = 8;
constexpr int THREADS = 256;
constexpr uint32_t PRIME_Y = 2654435761u;
constexpr uint32_t PRIME_Z = 805459861u;

struct Resolutions {
  int r[LEVELS];
};

// the point's cell and fractions at resolution res
struct Cell {
  uint32_t lo[3];
  float frac[3];
  uint32_t rmax;
  bool dense;
};

__device__ __forceinline__ Cell cell_of(const float* __restrict__ p, int res,
                                        uint32_t table_size, float bbox_min,
                                        float bbox_max) {
  Cell cell;
  const float span = __fsub_rn(bbox_max, bbox_min);
  const float scale = (float)(res - 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float xn = __fdiv_rn(__fsub_rn(p[a], bbox_min), span);
    xn = fminf(fmaxf(xn, 0.0f), 1.0f);
    const float v = __fmul_rn(xn, scale);
    const float lo = floorf(v);
    cell.frac[a] = __fsub_rn(v, lo);
    cell.lo[a] = (uint32_t)lo;
  }
  cell.rmax = (uint32_t)(res - 1);
  cell.dense = (unsigned long long)res * res * res <= table_size;
  return cell;
}

// row (level offset included) and trilinear weight of corner c
__device__ __forceinline__ size_t corner(const Cell& cell, int c, int res,
                                         int level, uint32_t table_size,
                                         float* w) {
  const uint32_t x = min(cell.lo[0] + (c & 1), cell.rmax);
  const uint32_t y = min(cell.lo[1] + ((c >> 1) & 1), cell.rmax);
  const uint32_t z = min(cell.lo[2] + ((c >> 2) & 1), cell.rmax);
  const uint32_t r = (uint32_t)res;
  const uint32_t idx = cell.dense ? (z * r + y) * r + x
                                  : (x * 1u) ^ (y * PRIME_Y) ^ (z * PRIME_Z);
  float wt = 1.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = ((c >> a) & 1) ? cell.frac[a]
                                   : __fsub_rn(1.0f, cell.frac[a]);
    wt = a == 0 ? f : __fmul_rn(wt, f);
  }
  *w = wt;
  return (size_t)(idx & (table_size - 1)) + (size_t)level * table_size;
}

// ---- K5f ----

constexpr int FWD_PTS = THREADS;             // points per block, one a thread

// clip((x − bbox_min)/span, 0, 1), as cell_of computes it
__device__ __forceinline__ float normalised(float x, float bbox_min,
                                            float span) {
  const float xn = __fdiv_rn(__fsub_rn(x, bbox_min), span);
  return fminf(fmaxf(xn, 0.0f), 1.0f);
}

// the cell of the normalised point xn [3] at resolution res: cell_of's
// operations after the normalisation
__device__ __forceinline__ Cell cell_at(const float* xn, int res,
                                        uint32_t table_size) {
  Cell cell;
  const float scale = (float)(res - 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v = __fmul_rn(xn[a], scale);
    const float lo = floorf(v);
    cell.frac[a] = __fsub_rn(v, lo);
    cell.lo[a] = (uint32_t)lo;
  }
  cell.rmax = (uint32_t)(res - 1);
  cell.dense = (unsigned long long)res * res * res <= table_size;
  return cell;
}

// an L2 policy under which the lines a load brings in are evicted last
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
      : "=l"(policy));
  return policy;
}

// rows 2k and 2k + 1 from p = row 2k (16-byte aligned), read-only,
// under `policy`
__device__ __forceinline__ float4 load_pair(const float2* p,
                                            unsigned long long policy) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// the row at p where `need`, else zeros: a predicated load (no branch,
// no request from the lanes that do not need it) into fresh registers,
// so that it waits on no earlier load
__device__ __forceinline__ float2 load_row_if(const float2* p, bool need,
                                              unsigned long long policy) {
  float2 v;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "mov.f32 %0, 0f00000000;\n\tmov.f32 %1, 0f00000000;\n\t"
      "@q ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%3], %4;\n\t}"
      : "=f"(v.x), "=f"(v.y)
      : "r"((int)need), "l"(p), "l"(policy));
  return v;
}

// the float2 slot of (point p, level) in a tile's [FWD_PTS][8] features:
// 16-byte chunk (level / 2) ^ ((p / 2) % 4), half (level % 2) ^ ((p / 8)
// % 2), so that the 8-byte writes of 16 consecutive points and the
// 16-byte reads of 2 points' 4 chunks fall on distinct banks
__device__ __forceinline__ int feat_slot(int p, int level) {
  return 8 * p + 2 * ((level >> 1) ^ ((p >> 1) & 3))
         + ((level & 1) ^ ((p >> 3) & 1));
}

// blockIdx.x = a tile of FWD_PTS consecutive points, a point per thread:
// warp w takes points 32w..32w + 31 through the 8 levels in turn, so the
// lanes of every load share a level
__global__ void __launch_bounds__(THREADS)
hash_fwd_kernel(const float2* __restrict__ table,
                const float* __restrict__ pts, float4* __restrict__ out,
                long long n_pts, uint32_t table_size, Resolutions res,
                float bbox_min, float bbox_max) {
  __shared__ float xn_s[3 * FWD_PTS];                 // [point][axis]
  __shared__ float4 feat_s[4 * FWD_PTS];              // feat_slot's layout
  const long long p0 = (long long)blockIdx.x * FWD_PTS;
  const int n = (int)min((long long)FWD_PTS, n_pts - p0);
  const float span = __fsub_rn(bbox_max, bbox_min);
  for (int i = threadIdx.x; i < 3 * n; i += THREADS)
    xn_s[i] = normalised(__ldcs(pts + 3 * p0 + i), bbox_min, span);
  __syncthreads();
  const int p = threadIdx.x;
  if (p < n) {
    const unsigned long long policy = evict_last_policy();
    float2* feat2 = reinterpret_cast<float2*>(feat_s);
    const float xn[3] = {xn_s[3 * p], xn_s[3 * p + 1], xn_s[3 * p + 2]};
#pragma unroll 1
    for (int level = 0; level < LEVELS; ++level) {
      const int r = res.r[level];
      const Cell cell = cell_at(xn, r, table_size);
      size_t row[8];
      float w[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        row[c] = corner(cell, c, r, level, table_size, &w[c]);
      // a level's rows start at an even row but at T = 1, where every
      // corner of a level is one row and no pair is joined
      float2 v[8];
#pragma unroll
      for (int c = 0; c < 8; c += 2) {
        const float4 q = load_pair(table + (row[c] & ~(size_t)1), policy);
        const bool joined = row[c + 1] == (row[c] ^ 1);
        const float2 b = load_row_if(table + row[c + 1], !joined, policy);
        const bool odd = row[c] & 1;
        v[c] = odd ? make_float2(q.z, q.w) : make_float2(q.x, q.y);
        v[c + 1] = !joined ? b
                   : odd   ? make_float2(q.x, q.y) : make_float2(q.z, q.w);
      }
      float2 acc = make_float2(__fmul_rn(v[0].x, w[0]),
                               __fmul_rn(v[0].y, w[0]));
#pragma unroll
      for (int c = 1; c < 8; ++c) {
        acc.x = __fadd_rn(acc.x, __fmul_rn(v[c].x, w[c]));
        acc.y = __fadd_rn(acc.y, __fmul_rn(v[c].y, w[c]));
      }
      feat2[feat_slot(p, level)] = acc;
    }
  }
  __syncthreads();
  // 16-byte chunk k of the tile's output: point k / 4, levels 2(k % 4) and
  // 2(k % 4) + 1
  for (int k = threadIdx.x; k < 4 * n; k += THREADS) {
    const int q = k >> 2;
    float4 f = feat_s[feat_slot(q, 2 * (k & 3)) >> 1];
    if ((q >> 3) & 1) f = make_float4(f.z, f.w, f.x, f.y);
    __stcs(out + 4 * p0 + k, f);
  }
}

// ---- K5b ----

constexpr int BWD_PTS = THREADS;       // points of one level per block
constexpr int SLOT_BITS = 12;          // 4096 slots for <= 2048 distinct rows
constexpr int SLOTS = 1 << SLOT_BITS;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr int BWD_SMEM = SLOTS * (4 + 2 * 8);   // keys, two u64 sums each
constexpr int COLS = LEVELS * 2;       // (level, feature) columns of dfeat

// the scale exponent of one (level, feature) column from its max |dfeat|
// (bits of a non-negative float) and the point count: the largest e with
// m·P·2^e < 2^61 (b = f·2^k with f in [0.5, 1), so b·2^(61-k) < 2^61)
__device__ __forceinline__ int fixed_exp(uint32_t max_bits, long long n_pts) {
  int k;
  frexp((double)__uint_as_float(max_bits) * (double)n_pts, &k);
  return 61 - k;
}

// m[c] = max over the points of |dfeat[p][c]| as float bits (zeroed by the
// wrapper); a grid-stride loop over float4s whose stride is a multiple of
// 4, so a thread always reads the same four columns
__global__ void __launch_bounds__(THREADS)
hash_bwd_max_kernel(const float4* __restrict__ dfeat, long long n4,
                    uint32_t* __restrict__ max_bits) {
  __shared__ uint32_t block_max[COLS];
  if (threadIdx.x < COLS) block_max[threadIdx.x] = 0u;
  __syncthreads();
  // maxima of |v| as bits: a non-negative float orders like its bits, and
  // a NaN's bits exceed infinity's, so a NaN cotangent is kept
  uint32_t m[4] = {0u, 0u, 0u, 0u};
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += stride) {
    const float4 v = dfeat[i];
    m[0] = max(m[0], __float_as_uint(v.x) & 0x7FFFFFFFu);
    m[1] = max(m[1], __float_as_uint(v.y) & 0x7FFFFFFFu);
    m[2] = max(m[2], __float_as_uint(v.z) & 0x7FFFFFFFu);
    m[3] = max(m[3], __float_as_uint(v.w) & 0x7FFFFFFFu);
  }
  const int group = threadIdx.x & 3;                 // columns 4·group + j
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t b = m[j];
    b = max(b, __shfl_xor_sync(0xFFFFFFFFu, b, 4));
    b = max(b, __shfl_xor_sync(0xFFFFFFFFu, b, 8));
    b = max(b, __shfl_xor_sync(0xFFFFFFFFu, b, 16));
    if ((threadIdx.x & 31) < 4) atomicMax(&block_max[4 * group + j], b);
  }
  __syncthreads();
  if (threadIdx.x < COLS) atomicMax(max_bits + threadIdx.x,
                                    block_max[threadIdx.x]);
}

// adds (qx, qy) into the slot of `key` (open addressing, linear probing;
// integer adds, so the order of the threads does not matter)
__device__ __forceinline__ void slot_add(uint32_t* keys,
                                         unsigned long long* sums,
                                         uint32_t key, long long qx,
                                         long long qy) {
  uint32_t h = (key * PRIME_Y) >> (32 - SLOT_BITS);
  while (true) {
    const uint32_t prev = atomicCAS(keys + h, EMPTY, key);
    if (prev == EMPTY || prev == key) {
      if (qx) atomicAdd(sums + 2 * h, (unsigned long long)qx);
      if (qy) atomicAdd(sums + 2 * h + 1, (unsigned long long)qy);
      return;
    }
    h = (h + 1) & (SLOTS - 1);
  }
}

// blockIdx.x = run of BWD_PTS points, blockIdx.y = level; acc [L·T][2]
// int64 (zeroed by the wrapper) += the fixed-point contributions
__global__ void __launch_bounds__(THREADS)
hash_bwd_kernel(const float2* __restrict__ dfeat,
                const float* __restrict__ pts,
                unsigned long long* __restrict__ acc,
                const uint32_t* __restrict__ max_bits, long long n_pts,
                uint32_t table_size, Resolutions res, float bbox_min,
                float bbox_max) {
  extern __shared__ uint32_t keys[];                  // [SLOTS]
  unsigned long long* sums =                          // [SLOTS][2]
      reinterpret_cast<unsigned long long*>(keys + SLOTS);
  const int level = blockIdx.y;
  for (int s = threadIdx.x; s < SLOTS; s += THREADS) {
    keys[s] = EMPTY;
    sums[2 * s] = 0ull;
    sums[2 * s + 1] = 0ull;
  }
  __syncthreads();
  const long long p = (long long)blockIdx.x * BWD_PTS + threadIdx.x;
  if (p < n_pts) {
    const float2 g = dfeat[p * LEVELS + level];
    if (g.x != 0.0f || g.y != 0.0f) {                 // else adds nothing
      const int ex = fixed_exp(max_bits[2 * level], n_pts);
      const int ey = fixed_exp(max_bits[2 * level + 1], n_pts);
      const int r = res.r[level];
      const Cell cell = cell_of(pts + 3 * p, r, table_size, bbox_min,
                                bbox_max);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float w;
        const size_t row = corner(cell, c, r, level, table_size, &w);
        const long long qx =
            __double2ll_rn(scalbn((double)__fmul_rn(w, g.x), ex));
        const long long qy =
            __double2ll_rn(scalbn((double)__fmul_rn(w, g.y), ey));
        if (qx || qy)
          slot_add(keys, sums, (uint32_t)(row - (size_t)level * table_size),
                   qx, qy);
      }
    }
  }
  __syncthreads();
  unsigned long long* lvl = acc + 2 * (size_t)level * table_size;
  for (int s = threadIdx.x; s < SLOTS; s += THREADS) {
    const uint32_t key = keys[s];
    if (key == EMPTY) continue;
    if (sums[2 * s]) atomicAdd(lvl + 2 * (size_t)key, sums[2 * s]);
    if (sums[2 * s + 1]) atomicAdd(lvl + 2 * (size_t)key + 1, sums[2 * s + 1]);
  }
}

// dtable[i] = float(acc[i]·2^-e) for the i-th float of [L·T][2]; a column
// whose max is not finite (a NaN or an infinite cotangent) gives NaN
__global__ void __launch_bounds__(THREADS)
hash_bwd_convert_kernel(const long long* __restrict__ acc,
                        const uint32_t* __restrict__ max_bits,
                        long long n_pts, long long table_size,
                        float* __restrict__ dtable) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= 2 * LEVELS * table_size) return;
  const int col = 2 * (int)(i / (2 * table_size)) + (int)(i & 1);
  const uint32_t m = max_bits[col];
  dtable[i] = m >= 0x7F800000u
                  ? __int_as_float(0x7FC00000)
                  : (float)scalbn((double)acc[i], -fixed_exp(m, n_pts));
}

int launch_check(long long n_pts, long long table_size, const int* res) {
  if (n_pts < 0 || table_size < 1 || (table_size & (table_size - 1))
      || table_size > (1LL << 31))
    return cudaErrorInvalidValue;
  for (int l = 0; l < LEVELS; ++l)
    if (res[l] < 2) return cudaErrorInvalidValue;
  return cudaSuccess;
}

Resolutions to_res(const int* res) {
  Resolutions r;
  for (int l = 0; l < LEVELS; ++l) r.r[l] = res[l];
  return r;
}

}  // namespace

extern "C" {

const char* hash_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5f on `stream`: out [n_pts][8][2] from table [8·table_size][2] and pts
// [n_pts][3]; res: the 8 level resolutions. Returns the cudaError_t.
int hash_fwd_launch(const float* table, const float* pts, float* out,
                    long long n_pts, long long table_size, const int* res,
                    float bbox_min, float bbox_max, void* stream) {
  int err = launch_check(n_pts, table_size, res);
  if (err != cudaSuccess || n_pts == 0) return err;
  hash_fwd_kernel<<<(unsigned)((n_pts + FWD_PTS - 1) / FWD_PTS), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(table), pts,
      reinterpret_cast<float4*>(out), n_pts, (uint32_t)table_size,
      to_res(res), bbox_min, bbox_max);
  return cudaGetLastError();
}

// K5b on `stream`: dtable [8·table_size][2] = the table gradient for
// dfeat [n_pts][8][2] and pts [n_pts][3]. Scratch, zeroed by the caller:
// acc [8·table_size][2] int64, max_bits [16] uint32.
int hash_bwd_launch(const float* dfeat, const float* pts, float* dtable,
                    long long* acc, unsigned int* max_bits, long long n_pts,
                    long long table_size, const int* res, float bbox_min,
                    float bbox_max, void* stream) {
  int err = launch_check(n_pts, table_size, res);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pts > 0) {
    const long long n4 = n_pts * LEVELS * 2 / 4;
    const long long max_blocks = (n4 + THREADS - 1) / THREADS;
    hash_bwd_max_kernel<<<(unsigned)(max_blocks < 264 ? max_blocks : 264),
                          THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(dfeat), n4, max_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(hash_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BWD_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((n_pts + BWD_PTS - 1) / BWD_PTS), LEVELS);
    hash_bwd_kernel<<<grid, THREADS, BWD_SMEM, s>>>(
        reinterpret_cast<const float2*>(dfeat), pts,
        reinterpret_cast<unsigned long long*>(acc), max_bits, n_pts,
        (uint32_t)table_size, to_res(res), bbox_min, bbox_max);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n = 2 * LEVELS * table_size;
  hash_bwd_convert_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                            0, s>>>(acc, max_bits, n_pts, table_size, dtable);
  return cudaGetLastError();
}

}  // extern "C"
