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
// What bounds it: bytes. Each (point, level) reads 8 float2 table rows
// (64 B, scattered) and 12 B of its point, and writes 8 B (K5f) or adds
// into 8 rows (K5b). The table (32 MB at T = 2^19) fits in the 50 MB L2,
// so the gathers are mostly L2 hits at random addresses.
//
// K5f (simple and exact): one thread per (point, level), point-major
// (thread t: point t / 8, level t % 8), so the float2 output stores of a
// warp are contiguous; nothing is reused within a block, so no shared
// memory.
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

__global__ void __launch_bounds__(THREADS)
hash_fwd_kernel(const float2* __restrict__ table,
                const float* __restrict__ pts, float2* __restrict__ out,
                long long n_pts, uint32_t table_size, Resolutions res,
                float bbox_min, float bbox_max) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_pts * LEVELS) return;
  const long long p = t / LEVELS;
  const int level = (int)(t % LEVELS);
  const int r = res.r[level];
  const Cell cell = cell_of(pts + 3 * p, r, table_size, bbox_min, bbox_max);
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float w;
    const size_t row = corner(cell, c, r, level, table_size, &w);
    const float2 v = __ldg(table + row);
    const float2 contrib = make_float2(__fmul_rn(v.x, w), __fmul_rn(v.y, w));
    if (c == 0) {
      acc = contrib;
    } else {
      acc.x = __fadd_rn(acc.x, contrib.x);
      acc.y = __fadd_rn(acc.y, contrib.y);
    }
  }
  out[t] = acc;                                   // [p][level] float2
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
  const long long threads = n_pts * LEVELS;
  hash_fwd_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS,
                    0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(table), pts,
      reinterpret_cast<float2*>(out), n_pts, (uint32_t)table_size,
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
