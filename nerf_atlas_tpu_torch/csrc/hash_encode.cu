// K5f / K5b: the NGP hash-grid lookup and its table gradient on Hopper.
//
// Replaces nerf_atlas_tpu/ops/pallas/hash_encode.py:_hash_fwd_kernel (K5f,
// called by _fwd_call) and :_hash_bwd_kernel (K5b, _bwd_call), for every
// power-of-two table size (the TPU kernels take T <= 2^16 only).
//   hash_fwd: table [L·T, 2] f32, pts [P, 3] f32 -> features [P, L·2] f32
//   hash_bwd: dfeat [P, L·2] f32, pts [P, 3] f32 -> += into dtable [L·T, 2]
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
// (64 B, scattered) and 12 B of its point, and writes 8 B (K5f) or 8 atomic
// float2 adds (K5b). The table (32 MB at T = 2^19) fits in the 50 MB L2,
// so the gathers are mostly L2 hits at random addresses; nothing is
// reused within a thread block, so there is no shared memory.
//
// Design (simple and exact, not yet fast): one thread per (point, level),
// point-major (thread t: point t / 8, level t % 8), so the float2 output
// stores of a warp are contiguous. K5b adds w·dfeat into the table
// gradient with float atomicAdd: the sum's order, and so its last bits,
// vary from run to run (the wrapper zeroes dtable first).
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

__global__ void __launch_bounds__(THREADS)
hash_bwd_kernel(const float2* __restrict__ dfeat,
                const float* __restrict__ pts, float* __restrict__ dtable,
                long long n_pts, uint32_t table_size, Resolutions res,
                float bbox_min, float bbox_max) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_pts * LEVELS) return;
  const long long p = t / LEVELS;
  const int level = (int)(t % LEVELS);
  const int r = res.r[level];
  const float2 g = dfeat[t];
  if (g.x == 0.0f && g.y == 0.0f) return;         // adds nothing
  const Cell cell = cell_of(pts + 3 * p, r, table_size, bbox_min, bbox_max);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float w;
    const size_t row = corner(cell, c, r, level, table_size, &w);
    atomicAdd(dtable + 2 * row, __fmul_rn(w, g.x));
    atomicAdd(dtable + 2 * row + 1, __fmul_rn(w, g.y));
  }
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

// K5b on `stream`: dtable [8·table_size][2] (zeroed by the caller) +=
// the table gradient for dfeat [n_pts][8][2] and pts [n_pts][3].
int hash_bwd_launch(const float* dfeat, const float* pts, float* dtable,
                    long long n_pts, long long table_size, const int* res,
                    float bbox_min, float bbox_max, void* stream) {
  int err = launch_check(n_pts, table_size, res);
  if (err != cudaSuccess || n_pts == 0) return err;
  const long long threads = n_pts * LEVELS;
  hash_bwd_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS,
                    0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(dfeat), pts, dtable, n_pts,
      (uint32_t)table_size, to_res(res), bbox_min, bbox_max);
  return cudaGetLastError();
}

}  // extern "C"
