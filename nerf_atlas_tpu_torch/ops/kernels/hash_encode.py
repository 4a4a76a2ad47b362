"""K5f and K5b: the NGP hash-grid lookup and its table gradient.

Counterparts of `nerf_atlas_tpu/ops/pallas/hash_encode.py`:
- `hash_encode` (K5f, kernel body `_hash_fwd_kernel`) launches
  `csrc/hash_encode.cu:hash_fwd_kernel`; `hash_encode_reference` is its
  plain torch (the index math and `table[idx]`, as
  `nerf_atlas_tpu.nn.HashEncoder` computes it).
- `hash_encode_table_grad` (K5b, `_hash_bwd_kernel`) launches
  `hash_bwd_kernel`; `hash_encode_table_grad_reference` is an
  `index_add_` per level and corner.
- `HashEncode` is the autograd Function K5f forward / K5b backward
  (`_make_hash_encode`): the gradient reaches the table only, points get
  none.
Each wrapper launches its kernel for points on the GPU (and raises if it
cannot) and takes its plain version for points on the CPU.

The encoder: 8 levels of F = 2 features, resolutions round(16·2^i) (base
16, max 2048), bbox [-1, 1], T entries per level (any power of two).
Per (point, level): normalize to the bbox and clip to [0, 1], scale by
res − 1, floor; the 8 corners (corner c pairs bits (c&1, c>>1&1, c>>2&1)
with (x, y, z)) clamp at res − 1 and index densely when res³ ≤ T, else
by the XOR-prime hash in uint32, then & (T − 1) plus the level offset
l·T; the trilinear weights multiply in x, y, z order and the corners sum
in order c = 0..7. Output columns are level-major, l·F + f. The table is
[L·T, F] float32 (`HashEncoder`'s layout and precision).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Iterator, List, Tuple

import torch

LEVELS = 8
FEATURES = 2
BASE_RES = 16
MAX_RES = 2048
BBOX = (-1.0, 1.0)
# NGP hash primes (public constants from the Instant-NGP paper)
PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def resolutions() -> List[int]:
  """The geometric resolution schedule of `HashEncoder`: round(16·g^i)."""
  growth = math.exp((math.log(MAX_RES) - math.log(BASE_RES)) / (LEVELS - 1))
  return [int(round(BASE_RES * growth ** i)) for i in range(LEVELS)]


def _table_size(table: torch.Tensor) -> int:
  if (table.dtype != torch.float32 or table.ndim != 2
      or table.shape[1] != FEATURES or table.shape[0] % LEVELS):
    raise ValueError(f"table must be float32 [{LEVELS}·T, {FEATURES}], got "
                     f"{table.dtype} {tuple(table.shape)}")
  size = table.shape[0] // LEVELS
  if size < 1 or size & (size - 1):
    raise ValueError(f"table size per level must be a power of two, got "
                     f"{size}")
  return size


def _corners(pts: torch.Tensor, table_size: int
             ) -> Iterator[Tuple[int, int, torch.Tensor, torch.Tensor]]:
  """(level, corner, row index [P] int64 incl. the level offset, weight
  [P] f32) for every level and corner, as `HashEncoder` computes them
  (uint32 products wrap: int64 masked to 32 bits)."""
  xn = torch.clamp((pts - BBOX[0]) / (BBOX[1] - BBOX[0]), 0.0, 1.0)
  for li, r in enumerate(resolutions()):
    v = xn * float(r - 1)
    lo = torch.floor(v)
    frac = v - lo
    lo = lo.long()
    dense = r ** 3 <= table_size
    for c in range(8):
      bits = (c & 1, (c >> 1) & 1, (c >> 2) & 1)
      cx, cy, cz = (torch.clamp(lo[:, a] + bits[a], max=r - 1)
                    for a in range(3))
      if dense:
        idx = (cz * r + cy) * r + cx
      else:
        idx = (((cx * PRIMES[0]) & _U32) ^ ((cy * PRIMES[1]) & _U32)
               ^ ((cz * PRIMES[2]) & _U32))
      idx = (idx & (table_size - 1)) + li * table_size
      w = None
      for a in range(3):
        f = frac[:, a] if bits[a] else 1 - frac[:, a]
        w = f if w is None else w * f
      yield li, c, idx, w


def _check_pts(pts: torch.Tensor, table: torch.Tensor):
  if pts.dtype != torch.float32 or pts.ndim != 2 or pts.shape[1] != 3:
    raise ValueError(f"pts must be float32 [P, 3], got {pts.dtype} "
                     f"{tuple(pts.shape)}")
  if pts.device != table.device:
    raise ValueError(f"pts on {pts.device}, table on {table.device}")


def hash_encode_reference(table: torch.Tensor, pts: torch.Tensor
                          ) -> torch.Tensor:
  """Plain K5f: table [L·T, F], pts [P, 3] -> features [P, L·F] on any
  device, differentiable in the table (torch's gather)."""
  table_size = _table_size(table)
  _check_pts(pts, table)
  levels = [None] * LEVELS
  for li, _, idx, w in _corners(pts, table_size):
    contrib = table[idx] * w[:, None]
    levels[li] = contrib if levels[li] is None else levels[li] + contrib
  return torch.cat(levels, dim=-1)


def hash_encode_table_grad_reference(pts: torch.Tensor, dfeat: torch.Tensor,
                                     table_size: int) -> torch.Tensor:
  """Plain K5b: d(Σ dfeat·features)/d table [L·T, F] for pts [P, 3] and
  the feature cotangent dfeat [P, L·F]."""
  dtable = torch.zeros(LEVELS * table_size, FEATURES, dtype=torch.float32,
                       device=pts.device)
  for li, _, idx, w in _corners(pts, table_size):
    dtable.index_add_(0, idx, w[:, None]
                      * dfeat[:, li * FEATURES:(li + 1) * FEATURES])
  return dtable


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
  """Build (at first use) and bind csrc/hash_encode.cu."""
  from . import build
  lib = build.load("hash_encode")
  args = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int * LEVELS, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_void_p])
  for fn in (lib.hash_fwd_launch, lib.hash_bwd_launch):
    fn.argtypes = args
    fn.restype = ctypes.c_int
  lib.hash_encode_error_string.argtypes = [ctypes.c_int]
  lib.hash_encode_error_string.restype = ctypes.c_char_p
  return lib


def _launch(name: str, a: torch.Tensor, pts: torch.Tensor, out: torch.Tensor,
            table_size: int):
  """One hash_fwd / hash_bwd launch on the current stream."""
  if pts.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu, not {pts.device}")
  for t, what in ((a, "input"), (pts, "pts")):
    if not t.is_contiguous():
      raise ValueError(f"{name}: {what} must be contiguous")
  if a.data_ptr() % 8 or out.data_ptr() % 8:
    raise ValueError(f"{name}: the float2 rows must be 8-byte aligned")
  lib = _load_library()
  res = (ctypes.c_int * LEVELS)(*resolutions())
  stream = torch.cuda.current_stream(pts.device).cuda_stream
  err = getattr(lib, f"{name}_launch")(
      a.data_ptr(), pts.data_ptr(), out.data_ptr(), pts.shape[0], table_size,
      res, BBOX[0], BBOX[1], stream)
  if err != 0:
    msg = lib.hash_encode_error_string(err).decode()
    raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def hash_encode(table: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
  """K5f: table [8·T, 2] f32, pts [P, 3] f32 -> features [P, 16] f32.
  CUDA points launch csrc/hash_encode.cu (each launch adds one to
  `hash_encode.launches`); CPU points take `hash_encode_reference`. Not
  differentiable: `HashEncode` is."""
  if pts.device.type == "cpu":
    return hash_encode_reference(table, pts)
  table_size = _table_size(table)
  _check_pts(pts, table)
  out = torch.empty(pts.shape[0], LEVELS * FEATURES, dtype=torch.float32,
                    device=pts.device)
  if pts.shape[0]:
    _launch("hash_fwd", table.detach(), pts, out, table_size)
    hash_encode.launches += 1
  return out


hash_encode.launches = 0


def hash_encode_table_grad(pts: torch.Tensor, dfeat: torch.Tensor,
                           table_size: int) -> torch.Tensor:
  """K5b: the table gradient [8·T, 2] for pts [P, 3] and the feature
  cotangent dfeat [P, 16]. CUDA points launch csrc/hash_encode.cu (float
  atomics: the sum's order, and so its last bits, vary from run to run;
  each launch adds one to `hash_encode_table_grad.launches`); CPU points
  take `hash_encode_table_grad_reference`."""
  if (dfeat.dtype != torch.float32
      or tuple(dfeat.shape) != (pts.shape[0], LEVELS * FEATURES)
      or dfeat.device != pts.device):
    raise ValueError(f"dfeat must be float32 [{pts.shape[0]}, "
                     f"{LEVELS * FEATURES}] on {pts.device}, got "
                     f"{dfeat.dtype} {tuple(dfeat.shape)} on {dfeat.device}")
  if pts.device.type == "cpu":
    return hash_encode_table_grad_reference(pts, dfeat, table_size)
  if table_size < 1 or table_size & (table_size - 1):
    raise ValueError(f"table size must be a power of two, got {table_size}")
  dtable = torch.zeros(LEVELS * table_size, FEATURES, dtype=torch.float32,
                       device=pts.device)
  _check_pts(pts, dtable)
  if pts.shape[0]:
    _launch("hash_bwd", dfeat, pts, dtable, table_size)
    hash_encode_table_grad.launches += 1
  return dtable


hash_encode_table_grad.launches = 0


class HashEncode(torch.autograd.Function):
  """K5f forward, K5b backward: (table [8·T, 2], pts [P, 3]) -> [P, 16].
  The gradient reaches the table only; pts get none."""

  @staticmethod
  def forward(ctx, table, pts):
    ctx.save_for_backward(pts)
    ctx.table_size = _table_size(table)
    return hash_encode(table.detach(), pts)

  @staticmethod
  def backward(ctx, g):
    (pts,) = ctx.saved_tensors
    return hash_encode_table_grad(pts, g.contiguous(), ctx.table_size), None
