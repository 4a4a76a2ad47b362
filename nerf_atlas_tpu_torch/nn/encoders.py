"""Input encoders: positional sin/cos bands, random Fourier features, CP
factorized volumes and the NGP hash grid.

Counterpart of `nerf_atlas_tpu/nn/encoders.py` (the encoders PlainNeRF
and the VolSDF shape build). Every encoder maps [..., D] -> [..., size()].
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class PositionalEncoder(nn.Module):
  """Classic NeRF sin/cos frequency bands, dim-major:
  [sin(x_0 b_0..b_F), sin(x_1 b_0..), ..., cos(...)]."""

  def __init__(self, input_dims: int = 3, max_freq_log2: float = 5,
               min_freq_log2: float = 0.0, num_freqs: int = 6,
               log_sampling: bool = True, include_input: bool = False):
    super().__init__()
    self.input_dims = input_dims
    self.max_freq_log2 = max_freq_log2
    self.min_freq_log2 = min_freq_log2
    self.num_freqs = num_freqs
    self.log_sampling = log_sampling
    self.include_input = include_input

  def size(self) -> int:
    return self.input_dims * (2 * self.num_freqs + int(self.include_input))

  def freqs(self, device=None):
    if self.log_sampling:
      return 2.0 ** torch.linspace(self.min_freq_log2, self.max_freq_log2,
                                   self.num_freqs, device=device)
    return torch.linspace(1.0, 2.0 ** self.max_freq_log2, self.num_freqs,
                          device=device)

  def forward(self, x):
    xb = x[..., :, None] * self.freqs(x.device)            # [..., D, F]
    xb = xb.reshape(x.shape[:-1] + (-1,))
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    if self.include_input:
      enc = torch.cat([x, enc], dim=-1)
    return enc


TWO_PI = 2 * math.pi


def fourier_phases(x, B):
  """2π·(x·B) [..., F] for x [..., D] and B [D, F]: the dot as D explicit
  products summed in dimension order, then one multiply by 2π, each
  rounded on its own (the fused VolSDF kernels round the same operations
  in the same order; phases reach hundreds of radians, where one ulp
  moves sin by ~3e-5)."""
  xb = x[..., 0:1] * B[0]
  for d in range(1, B.shape[0]):
    xb = xb + x[..., d:d + 1] * B[d]
  return xb * TWO_PI


class FourierEncoder(nn.Module):
  """Random Gaussian Fourier features: [sin(2π·x·B) ‖ cos(2π·x·B)]. The
  frequency matrix B [input_dims, freqs], drawn N(0, sigma²), is a
  parameter that takes no gradient (the JAX encoder's stop_gradient)."""

  def __init__(self, input_dims: int = 3, freqs: int = 16,
               sigma: float = 1 << 5, device=None):
    super().__init__()
    self.input_dims = input_dims
    self.freqs = freqs
    self.sigma = sigma
    self.B = nn.Parameter(torch.zeros(input_dims, freqs, device=device),
                          requires_grad=False)

  def size(self) -> int:
    return 2 * self.freqs

  def reset_parameters(self, generator: torch.Generator):
    with torch.no_grad():
      self.B.copy_(torch.randn(self.B.shape, generator=generator)
                   * self.sigma)

  def forward(self, x):
    mapped = fourier_phases(x, self.B)
    return torch.cat([torch.sin(mapped), torch.cos(mapped)], dim=-1)


class CPEncoder(nn.Module):
  """Multi-resolution CP (CANDECOMP/PARAFAC) factorized feature volumes.

  Each level stores per-axis line tables `lines_{l}` [3, R, K]. A point's
  feature is, per axis, the linear interpolation of its line at
  xn·(R-1) (2 taps: idx = floor(xn·(R-1)) clamped at R-1, and idx+1
  clamped likewise); the three axis features multiply, and levels
  concatenate. This is exactly the JAX encoder's dense hat basis
  max(1 - |v - r|, 0), written as the gather a GPU does well.
  """

  def __init__(self, resolutions: Sequence[int] = (16, 32, 64, 128),
               rank: int = 8, bbox_min: float = -1.0, bbox_max: float = 1.0,
               device=None):
    super().__init__()
    self.resolutions = tuple(resolutions)
    self.rank = rank
    self.bbox_min = bbox_min
    self.bbox_max = bbox_max
    for li, r in enumerate(self.resolutions):
      self.register_parameter(
          f"lines_{li}",
          nn.Parameter(torch.zeros(3, r, rank, device=device)))

  def size(self) -> int:
    return len(self.resolutions) * self.rank

  def lines(self):
    return [getattr(self, f"lines_{li}")
            for li in range(len(self.resolutions))]

  def reset_parameters(self, generator: torch.Generator):
    with torch.no_grad():
      for lines in self.lines():
        lines.copy_(torch.randn(lines.shape, generator=generator) * 0.1)

  def forward(self, x):
    batch = x.shape[:-1]
    xn = (x.reshape(-1, 3) - self.bbox_min) / (self.bbox_max - self.bbox_min)
    xn = torch.clamp(xn, 0.0, 1.0)
    return cp_encode(xn, self.lines()).reshape(batch + (self.size(),))


def cp_encode(xn, lines: Sequence[torch.Tensor]):
  """Normalized points xn [N, 3] in [0, 1] and per-level line tables
  [3, R, K] -> features [N, levels·K] (see CPEncoder)."""
  feats = []
  for tab in lines:
    r = tab.shape[1]
    v = xn * (r - 1)                                        # [N, 3]
    i0 = torch.clamp(torch.floor(v), max=r - 1)
    frac = (v - i0)[..., None]                              # [N, 3, 1]
    i0 = i0.long()
    i1 = torch.clamp(i0 + 1, max=r - 1)
    level = None
    for axis in range(3):
      f = (tab[axis][i0[:, axis]] * (1.0 - frac[:, axis])
           + tab[axis][i1[:, axis]] * frac[:, axis])        # [N, K]
      level = f if level is None else level * f
    feats.append(level)
  return torch.cat(feats, dim=-1)


class HashEncoder(nn.Module):
  """Multi-resolution hash-grid encoder (Instant-NGP): 8 levels of 2
  features, resolutions round(16·2^i) up to 2048, bbox [-1, 1], and
  `table_size` entries per level (a power of two; 2^19 by default). The
  parameter `table` is [8·table_size, 2]. Dense levels whose full grid
  fits in the table are indexed directly, larger ones by the XOR-prime
  hash. The forward is the plain K5f (`hash_encode_reference`: the index
  math and `table[idx]`); the fused kernel paths call K5f/K5b on the
  table directly (`ops/kernels/hash_encode.py`)."""

  def __init__(self, table_size: int = 1 << 19, device=None):
    super().__init__()
    from ..ops.kernels import hash_encode as hk
    if table_size < 1 or table_size & (table_size - 1):
      raise ValueError(f"table_size must be a power of two, got {table_size}")
    self.table = nn.Parameter(torch.zeros(
        hk.LEVELS * table_size, hk.FEATURES, device=device))

  def size(self) -> int:
    from ..ops.kernels import hash_encode as hk
    return hk.LEVELS * hk.FEATURES

  def reset_parameters(self, generator: torch.Generator):
    """uniform(−1e-4, 1e-4), drawn on the CPU (encoders.py:214)."""
    with torch.no_grad():
      self.table.copy_((torch.rand(self.table.shape, generator=generator)
                        * 2 - 1) * 1e-4)

  def forward(self, x):
    from ..ops.kernels import hash_encode as hk
    batch = x.shape[:-1]
    out = hk.hash_encode_reference(self.table, x.reshape(-1, 3))
    return out.reshape(batch + (self.size(),))
