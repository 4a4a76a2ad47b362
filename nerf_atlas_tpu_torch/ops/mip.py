"""MipNeRF integrated positional encoding (IPE).

Counterpart of `nerf_atlas_tpu/ops/mip.py`: casts each ray segment as a
conic frustum (or cylinder), fits a Gaussian, and computes E[sin] of the
positionally-encoded Gaussian. Segments live on the trailing sample axis
(t0/t1 are [..., T]) and outputs are [..., T, 2·(max_deg − min_deg)·3];
`radii` is an explicit argument (the models use a constant 1e-3).

Every operation is written in the order the fused kernels
(csrc/render_common.cuh `ipe_moments`, `ipe_rows`) round it: the sum of
squares of r_d as (x² + y²) + z², squares as products, the cosine half
as sin(y + π/2) (the JAX module's form, not cos(y)). The kernels and
this plain version then agree to the last bit on every phase, which at
the 2^15 scale is what keeps them within float32 round-off of each other.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


def expected_sin(x, x_var):
  """E[sin(z)], Var[sin(z)] for z ~ N(x, x_var)."""
  y = torch.exp(-0.5 * x_var) * torch.sin(x)
  y_var = torch.clamp(
      0.5 * (1 - torch.exp(-2 * x_var) * torch.cos(2 * x)) - y * y, min=0.0)
  return y, y_var


def lift_gaussian(r_d, t_mean, t_var, r_var):
  """Lift a 1-D Gaussian along the ray to a 3-D diagonal Gaussian.

  r_d: [..., 3]; t_mean/t_var/r_var: [..., T].
  Returns (mean [..., T, 3], cov_diag [..., T, 3]).
  """
  mean = t_mean[..., :, None] * r_d[..., None, :]
  outer_diag = r_d * r_d
  magn_sq = torch.clamp(
      outer_diag[..., 0] + outer_diag[..., 1] + outer_diag[..., 2],
      min=1e-10)[..., None]
  null_outer_diag = 1 - outer_diag / magn_sq
  t_cov_diag = t_var[..., :, None] * outer_diag[..., None, :]
  xy_cov_diag = r_var[..., :, None] * null_outer_diag[..., None, :]
  return mean, t_cov_diag + xy_cov_diag


def conical_frustum_to_gaussian(r_d, t0, t1, rad):
  """Gaussian fit of the conic frustum between t0 and t1 with base radius
  rad (MipNeRF's closed form: t_var = hw²/3 − …)."""
  mu = (t1 + t0) / 2
  hw = (t1 - t0) / 2
  mu2 = mu * mu
  hw2 = hw * hw
  hw4 = hw2 * hw2
  denom = 3 * mu2 + hw2
  t_mean = mu + (2 * mu * hw2) / denom
  t_var = hw2 / 3 - (4 / 15) * ((hw4 * (12 * mu2 - hw2)) / (denom * denom))
  r_var = rad * rad * (mu2 / 4 + (5 / 12) * hw2 - (4 / 15) * hw4 / denom)
  return lift_gaussian(r_d, t_mean, t_var, r_var)


def cylinder_to_gaussian(r_d, t0, t1, rad):
  t_mean = (t1 + t0) / 2
  r_var = rad * rad / 4
  d = t1 - t0
  t_var = d * d / 12
  return lift_gaussian(r_d, t_mean, t_var, r_var)


def ipe_scales(min_deg: int, max_deg: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
  """The IPE scales 2^min_deg..2^(max_deg-1), exact powers of two (as the
  kernels multiply by them)."""
  return 2.0 ** torch.arange(min_deg, max_deg, dtype=dtype, device=device)


def integrated_pos_enc_diag(x, x_cov, min_deg: int, max_deg: int):
  """IPE features: E[sin] at 2^min_deg..2^(max_deg-1) scales, sin+cos
  pairs, scale-major / axis-minor.

  x, x_cov: [..., 3] -> [..., 2·(max_deg − min_deg)·3].
  """
  scales = ipe_scales(min_deg, max_deg, x.dtype, x.device)
  shape = x.shape[:-1] + (-1,)
  y = (x[..., None, :] * scales[:, None]).reshape(shape)
  y_var = (x_cov[..., None, :] * (scales * scales)[:, None]).reshape(shape)
  return expected_sin(
      torch.cat([y, y + 0.5 * math.pi], dim=-1),
      torch.cat([y_var, y_var], dim=-1),
  )[0]


def pixel_radii(focal, dtype=torch.float32):
  """Per-pixel cone base radius for a pinhole camera with `focal` (in px):
  adjacent ray directions differ by ~1/focal; MipNeRF scales by
  2/sqrt(12)."""
  return torch.as_tensor(focal, dtype=dtype) ** -1 * (2.0 / math.sqrt(12.0))


def radii_from_dirs(r_d_grid):
  """Footprint from an image grid of directions: the finite difference
  along the x axis of [..., H, W, 3]. Returns [..., H, W, 1]."""
  dx = torch.sqrt(torch.sum(
      (r_d_grid[..., :-1, :, :] - r_d_grid[..., 1:, :, :]) ** 2, dim=-1))
  dx = torch.cat([dx, dx[..., -2:-1, :]], dim=-2)
  return dx[..., None] * 2 / math.sqrt(12)


@dataclass(frozen=True)
class ConicGaussian:
  """Cone-footprint IPE; call with rays + segment bounds."""
  min_deg: int = 0
  max_deg: int = 16

  def size(self) -> int:
    return self.max_deg - self.min_deg

  def __call__(self, r_o, r_d, t0, t1, rad):
    mean, cov = conical_frustum_to_gaussian(r_d, t0, t1, rad)
    mean = mean + r_o[..., None, :]
    return integrated_pos_enc_diag(mean, cov, self.min_deg, self.max_deg)


@dataclass(frozen=True)
class CylinderGaussian:
  min_deg: int = 0
  max_deg: int = 16

  def size(self) -> int:
    return self.max_deg - self.min_deg

  def __call__(self, r_o, r_d, t0, t1, rad):
    mean, cov = cylinder_to_gaussian(r_d, t0, t1, rad)
    mean = mean + r_o[..., None, :]
    return integrated_pos_enc_diag(mean, cov, self.min_deg, self.max_deg)


def load_mip(kind):
  """kind: None | 'cone' | 'cylinder'."""
  if kind is None:
    return None
  if kind == "cone":
    return ConicGaussian()
  if kind == "cylinder":
    return CylinderGaussian()
  raise NotImplementedError(f"Unknown mip kind {kind}")


def mip_segments(ts):
  """Segment bounds (t0, t1) for IPE from sample ts [..., T]. The tail
  segment reuses the last finite width (clamped at 1e-5), not the 1e10
  tail of the compositing, which would overflow the frustum's variance
  in float32."""
  last_dt = ts[..., -1:] - ts[..., -2:-1]
  end_val = ts[..., -1:] + torch.clamp(last_dt, min=1e-5)
  ts_ext = torch.cat([ts, end_val], dim=-1)
  return ts_ext[..., :-1], ts_ext[..., 1:]


def encode(kind: str, r_o, r_d, ts, radius: float = 1e-3):
  """The IPE features the models feed their density MLP (JAX
  `NeRFBase.mip_encode`): r_o, r_d [N, 3] and ts [T] (shared, broadcast
  to every ray) or [N, T] -> [N, T, 96] at the constant radius."""
  if ts.ndim == 1:
    ts = ts.expand(r_o.shape[:-1] + ts.shape)
  t0, t1 = mip_segments(ts)
  return load_mip(kind)(r_o, r_d, t0, t1, torch.full_like(t0, radius))
