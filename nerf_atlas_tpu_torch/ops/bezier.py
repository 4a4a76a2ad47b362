"""Bezier spline kit: de Casteljau evaluation, derivatives, the cubic
closed form and the Bernstein weights.

Counterpart of `nerf_atlas_tpu/ops/bezier.py` (`de_casteljau`,
`bezier_derivative`, `frenet_normal`, `cubic_bezier`, `arc_len`). Control
points live on axis 0 ([N, ...]).
"""
from __future__ import annotations

import math
from typing import List

import torch

from .math import normalize


def de_casteljau(coeffs, t, N: int):
  """Evaluate a Bezier curve with N control points (axis 0) at t, by the
  repeated lerp betas[:-1]·(1 − t) + betas[1:]·t. t broadcasts against
  coeffs[i]; returns the shape of one control point."""
  betas = coeffs
  m1t = 1 - t
  for _ in range(1, N):
    betas = betas[:-1] * m1t + betas[1:] * t
  return betas.squeeze(0) if betas.shape[0] == 1 else betas


def bezier_derivative(coeffs, t, N: int, deriv: int = 1):
  """The `deriv`-th derivative of the Bezier curve at t (degree factor
  N − 1, as the JAX package)."""
  if deriv < 0:
    raise ValueError("Must take a positive number of derivatives")
  for _ in range(deriv):
    coeffs = (N - 1) * (coeffs[1:] - coeffs[:-1])
    N -= 1
  return de_casteljau(coeffs, t, N)


def frenet_normal(coeffs, t, N: int):
  """The Frenet normal of the curve at t (for rig-point orientation)."""
  a = normalize(bezier_derivative(coeffs, t, N))
  b = normalize(a + bezier_derivative(coeffs, t, N, deriv=2))
  r = normalize(torch.linalg.cross(a, b))
  return normalize(torch.linalg.cross(a, r))


def cubic_bezier(coeffs, t, N: int):
  """Closed-form cubic evaluation (N = 4)."""
  if N != 4:
    raise ValueError(f"Must be cubic, got {N}")
  m1t = 1 - t
  m1t_sq, t_sq = m1t * m1t, t * t
  k = torch.stack([m1t_sq * m1t, 3 * m1t_sq * t, 3 * t_sq * m1t, t_sq * t])
  if k.ndim < coeffs.ndim:
    k = k.reshape(k.shape + (1,) * (coeffs.ndim - k.ndim))
  return torch.sum(k * coeffs, dim=0)


def arc_len(ctrl_pts, samples: int = 16):
  """Arc length by piecewise-linear quadrature over `samples` uniform
  evaluations. ctrl_pts [N, ..., 3] -> [...]."""
  N = ctrl_pts.shape[0]
  t = torch.linspace(0.0, 1.0, samples, dtype=ctrl_pts.dtype,
                     device=ctrl_pts.device)
  t_shaped = t.reshape((1, samples) + (1,) * (ctrl_pts.ndim - 1))
  pts = de_casteljau(ctrl_pts[:, None], t_shaped, N)    # [samples, ..., 3]
  return torch.sum(torch.linalg.vector_norm(pts[1:] - pts[:-1], dim=-1),
                   dim=0)


def bernstein_weights(t, n: int) -> List[torch.Tensor]:
  """B_{j,n}(t) = C(n, j)·t^j·(1 − t)^{n−j} for j = 1..n: the weights of
  control points 1..n in the degree-n curve that `de_casteljau` evaluates
  (render_dyn.py `_bernstein_weights`; the fused backward scatters the
  cotangent of the curve into its control points with them)."""
  om = 1 - t
  tp, op = [t], [om]
  for _ in range(n - 1):
    tp.append(tp[-1] * t)
    op.append(op[-1] * om)
  out = []
  for j in range(1, n + 1):
    w = float(math.comb(n, j)) * tp[j - 1]
    if n - j > 0:
      w = w * op[n - j - 1]
    out.append(w)
  return out
