"""SDF ray intersection: sphere marching, dense scan + bisection, secant.

Counterpart of `nerf_atlas_tpu/ops/march.py`. Every function takes
`sdf_fn`, which maps points [..., 3] to SDF values [...], and rays r_o,
r_d [..., 3]; the intersectors return (pts, hits, best_pos or dist,
throughput). The throughput is the minimum SDF value along the ray,
differentiable in the SDF's parameters: the silhouette (miss) signal of
masked training.

The dense scan evaluates all S + 1 points of a ray in one SDF call, and
the refinements are fixed-iteration loops over dense masked tensors (a
finished lane keeps its values), so every shape is static. The scan and
the refinements run without gradient; only the SDF at the scan's minimum
keeps a graph (a graph through the scan would hold S + 1 times the
activations).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _at(r_o, r_d, t):
  return r_o + t[..., None] * r_d


def throughput_with_sign_change(sdf_fn: Callable, r_o, r_d, near: float,
                                far: float, batch_size: int = 128,
                                generator: Optional[torch.Generator] = None):
  """Dense scan of S = batch_size points after `near` (and `near` itself)
  along each ray. Returns (tput [...], best_pos [..., 3], t_lo [...],
  t_hi [...], hits [...]): tput is the SDF at the scan's minimum,
  evaluated with gradient; (t_lo, t_hi) bracket the first sign change,
  and collapse to the far end where there is none (bisection is then a
  no-op under its mask). With `generator` the scan's extent grows by
  U(0, 2/S), as the reference jitters it."""
  max_t = far - near
  if generator is not None:
    max_t = max_t + torch.rand((), generator=generator,
                               device=generator.device).to(r_o.device) * (
                                   2.0 / batch_size)
  step = max_t / batch_size
  ts = near + step * torch.arange(1, batch_size + 1, dtype=r_o.dtype,
                                  device=r_o.device)               # [S]
  all_ts = torch.cat([torch.full_like(ts[:1], near), ts])         # [S+1]
  with torch.no_grad():
    pts = r_o[..., None, :] + ts[:, None] * r_d[..., None, :]      # [..., S, 3]
    sd0 = sdf_fn(r_o + near * r_d)
    all_sd = torch.cat([sd0[..., None], sdf_fn(pts)], dim=-1)     # [..., S+1]
    best_t = all_ts[torch.argmin(all_sd, dim=-1)]
    neg = all_sd < 0
    hits = torch.any(neg, dim=-1)
    first_neg = torch.argmax(neg.to(torch.uint8), dim=-1)  # first True
    first_neg = torch.where(hits, first_neg, all_sd.shape[-1] - 1)
    last_pos = torch.clamp(first_neg - 1, min=0)
  best_pos = _at(r_o, r_d, best_t)
  tput = sdf_fn(best_pos)                       # the differentiable path
  return tput, best_pos, all_ts[last_pos], all_ts[first_neg], hits


def throughput(sdf_fn, r_o, r_d, near: float, far: float,
               batch_size: int = 128, generator=None):
  """The minimum SDF along the ray and its position."""
  tput, best_pos, _, _, _ = throughput_with_sign_change(
      sdf_fn, r_o, r_d, near, far, batch_size, generator)
  return tput, best_pos


def bisection(sdf_fn, r_o, r_d, t_lo, t_hi, iters: int = 32,
              eps: float = 1e-6):
  """Masked bisection inside [t_lo, t_hi] (active where sdf(t_lo) > 0 >
  sdf(t_hi) and the bracket is wider than eps). Returns the points
  [..., 3] at the brackets' midpoints."""
  with torch.no_grad():
    lo, hi = t_lo, t_hi
    s_lo = sdf_fn(_at(r_o, r_d, lo))
    s_hi = sdf_fn(_at(r_o, r_d, hi))
    for _ in range(iters):
      active = ((hi - lo) > eps) & (s_lo > 0) & (s_hi < 0)
      mid = (lo + hi) / 2
      s_mid = sdf_fn(_at(r_o, r_d, mid))
      go_lo = active & (s_mid > 0)
      go_hi = active & (s_mid < 0)
      lo = torch.where(go_lo, mid, lo)
      s_lo = torch.where(go_lo, s_mid, s_lo)
      hi = torch.where(go_hi, mid, hi)
      s_hi = torch.where(go_hi, s_mid, s_hi)
  return _at(r_o, r_d, (lo + hi) / 2)


def _secant_z(lo, hi, sl, sh):
  denom = sh - sl
  denom = torch.where(torch.abs(denom) < 1e-10, torch.ones_like(denom),
                      denom)
  z = -sl * (hi - lo) / denom + lo
  return torch.clamp(z, torch.minimum(lo, hi), torch.maximum(lo, hi))


def secant_find(sdf_fn, r_o, r_d, t_lo, t_hi, iters: int = 32):
  """Masked secant refinement (IDR's), kept inside its bracket. Returns
  the points [..., 3]."""
  with torch.no_grad():
    lo, hi = t_lo, t_hi
    sl = sdf_fn(_at(r_o, r_d, lo))
    sh = sdf_fn(_at(r_o, r_d, hi))
    for _ in range(iters):
      z = _secant_z(lo, hi, sl, sh)
      s_mid = sdf_fn(_at(r_o, r_d, z))
      go_lo = s_mid > 0
      go_hi = s_mid < 0
      lo = torch.where(go_lo, z, lo)
      sl = torch.where(go_lo, s_mid, sl)
      hi = torch.where(go_hi, z, hi)
      sh = torch.where(go_hi, s_mid, sh)
    z = _secant_z(lo, hi, sl, sh)
  return _at(r_o, r_d, z)


def sphere_march(sdf_fn, r_o, r_d, iters: int = 32, eps: float = 1e-3,
                 near: float = 0.0, far: float = 1.0):
  """Sphere marching for a fixed number of steps: a ray hits where its SDF
  drops under eps before t passes far. Returns (pts [..., 3], hits [...],
  t [..., 1], None): no minimum-SDF track."""
  batch = r_o.shape[:-1]
  with torch.no_grad():
    t = torch.full(batch, near, dtype=r_o.dtype, device=r_o.device)
    hit = torch.zeros(batch, dtype=torch.bool, device=r_o.device)
    rem = torch.ones(batch, dtype=torch.bool, device=r_o.device)
    for _ in range(iters):
      d = sdf_fn(_at(r_o, r_d, t))
      hit = hit | (rem & (d < eps) & (t <= far))
      t = torch.where(rem, t + d, t)
      rem = rem & ~hit & (t <= far)
  return _at(r_o, r_d, t), hit, t[..., None], None


def bisect(sdf_fn, r_o, r_d, iters: int = 128, eps: float = 0.0,
           near: float = 0.0, far: float = 1.0, generator=None):
  """Dense scan + bisection (the reference's default intersector).
  Returns (pts, hits, best_pos, throughput [..., 1])."""
  del eps
  tput, best_pos, t_lo, t_hi, hits = throughput_with_sign_change(
      sdf_fn, r_o, r_d, near, far, batch_size=iters, generator=generator)
  pts = bisection(sdf_fn, r_o, r_d, t_lo, t_hi, iters=min(32, iters))
  return pts, hits, best_pos, tput[..., None]


def secant(sdf_fn, r_o, r_d, iters: int = 128, eps: float = 1e-3,
           near: float = 0.0, far: float = 1.0, generator=None):
  """Dense scan + secant refinement. Returns (pts, hits, best_pos,
  throughput [...])."""
  del eps
  tput, best_pos, t_lo, t_hi, hits = throughput_with_sign_change(
      sdf_fn, r_o, r_d, near, far, batch_size=iters, generator=generator)
  pts = secant_find(sdf_fn, r_o, r_d, t_lo, t_hi, iters=iters)
  return pts, hits, best_pos, tput


INTERSECTION_KINDS = {"sphere": sphere_march, "secant": secant,
                      "bisect": bisect}


def load_intersection_kind(kind: str):
  fn = INTERSECTION_KINDS.get(kind)
  if fn is None:
    raise NotImplementedError(f"unknown intersection kind {kind}")
  return fn
