"""Volumetric integration: density→alpha, transmittance, weighted sums,
and sky/background models.

Counterpart of `nerf_atlas_tpu/ops/integrate.py`:
  - sigma = softplus(density - 1)  (or relu);
  - dists = diff(ts) with a 1e10 tail, clamped >= 1e-5, scaled by ||r_d||;
  - alpha = 1 - exp(-sigma * dists);
  - weights = alpha * exclusive_cumprod(1 - alpha + 1e-10) along samples;
  - image = sum_T weights * rgb  (+ background on leftover transmittance).
The sample axis T is last on density/ts/alpha/weights ([..., T]) and
second-to-last on per-sample features ([..., T, C]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def exclusive_cumprod(t, dim: int = -1):
  """Exclusive running product along `dim`: out[0]=1, out[i]=prod(t[:i])."""
  cp = torch.cumprod(t, dim=dim)
  one = torch.ones_like(cp.narrow(dim, 0, 1))
  return torch.cat([one, cp.narrow(dim, 0, cp.shape[dim] - 1)], dim=dim)


def dists_from_ts(ts, r_d=None):
  """Segment lengths between consecutive t samples, with an infinite tail.

  ts: [T] or [..., T]; r_d: optional [..., 3] (scales by direction norm so
  sigma is per-world-unit even for unnormalized directions).
  Returns [..., T] broadcastable against density.
  """
  end_val = torch.full_like(ts[..., :1], 1e10)
  dists = torch.cat([ts[..., 1:] - ts[..., :-1], end_val], dim=-1)
  dists = torch.clamp(dists, min=1e-5)
  if r_d is not None:
    dists = dists * torch.linalg.vector_norm(r_d, dim=-1, keepdim=True)
  return dists


def alpha_from_density(density, ts, r_d=None, *, softplus: bool = True):
  """density [..., T] -> (alpha [..., T], weights [..., T])."""
  sigma = F.softplus(density - 1) if softplus else F.relu(density)
  dists = dists_from_ts(ts, r_d)
  alpha = 1 - torch.exp(-sigma * dists)
  return alpha, alpha_composite(alpha)


def alpha_composite(alpha, dim: int = -1):
  """weights_i = alpha_i * prod_{j<i} (1 - alpha_j)."""
  return alpha * exclusive_cumprod(1.0 - alpha + 1e-10, dim=dim)


def volumetric_integrate(weights, other):
  """weights [..., T], other [..., T, C] -> [..., C]."""
  return torch.sum(weights[..., None] * other, dim=-2)


def depth_from_weights(weights, ts):
  """Expected termination depth along each ray: sum_T w * t."""
  return torch.sum(weights * ts.expand(weights.shape), dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# backgrounds: the leftover transmittance is 1 - sum of all-but-last
# weights; the last sample's weight is excluded because its bin is the
# infinite tail.
# ---------------------------------------------------------------------------

def leftover_transmittance(weights):
  return 1 - torch.sum(weights[..., :-1], dim=-1, keepdim=True)


def bg_black(weights):
  return torch.zeros(weights.shape[:-1] + (1,), dtype=weights.dtype,
                     device=weights.device)


def bg_white(weights):
  return leftover_transmittance(weights)


def bg_random(weights):
  """Black at eval; the training form (a random grey on the leftover
  transmittance) is `models.base.NeRFBase.sky_color`."""
  return bg_black(weights)


SKY_KINDS = {
    "black": bg_black,
    "white": bg_white,
    "random": bg_random,
}


def load_sky(kind: str):
  fn = SKY_KINDS.get(kind)
  if fn is None:
    raise NotImplementedError(f"Unknown bg kind {kind}")
  return fn
