"""Hierarchical (inverse-CDF) importance sampling along rays.

Counterpart of `nerf_atlas_tpu/ops/sampling.py` (`sample_pdf`, `merge_ts`):
build a CDF over the coarse samples' weights, invert it at u, and
interpolate linearly inside the bins. The JAX package's TPU forms (the
compare-reduce searchsorted, the triangular-matmul cumsum, the
rank-counting sort and merge) are exact rewrites of the sort/gather forms
for Mosaic; the port has the sort/gather forms only.
"""
from __future__ import annotations

from typing import Optional

import torch


def linspace_u(n: int, batch_shape=(), dtype=torch.float32,
               device=None) -> torch.Tensor:
  """The deterministic u: linspace(0, 1, n) rounded as jnp.linspace
  rounds it (i · fl(1/(n − 1)), the last entry exactly 1), broadcast to
  batch_shape + [n]."""
  u = torch.arange(n, dtype=dtype, device=device) * (1.0 / max(n - 1, 1))
  if n > 1:
    u[-1] = 1.0
  return u.expand(tuple(batch_shape) + (n,))


def uniform_u(batch_shape, n: int, generator: torch.Generator,
              dtype=torch.float32, device=None) -> torch.Tensor:
  """The stratified-random u: uniform [0, 1) of batch_shape + [n] from
  `generator` (which lives on `device`)."""
  return torch.rand(tuple(batch_shape) + (n,), generator=generator,
                    dtype=dtype, device=device)


def pdf_cdf(weights: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  """The CDF [..., T + 1] (a leading 0) of the piecewise-constant PDF of
  importance weights [..., T] + eps, normalized per ray."""
  weights = weights + eps
  pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
  cdf = torch.cumsum(pdf, dim=-1)
  return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def invert_cdf(z_vals: torch.Tensor, cdf: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
  """The samples at u [..., N] of the inverse of `cdf` [..., T + 1]
  (`pdf_cdf`) over the bins of z_vals [..., T] (sorted; the last bin is
  z's last value, of zero width): searchsorted on the right, the bin's
  two ends gathered, a bin under 1e-5 of mass read as mass 1, linear
  inside the bin; sorted along the last axis.

  The inverse is steep where a bin holds little mass and jumps at u = 1
  and at bins under the 1e-5 rule, so two float32 CDFs a round-off apart
  (another summation order) can give samples far more than a round-off
  apart there."""
  z_ext = torch.cat([z_vals, z_vals[..., -1:]], dim=-1)
  u = u.expand(cdf.shape[:-1] + u.shape[-1:]).contiguous()
  inds = torch.searchsorted(cdf.contiguous(), u, right=True)
  below = torch.clamp(inds - 1, min=0)
  above = torch.clamp(inds, max=cdf.shape[-1] - 1)
  cdf_below = torch.gather(cdf, -1, below)
  cdf_above = torch.gather(cdf, -1, above)
  z_below = torch.gather(z_ext, -1, below)
  z_above = torch.gather(z_ext, -1, above)
  denom = cdf_above - cdf_below
  denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
  t = (u - cdf_below) / denom
  return torch.sort(z_below + t * (z_above - z_below), dim=-1).values


def sample_pdf(z_vals: torch.Tensor, weights: torch.Tensor, n: int = 64, *,
               generator: Optional[torch.Generator] = None,
               eps: float = 1e-5) -> torch.Tensor:
  """Draw n samples per ray from the piecewise-constant PDF over the bins
  of z_vals [..., T] (sorted) with importance weights [..., T]: u from
  `generator` (stratified-random, `uniform_u`) or, without one, the
  deterministic `linspace_u`. Returns samples [..., n], sorted."""
  batch = z_vals.shape[:-1]
  if generator is None:
    u = linspace_u(n, batch, z_vals.dtype, z_vals.device)
  else:
    u = uniform_u(batch, n, generator, z_vals.dtype, z_vals.device)
  return invert_cdf(z_vals, pdf_cdf(weights, eps), u)


def merge_ts(coarse_ts: torch.Tensor, fine_ts: torch.Tensor) -> torch.Tensor:
  """The union of the coarse [T] or [..., T] and fine [..., N] samples,
  sorted per ray: [..., T + N]."""
  if coarse_ts.ndim == 1:
    coarse_ts = coarse_ts.expand(fine_ts.shape[:-1] + coarse_ts.shape)
  return torch.sort(torch.cat([coarse_ts, fine_ts], dim=-1), dim=-1).values
