"""Shared model machinery: render config, point sampling, compositing,
backgrounds.

Counterpart of `nerf_atlas_tpu/models/base.py`. Model contract:
  forward(rays [..., 6], train=False, generator=None)
      -> dict: rgb [..., 3], weights [..., T], ts, alpha.
  query(pts [..., 3], view [..., 3], ..., latent=None)
      -> (density [...], rgb [..., 3]).
Modules own their parameters; `reset_parameters(generator)` draws them
from an explicit `torch.Generator`. Training mode (train=True) draws the
stratified sample jitter, the density noise and the random sky colour
from `generator`, which lives on the rays' device. `mip` ("cone" or
"cylinder") makes `mip_encode` return MipNeRF's IPE features of each
sample's segment, which PlainNeRF feeds its density MLP in place of the
encoded point. `latent_size` is the width of the conditioning latent a
model's fields read beside their input (the dynamic wrappers' per-time
latent, `models/dyn.py`); 0 for none.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops import integrate, mip as mip_ops, rays as rays_ops
from ..ops.math import load_sigmoid

class NeRFBase(nn.Module):
  """Base class holding the common render configuration."""

  def __init__(self, steps: int = 64, t_near: float = 2.0,
               t_far: float = 6.0, mip: Optional[str] = None,
               sky_kind: str = "black", sigmoid_kind: str = "thin",
               intermediate_size: int = 32, per_ray_jitter: bool = False,
               lindisp: bool = False, density_noise: float = 0.0,
               latent_size: int = 0):
    super().__init__()
    mip_ops.load_mip(mip)       # raises on an unknown kind
    if sky_kind not in integrate.SKY_KINDS:
      raise NotImplementedError(
          f"sky kind {sky_kind}: the sky MLP arrives with ROADMAP Queue 1 "
          "#13")
    load_sigmoid(sigmoid_kind)  # raises on an unknown kind
    self.steps = steps
    self.t_near = t_near
    self.t_far = t_far
    self.mip = mip
    self.sky_kind = sky_kind
    self.sigmoid_kind = sigmoid_kind
    self.intermediate_size = intermediate_size
    self.per_ray_jitter = per_ray_jitter
    self.lindisp = lindisp
    self.density_noise = density_noise
    self.latent_size = latent_size

  # ---- helpers shared by all subclasses --------------------------------

  def sample_points(self, rays, train: bool,
                    generator: Optional[torch.Generator] = None):
    """Eval: the uniform grid. Train: stratified jitter inside the bins
    (one draw shared by all rays, or per ray with per_ray_jitter)."""
    return rays_ops.compute_pts_ts(
        rays, self.t_near, self.t_far, self.steps, lindisp=self.lindisp,
        perturb=1.0 if train else 0.0, generator=generator,
        per_ray_jitter=self.per_ray_jitter)

  def add_density_noise(self, density, train: bool,
                        generator: Optional[torch.Generator] = None):
    if train and self.density_noise > 0:
      density = density + self.density_noise * torch.randn(
          density.shape, generator=generator, dtype=density.dtype,
          device=density.device)
    return density

  def rgb_act(self, v):
    return load_sigmoid(self.sigmoid_kind)(v)

  def mip_encode(self, r_o, r_d, ts):
    """IPE features per sample [..., T, 96] when mip is set, else None
    (a constant radius of 1e-3, shared ts broadcast to every ray)."""
    if self.mip is None:
      return None
    return mip_ops.encode(self.mip, r_o, r_d, ts)

  def sky_color(self, weights, r_d, train: bool,
                generator: Optional[torch.Generator] = None):
    """Background contribution on leftover transmittance [..., 1]. The
    "random" sky is a uniform grey per ray in training, black at eval."""
    del r_d
    if train and self.sky_kind == "random":
      rem = integrate.leftover_transmittance(weights)
      return rem * torch.rand(rem.shape, generator=generator,
                              dtype=rem.dtype, device=rem.device)
    return integrate.load_sky(self.sky_kind)(weights)

  def finish(self, density, rgb, ts, r_d, train: bool,
             softplus: bool = True,
             generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """density [..., T], rgb [..., T, 3] -> composited output dict."""
    alpha, weights = integrate.alpha_from_density(density, ts, r_d,
                                                  softplus=softplus)
    img = integrate.volumetric_integrate(weights, rgb)
    img = img + self.sky_color(weights, r_d, train, generator)
    return dict(rgb=img, weights=weights, ts=ts, alpha=alpha)


def broadcast_latent(latents, pts_shape, latent_size: int):
  """An optional per-ray latent [..., L] broadcast to every sample
  [..., T, L]; None when there is none or the model reads none."""
  if latents is None or latent_size == 0:
    return None
  return latents[..., None, :].expand(tuple(pts_shape[:-1])
                                      + (latents.shape[-1],))


def view_per_sample(r_d, steps: int):
  """Ray direction broadcast to every sample: [..., T, 3]."""
  return r_d[..., None, :].expand(r_d.shape[:-1] + (steps, 3))
