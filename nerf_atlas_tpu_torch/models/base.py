"""Shared model machinery: render config, point sampling, compositing,
backgrounds.

Counterpart of `nerf_atlas_tpu/models/base.py`. Model contract:
  forward(rays [..., 6], train=False)
      -> dict: rgb [..., 3], weights [..., T], ts, alpha.
  query(pts [..., 3], view [..., 3]) -> (density [...], rgb [..., 3]).
Modules own their parameters; `reset_parameters(generator)` draws them
from an explicit `torch.Generator`. Training-mode sampling (stratified
jitter, density noise, random sky) arrives with the training slice
(ROADMAP Queue 1 #5); latent-conditioned models with Queue 1 #9/#11.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from torch import nn

from ..ops import integrate, rays as rays_ops
from ..ops.math import load_sigmoid

_TRAINING = ("training mode: arrives with the training slice (ROADMAP "
             "Queue 1 #5)")


class NeRFBase(nn.Module):
  """Base class holding the common render configuration."""

  def __init__(self, steps: int = 64, t_near: float = 2.0,
               t_far: float = 6.0, mip: Optional[str] = None,
               sky_kind: str = "black", sigmoid_kind: str = "thin",
               intermediate_size: int = 32, per_ray_jitter: bool = False,
               lindisp: bool = False):
    super().__init__()
    if mip is not None:
      raise NotImplementedError(
          f"mip {mip}: the IPE encoders arrive with ROADMAP Queue 1 #7")
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

  # ---- helpers shared by all subclasses --------------------------------

  def sample_points(self, rays, train: bool):
    if train:
      raise NotImplementedError(_TRAINING)
    return rays_ops.compute_pts_ts(
        rays, self.t_near, self.t_far, self.steps, lindisp=self.lindisp,
        per_ray_jitter=self.per_ray_jitter)

  def sky_color(self, weights, r_d, train: bool):
    """Background contribution on leftover transmittance [..., 1]."""
    del r_d
    if train:
      raise NotImplementedError(_TRAINING)
    return integrate.load_sky(self.sky_kind)(weights)

  def finish(self, density, rgb, ts, r_d, train: bool,
             softplus: bool = True) -> Dict[str, Any]:
    """density [..., T], rgb [..., T, 3] -> composited output dict."""
    alpha, weights = integrate.alpha_from_density(density, ts, r_d,
                                                  softplus=softplus)
    img = integrate.volumetric_integrate(weights, rgb)
    img = img + self.sky_color(weights, r_d, train)
    return dict(rgb=img, weights=weights, ts=ts, alpha=alpha)


def view_per_sample(r_d, steps: int):
  """Ray direction broadcast to every sample: [..., T, 3]."""
  return r_d[..., None, :].expand(r_d.shape[:-1] + (steps, 3))
