"""VolSDF: volume rendering of a signed distance field.

Counterpart of `nerf_atlas_tpu/models/volsdf.py:VolSDF`: the density is
LaplaceCDF(−sdf, s)/s with a learned scale s, the SDF any shape of
`models/sdf.py`, the colour the View refl on the SDF's latent, and the
compositing takes the density as σ directly (relu, no softplus). With
`with_normals` the forward also returns the SDF's gradient at the sample
points (by autograd, differentiable again) and the eikonal residual.
`surface_render` renders the same SDF and refl at the surface bisection
finds (`--volsdf-alternate`'s other half). The occlusion, the
integrators and the lights arrive with ROADMAP Queue 1 #13.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import march
from ..ops.math import laplace_cdf
from ..refl import load_refl
from .base import NeRFBase, view_per_sample
from .sdf import load_sdf_shape, sdf_gradient

SCALE_KINDS = ("softplus", "ident")


class VolSDF(NeRFBase):
  """scale_kind "softplus": s = softplus(raw) + 1e-4, raw starting at
  −2.3 (the fused kernels serve this one); "ident": s = max(|raw|, 1e-4),
  raw starting at 0.1 (the reference's dynamics, --ref-compat). The raw
  scale is the 0-d parameter `density_scale`, the flax name."""

  def __init__(self, sdf_kind: str = "mlp", refl_kind: str = "view",
               occ_kind: Optional[str] = None,
               integrator_kind: Optional[str] = None,
               light_kind: Optional[str] = None, sdf_latent: int = 32,
               with_normals: bool = False, refl_kwargs=None,
               sdf_kwargs=None, scale_kind: str = "softplus", device=None,
               **base_kwargs):
    super().__init__(**base_kwargs)
    for name, value in (("occ_kind", occ_kind),
                        ("integrator_kind", integrator_kind),
                        ("light_kind", light_kind),
                        ("refl_kwargs", refl_kwargs)):
      if value:
        raise NotImplementedError(
            f"VolSDF {name}={value!r}: occlusion, integrators, lights and "
            "BRDF options are not ported yet (ROADMAP Queue 1 #13)")
    if scale_kind not in SCALE_KINDS:
      raise ValueError(f"scale_kind must be one of {SCALE_KINDS}")
    self.sdf_kind = sdf_kind
    self.refl_kind = refl_kind
    self.sdf_latent = sdf_latent
    self.with_normals = with_normals
    self.sdf_kwargs = dict(sdf_kwargs or {})
    self.scale_kind = scale_kind
    self.shape = load_sdf_shape(sdf_kind, latent_out=sdf_latent,
                                device=device, **self.sdf_kwargs)
    self.refl = load_refl(refl_kind, latent_size=sdf_latent,
                          act=self.sigmoid_kind, device=device)
    self.density_scale = nn.Parameter(torch.zeros((), device=device))
    self.reset_scale()

  def reset_scale(self):
    with torch.no_grad():
      self.density_scale.fill_(0.1 if self.scale_kind == "ident" else -2.3)

  def reset_parameters(self, generator: torch.Generator):
    self.shape.reset_parameters(generator)
    self.refl.reset_parameters(generator)
    self.reset_scale()

  def sdf_value(self, pts):
    return self.shape(pts)[0]

  def normals(self, pts):
    """∇ₓsdf by autograd (`sdf.sdf_gradient`)."""
    return sdf_gradient(self.sdf_value, pts)

  def density_params(self):
    """The learned Laplace scale s."""
    if self.scale_kind == "ident":
      return torch.clamp(torch.abs(self.density_scale), min=1e-4)
    return F.softplus(self.density_scale) + 1e-4

  def density_from_sdf(self, sdf_vals):
    scale = self.density_params()
    return laplace_cdf(-sdf_vals, scale) / scale

  def query(self, pts, view):
    """(density [...], rgb [..., 3], sdf [...], normals [..., 3] or None).
    The normals are ∇ₓsdf by autograd; when the caller records gradients
    they stay differentiable (the eikonal's second-order gradient)."""
    normals = None
    if self.with_normals:
      grad_on = torch.is_grad_enabled()
      with torch.enable_grad():
        if not pts.requires_grad:
          pts = pts.detach().requires_grad_(True)
        sdf_vals, latent = self.shape(pts)
        (normals,) = torch.autograd.grad(sdf_vals.sum(), pts,
                                         create_graph=grad_on)
      if not grad_on:
        sdf_vals, latent = sdf_vals.detach(), latent.detach()
    else:
      sdf_vals, latent = self.shape(pts)
    rgb = self.refl(pts, view=view, latent=latent)
    return self.density_from_sdf(sdf_vals), rgb, sdf_vals, normals

  def surface_render(self, rays, train: bool = False,
                     generator: Optional[torch.Generator] = None):
    """The surface render of the same SDF and refl (the other half of
    --volsdf-alternate): 32 scan steps and 32 bisections over [t_near,
    t_far], the refl at the points found with the shape's latent, black
    where a ray misses. Returns {"rgb", "hits", "throughput"}: the
    throughput is sigmoid(−500 · the minimum SDF along the ray) [..., 1],
    the differentiable silhouette."""
    del train, generator
    r_o, r_d = rays[..., :3], rays[..., 3:6]
    pts, hits, _, tput = march.bisect(self.sdf_value, r_o, r_d, iters=32,
                                      near=self.t_near, far=self.t_far)
    _, latent = self.shape(pts)
    n = self.normals(pts)
    view = r_d / torch.clamp(torch.linalg.vector_norm(r_d, dim=-1,
                                                      keepdim=True), min=1e-8)
    rgb = self.refl(pts, view=view, normal=n, latent=latent)
    rgb = torch.where(hits[..., None], rgb, torch.zeros_like(rgb))
    return {"rgb": rgb, "hits": hits,
            "throughput": torch.sigmoid(-500.0 * tput)}

  def forward(self, rays, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """The composited render dict (models/base.py) plus sdf_vals [..., T]
    and the scale s; with `with_normals` also normals [..., T, 3] and
    the eikonal, the mean over sample points of (‖∇ₓsdf‖ − 1)²."""
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    density, rgb, sdf_vals, normals = self.query(
        pts, view_per_sample(r_d, self.steps))
    out = self.finish(density, rgb, ts, r_d, train, softplus=False,
                      generator=generator)
    out["sdf_vals"] = sdf_vals
    out["scale"] = self.density_params()
    if normals is not None:
      out["normals"] = normals
      out["eikonal"] = torch.mean(torch.square(
          torch.linalg.vector_norm(normals, dim=-1) - 1.0))
    return out
