"""SDF shape models and the SDF surface renderer.

Counterpart of `nerf_atlas_tpu/models/sdf.py`. Every shape maps pts
[..., 3] to (sdf [...], latent [..., L]); `value(pts)` is the sdf alone
(the function handed to the marchers) and `normals(pts)` its gradient in
pts by autograd, differentiable again when the caller records gradients
(the eikonal's second order). The kinds: `MLP` (the shape VolSDF's
kernels serve), `SIREN`, `CurlMLP`, `Local`, `SmoothedSpheres` and
`Triangles`; `UnitSphere` bounds any of them by a sphere. `SDF` renders
the surface a marcher finds (`--model sdf`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import FourierEncoder, SkipConnMLP
from ..ops import march
from ..ops.math import smooth_min
from ..refl import load_refl


def _norm(v):
  return torch.linalg.vector_norm(v, dim=-1)


def sdf_gradient(value_fn, pts):
  """∇ₓ Σ value_fn(pts) by autograd, also under no_grad. When the caller
  records gradients it stays in the graph (create_graph), else it comes
  back detached."""
  grad_on = torch.is_grad_enabled()
  with torch.enable_grad():
    p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(value_fn(p).sum(), p, create_graph=grad_on)
  return g


class SDFModel(nn.Module):
  """Base: the latent width and the sphere init. sphere_init adds the
  analytic ‖p‖ − 1 to the field, so that it starts as a unit sphere."""

  def __init__(self, latent_out: int = 32, sphere_init: bool = True):
    super().__init__()
    self.latent_out = latent_out
    self.sphere_init = sphere_init

  def sphere_bias(self, pts):
    if not self.sphere_init:
      return 0.0
    return _norm(pts) - 1.0

  def value(self, pts):
    return self(pts)[0]

  def normals(self, pts):
    return sdf_gradient(self.value, pts)


class MLP(SDFModel):
  """Fourier-encoded MLP SDF: 32 frequencies at sigma 4 (the fused VolSDF
  kernels' envelope) into a 256×6 SkipConnMLP with 1 + latent_out
  outputs; the SDF is output 0 plus the sphere bias, the latent the
  rest. The encoder sits at `mlp.enc` (the JAX tree keeps it at
  `shape/FourierEncoder_0`, beside `shape/mlp`; `convert` maps it)."""

  def __init__(self, latent_out: int = 32, sphere_init: bool = True,
               enc_freqs: int = 32, enc_sigma: float = 4.0, device=None):
    super().__init__(latent_out, sphere_init)
    self.mlp = SkipConnMLP(
        in_size=3, out=1 + latent_out,
        enc=FourierEncoder(input_dims=3, freqs=enc_freqs, sigma=enc_sigma,
                           device=device),
        num_layers=6, hidden_size=256, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.mlp.reset_parameters(generator)

  def forward(self, pts):
    out = self.mlp(pts)
    return out[..., 0] + self.sphere_bias(pts), out[..., 1:]


class SIREN(SDFModel):
  """A siren SkipConnMLP (256×5) on the raw points, plus the sphere
  bias."""

  def __init__(self, latent_out: int = 32, sphere_init: bool = True,
               device=None):
    super().__init__(latent_out, sphere_init)
    self.mlp = SkipConnMLP(in_size=3, out=1 + latent_out, init_kind="siren",
                           num_layers=5, hidden_size=256, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.mlp.reset_parameters(generator)

  def forward(self, pts):
    out = self.mlp(pts)
    return out[..., 0] + self.sphere_bias(pts), out[..., 1:]


class CurlMLP(SDFModel):
  """tanh(F)·‖∇F‖ / max(‖∇F‖, 1), F the Fourier-encoded MLP's output 0
  plus ‖p‖ − 1 (whatever sphere_init says): |∇sdf| ≈ 1 near the zero set
  without an eikonal loss. ∇F comes by autograd inside the forward, so
  the normals are second order and an eikonal third."""

  def __init__(self, latent_out: int = 32, sphere_init: bool = True,
               device=None):
    super().__init__(latent_out, sphere_init)
    self.mlp = SkipConnMLP(
        in_size=3, out=1 + latent_out,
        enc=FourierEncoder(input_dims=3, freqs=32, sigma=4.0, device=device),
        num_layers=5, hidden_size=256, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.mlp.reset_parameters(generator)

  def forward(self, pts):
    grad_on = torch.is_grad_enabled()
    with torch.enable_grad():
      p = pts if pts.requires_grad else pts.detach().requires_grad_(True)
      out = self.mlp(p)
      f = out[..., 0] + _norm(p) - 1.0
      (g,) = torch.autograd.grad(f.sum(), p, create_graph=grad_on)
    if not grad_on:
      out, f = out.detach(), f.detach()
    gn = _norm(g)
    return torch.tanh(f) * gn / torch.clamp(gn, min=1.0), out[..., 1:]


class Local(SDFModel):
  """Space cut into `partitions`³ cells: a 64×2 MLP on the cell's corner
  gives a 32-wide latent to a Fourier-encoded 128×4 MLP on the point's
  place inside its cell, plus ‖p‖ − 1. The fine MLP's encoder sits at
  `fine.enc` (JAX: `shape/FourierEncoder_0`; `convert` maps it)."""

  def __init__(self, latent_out: int = 32, sphere_init: bool = True,
               partitions: int = 4, device=None):
    super().__init__(latent_out, sphere_init)
    self.partitions = partitions
    self.coarse = SkipConnMLP(in_size=3, out=32, num_layers=2,
                              hidden_size=64, device=device)
    self.fine = SkipConnMLP(
        in_size=3, out=1 + latent_out, latent_size=32,
        enc=FourierEncoder(input_dims=3, freqs=16, sigma=2.0, device=device),
        num_layers=4, hidden_size=128, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.coarse.reset_parameters(generator)
    self.fine.reset_parameters(generator)

  def forward(self, pts):
    scaled = (pts + 1) * 0.5 * self.partitions
    cell = torch.floor(scaled)
    local = scaled - cell
    coarse = self.coarse(cell / self.partitions)
    out = self.fine(local * 2 - 1, coarse)
    return out[..., 0] + _norm(pts) - 1.0, out[..., 1:]


class SmoothedSpheres(SDFModel):
  """The smooth min (k = 32) of n learnable spheres (centers N(0, 0.3²),
  radii softplus(0.2)) plus 0.1·tanh of a zero-initialized 128×3 residual
  MLP, whose other outputs are the latent."""

  def __init__(self, latent_out: int = 32, sphere_init: bool = True,
               n_spheres: int = 16, device=None):
    super().__init__(latent_out, sphere_init)
    self.centers = nn.Parameter(torch.zeros(n_spheres, 3, device=device))
    self.radii = nn.Parameter(torch.zeros(n_spheres, device=device))
    self.resid = SkipConnMLP(in_size=3, out=1 + latent_out, num_layers=3,
                             hidden_size=128, zero_last=True, device=device)

  def reset_parameters(self, generator: torch.Generator):
    with torch.no_grad():
      self.centers.copy_(torch.randn(self.centers.shape, generator=generator)
                         * 0.3)
      self.radii.fill_(0.2)
    self.resid.reset_parameters(generator)

  def forward(self, pts):
    d = _norm(pts[..., None, :] - self.centers) - F.softplus(self.radii)
    base = smooth_min(torch.movedim(d, -1, 0), k=32.0, dim=0)
    resid = self.resid(pts)
    return base + 0.1 * torch.tanh(resid[..., 0]), resid[..., 1:]


def point_triangle_dist(pts, tris):
  """The exact unsigned distance from pts [..., 3] to triangles [K, 3, 3]
  -> [..., K], in the JAX function's operations (its 1e-12 guards and
  clips), so that gradients match as well as values."""
  a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
  p = pts[..., None, :]
  ab, ac, ap = b - a, c - a, p - a
  d1 = torch.sum(ab * ap, -1)
  d2 = torch.sum(ac * ap, -1)
  bp = p - b
  d3 = torch.sum(ab * bp, -1)
  d4 = torch.sum(ac * bp, -1)
  cp = p - c
  d5 = torch.sum(ab * cp, -1)
  d6 = torch.sum(ac * cp, -1)
  # the face projection holds where all barycentric weights are positive;
  # the three edge projections cover every boundary and vertex region
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  total = va + vb + vc
  denom = torch.where(torch.abs(total) < 1e-12,
                      torch.full_like(total, 1e-12), total)
  v = vb / denom
  w = vc / denom
  inside = (va >= 0) & (vb >= 0) & (vc >= 0)
  face = a + v[..., None] * ab + w[..., None] * ac

  def seg(p0, e):
    t = torch.clamp(torch.sum((p - p0) * e, -1)
                    / torch.clamp(torch.sum(e * e, -1), min=1e-12), 0, 1)
    return p0 + t[..., None] * e

  edges = torch.stack([seg(a, ab), seg(a, ac), seg(b, c - b)], -2)
  edge_d = torch.min(_norm(p[..., None, :] - edges), -1).values
  face_d = _norm(p - face)
  return torch.where(inside, torch.minimum(face_d, edge_d), edge_d)


class Triangles(SDFModel):
  """The smooth min (k = 32) of the distances to n learnable triangles
  (vertices N(0, 0.4²)) less 0.02: an unsigned surface; the latent is 0."""

  def __init__(self, latent_out: int = 32, sphere_init: bool = True,
               n_triangles: int = 16, device=None):
    super().__init__(latent_out, sphere_init)
    self.tris = nn.Parameter(torch.zeros(n_triangles, 3, 3, device=device))

  def reset_parameters(self, generator: torch.Generator):
    with torch.no_grad():
      self.tris.copy_(torch.randn(self.tris.shape, generator=generator) * 0.4)

  def forward(self, pts):
    d = point_triangle_dist(pts, self.tris) - 0.02
    sd = smooth_min(torch.movedim(d, -1, 0), k=32.0, dim=0)
    return sd, pts.new_zeros(pts.shape[:-1] + (self.latent_out,))


class UnitSphere(SDFModel):
  """An inner shape (`inner`) intersected with a sphere of `radius`:
  max(sdf, ‖p‖ − radius)."""

  def __init__(self, inner_kind: str = "mlp", radius: float = 1.5,
               latent_out: int = 32, sphere_init: bool = True, device=None):
    super().__init__(latent_out, sphere_init)
    self.radius = radius
    self.inner = _shape_kind(inner_kind)(latent_out=latent_out,
                                         sphere_init=sphere_init,
                                         device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.inner.reset_parameters(generator)

  def forward(self, pts):
    sd, latent = self.inner(pts)
    return torch.maximum(sd, _norm(pts) - self.radius), latent


SDF_KINDS = {"mlp": MLP, "siren": SIREN, "curl-mlp": CurlMLP, "local": Local,
             "spheres": SmoothedSpheres, "triangles": Triangles}


def _shape_kind(kind: str):
  ctor = SDF_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(f"unknown sdf kind {kind}")
  return ctor


def load_sdf_shape(kind: str, latent_out: int = 32, bounded: bool = False,
                   bound_radius: float = 1.5, device=None,
                   **kwargs) -> SDFModel:
  """The shape of `kind`; `bounded` wraps it in a UnitSphere of
  `bound_radius`, which passes on `sphere_init` alone (as the JAX
  package does)."""
  if bounded:
    return UnitSphere(inner_kind=kind, radius=bound_radius,
                      latent_out=latent_out,
                      sphere_init=kwargs.get("sphere_init", True),
                      device=device)
  return _shape_kind(kind)(latent_out=latent_out, device=device, **kwargs)


class SDF(nn.Module):
  """The SDF surface renderer (`--model sdf`): a marcher
  (`march.INTERSECTION_KINDS[isect_kind]`, march_steps scan steps over
  [t_near, t_far]) finds each ray's surface point, the refl shades it
  with the shape's latent and normal, and rays that miss are black. The
  silhouette is differentiable: sil_logit = −alpha · (the minimum SDF
  along the ray; for sphere marching the SDF at the march's end), its
  sigmoid the throughput and the weights. The outputs: rgb [..., 3], hits
  [...], pts and normals [..., 3], sil_logit, throughput and weights
  [..., 1].

  `eval_chunk` bounds `driver.render_view`'s chunk: the scan evaluates
  the shape at march_steps + 1 points a ray, so 16384 rays are 2.1M
  points at the default 128 steps (~10 GB of the MLP's activations
  without a graph, ~30 GB for CurlMLP's, whose forward keeps one)."""
  eval_chunk = 16384

  def __init__(self, sdf_kind: str = "mlp", refl_kind: str = "view",
               isect_kind: str = "bisect", latent_out: int = 32,
               t_near: float = 0.0, t_far: float = 6.0,
               march_steps: int = 128, sigmoid_kind: str = "thin",
               bounded: bool = True, bound_radius: float = 1.5,
               alpha: float = 500.0, refl_kwargs=None, sdf_kwargs=None,
               device=None):
    super().__init__()
    if refl_kwargs:
      raise NotImplementedError(
          f"SDF refl_kwargs={refl_kwargs!r}: the BRDF options are not ported "
          "yet (ROADMAP Queue 1 #13)")
    march.load_intersection_kind(isect_kind)
    self.sdf_kind = sdf_kind
    self.refl_kind = refl_kind
    self.isect_kind = isect_kind
    self.latent_out = latent_out
    self.t_near = t_near
    self.t_far = t_far
    self.march_steps = march_steps
    self.sigmoid_kind = sigmoid_kind
    self.bounded = bounded
    self.bound_radius = bound_radius
    self.alpha = alpha
    self.shape = load_sdf_shape(sdf_kind, latent_out=latent_out,
                                bounded=bounded, bound_radius=bound_radius,
                                device=device, **(sdf_kwargs or {}))
    self.refl = load_refl(refl_kind, latent_size=latent_out,
                          act=sigmoid_kind, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.shape.reset_parameters(generator)
    self.refl.reset_parameters(generator)

  def value(self, pts):
    return self.shape(pts)[0]

  def normals(self, pts):
    return sdf_gradient(self.value, pts)

  def forward(self, rays, train: bool = False,
              generator: Optional[torch.Generator] = None):
    del train, generator                       # the marchers draw nothing
    r_o, r_d = rays[..., :3], rays[..., 3:6]
    isect = march.INTERSECTION_KINDS[self.isect_kind]
    pts, hits, best_pos, tput = isect(self.value, r_o, r_d,
                                      iters=self.march_steps,
                                      near=self.t_near, far=self.t_far)
    if tput is None:
      # sphere marching keeps no minimum: the miss signal is the SDF at
      # the march's end points
      tput = self.value(pts)[..., None]
    elif tput.ndim == r_o.ndim - 1:
      tput = tput[..., None]
    _, latent = self.shape(pts)
    n = self.normals(pts)
    view = r_d / torch.clamp(_norm(r_d)[..., None], min=1e-8)
    rgb = self.refl(pts, view=view, normal=n, latent=latent)
    rgb = torch.where(hits[..., None], rgb, torch.zeros_like(rgb))
    # the driver supervises sil_logit with a sigmoid BCE: at alpha 500 the
    # sigmoid saturates for |min sdf| > ~0.01, where an l2 on it has no
    # gradient
    sil_logit = -self.alpha * tput
    throughput = torch.sigmoid(sil_logit)
    return dict(rgb=rgb, hits=hits, pts=pts, normals=n, sil_logit=sil_logit,
                throughput=throughput, weights=throughput)
