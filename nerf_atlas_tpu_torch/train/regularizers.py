"""The regularizers the port's models carry: NeRFAE's latent L2, in its
two forms, the SDF models' eikonal (on the ray samples, near the surface
and at random points), normal and surface smoothness and VolSDF's scale
decay, and the dynamic models' delta-x, NR-NeRF offset, rigidity
sparsity, divergence (Hutchinson and FFJORD), spline length and spline
point 0.

Counterpart of `nerf_atlas_tpu/train/regularizers.py:latent_l2`,
`eikonal`, `delta_x`, `offset_nrnerf`, `rigidity_sparsity`,
`volsdf_scale`, `surface_eikonal`, `total_regularizer`, `ae_latent_l2`,
`smooth_normals`, `eikonal_random`, `smooth_surface`, `dyn_divergence`,
`ffjord_div`, `spline_length`, `spline_pt0` and `point_regularizers`;
the other terms arrive with their models (ROADMAP Queue 1 #13: the
occlusion's `smooth_occ` and `occ_decay`, `view_variance`, the voxel
grids' TV terms, `weight_sparsity`). Two families: out-dict terms read
the module forward's output dict (`total_regularizer`); point-sampled
terms evaluate the model at random points (`point_regularizers`). A
point-sampled term is two functions: its draws from an explicit
`torch.Generator` and its arithmetic on them, so that the arithmetic can
be fed another package's draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def latent_l2(out):
  """The module forward's latent L2 (NeRFAE's out["latent_l2"], the mean
  over sample points of ‖raw encoding‖²); 0 for a model without one."""
  return out.get("latent_l2", 0.0)


def eikonal(out):
  """VolSDF's out["eikonal"] (the mean over sample points of
  (‖∇ₓsdf‖ − 1)², present with `with_normals`); 0 without."""
  return out.get("eikonal", 0.0)


def delta_x(out):
  """The mean squared deformation of a dynamic model's out["dp"] (D-NeRF's
  regularizer, --dp-weight); 0 without one."""
  dp = out.get("dp")
  return 0.0 if dp is None else torch.mean(torch.square(dp))


def volsdf_scale(out):
  """VolSDF's learned Laplace scale out["scale"]: its coefficient anneals
  the scale down (sharper surfaces)."""
  return out.get("scale", 0.0)


def offset_nrnerf(out):
  """NR-NeRF's offset loss: the mean of weights.detach() · (‖dp‖^(2 −
  rigidity) + 3e-3·rigidity), ‖dp‖² without a rigidity output; rigid
  points pay ~‖dp‖, free ones ‖dp‖². The norm is √(Σdp² + 1e-12): the warp
  starts at zero, where the exact norm's gradient is NaN."""
  dp, rig = out.get("dp"), out.get("rigidity")
  if dp is None:
    return 0.0
  norm = torch.sqrt(torch.sum(torch.square(dp), dim=-1, keepdim=True)
                    + 1e-12)
  val = torch.square(norm) if rig is None else norm ** (2.0 - rig) + 3e-3 * rig
  w = out.get("weights")
  if w is not None and w.shape == val.shape[:-1]:
    val = w.detach()[..., None] * val
  return torch.mean(val)


def rigidity_sparsity(out):
  """The mean |rigidity| of a dynamic model's out["rigidity"]; 0 without
  one."""
  r = out.get("rigidity")
  return 0.0 if r is None else torch.mean(torch.abs(r))


def surface_eikonal(out):
  """The eikonal weighted toward the surface: Σ w·(‖n‖ − 1)² / (Σ w +
  1e-8) over out["normals"] and out["weights"] (the rendering weights
  concentrate at the ray-surface crossings); 0 without either. For the
  SDF renderer, whose weights are [..., 1] and normals one per ray, the
  product broadcasts [N, 1] × [N] to [N, N], as in the JAX package."""
  n, w = out.get("normals"), out.get("weights")
  if n is None or w is None:
    return 0.0
  ei = torch.square(torch.linalg.vector_norm(n, dim=-1) - 1.0)
  return torch.sum(w * ei) / (torch.sum(w) + 1e-8)


REGULARIZERS = {"latent_l2": latent_l2, "eikonal": eikonal,
                "delta_x": delta_x, "offset": offset_nrnerf,
                "rigidity_sparsity": rigidity_sparsity,
                "volsdf_scale": volsdf_scale,
                "surface_eikonal": surface_eikonal}


def total_regularizer(out, coeffs: Dict[str, float]):
  """Σ coeff·term(out) over the active coefficients of REGULARIZERS (the
  module-forward path's regularizer; the point-sampled names are
  `point_regularizers`' and skipped here)."""
  total = 0.0
  for name, fn in REGULARIZERS.items():
    c = (coeffs or {}).get(name)
    if c:
      total = total + c * fn(out)
  return total


def uniform_points(generator: torch.Generator, n: int,
                   bound: float = 1.3) -> torch.Tensor:
  """n points uniform in [−bound, bound]³, drawn from `generator` on its
  device."""
  return (torch.rand(n, 3, generator=generator, device=generator.device)
          * (2 * bound) - bound)


def ae_latent_l2(model, generator: torch.Generator,
                 n: int = 1024) -> torch.Tensor:
  """The point-sampled latent L2 of the fused NeRFAE paths: the mean of
  ‖`model.encode_raw`‖² over n uniform points, differentiable in the
  encoder's parameters by autograd. The kernels do not emit the raw
  encoding, so the fused paths add this estimator of the same quantity
  outside them; the oracle path reads out["latent_l2"] on the ray
  samples instead (the two penalties differ in size, as in the JAX
  package)."""
  raw = model.encode_raw(uniform_points(generator, n))
  return torch.mean(torch.sum(torch.square(raw), dim=-1))


# ---- the SDF models' point-sampled terms (`normals`, `sdf_value`) ----

def smooth_draws(generator: torch.Generator, n: int = 512,
                 eps: float = 1e-2, eps_rng: bool = False
                 ) -> Tuple[torch.Tensor, ...]:
  """The smoothness terms' draws: points uniform in [−1, 1]³ [n, 3] and
  their offsets [n, 3], a unit gaussian direction times eps, or with
  `eps_rng` times U(0, eps) per point (--smooth-eps, --smooth-eps-rng)."""
  dev = generator.device
  pts = uniform_points(generator, n, 1.0)
  d = torch.randn(n, 3, generator=generator, device=dev)
  d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                      min=1e-8)
  r = (torch.rand(n, 1, generator=generator, device=dev) * eps if eps_rng
       else eps)
  return pts, d * r


def smooth_normals(model, pts, delta, ords=(2,)):
  """E‖n(x) − n(x + δ)‖ for each vector-norm order in `ords`
  (--smooth-n-ord), n = `model.normals`; order 2 as the mean of the
  squared differences' sum (the norm's square has a NaN gradient at 0)."""
  n0 = model.normals(pts)
  n1 = model.normals(pts + delta)
  total = 0.0
  for o in ords:
    if o == 2:
      total = total + torch.mean(torch.sum(torch.square(n0 - n1), dim=-1))
    else:
      total = total + torch.mean(torch.linalg.vector_norm(n0 - n1, ord=o,
                                                          dim=-1))
  return total


def eikonal_draws(generator: torch.Generator, n: int = 512
                  ) -> Tuple[torch.Tensor]:
  """The random eikonal's draw: points uniform in [−1.5, 1.5]³ [n, 3]."""
  return (uniform_points(generator, n, 1.5),)


def eikonal_random(model, pts):
  """The eikonal at random points: the mean of (‖∇ₓsdf‖ − 1)²
  (--eikonal-random-weight)."""
  g = model.normals(pts)
  return torch.mean(torch.square(torch.linalg.vector_norm(g, dim=-1) - 1.0))


def smooth_surface(model, pts, delta, sharp: float = 8.0):
  """Normal smoothness weighted toward the zero set: the mean of
  exp(−sharp·|sdf|) (the sdf without gradient) times ‖n(x) − n(x + δ)‖²
  (--smooth-surface-weight)."""
  w = torch.exp(-sharp * torch.abs(model.sdf_value(pts).detach()))
  n0 = model.normals(pts)
  n1 = model.normals(pts + delta)
  return torch.mean(w * torch.sum(torch.square(n0 - n1), dim=-1))


# ---- the dynamic models' point-sampled terms ----------------------------

def _delta_x(model):
  fn = getattr(model, "delta_x", None)
  if fn is None:
    raise NotImplementedError(
        f"{type(model).__name__} has no delta_x: the divergence and spline "
        "regularizers read a DynamicNeRF's or LongDynamicNeRF's "
        "deformation (the JAX package fails there too)")
  return fn


def divergence_draws(generator: torch.Generator, n: int = 512
                     ) -> Tuple[torch.Tensor, ...]:
  """The divergence terms' draws: points uniform in [−1, 1]³ [n, 3],
  times uniform in [0, 1) [n, 1], Rademacher signs [n, 3]."""
  dev = generator.device
  pts = uniform_points(generator, n, 1.0)
  t = torch.rand(n, 1, generator=generator, device=dev)
  eps = torch.randint(0, 2, (n, 3), generator=generator,
                      device=dev).float() * 2 - 1
  return pts, t, eps


def _hutchinson(model, pts, t, eps):
  """εᵀ J ε per point, J the Jacobian of `delta_x` in x at time t: the
  dot of ε with the vector-Jacobian product Jᵀε, kept in the graph
  (create_graph) so that the estimate is differentiable in the
  parameters."""
  pts = pts.detach().requires_grad_(True)
  with torch.enable_grad():
    dp = _delta_x(model)(pts, t)
    vjp, = torch.autograd.grad(dp, pts, grad_outputs=eps, create_graph=True)
  return torch.sum(eps * vjp, dim=-1)


def dyn_divergence(model, pts, t, eps):
  """Divergence penalty on the deformation field: the mean of the squared
  Hutchinson estimate (εᵀ J ε)² (--dyn-divergence-weight)."""
  return torch.mean(torch.square(_hutchinson(model, pts, t, eps)))


def ffjord_div(model, pts, t, eps):
  """FFJORD's stochastic divergence: the mean |εᵀ J ε|, the first moment
  (--ffjord-div-decay)."""
  return torch.mean(torch.abs(_hutchinson(model, pts, t, eps)))


def spline_draws(generator: torch.Generator, n: int = 256
                 ) -> Tuple[torch.Tensor]:
  """The spline terms' draw: points uniform in [−1, 1]³ [n, 3]."""
  return (uniform_points(generator, n, 1.0),)


def spline_length(model, pts, t_samples: int = 8):
  """The length of each point's deformation path over t_samples uniform
  times in [0, 1], its segments' norms √(Σ² + 1e-12) (the warp starts at
  zero), summed per point and averaged (--spline-len-decay)."""
  # the JAX package's linspace: iota times the float32 step (torch's
  # rounds two of the eight times another way)
  ts = (torch.arange(t_samples, dtype=torch.float32, device=pts.device)
        * (1.0 / (t_samples - 1)))
  ptsb = pts.expand((t_samples,) + pts.shape)
  tb = ts[:, None, None].expand((t_samples, pts.shape[0], 1))
  dp = _delta_x(model)(ptsb, tb)
  seg = torch.sqrt(torch.sum(torch.square(dp[1:] - dp[:-1]), dim=-1)
                   + 1e-12)
  return torch.mean(torch.sum(seg, dim=0))


def spline_pt0(model, pts):
  """The mean squared deformation at t = 0 (the canonical frame is t = 0;
  --spline-pt0-decay)."""
  dp0 = _delta_x(model)(pts, torch.zeros(pts.shape[0], 1,
                                         device=pts.device))
  return torch.mean(torch.square(dp0))


# name -> (draws from a generator, the term on the model and those draws)
POINT_REGULARIZERS: Dict[str, Tuple[Callable, Callable]] = {
    "smooth_normals": (smooth_draws, smooth_normals),
    "eikonal_random": (eikonal_draws, eikonal_random),
    "smooth_surface": (smooth_draws, smooth_surface),
    "dyn_divergence": (divergence_draws, dyn_divergence),
    "ffjord_div": (divergence_draws, ffjord_div),
    "spline_length": (spline_draws, spline_length),
    "spline_pt0": (spline_draws, spline_pt0),
}


# the terms that take the smoothing options (--smooth-eps, --smooth-eps-rng,
# --smooth-n-ord): "ords" goes to the term, the others to its draws
_SMOOTH_REGS = {"smooth_normals": ("eps", "eps_rng", "ords"),
                "smooth_surface": ("eps", "eps_rng")}


def point_regularizers(model, generator: torch.Generator,
                       coeffs: Dict[str, float],
                       smooth_opts: Optional[Dict] = None):
  """Σ coeff·term over the active point-sampled coefficients, in the
  order of `coeffs`, each term drawing from `generator` in turn;
  differentiable in the model's parameters by autograd. `smooth_opts`
  ({"eps", "eps_rng", "ords"}) reach the smoothness terms."""
  total = 0.0
  for name, c in (coeffs or {}).items():
    if c and name in POINT_REGULARIZERS:
      draws, term = POINT_REGULARIZERS[name]
      opts = {k: smooth_opts[k] for k in _SMOOTH_REGS.get(name, ())
              if smooth_opts and k in smooth_opts}
      ords = {"ords": opts.pop("ords")} if "ords" in opts else {}
      total = total + c * term(model, *draws(generator, **opts), **ords)
  return total
