"""The regularizers the port's models carry: NeRFAE's latent L2, in its
two forms, VolSDF's eikonal and scale decay, and the dynamic models'
delta-x, NR-NeRF offset, rigidity sparsity, divergence (Hutchinson and
FFJORD), spline length and spline point 0.

Counterpart of `nerf_atlas_tpu/train/regularizers.py:latent_l2`,
`eikonal`, `delta_x`, `offset_nrnerf`, `rigidity_sparsity`,
`volsdf_scale`, `total_regularizer`, `ae_latent_l2`, `dyn_divergence`,
`ffjord_div`, `spline_length`, `spline_pt0` and `point_regularizers`;
the other terms arrive with their models (ROADMAP Queue 1 #10, #13).
Two families: out-dict terms read the module forward's output dict
(`total_regularizer`); point-sampled terms evaluate the model at random
points (`point_regularizers`). A point-sampled term is two functions:
its draws from an explicit `torch.Generator` and its arithmetic on them,
so that the arithmetic can be fed another package's draws.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

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


REGULARIZERS = {"latent_l2": latent_l2, "eikonal": eikonal,
                "delta_x": delta_x, "offset": offset_nrnerf,
                "rigidity_sparsity": rigidity_sparsity,
                "volsdf_scale": volsdf_scale}


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
    "dyn_divergence": (divergence_draws, dyn_divergence),
    "ffjord_div": (divergence_draws, ffjord_div),
    "spline_length": (spline_draws, spline_length),
    "spline_pt0": (spline_draws, spline_pt0),
}


def point_regularizers(model, generator: torch.Generator,
                       coeffs: Dict[str, float]):
  """Σ coeff·term over the active point-sampled coefficients, in the
  order of `coeffs`, each term drawing from `generator` in turn;
  differentiable in the model's parameters by autograd."""
  total = 0.0
  for name, c in (coeffs or {}).items():
    if c and name in POINT_REGULARIZERS:
      draws, term = POINT_REGULARIZERS[name]
      total = total + c * term(model, *draws(generator))
  return total
