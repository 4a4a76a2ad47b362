"""The regularizers the port's models carry: NeRFAE's latent L2, in its
two forms, VolSDF's eikonal and scale decay, and DynamicNeRF's delta-x.

Counterpart of `nerf_atlas_tpu/train/regularizers.py:latent_l2`,
`eikonal`, `delta_x`, `volsdf_scale`, `total_regularizer` and
`ae_latent_l2`; the other terms arrive with their models (ROADMAP Queue 1
#11, #13).
"""
from __future__ import annotations

from typing import Dict

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


REGULARIZERS = {"latent_l2": latent_l2, "eikonal": eikonal,
                "delta_x": delta_x, "volsdf_scale": volsdf_scale}


def total_regularizer(out, coeffs: Dict[str, float]):
  """Σ coeff·term(out) over the active coefficients of REGULARIZERS (the
  module-forward path's regularizer)."""
  total = 0.0
  for name, fn in REGULARIZERS.items():
    c = (coeffs or {}).get(name)
    if c:
      total = total + c * fn(out)
  return total


def uniform_points(generator: torch.Generator, n: int) -> torch.Tensor:
  """n points uniform in [−1.3, 1.3]³, drawn from `generator` on its
  device."""
  return torch.rand(n, 3, generator=generator,
                    device=generator.device) * 2.6 - 1.3


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
