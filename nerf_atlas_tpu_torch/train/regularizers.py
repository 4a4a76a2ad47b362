"""The regularizers the port's models carry: NeRFAE's latent L2, in its
two forms.

Counterpart of `nerf_atlas_tpu/train/regularizers.py:latent_l2` and
`ae_latent_l2`; the other terms arrive with their models (ROADMAP Queue 1
#10, #11, #13).
"""
from __future__ import annotations

import torch


def latent_l2(out):
  """The module forward's latent L2 (NeRFAE's out["latent_l2"], the mean
  over sample points of ‖raw encoding‖²); 0 for a model without one."""
  return out.get("latent_l2", 0.0)


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
