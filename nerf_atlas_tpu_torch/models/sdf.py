"""SDF shape models: pts [..., 3] -> (sdf [...], latent [..., L]).

Counterpart of `nerf_atlas_tpu/models/sdf.py` for the shape VolSDF's
fused kernels serve: `MLP`, a Fourier-encoded SkipConnMLP with the
analytic unit-sphere bias. The other kinds (siren, curl-mlp, local,
spheres, triangles), the bounding `UnitSphere` and the `SDF` surface
renderer arrive with ROADMAP Queue 1 #10/#13.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import FourierEncoder, SkipConnMLP

# the JAX package's SDF kinds that the port does not build yet
_UNPORTED_KINDS = ("siren", "curl-mlp", "local", "spheres", "triangles")


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
    return torch.linalg.vector_norm(pts, dim=-1) - 1.0


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


SDF_KINDS = {"mlp": MLP}


def load_sdf_shape(kind: str, latent_out: int = 32, bounded: bool = False,
                   device=None, **kwargs) -> SDFModel:
  if bounded:
    raise NotImplementedError(
        "a bounded SDF (UnitSphere): not ported yet (ROADMAP Queue 1 #13)")
  ctor = SDF_KINDS.get(kind)
  if ctor is None:
    if kind in _UNPORTED_KINDS:
      raise NotImplementedError(
          f"sdf kind {kind}: not ported yet (ROADMAP Queue 1 #10/#13)")
    raise NotImplementedError(f"unknown sdf kind {kind}")
  return ctor(latent_out=latent_out, device=device, **kwargs)
