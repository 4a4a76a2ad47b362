"""PlainNeRF: a density MLP emitting sigma + an intermediate feature, RGB
from a pluggable reflectance model.

Counterpart of `nerf_atlas_tpu/models/nerf.py:PlainNeRF`. TinyNeRF,
NeRFAE and CoarseFineNeRF arrive with ROADMAP Queue 1 #3, #9 and #8.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn import CPEncoder, HashEncoder, PositionalEncoder, SkipConnMLP
from ..refl import load_refl
from .base import NeRFBase, view_per_sample


class PlainNeRF(NeRFBase):
  """enc_kind selects the spatial encoder: "cp" (factorized feature
  volumes, the default), "hash" (the NGP hash grid, `table_size` entries
  per level; the JAX model's `enc_kwargs={"table_size": ...}`) or
  "posenc" (frequency encoding); cp and hash take the fused kernels.
  "ref-hash" and mip arrive with ROADMAP Queue 1 #7. The density MLP
  (256x5) and View (128x5) are built at the default widths; overriding
  them arrives with --ref-compat (ROADMAP Queue 1 #13)."""

  def __init__(self, refl_kind: str = "view", refl_space: str = "identity",
               enc_kind: str = "cp", table_size: Optional[int] = None,
               device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    if table_size is not None and enc_kind != "hash":
      raise NotImplementedError(
          f"table_size only configures enc_kind='hash', got {enc_kind}")
    if enc_kind == "cp":
      enc = CPEncoder(device=device)
    elif enc_kind == "hash":
      enc = HashEncoder(table_size=table_size or 1 << 19, device=device)
    elif enc_kind == "posenc":
      enc = PositionalEncoder(input_dims=3, max_freq_log2=6, num_freqs=10)
    elif enc_kind == "ref-hash":
      raise NotImplementedError(
          "enc kind ref-hash: the reference-exact RefHashEncoder arrives "
          "with ROADMAP Queue 1 #7")
    else:
      raise NotImplementedError(f"unknown enc kind {enc_kind}")
    self.refl_kind = refl_kind
    self.refl_space = refl_space
    self.enc_kind = enc_kind
    self.density_mlp = SkipConnMLP(
        in_size=3, out=1 + self.intermediate_size, enc=enc, num_layers=5,
        hidden_size=256, device=device)
    self.refl = load_refl(
        refl_kind, latent_size=self.intermediate_size,
        act=self.sigmoid_kind, space=refl_space, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.density_mlp.reset_parameters(generator)
    self.refl.reset_parameters(generator)

  def query(self, pts, view, train: bool = False,
            generator: Optional[torch.Generator] = None):
    out = self.density_mlp(pts)
    density = self.add_density_noise(out[..., 0], train, generator)
    rgb = self.refl(pts, view=view, latent=out[..., 1:])
    return density, rgb

  def forward(self, rays, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """train=True draws the ts jitter, the density noise and the random
    sky from `generator` (required then, on the rays' device)."""
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    density, rgb = self.query(pts, view_per_sample(r_d, self.steps), train,
                              generator)
    return self.finish(density, rgb, ts, r_d, train, generator=generator)
