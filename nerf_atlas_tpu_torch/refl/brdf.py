"""Reflectance models: the view-dependent siren MLP the main path uses.

Counterpart of `nerf_atlas_tpu/refl/brdf.py`. Call contract:
`refl(x, view=None, normal=None, light=None, latent=None) -> rgb
[..., out]`. The other BRDF kinds arrive with ROADMAP Queue 1 #13.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn import SkipConnMLP
from ..ops.math import dir_to_elev_azim, load_sigmoid


class IdentitySpace(nn.Module):
  def size(self) -> int:
    return 3

  def forward(self, x):
    return x


SPACE_KINDS = {"identity": IdentitySpace}


def load_space(kind: str) -> nn.Module:
  ctor = SPACE_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"space kind {kind}: ported with the rest of refl/ (ROADMAP Queue 1 "
        "#13)")
  return ctor()


class View(nn.Module):
  """Position + view direction (the default refl): a siren SkipConnMLP
  on [space(x), elev/azim(view)] with the latent concatenated."""

  def __init__(self, latent_size: int = 0, out_features: int = 3,
               act: str = "thin", space: str = "identity",
               hidden_size: int = 128, num_layers: int = 5,
               siren_w0: float = 30.0, device=None):
    super().__init__()
    self.act = act
    self.space = load_space(space)
    self.mlp = SkipConnMLP(
        in_size=self.space.size() + 2, out=out_features,
        latent_size=latent_size, init_kind="siren", num_layers=num_layers,
        hidden_size=hidden_size, siren_w0=siren_w0, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.mlp.reset_parameters(generator)

  def forward(self, x, view=None, normal=None, light=None,
              latent: Optional[torch.Tensor] = None):
    if view is None:
      raise ValueError("View refl requires view directions")
    inp = torch.cat([self.space(x), dir_to_elev_azim(view)], dim=-1)
    return load_sigmoid(self.act)(self.mlp(inp, latent))


REFL_KINDS = {"view": View}


def load_refl(kind: str = "view", latent_size: int = 0,
              out_features: int = 3, act: str = "thin", **kwargs):
  ctor = REFL_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"refl kind {kind}: ported with the rest of refl/ (ROADMAP Queue 1 "
        "#13)")
  return ctor(latent_size=latent_size, out_features=out_features, act=act,
              **kwargs)
