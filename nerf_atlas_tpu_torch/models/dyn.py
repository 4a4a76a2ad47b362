"""Dynamic (time-varying) models: D-NeRF's Δx warp and Spline-NeRF's
Bezier warp in front of a canonical PlainNeRF.

Counterpart of `nerf_atlas_tpu/models/dyn.py:DynamicNeRF`. The warp
reads Fourier features of (x, t) and emits Δx (spline_points = 0), or
reads x alone and emits the control points P_1..P_{S−1} of a Bezier curve
(P_0 pinned to 0, so t = 0 is the canonical frame) that de Casteljau
evaluates at t; a rigidity MLP gates Δx by σ(rigidity(x)). Times ride
per ray. The per-time refl latent (`time_latent_size`, --dyn-refl-latent),
other canonical kinds, DynamicNeRFAE and LongDynamicNeRF arrive with
ROADMAP Queue 1 #11.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn import FourierEncoder, SkipConnMLP
from ..ops import bezier
from .base import NeRFBase, view_per_sample
from .nerf import PlainNeRF


class DynamicNeRF(NeRFBase):
  """D-NeRF-style deformation (spline_points=0) or Spline-NeRF Bezier
  dynamics (spline_points=S>1) over a canonical PlainNeRF built from
  `canonical_kwargs` (its steps, near/far, sky and rgb activation default
  to the wrapper's, as in JAX; its other options, density noise and mip
  among them, are its own). The submodules are `canonical`, `warp` and
  `rigidity`, so the `state_dict` keys are the flax paths
  (`warp.enc.B`, `warp.layer_in.weight`, `canonical.density_mlp...`)."""

  def __init__(self, canonical_kind: str = "plain", canonical_kwargs=None,
               spline_points: int = 0, with_rigidity: bool = True,
               time_latent_size: int = 0, device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    if canonical_kind != "plain":
      raise NotImplementedError(
          f"DynamicNeRF canonical_kind {canonical_kind!r}: only the plain "
          "canonical is ported (ROADMAP Queue 1 #11)")
    if spline_points == 1 or spline_points < 0:
      raise ValueError(f"spline_points must be 0 (Δx) or at least 2, got "
                       f"{spline_points}")
    if time_latent_size:
      raise NotImplementedError(
          "DynamicNeRF time_latent_size (--dyn-refl-latent): arrives with "
          "ROADMAP Queue 1 #11")
    self.canonical_kind = canonical_kind
    self.canonical_kwargs = dict(canonical_kwargs or {})
    self.spline_points = spline_points
    self.with_rigidity = with_rigidity
    self.time_latent_size = time_latent_size
    kwargs = dict(self.canonical_kwargs)
    for key in ("steps", "t_near", "t_far", "sky_kind", "sigmoid_kind"):
      kwargs.setdefault(key, getattr(self, key))
    self.canonical = PlainNeRF(device=device, **kwargs)
    in_size = 4 if spline_points == 0 else 3
    self.warp = SkipConnMLP(
        in_size=in_size,
        out=3 if spline_points == 0 else 3 * (spline_points - 1),
        enc=FourierEncoder(input_dims=in_size, freqs=32, sigma=16.0,
                           device=device),
        num_layers=5, hidden_size=256, zero_last=True, device=device)
    self.rigidity = (SkipConnMLP(in_size=3, out=1, num_layers=3,
                                 hidden_size=64, device=device)
                     if with_rigidity else None)

  def reset_parameters(self, generator: torch.Generator):
    self.canonical.reset_parameters(generator)
    self.warp.reset_parameters(generator)
    if self.rigidity is not None:
      self.rigidity.reset_parameters(generator)

  def delta_x(self, pts, t):
    """Deformation at (pts [..., 3], t [..., 1]) -> dp [..., 3]."""
    if self.spline_points == 0:
      dp = self.warp(torch.cat([pts, t], dim=-1))
    else:
      n = self.spline_points - 1
      ctrl = self.warp(pts).reshape(pts.shape[:-1] + (n, 3))
      ctrl = torch.cat([torch.zeros_like(ctrl[..., :1, :]), ctrl], dim=-2)
      dp = bezier.de_casteljau(torch.movedim(ctrl, -2, 0), t,
                               self.spline_points)
    if self.rigidity is not None:
      dp = dp * torch.sigmoid(self.rigidity(pts))
    return dp

  def query(self, pts, view=None, train: bool = False,
            generator: Optional[torch.Generator] = None, t=None):
    dp = 0.0 if t is None else self.delta_x(pts, t)
    return self.canonical.query(pts + dp, view, train, generator)

  def forward(self, rays, times=None, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """rays [..., 6] and each ray's time [...] -> the composited render
    dict (models/base.py) plus dp [..., T, 3] and, with the rigidity MLP,
    rigidity [..., T, 1]. Raises without times."""
    if times is None:
      raise ValueError("a dynamic model needs each ray's time")
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    t = times[..., None, None].expand(pts.shape[:-1] + (1,))
    dp = self.delta_x(pts, t)
    density, rgb = self.canonical.query(
        pts + dp, view_per_sample(r_d, self.steps), train, generator)
    out = self.finish(density, rgb, ts, r_d, train, generator=generator)
    out["dp"] = dp
    if self.rigidity is not None:
      out["rigidity"] = torch.sigmoid(self.rigidity(pts))
    return out


DYN_MODEL_KINDS = {"plain": DynamicNeRF}


def load_dyn_model(kind: str, **kwargs):
  ctor = DYN_MODEL_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"dynamic model kind {kind}: only 'plain' (DynamicNeRF) is ported "
        "(DynamicNeRFAE, LongDynamicNeRF, the voxel and rig models arrive "
        "with ROADMAP Queue 1 #11)")
  return ctor(**kwargs)
