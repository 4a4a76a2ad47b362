"""Dynamic (time-varying) models: a warp in front of a canonical model.

Counterpart of `nerf_atlas_tpu/models/dyn.py`:
  DynamicNeRF      D-NeRF's Δx warp or Spline-NeRF's Bezier warp, a
                   rigidity gate and an optional per-time latent for the
                   canonical's reflectance, over any canonical of
                   `MODEL_KINDS` but VolSDF;
  DynamicNeRFAE    Δx plus Δlatent on NeRFAE's encoding;
  LongDynamicNeRF  a poly-Bezier over time segments from one warp MLP.
The warp reads Fourier features of (x, t) and emits Δx (spline_points =
0), or reads x alone and emits Bezier control points (P_0 pinned to 0, so
t = 0 is the canonical frame) that de Casteljau evaluates at t. Times ride
per ray. The voxel and rig dynamic models arrive with ROADMAP Queue 1 #11
(they need `ops/grid.py` and the Rig model, #13).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn import FourierEncoder, SkipConnMLP
from ..ops import bezier
from .base import NeRFBase, broadcast_latent, view_per_sample

# the reference's DynamicNeRF unpacks two values from the canonical's
# query (nerf_atlas_tpu/models/dyn.py:108), of which VolSDF's returns three
# (nerf_atlas_tpu/models/volsdf.py:162): a fault of the reference, not
# ported (ROADMAP Queue 3)
_VOLSDF_CANONICAL = (
    "a dynamic model over the volsdf canonical: the reference's "
    "DynamicNeRF unpacks two values from VolSDF.query, which returns three "
    "(nerf_atlas_tpu/models/dyn.py:108 against models/volsdf.py:162; "
    "ROADMAP Queue 3)")


def _canonical(kind: str, kwargs: dict, device):
  from . import MODEL_KINDS
  if kind == "volsdf":
    raise NotImplementedError(_VOLSDF_CANONICAL)
  if kind not in MODEL_KINDS:
    raise NotImplementedError(f"canonical kind {kind}: not ported")
  return MODEL_KINDS[kind](device=device, **kwargs)


def _times_per_sample(times, pts):
  if times is None:
    raise ValueError("a dynamic model needs each ray's time")
  return times[..., None, None].expand(pts.shape[:-1] + (1,))


class DynamicNeRF(NeRFBase):
  """D-NeRF-style deformation (spline_points=0) or Spline-NeRF Bezier
  dynamics (spline_points=S>1) over a canonical of `canonical_kind`
  (tiny, plain, ae or coarse_fine) built from `canonical_kwargs` (its
  steps, near/far, sky and rgb activation default to the wrapper's, as in
  JAX; its other options, density noise and mip among them, are its
  own). With `time_latent_size` L the warp emits L more values, the
  per-time latent that the canonical reads (its latent_size grows by L).
  The submodules are `canonical`, `warp` and `rigidity`, so the
  `state_dict` keys are the flax paths (`warp.enc.B`,
  `warp.layer_in.weight`, `canonical.density_mlp...`)."""

  def __init__(self, canonical_kind: str = "plain", canonical_kwargs=None,
               spline_points: int = 0, with_rigidity: bool = True,
               time_latent_size: int = 0, device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    if spline_points == 1 or spline_points < 0:
      raise ValueError(f"spline_points must be 0 (Δx) or at least 2, got "
                       f"{spline_points}")
    self.canonical_kind = canonical_kind
    self.canonical_kwargs = dict(canonical_kwargs or {})
    self.spline_points = spline_points
    self.with_rigidity = with_rigidity
    self.time_latent_size = time_latent_size
    kwargs = dict(self.canonical_kwargs)
    for key in ("steps", "t_near", "t_far", "sky_kind", "sigmoid_kind"):
      kwargs.setdefault(key, getattr(self, key))
    if time_latent_size > 0:
      kwargs["latent_size"] = time_latent_size + kwargs.get("latent_size", 0)
    self.canonical = _canonical(canonical_kind, kwargs, device)
    in_size = 4 if spline_points == 0 else 3
    out = 3 if spline_points == 0 else 3 * (spline_points - 1)
    self.warp = SkipConnMLP(
        in_size=in_size, out=out + time_latent_size,
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

  def delta_x_latent(self, pts, t):
    """Deformation and per-time latent at (pts [..., 3], t [..., 1]) ->
    (dp [..., 3], tlat [..., time_latent_size] or None)."""
    tlat = None
    if self.spline_points == 0:
      w = self.warp(torch.cat([pts, t], dim=-1))
      dp = w[..., :3]
      if self.time_latent_size > 0:
        tlat = w[..., 3:]
    else:
      w = self.warp(pts)
      nw = 3 * (self.spline_points - 1)
      ctrl = w[..., :nw].reshape(pts.shape[:-1] + (self.spline_points - 1, 3))
      if self.time_latent_size > 0:
        tlat = w[..., nw:]
      ctrl = torch.cat([torch.zeros_like(ctrl[..., :1, :]), ctrl], dim=-2)
      dp = bezier.de_casteljau(torch.movedim(ctrl, -2, 0), t,
                               self.spline_points)
    if self.rigidity is not None:
      dp = dp * torch.sigmoid(self.rigidity(pts))
    return dp, tlat

  def delta_x(self, pts, t):
    """Deformation at (pts [..., 3], t [..., 1]) -> dp [..., 3]."""
    return self.delta_x_latent(pts, t)[0]

  def query(self, pts, view=None, train: bool = False,
            generator: Optional[torch.Generator] = None, t=None,
            latent=None):
    dp = 0.0 if t is None else self.delta_x(pts, t)
    return self.canonical.query(pts + dp, view, train, generator,
                                latent=latent)

  def forward(self, rays, times=None, train: bool = False,
              generator: Optional[torch.Generator] = None, latents=None):
    """rays [..., 6] and each ray's time [...] -> the composited render
    dict (models/base.py) plus dp [..., T, 3] and, with the rigidity MLP,
    rigidity [..., T, 1]. The canonical reads [tlat ; latents]. Raises
    without times."""
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    t = _times_per_sample(times, pts)
    dp, tlat = self.delta_x_latent(pts, t)
    lat = broadcast_latent(latents, pts.shape, self.latent_size)
    if tlat is not None:
      lat = tlat if lat is None else torch.cat([tlat, lat], dim=-1)
    density, rgb = self.canonical.query(
        pts + dp, view_per_sample(r_d, self.steps), train, generator,
        latent=lat)
    out = self.finish(density, rgb, ts, r_d, train, generator=generator)
    out["dp"] = dp
    if self.rigidity is not None:
      out["rigidity"] = torch.sigmoid(self.rigidity(pts))
    return out


class DynamicNeRFAE(NeRFBase):
  """Δx plus Δlatent on a NeRFAE canonical (`canonical`, built from
  `canonical_kwargs`; its steps and near/far default to the wrapper's, its
  sky and rgb activation are its own, as in JAX): one warp on Fourier
  features of (x, t) emits Δx and a change of the encoding at x + Δx. No
  rigidity gate, so no `delta_x`: the divergence regularizers do not
  apply (they raise)."""

  def __init__(self, canonical_kwargs=None, device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    from .nerf import NeRFAE
    self.canonical_kwargs = dict(canonical_kwargs or {})
    kwargs = dict(self.canonical_kwargs)
    for key in ("steps", "t_near", "t_far"):
      kwargs.setdefault(key, getattr(self, key))
    self.canonical = NeRFAE(device=device, **kwargs)
    self.warp = SkipConnMLP(
        in_size=4, out=3 + self.canonical.encoding_size,
        enc=FourierEncoder(input_dims=4, freqs=32, sigma=16.0, device=device),
        num_layers=5, hidden_size=256, zero_last=True, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.canonical.reset_parameters(generator)
    self.warp.reset_parameters(generator)

  def forward(self, rays, times=None, train: bool = False,
              generator: Optional[torch.Generator] = None, latents=None):
    """As DynamicNeRF's, with out["dp"] and no rigidity."""
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    w = self.warp(torch.cat([pts, _times_per_sample(times, pts)], dim=-1))
    dp, dlat = w[..., :3], w[..., 3:]
    lat = broadcast_latent(latents, pts.shape, self.latent_size)
    enc = self.canonical.encoding(pts + dp, lat) + dlat
    density, rgb = self.canonical.query_from_encoding(
        pts + dp, enc, view_per_sample(r_d, self.steps), train, generator)
    out = self.finish(density, rgb, ts, r_d, train, generator=generator)
    out["dp"] = dp
    return out


class LongDynamicNeRF(NeRFBase):
  """Segmented poly-Bezier dynamics for long videos: time in [0, 1] is
  split into `segments` spans of a curve of `spline_points` control points
  each. The JAX package's layout: ONE warp MLP (128×4 on Fourier features
  of x) emits every segment's control deltas; their cumulative sum is one
  stitched control track (segment s's control points are the window
  track[s(P−1) : s(P−1)+P], which shares its first point with the
  previous window: C0 for free), and each point gathers its segment's
  window. The canonical (`canonical_kind`, its steps and near/far
  defaulting to the wrapper's) is queried at x + Δx; out carries "dp" (the
  rigidity gate scales Δx but is not emitted)."""

  def __init__(self, canonical_kind: str = "plain", canonical_kwargs=None,
               segments: int = 4, spline_points: int = 4,
               with_rigidity: bool = True, device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    self.canonical_kind = canonical_kind
    self.canonical_kwargs = dict(canonical_kwargs or {})
    self.segments = segments
    self.spline_points = spline_points
    self.with_rigidity = with_rigidity
    kwargs = dict(self.canonical_kwargs)
    for key in ("steps", "t_near", "t_far"):
      kwargs.setdefault(key, getattr(self, key))
    self.canonical = _canonical(canonical_kind, kwargs, device)
    self.warp = SkipConnMLP(
        in_size=3, out=3 * (spline_points - 1) * segments,
        enc=FourierEncoder(input_dims=3, freqs=32, sigma=16.0, device=device),
        num_layers=4, hidden_size=128, zero_last=True, device=device)
    self.rigidity = (SkipConnMLP(in_size=3, out=1, num_layers=3,
                                 hidden_size=64, device=device)
                     if with_rigidity else None)

  def reset_parameters(self, generator: torch.Generator):
    self.canonical.reset_parameters(generator)
    self.warp.reset_parameters(generator)
    if self.rigidity is not None:
      self.rigidity.reset_parameters(generator)

  def _ctrl_track(self, pts):
    """The stitched control track [..., S(P−1)+1, 3]: 0, then the
    cumulative sum of the warp's deltas."""
    deltas = self.warp(pts).reshape(
        pts.shape[:-1] + (self.segments * (self.spline_points - 1), 3))
    zero = torch.zeros(pts.shape[:-1] + (1, 3), dtype=pts.dtype,
                       device=pts.device)
    return torch.cat([zero, torch.cumsum(deltas, dim=-2)], dim=-2)

  def delta_x(self, pts, t):
    """Deformation at (pts [..., 3], t [..., 1]) -> dp [..., 3]: segment
    ⌊t·S⌋ (clipped to [0, S−1]) at its local time t·S − seg."""
    S, P = self.segments, self.spline_points
    scaled = t[..., 0] * S
    seg = torch.clamp(scaled.to(torch.int32), 0, S - 1)
    local_t = scaled - seg
    idx = (seg[..., None] * (P - 1)
           + torch.arange(P, dtype=torch.int32, device=pts.device))
    track = self._ctrl_track(pts)
    ctrl = torch.take_along_dim(
        track, idx[..., None].long().expand(idx.shape + (3,)), dim=-2)
    dp = bezier.de_casteljau(torch.movedim(ctrl, -2, 0), local_t[..., None],
                             P)
    if self.rigidity is not None:
      dp = dp * torch.sigmoid(self.rigidity(pts))
    return dp

  def forward(self, rays, times=None, train: bool = False,
              generator: Optional[torch.Generator] = None, latents=None):
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    dp = self.delta_x(pts, _times_per_sample(times, pts))
    lat = broadcast_latent(latents, pts.shape, self.latent_size)
    density, rgb = self.canonical.query(
        pts + dp, view_per_sample(r_d, self.steps), train, generator,
        latent=lat)
    out = self.finish(density, rgb, ts, r_d, train, generator=generator)
    out["dp"] = dp
    return out


DYN_MODEL_KINDS = {"plain": DynamicNeRF, "ae": DynamicNeRFAE,
                   "long": LongDynamicNeRF}


def is_dynamic(model) -> bool:
  """Whether `model` is one of the dynamic models (reads each ray's
  time)."""
  return isinstance(model, tuple(DYN_MODEL_KINDS.values()))


def load_dyn_model(kind: str, **kwargs):
  ctor = DYN_MODEL_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"dynamic model kind {kind}: the port has 'plain' (DynamicNeRF), "
        "'ae' (DynamicNeRFAE) and 'long' (LongDynamicNeRF); the voxel and "
        "rig models arrive with ROADMAP Queue 1 #11 (they need ops/grid.py "
        "and the Rig model, #13)")
  return ctor(**kwargs)
