"""TinyNeRF (one MLP to sigma and rgb), PlainNeRF (a density MLP emitting
sigma + an intermediate feature, RGB from a pluggable reflectance model),
NeRFAE (an auto-encoded latent field that density and reflectance both
read) and CoarseFineNeRF (PlainNeRF's field queried by a coarse pass and
by a fine pass at positions drawn from the coarse weights).

Counterparts of `nerf_atlas_tpu/models/nerf.py:TinyNeRF`, `PlainNeRF`,
`NeRFAE` and `CoarseFineNeRF`. Each takes `latent_size` (NeRFBase) and a
`latent` [..., latent_size] in `query`, which its first MLP reads beside
the encoded point (and PlainNeRF's and CoarseFineNeRF's reflectance
beside the density MLP's features): the dynamic wrappers' per-time
latent (`models/dyn.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..nn import CPEncoder, HashEncoder, PositionalEncoder, SkipConnMLP
from ..ops import sampling
from ..refl import load_refl
from .base import NeRFBase, view_per_sample


def _density_encoder(enc_kind: str, mip: Optional[str],
                     table_size: Optional[int], device):
  """The density MLP's spatial encoder of PlainNeRF and CoarseFineNeRF:
  none with mip (the IPE features replace it), else cp, hash or
  posenc."""
  if mip is not None:
    return None
  if enc_kind == "cp":
    return CPEncoder(device=device)
  if enc_kind == "hash":
    return HashEncoder(table_size=table_size or 1 << 19, device=device)
  if enc_kind == "posenc":
    return PositionalEncoder(input_dims=3, max_freq_log2=6, num_freqs=10)
  if enc_kind == "ref-hash":
    raise NotImplementedError(
        "enc kind ref-hash: the reference-exact RefHashEncoder arrives "
        "with ROADMAP Queue 1 #7")
  raise NotImplementedError(f"unknown enc kind {enc_kind}")


def _with_latent(feats, latent):
  """The reflectance's latent: the density MLP's features, then the
  conditioning latent when there is one."""
  return feats if latent is None else torch.cat([feats, latent], dim=-1)


class TinyNeRF(NeRFBase):
  """One SkipConnMLP (8-band positional encoding up to 2^6, 128×6) maps a
  point to (sigma, rgb); no view dependence. Built at the JAX model's
  default widths only: `mlp_kwargs` that change them (the reference
  checkpoints' 6×256, --ref-compat) arrive with ROADMAP Queue 1 #13. The
  MLP is the attribute `mlp`, so the `state_dict` keys are the flax
  paths (`mlp.layer_in.weight`, ...)."""

  DEFAULT_MLP = dict(num_layers=6, hidden_size=128)

  def __init__(self, mlp_kwargs: Optional[dict] = None, device=None,
               **base_kwargs):
    super().__init__(**base_kwargs)
    kw = dict(self.DEFAULT_MLP, **(mlp_kwargs or {}))
    if kw != self.DEFAULT_MLP:
      raise NotImplementedError(
          f"TinyNeRF mlp_kwargs {mlp_kwargs}: other widths arrive with "
          "--ref-compat (ROADMAP Queue 1 #13)")
    self.mlp = SkipConnMLP(
        in_size=3, out=1 + 3, latent_size=self.latent_size,
        enc=PositionalEncoder(input_dims=3, max_freq_log2=6, num_freqs=8),
        device=device, **kw)

  def reset_parameters(self, generator: torch.Generator):
    self.mlp.reset_parameters(generator)

  def query(self, pts, view=None, train: bool = False,
            generator: Optional[torch.Generator] = None, latent=None):
    out = self.mlp(pts, latent)
    density = self.add_density_noise(out[..., 0], train, generator)
    return density, self.rgb_act(out[..., 1:])

  def forward(self, rays, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """As PlainNeRF's."""
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    density, rgb = self.query(pts, train=train, generator=generator)
    return self.finish(density, rgb, ts, r_d, train, generator=generator)


class PlainNeRF(NeRFBase):
  """enc_kind selects the spatial encoder: "cp" (factorized feature
  volumes, the default), "hash" (the NGP hash grid, `table_size` entries
  per level; the JAX model's `enc_kwargs={"table_size": ...}`) or
  "posenc" (frequency encoding); with `mip` ("cone" or "cylinder") the
  density MLP reads MipNeRF's 96 IPE features instead of an encoded
  point, whatever enc_kind says. Every one of them takes the fused
  kernels. "ref-hash" arrives with ROADMAP Queue 1 #7. The density MLP
  (256x5) and View (128x5) are built at the default widths; overriding
  them arrives with --ref-compat (ROADMAP Queue 1 #13)."""

  def __init__(self, refl_kind: str = "view", refl_space: str = "identity",
               enc_kind: str = "cp", table_size: Optional[int] = None,
               device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    if table_size is not None and enc_kind != "hash":
      raise NotImplementedError(
          f"table_size only configures enc_kind='hash', got {enc_kind}")
    enc = _density_encoder(enc_kind, self.mip, table_size, device)
    self.refl_kind = refl_kind
    self.refl_space = refl_space
    self.enc_kind = enc_kind
    self.density_mlp = SkipConnMLP(
        in_size=3 if self.mip is None else 96,
        out=1 + self.intermediate_size, latent_size=self.latent_size,
        enc=enc, num_layers=5, hidden_size=256, device=device)
    self.refl = load_refl(
        refl_kind, latent_size=self.intermediate_size + self.latent_size,
        act=self.sigmoid_kind, space=refl_space, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.density_mlp.reset_parameters(generator)
    self.refl.reset_parameters(generator)

  def query(self, pts, view, train: bool = False,
            generator: Optional[torch.Generator] = None, mip_feats=None,
            latent=None):
    """The refl reads [features ; latent]."""
    out = self.density_mlp(pts if mip_feats is None else mip_feats, latent)
    density = self.add_density_noise(out[..., 0], train, generator)
    rgb = self.refl(pts, view=view, latent=_with_latent(out[..., 1:], latent))
    return density, rgb

  def forward(self, rays, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """train=True draws the ts jitter, the density noise and the random
    sky from `generator` (required then, on the rays' device)."""
    pts, ts, r_o, r_d = self.sample_points(rays, train, generator)
    density, rgb = self.query(pts, view_per_sample(r_d, self.steps), train,
                              generator, self.mip_encode(r_o, r_d, ts))
    return self.finish(density, rgb, ts, r_d, train, generator=generator)


class NeRFAE(NeRFBase):
  """Auto-encoded NeRF (JAX `models/nerf.py:NeRFAE`): points encode to a
  latent field (positional encoding, 8 bands up to 2^6, into a 256×5
  SkipConnMLP), optionally L2-normalized; a 128×4 `density_tfm` MLP maps
  the latent to sigma and 32 features, and the View refl reads the
  latent and the features.

  The encoder submodule is the attribute `encode`, so that the
  `state_dict` keys are the flax paths (`encode.layer_in.weight`, ...);
  the JAX class's `encode` *method* is therefore `encoding` here, and its
  `encode_raw` keeps its name. Only the default widths are built; the
  JAX `enc_mlp_kwargs` / `density_mlp_kwargs` / `refl_kwargs` overrides
  arrive with --ref-compat (ROADMAP Queue 1 #13)."""

  def __init__(self, refl_kind: str = "view", encoding_size: int = 32,
               normalize_latent: bool = True, device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    self.refl_kind = refl_kind
    self.encoding_size = encoding_size
    self.normalize_latent = normalize_latent
    self.encode = SkipConnMLP(
        in_size=3, out=encoding_size, latent_size=self.latent_size,
        enc=PositionalEncoder(input_dims=3, max_freq_log2=6, num_freqs=8),
        num_layers=5, hidden_size=256, device=device)
    self.density_tfm = SkipConnMLP(
        in_size=encoding_size, out=1 + self.intermediate_size, num_layers=4,
        hidden_size=128, device=device)
    self.refl = load_refl(
        refl_kind, latent_size=encoding_size + self.intermediate_size,
        act=self.sigmoid_kind, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.encode.reset_parameters(generator)
    self.density_tfm.reset_parameters(generator)
    self.refl.reset_parameters(generator)

  def encoding(self, pts, latent=None, with_raw: bool = False):
    """Latent field at pts (the JAX method `encode`), conditioned on
    `latent` when the model reads one; with_raw also returns the encoding
    before normalization, which `latent_l2` reads."""
    raw = self.encode(pts, latent)
    enc = raw
    if self.normalize_latent:
      enc = raw / torch.clamp(
          torch.linalg.vector_norm(raw, dim=-1, keepdim=True), min=1e-6)
    return (enc, raw) if with_raw else enc

  def encode_raw(self, pts):
    """The encoding before normalization (`ae_latent_l2` reads it)."""
    return self.encode(pts)

  def query_from_encoding(self, pts, enc, view, train: bool = False,
                          generator: Optional[torch.Generator] = None):
    out = self.density_tfm(enc)
    density = self.add_density_noise(out[..., 0], train, generator)
    rgb = self.refl(pts, view=view,
                    latent=torch.cat([enc, out[..., 1:]], dim=-1))
    return density, rgb

  def query(self, pts, view, train: bool = False,
            generator: Optional[torch.Generator] = None, latent=None):
    return self.query_from_encoding(pts, self.encoding(pts, latent), view,
                                    train, generator)

  def forward(self, rays, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """As PlainNeRF's, plus out["latent_l2"]: the mean over sample points
    of ‖raw encoding‖², taken before normalization."""
    pts, ts, _, r_d = self.sample_points(rays, train, generator)
    enc, raw = self.encoding(pts, with_raw=True)
    density, rgb = self.query_from_encoding(
        pts, enc, view_per_sample(r_d, self.steps), train, generator)
    out = self.finish(density, rgb, ts, r_d, train, generator=generator)
    out["latent_l2"] = torch.mean(torch.sum(torch.square(raw), dim=-1))
    return out


class CoarseFineNeRF(NeRFBase):
  """Hierarchical NeRF (JAX `models/nerf.py:CoarseFineNeRF`): a coarse
  pass on the stratified ts drives inverse-CDF importance sampling of
  `fine_steps` more positions per ray (from the coarse weights under
  stop-grad; `generator` draws u in training, linspace at eval), and the
  fine pass composites the merged steps + fine_steps per-ray ts. One
  field serves both: the density MLP (`density_mlp`, 256×5 → 1 + 32) on
  the encoder of `enc_kind` ("hash", the JAX class's default, "cp" or
  "posenc"; with `mip`, the IPE features of each segment) and the
  reflectance `refl`, named as the flax paths. The output is the fine
  pass's dict with `coarse_rgb` and `coarse_weights`; the training loss
  supervises both images. The fused kernels take cp, posenc and mip
  (`ops/kernels/render.py:fused_coarse_fine_*`)."""

  def __init__(self, refl_kind: str = "view", fine_steps: int = 64,
               enc_kind: str = "hash", device=None, **base_kwargs):
    super().__init__(**base_kwargs)
    self.refl_kind = refl_kind
    self.fine_steps = fine_steps
    self.enc_kind = enc_kind
    self.density_mlp = SkipConnMLP(
        in_size=3 if self.mip is None else 96,
        out=1 + self.intermediate_size, latent_size=self.latent_size,
        enc=_density_encoder(enc_kind, self.mip, None, device), num_layers=5,
        hidden_size=256, device=device)
    self.refl = load_refl(
        refl_kind, latent_size=self.intermediate_size + self.latent_size,
        act=self.sigmoid_kind, device=device)

  def reset_parameters(self, generator: torch.Generator):
    self.density_mlp.reset_parameters(generator)
    self.refl.reset_parameters(generator)

  def query(self, pts, view, train: bool = False,
            generator: Optional[torch.Generator] = None, mip_feats=None,
            latent=None):
    """The refl reads [features ; latent]."""
    out = self.density_mlp(pts if mip_feats is None else mip_feats, latent)
    density = self.add_density_noise(out[..., 0], train, generator)
    rgb = self.refl(pts, view=view, latent=_with_latent(out[..., 1:], latent))
    return density, rgb

  def _pass(self, rays, ts, r_o, r_d, train, generator):
    """One pass on ts [T] or [N, T] -> the composited output dict."""
    pts = rays[..., None, :3] + ts[..., :, None] * rays[..., None, 3:6]
    density, rgb = self.query(pts, view_per_sample(r_d, ts.shape[-1]),
                              train, generator,
                              self.mip_encode(r_o, r_d, ts))
    return self.finish(density, rgb, ts, r_d, train, generator=generator)

  def forward(self, rays, train: bool = False,
              generator: Optional[torch.Generator] = None):
    """train=True draws the ts jitter, the fine u, the density noise and
    the random sky from `generator` (required then, on the rays'
    device)."""
    _, ts, r_o, r_d = self.sample_points(rays, train, generator)
    coarse = self._pass(rays, ts, r_o, r_d, train, generator)
    w = coarse["weights"].detach()
    ts_b = ts.expand(w.shape) if ts.ndim == 1 else ts
    fine_ts = sampling.sample_pdf(ts_b, w, self.fine_steps,
                                  generator=generator if train else None)
    fine = self._pass(rays, sampling.merge_ts(ts_b, fine_ts), r_o, r_d,
                      train, generator)
    fine["coarse_rgb"] = coarse["rgb"]
    fine["coarse_weights"] = coarse["weights"]
    return fine
