"""Helpers that hold the kernels against their plain versions: used by
`chip_smoke.py` and the `cuda` tests, not by any training or rendering
path."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .ops.kernels import render as k1
from .ops.kernels import render_ae as k7


def kink_free_rays(params: k1.Params, rays: torch.Tensor, ts: torch.Tensor,
                   steps: int, margin: float = 10.0,
                   feats: Optional[torch.Tensor] = None,
                   enc_kind: Optional[str] = None) -> torch.Tensor:
  """[N] bool: the rays none of whose density-MLP (tiny: its one MLP's)
  hidden pre-activations lies within `margin` round-offs of the
  leaky-relu kink at 0.

  Two float32 backward implementations (K2/K3 and autograd through the
  plain K1) sum in different orders; a pre-activation within round-off
  of 0 can then take the other slope in one of them and move that
  point's whole backward (one such point moves a weight gradient by
  ~1e-3 relative). A pre-activation counts as near the kink when its
  magnitude is under `margin` times its column's float32-vs-float64
  round-off (RMS over the points). The init features are left out:
  render_bwd.cu rounds the cp and hash ones exactly as the plain version
  does, and the parameter-free encoders' kink moves only the input
  cotangent, which neither implementation forms. The parameter-free
  encoders' features also enter both evaluations as their float32
  values: kernel and plain version compute them with the same rounded
  float32 operations, while their float64 values differ by far more at
  the high bands (a mean's float32 rounding times 2^15), which would
  flag rays the two float32 MLPs agree on. `params` are weights of
  `enc_kind` (default cp, or hash when the points' features `feats`
  [N·T, 16] are given). Used to hold the kernels to their plain versions
  on the rays where the two must agree to float32 summation order."""
  enc_kind = enc_kind or ("cp" if feats is None else "hash")
  ws = k1.pack_weights(params, rays.device, enc_kind)

  def pre_activations(dtype):
    lines, dense_layers, _ = k1._unpack(ws.to(dtype))
    if enc_kind in ("cp", "hash"):
      feat = k1.init_feature(enc_kind, lines, rays.to(dtype), ts.to(dtype),
                             None if feats is None else feats.to(dtype))
    else:
      feat = k1.init_feature(enc_kind, lines, rays, ts).to(dtype)
    zs = []

    def act(v):
      zs.append(v)
      return F.leaky_relu(v, 0.01)

    with torch.no_grad():
      k1._mlp(feat, dense_layers, act, k1.LAYOUTS[enc_kind].n_layers)
    return zs[1:]                    # zs[0]: act(init feature)

  return _kink_free(pre_activations, rays, steps, margin)


def ae_kink_free_rays(params: k7.Params, rays: torch.Tensor,
                      ts: torch.Tensor, steps: int,
                      margin: float = 10.0) -> torch.Tensor:
  """`kink_free_rays` for NeRFAE (`params`: its state_dict or packed
  weights): the same rule over the encoder's hidden pre-activations and
  every leaky-relu input of density_tfm, its init feature (the
  normalized latent, which the kernel and the plain version sum in
  different orders) included. The encoder's init feature (p and its
  posenc) is left out: its kink moves only the input cotangent, which
  neither implementation forms."""
  ws = k7.pack_weights_ae(params, rays.device)

  def pre_activations(dtype):
    zs = []

    def act(v):
      zs.append(v)
      return F.leaky_relu(v, 0.01)

    with torch.no_grad():
      k7.ae_chain(ws.to(dtype), rays.to(dtype), ts.to(dtype), "thin", act)
    return zs[1:]                    # zs[0]: act(the encoder's init feature)

  return _kink_free(pre_activations, rays, steps, margin)


def _kink_free(pre_activations, rays, steps: int, margin: float):
  fragile = torch.zeros(rays.shape[0] * steps, dtype=torch.bool,
                        device=rays.device)
  for z32, z64 in zip(pre_activations(torch.float32),
                      pre_activations(torch.float64)):
    z32 = z32.double()
    rms = (z32 - z64).pow(2).mean(dim=0).sqrt()
    fragile |= (z32.abs() < margin * rms).any(dim=-1)
  return ~fragile.view(rays.shape[0], steps).any(dim=-1)
