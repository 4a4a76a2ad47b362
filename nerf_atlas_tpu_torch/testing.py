"""Helpers that hold the kernels against their plain versions: used by
`chip_smoke.py` and the `cuda` tests, not by any training or rendering
path."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .ops.kernels import render as k1
from .ops.kernels import render_ae as k7
from .ops.kernels import render_dyn as k9
from .ops.kernels import render_volsdf as k8


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """a @ b as K2/K3's tensor cores form it (csrc/mma_tf32.cuh): each
  operand split into TF32 hi and lo parts, the three products lo_a·hi_b,
  hi_a·lo_b and hi_a·hi_b summed in float32; lo_a·lo_b is dropped."""
  a_hi, a_lo = k1.tf32_split(a)
  b_hi, b_lo = k1.tf32_split(b)
  return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


class SplitTF32Matmul(torch.autograd.Function):
  """a @ b whose forward and both backward products (g @ bᵀ, aᵀ @ g) go
  through the split-TF32 emulation: the three dense products K2/K3 runs
  per layer (the recompute, the input and the weight gradient)."""

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a, b)
    return _split_product(a, b)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    return _split_product(g, b.t()), _split_product(a.t(), g)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """`SplitTF32Matmul.apply`: put in place of `render._matmul` to run a
  plain version's MLP products as K2/K3's tensor cores do."""
  return SplitTF32Matmul.apply(a, b)


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


def volsdf_kink_free_rays(params: k8.Params, rays: torch.Tensor,
                          ts: torch.Tensor, steps: int,
                          margin: float = 10.0,
                          exact_features: bool = False) -> torch.Tensor:
  """`kink_free_rays` for VolSDF (`params`: its state_dict or packed
  weights): the same rule over the SDF MLP's hidden pre-activations, the
  inputs of its leaky-relus. Their act′ (1 or 0.01) gates the backward
  and, in the eikonal, ∇ₓsdf itself, whose value jumps where one of them
  crosses 0. The View MLP is a siren, smooth everywhere. The init
  feature [p ‖ sin ‖ cos] enters both evaluations as its float32 values
  (the kernels and the plain version compute it with the same rounded
  operations), unless `exact_features`, which takes its float64 values in
  the float64 evaluation: the rule for holding the port against another
  implementation (the JAX package) whose Fourier phases, hundreds of
  radians, round differently."""
  ws = k8.pack_weights(params, rays.device)
  pts = k1.hash_pts(rays, ts)
  init32 = k8.sdf_init_feature(pts, ws[k8.B_OFFSET:k8.MLP_OFFSET].view(3, -1))

  def pre_activations(dtype):
    zs = []

    def act(v):
      zs.append(v)
      return F.leaky_relu(v, 0.01)

    init = init32.to(dtype)
    if exact_features and dtype == torch.float64:
      init = None
    with torch.no_grad():
      k8.volsdf_chain(ws.to(dtype), rays.to(dtype), ts.to(dtype), "thin",
                      True, pts=pts.to(dtype), act=act, init=init)
    return zs[1:]                    # zs[0]: act(the init feature)

  return _kink_free(pre_activations, rays, steps, margin)


def dyn_kink_free_rays(params: k9.Params, rays: torch.Tensor,
                       times: torch.Tensor, ts: torch.Tensor, steps: int,
                       enc_kind: str = "cp", spline_points: int = 0,
                       margin: float = 10.0, exact_features: bool = False
                       ) -> torch.Tensor:
  """`kink_free_rays` for a DynamicNeRF (`params`: its state_dict or
  packed weights of `enc_kind`, `spline_points`): the same rule over the
  leaky-relu inputs of the warp's and the rigidity's hidden layers and of
  the canonical density MLP's; the View is a siren, smooth everywhere.
  Two things differ from the static models, because the warped points x'
  come out of the warp MLP, whose sums the kernel and the plain version
  order differently, and their cotangent is formed:
  - the density MLP's init feature [x' ‖ enc] is held too, per value: a
    value is near its kink when its magnitude is under `margin` times its
    own float32-vs-float64 difference, or under `margin`/10 times its
    column's RMS difference (the column rule at `margin` would flag most
    rays: CP features, products of three line values, cluster near 0,
    where their error is far below the column's);
  - for the cp canonical, the CP taps of x', where the position gradient
    jumps: a point's xn·(R − 1) within `margin` round-offs of an integer
    at some level R inside the box, or xn = (x' + 1)/2 within `margin`
    round-offs of the box's faces (the round-off: the RMS over the points
    of the float32-vs-float64 difference of xn).
  The warp's init feature [x ‖ sin ‖ cos] enters both evaluations as its
  float32 values, unless `exact_features` (the rule against the JAX
  package, whose Fourier phases, up to ~1000 radians, round differently),
  which takes its float64 values in the float64 evaluation."""
  lay = k9.layout(enc_kind, spline_points)
  ws = k9.pack_weights(params, rays.device, enc_kind, spline_points)
  pts = k1.hash_pts(rays, ts)
  x_in = pts if lay.warp == "spline" else torch.cat(
      [pts, times[:, None].expand(-1, steps).reshape(-1, 1)], dim=-1)
  init32 = k9.warp_init_feature(x_in, ws[:lay.warp_offset].view(lay.w_in, -1))
  evals = {}
  for dtype in (torch.float32, torch.float64):
    zs = []

    def act(v):
      zs.append(v.double())
      return F.leaky_relu(v, 0.01)

    init = init32.to(dtype)
    if exact_features and dtype == torch.float64:
      init = None
    with torch.no_grad():
      *_, warped = k9.dyn_chain(
          ws.to(dtype), rays.to(dtype), times.to(dtype), ts.to(dtype), lay,
          spline_points, "thin", act=act, warp_init=init)
    evals[dtype] = (zs, warped.double())
  (z32, x32), (z64, x64) = evals[torch.float32], evals[torch.float64]
  # the leaky-relu inputs in call order: the warp's init feature and its 6
  # pre-activations, the rigidity's init (p) and 4, the density MLP's init
  # feature and 6; no input cotangent of the warp's or the rigidity's is
  # formed, so their init features are left out
  n_w, n_g = k9.W_LAYERS + 2, k9.G_LAYERS + 2
  keep = list(range(1, n_w)) + list(range(n_w + 1, n_w + n_g)) + list(
      range(n_w + n_g + 1, len(z32)))
  fragile = torch.zeros(z32[0].shape[0], dtype=torch.bool, device=rays.device)
  for i in keep:
    rms = (z32[i] - z64[i]).pow(2).mean(dim=0).sqrt()
    fragile |= (z32[i].abs() < margin * rms).any(dim=-1)
  f32, f64 = z32[n_w + n_g], z64[n_w + n_g]              # [x' ‖ enc]
  diff = (f32 - f64).abs()
  fragile |= ((f32.abs() < margin * diff)
              | (f32.abs() < 0.1 * margin * diff.pow(2).mean(dim=0).sqrt())
              ).any(dim=-1)
  if enc_kind == "cp":
    u32, u64 = (x32 + 1.0) * 0.5, (x64 + 1.0) * 0.5
    tol = margin * (u32 - u64).pow(2).mean(dim=0).sqrt()          # [3]
    near = (u32.abs() < tol) | ((u32 - 1.0).abs() < tol)
    inside = (u32 > 0.0) & (u32 < 1.0)          # outside, no gradient
    for res in k1.CP_RESOLUTIONS:
      v = u32 * (res - 1)
      near |= inside & ((v - torch.round(v)).abs() < tol * (res - 1))
    fragile |= near.any(dim=-1)
  return ~fragile.view(rays.shape[0], steps).any(dim=-1)


def _kink_free(pre_activations, rays, steps: int, margin: float):
  fragile = torch.zeros(rays.shape[0] * steps, dtype=torch.bool,
                        device=rays.device)
  for z32, z64 in zip(pre_activations(torch.float32),
                      pre_activations(torch.float64)):
    z32 = z32.double()
    rms = (z32 - z64).pow(2).mean(dim=0).sqrt()
    fragile |= (z32.abs() < margin * rms).any(dim=-1)
  return ~fragile.view(rays.shape[0], steps).any(dim=-1)
