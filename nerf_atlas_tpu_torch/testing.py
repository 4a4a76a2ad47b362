"""Helpers that hold the kernels against their plain versions, and the
writers of on-disk dataset fixtures (a PNG encoder with every row
filter; NeRF-synthetic, D-NeRF and DTU scenes rendered from the
procedural scene): used by `chip_smoke.py` and the tests, not by any
training or rendering path."""
from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .ops import integrate
from .ops.kernels import hash_encode as hk
from .ops.kernels import render as k1
from .ops.kernels import render_ae as k7
from .ops.kernels import render_dyn as k9
from .ops.kernels import render_volsdf as k8


def _split3(x: torch.Tensor):
  """(hi, mid, lo): x's three TF32 parts (csrc/mma_tf32.cuh `split3`);
  |x − (hi + mid + lo)| ≤ 2^-33·|x|."""
  hi = k1.tf32_round(x)
  r = x - hi
  mid = k1.tf32_round(r)
  return hi, mid, k1.tf32_round(r - mid)


def _split_product(a: torch.Tensor, b: torch.Tensor,
                   parts: int = 2) -> torch.Tensor:
  """a @ b as the tensor-core kernels form it (csrc/mma_tf32.cuh): each
  operand split into TF32 parts and the products summed in float32, the
  small first. Two parts (hi, lo): lo_a·hi_b, hi_a·lo_b, hi_a·hi_b
  (lo_a·lo_b dropped). Three parts (hi, mid, lo; `mma_slice3`): lo·hi,
  hi·lo, mid·mid, mid·hi, hi·mid, hi·hi."""
  if parts == 2:
    a_hi, a_lo = k1.tf32_split(a)
    b_hi, b_lo = k1.tf32_split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
  a_hi, a_mid, a_lo = _split3(a)
  b_hi, b_mid, b_lo = _split3(b)
  return ((((a_lo @ b_hi + a_hi @ b_lo) + a_mid @ b_mid) + a_mid @ b_hi)
          + a_hi @ b_mid) + a_hi @ b_hi


class SplitTF32Matmul(torch.autograd.Function):
  """a @ b whose forward and both backward products (g @ bᵀ, aᵀ @ g) go
  through the split-TF32 emulation: the three dense products the
  tensor-core kernels run per layer (the recompute, the input and the
  weight gradient). The forward takes `parts` (2 or 3) parts, the input
  gradient `dx_parts`, the weight gradient two. The backward's products
  are this Function again, so a gradient of a gradient (VolSDF's
  eikonal: the transpose chain, its adjoint's forward-like products and
  rank-64 weight updates) splits every product at every order: the input
  gradient g @ bᵀ differentiates to the forward-like gg @ b, which reads
  the forward's weight blocks in the kernel and so takes `parts`."""

  @staticmethod
  def forward(ctx, a, b, parts=2, dx_parts=2):
    ctx.save_for_backward(a, b)
    ctx.parts = (parts, dx_parts)
    return _split_product(a, b, parts)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    parts, dx_parts = ctx.parts
    return (SplitTF32Matmul.apply(g, b.t(), dx_parts, parts),
            SplitTF32Matmul.apply(a.t(), g, 2, 2), None, None)


def split_tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """`SplitTF32Matmul.apply` in two parts: put in place of
  `render._matmul` to run a plain version's MLP products as K2/K3's
  tensor cores form them."""
  return SplitTF32Matmul.apply(a, b)


def split_tf32_matmul_fwd3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """`SplitTF32Matmul.apply` with the forward product (and, at second
  order, the forward-like one) in three parts: an MLP whose forward
  blocks a backward kernel keeps raw (csrc/mma_tf32.cuh `THREE`)."""
  return SplitTF32Matmul.apply(a, b, 3, 2)


def split_tf32_mlp(mlp, mlps: k1.TCMlps):
  """A stand-in for `render._mlp` (`mlp`, the original) whose products are
  a backward kernel's: each MLP of the kernel's TC pack `mlps` (the
  wrapper's list of (offset, Dense layers, three-part flag), which the
  kernel's tc_floats check at load holds to its constexprs) through
  `split_tf32_matmul_fwd3` where its flag is set, else
  `split_tf32_matmul`. An MLP is known by its Dense layers' shapes; one
  that is not in `mlps` raises."""
  three = {}
  for _, layers, flag in mlps:
    shapes = tuple((i, o) for _, i, o in layers)
    if three.setdefault(shapes, flag) != flag:
      raise ValueError(f"two MLPs of Dense shapes {shapes} differ in parts")

  def run(init_feat, layers, act, n_layers):
    shapes = tuple(tuple(w.shape) for w, _ in layers)
    if shapes not in three:
      raise KeyError(f"an MLP of Dense shapes {shapes} is not in the TC "
                     f"pack")
    saved = k1._matmul
    k1._matmul = (split_tf32_matmul_fwd3 if three[shapes]
                  else split_tf32_matmul)
    try:
      return mlp(init_feat, layers, act, n_layers)
    finally:
      k1._matmul = saved
  return run


def k8b_split_tf32_mlp(mlp):
  """`split_tf32_mlp` as K8b runs it (`render_volsdf.TC_MLPS`)."""
  return split_tf32_mlp(mlp, k8.TC_MLPS)


def k7b_split_tf32_mlp(mlp):
  """`split_tf32_mlp` as K7b runs it (`render_ae.TC_MLPS`)."""
  return split_tf32_mlp(mlp, k7.TC_MLPS)


def k9b_split_tf32_mlp(mlp, lay: k9.Layout):
  """`split_tf32_mlp` as K9b runs it on the layout `lay`
  (`render_dyn.Layout.tc_mlps`)."""
  return split_tf32_mlp(mlp, lay.tc_mlps)


class _Float32Features(torch.autograd.Function):
  """The SDF init feature in float64 holding the kernels' float32 values,
  with the float32 sin/cos in its jacobian (dy/dx = 2π·B): a float64
  evaluation of exactly the float32 model's features."""

  @staticmethod
  def forward(ctx, pts, init32, fb):
    ctx.save_for_backward(init32, fb)
    return init32.double()

  @staticmethod
  def backward(ctx, g):
    init32, fb = ctx.saved_tensors
    sin, cos = init32[:, 3:35].double(), init32[:, 35:].double()
    gy = g[:, 3:35] * cos - g[:, 35:] * sin
    return g[:, :3] + gy @ (fb.double() * (2 * math.pi)).t(), None, None


def volsdf_float64_grad(ws: torch.Tensor, rays: torch.Tensor,
                        ts: torch.Tensor, target: torch.Tensor,
                        sigmoid_kind: str, sky_kind: str,
                        eikonal_weight: float) -> torch.Tensor:
  """The packed gradient of K8b-L's loss (the sphere-init VolSDF, the
  eikonal at `eikonal_weight`) in float64 on the kernels' float32 init
  features (`_Float32Features`): a witness for how far each float32
  implementation lies from the same function in float64."""
  w = ws.double().requires_grad_(True)
  r, t = rays.double(), ts.double()
  fb = ws[k8.B_OFFSET:k8.MLP_OFFSET].view(3, -1)
  init32 = k8.sdf_init_feature(k1.hash_pts(rays, ts), fb)
  with torch.enable_grad():
    pts = k1.hash_pts(r, t).requires_grad_(True)
    init = _Float32Features.apply(pts, init32, fb)
    sigma, rgb, sdf = k8.volsdf_chain(w, r, t, sigmoid_kind, True, pts=pts,
                                      init=init)
    eik = k8.eikonal_residual(sdf, pts, r.shape[0], True)
    out = k1.composite(sigma, rgb, r[:, 3:6], integrate.dists_from_ts(t),
                       sky_kind, relu=True)
    loss = (torch.mean((out[:, :3] - target.double()) ** 2)
            + eikonal_weight * eik.mean())
    (g,) = torch.autograd.grad(loss, w)
  return g


def dyn_float64_grad(ws: torch.Tensor, rays: torch.Tensor,
                     times: torch.Tensor, ts: torch.Tensor,
                     arg: torch.Tensor, *, loss_mode: bool,
                     dp_weight: float = 0.0, spline_points: int = 0,
                     enc_kind: str = "cp", sigmoid_kind: str = "thin",
                     sky_kind: str = "black") -> torch.Tensor:
  """The packed gradient of K9b in float64 on the kernels' float32 warp
  init features (as `dyn_kink_free_rays` evaluates the chain): mode G
  (loss_mode False) d(Σ arg·out)/d(weights) for the cotangent `arg` [N, 4]
  or, with the dp² column, [N, 5]; mode L the gradient of mean((out_rgb −
  arg)²) + dp_weight·mean(dp²). A witness for how far each float32
  implementation lies from the same function in float64."""
  lay = k9.layout(enc_kind, spline_points)
  steps = ts.shape[0]
  pts = k1.hash_pts(rays, ts)
  x_in = pts if lay.warp == "spline" else torch.cat(
      [pts, times[:, None].expand(-1, steps).reshape(-1, 1)], dim=-1)
  init32 = k9.warp_init_feature(x_in, ws[:lay.warp_offset].view(lay.w_in, -1))
  w = ws.double().requires_grad_(True)
  r, t64 = rays.double(), ts.double()
  with torch.enable_grad():
    density, rgb, dp, _ = k9.dyn_chain(w, r, times.double(), t64, lay,
                                       spline_points, sigmoid_kind,
                                       warp_init=init32.double())
    out = k1.composite(density, rgb, r[:, 3:6], integrate.dists_from_ts(t64),
                       sky_kind)
    dp_col = k9.dp_column(dp, rays.shape[0])
    if loss_mode:
      loss = torch.mean((out[:, :3] - arg.double()) ** 2)
      if dp_weight:
        loss = loss + dp_weight * torch.mean(dp_col)
    else:
      if arg.shape[1] == 5:
        out = torch.cat([out, dp_col[:, None]], dim=-1)
      loss = (out * arg.double()).sum()
    (g,) = torch.autograd.grad(loss, w)
  return g


def _float64_products(render, *args, **kw) -> torch.Tensor:
  """`render` (a plain forward kernel version) with every MLP product
  (`render._matmul`) in float64 and the rest after them in float64, on
  the same float32 inputs to the first products."""
  saved = k1._matmul
  k1._matmul = lambda a, b: a.double() @ b.double()
  try:
    return render(*args, **kw)
  finally:
    k1._matmul = saved


def k1_float64_render(ws: torch.Tensor, rays: torch.Tensor,
                      enc_kind: str = "cp", **kw) -> torch.Tensor:
  """The plain K1 of `enc_kind` (`render.plain_cp_render_reference`'s
  keywords) with every MLP product in float64 and the rest after them in
  float64, on the same float32 init features: a witness for how far K1
  and its plain float32 version each lie from their function where the
  siren's gain amplifies round-off (rays [N, 4] out, float64)."""
  return _float64_products(k1.plain_cp_render_reference, ws, rays,
                           enc_kind=enc_kind, **kw)


def dyn_float64_render(ws: torch.Tensor, rays: torch.Tensor,
                       times: torch.Tensor, **kw) -> torch.Tensor:
  """The plain K9f (`render_dyn.dyn_render_reference`'s keywords) with
  every MLP product in float64 and the rest after them in float64 (the
  gate, x' = p + dp, the canonical's encoding of x'), on the same float32
  warp init feature: K9f's witness, as `k1_float64_render` is K1's ([N,
  4] or, with want_dp, [N, 5] out, float64)."""
  return _float64_products(k9.dyn_render_reference, ws, rays, times, **kw)


def ae_float64_render(ws: torch.Tensor, rays: torch.Tensor,
                      **kw) -> torch.Tensor:
  """The plain K7f (`render_ae.ae_render_reference`'s keywords) with every
  MLP product in float64 and the rest after them in float64 (the
  normalize, the View's init feature), on the same float32 posenc
  features: K7f's witness, as `k1_float64_render` is K1's ([N, 4] out,
  float64)."""
  return _float64_products(k7.ae_render_reference, ws, rays, **kw)


def volsdf_float64_render(ws: torch.Tensor, rays: torch.Tensor,
                          **kw) -> torch.Tensor:
  """The plain K8f (`render_volsdf.volsdf_render_reference`'s keywords)
  with every MLP product in float64 and the rest after them in float64
  (the sphere bias, the density, the View's init feature, the
  compositing), on the same float32 points and SDF init feature: K8f's
  witness, as `k1_float64_render` is K1's ([N, 4] or, with want_eikonal,
  [N, 5] out, float64). The eikonal column's transpose chain is the
  float64 products' backward, in float64 up to the init feature, whose
  Fourier jacobian and the ∇ₓsdf it gives stay float32 as the points
  are."""
  return _float64_products(k8.volsdf_render_reference, ws, rays, **kw)


def ae_float64_grad(ws: torch.Tensor, rays: torch.Tensor, ts: torch.Tensor,
                    arg: torch.Tensor, *, loss_mode: bool,
                    sigmoid_kind: str = "thin",
                    sky_kind: str = "black") -> torch.Tensor:
  """The packed gradient of K7b in float64: mode G (loss_mode False)
  d(Σ arg·out)/d(weights) for the cotangent `arg` [N, 4], mode L the
  gradient of mean((out_rgb − arg)²). A witness for how far each float32
  implementation lies from the same function in float64."""
  w = ws.double().requires_grad_(True)
  r, t64 = rays.double(), ts.double()
  with torch.enable_grad():
    density, rgb = k7.ae_chain(w, r, t64, sigmoid_kind)
    out = k1.composite(density, rgb, r[:, 3:6], integrate.dists_from_ts(t64),
                       sky_kind)
    if loss_mode:
      loss = torch.mean((out[:, :3] - arg.double()) ** 2)
    else:
      loss = (out * arg.double()).sum()
    (g,) = torch.autograd.grad(loss, w)
  return g


WITNESS_RATIO = 2.0


def float64_witness_ratio(unpack, got: torch.Tensor, ref: torch.Tensor,
                          w64: torch.Tensor, floor: float):
  """Tensor by tensor, how much further a kernel's packed gradient `got`
  lies from the float64 gradient `w64` than the plain float32 version's
  `ref` does (`unpack` splits a packed gradient into its named tensors;
  each distance ‖Δ‖/‖w64‖): (the largest got-distance / max(ref-distance,
  `floor`), its tensor, both distances). The floor keeps a tensor the
  plain version lands on by chance (a one-element bias, a sum that
  cancels) from reading as a loss: two float32 implementations each
  within `floor` of the exact gradient may lie 2·`floor` apart, so with
  `floor` half the gate a ratio under `WITNESS_RATIO` (2) means the
  kernel is within the gate of the exact gradient or as close as float32
  reaches there, twice over."""
  ug, ur, u64 = (unpack(x.float()) for x in (got, ref, w64))
  best = None
  for k in u64:
    norm = u64[k].double().norm()
    ek = float((ug[k].double() - u64[k].double()).norm() / norm)
    ep = float((ur[k].double() - u64[k].double()).norm() / norm)
    ratio = ek / max(ep, floor)
    if best is None or ratio > best[0]:
      best = (ratio, k, ek, ep)
  return best


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
  pre = _volsdf_pre_activations(params, rays, ts, exact_features)
  return _kink_free(lambda dtype: pre(dtype)[1:], rays, steps, margin)


def _volsdf_pre_activations(params: k8.Params, rays: torch.Tensor,
                            ts: torch.Tensor, exact_features: bool = False):
  """dtype -> the inputs of the SDF MLP's leaky-relus in the plain K8f,
  in its order: the init feature [P, 67], then layer_in's and each hidden
  layer's pre-activations [P, 256] (`volsdf_kink_free_rays` says how
  the init feature enters)."""
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
    return zs

  return pre_activations


# ---- K8f's eikonal sign stash (csrc/wgmma_tf32.cuh `sign_rows`,
# `slope`) ----

def sign_bytes(x: torch.Tensor) -> torch.Tensor:
  """Rows x [..., rows, 64] (a tile's points) -> their signs in K8f's
  stash layout, uint8 [..., rows · 8]: a row is 8 bytes, bit g of byte k
  set where the row's value at point 8k + g is > 0."""
  bits = (x > 0).to(torch.uint8).reshape(*x.shape[:-1], 8, 8)
  weight = (1 << torch.arange(8, device=x.device)).to(torch.uint8)
  return (bits * weight).sum(dim=-1, dtype=torch.uint8).reshape(
      *x.shape[:-2], -1)


def stash_bits(signs: torch.Tensor) -> torch.Tensor:
  """Signs uint8 [..., rows · 8] in K8f's stash layout -> bool [..., rows,
  64]: the bit of each row and point."""
  b = signs.reshape(*signs.shape[:-1], -1, 8).long()
  bits = (b[..., None] >> torch.arange(8, device=signs.device)) & 1
  return bits.flatten(-2) == 1


def stash_slopes(signs: torch.Tensor) -> torch.Tensor:
  """Leaky-relu's act′ as K8f's transpose chain reads it from its signs
  (`wg::slope`): [..., rows, 64], 1 where the bit is set, else 0.01."""
  return torch.where(stash_bits(signs), 1.0, 0.01)


def volsdf_sign_stash(params: k8.Params, rays: torch.Tensor,
                      ts: torch.Tensor, margin: float = 10.0):
  """K8f's eikonal stash as the plain forward gives it, for rays whose
  N·T points fill whole 64-point tiles (tile t: points 64t..64t+63, ray
  by ray): (signs uint8 [tiles, SIGN_BYTES] in the kernel's layout; z
  float32 [tiles, SIGN_ROWS, 64], the values they are the signs of:
  layer_in's and each hidden layer's pre-activations, then the init
  feature; sure bool [tiles, SIGN_ROWS, 64], where z's sign is one a
  kernel must repeat: |z| at least `margin` × its column's rms distance
  to the float64 forward's, and not 0)."""
  pre = _volsdf_pre_activations(params, rays, ts)
  z32, z64 = pre(torch.float32), pre(torch.float64)
  order = z32[1:] + z32[:1]                       # hidden rows, then init
  z = torch.cat(order, dim=-1)                    # [P, SIGN_ROWS]
  rms = torch.cat([(a.double() - b).pow(2).mean(dim=0).sqrt()
                   for a, b in zip(order, z64[1:] + z64[:1])])
  sure = (z.double().abs() >= margin * rms) & (z != 0)
  if z.shape[0] % 64:
    raise ValueError(f"{z.shape[0]} points do not fill 64-point tiles")

  def tiles(x):
    return x.view(-1, 64, k8.SIGN_ROWS).transpose(1, 2)

  z, sure = tiles(z), tiles(sure)
  return sign_bytes(z), z, sure


def k8f_sign_stash(ws: torch.Tensor, rays: torch.Tensor, ts: torch.Tensor,
                   **kw) -> torch.Tensor:
  """The signs one launch of K8f's eikonal build keeps, read back: rays
  [N, 6] at the T = len(ts) sample positions, N·T = 128 (one block of two
  tiles and one pass), through a scratch filled with random bytes. The
  block must write exactly one slot and free it. Returns that slot,
  uint8 [2, SIGN_BYTES] (tile t: points 64t..64t+63). `kw`: sigmoid_kind,
  sky_kind, sphere_init (default thin, black, True)."""
  kw = {"sigmoid_kind": "thin", "sky_kind": "black", "sphere_init": True,
        **kw}
  steps = ts.shape[0]
  if rays.shape[0] * steps != 128 or steps > 128:
    raise ValueError(f"{rays.shape[0]} rays x {steps} steps are not one "
                     "block of two tiles")
  stash, busy = k8.eikonal_scratch(rays.device)
  gen = torch.Generator(device=rays.device).manual_seed(3)
  stash.copy_(torch.randint(0, 256, stash.shape, generator=gen,
                            device=rays.device, dtype=torch.uint8))
  before = stash.clone()
  k8._forward_launch(k8.pack_weights(ws, rays.device), rays, steps=steps,
                     t_near=2.0, t_far=6.0, want_eikonal=True, ts=ts,
                     scratch=(stash, busy), **kw)
  torch.cuda.synchronize(rays.device)
  written = (stash != before).flatten(1).any(dim=1).nonzero().flatten()
  if written.numel() != 1 or bool(busy.any()):
    raise RuntimeError(f"one K8f eikonal block wrote slots "
                       f"{written.tolist()} of {busy.numel()} and left "
                       f"{int(busy.count_nonzero())} busy")
  return stash[int(written[0])]


def dyn_kink_free_rays(params: k9.Params, rays: torch.Tensor,
                       times: torch.Tensor, ts: torch.Tensor, steps: int,
                       enc_kind: str = "cp", spline_points: int = 0,
                       margin: float = 10.0, exact_features: bool = False,
                       chunk: Optional[int] = None) -> torch.Tensor:
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
  which takes its float64 values in the float64 evaluation. `chunk`: rays
  per evaluation (default all), in two passes (the columns' round-off
  over every point, then the rule), so that a CPU run at thousands of
  rays holds a chunk's activations, not all of them."""
  lay = k9.layout(enc_kind, spline_points)
  ws = k9.pack_weights(params, rays.device, enc_kind, spline_points)
  n_w, n_g = k9.W_LAYERS + 2, k9.G_LAYERS + 2
  chunk = chunk or rays.shape[0]

  def evals(sl):
    r, tm = rays[sl], times[sl]
    pts = k1.hash_pts(r, ts)
    x_in = pts if lay.warp == "spline" else torch.cat(
        [pts, tm[:, None].expand(-1, steps).reshape(-1, 1)], dim=-1)
    init32 = k9.warp_init_feature(x_in,
                                  ws[:lay.warp_offset].view(lay.w_in, -1))
    out = []
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
            ws.to(dtype), r.to(dtype), tm.to(dtype), ts.to(dtype), lay,
            spline_points, "thin", act=act, warp_init=init)
      out += [zs, warped.double()]
    # the leaky-relu inputs in call order: the warp's init feature and its
    # 6 pre-activations, the rigidity's init (p) and 4, the density MLP's
    # init feature and 6; no input cotangent of the warp's or the
    # rigidity's is formed, so their init features are left out
    z32, x32, z64, x64 = out
    keep = list(range(1, n_w)) + list(range(n_w + 1, n_w + n_g)) + list(
        range(n_w + n_g + 1, len(z32)))
    zs = [(z32[i], z64[i]) for i in keep]
    return zs, (z32[n_w + n_g], z64[n_w + n_g]), (x32 + 1.0) * 0.5, (
        x64 + 1.0) * 0.5

  spans = [slice(s, s + chunk) for s in range(0, rays.shape[0], chunk)]
  # pass 1: each column's float32-vs-float64 round-off, RMS over the points
  sums, count, done = None, 0, None
  for sl in spans:
    e = evals(sl)
    zs, (f32, f64), u32, u64 = e
    sq = [(a - b).pow(2).sum(dim=0) for a, b in zs] + [
        (f32 - f64).pow(2).sum(dim=0), (u32 - u64).pow(2).sum(dim=0)]
    sums = sq if sums is None else [x + y for x, y in zip(sums, sq)]
    count += f32.shape[0]
    if len(spans) == 1:
      done = e
  rms = [(x / count).sqrt() for x in sums]
  # pass 2: the rule
  free = []
  for sl in spans:
    zs, (f32, f64), u32, _ = done or evals(sl)
    fragile = torch.zeros(f32.shape[0], dtype=torch.bool, device=rays.device)
    for (a, _), col in zip(zs, rms):
      fragile |= (a.abs() < margin * col).any(dim=-1)
    diff = (f32 - f64).abs()                            # [x' ‖ enc]
    fragile |= ((f32.abs() < margin * diff)
                | (f32.abs() < 0.1 * margin * rms[-2])).any(dim=-1)
    if enc_kind == "cp":
      tol = margin * rms[-1]                                     # [3]
      near = (u32.abs() < tol) | ((u32 - 1.0).abs() < tol)
      inside = (u32 > 0.0) & (u32 < 1.0)          # outside, no gradient
      for res in k1.CP_RESOLUTIONS:
        v = u32 * (res - 1)
        near |= inside & ((v - torch.round(v)).abs() < tol * (res - 1))
      fragile |= near.any(dim=-1)
    free.append(~fragile.view(-1, steps).any(dim=-1))
  return torch.cat(free)


def _kink_free(pre_activations, rays, steps: int, margin: float):
  fragile = torch.zeros(rays.shape[0] * steps, dtype=torch.bool,
                        device=rays.device)
  for z32, z64 in zip(pre_activations(torch.float32),
                      pre_activations(torch.float64)):
    z32 = z32.double()
    rms = (z32 - z64).pow(2).mean(dim=0).sqrt()
    fragile |= (z32.abs() < margin * rms).any(dim=-1)
  return ~fragile.view(rays.shape[0], steps).any(dim=-1)


def k5f_corner_pairs(pts: torch.Tensor, table_size: int):
  """K5f's corner-pair rule (csrc/hash_encode.cu) on the host: (level,
  even corner c, row of c [P], row of c | 1 [P], joined [P] bool) for
  every level and pair, the rows with their level offset as
  `hash_encode._corners` gives them. A pair is joined where row c | 1 is
  row c ^ 1 (rows 2k and 2k + 1, in either order): one 16-byte load then
  holds both rows."""
  rows = {(li, c): idx for li, c, idx, _ in hk._corners(pts, table_size)}
  for li in range(hk.LEVELS):
    for c in range(0, 8, 2):
      a, b = rows[(li, c)], rows[(li, c + 1)]
      yield li, c, a, b, b == (a ^ 1)


def k5f_joined_share(pts: torch.Tensor, table_size: int) -> list:
  """The share of K5f's corner pairs that the rule joins, per level."""
  joined = [0.0] * hk.LEVELS
  for li, _, _, _, j in k5f_corner_pairs(pts, table_size):
    joined[li] += float(j.float().mean()) / 4
  return joined


def k5f_emulate(table: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
  """K5f's loads on the host: for each pair, the 16-byte load of the
  aligned row pair that holds row c (row c its half by parity), and row
  c | 1 from that load's other half where the pair is joined, from a load
  of its own elsewhere; then the products and sums in the kernel's order.
  Features [P, 16]: where the rule is right, `hash_encode_reference`'s
  bits."""
  size = hk._table_size(table)
  quads = table.reshape(-1, 4)             # [L·T / 2]: aligned row pairs
  weights = {(li, c): w for li, c, _, w in hk._corners(pts, size)}
  levels = [None] * hk.LEVELS
  for li, c, a, b, joined in k5f_corner_pairs(pts, size):
    q = quads[a // 2]
    odd = (a % 2 == 1)[:, None]
    v_a = torch.where(odd, q[:, 2:], q[:, :2])
    v_b = torch.where(joined[:, None], torch.where(odd, q[:, :2], q[:, 2:]),
                      table[b])
    for v, w in ((v_a, weights[(li, c)]), (v_b, weights[(li, c + 1)])):
      contrib = v * w[:, None]
      levels[li] = contrib if levels[li] is None else levels[li] + contrib
  return torch.cat(levels, dim=-1)


# ---------------------------------------------------------------------------
# on-disk dataset fixtures
# ---------------------------------------------------------------------------

_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def filter_rows(raw: np.ndarray, bpp: int,
                filters: Sequence[int]) -> np.ndarray:
  """PNG's forward row filters: raw [H, stride] uint8, filters [H] (0
  None, 1 Sub, 2 Up, 3 Average, 4 Paeth) -> [H, 1 + stride] uint8. Every
  predictor reads the unfiltered bytes, so each filter is one numpy
  expression over the image."""
  x = raw.astype(np.int16)
  a = np.zeros_like(x)
  a[:, bpp:] = x[:, :-bpp]
  b = np.zeros_like(x)
  b[1:] = x[:-1]
  c = np.zeros_like(x)
  c[1:, bpp:] = x[:-1, :-bpp]
  pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
  paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
  preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
  f = np.asarray(filters)
  out = (x - preds[f, np.arange(len(f))]) & 255
  return np.concatenate([f[:, None], out], axis=1).astype(np.uint8)


def encode_png(img: np.ndarray, filters: Optional[Sequence[int]] = None,
               level: int = 6) -> bytes:
  """An 8-bit (uint8) or 16-bit (uint16) PNG of img [H, W] or [H, W, C]
  (C = 1-4: grey, grey + alpha, RGB, RGBA), row r filtered by filters[r]
  (default: r mod 5, so that every unfilter runs)."""
  img = np.asarray(img)
  if img.ndim == 2:
    img = img[..., None]
  h, w, c = img.shape
  depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}[img.dtype]
  raw = (img.astype(">u2").view(np.uint8) if depth == 16 else img)
  raw = np.ascontiguousarray(raw).reshape(h, -1)
  filters = np.arange(h) % 5 if filters is None else filters
  rows = filter_rows(raw, c * depth // 8, filters)

  def chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

  return (b"\x89PNG\r\n\x1a\n"
          + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                       _COLOR_TYPES[c], 0, 0, 0))
          + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
          + chunk(b"IEND", b""))


def write_png_filtered(path: str, img: np.ndarray, **kw):
  """`encode_png` into a file."""
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  with open(path, "wb") as f:
    f.write(encode_png(img, **kw))


def _u8(img) -> np.ndarray:
  return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_nerf_synthetic(root: str, n_train: int, n_test: int, size: int,
                         dynamic: bool = False, device=None, level: int = 6,
                         chunk: int = 16384):
  """A NeRF-synthetic (or, `dynamic`, D-NeRF) scene of the procedural
  scene: transforms_{train,test}.json (camera_angle_x 0.6911) and RGBA
  PNGs train/r_i.png, test/r_i.png at size × size, the train poses from
  seed 0 and the test poses from seed 1 (`hemisphere_poses`). D-NeRF:
  each frame's `time` (linspace over the split), the frames listed in a
  shuffled order. `level`: zlib's; `chunk`: rays per render call.
  Returns {split: imgs [N, S, S, 4] float32}."""
  from .data import cameras as cam_lib
  from .data import synthetic
  out = {}
  for split, n, seed in (("train", n_train, 0), ("test", n_test, 1)):
    poses = synthetic.hemisphere_poses(n, seed=seed)
    cam = cam_lib.NeRFCamera.from_json_transforms(poses, 0.6911, size,
                                                  device=device)
    times = np.linspace(0.0, 1.0, n).astype(np.float32) if dynamic else None
    imgs = synthetic.render_gt(cam, size, times=times, chunk=chunk)
    frames = []
    for i in range(n):
      rel = f"{split}/r_{i}"
      write_png_filtered(os.path.join(root, rel + ".png"), _u8(imgs[i]),
                         level=level)
      fr = {"file_path": f"./{rel}",
            "transform_matrix": poses[i].tolist()}
      if dynamic:
        fr["time"] = float(times[i])
      frames.append(fr)
    if dynamic:
      frames = [frames[i] for i in np.random.default_rng(seed).permutation(n)]
    with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
      json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    out[split] = imgs
  return out


def write_dtu(root: str, views: int, width: int, height: int,
              device=None, level: int = 6,
              chunk: int = 16384) -> np.ndarray:
  """A DTU scan of the procedural scene: image/###.png (RGB) and
  mask/###.png (grey, the alpha above 0.5) at width × height, and
  cameras.npz with world_mat_i = K [R | t] (OpenCV axes: +z forward, y
  down; focal from camera_angle_x 0.6911 over the width, centred
  principal point) and an identity scale_mat_i, the poses those of
  `hemisphere_poses(views)`. `level`: zlib's; `chunk`: rays per render
  call. Returns the RGBA renders [V, H, W, 4]."""
  from .data import cameras as cam_lib
  from .data import synthetic
  f = 0.5 * width / math.tan(0.5 * 0.6911)
  K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
  flip = np.diag([1.0, -1.0, -1.0])
  poses = synthetic.hemisphere_poses(views).numpy().astype(np.float64)
  c2w_cv = poses.copy()
  c2w_cv[:, :3, :3] = poses[:, :3, :3] @ flip
  cam = cam_lib.DTUCamera(
      pose=torch.as_tensor(c2w_cv, dtype=torch.float32, device=device),
      K=torch.as_tensor(np.tile(K, (views, 1, 1)),
                        dtype=torch.float32, device=device))
  ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
  xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
  gy, gx = torch.meshgrid(ys, xs, indexing="ij")
  xy = torch.stack([gx, gy], dim=-1)
  mats, imgs = {}, []
  for i in range(views):
    vidx = torch.full(xy.shape[:-1], i, dtype=torch.long, device=device)
    rays = cam.rays_at(vidx, xy, 0).reshape(-1, 6)
    img = synthetic.render_rays(rays, chunk=chunk).reshape(
        height, width, 4).cpu().numpy()
    imgs.append(img)
    world = np.eye(4)
    world[:3] = K @ np.linalg.inv(c2w_cv[i])[:3]
    mats[f"world_mat_{i}"] = world
    mats[f"scale_mat_{i}"] = np.eye(4)
    write_png_filtered(os.path.join(root, "image", f"{i:03d}.png"),
                       _u8(img[..., :3]), level=level)
    write_png_filtered(os.path.join(root, "mask", f"{i:03d}.png"),
                       (img[..., 3] > 0.5).astype(np.uint8) * 255,
                       level=level)
  np.savez(os.path.join(root, "cameras.npz"), **mats)
  return np.stack(imgs)
