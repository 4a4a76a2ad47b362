"""K9f and K9b: the fused forward render of D-NeRF / Spline-NeRF and its
backward, the warp and the rigidity gate inside the kernels.

Counterparts of `nerf_atlas_tpu/ops/pallas/render_dyn.py`:
- `fused_dyn_render` (K9f, kernel body `_dyn_kernel`) launches
  `csrc/render_dyn_fwd.cu`; `dyn_render_reference` is its plain torch.
  With `want_dp` the output gains a 5th column, the per-ray mean over the
  T samples and 3 axes of dp² (the --dp-weight regularizer's term).
- `fused_dyn_render_grad` (K9b in cotangent mode G, the autograd
  backward of K9f) and `fused_dyn_train_step` (K9b in loss mode L, the
  one-kernel step: the L2 loss plus `dp_weight` times the mean of dp²,
  and its gradient) launch `csrc/render_dyn_bwd.cu`;
  `dyn_render_grad_reference` and `dyn_train_step_reference` are autograd
  through the plain K9f.
- `DynRender` is the autograd Function K9f forward / K9b-G backward
  (`_make_diff_dyn_render`), `fused_dyn_render_train` its entry point.
Each wrapper launches its kernel for rays on the GPU (and raises if it
cannot) and takes its plain version for rays on the CPU. The sharded
form (`fused_dyn_cp_render_train_sharded`) arrives with ROADMAP Queue 1
#12.

The kernels cover `models.DynamicNeRF` with a plain canonical at its
default widths, in two warp kinds and two canonical encoders:
- the warp ("dx", spline_points 0): Fourier features (32 frequencies) of
  (x, t) -> a 68 -> 256×5 SkipConnMLP -> Δx; ("spline", spline_points
  S in [2, MAX_SPLINE]): of x alone -> 67 -> 256×5 -> the control points
  P_1..P_{S−1} (P_0 = 0), de Casteljau at t;
- the rigidity gate: a 3 -> 64×3 -> 1 SkipConnMLP, dp = Δx·σ(rigidity(x));
- the canonical PlainNeRF on x + dp, enc_kind "cp" or "posenc" (K1's
  chains).

Weights travel as one packed float32 vector (`pack_weights`): the warp's
Fourier matrix B [4 or 3, 32] row-major, every Dense layer of the warp
MLP and of the rigidity MLP as W [in, out] row-major followed by its
bias, then the canonical PlainNeRF packed as K1 packs it
(`render.pack_weights`). The spline warp's layer_out is packed at
MAX_SPLINE's width, 3·(MAX_SPLINE − 1) = 30 columns, its columns past
3·(S − 1) zero, so that one kernel build serves every S. Gradients come
back in the same layout (`unpack_grads`); B's entries are 0 (B takes no
gradient) and so are the padding columns'.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ...nn.encoders import cp_encode, fourier_phases
from ...nn.mlp import leaky_relu
from .. import bezier
from ..math import dir_to_elev_azim, load_sigmoid
from . import render as k1

# the warp and the rigidity MLP (must match models.DynamicNeRF)
W_FREQS = 32
W_HIDDEN, W_LAYERS = 256, 5
G_HIDDEN, G_LAYERS = 64, 3
# the spline warp's layer_out is packed at this many control points; the
# gate refuses more
MAX_SPLINE = 11
SPLINE_OUT = 3 * (MAX_SPLINE - 1)                # 30 columns
WARP_KINDS = ("dx", "spline")
ENC_KINDS = ("cp", "posenc")
MAX_STEPS = 2048                                 # csrc/render_dyn_fwd.cu
# csrc/render_dyn_bwd.cu: shared memory holds 9 floats per point of a ray
BWD_MAX_STEPS = {"cp": 389, "posenc": 1024}
B_KEY = "warp.enc.B"
CANON = "canonical."

Params = Union[Mapping[str, torch.Tensor], torch.Tensor]


def warp_kind(spline_points: int) -> str:
  if spline_points == 0:
    return "dx"
  if 2 <= spline_points <= MAX_SPLINE:
    return "spline"
  raise ValueError(f"spline_points must be 0 or in [2, {MAX_SPLINE}], got "
                   f"{spline_points}")


def _enc(enc_kind: str) -> str:
  if enc_kind not in ENC_KINDS:
    raise NotImplementedError(f"fused D-NeRF kernel: canonical enc_kind "
                              f"{enc_kind}")
  return enc_kind


@dataclass(frozen=True)
class Layout:
  """The packed weight vector of one (canonical encoder, warp kind)."""
  enc_kind: str
  warp: str
  w_in: int                                      # 4 (x, t) or 3 (x)
  warp_layers: Tuple[Tuple[str, int, int], ...]  # layer_out at kernel width
  rig_layers: Tuple[Tuple[str, int, int], ...]

  @property
  def warp_offset(self) -> int:
    return self.w_in * W_FREQS

  @property
  def rig_offset(self) -> int:
    return self.warp_offset + sum(i * o + o for _, i, o in self.warp_layers)

  @property
  def canon_offset(self) -> int:
    return self.rig_offset + sum(i * o + o for _, i, o in self.rig_layers)

  @property
  def weight_count(self) -> int:
    return self.canon_offset + k1.LAYOUTS[self.enc_kind].weight_count

  @property
  def tc_mlps(self) -> k1.TCMlps:
    """K9b's TC pack (render.tc_layout_index): the warp MLP's, the
    rigidity MLP's, then the canonical's density and View MLPs'; the
    three with leaky-relu kinks run their forward products in three parts
    (csrc/render_dyn.cuh `LEAKY_THREE`)."""
    (d_pos, d_layers, _), (r_pos, r_layers, _) = k1.tc_mlps(self.enc_kind)
    return ((self.warp_offset, self.warp_layers, True),
            (self.rig_offset, self.rig_layers, True),
            (self.canon_offset + d_pos, d_layers, True),
            (self.canon_offset + r_pos, r_layers, False))


def _make_layout(enc_kind: str, warp: str) -> Layout:
  w_in = 4 if warp == "dx" else 3
  return Layout(enc_kind, warp, w_in, tuple(k1._mlp_layout(
      "warp", w_in + 2 * W_FREQS, W_HIDDEN, W_LAYERS,
      3 if warp == "dx" else SPLINE_OUT)), tuple(k1._mlp_layout(
          "rigidity", 3, G_HIDDEN, G_LAYERS, 1)))


LAYOUTS = {(e, w): _make_layout(e, w) for e in ENC_KINDS for w in WARP_KINDS}


def layout(enc_kind: str = "cp", spline_points: int = 0) -> Layout:
  return LAYOUTS[(_enc(enc_kind), warp_kind(spline_points))]


def _warp_out(spline_points: int) -> int:
  """The warp MLP's real output width: 3 (Δx) or 3·(S − 1)."""
  return 3 if spline_points == 0 else 3 * (spline_points - 1)


def _expected_shapes(lay: Layout, spline_points: int):
  shapes = {B_KEY: (lay.w_in, W_FREQS)}
  for name, i, o in lay.warp_layers + lay.rig_layers:
    if name == "warp.layer_out":
      o = _warp_out(spline_points)
    shapes[f"{name}.weight"] = (o, i)
    shapes[f"{name}.bias"] = (o,)
  return shapes


def flatten_params(state_dict: Mapping[str, torch.Tensor],
                   enc_kind: str = "cp", spline_points: int = 0
                   ) -> List[torch.Tensor]:
  """DynamicNeRF state_dict -> the kernels' tensors in packed order (B,
  the warp and rigidity Dense weights transposed to [in, out], the spline
  layer_out padded to the kernel's width, the canonical's packed vector).
  Raises on a divergent tree."""
  lay = layout(enc_kind, spline_points)
  shapes = _expected_shapes(lay, spline_points)
  canon = {k[len(CANON):]: v for k, v in state_dict.items()
           if k.startswith(CANON)}
  own = {k: v for k, v in state_dict.items() if not k.startswith(CANON)}
  missing = sorted(set(shapes) - set(own))
  extra = sorted(set(own) - set(shapes))
  if missing or extra:
    raise KeyError(f"not the default DynamicNeRF parameters: missing "
                   f"{missing}, unexpected {extra}")
  for key, shape in shapes.items():
    if tuple(own[key].shape) != shape:
      raise ValueError(f"{key}: shape {tuple(own[key].shape)}, the kernel "
                       f"needs {shape}")
  out = [own[B_KEY]]
  for name, _, o in lay.warp_layers + lay.rig_layers:
    w, b = own[f"{name}.weight"].t(), own[f"{name}.bias"]
    if w.shape[1] != o:                          # the spline's padding
      w = F.pad(w, (0, o - w.shape[1]))
      b = F.pad(b, (0, o - b.shape[0]))
    out += [w, b]
  out.append(k1.pack_weights(canon, None, enc_kind))
  return out


def pack_weights(params: Params, device=None, enc_kind: str = "cp",
                 spline_points: int = 0) -> torch.Tensor:
  """state_dict (or an already packed vector) -> packed f32 [weight count
  of (enc_kind, spline_points)]."""
  count = layout(enc_kind, spline_points).weight_count
  if isinstance(params, torch.Tensor):
    if params.dtype != torch.float32 or params.shape != (count,):
      raise ValueError(f"packed D-NeRF weights must be float32 [{count}], "
                       f"got {params.dtype} {tuple(params.shape)}")
    return params.to(device) if device is not None else params
  with torch.no_grad():
    flat = [t.detach().to(device=device, dtype=torch.float32).reshape(-1)
            for t in flatten_params(params, enc_kind, spline_points)]
    return torch.cat(flat).contiguous()


def _unpack(ws: torch.Tensor, lay: Layout):
  """Packed vector -> (B, warp [(W, b)], rigidity [(W, b)], canonical
  packed vector)."""
  if ws.ndim != 1 or ws.shape[0] != lay.weight_count:
    raise ValueError(f"not a packed {lay.enc_kind}/{lay.warp} D-NeRF weight "
                     f"vector: shape {tuple(ws.shape)}")
  pos, mlps = lay.warp_offset, []
  for layers in (lay.warp_layers, lay.rig_layers):
    mlp = []
    for _, i, o in layers:
      mlp.append((ws[pos:pos + i * o].view(i, o),
                  ws[pos + i * o:pos + i * o + o]))
      pos += i * o + o
    mlps.append(mlp)
  return (ws[:lay.warp_offset].view(lay.w_in, W_FREQS), mlps[0], mlps[1],
          ws[lay.canon_offset:])


def unpack_grads(packed: torch.Tensor, enc_kind: str = "cp",
                 spline_points: int = 0) -> Dict[str, torch.Tensor]:
  """Packed weights or gradient -> {state_dict key: tensor} (the inverse
  of `pack_weights`: Dense weights back to [out, in], the spline's
  padding dropped). B takes no gradient and has no entry."""
  lay = layout(enc_kind, spline_points)
  _, warp, rig, canon = _unpack(packed, lay)
  out = {}
  for (name, _, _), (w, b) in zip(lay.warp_layers + lay.rig_layers,
                                  warp + rig):
    if name == "warp.layer_out":
      w, b = w[:, :_warp_out(spline_points)], b[:_warp_out(spline_points)]
    out[f"{name}.weight"] = w.t().contiguous()
    out[f"{name}.bias"] = b
  for key, value in k1.unpack_grads(canon).items():
    out[CANON + key] = value
  return out


def warp_init_feature(x_in: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
  """The warp MLP's init feature [P, w_in + 64] = x ‖ sin(2π·x·B) ‖
  cos(2π·x·B) (`fourier_phases`: the kernels round the same operations in
  the same order)."""
  y = fourier_phases(x_in, fb)
  return torch.cat([x_in, torch.sin(y), torch.cos(y)], dim=-1)


def dyn_chain(ws: torch.Tensor, rays: torch.Tensor, times: torch.Tensor,
              ts: torch.Tensor, lay: Layout, spline_points: int,
              sigmoid_kind: str, act=leaky_relu,
              warp_init: Optional[torch.Tensor] = None):
  """The per-point chain of the plain K9f: (density raw [N·T], rgb [N·T,
  3], dp [N·T, 3], warped [N·T, 3]) at the sample points r_o + t·r_d
  (rounded as the kernels round them). `act` is the leaky-relu of the
  warp, rigidity and density MLPs (a test may pass one that records its
  inputs); `warp_init` a warp init feature to use in place of the
  points'. B enters as a constant: it takes no gradient (the JAX
  encoder's stop_gradient)."""
  fb, warp, rig, canon = _unpack(ws, lay)
  fb = fb.detach()
  n, steps = rays.shape[0], ts.shape[0]
  pts = k1.hash_pts(rays, ts)
  t = times[:, None].expand(n, steps).reshape(-1, 1)
  if warp_init is None:
    x_in = pts if lay.warp == "spline" else torch.cat([pts, t], dim=-1)
    warp_init = warp_init_feature(x_in, fb)
  w_out = k1._mlp(warp_init, warp, act, W_LAYERS)
  if lay.warp == "spline":
    ctrl = w_out[:, :_warp_out(spline_points)].reshape(-1,
                                                       spline_points - 1, 3)
    ctrl = torch.cat([torch.zeros_like(ctrl[:, :1]), ctrl], dim=1)
    spl = bezier.de_casteljau(ctrl.movedim(1, 0), t, spline_points)
  else:
    spl = w_out
  dp = spl * torch.sigmoid(k1._mlp(pts, rig, act, G_LAYERS))
  warped = pts + dp
  lines, dense, refl = k1._unpack(canon)
  out = k1._mlp(canonical_init_feature(lay.enc_kind, lines, warped), dense,
                act, k1.N_LAYERS)
  elaz = dir_to_elev_azim(rays[:, 3:6])[:, None, :].expand(
      n, steps, 2).reshape(-1, 2)
  r_in = torch.cat([warped, elaz, out[:, 1:]], dim=-1)
  rgb = load_sigmoid(sigmoid_kind)(k1._mlp(r_in, refl, k1.siren_act,
                                           k1.R_LAYERS))
  return out[:, 0], rgb, dp, warped


def canonical_init_feature(enc_kind: str, lines, warped: torch.Tensor
                           ) -> torch.Tensor:
  """The canonical density MLP's init feature [P, 35 or 63] at the warped
  points: [x ‖ CP encode of the [-1, 1] box] or [x ‖ posenc]."""
  if enc_kind == "cp":
    xn = torch.clamp((warped + 1.0) * 0.5, 0.0, 1.0)
    return torch.cat([warped, cp_encode(xn, lines)], dim=-1)
  return torch.cat([warped, k1.POSENCS["posenc"](warped)], dim=-1)


def dp_column(dp: torch.Tensor, n: int) -> torch.Tensor:
  """Per ray, the mean over its T points and 3 axes of dp² [n]."""
  return torch.mean(torch.square(dp), dim=-1).view(n, -1).mean(dim=-1)


def check_times(times: torch.Tensor, rays: torch.Tensor):
  if (times.dtype != torch.float32 or tuple(times.shape) != (rays.shape[0],)
      or times.device != rays.device or not times.is_contiguous()):
    raise ValueError(f"times must be contiguous float32 [{rays.shape[0]}] on "
                     f"{rays.device}, got {times.dtype} "
                     f"{tuple(times.shape)} on {times.device}")


def _check_call(ws: torch.Tensor, rays: torch.Tensor, times: torch.Tensor,
                steps: int, sigmoid_kind: str, sky_kind: str, max_steps: int,
                lay: Layout):
  k1.check_rays(ws, rays, steps, sigmoid_kind, sky_kind, max_steps)
  check_times(times, rays)
  if ws.ndim != 1 or ws.shape[0] != lay.weight_count:
    raise ValueError(f"not a packed {lay.enc_kind}/{lay.warp} D-NeRF weight "
                     f"vector: shape {tuple(ws.shape)}")


def dyn_render_reference(params: Params, rays: torch.Tensor,
                         times: torch.Tensor, *, steps: int = 64,
                         t_near: float = 2.0, t_far: float = 6.0,
                         sigmoid_kind: str = "thin", sky_kind: str = "black",
                         spline_points: int = 0, enc_kind: str = "cp",
                         want_dp: bool = False,
                         ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Plain-torch K9f: rays [N, 6] and each ray's time [N] -> [N, 4] (rgb
  ‖ acc), with want_dp [N, 5] (‖ the per-ray mean of dp²), on any device,
  differentiable in a packed weight vector. ts [T]: shared sample
  positions (default the uniform grid). The "random" sky is black, as
  the kernels render it."""
  lay = layout(enc_kind, spline_points)
  ws = pack_weights(params, rays.device, enc_kind, spline_points)
  _check_call(ws, rays, times, steps, sigmoid_kind, sky_kind, MAX_STEPS, lay)
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  density, rgb, dp, _ = dyn_chain(ws, rays, times, ts, lay, spline_points,
                                  sigmoid_kind)
  out = k1.composite(density, rgb, rays[:, 3:6], dists, sky_kind)
  if want_dp:
    out = torch.cat([out, dp_column(dp, rays.shape[0])[:, None]], dim=-1)
  return out


def _leaf(params: Params, device, enc_kind: str,
          spline_points: int) -> torch.Tensor:
  return pack_weights(params, device, enc_kind,
                      spline_points).detach().clone().requires_grad_(True)


def dyn_render_grad_reference(params: Params, rays: torch.Tensor,
                              times: torch.Tensor, g: torch.Tensor,
                              **kw) -> torch.Tensor:
  """Plain K9b, mode G: d(Σ g·out)/d(packed weights) for the cotangent g
  [N, 4] (with want_dp [N, 5]), by autograd through
  `dyn_render_reference`."""
  ws = _leaf(params, rays.device, kw.get("enc_kind", "cp"),
             kw.get("spline_points", 0))
  with torch.enable_grad():
    out = dyn_render_reference(ws, rays, times, **kw)
    (dws,) = torch.autograd.grad(out, ws, g)
  return dws


def dyn_train_step_reference(params: Params, rays: torch.Tensor,
                             times: torch.Tensor, target: torch.Tensor, *,
                             dp_weight: float = 0.0, **kw
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain K9b, mode L: (loss, d loss/d(packed weights)) for loss =
  mean((out_rgb − target)²) + dp_weight · mean(dp²), by autograd through
  the plain K9f."""
  ws = _leaf(params, rays.device, kw.get("enc_kind", "cp"),
             kw.get("spline_points", 0))
  with torch.enable_grad():
    out = dyn_render_reference(ws, rays, times, want_dp=dp_weight != 0, **kw)
    loss = torch.mean((out[:, :3] - target) ** 2)
    if dp_weight:
      loss = loss + dp_weight * torch.mean(out[:, 4])
    (dws,) = torch.autograd.grad(loss, ws)
  return loss.detach(), dws


# ---------------------------------------------------------------------------
# the launchers (csrc/render_dyn_fwd.cu, csrc/render_dyn_bwd.cu)
# ---------------------------------------------------------------------------

def defines(enc_kind: str, spline_points: int) -> Tuple[str, ...]:
  """The defines that build csrc/render_dyn_{fwd,bwd}.cu for one (canonical
  encoder, warp kind): four libraries each, compiled in parallel."""
  return (f"RENDER_DYN_ENC={k1.ENC_KINDS.index(_enc(enc_kind))}",
          f"RENDER_DYN_SPLINE={int(warp_kind(spline_points) == 'spline')}")


def variants() -> List[Tuple[str, int]]:
  """(enc_kind, spline_points) of each build variant."""
  return [(e, s) for e in ENC_KINDS for s in (0, MAX_SPLINE)]


def _bind(name: str, enc_kind: str, spline_points: int, n_ptr: int,
          n_int: int, n_float: int, counts: Tuple[str, ...]) -> ctypes.CDLL:
  """Build (at first use) and bind csrc/<name>.cu for one variant: its
  launch function, the scratch sizes `counts` and the constants it must
  share with this wrapper."""
  from . import build
  lib = build.load(name, defines(enc_kind, spline_points))
  fn = getattr(lib, f"{name}_launch")
  fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                 + [ctypes.c_float] * n_float + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  for suffix in ("weight_count",) + counts:
    getattr(lib, f"{name}_{suffix}").argtypes = []
    getattr(lib, f"{name}_{suffix}").restype = ctypes.c_longlong
  for suffix in ("max_steps", "max_spline", "built_enc", "built_spline"):
    getattr(lib, f"{name}_{suffix}").argtypes = []
    getattr(lib, f"{name}_{suffix}").restype = ctypes.c_int
  getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
  getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
  lay = layout(enc_kind, spline_points)
  want = (lay.weight_count,
          MAX_STEPS if name.endswith("fwd") else BWD_MAX_STEPS[enc_kind],
          MAX_SPLINE, k1.ENC_KINDS.index(enc_kind), int(lay.warp == "spline"))
  got = tuple(getattr(lib, f"{name}_{s}")() for s in (
      "weight_count", "max_steps", "max_spline", "built_enc", "built_spline"))
  if got != want:
    raise RuntimeError(f"{name}.cu built for {defines(enc_kind, spline_points)}"
                       f" reports (weights, steps, max spline, enc, spline) "
                       f"{got}, the wrapper {want}")
  return lib


@functools.lru_cache(maxsize=None)
def _load_fwd_library(enc_kind: str, warp: str) -> ctypes.CDLL:
  return _bind("render_dyn_fwd", enc_kind, 0 if warp == "dx" else MAX_SPLINE,
               7, 6, 0, ())


@functools.lru_cache(maxsize=None)
def _load_bwd_library(enc_kind: str, warp: str) -> ctypes.CDLL:
  lib = _bind("render_dyn_bwd", enc_kind, 0 if warp == "dx" else MAX_SPLINE,
              11, 8, 2, ("stash_floats_per_tile", "tc_floats"))
  lay = LAYOUTS[(enc_kind, warp)]
  want = k1.tc_layout_index(lay.tc_mlps, lay.weight_count)[0].numel()
  if lib.render_dyn_bwd_tc_floats() != want:
    raise RuntimeError(f"render_dyn_bwd.cu built for {enc_kind}/{warp} takes "
                       f"a TC pack of {lib.render_dyn_bwd_tc_floats()} "
                       f"floats, the wrapper {want}")
  return lib


def _forward_launch(ws: torch.Tensor, rays: torch.Tensor,
                    times: torch.Tensor, *, steps: int, t_near: float,
                    t_far: float, sigmoid_kind: str, sky_kind: str,
                    spline_points: int, enc_kind: str, want_dp: bool,
                    ts: Optional[torch.Tensor]) -> torch.Tensor:
  """One render_dyn_fwd launch."""
  k1._check_cuda(rays, "render_dyn_fwd")
  lay = layout(enc_kind, spline_points)
  ws = ws.detach()
  _check_call(ws, rays, times, steps, sigmoid_kind, sky_kind, MAX_STEPS, lay)
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  n = rays.shape[0]
  out = torch.empty((n, 5 if want_dp else 4), dtype=torch.float32,
                    device=rays.device)
  if n == 0:
    return out
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  fq = k1.freqs(enc_kind, rays.device)
  lib = _load_fwd_library(enc_kind, lay.warp)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_dyn_fwd_launch(
      rays.data_ptr(), times.data_ptr(), ts.data_ptr(), dists.data_ptr(),
      ws.data_ptr(), k1._ptr(fq), out.data_ptr(), n, steps, spline_points,
      k1.FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      int(want_dp), stream)
  k1._raise_on(err, lib, "render_dyn_fwd", "render_dyn_fwd")
  return out


def _backward_launch(ws: torch.Tensor, rays: torch.Tensor,
                     times: torch.Tensor, gin: torch.Tensor,
                     ts: Optional[torch.Tensor], *, steps: int, t_near: float,
                     t_far: float, sigmoid_kind: str, sky_kind: str,
                     spline_points: int, enc_kind: str, want_dp: bool,
                     loss_mode: bool, dp_weight: float = 0.0
                     ) -> torch.Tensor:
  """One render_dyn_bwd launch (+ its partial reduction); returns [weight
  count + 1] = gradient ‖ loss."""
  k1._check_cuda(rays, "render_dyn_bwd")
  lay = layout(enc_kind, spline_points)
  ws = ws.detach()
  _check_call(ws, rays, times, steps, sigmoid_kind, sky_kind,
              BWD_MAX_STEPS[enc_kind], lay)
  width = 3 if loss_mode else (5 if want_dp else 4)
  if (gin.dtype != torch.float32 or tuple(gin.shape) != (rays.shape[0], width)
      or gin.device != rays.device or not gin.is_contiguous()):
    raise ValueError(f"{'target' if loss_mode else 'g'} must be contiguous "
                     f"float32 [{rays.shape[0]}, {width}] on {rays.device}, "
                     f"got {gin.dtype} {tuple(gin.shape)} on {gin.device}")
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  n, count = rays.shape[0], lay.weight_count
  out = torch.zeros(count + 1, dtype=torch.float32, device=rays.device)
  if n == 0:
    return out
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  fq = k1.freqs(enc_kind, rays.device)
  lib = _load_bwd_library(enc_kind, lay.warp)
  rays_per_block = 1 if steps >= 64 else 64 // steps
  tiles = -(-(rays_per_block * steps) // 64)
  blocks = min(-(-n // rays_per_block), torch.cuda.get_device_properties(
      rays.device).multi_processor_count)
  partial = torch.empty(blocks * (count + 1), dtype=torch.float32,
                        device=rays.device)
  stash = torch.empty(
      blocks * tiles * lib.render_dyn_bwd_stash_floats_per_tile(),
      dtype=torch.float32, device=rays.device)
  tcw = k1.tc_pack_mlps(ws, lay.tc_mlps)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_dyn_bwd_launch(
      rays.data_ptr(), times.data_ptr(), ts.data_ptr(), dists.data_ptr(),
      ws.data_ptr(), tcw.data_ptr(), gin.data_ptr(), k1._ptr(fq),
      out.data_ptr(), partial.data_ptr(), stash.data_ptr(), n, steps, blocks,
      spline_points, k1.FUSED_SIGMOID_KINDS.index(sigmoid_kind),
      int(sky_kind == "white"), int(want_dp), int(loss_mode),
      1.0 / (3 * n) if loss_mode else 0.0,
      dp_weight / n if loss_mode else 0.0, stream)
  k1._raise_on(err, lib, "render_dyn_bwd", "render_dyn_bwd")
  return out


def _kw(steps, t_near, t_far, sigmoid_kind, sky_kind, spline_points,
        enc_kind):
  return dict(steps=steps, t_near=t_near, t_far=t_far,
              sigmoid_kind=sigmoid_kind, sky_kind=sky_kind,
              spline_points=spline_points, enc_kind=enc_kind)


def fused_dyn_render(params: Params, rays: torch.Tensor, times: torch.Tensor,
                     *, steps: int = 64, t_near: float = 2.0,
                     t_far: float = 6.0, sigmoid_kind: str = "thin",
                     sky_kind: str = "black", spline_points: int = 0,
                     enc_kind: str = "cp", want_dp: bool = False,
                     ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Render rays [N, 6] at each ray's time times [N] -> [N, 4] (rgb ‖ acc;
  with want_dp [N, 5], ‖ the per-ray mean of dp²) of a DynamicNeRF
  through K9f.

  params: a DynamicNeRF state_dict or its `pack_weights` vector (of
  `enc_kind` and `spline_points`). ts [T]: shared sample positions
  (default the uniform grid). Rays on a CUDA device launch the kernel on
  the current stream (and raise if it cannot launch); rays on the CPU
  take `dyn_render_reference`. The "random" sky is black. Each launch
  adds one to `fused_dyn_render.launches`."""
  kw = _kw(steps, t_near, t_far, sigmoid_kind, sky_kind, spline_points,
           enc_kind)
  if rays.device.type == "cpu":
    return dyn_render_reference(params, rays, times, want_dp=want_dp, ts=ts,
                                **kw)
  out = _forward_launch(pack_weights(params, rays.device, enc_kind,
                                     spline_points), rays, times,
                        want_dp=want_dp, ts=ts, **kw)
  fused_dyn_render.launches += 1
  return out


fused_dyn_render.launches = 0


def fused_dyn_render_grad(params: Params, rays: torch.Tensor,
                          times: torch.Tensor, g: torch.Tensor, *,
                          steps: int = 64, t_near: float = 2.0,
                          t_far: float = 6.0, sigmoid_kind: str = "thin",
                          sky_kind: str = "black", spline_points: int = 0,
                          enc_kind: str = "cp", want_dp: bool = False,
                          ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """K9b in cotangent mode: d(Σ g·out)/d(packed weights) for the render of
  rays [N, 6] at times [N] and the cotangent g [N, 4] (with want_dp
  [N, 5]: column 4 is the dp column's). CUDA rays launch
  render_dyn_bwd.cu (each launch adds one to
  `fused_dyn_render_grad.launches`); CPU rays take
  `dyn_render_grad_reference`."""
  kw = _kw(steps, t_near, t_far, sigmoid_kind, sky_kind, spline_points,
           enc_kind)
  if rays.device.type == "cpu":
    return dyn_render_grad_reference(params, rays, times, g, ts=ts,
                                     want_dp=want_dp, **kw)
  ws = pack_weights(params, rays.device, enc_kind, spline_points)
  out = _backward_launch(ws, rays, times, g, ts, want_dp=want_dp,
                         loss_mode=False, **kw)
  fused_dyn_render_grad.launches += 1
  return out[:ws.shape[0]]


fused_dyn_render_grad.launches = 0


def fused_dyn_train_step(params: Params, rays: torch.Tensor,
                         times: torch.Tensor, target: torch.Tensor,
                         ts: Optional[torch.Tensor] = None, *,
                         steps: int = 64, t_near: float = 2.0,
                         t_far: float = 6.0, sigmoid_kind: str = "thin",
                         sky_kind: str = "black", spline_points: int = 0,
                         enc_kind: str = "cp", dp_weight: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K9b in loss mode, the one-kernel train step: (loss, d loss/d(packed
  weights)) for loss = mean((render_rgb − target)²) + dp_weight ·
  mean(dp²), target [N, 3]; the kernel computes the loss, the dp term
  and their cotangents from its own forward. CUDA rays launch
  render_dyn_bwd.cu (each launch adds one to
  `fused_dyn_train_step.launches`); CPU rays take
  `dyn_train_step_reference`. `unpack_grads` maps the gradient onto the
  state_dict keys."""
  kw = _kw(steps, t_near, t_far, sigmoid_kind, sky_kind, spline_points,
           enc_kind)
  if rays.device.type == "cpu":
    return dyn_train_step_reference(params, rays, times, target, ts=ts,
                                    dp_weight=dp_weight, **kw)
  ws = pack_weights(params, rays.device, enc_kind, spline_points)
  out = _backward_launch(ws, rays, times, target, ts, want_dp=dp_weight != 0,
                         loss_mode=True, dp_weight=dp_weight, **kw)
  fused_dyn_train_step.launches += 1
  count = ws.shape[0]
  return out[count], out[:count]


fused_dyn_train_step.launches = 0


class DynRender(torch.autograd.Function):
  """K9f forward, K9b-G backward (render_dyn.py `_make_diff_dyn_render`):
  packed weights, rays [N, 6], times [N], ts [T] or None -> [N, 4]
  (want_dp: [N, 5]). The gradient goes to the packed weights only; rays,
  times and ts get none."""

  @staticmethod
  def forward(ctx, ws, rays, times, ts, kw):
    ctx.save_for_backward(ws, rays, times, ts)
    ctx.kw = kw
    return fused_dyn_render(ws.detach(), rays, times, ts=ts, **kw)

  @staticmethod
  def backward(ctx, g):
    ws, rays, times, ts = ctx.saved_tensors
    dws = fused_dyn_render_grad(ws.detach(), rays, times, g.contiguous(),
                                ts=ts, **ctx.kw)
    return dws, None, None, None, None


def fused_dyn_render_train(ws: torch.Tensor, rays: torch.Tensor,
                           times: torch.Tensor,
                           ts: Optional[torch.Tensor] = None, *,
                           steps: int = 64, t_near: float = 2.0,
                           t_far: float = 6.0, sigmoid_kind: str = "thin",
                           sky_kind: str = "black", spline_points: int = 0,
                           enc_kind: str = "cp",
                           want_dp: bool = False) -> torch.Tensor:
  """Differentiable render of a DynamicNeRF (the two-kernel train path):
  packed weights (a leaf that requires grad) -> [N, 4] (want_dp: [N, 5])
  through `DynRender`."""
  kw = dict(_kw(steps, t_near, t_far, sigmoid_kind, sky_kind, spline_points,
                enc_kind), want_dp=want_dp)
  return DynRender.apply(ws, rays, times, ts, kw)
