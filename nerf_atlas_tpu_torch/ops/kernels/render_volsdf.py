"""K8f and K8b: the fused forward render of VolSDF and its backward, with
the eikonal regularizer computed inside the kernels.

Counterparts of `nerf_atlas_tpu/ops/pallas/render_volsdf.py`:
- `fused_volsdf_render` (K8f, kernel body `_vs_kernel`) launches
  `csrc/render_volsdf_fwd.cu` (built without and with the eikonal column,
  `fwd_defines`; its MLP products by TF32 wgmma from the wgmma pack of
  TC_MLPS, the column's transpose chain from `chain_pack`);
  `volsdf_render_reference` is its plain torch. With `want_eikonal` the
  output gains a 5th column, the per-ray mean of (‖∇ₓsdf‖ − 1)² over the
  sample points.
- `fused_volsdf_render_grad` (K8b in cotangent mode G, the autograd
  backward of K8f) and `fused_volsdf_train_step` (K8b in loss mode L, the
  one-kernel step: the L2 loss, plus `eikonal_weight` times the mean
  eikonal residual, and its gradient) launch
  `csrc/render_volsdf_bwd.cu`; `volsdf_render_grad_reference` and
  `volsdf_train_step_reference` are autograd through the plain K8f (the
  eikonal's second-order gradient by `torch.autograd.grad` with
  `create_graph=True`).
- `VolSDFRender` is the autograd Function K8f forward / K8b-G backward
  (`_make_diff_vs_render`), `fused_volsdf_render_train` its entry point.
Each wrapper launches its kernel for rays on the GPU (and raises if it
cannot) and takes its plain version for rays on the CPU. The sharded form
arrives with ROADMAP Queue 1 #12.

Weights travel as one packed float32 vector (`pack_weights`): the Laplace
scale s = softplus(raw) + 1e-4 (computed here, outside the kernels, so
that the raw parameter's gradient chains through softplus by autograd,
`unpack_grads`), the Fourier matrix B [3, 32] row-major, then every Dense
layer of the SDF MLP (`shape.mlp`) and of the View MLP (`refl.mlp`) as
W [in, out] row-major followed by its bias. Gradients come back in the
same layout; B's entries are 0 (B takes no gradient). The kernels cover
VolSDF at its default widths: `sdf_kind` mlp with 32 Fourier frequencies,
a 67 -> 256×6 -> 33 SDF MLP, `sdf_latent` 32, the View refl 37 -> 128×5
-> 3, `scale_kind` softplus.
"""
from __future__ import annotations

import ctypes
import functools
import types
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ...nn.encoders import fourier_phases
from ...nn.mlp import leaky_relu
from ..math import dir_to_elev_azim, laplace_cdf, load_sigmoid
from . import render as k1

# VolSDF architecture (must match models.VolSDF defaults)
N_FREQS = 32                                     # Fourier B [3, 32]
S_IN = 3 + 2 * N_FREQS                           # 67: p ‖ sin ‖ cos
S_HIDDEN, S_LAYERS = 256, 6
LATENT = 32                                      # sdf_latent
S_OUT = 1 + LATENT
R_IN = 3 + 2 + LATENT                            # 37: p ‖ elaz ‖ latent
MAX_STEPS = 2048                                 # csrc/render_volsdf_fwd.cu
BWD_MAX_STEPS = 512                              # csrc/render_volsdf_bwd.cu
SCALE_KEY = "density_scale"
B_KEY = "shape.mlp.enc.B"

LAYERS = tuple(
    k1._mlp_layout("shape.mlp", S_IN, S_HIDDEN, S_LAYERS, S_OUT)
    + k1._mlp_layout("refl.mlp", R_IN, k1.R_HIDDEN, k1.R_LAYERS, 3))
N_SDF_LAYERS = S_LAYERS + 2
B_OFFSET = 1                                     # after s
MLP_OFFSET = B_OFFSET + 3 * N_FREQS              # 97
WEIGHT_COUNT = MLP_OFFSET + sum(i * o + o for _, i, o in LAYERS)  # 552,325
# K8b's TC pack (render.tc_layout_index): the SDF MLP's, whose forward
# products (the recompute and the eikonal adjoint's) run in three parts,
# then the View's
TC_MLPS = ((MLP_OFFSET, LAYERS[:N_SDF_LAYERS], True),
           (MLP_OFFSET + sum(i * o + o for _, i, o in LAYERS[:N_SDF_LAYERS]),
            LAYERS[N_SDF_LAYERS:], False))
# K8f's forward takes the wgmma pack of TC_MLPS (its flags unread), its
# eikonal column the chain pack of the SDF MLP
CHAIN_MLPS = TC_MLPS[:1]
# K8f's eikonal keeps the signs of a tile's (64 points') SDF MLP
# activations, layer_in's and each hidden layer's, then of its init
# feature: 8 bytes a row (csrc/wgmma_tf32.cuh `sign_rows`)
SIGN_ROWS = (S_LAYERS + 1) * S_HIDDEN + S_IN                 # 1,859
SIGN_BYTES = 8 * SIGN_ROWS                                   # 14,872

Params = Union[Mapping[str, torch.Tensor], torch.Tensor]


def scale_of(raw: torch.Tensor) -> torch.Tensor:
  """s = softplus(raw) + 1e-4 (VolSDF.density_params, scale_kind
  softplus)."""
  return F.softplus(raw) + 1e-4


def _expected_shapes():
  shapes = {SCALE_KEY: (), B_KEY: (3, N_FREQS)}
  for name, i, o in LAYERS:
    shapes[f"{name}.weight"] = (o, i)
    shapes[f"{name}.bias"] = (o,)
  return shapes


def flatten_params(state_dict: Mapping[str, torch.Tensor]
                   ) -> List[torch.Tensor]:
  """VolSDF state_dict -> the kernels' tensors in packed order (s, B,
  Dense weights transposed to [in, out]). Raises on a divergent tree."""
  shapes = _expected_shapes()
  missing = sorted(set(shapes) - set(state_dict))
  extra = sorted(set(state_dict) - set(shapes))
  if missing or extra:
    raise KeyError(f"not the default VolSDF parameters: missing {missing}, "
                   f"unexpected {extra}")
  for key, shape in shapes.items():
    if tuple(state_dict[key].shape) != shape:
      raise ValueError(f"{key}: shape {tuple(state_dict[key].shape)}, the "
                       f"kernel needs {shape}")
  out = [scale_of(state_dict[SCALE_KEY]), state_dict[B_KEY]]
  for name, _, _ in LAYERS:
    out.append(state_dict[f"{name}.weight"].t())
    out.append(state_dict[f"{name}.bias"])
  return out


def pack_weights(params: Params, device=None) -> torch.Tensor:
  """state_dict (or an already packed vector) -> packed f32
  [WEIGHT_COUNT]."""
  if isinstance(params, torch.Tensor):
    if params.dtype != torch.float32 or params.shape != (WEIGHT_COUNT,):
      raise ValueError(f"packed VolSDF weights must be float32 "
                       f"[{WEIGHT_COUNT}], got {params.dtype} "
                       f"{tuple(params.shape)}")
    return params.to(device) if device is not None else params
  with torch.no_grad():
    flat = [t.detach().to(device=device, dtype=torch.float32).reshape(-1)
            for t in flatten_params(params)]
    return torch.cat(flat).contiguous()


def _check_packed(ws: torch.Tensor):
  if ws.ndim != 1 or ws.shape[0] != WEIGHT_COUNT:
    raise ValueError(f"not a packed VolSDF weight vector: shape "
                     f"{tuple(ws.shape)}")


def _unpack(ws: torch.Tensor):
  """Packed vector -> (s, B [3, 32], SDF [(W, b)], View [(W, b)])."""
  _check_packed(ws)
  pos, layers = MLP_OFFSET, []
  for _, i, o in LAYERS:
    layers.append((ws[pos:pos + i * o].view(i, o),
                   ws[pos + i * o:pos + i * o + o]))
    pos += i * o + o
  return (ws[0], ws[B_OFFSET:MLP_OFFSET].view(3, N_FREQS),
          layers[:N_SDF_LAYERS], layers[N_SDF_LAYERS:])


def unpack_grads(packed: torch.Tensor, raw_scale: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
  """Packed gradient -> {state_dict key: gradient}: Dense weights back to
  [out, in]; the scale's entry, d/ds, chained to the raw parameter
  `raw_scale` through s = softplus(raw) + 1e-4 by autograd; B takes no
  gradient and has no entry."""
  _, _, sdf_layers, refl_layers = _unpack(packed)
  out = {}
  for (name, _, _), (w, b) in zip(LAYERS, sdf_layers + refl_layers):
    out[f"{name}.weight"] = w.t().contiguous()
    out[f"{name}.bias"] = b
  with torch.enable_grad():
    raw = raw_scale.detach().to(packed.device).requires_grad_(True)
    (out[SCALE_KEY],) = torch.autograd.grad(scale_of(raw), raw, packed[0])
  return out


def sdf_init_feature(pts: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
  """The SDF MLP's init feature [P, 67] = p ‖ sin(2π·p·B) ‖ cos(2π·p·B)
  (`fourier_phases`: the kernels round the same operations in the same
  order)."""
  y = fourier_phases(pts, fb)
  return torch.cat([pts, torch.sin(y), torch.cos(y)], dim=-1)


def sphere_bias(pts: torch.Tensor) -> torch.Tensor:
  """‖p‖ − 1 with the squares summed in axis order (as the kernels)."""
  sq = pts * pts
  return torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2]) - 1.0


def volsdf_chain(ws: torch.Tensor, rays: torch.Tensor, ts: torch.Tensor,
                 sigmoid_kind: str, sphere_init: bool,
                 pts: Optional[torch.Tensor] = None, act=leaky_relu,
                 init: Optional[torch.Tensor] = None):
  """The per-point chain of the plain K8f: (σ [N·T], rgb [N·T, 3], sdf
  [N·T]) at the sample points r_o + t·r_d (rounded as the kernels round
  them, or the given `pts`, e.g. a leaf the eikonal differentiates by).
  `act` is the SDF MLP's leaky-relu (a test may pass one that records its
  inputs); `init` an SDF init feature to use in place of the points'.
  B enters as a constant: it takes no gradient (the JAX encoder's
  stop_gradient)."""
  s, fb, sdf_layers, refl_layers = _unpack(ws)
  fb = fb.detach()
  n, steps = rays.shape[0], ts.shape[0]
  if pts is None:
    pts = k1.hash_pts(rays, ts)
  if init is None:
    init = sdf_init_feature(pts, fb)
  out = k1._mlp(init, sdf_layers, act, S_LAYERS)
  sdf = out[:, 0]
  if sphere_init:
    sdf = sdf + sphere_bias(pts)
  sigma = laplace_cdf(-sdf, s) / s
  elaz = dir_to_elev_azim(rays[:, 3:6])[:, None, :].expand(
      n, steps, 2).reshape(-1, 2)
  r_in = torch.cat([pts, elaz, out[:, 1:]], dim=-1)
  rgb = load_sigmoid(sigmoid_kind)(
      k1._mlp(r_in, refl_layers, k1.siren_act, k1.R_LAYERS))
  return sigma, rgb, sdf


def eikonal_residual(sdf: torch.Tensor, pts: torch.Tensor, n: int,
                     create_graph: bool) -> torch.Tensor:
  """Per-ray mean over its T points of (‖∇ₓsdf‖ − 1)² [n], the gradient
  by autograd from `sdf` to the leaf `pts`."""
  (g,) = torch.autograd.grad(sdf.sum(), pts, create_graph=create_graph)
  e = torch.square(torch.linalg.vector_norm(g, dim=-1) - 1.0)
  return e.view(n, -1).mean(dim=-1)


def _check_call(ws: torch.Tensor, rays: torch.Tensor, steps: int,
                sigmoid_kind: str, sky_kind: str, max_steps: int):
  k1.check_rays(ws, rays, steps, sigmoid_kind, sky_kind, max_steps)
  _check_packed(ws)


def volsdf_render_reference(params: Params, rays: torch.Tensor, *,
                            steps: int = 64, t_near: float = 2.0,
                            t_far: float = 6.0, sigmoid_kind: str = "thin",
                            sky_kind: str = "black", sphere_init: bool = True,
                            want_eikonal: bool = False,
                            ts: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
  """Plain-torch K8f: rays [N, 6] -> [N, 4] (rgb ‖ acc), with
  want_eikonal [N, 5] (‖ the per-ray mean eikonal residual), on any
  device, differentiable in a packed weight vector (twice through the
  eikonal column). ts [T]: shared sample positions (default the uniform
  grid). σ enters the compositing through relu; the "random" sky is
  black, as the kernels render it. The output keeps a graph only when
  gradients are on and the weights require them."""
  ws = pack_weights(params, rays.device)
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, MAX_STEPS)
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  if not want_eikonal:
    sigma, rgb, _ = volsdf_chain(ws, rays, ts, sigmoid_kind, sphere_init)
    return k1.composite(sigma, rgb, rays[:, 3:6], dists, sky_kind,
                        relu=True)
  keep_graph = torch.is_grad_enabled() and ws.requires_grad
  with torch.enable_grad():
    pts = k1.hash_pts(rays, ts).detach().requires_grad_(True)
    sigma, rgb, sdf = volsdf_chain(ws, rays, ts, sigmoid_kind, sphere_init,
                                   pts=pts)
    eik = eikonal_residual(sdf, pts, rays.shape[0], keep_graph)
  out = torch.cat([k1.composite(sigma, rgb, rays[:, 3:6], dists, sky_kind,
                                relu=True), eik[:, None]], dim=-1)
  return out if keep_graph else out.detach()


def _leaf(params: Params, device) -> torch.Tensor:
  return pack_weights(params, device).detach().clone().requires_grad_(True)


def volsdf_render_grad_reference(params: Params, rays: torch.Tensor,
                                 g: torch.Tensor, **kw) -> torch.Tensor:
  """Plain K8b, mode G: d(Σ g·out)/d(packed weights) [WEIGHT_COUNT] for
  the cotangent g [N, 4] (with want_eikonal [N, 5]), by autograd through
  `volsdf_render_reference`."""
  ws = _leaf(params, rays.device)
  with torch.enable_grad():
    out = volsdf_render_reference(ws, rays, **kw)
    (dws,) = torch.autograd.grad(out, ws, g)
  return dws


def volsdf_train_step_reference(params: Params, rays: torch.Tensor,
                                target: torch.Tensor, *,
                                eikonal_weight: float = 0.0, **kw
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain K8b, mode L: (loss, d loss/d(packed weights)) for loss =
  mean((out_rgb − target)²) + eikonal_weight · mean over rays of the
  per-ray mean eikonal residual, by autograd through the plain K8f."""
  ws = _leaf(params, rays.device)
  with torch.enable_grad():
    out = volsdf_render_reference(ws, rays, want_eikonal=eikonal_weight != 0,
                                  **kw)
    loss = torch.mean((out[:, :3] - target) ** 2)
    if eikonal_weight:
      loss = loss + eikonal_weight * torch.mean(out[:, 4])
    (dws,) = torch.autograd.grad(loss, ws)
  return loss.detach(), dws


# ---------------------------------------------------------------------------
# the launchers (csrc/render_volsdf_fwd.cu, csrc/render_volsdf_bwd.cu)
# ---------------------------------------------------------------------------

def fwd_defines(want_eikonal: bool) -> Tuple[str, ...]:
  """The defines that build csrc/render_volsdf_fwd.cu in one mode: two
  libraries, compiled in parallel."""
  return (f"RENDER_VOLSDF_EIKONAL={int(want_eikonal)}",)


def _bind(name: str, n_ptr: int, n_int: int, n_float: int,
          counts: Tuple[str, ...],
          defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
  """Build (at first use) and bind csrc/<name>.cu (with `defines`): its
  launch function, the sizes `counts` and the constants it must share
  with this wrapper."""
  from . import build
  lib = build.load(name, defines)
  fn = getattr(lib, f"{name}_launch")
  fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                 + [ctypes.c_float] * n_float + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  for suffix in ("weight_count",) + counts:
    getattr(lib, f"{name}_{suffix}").argtypes = []
    getattr(lib, f"{name}_{suffix}").restype = ctypes.c_longlong
  getattr(lib, f"{name}_max_steps").argtypes = []
  getattr(lib, f"{name}_max_steps").restype = ctypes.c_int
  getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
  getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
  max_steps = MAX_STEPS if name.endswith("fwd") else BWD_MAX_STEPS
  count = getattr(lib, f"{name}_weight_count")()
  steps = getattr(lib, f"{name}_max_steps")()
  if count != WEIGHT_COUNT or steps != max_steps:
    raise RuntimeError(f"{name}.cu packs {count} weights and takes {steps} "
                       f"steps, the wrapper {WEIGHT_COUNT} and {max_steps}")
  return lib


@functools.lru_cache(maxsize=None)
def _load_fwd_library(want_eikonal: bool) -> ctypes.CDLL:
  lib = _bind("render_volsdf_fwd", 9, 6, 0,
              ("pack_floats", "chain_floats", "stash_bytes_per_slot"),
              fwd_defines(want_eikonal))
  lib.render_volsdf_fwd_stash_slots.restype = ctypes.c_int
  lib.render_volsdf_fwd_stash_slots.argtypes = []
  want = (k1.wgmma_layout_index(TC_MLPS, WEIGHT_COUNT)[0].numel(),
          chain_pack_floats() if want_eikonal else 0,
          2 * SIGN_BYTES if want_eikonal else 0)
  got = (lib.render_volsdf_fwd_pack_floats(),
         lib.render_volsdf_fwd_chain_floats(),
         lib.render_volsdf_fwd_stash_bytes_per_slot())
  if got != want:
    raise RuntimeError(f"render_volsdf_fwd.cu built for "
                       f"{fwd_defines(want_eikonal)} reports (pack floats, "
                       f"chain floats, stash bytes per slot) {got}, the "
                       f"wrapper {want}")
  return lib


@functools.lru_cache(maxsize=None)
def _load_bwd_library() -> ctypes.CDLL:
  lib = _bind("render_volsdf_bwd", 9, 8, 2,
              ("stash_floats_per_tile", "ustash_floats_per_block",
               "tc_floats"))
  want = k1.tc_layout_index(TC_MLPS, WEIGHT_COUNT)[0].numel()
  if lib.render_volsdf_bwd_tc_floats() != want:
    raise RuntimeError(f"render_volsdf_bwd.cu takes a TC pack of "
                       f"{lib.render_volsdf_bwd_tc_floats()} floats, the "
                       f"wrapper {want}")
  return lib


def chain_pack_floats() -> int:
  """Floats of K8f's chain pack (`chain_pack`)."""
  return k1.wgmma_layout_index(CHAIN_MLPS, WEIGHT_COUNT, True)[0].numel()


def chain_pack(ws: torch.Tensor) -> torch.Tensor:
  """The chain pack of K8f's eikonal column (render.py
  `wgmma_layout_index(..., transposed=True)` of the SDF MLP): each Dense
  layer's W as the B of the transpose chain's wgmma products, hi and
  lo."""
  return k1.wgmma_pack_mlps(ws, CHAIN_MLPS, transposed=True)


@functools.lru_cache(maxsize=None)
def _stash_slots(index: int) -> int:
  lib = _load_fwd_library(True)
  with torch.cuda.device(index):
    slots = lib.render_volsdf_fwd_stash_slots()
  if slots < 0:
    raise RuntimeError(f"render_volsdf_fwd (eikonal) on cuda:{index}: "
                       f"{lib.render_volsdf_fwd_error_string(-slots)!r}")
  if slots == 0:
    raise RuntimeError(f"no block of render_volsdf_fwd (eikonal) fits on "
                       f"cuda:{index}")
  return slots


def eikonal_scratch(device) -> Tuple[torch.Tensor, torch.Tensor]:
  """The sign scratch of one K8f eikonal launch on `device`: (stash
  uint8 [slots, 2, SIGN_BYTES], busy int32 [slots] of 0), a slot per SM
  id, at least one per block the card holds at once (132 on an H100
  80GB HBM3: 3.9 MB), whatever the number of rays. Each block keeps its
  two tiles' signs (`testing.sign_bytes`'s layout) in the slot it
  claims."""
  device = torch.device(device)
  slots = _stash_slots(device.index if device.index is not None
                       else torch.cuda.current_device())
  return (torch.empty((slots, 2, SIGN_BYTES), dtype=torch.uint8,
                      device=device),
          torch.zeros(slots, dtype=torch.int32, device=device))


def _sm_count(device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


def _rays_per_block(steps: int) -> int:
  return 1 if steps >= 64 else 64 // steps


def _forward_launch(ws: torch.Tensor, rays: torch.Tensor, *, steps: int,
                    t_near: float, t_far: float, sigmoid_kind: str,
                    sky_kind: str, sphere_init: bool, want_eikonal: bool,
                    ts: Optional[torch.Tensor],
                    scratch: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    = None) -> torch.Tensor:
  """One render_volsdf_fwd launch of the library built for
  `want_eikonal`: the weights' wgmma pack (and the chain pack) packed
  once per call; the eikonal's sign scratch is `scratch` (default a new
  `eikonal_scratch`)."""
  k1._check_cuda(rays, "render_volsdf_fwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, MAX_STEPS)
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  n = rays.shape[0]
  out = torch.empty((n, 5 if want_eikonal else 4), dtype=torch.float32,
                    device=rays.device)
  if n == 0:
    return out
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  lib = _load_fwd_library(want_eikonal)
  wp = k1.wgmma_pack_mlps(ws, TC_MLPS)
  wc = stash = busy = None
  if want_eikonal:
    wc = chain_pack(ws)
    stash, busy = scratch or eikonal_scratch(rays.device)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_volsdf_fwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
      wp.data_ptr(), k1._ptr(wc), k1._ptr(stash), k1._ptr(busy),
      out.data_ptr(), n, steps, k1.FUSED_SIGMOID_KINDS.index(sigmoid_kind),
      int(sky_kind == "white"), int(sphere_init),
      busy.numel() if want_eikonal else 0, stream)
  k1._raise_on(err, lib, "render_volsdf_fwd", "render_volsdf_fwd")
  return out


def _backward_launch(ws: torch.Tensor, rays: torch.Tensor, gin: torch.Tensor,
                     ts: Optional[torch.Tensor], *, steps: int, t_near: float,
                     t_far: float, sigmoid_kind: str, sky_kind: str,
                     sphere_init: bool, want_eikonal: bool, loss_mode: bool,
                     eikonal_weight: float = 0.0) -> torch.Tensor:
  """One render_volsdf_bwd launch (+ its partial reduction); returns
  [WEIGHT_COUNT + 1] = gradient ‖ loss."""
  k1._check_cuda(rays, "render_volsdf_bwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, BWD_MAX_STEPS)
  width = 3 if loss_mode else (5 if want_eikonal else 4)
  if (gin.dtype != torch.float32 or tuple(gin.shape) != (rays.shape[0], width)
      or gin.device != rays.device or not gin.is_contiguous()):
    raise ValueError(f"{'target' if loss_mode else 'g'} must be contiguous "
                     f"float32 [{rays.shape[0]}, {width}] on {rays.device}, "
                     f"got {gin.dtype} {tuple(gin.shape)} on {gin.device}")
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  n = rays.shape[0]
  out = torch.zeros(WEIGHT_COUNT + 1, dtype=torch.float32, device=rays.device)
  if n == 0:
    return out
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  lib = _load_bwd_library()
  rays_per_block = _rays_per_block(steps)
  tiles = -(-(rays_per_block * steps) // 64)
  blocks = min(-(-n // rays_per_block), _sm_count(rays.device))
  partial = torch.empty(blocks * (WEIGHT_COUNT + 1), dtype=torch.float32,
                        device=rays.device)
  stash = torch.empty(
      blocks * (tiles * lib.render_volsdf_bwd_stash_floats_per_tile()
                + lib.render_volsdf_bwd_ustash_floats_per_block()),
      dtype=torch.float32, device=rays.device)
  tcw = k1.tc_pack_mlps(ws, TC_MLPS)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_volsdf_bwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
      tcw.data_ptr(), gin.data_ptr(), out.data_ptr(), partial.data_ptr(),
      stash.data_ptr(), n, steps, blocks,
      k1.FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      int(sphere_init), int(want_eikonal), int(loss_mode),
      1.0 / (3 * n) if loss_mode else 0.0,
      eikonal_weight / n if loss_mode else 0.0, stream)
  k1._raise_on(err, lib, "render_volsdf_bwd", "render_volsdf_bwd")
  return out


def fused_volsdf_render(params: Params, rays: torch.Tensor, *,
                        steps: int = 64, t_near: float = 2.0,
                        t_far: float = 6.0, sigmoid_kind: str = "thin",
                        sky_kind: str = "black", sphere_init: bool = True,
                        want_eikonal: bool = False,
                        ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Render rays [N, 6] -> [N, 4] (rgb ‖ acc; with want_eikonal [N, 5],
  ‖ the per-ray mean eikonal residual) of a VolSDF through K8f.

  params: a VolSDF state_dict or its `pack_weights` vector. ts [T]:
  shared sample positions (default the uniform grid). Rays on a CUDA
  device launch the kernel on the current stream (and raise if it cannot
  launch); rays on the CPU take `volsdf_render_reference`. The "random"
  sky is black. Each launch adds one to `fused_volsdf_render.launches`,
  each of the eikonal build also to
  `fused_volsdf_render.eikonal.launches`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind,
            sphere_init=sphere_init, want_eikonal=want_eikonal, ts=ts)
  if rays.device.type == "cpu":
    return volsdf_render_reference(params, rays, **kw)
  out = _forward_launch(pack_weights(params, rays.device), rays, **kw)
  fused_volsdf_render.launches += 1
  if want_eikonal:
    fused_volsdf_render.eikonal.launches += 1
  return out


fused_volsdf_render.launches = 0
fused_volsdf_render.eikonal = types.SimpleNamespace(launches=0)


def fused_volsdf_render_grad(params: Params, rays: torch.Tensor,
                             g: torch.Tensor, *, steps: int = 64,
                             t_near: float = 2.0, t_far: float = 6.0,
                             sigmoid_kind: str = "thin",
                             sky_kind: str = "black",
                             sphere_init: bool = True,
                             want_eikonal: bool = False,
                             ts: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
  """K8b in cotangent mode: d(Σ g·out)/d(packed weights) [WEIGHT_COUNT]
  for the render of rays [N, 6] and the cotangent g [N, 4] (with
  want_eikonal [N, 5]: column 4 is the eikonal column's). CUDA rays
  launch render_volsdf_bwd.cu (each launch adds one to
  `fused_volsdf_render_grad.launches`); CPU rays take
  `volsdf_render_grad_reference`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind,
            sphere_init=sphere_init, want_eikonal=want_eikonal)
  if rays.device.type == "cpu":
    return volsdf_render_grad_reference(params, rays, g, ts=ts, **kw)
  out = _backward_launch(pack_weights(params, rays.device), rays, g, ts,
                         loss_mode=False, **kw)
  fused_volsdf_render_grad.launches += 1
  return out[:WEIGHT_COUNT]


fused_volsdf_render_grad.launches = 0


def fused_volsdf_train_step(params: Params, rays: torch.Tensor,
                            target: torch.Tensor,
                            ts: Optional[torch.Tensor] = None, *,
                            steps: int = 64, t_near: float = 2.0,
                            t_far: float = 6.0, sigmoid_kind: str = "thin",
                            sky_kind: str = "black", sphere_init: bool = True,
                            eikonal_weight: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K8b in loss mode, the one-kernel train step: (loss, d loss/d(packed
  weights)) for loss = mean((render(rays)_rgb − target)²) +
  eikonal_weight · mean over rays of the per-ray mean eikonal residual,
  target [N, 3]; the kernel computes the loss and its cotangents from
  its own forward. CUDA rays launch render_volsdf_bwd.cu (each launch
  adds one to `fused_volsdf_train_step.launches`); CPU rays take
  `volsdf_train_step_reference`. `unpack_grads` maps the gradient onto
  the state_dict keys."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind,
            sphere_init=sphere_init)
  if rays.device.type == "cpu":
    return volsdf_train_step_reference(params, rays, target, ts=ts,
                                       eikonal_weight=eikonal_weight, **kw)
  out = _backward_launch(pack_weights(params, rays.device), rays, target,
                         ts, loss_mode=True,
                         want_eikonal=eikonal_weight != 0,
                         eikonal_weight=eikonal_weight, **kw)
  fused_volsdf_train_step.launches += 1
  return out[WEIGHT_COUNT], out[:WEIGHT_COUNT]


fused_volsdf_train_step.launches = 0


class VolSDFRender(torch.autograd.Function):
  """K8f forward, K8b-G backward (render_volsdf.py `_make_diff_vs_render`):
  packed weights [WEIGHT_COUNT], rays [N, 6], ts [T] or None -> [N, 4]
  (want_eikonal: [N, 5]). The gradient goes to the packed weights only;
  rays and ts get none."""

  @staticmethod
  def forward(ctx, ws, rays, ts, kw):
    ctx.save_for_backward(ws, rays, ts)
    ctx.kw = kw
    return fused_volsdf_render(ws.detach(), rays, ts=ts, **kw)

  @staticmethod
  def backward(ctx, g):
    ws, rays, ts = ctx.saved_tensors
    dws = fused_volsdf_render_grad(ws.detach(), rays, g.contiguous(), ts=ts,
                                   **ctx.kw)
    return dws, None, None, None


def fused_volsdf_render_train(ws: torch.Tensor, rays: torch.Tensor,
                              ts: Optional[torch.Tensor] = None, *,
                              steps: int = 64, t_near: float = 2.0,
                              t_far: float = 6.0, sigmoid_kind: str = "thin",
                              sky_kind: str = "black",
                              sphere_init: bool = True,
                              want_eikonal: bool = False) -> torch.Tensor:
  """Differentiable render of a VolSDF (the two-kernel train path):
  packed weights (a leaf that requires grad) -> [N, 4] (want_eikonal:
  [N, 5]) through `VolSDFRender`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind,
            sphere_init=sphere_init, want_eikonal=want_eikonal)
  return VolSDFRender.apply(ws, rays, ts, kw)
