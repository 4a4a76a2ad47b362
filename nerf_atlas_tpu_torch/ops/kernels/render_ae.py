"""K7f and K7b: the fused forward render of NeRFAE and its backward.

Counterparts of `nerf_atlas_tpu/ops/pallas/render_ae.py`:
- `fused_ae_render` (K7f, kernel body `_ae_kernel`) launches
  `csrc/render_ae_fwd.cu`; `ae_render_reference` is its plain torch.
- `fused_ae_render_grad` (K7b in cotangent mode, the custom VJP's
  backward) and `fused_ae_train_step` (K7b in loss mode, the one-kernel
  L2 train step) launch `csrc/render_ae_bwd.cu`;
  `ae_render_grad_reference` and `ae_train_step_reference` are autograd
  through the plain K7f.
- `AERender` is the autograd Function K7f forward / K7b backward
  (`_make_diff_ae_render`), `fused_ae_render_train` its entry point.
Each wrapper launches its kernel for rays on the GPU (and raises if it
cannot) and takes its plain version for rays on the CPU. The sharded
forms arrive with ROADMAP Queue 1 #12.

Weights travel as one packed float32 vector (`pack_weights_ae`), in
`_flatten_params_ae` order: every Dense layer of the encoder (`encode`),
of `density_tfm` and of the View MLP (`refl.mlp`) as W [in, out]
row-major followed by its bias; gradients come back in the same layout
(`unpack_grads_ae` maps them onto state_dict keys). The kernels cover
NeRFAE at its default widths with `encoding_size` 32 and the latent
normalized.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch

from ...nn.encoders import PositionalEncoder
from ...nn.mlp import leaky_relu
from ..math import dir_to_elev_azim, load_sigmoid
from . import render as k1

# NeRFAE architecture (must match models.NeRFAE defaults)
POSENC = PositionalEncoder(input_dims=3, max_freq_log2=6, num_freqs=8)
E_IN = 3 + POSENC.size()                         # 51: raw ‖ sin ‖ cos
E_HIDDEN, E_LAYERS = 256, 5
ENC_SIZE = 32
D_HIDDEN, D_LAYERS = 128, 4
R_IN = 3 + 2 + ENC_SIZE + k1.INTERMEDIATE        # 69: p ‖ elaz ‖ enc ‖ feats
MAX_STEPS = 2048                                 # csrc/render_ae_fwd.cu
BWD_MAX_STEPS = 512                              # csrc/render_ae_bwd.cu

LAYERS = tuple(
    k1._mlp_layout("encode", E_IN, E_HIDDEN, E_LAYERS, ENC_SIZE)
    + k1._mlp_layout("density_tfm", ENC_SIZE, D_HIDDEN, D_LAYERS,
                     1 + k1.INTERMEDIATE)
    + k1._mlp_layout("refl.mlp", R_IN, k1.R_HIDDEN, k1.R_LAYERS, 3))
N_ENC_LAYERS = E_LAYERS + 2
N_DT_LAYERS = D_LAYERS + 2
WEIGHT_COUNT = sum(i * o + o for _, i, o in LAYERS)         # 564,804


def _mlp_offsets():
  pos, out = 0, []
  for group in (LAYERS[:N_ENC_LAYERS],
                LAYERS[N_ENC_LAYERS:N_ENC_LAYERS + N_DT_LAYERS],
                LAYERS[N_ENC_LAYERS + N_DT_LAYERS:]):
    out.append((pos, group))
    pos += sum(i * o + o for _, i, o in group)
  return out


# K7b's TC pack (render.tc_layout_index; csrc/render_ae.cuh E_THREE,
# D_THREE, R_THREE mirror the flags): the encoder's, density_tfm's and the
# View's. The two leaky MLPs run their forward products (the recompute,
# whose pre-activations decide the backward's act′) in three parts, the
# siren View in two.
TC_MLPS = tuple((pos, group, three) for (pos, group), three in
                zip(_mlp_offsets(), (True, True, False)))

Params = Union[Mapping[str, torch.Tensor], torch.Tensor]


def freqs(device=None) -> torch.Tensor:
  """The 8 posenc bands, float32 2^linspace(0, 6, 8) as the module's
  PositionalEncoder computes them on `device` (the kernels take them as
  an input, so that kernel and plain version multiply by the same
  bits)."""
  return POSENC.freqs(device)


def _expected_shapes():
  shapes = {}
  for name, i, o in LAYERS:
    shapes[f"{name}.weight"] = (o, i)
    shapes[f"{name}.bias"] = (o,)
  return shapes


def flatten_params_ae(state_dict: Mapping[str, torch.Tensor]
                      ) -> List[torch.Tensor]:
  """NeRFAE state_dict -> the kernels' tensors in packed order (Dense
  weights transposed to [in, out]). Raises on a divergent tree."""
  shapes = _expected_shapes()
  missing = sorted(set(shapes) - set(state_dict))
  extra = sorted(set(state_dict) - set(shapes))
  if missing or extra:
    raise KeyError(f"not the default NeRFAE parameters: missing {missing}, "
                   f"unexpected {extra}")
  for key, shape in shapes.items():
    if tuple(state_dict[key].shape) != shape:
      raise ValueError(f"{key}: shape {tuple(state_dict[key].shape)}, the "
                       f"kernel needs {shape}")
  out = []
  for name, _, _ in LAYERS:
    out.append(state_dict[f"{name}.weight"].t())
    out.append(state_dict[f"{name}.bias"])
  return out


def pack_weights_ae(params: Params, device=None) -> torch.Tensor:
  """state_dict (or an already packed vector) -> packed f32
  [WEIGHT_COUNT]."""
  if isinstance(params, torch.Tensor):
    if params.dtype != torch.float32 or params.shape != (WEIGHT_COUNT,):
      raise ValueError(f"packed NeRFAE weights must be float32 "
                       f"[{WEIGHT_COUNT}], got {params.dtype} "
                       f"{tuple(params.shape)}")
    return params.to(device) if device is not None else params
  with torch.no_grad():
    flat = [t.detach().to(device=device, dtype=torch.float32).reshape(-1)
            for t in flatten_params_ae(params)]
    return torch.cat(flat).contiguous()


def _check_packed(ws: torch.Tensor):
  if ws.ndim != 1 or ws.shape[0] != WEIGHT_COUNT:
    raise ValueError(f"not a packed NeRFAE weight vector: shape "
                     f"{tuple(ws.shape)}")


def _unpack(ws: torch.Tensor):
  """Packed vector -> (encoder, density_tfm, View) lists of (W, b)."""
  _check_packed(ws)
  pos, layers = 0, []
  for _, i, o in LAYERS:
    layers.append((ws[pos:pos + i * o].view(i, o),
                   ws[pos + i * o:pos + i * o + o]))
    pos += i * o + o
  return (layers[:N_ENC_LAYERS], layers[N_ENC_LAYERS:-k1.R_LAYERS - 2],
          layers[-k1.R_LAYERS - 2:])


def unpack_grads_ae(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
  """Packed weights or gradient -> {state_dict key: tensor} (the inverse
  of `pack_weights_ae`: Dense weights back to [out, in])."""
  out = {}
  for (name, _, _), (w, b) in zip(LAYERS, sum(_unpack(packed), [])):
    out[f"{name}.weight"] = w.t().contiguous()
    out[f"{name}.bias"] = b
  return out


def ae_chain(ws: torch.Tensor, rays: torch.Tensor, ts: torch.Tensor,
             sigmoid_kind: str, act=leaky_relu):
  """The per-point chain of the plain K7f: (raw density [N·T], rgb
  [N·T, 3]) at the sample points r_o + t·r_d (rounded as the kernels
  round them). `act` is the encoder's and density_tfm's leaky-relu (a
  test may pass one that records its inputs)."""
  enc_layers, dt_layers, refl_layers = _unpack(ws)
  n, steps = rays.shape[0], ts.shape[0]
  pts = k1.hash_pts(rays, ts)
  xb = (pts[:, :, None] * freqs(pts.device)).reshape(pts.shape[0], -1)
  init = torch.cat([pts, torch.sin(xb), torch.cos(xb)], dim=-1)
  raw = k1._mlp(init, enc_layers, act, E_LAYERS)
  enc = raw / torch.clamp(
      torch.linalg.vector_norm(raw, dim=-1, keepdim=True), min=1e-6)
  out = k1._mlp(enc, dt_layers, act, D_LAYERS)
  elaz = dir_to_elev_azim(rays[:, 3:6])[:, None, :].expand(
      n, steps, 2).reshape(-1, 2)
  r_in = torch.cat([pts, elaz, enc, out[:, 1:]], dim=-1)
  rgb = load_sigmoid(sigmoid_kind)(
      k1._mlp(r_in, refl_layers, k1.siren_act, k1.R_LAYERS))
  return out[:, 0], rgb


def _check_call(ws: torch.Tensor, rays: torch.Tensor, steps: int,
                sigmoid_kind: str, sky_kind: str, max_steps: int):
  k1.check_rays(ws, rays, steps, sigmoid_kind, sky_kind, max_steps)
  _check_packed(ws)


def ae_render_reference(params: Params, rays: torch.Tensor, *,
                        steps: int = 64, t_near: float = 2.0,
                        t_far: float = 6.0, sigmoid_kind: str = "thin",
                        sky_kind: str = "black",
                        ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Plain-torch K7f: rays [N, 6] -> [N, 4] (rgb ‖ acc), on any device,
  differentiable in a packed weight vector. ts [T]: shared sample
  positions (default the uniform grid). The "random" sky is black, as
  the kernels render it."""
  ws = pack_weights_ae(params, rays.device)
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, MAX_STEPS)
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  density, rgb = ae_chain(ws, rays, ts, sigmoid_kind)
  return k1.composite(density, rgb, rays[:, 3:6], dists, sky_kind)


def _leaf(params: Params, device) -> torch.Tensor:
  return pack_weights_ae(params, device).detach().clone().requires_grad_(
      True)


def ae_render_grad_reference(params: Params, rays: torch.Tensor,
                             g: torch.Tensor, **kw) -> torch.Tensor:
  """Plain K7b, mode G: d(Σ g·out)/d(packed weights) [WEIGHT_COUNT] for
  the cotangent g [N, 4], by autograd through `ae_render_reference`."""
  ws = _leaf(params, rays.device)
  with torch.enable_grad():
    out = ae_render_reference(ws, rays, **kw)
    (dws,) = torch.autograd.grad(out, ws, g)
  return dws


def ae_train_step_reference(params: Params, rays: torch.Tensor,
                            target: torch.Tensor, **kw
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain K7b, mode L: (loss, d loss/d(packed weights)) for loss =
  mean((out_rgb − target)²), by autograd through the plain K7f."""
  ws = _leaf(params, rays.device)
  with torch.enable_grad():
    out = ae_render_reference(ws, rays, **kw)
    loss = torch.mean((out[:, :3] - target) ** 2)
    (dws,) = torch.autograd.grad(loss, ws)
  return loss.detach(), dws


# ---------------------------------------------------------------------------
# the launchers (csrc/render_ae_fwd.cu, csrc/render_ae_bwd.cu)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _load_fwd_library() -> ctypes.CDLL:
  """Build (at first use) and bind csrc/render_ae_fwd.cu."""
  from . import build
  lib = build.load("render_ae_fwd")
  lib.render_ae_fwd_launch.argtypes = (
      [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
  lib.render_ae_fwd_launch.restype = ctypes.c_int
  lib.render_ae_fwd_weight_count.argtypes = []
  lib.render_ae_fwd_weight_count.restype = ctypes.c_longlong
  lib.render_ae_fwd_max_steps.argtypes = []
  lib.render_ae_fwd_max_steps.restype = ctypes.c_int
  lib.render_ae_fwd_error_string.argtypes = [ctypes.c_int]
  lib.render_ae_fwd_error_string.restype = ctypes.c_char_p
  if (lib.render_ae_fwd_weight_count() != WEIGHT_COUNT
      or lib.render_ae_fwd_max_steps() != MAX_STEPS):
    raise RuntimeError(
        f"render_ae_fwd.cu packs {lib.render_ae_fwd_weight_count()} weights "
        f"and takes {lib.render_ae_fwd_max_steps()} steps, the wrapper "
        f"{WEIGHT_COUNT} and {MAX_STEPS}")
  return lib


@functools.lru_cache(maxsize=None)
def _load_bwd_library() -> ctypes.CDLL:
  """Build (at first use) and bind csrc/render_ae_bwd.cu."""
  from . import build
  lib = build.load("render_ae_bwd")
  lib.render_ae_bwd_launch.argtypes = (
      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
      + [ctypes.c_float, ctypes.c_void_p])
  lib.render_ae_bwd_launch.restype = ctypes.c_int
  for fn in ("render_ae_bwd_weight_count",
             "render_ae_bwd_stash_floats_per_tile", "render_ae_bwd_tc_floats"):
    getattr(lib, fn).argtypes = []
    getattr(lib, fn).restype = ctypes.c_longlong
  lib.render_ae_bwd_max_steps.argtypes = []
  lib.render_ae_bwd_max_steps.restype = ctypes.c_int
  lib.render_ae_bwd_error_string.argtypes = [ctypes.c_int]
  lib.render_ae_bwd_error_string.restype = ctypes.c_char_p
  tc = k1.tc_layout_index(TC_MLPS, WEIGHT_COUNT)[0].numel()
  if (lib.render_ae_bwd_weight_count() != WEIGHT_COUNT
      or lib.render_ae_bwd_max_steps() != BWD_MAX_STEPS
      or lib.render_ae_bwd_tc_floats() != tc):
    raise RuntimeError(
        f"render_ae_bwd.cu packs {lib.render_ae_bwd_weight_count()} weights "
        f"and takes {lib.render_ae_bwd_max_steps()} steps and a TC pack of "
        f"{lib.render_ae_bwd_tc_floats()} floats, the wrapper "
        f"{WEIGHT_COUNT}, {BWD_MAX_STEPS} and {tc}")
  return lib


def _forward_launch(ws: torch.Tensor, rays: torch.Tensor, *, steps: int,
                    t_near: float, t_far: float, sigmoid_kind: str,
                    sky_kind: str, ts: Optional[torch.Tensor]
                    ) -> torch.Tensor:
  """One render_ae_fwd launch."""
  k1._check_cuda(rays, "render_ae_fwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, MAX_STEPS)
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  out = torch.empty((rays.shape[0], 4), dtype=torch.float32,
                    device=rays.device)
  if rays.shape[0] == 0:
    return out
  ts, dists = k1.sample_grid(steps, t_near, t_far, rays.device, ts)
  fq = freqs(rays.device)
  lib = _load_fwd_library()
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_ae_fwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), fq.data_ptr(),
      ws.data_ptr(), out.data_ptr(), rays.shape[0], steps,
      k1.FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      stream)
  k1._raise_on(err, lib, "render_ae_fwd", "render_ae_fwd")
  return out


def _backward_launch(ws: torch.Tensor, rays: torch.Tensor, gin: torch.Tensor,
                     ts: Optional[torch.Tensor], *, steps: int, t_near: float,
                     t_far: float, sigmoid_kind: str, sky_kind: str,
                     loss_mode: bool) -> torch.Tensor:
  """One render_ae_bwd launch (+ its partial reduction); returns
  [WEIGHT_COUNT + 1] = gradient ‖ loss."""
  k1._check_cuda(rays, "render_ae_bwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, BWD_MAX_STEPS)
  width = 3 if loss_mode else 4
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
  rays_per_block = 1 if steps >= 64 else 64 // steps
  ray_blocks = -(-n // rays_per_block)
  tiles = -(-(rays_per_block * steps) // 64)
  blocks = min(ray_blocks, torch.cuda.get_device_properties(
      rays.device).multi_processor_count)
  partial = torch.empty(blocks * (WEIGHT_COUNT + 1), dtype=torch.float32,
                        device=rays.device)
  stash = torch.empty(
      blocks * tiles * lib.render_ae_bwd_stash_floats_per_tile(),
      dtype=torch.float32, device=rays.device)
  tcw = k1.tc_pack_mlps(ws, TC_MLPS)
  fq = freqs(rays.device)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_ae_bwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), fq.data_ptr(),
      ws.data_ptr(), tcw.data_ptr(), gin.data_ptr(), out.data_ptr(),
      partial.data_ptr(), stash.data_ptr(), n, steps, blocks,
      k1.FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      int(loss_mode), 1.0 / (3 * n) if loss_mode else 0.0, stream)
  k1._raise_on(err, lib, "render_ae_bwd", "render_ae_bwd")
  return out


def fused_ae_render(params: Params, rays: torch.Tensor, *, steps: int = 64,
                    t_near: float = 2.0, t_far: float = 6.0,
                    sigmoid_kind: str = "thin", sky_kind: str = "black",
                    ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Render rays [N, 6] -> [N, 4] (rgb ‖ acc) of a NeRFAE through K7f.

  params: a NeRFAE state_dict or its `pack_weights_ae` vector. ts [T]:
  shared sample positions (default the uniform grid). Rays on a CUDA
  device launch the kernel on the current stream (and raise if it cannot
  launch); rays on the CPU take `ae_render_reference`. The "random" sky
  is black. Each launch adds one to `fused_ae_render.launches`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return ae_render_reference(params, rays, **kw)
  out = _forward_launch(pack_weights_ae(params, rays.device), rays, **kw)
  fused_ae_render.launches += 1
  return out


fused_ae_render.launches = 0


def fused_ae_render_grad(params: Params, rays: torch.Tensor, g: torch.Tensor,
                         *, steps: int = 64, t_near: float = 2.0,
                         t_far: float = 6.0, sigmoid_kind: str = "thin",
                         sky_kind: str = "black",
                         ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """K7b in cotangent mode: d(Σ g·out)/d(packed weights) [WEIGHT_COUNT]
  for the render of rays [N, 6] and the cotangent g [N, 4]. CUDA rays
  launch render_ae_bwd.cu (each launch adds one to
  `fused_ae_render_grad.launches`); CPU rays take
  `ae_render_grad_reference`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
  if rays.device.type == "cpu":
    return ae_render_grad_reference(params, rays, g, ts=ts, **kw)
  out = _backward_launch(pack_weights_ae(params, rays.device), rays, g, ts,
                         loss_mode=False, **kw)
  fused_ae_render_grad.launches += 1
  return out[:WEIGHT_COUNT]


fused_ae_render_grad.launches = 0


def fused_ae_train_step(params: Params, rays: torch.Tensor,
                        target: torch.Tensor,
                        ts: Optional[torch.Tensor] = None, *,
                        steps: int = 64, t_near: float = 2.0,
                        t_far: float = 6.0, sigmoid_kind: str = "thin",
                        sky_kind: str = "black"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K7b in loss mode, the one-kernel train step: (loss, d loss/d(packed
  weights)) for loss = mean((render(rays)_rgb − target)²), target
  [N, 3]; the kernel computes the loss and its cotangent from its own
  forward. CUDA rays launch render_ae_bwd.cu (each launch adds one to
  `fused_ae_train_step.launches`); CPU rays take
  `ae_train_step_reference`. `unpack_grads_ae` maps the gradient onto
  the state_dict keys."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
  if rays.device.type == "cpu":
    return ae_train_step_reference(params, rays, target, ts=ts, **kw)
  out = _backward_launch(pack_weights_ae(params, rays.device), rays, target,
                         ts, loss_mode=True, **kw)
  fused_ae_train_step.launches += 1
  return out[WEIGHT_COUNT], out[:WEIGHT_COUNT]


fused_ae_train_step.launches = 0


class AERender(torch.autograd.Function):
  """K7f forward, K7b backward (render_ae.py `_make_diff_ae_render`):
  packed weights [WEIGHT_COUNT], rays [N, 6], ts [T] or None -> [N, 4].
  The gradient goes to the packed weights only; rays and ts get none."""

  @staticmethod
  def forward(ctx, ws, rays, ts, steps, t_near, t_far, sigmoid_kind,
              sky_kind):
    ctx.save_for_backward(ws, rays, ts)
    ctx.kw = dict(steps=steps, t_near=t_near, t_far=t_far,
                  sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
    return fused_ae_render(ws.detach(), rays, ts=ts, **ctx.kw)

  @staticmethod
  def backward(ctx, g):
    ws, rays, ts = ctx.saved_tensors
    dws = fused_ae_render_grad(ws.detach(), rays, g.contiguous(), ts=ts,
                               **ctx.kw)
    return dws, None, None, None, None, None, None, None


def fused_ae_render_train(ws: torch.Tensor, rays: torch.Tensor,
                          ts: Optional[torch.Tensor] = None, *,
                          steps: int = 64, t_near: float = 2.0,
                          t_far: float = 6.0, sigmoid_kind: str = "thin",
                          sky_kind: str = "black") -> torch.Tensor:
  """Differentiable render of a NeRFAE (the two-kernel train path):
  packed weights (a leaf that requires grad) -> [N, 4] through
  `AERender`."""
  return AERender.apply(ws, rays, ts, steps, t_near, t_far, sigmoid_kind,
                        sky_kind)
