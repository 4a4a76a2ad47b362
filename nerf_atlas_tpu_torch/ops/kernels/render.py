"""K1 and K2/K3: the fused forward render of the flagship PlainNeRF-CP
model and its backward.

Counterparts of `nerf_atlas_tpu/ops/pallas/render.py`:
- `plain_cp_render` (K1, kernel body `_render_kernel`) launches
  `csrc/render_fwd.cu`; `plain_cp_render_reference` is its plain torch.
- `plain_cp_render_grad` (K2, `_render_bwd_kernel`) and
  `plain_cp_train_step` (K3, its loss mode, `fused_plain_cp_train_step`)
  launch `csrc/render_bwd.cu`; `plain_cp_render_grad_reference` and
  `plain_cp_train_step_reference` are autograd through the plain K1.
- `PlainCPRender` is the autograd Function K1 forward / K2 backward
  (`_make_diff_render`), `plain_cp_render_train` its entry point.
Each wrapper launches its kernel for rays on the GPU (and raises if it
cannot) and takes its plain version for rays on the CPU. See the kernel
sources for their design.

Weights travel as one packed float32 vector (`pack_weights`): the four CP
line tables [3, R, 8], then every Dense layer of the density MLP and of
the View MLP as W [in, out] row-major followed by its bias; gradients
come back in the same layout (`unpack_grads` maps them onto state_dict
keys). The encoder variants (posenc, tiny, mip, hash), per-ray ts and
`want_weights` arrive with ROADMAP Queue 2 K4-K6.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import integrate
from ..math import dir_to_elev_azim, load_sigmoid
from ...nn.encoders import cp_encode

# flagship architecture (must match models.PlainNeRF defaults)
CP_RESOLUTIONS = (16, 32, 64, 128)
CP_RANK = 8
ENC_DIM = len(CP_RESOLUTIONS) * CP_RANK          # 32
FEAT_IN = 3 + ENC_DIM                            # density MLP input: raw ‖ enc
HIDDEN = 256
N_LAYERS = 5
SKIP = 3
INTERMEDIATE = 32
R_IN = 3 + 2 + INTERMEDIATE                      # refl input: p ‖ elaz ‖ feats
R_HIDDEN = 128
R_LAYERS = 5
SIREN_W0 = 30.0

# rgb activations the kernel implements, in the kernel's index order
FUSED_SIGMOID_KINDS = ("thin", "fat", "normal", "upshifted", "tanh",
                       "relu", "upshifted_relu", "leaky_relu")
MAX_STEPS = 2048                                 # csrc/render_fwd.cu
BWD_MAX_STEPS = 1024                             # csrc/render_bwd.cu

Params = Union[Mapping[str, torch.Tensor], torch.Tensor]


def _skip_at(i: int, num_layers: int, skip: int = SKIP) -> bool:
  return i % skip == 0 and i != num_layers - 1


def _mlp_layout(prefix: str, in_size: int, hidden: int, n_layers: int,
                out: int) -> List[Tuple[str, int, int]]:
  """(module path, in, out) of each Dense layer of a SkipConnMLP."""
  layers = [(f"{prefix}.layer_in", in_size, hidden)]
  for i in range(n_layers):
    width = hidden + (in_size if _skip_at(i, n_layers) else 0)
    layers.append((f"{prefix}.layer_{i}", width, hidden))
  layers.append((f"{prefix}.layer_out", hidden, out))
  return layers


DENSITY_LAYERS = _mlp_layout("density_mlp", FEAT_IN, HIDDEN, N_LAYERS,
                             1 + INTERMEDIATE)
REFL_LAYERS = _mlp_layout("refl.mlp", R_IN, R_HIDDEN, R_LAYERS, 3)
LINE_SHAPES = [(f"density_mlp.enc.lines_{li}", (3, r, CP_RANK))
               for li, r in enumerate(CP_RESOLUTIONS)]
WEIGHT_COUNT = (sum(3 * r * CP_RANK for r in CP_RESOLUTIONS)
                + sum(i * o + o for _, i, o in DENSITY_LAYERS + REFL_LAYERS))


def _expected_shapes():
  shapes = dict(LINE_SHAPES)
  for name, i, o in DENSITY_LAYERS + REFL_LAYERS:
    shapes[f"{name}.weight"] = (o, i)
    shapes[f"{name}.bias"] = (o,)
  return shapes


def flatten_params(state_dict: Mapping[str, torch.Tensor]
                   ) -> List[torch.Tensor]:
  """PlainNeRF-CP state_dict -> the kernel's tensors in packed order
  (Dense weights transposed to [in, out]). Raises on a divergent tree."""
  shapes = _expected_shapes()
  missing = sorted(set(shapes) - set(state_dict))
  extra = sorted(set(state_dict) - set(shapes))
  if missing or extra:
    raise KeyError(f"not the flagship PlainNeRF-CP parameters: missing "
                   f"{missing}, unexpected {extra}")
  for key, shape in shapes.items():
    if tuple(state_dict[key].shape) != shape:
      raise ValueError(f"{key}: shape {tuple(state_dict[key].shape)}, the "
                       f"kernel needs {shape}")
  out = [state_dict[k] for k, _ in LINE_SHAPES]
  for name, _, _ in DENSITY_LAYERS + REFL_LAYERS:
    out.append(state_dict[f"{name}.weight"].t())
    out.append(state_dict[f"{name}.bias"])
  return out


def pack_weights(params: Params, device=None) -> torch.Tensor:
  """state_dict (or an already packed vector) -> packed f32 [WEIGHT_COUNT]."""
  if isinstance(params, torch.Tensor):
    if params.dtype != torch.float32 or params.shape != (WEIGHT_COUNT,):
      raise ValueError(f"packed weights must be float32 [{WEIGHT_COUNT}], "
                       f"got {params.dtype} {tuple(params.shape)}")
    return params.to(device) if device is not None else params
  with torch.no_grad():
    flat = [t.detach().to(device=device, dtype=torch.float32).reshape(-1)
            for t in flatten_params(params)]
    return torch.cat(flat).contiguous()


def _unpack(ws: torch.Tensor):
  """Packed vector -> (lines list, density [(W, b)], refl [(W, b)])."""
  pos = 0

  def take(n, shape):
    nonlocal pos
    t = ws[pos:pos + n].view(shape)
    pos += n
    return t

  lines = [take(3 * r * CP_RANK, (3, r, CP_RANK)) for r in CP_RESOLUTIONS]
  mlps = []
  for layout in (DENSITY_LAYERS, REFL_LAYERS):
    mlps.append([(take(i * o, (i, o)), take(o, (o,))) for _, i, o in layout])
  return lines, mlps[0], mlps[1]


def unpack_grads(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
  """Packed weights or gradient [WEIGHT_COUNT] -> {state_dict key: tensor}
  (the inverse of `flatten_params` + `pack_weights`: Dense weights back
  to [out, in])."""
  lines, dense_layers, refl_layers = _unpack(packed)
  out = {name: t for (name, _), t in zip(LINE_SHAPES, lines)}
  for (name, _, _), (w, b) in zip(DENSITY_LAYERS + REFL_LAYERS,
                                  dense_layers + refl_layers):
    out[f"{name}.weight"] = w.t().contiguous()
    out[f"{name}.bias"] = b
  return out


def sample_grid(steps: int, t_near: float, t_far: float, device=None,
                ts: Optional[torch.Tensor] = None):
  """The shared sample positions ts [T] (the uniform grid, or the given
  ones, e.g. a stratified-jittered draw) and their segment lengths
  dists [T] with the 1e10 tail and 1e-5 clamp, unscaled by ||r_d||
  (render.py `_linspace_ts` / `_dists_base`)."""
  if ts is None:
    ts = torch.linspace(t_near, t_far, steps, device=device)
  elif (ts.dtype != torch.float32 or tuple(ts.shape) != (steps,)
        or ts.device != torch.device(device) or not ts.is_contiguous()):
    raise ValueError(f"ts must be contiguous float32 [{steps}] on {device}, "
                     f"got {ts.dtype} {tuple(ts.shape)} on {ts.device}")
  return ts, integrate.dists_from_ts(ts)


def _check_call(ws: torch.Tensor, rays: torch.Tensor, steps: int,
                sigmoid_kind: str, sky_kind: str,
                max_steps: int = MAX_STEPS):
  if rays.dtype != torch.float32 or rays.ndim != 2 or rays.shape[1] != 6:
    raise ValueError(f"rays must be float32 [N, 6], got {rays.dtype} "
                     f"{tuple(rays.shape)}")
  if not rays.is_contiguous():
    raise ValueError("rays must be contiguous")
  if ws.device != rays.device:
    raise ValueError(f"weights on {ws.device}, rays on {rays.device}")
  if not 2 <= steps <= max_steps:
    raise ValueError(f"steps must be in [2, {max_steps}], got {steps}")
  if sigmoid_kind not in FUSED_SIGMOID_KINDS:
    raise NotImplementedError(f"fused kernel: rgb act {sigmoid_kind}")
  if sky_kind not in integrate.SKY_KINDS:
    raise NotImplementedError(f"fused kernel: sky {sky_kind}")


def _mlp(init_feat, layers, act, n_layers):
  """SkipConnMLP with split skip matmuls: layer i's weight splits into its
  hidden rows and init-feature rows, act(h)·W_h + act(f)·W_f."""
  f_act = act(init_feat)
  w, b = layers[0]
  h = init_feat @ w + b
  for i in range(n_layers):
    w, b = layers[i + 1]
    if _skip_at(i, n_layers):
      hidden = w.shape[1]
      h = act(h) @ w[:hidden] + f_act @ w[hidden:] + b
    else:
      h = act(h) @ w + b
  w, b = layers[-1]
  return act(h) @ w + b


def plain_cp_render_reference(params: Params, rays: torch.Tensor, *,
                              steps: int = 64, t_near: float = 2.0,
                              t_far: float = 6.0,
                              sigmoid_kind: str = "thin",
                              sky_kind: str = "black",
                              ts: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
  """Plain-torch K1: rays [N, 6] -> [N, 4] (rgb ‖ acc), on any device,
  differentiable in a packed weight vector. ts [T]: shared sample
  positions (default the uniform grid). The "random" sky is black, as
  the kernels render it."""
  ws = pack_weights(params, rays.device)
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind)
  lines, dense_layers, refl_layers = _unpack(ws)
  n = rays.shape[0]
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts)
  r_o, r_d = rays[:, :3], rays[:, 3:6]
  pts = (r_o[:, None, :] + ts[None, :, None] * r_d[:, None, :]).reshape(-1, 3)

  xn = torch.clamp((pts + 1.0) * 0.5, 0.0, 1.0)     # the [-1, 1] CP bbox
  init_feat = torch.cat([pts, cp_encode(xn, lines)], dim=-1)
  out = _mlp(init_feat, dense_layers, lambda v: F.leaky_relu(v, 0.01),
             N_LAYERS)
  density, feats = out[:, 0], out[:, 1:]
  elaz = dir_to_elev_azim(r_d)[:, None, :].expand(n, steps, 2).reshape(-1, 2)
  r_in = torch.cat([pts, elaz, feats], dim=-1)
  rgb = load_sigmoid(sigmoid_kind)(
      _mlp(r_in, refl_layers, lambda v: torch.sin(SIREN_W0 * v), R_LAYERS))

  sigma = F.softplus(density - 1.0).reshape(n, steps)
  seg = dists[None, :] * torch.linalg.vector_norm(r_d, dim=-1, keepdim=True)
  alpha = 1.0 - torch.exp(-sigma * seg)
  trans = integrate.exclusive_cumprod(torch.clamp(1.0 - alpha, min=1e-10))
  weights = alpha * trans
  acc = weights.sum(-1, keepdim=True)
  img = (weights[..., None] * rgb.reshape(n, steps, 3)).sum(1)
  if sky_kind == "white":
    img = img + (1.0 - (acc - weights[:, -1:]))
  return torch.cat([img, acc], dim=-1)


def _check_cuda(rays: torch.Tensor, name: str):
  if rays.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu, not {rays.device}")


def _raise_on(err: int, lib, what: str, prefix: str):
  if err != 0:
    msg = getattr(lib, f"{prefix}_error_string")(err).decode()
    raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
  """Build (at first use) and bind csrc/render_fwd.cu."""
  from . import build
  lib = build.load("render_fwd")
  lib.render_fwd_launch.argtypes = [
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_void_p]
  lib.render_fwd_launch.restype = ctypes.c_int
  lib.render_fwd_weight_count.argtypes = []
  lib.render_fwd_weight_count.restype = ctypes.c_longlong
  lib.render_fwd_error_string.argtypes = [ctypes.c_int]
  lib.render_fwd_error_string.restype = ctypes.c_char_p
  if lib.render_fwd_weight_count() != WEIGHT_COUNT:
    raise RuntimeError(
        f"render_fwd.cu packs {lib.render_fwd_weight_count()} weights, "
        f"the wrapper {WEIGHT_COUNT}")
  return lib


def plain_cp_render(params: Params, rays: torch.Tensor, *, steps: int = 64,
                    t_near: float = 2.0, t_far: float = 6.0,
                    sigmoid_kind: str = "thin",
                    sky_kind: str = "black",
                    ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Render rays [N, 6] -> [N, 4] (rgb ‖ acc) through K1.

  params: a PlainNeRF-CP state_dict or its `pack_weights` vector. ts [T]:
  shared sample positions (default the uniform grid). Rays on a CUDA
  device launch the kernel on the current stream (and raise if it cannot
  launch); rays on the CPU take `plain_cp_render_reference`. The "random"
  sky is black. Each launch adds one to `plain_cp_render.launches`."""
  if rays.device.type == "cpu":
    return plain_cp_render_reference(
        params, rays, steps=steps, t_near=t_near, t_far=t_far,
        sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  _check_cuda(rays, "plain_cp_render")
  ws = pack_weights(params, rays.device).detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind)
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  out = torch.empty((rays.shape[0], 4), dtype=torch.float32,
                    device=rays.device)
  if rays.shape[0] == 0:
    return out
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts)
  lib = _load_library()
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_fwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
      out.data_ptr(), rays.shape[0], steps,
      FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      stream)
  _raise_on(err, lib, "render_fwd", "render_fwd")
  plain_cp_render.launches += 1
  return out


plain_cp_render.launches = 0


# ---------------------------------------------------------------------------
# K2/K3: the backward (csrc/render_bwd.cu) and its plain versions
# ---------------------------------------------------------------------------

def _leaf(params: Params, device) -> torch.Tensor:
  return pack_weights(params, device).detach().clone().requires_grad_(True)


def plain_cp_render_grad_reference(params: Params, rays: torch.Tensor,
                                   g: torch.Tensor, *, steps: int = 64,
                                   t_near: float = 2.0, t_far: float = 6.0,
                                   sigmoid_kind: str = "thin",
                                   sky_kind: str = "black",
                                   ts: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
  """Plain K2: d(Σ g·out)/d(packed weights) [WEIGHT_COUNT] for the
  cotangent g [N, 4], by autograd through `plain_cp_render_reference`."""
  ws = _leaf(params, rays.device)
  with torch.enable_grad():
    out = plain_cp_render_reference(
        ws, rays, steps=steps, t_near=t_near, t_far=t_far,
        sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
    (dws,) = torch.autograd.grad(out, ws, g)
  return dws


def plain_cp_train_step_reference(params: Params, rays: torch.Tensor,
                                  target: torch.Tensor, *, steps: int = 64,
                                  t_near: float = 2.0, t_far: float = 6.0,
                                  sigmoid_kind: str = "thin",
                                  sky_kind: str = "black",
                                  ts: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain K3: (loss, d loss/d(packed weights)) for loss =
  mean((out_rgb − target)²), by autograd through the plain K1."""
  ws = _leaf(params, rays.device)
  with torch.enable_grad():
    out = plain_cp_render_reference(
        ws, rays, steps=steps, t_near=t_near, t_far=t_far,
        sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
    loss = torch.mean((out[:, :3] - target) ** 2)
    (dws,) = torch.autograd.grad(loss, ws)
  return loss.detach(), dws


@functools.lru_cache(maxsize=None)
def _load_bwd_library() -> ctypes.CDLL:
  """Build (at first use) and bind csrc/render_bwd.cu."""
  from . import build
  lib = build.load("render_bwd")
  lib.render_bwd_launch.argtypes = (
      [ctypes.c_void_p] * 9
      + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
  lib.render_bwd_launch.restype = ctypes.c_int
  for fn in ("render_bwd_weight_count", "render_bwd_stash_floats_per_tile"):
    getattr(lib, fn).argtypes = []
    getattr(lib, fn).restype = ctypes.c_longlong
  lib.render_bwd_max_steps.argtypes = []
  lib.render_bwd_max_steps.restype = ctypes.c_int
  lib.render_bwd_error_string.argtypes = [ctypes.c_int]
  lib.render_bwd_error_string.restype = ctypes.c_char_p
  if (lib.render_bwd_weight_count() != WEIGHT_COUNT
      or lib.render_bwd_max_steps() != BWD_MAX_STEPS):
    raise RuntimeError(
        f"render_bwd.cu packs {lib.render_bwd_weight_count()} weights and "
        f"takes {lib.render_bwd_max_steps()} steps, the wrapper "
        f"{WEIGHT_COUNT} and {BWD_MAX_STEPS}")
  return lib


_TRANSPOSE_INDEX: Dict[torch.device, torch.Tensor] = {}


def _transposed(ws: torch.Tensor) -> torch.Tensor:
  """The packed vector with every Dense W [in, out] stored as [out, in]
  at the same offset (render_bwd.cu reads W row by output unit for the
  input-gradient products)."""
  index = _TRANSPOSE_INDEX.get(ws.device)
  if index is None:
    index = torch.arange(WEIGHT_COUNT)
    pos = sum(3 * r * CP_RANK for r in CP_RESOLUTIONS)
    for _, i, o in DENSITY_LAYERS + REFL_LAYERS:
      index[pos:pos + i * o] = pos + torch.arange(i * o).view(i, o).t(
      ).reshape(-1)
      pos += i * o + o
    index = _TRANSPOSE_INDEX.setdefault(ws.device, index.to(ws.device))
  return ws[index]


def _backward_launch(ws: torch.Tensor, rays: torch.Tensor,
                     gin: torch.Tensor, ts: Optional[torch.Tensor], *,
                     steps: int, t_near: float, t_far: float,
                     sigmoid_kind: str, sky_kind: str, loss_mode: bool
                     ) -> torch.Tensor:
  """One render_bwd launch (+ its partial reduction); returns
  [WEIGHT_COUNT + 1] = gradient ‖ loss."""
  _check_cuda(rays, "render_bwd")
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
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts)
  lib = _load_bwd_library()
  rays_per_block = 1 if steps >= 64 else 64 // steps
  ray_blocks = -(-n // rays_per_block)
  tiles = -(-(rays_per_block * steps) // 64)
  blocks = min(ray_blocks, torch.cuda.get_device_properties(
      rays.device).multi_processor_count)
  partial = torch.empty(blocks * (WEIGHT_COUNT + 1), dtype=torch.float32,
                        device=rays.device)
  stash = torch.empty(blocks * tiles * lib.render_bwd_stash_floats_per_tile(),
                      dtype=torch.float32, device=rays.device)
  wt = _transposed(ws)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_bwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
      wt.data_ptr(), gin.data_ptr(), out.data_ptr(), partial.data_ptr(),
      stash.data_ptr(), n, steps, blocks,
      FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      int(loss_mode), 1.0 / (3 * n) if loss_mode else 0.0, stream)
  _raise_on(err, lib, "render_bwd", "render_bwd")
  return out


def plain_cp_render_grad(params: Params, rays: torch.Tensor, g: torch.Tensor,
                         *, steps: int = 64, t_near: float = 2.0,
                         t_far: float = 6.0, sigmoid_kind: str = "thin",
                         sky_kind: str = "black",
                         ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """K2: d(Σ g·out)/d(packed weights) [WEIGHT_COUNT] for the render of
  rays [N, 6] and the cotangent g [N, 4]. CUDA rays launch render_bwd.cu
  in mode G (each launch adds one to `plain_cp_render_grad.launches`);
  CPU rays take `plain_cp_render_grad_reference`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_cp_render_grad_reference(params, rays, g, **kw)
  out = _backward_launch(pack_weights(params, rays.device), rays, g,
                         loss_mode=False, **kw)
  plain_cp_render_grad.launches += 1
  return out[:WEIGHT_COUNT]


plain_cp_render_grad.launches = 0


def plain_cp_train_step(params: Params, rays: torch.Tensor,
                        target: torch.Tensor, *, steps: int = 64,
                        t_near: float = 2.0, t_far: float = 6.0,
                        sigmoid_kind: str = "thin", sky_kind: str = "black",
                        ts: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K3, the one-kernel train step: (loss, d loss/d(packed weights)) for
  loss = mean((render(rays)_rgb − target)²), target [N, 3]. CUDA rays
  launch render_bwd.cu in mode L, which computes the loss and its
  cotangent from its own forward (each launch adds one to
  `plain_cp_train_step.launches`); CPU rays take
  `plain_cp_train_step_reference`. `unpack_grads` maps the gradient onto
  the state_dict keys."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_cp_train_step_reference(params, rays, target, **kw)
  out = _backward_launch(pack_weights(params, rays.device), rays, target,
                         loss_mode=True, **kw)
  plain_cp_train_step.launches += 1
  return out[WEIGHT_COUNT], out[:WEIGHT_COUNT]


plain_cp_train_step.launches = 0


class PlainCPRender(torch.autograd.Function):
  """K1 forward, K2 backward (render.py `_make_diff_render`): packed
  weights [WEIGHT_COUNT], rays [N, 6], ts [T] or None -> [N, 4]. The
  gradient goes to the packed weights only; rays and ts get none."""

  @staticmethod
  def forward(ctx, ws, rays, ts, steps, t_near, t_far, sigmoid_kind,
              sky_kind):
    ctx.save_for_backward(ws, rays, ts)
    ctx.kw = dict(steps=steps, t_near=t_near, t_far=t_far,
                  sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
    return plain_cp_render(ws.detach(), rays, ts=ts, **ctx.kw)

  @staticmethod
  def backward(ctx, g):
    ws, rays, ts = ctx.saved_tensors
    dws = plain_cp_render_grad(ws.detach(), rays, g.contiguous(), ts=ts,
                               **ctx.kw)
    return dws, None, None, None, None, None, None, None


def plain_cp_render_train(ws: torch.Tensor, rays: torch.Tensor,
                          ts: Optional[torch.Tensor] = None, *,
                          steps: int = 64, t_near: float = 2.0,
                          t_far: float = 6.0, sigmoid_kind: str = "thin",
                          sky_kind: str = "black") -> torch.Tensor:
  """Differentiable render (the two-kernel train path): packed weights
  (a leaf that requires grad) -> [N, 4] through `PlainCPRender`."""
  return PlainCPRender.apply(ws, rays, ts, steps, t_near, t_far,
                             sigmoid_kind, sky_kind)
