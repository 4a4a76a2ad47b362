"""K1: the fused forward render of the flagship PlainNeRF-CP model.

Counterpart of `nerf_atlas_tpu/ops/pallas/render.py:fused_plain_cp_render`
(kernel body `_render_kernel`). `plain_cp_render` launches the CUDA kernel
`csrc/render_fwd.cu` for rays on the GPU; `plain_cp_render_reference` is
the same function in plain torch, which the wrapper uses only for rays on
the CPU. See the kernel source for its design.

Weights travel as one packed float32 vector (`pack_weights`): the four CP
line tables [3, R, 8], then every Dense layer of the density MLP and of
the View MLP as W [in, out] row-major followed by its bias. The encoder
variants (posenc, tiny, mip, hash), the per-ray-ts and `want_weights`
forms and the backward kernels arrive with ROADMAP Queue 2 K2-K6.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Mapping, Tuple, Union

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


def sample_grid(steps: int, t_near: float, t_far: float, device=None):
  """The shared sample positions ts [T] and their segment lengths
  dists [T] with the 1e10 tail and 1e-5 clamp, unscaled by ||r_d||
  (render.py `_linspace_ts` / `_dists_base`)."""
  ts = torch.linspace(t_near, t_far, steps, device=device)
  return ts, integrate.dists_from_ts(ts)


def _check_call(ws: torch.Tensor, rays: torch.Tensor, steps: int,
                sigmoid_kind: str, sky_kind: str):
  if rays.dtype != torch.float32 or rays.ndim != 2 or rays.shape[1] != 6:
    raise ValueError(f"rays must be float32 [N, 6], got {rays.dtype} "
                     f"{tuple(rays.shape)}")
  if not rays.is_contiguous():
    raise ValueError("rays must be contiguous")
  if ws.device != rays.device:
    raise ValueError(f"weights on {ws.device}, rays on {rays.device}")
  if not 2 <= steps <= MAX_STEPS:
    raise ValueError(f"steps must be in [2, {MAX_STEPS}], got {steps}")
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
                              sky_kind: str = "black") -> torch.Tensor:
  """Plain-torch K1: rays [N, 6] -> [N, 4] (rgb ‖ acc), on any device.
  The "random" sky is black at eval."""
  ws = pack_weights(params, rays.device)
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind)
  lines, dense_layers, refl_layers = _unpack(ws)
  n = rays.shape[0]
  ts, dists = sample_grid(steps, t_near, t_far, rays.device)
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
                    sky_kind: str = "black") -> torch.Tensor:
  """Render rays [N, 6] -> [N, 4] (rgb ‖ acc) through K1.

  params: a PlainNeRF-CP state_dict or its `pack_weights` vector. Rays on
  a CUDA device launch the kernel on the current stream (and raise if it
  cannot launch); rays on the CPU take `plain_cp_render_reference`. The
  "random" sky is black at eval. Each launch adds one to
  `plain_cp_render.launches`."""
  if rays.device.type == "cpu":
    return plain_cp_render_reference(
        params, rays, steps=steps, t_near=t_near, t_far=t_far,
        sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
  if rays.device.type != "cuda":
    raise ValueError(f"plain_cp_render runs on cuda or cpu, not "
                     f"{rays.device}")
  ws = pack_weights(params, rays.device)
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind)
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  out = torch.empty((rays.shape[0], 4), dtype=torch.float32,
                    device=rays.device)
  if rays.shape[0] == 0:
    return out
  ts, dists = sample_grid(steps, t_near, t_far, rays.device)
  lib = _load_library()
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_fwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
      out.data_ptr(), rays.shape[0], steps,
      FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      stream)
  if err != 0:
    raise RuntimeError(f"render_fwd launch failed: CUDA error {err} "
                       f"({lib.render_fwd_error_string(err).decode()})")
  plain_cp_render.launches += 1
  return out


plain_cp_render.launches = 0
