"""K1 and K2/K3: the fused forward render of PlainNeRF and its backward,
for the CP encoder and for the hash-grid feature stream.

Counterparts of `nerf_atlas_tpu/ops/pallas/render.py`:
- `plain_cp_render` (K1, kernel body `_render_kernel`) launches
  `csrc/render_fwd.cu`; `plain_cp_render_reference` is its plain torch.
- `plain_cp_render_grad` (K2, `_render_bwd_kernel`) and
  `plain_cp_train_step` (K3, its loss mode, `fused_plain_cp_train_step`)
  launch `csrc/render_bwd.cu`; `plain_cp_render_grad_reference` and
  `plain_cp_train_step_reference` are autograd through the plain K1.
- `PlainCPRender` is the autograd Function K1 forward / K2 backward
  (`_make_diff_render`), `plain_cp_render_train` its entry point.
- The hash mode (enc_kind "hash"): `plain_hash_render`,
  `plain_hash_render_grad` and `plain_hash_train_step` run the same two
  kernels with the CP encode replaced by a read of each sample point's
  16 hash-grid features (`feats` [N·T, 16], from K5f,
  `hash_encode.py`); the backward also returns the feature cotangent
  dfeat [N·T, 16]. `PlainHashRender` is `_make_diff_render_hash`;
  `fused_plain_hash_render` (K5f + K1), `fused_plain_hash_render_train`
  (differentiable in the weights and the table) and
  `fused_plain_hash_train_step` (K5f + K3 + K5b) are the JAX functions
  of the same names.
Each wrapper launches its kernel for rays on the GPU (and raises if it
cannot) and takes its plain version for rays on the CPU. See the kernel
sources for their design.

Weights travel as one packed float32 vector (`pack_weights`): for cp the
four CP line tables [3, R, 8], then (both kinds) every Dense layer of the
density MLP and of the View MLP as W [in, out] row-major followed by its
bias; gradients come back in the same layout (`unpack_grads` maps them
onto state_dict keys). The hash table is not packed: it travels as its
own tensor. The other encoder variants (posenc, tiny, mip), per-ray ts
and `want_weights` arrive with ROADMAP Queue 2 K4-K6.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import integrate
from ..math import dir_to_elev_azim, load_sigmoid
from ...nn.encoders import cp_encode
from . import hash_encode as hk

# flagship architecture (must match models.PlainNeRF defaults)
CP_RESOLUTIONS = (16, 32, 64, 128)
CP_RANK = 8
ENC_DIM = len(CP_RESOLUTIONS) * CP_RANK          # 32
FEAT_IN = 3 + ENC_DIM                            # density MLP input: raw ‖ enc
HASH_DIM = hk.LEVELS * hk.FEATURES               # 16
HASH_FEAT_IN = 3 + HASH_DIM                      # raw ‖ hash features
HIDDEN = 256
N_LAYERS = 5
SKIP = 3
INTERMEDIATE = 32
R_IN = 3 + 2 + INTERMEDIATE                      # refl input: p ‖ elaz ‖ feats
R_HIDDEN = 128
R_LAYERS = 5
SIREN_W0 = 30.0
HASH_TABLE_KEY = "density_mlp.enc.table"

# rgb activations the kernel implements, in the kernel's index order
FUSED_SIGMOID_KINDS = ("thin", "fat", "normal", "upshifted", "tanh",
                       "relu", "upshifted_relu", "leaky_relu")
ENC_KINDS = ("cp", "hash")                       # the kernels' `enc` index
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


@dataclass(frozen=True)
class Layout:
  """The packed weight vector of one encoder kind: the CP line tables
  (cp only), then the density and View MLPs' Dense layers."""
  enc_kind: str
  feat_in: int
  line_shapes: Tuple[Tuple[str, Tuple[int, int, int]], ...]
  density_layers: Tuple[Tuple[str, int, int], ...]
  refl_layers: Tuple[Tuple[str, int, int], ...]

  @property
  def line_count(self) -> int:
    return sum(3 * s[1] * s[2] for _, s in self.line_shapes)

  @property
  def weight_count(self) -> int:
    return self.line_count + sum(i * o + o for _, i, o in
                                 self.density_layers + self.refl_layers)


def _make_layout(enc_kind: str, feat_in: int, lines) -> Layout:
  return Layout(enc_kind, feat_in, tuple(lines),
                tuple(_mlp_layout("density_mlp", feat_in, HIDDEN, N_LAYERS,
                                  1 + INTERMEDIATE)),
                tuple(_mlp_layout("refl.mlp", R_IN, R_HIDDEN, R_LAYERS, 3)))


LAYOUTS = {
    "cp": _make_layout("cp", FEAT_IN,
                       [(f"density_mlp.enc.lines_{li}", (3, r, CP_RANK))
                        for li, r in enumerate(CP_RESOLUTIONS)]),
    "hash": _make_layout("hash", HASH_FEAT_IN, []),
}
WEIGHT_COUNT = LAYOUTS["cp"].weight_count                 # 467,620
HASH_WEIGHT_COUNT = LAYOUTS["hash"].weight_count          # 449,572


def _layout_of(ws: torch.Tensor) -> Layout:
  """The layout of a packed vector, by its length (the two differ)."""
  for layout in LAYOUTS.values():
    if ws.ndim == 1 and ws.shape[0] == layout.weight_count:
      return layout
  raise ValueError(f"not a packed weight vector: shape {tuple(ws.shape)}")


def _expected_shapes(layout: Layout):
  shapes = dict(layout.line_shapes)
  for name, i, o in layout.density_layers + layout.refl_layers:
    shapes[f"{name}.weight"] = (o, i)
    shapes[f"{name}.bias"] = (o,)
  return shapes


def flatten_params(state_dict: Mapping[str, torch.Tensor],
                   enc_kind: str = "cp") -> List[torch.Tensor]:
  """PlainNeRF state_dict -> the kernel's tensors in packed order (Dense
  weights transposed to [in, out]). For hash the state_dict also holds
  the table, which is checked (`hash_table`) and not packed. Raises on a
  divergent tree."""
  layout = LAYOUTS[enc_kind]
  shapes = _expected_shapes(layout)
  known = set(shapes) | ({HASH_TABLE_KEY} if enc_kind == "hash" else set())
  missing = sorted(known - set(state_dict))
  extra = sorted(set(state_dict) - known)
  if missing or extra:
    raise KeyError(f"not the flagship PlainNeRF-{enc_kind} parameters: "
                   f"missing {missing}, unexpected {extra}")
  for key, shape in shapes.items():
    if tuple(state_dict[key].shape) != shape:
      raise ValueError(f"{key}: shape {tuple(state_dict[key].shape)}, the "
                       f"kernel needs {shape}")
  if enc_kind == "hash":
    hash_table(state_dict)
  out = [state_dict[k] for k, _ in layout.line_shapes]
  for name, _, _ in layout.density_layers + layout.refl_layers:
    out.append(state_dict[f"{name}.weight"].t())
    out.append(state_dict[f"{name}.bias"])
  return out


def hash_table(state_dict: Mapping[str, torch.Tensor]) -> torch.Tensor:
  """The hash table [8·T, 2] of a PlainNeRF-hash state_dict (T a power of
  two); raises on any other shape."""
  table = state_dict[HASH_TABLE_KEY]
  hk._table_size(table)
  return table


def pack_weights(params: Params, device=None,
                 enc_kind: str = "cp") -> torch.Tensor:
  """state_dict (or an already packed vector) -> packed f32
  [weight count of `enc_kind`]."""
  count = LAYOUTS[enc_kind].weight_count
  if isinstance(params, torch.Tensor):
    if params.dtype != torch.float32 or params.shape != (count,):
      raise ValueError(f"packed {enc_kind} weights must be float32 [{count}], "
                       f"got {params.dtype} {tuple(params.shape)}")
    return params.to(device) if device is not None else params
  with torch.no_grad():
    flat = [t.detach().to(device=device, dtype=torch.float32).reshape(-1)
            for t in flatten_params(params, enc_kind)]
    return torch.cat(flat).contiguous()


def _unpack(ws: torch.Tensor):
  """Packed vector -> (lines list, density [(W, b)], refl [(W, b)])."""
  layout = _layout_of(ws)
  pos = 0

  def take(n, shape):
    nonlocal pos
    t = ws[pos:pos + n].view(shape)
    pos += n
    return t

  lines = [take(3 * s[1] * s[2], s) for _, s in layout.line_shapes]
  mlps = []
  for layers in (layout.density_layers, layout.refl_layers):
    mlps.append([(take(i * o, (i, o)), take(o, (o,))) for _, i, o in layers])
  return lines, mlps[0], mlps[1]


def unpack_grads(packed: torch.Tensor) -> Dict[str, torch.Tensor]:
  """Packed weights or gradient (either layout, told apart by length) ->
  {state_dict key: tensor} (the inverse of `flatten_params` +
  `pack_weights`: Dense weights back to [out, in])."""
  layout = _layout_of(packed)
  lines, dense_layers, refl_layers = _unpack(packed)
  out = {name: t for (name, _), t in zip(layout.line_shapes, lines)}
  for (name, _, _), (w, b) in zip(layout.density_layers + layout.refl_layers,
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


def hash_pts(rays: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
  """Sample points [N·T, 3], r_o + t·r_d rounded after the product and
  after the sum (render.py `_hash_pts`): the points K5f encodes are the
  points K1/K2/K3 feed the MLP."""
  return (rays[:, None, :3] + ts[None, :, None] * rays[:, None, 3:6]
          ).reshape(-1, 3)


def _check_call(ws: torch.Tensor, rays: torch.Tensor, steps: int,
                sigmoid_kind: str, sky_kind: str,
                max_steps: int = MAX_STEPS,
                feats: Optional[torch.Tensor] = None):
  check_rays(ws, rays, steps, sigmoid_kind, sky_kind, max_steps)
  if (feats is None) != (_layout_of(ws).enc_kind == "cp"):
    raise ValueError("hash weights take feats, cp weights none")
  if feats is not None and (
      feats.dtype != torch.float32
      or tuple(feats.shape) != (rays.shape[0] * steps, HASH_DIM)
      or feats.device != rays.device or not feats.is_contiguous()):
    raise ValueError(f"feats must be contiguous float32 "
                     f"[{rays.shape[0] * steps}, {HASH_DIM}] on "
                     f"{rays.device}, got {feats.dtype} "
                     f"{tuple(feats.shape)} on {feats.device}")


def check_rays(ws: torch.Tensor, rays: torch.Tensor, steps: int,
               sigmoid_kind: str, sky_kind: str, max_steps: int):
  """The checks every render kernel's wrapper makes: rays contiguous
  float32 [N, 6] beside the weights, steps in range, an rgb activation
  and a sky the kernels implement."""
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


def _plain_render(ws: torch.Tensor, rays: torch.Tensor,
                  feats: Optional[torch.Tensor], *, steps: int,
                  t_near: float, t_far: float, sigmoid_kind: str,
                  sky_kind: str, ts: Optional[torch.Tensor]) -> torch.Tensor:
  """The plain K1 of either layout: the CP encode from the packed lines,
  or the given hash features [N·T, 16]."""
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, feats=feats)
  lines, dense_layers, refl_layers = _unpack(ws)
  n = rays.shape[0]
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts)
  r_d = rays[:, 3:6]
  pts = hash_pts(rays, ts)
  if feats is None:
    xn = torch.clamp((pts + 1.0) * 0.5, 0.0, 1.0)   # the [-1, 1] CP bbox
    feats = cp_encode(xn, lines)
  init_feat = torch.cat([pts, feats], dim=-1)
  out = _mlp(init_feat, dense_layers, lambda v: F.leaky_relu(v, 0.01),
             N_LAYERS)
  density, latent = out[:, 0], out[:, 1:]
  elaz = dir_to_elev_azim(r_d)[:, None, :].expand(n, steps, 2).reshape(-1, 2)
  r_in = torch.cat([pts, elaz, latent], dim=-1)
  rgb = load_sigmoid(sigmoid_kind)(
      _mlp(r_in, refl_layers, siren_act, R_LAYERS))
  return composite(density, rgb, r_d, dists, sky_kind)


def siren_act(v):
  return torch.sin(SIREN_W0 * v)


def composite(density: torch.Tensor, rgb: torch.Tensor, r_d: torch.Tensor,
              dists: torch.Tensor, sky_kind: str) -> torch.Tensor:
  """The kernels' compositing in plain torch: raw density [N·T] and rgb
  [N·T, 3] of N rays -> [N, 4] (rgb ‖ acc); sigma = softplus(density −
  1), the exclusive transmittance of max(1 − alpha, 1e-10), a white sky
  over the leftover transmittance without the 1e10 tail."""
  n, steps = r_d.shape[0], dists.shape[0]
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
  return _plain_render(pack_weights(params, rays.device), rays, None,
                       steps=steps, t_near=t_near, t_far=t_far,
                       sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)


def plain_hash_render_reference(params: Params, rays: torch.Tensor,
                                feats: torch.Tensor, *, steps: int = 64,
                                t_near: float = 2.0, t_far: float = 6.0,
                                sigmoid_kind: str = "thin",
                                sky_kind: str = "black",
                                ts: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
  """Plain-torch K1 in hash mode: rays [N, 6] and the sample points' hash
  features feats [N·T, 16] -> [N, 4], differentiable in the packed
  weights and in feats."""
  return _plain_render(pack_weights(params, rays.device, "hash"), rays,
                       feats, steps=steps, t_near=t_near, t_far=t_far,
                       sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)


def _check_cuda(rays: torch.Tensor, name: str):
  if rays.device.type != "cuda":
    raise ValueError(f"{name} runs on cuda or cpu, not {rays.device}")


def _raise_on(err: int, lib, what: str, prefix: str):
  if err != 0:
    msg = getattr(lib, f"{prefix}_error_string")(err).decode()
    raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
  return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _load_library() -> ctypes.CDLL:
  """Build (at first use) and bind csrc/render_fwd.cu."""
  from . import build
  lib = build.load("render_fwd")
  lib.render_fwd_launch.argtypes = [
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
  lib.render_fwd_launch.restype = ctypes.c_int
  lib.render_fwd_weight_count.argtypes = [ctypes.c_int]
  lib.render_fwd_weight_count.restype = ctypes.c_longlong
  lib.render_fwd_error_string.argtypes = [ctypes.c_int]
  lib.render_fwd_error_string.restype = ctypes.c_char_p
  for enc, kind in enumerate(ENC_KINDS):
    if lib.render_fwd_weight_count(enc) != LAYOUTS[kind].weight_count:
      raise RuntimeError(
          f"render_fwd.cu packs {lib.render_fwd_weight_count(enc)} {kind} "
          f"weights, the wrapper {LAYOUTS[kind].weight_count}")
  return lib


def _forward_launch(ws: torch.Tensor, rays: torch.Tensor,
                    feats: Optional[torch.Tensor], *, steps: int,
                    t_near: float, t_far: float, sigmoid_kind: str,
                    sky_kind: str, ts: Optional[torch.Tensor]
                    ) -> torch.Tensor:
  """One render_fwd launch (CP mode without feats, hash mode with)."""
  _check_cuda(rays, "render_fwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, feats=feats)
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
      _ptr(feats), out.data_ptr(), rays.shape[0], steps,
      FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      ENC_KINDS.index(_layout_of(ws).enc_kind), stream)
  _raise_on(err, lib, "render_fwd", "render_fwd")
  return out


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
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_cp_render_reference(params, rays, **kw)
  out = _forward_launch(pack_weights(params, rays.device), rays, None, **kw)
  plain_cp_render.launches += 1
  return out


plain_cp_render.launches = 0


def plain_hash_render(params: Params, rays: torch.Tensor,
                      feats: torch.Tensor, *, steps: int = 64,
                      t_near: float = 2.0, t_far: float = 6.0,
                      sigmoid_kind: str = "thin", sky_kind: str = "black",
                      ts: Optional[torch.Tensor] = None) -> torch.Tensor:
  """K1 in hash mode: rays [N, 6] and the sample points' features feats
  [N·T, 16] (ray-major, from K5f on `hash_pts`) -> [N, 4]. params: a
  PlainNeRF-hash state_dict or its packed MLP weights. CUDA rays launch
  render_fwd.cu (each launch adds one to `plain_hash_render.launches`);
  CPU rays take `plain_hash_render_reference`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_hash_render_reference(params, rays, feats, **kw)
  out = _forward_launch(pack_weights(params, rays.device, "hash"), rays,
                        feats.detach(), **kw)
  plain_hash_render.launches += 1
  return out


plain_hash_render.launches = 0


# ---------------------------------------------------------------------------
# K2/K3: the backward (csrc/render_bwd.cu) and its plain versions
# ---------------------------------------------------------------------------

def _leaf(params: Params, device, enc_kind: str = "cp") -> torch.Tensor:
  return pack_weights(params, device, enc_kind).detach().clone(
  ).requires_grad_(True)


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


def plain_hash_render_grad_reference(params: Params, rays: torch.Tensor,
                                     feats: torch.Tensor, g: torch.Tensor,
                                     **kw) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
  """Plain K2 in hash mode: (d(Σ g·out)/d(packed weights), d/d feats
  [N·T, 16]) by autograd through `plain_hash_render_reference`."""
  ws = _leaf(params, rays.device, "hash")
  fl = feats.detach().clone().requires_grad_(True)
  with torch.enable_grad():
    out = plain_hash_render_reference(ws, rays, fl, **kw)
    dws, dfeat = torch.autograd.grad(out, (ws, fl), g)
  return dws, dfeat


def plain_hash_train_step_reference(params: Params, rays: torch.Tensor,
                                    feats: torch.Tensor,
                                    target: torch.Tensor, **kw
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
  """Plain K3 in hash mode: (loss, d loss/d(packed weights), d loss/d
  feats) for loss = mean((out_rgb − target)²)."""
  ws = _leaf(params, rays.device, "hash")
  fl = feats.detach().clone().requires_grad_(True)
  with torch.enable_grad():
    out = plain_hash_render_reference(ws, rays, fl, **kw)
    loss = torch.mean((out[:, :3] - target) ** 2)
    dws, dfeat = torch.autograd.grad(loss, (ws, fl))
  return loss.detach(), dws, dfeat


@functools.lru_cache(maxsize=None)
def _load_bwd_library() -> ctypes.CDLL:
  """Build (at first use) and bind csrc/render_bwd.cu."""
  from . import build
  lib = build.load("render_bwd")
  lib.render_bwd_launch.argtypes = (
      [ctypes.c_void_p] * 11
      + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
  lib.render_bwd_launch.restype = ctypes.c_int
  for fn in ("render_bwd_weight_count", "render_bwd_stash_floats_per_tile"):
    getattr(lib, fn).argtypes = [ctypes.c_int]
    getattr(lib, fn).restype = ctypes.c_longlong
  lib.render_bwd_max_steps.argtypes = []
  lib.render_bwd_max_steps.restype = ctypes.c_int
  lib.render_bwd_error_string.argtypes = [ctypes.c_int]
  lib.render_bwd_error_string.restype = ctypes.c_char_p
  for enc, kind in enumerate(ENC_KINDS):
    if (lib.render_bwd_weight_count(enc) != LAYOUTS[kind].weight_count
        or lib.render_bwd_max_steps() != BWD_MAX_STEPS):
      raise RuntimeError(
          f"render_bwd.cu packs {lib.render_bwd_weight_count(enc)} {kind} "
          f"weights and takes {lib.render_bwd_max_steps()} steps, the "
          f"wrapper {LAYOUTS[kind].weight_count} and {BWD_MAX_STEPS}")
  return lib


_TRANSPOSE_INDEX: Dict[Tuple[torch.device, str], torch.Tensor] = {}


def _transposed(ws: torch.Tensor) -> torch.Tensor:
  """The packed vector with every Dense W [in, out] stored as [out, in]
  at the same offset (render_bwd.cu reads W row by output unit for the
  input-gradient products)."""
  layout = _layout_of(ws)
  index = _TRANSPOSE_INDEX.get((ws.device, layout.enc_kind))
  if index is None:
    index = torch.arange(layout.weight_count)
    pos = layout.line_count
    for _, i, o in layout.density_layers + layout.refl_layers:
      index[pos:pos + i * o] = pos + torch.arange(i * o).view(i, o).t(
      ).reshape(-1)
      pos += i * o + o
    index = _TRANSPOSE_INDEX.setdefault((ws.device, layout.enc_kind),
                                        index.to(ws.device))
  return ws[index]


def _backward_launch(ws: torch.Tensor, rays: torch.Tensor,
                     gin: torch.Tensor, ts: Optional[torch.Tensor],
                     feats: Optional[torch.Tensor] = None, *,
                     steps: int, t_near: float, t_far: float,
                     sigmoid_kind: str, sky_kind: str, loss_mode: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """One render_bwd launch (+ its partial reduction); returns ([weight
  count + 1] = gradient ‖ loss, dfeat [N·T, 16] in hash mode else None)."""
  _check_cuda(rays, "render_bwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, BWD_MAX_STEPS, feats)
  layout = _layout_of(ws)
  width = 3 if loss_mode else 4
  if (gin.dtype != torch.float32 or tuple(gin.shape) != (rays.shape[0], width)
      or gin.device != rays.device or not gin.is_contiguous()):
    raise ValueError(f"{'target' if loss_mode else 'g'} must be contiguous "
                     f"float32 [{rays.shape[0]}, {width}] on {rays.device}, "
                     f"got {gin.dtype} {tuple(gin.shape)} on {gin.device}")
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  n, count = rays.shape[0], layout.weight_count
  out = torch.zeros(count + 1, dtype=torch.float32, device=rays.device)
  dfeat = (None if feats is None else
           torch.empty_like(feats))
  if n == 0:
    return out, dfeat
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts)
  lib = _load_bwd_library()
  enc = ENC_KINDS.index(layout.enc_kind)
  rays_per_block = 1 if steps >= 64 else 64 // steps
  ray_blocks = -(-n // rays_per_block)
  tiles = -(-(rays_per_block * steps) // 64)
  blocks = min(ray_blocks, torch.cuda.get_device_properties(
      rays.device).multi_processor_count)
  partial = torch.empty(blocks * (count + 1), dtype=torch.float32,
                        device=rays.device)
  stash = torch.empty(
      blocks * tiles * lib.render_bwd_stash_floats_per_tile(enc),
      dtype=torch.float32, device=rays.device)
  wt = _transposed(ws)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_bwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
      wt.data_ptr(), gin.data_ptr(), _ptr(feats), _ptr(dfeat),
      out.data_ptr(), partial.data_ptr(), stash.data_ptr(), n, steps, blocks,
      FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      int(loss_mode), 1.0 / (3 * n) if loss_mode else 0.0, enc, stream)
  _raise_on(err, lib, "render_bwd", "render_bwd")
  return out, dfeat


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
  out, _ = _backward_launch(pack_weights(params, rays.device), rays, g,
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
  out, _ = _backward_launch(pack_weights(params, rays.device), rays, target,
                            loss_mode=True, **kw)
  plain_cp_train_step.launches += 1
  return out[WEIGHT_COUNT], out[:WEIGHT_COUNT]


plain_cp_train_step.launches = 0


def plain_hash_render_grad(params: Params, rays: torch.Tensor,
                           feats: torch.Tensor, g: torch.Tensor, *,
                           steps: int = 64, t_near: float = 2.0,
                           t_far: float = 6.0, sigmoid_kind: str = "thin",
                           sky_kind: str = "black",
                           ts: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K2 in hash mode: (d(Σ g·out)/d(packed weights) [HASH_WEIGHT_COUNT],
  the feature cotangent dfeat [N·T, 16]) for rays [N, 6], feats [N·T, 16]
  and g [N, 4]. CUDA rays launch render_bwd.cu in mode G (each launch
  adds one to `plain_hash_render_grad.launches`); CPU rays take
  `plain_hash_render_grad_reference`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_hash_render_grad_reference(params, rays, feats, g, **kw)
  out, dfeat = _backward_launch(pack_weights(params, rays.device, "hash"),
                                rays, g, feats=feats.detach(),
                                loss_mode=False, **kw)
  plain_hash_render_grad.launches += 1
  return out[:HASH_WEIGHT_COUNT], dfeat


plain_hash_render_grad.launches = 0


def plain_hash_train_step(params: Params, rays: torch.Tensor,
                          feats: torch.Tensor, target: torch.Tensor, *,
                          steps: int = 64, t_near: float = 2.0,
                          t_far: float = 6.0, sigmoid_kind: str = "thin",
                          sky_kind: str = "black",
                          ts: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
  """K3 in hash mode: (loss, d loss/d(packed weights), dfeat [N·T, 16])
  for loss = mean((render_rgb − target)²). CUDA rays launch render_bwd.cu
  in mode L (each launch adds one to `plain_hash_train_step.launches`);
  CPU rays take `plain_hash_train_step_reference`."""
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_hash_train_step_reference(params, rays, feats, target, **kw)
  out, dfeat = _backward_launch(pack_weights(params, rays.device, "hash"),
                                rays, target, feats=feats.detach(),
                                loss_mode=True, **kw)
  plain_hash_train_step.launches += 1
  return out[HASH_WEIGHT_COUNT], out[:HASH_WEIGHT_COUNT], dfeat


plain_hash_train_step.launches = 0


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


class PlainHashRender(torch.autograd.Function):
  """K1 forward, K2 backward in hash mode (render.py
  `_make_diff_render_hash`): packed weights [HASH_WEIGHT_COUNT], feats
  [N·T, 16], rays [N, 6], ts [T] or None -> [N, 4]. The gradient goes to
  the packed weights and to the feature stream; rays and ts get none."""

  @staticmethod
  def forward(ctx, ws, feats, rays, ts, steps, t_near, t_far, sigmoid_kind,
              sky_kind):
    ctx.save_for_backward(ws, feats, rays, ts)
    ctx.kw = dict(steps=steps, t_near=t_near, t_far=t_far,
                  sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
    return plain_hash_render(ws.detach(), rays, feats.detach(), ts=ts,
                             **ctx.kw)

  @staticmethod
  def backward(ctx, g):
    ws, feats, rays, ts = ctx.saved_tensors
    dws, dfeat = plain_hash_render_grad(ws.detach(), rays, feats,
                                        g.contiguous(), ts=ts, **ctx.kw)
    return dws, dfeat, None, None, None, None, None, None, None


def fused_plain_hash_render(ws: Params, table: torch.Tensor,
                            rays: torch.Tensor, *, steps: int = 64,
                            t_near: float = 2.0, t_far: float = 6.0,
                            sigmoid_kind: str = "thin",
                            sky_kind: str = "black") -> torch.Tensor:
  """Eval render of PlainNeRF-hash on the uniform grid: K5f on the sample
  points, then K1 in hash mode -> [N, 4]. The feature stream is N·T·16
  floats (268 MB for 65536 rays × 64 steps)."""
  ts, _ = sample_grid(steps, t_near, t_far, rays.device)
  feats = hk.hash_encode(table, hash_pts(rays, ts))
  return plain_hash_render(ws, rays, feats, steps=steps, t_near=t_near,
                           t_far=t_far, sigmoid_kind=sigmoid_kind,
                           sky_kind=sky_kind, ts=ts)


def fused_plain_hash_render_train(ws: torch.Tensor, table: torch.Tensor,
                                  rays: torch.Tensor,
                                  ts: Optional[torch.Tensor] = None, *,
                                  steps: int = 64, t_near: float = 2.0,
                                  t_far: float = 6.0,
                                  sigmoid_kind: str = "thin",
                                  sky_kind: str = "black") -> torch.Tensor:
  """Differentiable render of PlainNeRF-hash (the two-kernel train path):
  `HashEncode` (K5f / K5b) into `PlainHashRender` (K1 / K2). Gradients
  reach the packed weights and the table."""
  grid, _ = sample_grid(steps, t_near, t_far, rays.device, ts)
  feats = hk.HashEncode.apply(table, hash_pts(rays, grid))
  return PlainHashRender.apply(ws, feats, rays, ts, steps, t_near, t_far,
                               sigmoid_kind, sky_kind)


def fused_plain_hash_train_step(ws: Params, table: torch.Tensor,
                                rays: torch.Tensor, target: torch.Tensor,
                                ts: Optional[torch.Tensor] = None, *,
                                steps: int = 64, t_near: float = 2.0,
                                t_far: float = 6.0,
                                sigmoid_kind: str = "thin",
                                sky_kind: str = "black"
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
  """The one-kernel L2 train step of PlainNeRF-hash: K5f, K3 in hash mode
  (loss, packed weight gradient, dfeat), K5b (the table gradient).
  Returns (loss, packed gradient, table gradient)."""
  grid, _ = sample_grid(steps, t_near, t_far, rays.device, ts)
  pts = hash_pts(rays, grid)
  feats = hk.hash_encode(table.detach(), pts)
  loss, dws, dfeat = plain_hash_train_step(
      ws, rays, feats, target, steps=steps, t_near=t_near, t_far=t_far,
      sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  return loss, dws, hk.hash_encode_table_grad(pts, dfeat,
                                              hk._table_size(table))
