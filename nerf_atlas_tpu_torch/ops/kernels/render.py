"""K1 and K2/K3: the fused forward render of PlainNeRF and TinyNeRF and
its backward, for the CP encoder, the hash-grid feature stream, the
positional encoding (posenc), TinyNeRF's one MLP (tiny) and MipNeRF's
integrated positional encoding (cone, cylinder).

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
- The parameter-free modes (ROADMAP's K4) take the `plain_cp_*`
  functions and `PlainCPRender` with `enc_kind` "posenc" (PlainNeRF's
  10 frequency bands), "tiny" (TinyNeRF: 8 bands into one 128×6 MLP to
  sigma ‖ rgb, no View) or "cone" / "cylinder" (PlainNeRF(mip=...): the
  density MLP reads the 96 IPE features of each sample's segment), as
  the JAX functions take `enc_kind`; `fused_plain_mip_render`,
  `fused_plain_mip_render_train` and `fused_plain_mip_train_step` are
  the JAX functions of those names, with `mip_kind`.
Each wrapper launches its kernel for rays on the GPU (and raises if it
cannot) and takes its plain version for rays on the CPU. See the kernel
sources for their design.

Weights travel as one packed float32 vector (`pack_weights`): for cp the
four CP line tables [3, R, 8], then every Dense layer of the density MLP
(tiny: of its one MLP) and of the View MLP (not tiny) as W [in, out]
row-major followed by its bias; gradients come back in the same layout
(`unpack_grads` maps them onto state_dict keys). The hash table is not
packed: it travels as its own tensor.

Sample positions ts are [T], shared by every ray, or [N, T], each ray's
own (render.py's [1, T] / [B, T] `ts_ref`); K1 and K2/K3 take either, by
a row stride of 0 or T. `plain_cp_render(..., want_weights=True)` also
returns K1's compositing weights [N, T]. CoarseFineNeRF's hierarchical
render (`fused_coarse_fine_render`, `fused_coarse_fine_train`, render.py
`_coarse_fine`) runs K1 with weights on the coarse ts, inverts their CDF
(`ops/sampling.py`) and runs K1 again (K2 in training) on the merged
per-ray ts.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .. import integrate, mip, sampling
from ..math import dir_to_elev_azim, load_sigmoid
from ...nn.encoders import PositionalEncoder, cp_encode
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
# the parameter-free encoders (models.PlainNeRF(enc_kind="posenc"),
# models.TinyNeRF): their bands go to the kernels as float32 inputs
POSENCS = {"posenc": PositionalEncoder(3, max_freq_log2=6, num_freqs=10),
           "tiny": PositionalEncoder(3, max_freq_log2=6, num_freqs=8)}
TINY_HIDDEN = 128
TINY_LAYERS = 6
MIP_KINDS = ("cone", "cylinder")
MIP_DIM = 2 * 3 * 16                             # IPE at 2^0..2^15: 96

# rgb activations the kernel implements, in the kernel's index order
FUSED_SIGMOID_KINDS = ("thin", "fat", "normal", "upshifted", "tanh",
                       "relu", "upshifted_relu", "leaky_relu")
# the kernels' `enc` index (csrc/render_fwd.cu, render_bwd.cu `Enc`)
ENC_KINDS = ("cp", "hash", "posenc", "tiny") + MIP_KINDS
MAX_STEPS = 2048                                 # csrc/render_fwd.cu
# csrc/render_bwd.cu: shared memory holds 8 floats per point of a ray
BWD_MAX_STEPS = {"cp": 1024, "hash": 1024, "posenc": 1024, "tiny": 1024,
                 "cone": 460, "cylinder": 460}

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
  (cp only), then the density MLP's (tiny: the one MLP's) and the View
  MLP's (none for tiny) Dense layers."""
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

  @property
  def n_layers(self) -> int:
    """Hidden layers of the density (tiny: the one) MLP."""
    return len(self.density_layers) - 2


def _make_layout(enc_kind: str, feat_in: int, lines=()) -> Layout:
  if enc_kind == "tiny":
    return Layout(enc_kind, feat_in, (), tuple(_mlp_layout(
        "mlp", feat_in, TINY_HIDDEN, TINY_LAYERS, 4)), ())
  return Layout(enc_kind, feat_in, tuple(lines),
                tuple(_mlp_layout("density_mlp", feat_in, HIDDEN, N_LAYERS,
                                  1 + INTERMEDIATE)),
                tuple(_mlp_layout("refl.mlp", R_IN, R_HIDDEN, R_LAYERS, 3)))


LAYOUTS = {
    "cp": _make_layout("cp", FEAT_IN,
                       [(f"density_mlp.enc.lines_{li}", (3, r, CP_RANK))
                        for li, r in enumerate(CP_RESOLUTIONS)]),
    "hash": _make_layout("hash", HASH_FEAT_IN),
    "posenc": _make_layout("posenc", 3 + POSENCS["posenc"].size()),
    "tiny": _make_layout("tiny", 3 + POSENCS["tiny"].size()),
    **{kind: _make_layout(kind, MIP_DIM) for kind in MIP_KINDS},
}
WEIGHT_COUNT = LAYOUTS["cp"].weight_count                 # 467,620
HASH_WEIGHT_COUNT = LAYOUTS["hash"].weight_count          # 449,572


def _layout_of(ws: torch.Tensor) -> Layout:
  """The layout of a packed vector, by its length: each kind's differs,
  but for cone and cylinder, whose layouts are the same (this returns
  cone's)."""
  for layout in LAYOUTS.values():
    if ws.ndim == 1 and ws.shape[0] == layout.weight_count:
      return layout
  raise ValueError(f"not a packed weight vector: shape {tuple(ws.shape)}")


def freqs(enc_kind: str, device=None) -> Optional[torch.Tensor]:
  """The posenc bands of `enc_kind` (float32 2^linspace, as the module's
  PositionalEncoder computes them on `device`; the kernels take them as
  an input so that kernel and plain version multiply by the same bits),
  or None for a kind without."""
  enc = POSENCS.get(enc_kind)
  return None if enc is None else enc.freqs(device)


def _expected_shapes(layout: Layout):
  shapes = dict(layout.line_shapes)
  for name, i, o in layout.density_layers + layout.refl_layers:
    shapes[f"{name}.weight"] = (o, i)
    shapes[f"{name}.bias"] = (o,)
  return shapes


def flatten_params(state_dict: Mapping[str, torch.Tensor],
                   enc_kind: str = "cp") -> List[torch.Tensor]:
  """PlainNeRF (TinyNeRF for "tiny") state_dict -> the kernel's tensors in
  packed order (Dense weights transposed to [in, out]). For hash the
  state_dict also holds the table, which is checked (`hash_table`) and
  not packed. Raises on a divergent tree."""
  layout = LAYOUTS[enc_kind]
  shapes = _expected_shapes(layout)
  known = set(shapes) | ({HASH_TABLE_KEY} if enc_kind == "hash" else set())
  missing = sorted(known - set(state_dict))
  extra = sorted(set(state_dict) - known)
  if missing or extra:
    raise KeyError(f"not the default {enc_kind} model's parameters: "
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
                ts: Optional[torch.Tensor] = None,
                n_rays: Optional[int] = None):
  """The sample positions ts and their segment lengths dists (the same
  shape) with the 1e10 tail and 1e-5 clamp, unscaled by ||r_d||
  (render.py `_linspace_ts` / `_dists_base`): the uniform grid [T], the
  given shared ts [T] (e.g. a stratified-jittered draw) or, where
  `n_rays` is given, also each ray's own ts [n_rays, T]."""
  shapes = [(steps,)] + ([(n_rays, steps)] if n_rays is not None else [])
  if ts is None:
    ts = torch.linspace(t_near, t_far, steps, device=device)
  elif (ts.dtype != torch.float32 or tuple(ts.shape) not in shapes
        or ts.device != torch.device(device) or not ts.is_contiguous()):
    raise ValueError(f"ts must be contiguous float32 "
                     f"{' or '.join(str(list(x)) for x in shapes)} on "
                     f"{device}, got {ts.dtype} {tuple(ts.shape)} on "
                     f"{ts.device}")
  return ts, integrate.dists_from_ts(ts)


def hash_pts(rays: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
  """Sample points [N·T, 3], r_o + t·r_d rounded after the product and
  after the sum (render.py `_hash_pts`), for ts [T] or [N, T]: the points
  K5f encodes are the points K1/K2/K3 feed the MLP."""
  return (rays[:, None, :3] + ts[..., None] * rays[:, None, 3:6]
          ).reshape(-1, 3)


def _check_call(ws: torch.Tensor, rays: torch.Tensor, steps: int,
                sigmoid_kind: str, sky_kind: str, enc_kind: str,
                max_steps: int = MAX_STEPS,
                feats: Optional[torch.Tensor] = None):
  check_rays(ws, rays, steps, sigmoid_kind, sky_kind, max_steps)
  if ws.ndim != 1 or ws.shape[0] != LAYOUTS[enc_kind].weight_count:
    raise ValueError(f"not a packed {enc_kind} weight vector: shape "
                     f"{tuple(ws.shape)}")
  if (feats is None) == (enc_kind == "hash"):
    raise ValueError("hash weights take feats, the other kinds none")
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


# the plain versions' dense product (tests/test_torch_tf32_split.py puts
# the split-TF32 emulation of K2/K3's tensor-core products in its place)
_matmul = torch.matmul


def _mlp(init_feat, layers, act, n_layers):
  """SkipConnMLP with split skip matmuls: layer i's weight splits into its
  hidden rows and init-feature rows, act(h)·W_h + act(f)·W_f."""
  f_act = act(init_feat)
  w, b = layers[0]
  h = _matmul(init_feat, w) + b
  for i in range(n_layers):
    w, b = layers[i + 1]
    if _skip_at(i, n_layers):
      hidden = w.shape[1]
      h = _matmul(act(h), w[:hidden]) + _matmul(f_act, w[hidden:]) + b
    else:
      h = _matmul(act(h), w) + b
  w, b = layers[-1]
  return _matmul(act(h), w) + b


def init_feature(enc_kind: str, lines, rays: torch.Tensor, ts: torch.Tensor,
                 feats: Optional[torch.Tensor] = None) -> torch.Tensor:
  """The density MLP's init feature [N·T, feat_in] at the sample points
  `hash_pts(rays, ts)` (ts [T] or [N, T]): [p ‖ CP encode] (cp, from the
  packed lines), [p ‖ feats] (hash, the given features [N·T, 16]),
  [p ‖ sin ‖ cos] (posenc, tiny) or the 96 IPE features of each sample's
  segment (cone, cylinder; `ops/mip.py`, the models' own)."""
  if enc_kind in MIP_KINDS:
    return mip.encode(enc_kind, rays[:, :3], rays[:, 3:6], ts).reshape(
        -1, MIP_DIM)
  pts = hash_pts(rays, ts)
  if enc_kind == "cp":
    xn = torch.clamp((pts + 1.0) * 0.5, 0.0, 1.0)   # the [-1, 1] CP bbox
    feats = cp_encode(xn, lines)
  elif enc_kind != "hash":
    feats = POSENCS[enc_kind](pts)
  return torch.cat([pts, feats], dim=-1)


def _plain_render(ws: torch.Tensor, rays: torch.Tensor,
                  feats: Optional[torch.Tensor], enc_kind: str, *,
                  steps: int, t_near: float, t_far: float, sigmoid_kind: str,
                  sky_kind: str, ts: Optional[torch.Tensor],
                  want_weights: bool = False):
  """The plain K1 of any kind (hash with the given features [N·T, 16]),
  with ts [T] or [N, T]; with `want_weights`, (out, weights [N, T])."""
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, enc_kind, feats=feats)
  lines, dense_layers, refl_layers = _unpack(ws)
  n = rays.shape[0]
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts, n)
  r_d = rays[:, 3:6]
  init_feat = init_feature(enc_kind, lines, rays, ts, feats)
  out = _mlp(init_feat, dense_layers, lambda v: F.leaky_relu(v, 0.01),
             LAYOUTS[enc_kind].n_layers)
  act = load_sigmoid(sigmoid_kind)
  if not refl_layers:                                # tiny: sigma ‖ rgb
    return composite(out[:, 0], act(out[:, 1:4]), r_d, dists, sky_kind,
                     want_weights=want_weights)
  density, latent = out[:, 0], out[:, 1:]
  elaz = dir_to_elev_azim(r_d)[:, None, :].expand(n, steps, 2).reshape(-1, 2)
  r_in = torch.cat([hash_pts(rays, ts), elaz, latent], dim=-1)
  rgb = act(_mlp(r_in, refl_layers, siren_act, R_LAYERS))
  return composite(density, rgb, r_d, dists, sky_kind,
                   want_weights=want_weights)


def siren_act(v):
  return torch.sin(SIREN_W0 * v)


def composite(density: torch.Tensor, rgb: torch.Tensor, r_d: torch.Tensor,
              dists: torch.Tensor, sky_kind: str, relu: bool = False,
              want_weights: bool = False):
  """The kernels' compositing in plain torch: raw density [N·T] and rgb
  [N·T, 3] of N rays with segment lengths dists [T] or [N, T] -> [N, 4]
  (rgb ‖ acc); sigma = softplus(density − 1) (relu(density) with `relu`,
  VolSDF's), the exclusive transmittance of max(1 − alpha, 1e-10), a
  white sky over the leftover transmittance without the 1e10 tail. With
  `want_weights`, (out, the weights [N, T])."""
  n, steps = r_d.shape[0], dists.shape[-1]
  sigma = (F.relu(density) if relu
           else F.softplus(density - 1.0)).reshape(n, steps)
  seg = dists * torch.linalg.vector_norm(r_d, dim=-1, keepdim=True)
  alpha = 1.0 - torch.exp(-sigma * seg)
  trans = integrate.exclusive_cumprod(torch.clamp(1.0 - alpha, min=1e-10))
  weights = alpha * trans
  acc = weights.sum(-1, keepdim=True)
  img = (weights[..., None] * rgb.reshape(n, steps, 3)).sum(1)
  if sky_kind == "white":
    img = img + (1.0 - (acc - weights[:, -1:]))
  out = torch.cat([img, acc], dim=-1)
  return (out, weights) if want_weights else out


def plain_cp_render_reference(params: Params, rays: torch.Tensor, *,
                              steps: int = 64, t_near: float = 2.0,
                              t_far: float = 6.0,
                              sigmoid_kind: str = "thin",
                              sky_kind: str = "black",
                              ts: Optional[torch.Tensor] = None,
                              enc_kind: str = "cp",
                              want_weights: bool = False):
  """Plain-torch K1: rays [N, 6] -> [N, 4] (rgb ‖ acc), on any device,
  differentiable in a packed weight vector. ts: shared sample positions
  [T] (default the uniform grid) or each ray's own [N, T]. The "random"
  sky is black, as the kernels render it. enc_kind: any of ENC_KINDS but
  hash. With `want_weights`, (out, the compositing weights [N, T])."""
  return _plain_render(pack_weights(params, rays.device, enc_kind), rays,
                       None, enc_kind, steps=steps, t_near=t_near,
                       t_far=t_far, sigmoid_kind=sigmoid_kind,
                       sky_kind=sky_kind, ts=ts, want_weights=want_weights)


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
                       feats, "hash", steps=steps, t_near=t_near,
                       t_far=t_far, sigmoid_kind=sigmoid_kind,
                       sky_kind=sky_kind, ts=ts)


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
  lib.render_fwd_launch.argtypes = (
      [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
  lib.render_fwd_launch.restype = ctypes.c_int
  for fn in (lib.render_fwd_weight_count, lib.render_fwd_pack_floats):
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
  lib.render_fwd_freq_count.argtypes = [ctypes.c_int]
  lib.render_fwd_freq_count.restype = ctypes.c_int
  lib.render_fwd_error_string.argtypes = [ctypes.c_int]
  lib.render_fwd_error_string.restype = ctypes.c_char_p
  for enc, kind in enumerate(ENC_KINDS):
    bands = freqs(kind)
    pack = wgmma_layout_index(tc_mlps(kind),
                              LAYOUTS[kind].weight_count)[0].numel()
    if (lib.render_fwd_weight_count(enc) != LAYOUTS[kind].weight_count
        or lib.render_fwd_pack_floats(enc) != pack
        or lib.render_fwd_freq_count(enc) != (0 if bands is None
                                              else bands.shape[0])):
      raise RuntimeError(
          f"render_fwd.cu packs {lib.render_fwd_weight_count(enc)} {kind} "
          f"weights in a wgmma pack of {lib.render_fwd_pack_floats(enc)} "
          f"floats and takes {lib.render_fwd_freq_count(enc)} bands, the "
          f"wrapper {LAYOUTS[kind].weight_count}, {pack} and {bands}")
  return lib


def _forward_launch(ws: torch.Tensor, rays: torch.Tensor,
                    feats: Optional[torch.Tensor], enc_kind: str, *,
                    steps: int, t_near: float, t_far: float,
                    sigmoid_kind: str, sky_kind: str,
                    ts: Optional[torch.Tensor], want_weights: bool = False):
  """One render_fwd launch in mode `enc_kind` (hash with feats), with ts
  [T] or [N, T]; with `want_weights`, (out, weights [N, T])."""
  _check_cuda(rays, "render_fwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, enc_kind, feats=feats)
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  n = rays.shape[0]
  out = torch.empty((n, 4), dtype=torch.float32, device=rays.device)
  wout = (torch.empty((n, steps), dtype=torch.float32, device=rays.device)
          if want_weights else None)
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts, n)
  if n > 0:
    fq = freqs(enc_kind, rays.device)
    lib = _load_library()
    wp = wgmma_pack(ws, enc_kind)
    stream = torch.cuda.current_stream(rays.device).cuda_stream
    err = lib.render_fwd_launch(
        rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
        wp.data_ptr(), _ptr(feats), _ptr(fq), out.data_ptr(), _ptr(wout),
        n, steps,
        steps if ts.ndim == 2 else 0, FUSED_SIGMOID_KINDS.index(sigmoid_kind),
        int(sky_kind == "white"), ENC_KINDS.index(enc_kind), stream)
    _raise_on(err, lib, "render_fwd", "render_fwd")
  return (out, wout) if want_weights else out


def _not_hash(enc_kind: str):
  if enc_kind not in ENC_KINDS or enc_kind == "hash":
    raise ValueError(f"enc_kind {enc_kind!r}: one of {ENC_KINDS} but hash "
                     "(hash takes the plain_hash_* functions)")


def plain_cp_render(params: Params, rays: torch.Tensor, *, steps: int = 64,
                    t_near: float = 2.0, t_far: float = 6.0,
                    sigmoid_kind: str = "thin",
                    sky_kind: str = "black",
                    ts: Optional[torch.Tensor] = None,
                    enc_kind: str = "cp", want_weights: bool = False):
  """Render rays [N, 6] -> [N, 4] (rgb ‖ acc) through K1; with
  `want_weights`, (out, the compositing weights [N, T]).

  params: a PlainNeRF-CP state_dict or its `pack_weights` vector (for
  enc_kind "posenc", "cone" or "cylinder" a PlainNeRF with that encoder,
  for "tiny" a TinyNeRF; a CoarseFineNeRF's tree is the PlainNeRF's of
  its encoder). ts: shared sample positions [T] (default the uniform
  grid) or each ray's own [N, T]. Rays on a CUDA device launch the
  kernel on the current stream (and raise if it cannot launch); rays on
  the CPU take `plain_cp_render_reference`. The "random" sky is black.
  Each launch adds one to `plain_cp_render.launches`."""
  _not_hash(enc_kind)
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts,
            want_weights=want_weights)
  if rays.device.type == "cpu":
    return plain_cp_render_reference(params, rays, enc_kind=enc_kind, **kw)
  out = _forward_launch(pack_weights(params, rays.device, enc_kind), rays,
                        None, enc_kind, **kw)
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
                        feats.detach(), "hash", **kw)
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
                                   ts: Optional[torch.Tensor] = None,
                                   enc_kind: str = "cp") -> torch.Tensor:
  """Plain K2: d(Σ g·out)/d(packed weights) for the cotangent g [N, 4],
  by autograd through `plain_cp_render_reference`."""
  ws = _leaf(params, rays.device, enc_kind)
  with torch.enable_grad():
    out = plain_cp_render_reference(
        ws, rays, steps=steps, t_near=t_near, t_far=t_far,
        sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts,
        enc_kind=enc_kind)
    (dws,) = torch.autograd.grad(out, ws, g)
  return dws


def plain_cp_train_step_reference(params: Params, rays: torch.Tensor,
                                  target: torch.Tensor, *, steps: int = 64,
                                  t_near: float = 2.0, t_far: float = 6.0,
                                  sigmoid_kind: str = "thin",
                                  sky_kind: str = "black",
                                  ts: Optional[torch.Tensor] = None,
                                  enc_kind: str = "cp"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain K3: (loss, d loss/d(packed weights)) for loss =
  mean((out_rgb − target)²), by autograd through the plain K1."""
  ws = _leaf(params, rays.device, enc_kind)
  with torch.enable_grad():
    out = plain_cp_render_reference(
        ws, rays, steps=steps, t_near=t_near, t_far=t_far,
        sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts,
        enc_kind=enc_kind)
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


def bwd_defines(enc_kind: str) -> Tuple[str, ...]:
  """The define that builds csrc/render_bwd.cu for one mode (its six
  instantiations then compile in parallel)."""
  return (f"RENDER_BWD_ENC={ENC_KINDS.index(enc_kind)}",)


@functools.lru_cache(maxsize=None)
def _load_bwd_library(enc_kind: str) -> ctypes.CDLL:
  """Build (at first use) and bind csrc/render_bwd.cu for `enc_kind`."""
  from . import build
  lib = build.load("render_bwd", bwd_defines(enc_kind))
  lib.render_bwd_launch.argtypes = (
      [ctypes.c_void_p] * 12
      + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
  lib.render_bwd_launch.restype = ctypes.c_int
  for fn in ("render_bwd_weight_count", "render_bwd_stash_floats_per_tile",
             "render_bwd_tc_floats"):
    getattr(lib, fn).argtypes = [ctypes.c_int]
    getattr(lib, fn).restype = ctypes.c_longlong
  for fn in ("render_bwd_max_steps", "render_bwd_freq_count"):
    getattr(lib, fn).argtypes = [ctypes.c_int]
    getattr(lib, fn).restype = ctypes.c_int
  lib.render_bwd_built_enc.argtypes = []
  lib.render_bwd_built_enc.restype = ctypes.c_int
  lib.render_bwd_error_string.argtypes = [ctypes.c_int]
  lib.render_bwd_error_string.restype = ctypes.c_char_p
  enc = ENC_KINDS.index(enc_kind)
  bands = freqs(enc_kind)
  tc = tc_layout_index(tc_mlps(enc_kind),
                       LAYOUTS[enc_kind].weight_count)[0].numel()
  if (lib.render_bwd_built_enc() != enc
      or lib.render_bwd_weight_count(enc) != LAYOUTS[enc_kind].weight_count
      or lib.render_bwd_max_steps(enc) != BWD_MAX_STEPS[enc_kind]
      or lib.render_bwd_tc_floats(enc) != tc
      or lib.render_bwd_freq_count(enc) != (0 if bands is None
                                            else bands.shape[0])):
    raise RuntimeError(
        f"render_bwd.cu built for mode {lib.render_bwd_built_enc()} packs "
        f"{lib.render_bwd_weight_count(enc)} {enc_kind} weights and takes "
        f"{lib.render_bwd_max_steps(enc)} steps and "
        f"{lib.render_bwd_freq_count(enc)} bands in a TC pack of "
        f"{lib.render_bwd_tc_floats(enc)} floats, the wrapper mode {enc}, "
        f"{LAYOUTS[enc_kind].weight_count}, {BWD_MAX_STEPS[enc_kind]}, "
        f"{bands} and {tc}")
  return lib


def tf32_round(x: torch.Tensor) -> torch.Tensor:
  """float32 x rounded to TF32 (10 stored mantissa bits), to nearest with
  ties away from zero, as `cvt.rna.tf32.f32` rounds and as
  csrc/mma_tf32.cuh `tf32_bits` computes it: the magnitude's bits plus
  half an ulp, the low 13 bits cleared."""
  bits = x.contiguous().view(torch.int32)
  return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """(hi, lo) = (tf32(x), tf32(x − hi)): x ≈ hi + lo to 2^-22·|x|."""
  hi = tf32_round(x)
  return hi, tf32_round(x - hi)


_TC_SLICE = 16                                   # csrc/mma_tf32.cuh SK


def _pad16(n: int) -> int:
  return -(-n // 16) * 16


# a TC pack entry's part of its float32 weight (`tc_layout_index`)
TC_HI, TC_LO, TC_RAW = 0, 1, 2


def _tc_block(a: torch.Tensor, pad: int, raw: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
  """A K-major index block a [k][m] (A[m][k] = a[k][m]) -> (its TC-pack
  order [Kp/16, parts, 2 (k-step), Mp/16 (m-tile), 32 (lane), 4], each
  entry's part): lane (g, t) of m-tile mt and k-step kk holds A[16mt +
  g][8kk + t], A[16mt + g + 8][8kk + t], A[16mt + g][8kk + t + 4], A[16mt
  + g + 8][8kk + t + 4] (mma.m16n8k8's A fragment), padded with `pad` (the
  index of a zero); each 16-deep slice holds its hi part, then its lo part
  (parts = 2), or with `raw` the float32 weights themselves (parts = 1),
  which the kernel splits in registers."""
  k, m = a.shape
  kp, mp = _pad16(k), _pad16(m)
  full = torch.full((kp, mp), pad, dtype=torch.long)
  full[:k, :m] = a
  s = torch.arange(kp // _TC_SLICE).view(-1, 1, 1, 1, 1)
  kk = torch.arange(2).view(1, -1, 1, 1, 1)
  mt = torch.arange(mp // 16).view(1, 1, -1, 1, 1)
  lane = torch.arange(32).view(1, 1, 1, -1, 1)
  j = torch.arange(4).view(1, 1, 1, 1, -1)
  rows = _TC_SLICE * s + 8 * kk + lane % 4 + 4 * (j // 2)
  cols = 16 * mt + lane // 4 + 8 * (j % 2)
  out = full[rows, cols].unsqueeze(1)
  if raw:
    return out, torch.full_like(out, TC_RAW)
  return (torch.cat([out, out], dim=1),
          torch.cat([torch.full_like(out, TC_HI), torch.full_like(out, TC_LO)],
                    dim=1))


# the MLPs of a TC pack: per MLP its offset in the packed vector, its Dense
# layers as `_mlp_layout` gives them, and whether its forward products run
# in three parts (their blocks then hold the raw weights)
TCMlps = Tuple[Tuple[int, Tuple[Tuple[str, int, int], ...], bool], ...]


def tc_mlps(enc_kind: str) -> TCMlps:
  """The MLPs of K2/K3's TC pack for `enc_kind`: the density MLP (tiny:
  the one MLP), then the View MLP, each in two parts."""
  layout = LAYOUTS[enc_kind]
  mlps = [(layout.line_count, layout.density_layers, False)]
  if layout.refl_layers:
    mlps.append((layout.line_count + sum(i * o + o for _, i, o in
                                         layout.density_layers),
                 layout.refl_layers, False))
  return tuple(mlps)


def tc_layout_index(mlps: TCMlps, weight_count: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(index, part) of csrc/mma_tf32.cuh's TC pack of the MLPs `mlps` of a
  packed weight vector of `weight_count` floats: each entry picks a float
  of the vector (`weight_count`: a zero pad) and which part of it it
  holds (TC_HI or TC_LO, its TF32 parts, or TC_RAW, the float itself).
  Per MLP, in order, and per Dense layer W [in, out] (in = kh hidden rows
  ‖ kf init rows): the forward product's block, W itself, K-major [in (kh
  rows padded to 16, then kf rows padded to 16)][out], raw in an MLP whose
  forward runs in three parts; the hidden rows' input-gradient block,
  W[:kh]ᵀ as [out][kh]; the init rows', W[kh:]ᵀ as [out][kf] (each present
  where kh, kf > 0); each block in 16-deep slices, in mma fragment order
  (`_tc_block`)."""
  pad = weight_count
  blocks = []
  for pos, layers, fwd3 in mlps:
    for j, (_, n_in, n_out) in enumerate(layers):
      kh = 0 if j == 0 else layers[0][2]
      w = pos + torch.arange(n_in * n_out).view(n_in, n_out)
      fwd = torch.full((_pad16(kh) + _pad16(n_in - kh), n_out), pad,
                       dtype=torch.long)
      fwd[:kh] = w[:kh]
      fwd[_pad16(kh):_pad16(kh) + n_in - kh] = w[kh:]
      blocks.append(_tc_block(fwd, pad, fwd3))
      for part in (w[:kh], w[kh:]):
        if part.shape[0]:
          blocks.append(_tc_block(part.t(), pad))
      pos += n_in * n_out + n_out
  return (torch.cat([b.reshape(-1) for b, _ in blocks]),
          torch.cat([p.reshape(-1) for _, p in blocks]))


_TC_INDEX: Dict[Tuple[torch.device, TCMlps, int],
                Tuple[torch.Tensor, torch.Tensor]] = {}


def tc_pack_mlps(ws: torch.Tensor, mlps: TCMlps) -> torch.Tensor:
  """The packed weights `ws` pre-split into csrc/mma_tf32.cuh's TC pack of
  the MLPs `mlps` (`tc_layout_index`): the tensor-core operands of a
  backward kernel's dense products, once per call."""
  key = (ws.device, mlps, ws.shape[0])
  if key not in _TC_INDEX:
    _TC_INDEX[key] = tuple(t.to(ws.device) for t in
                           tc_layout_index(mlps, ws.shape[0]))
  index, part = _TC_INDEX[key]
  raw = F.pad(ws, (0, 1))[index]
  hi, lo = tf32_split(raw)
  return torch.where(part == TC_HI, hi, torch.where(part == TC_LO, lo, raw))


def tc_pack(ws: torch.Tensor, enc_kind: str) -> torch.Tensor:
  """K2/K3's TC pack of `ws` for `enc_kind` (`tc_pack_mlps`)."""
  return tc_pack_mlps(ws, tc_mlps(enc_kind))


# ---- K1's wgmma pack (csrc/wgmma_tf32.cuh) ----

_WG_SLICE = 16                                   # csrc/wgmma_tf32.cuh SK
_WG_SUB = 64                                     # its NS_MAX


def _pad8(n: int) -> int:
  return -(-n // 8) * 8


def _wgmma_block(a: torch.Tensor, pad: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
  """An index block a [K][n_out] (K a multiple of 16; B[k][n] = a[k][n]) ->
  (its wgmma-pack order [sub, slice, part (hi, lo), k-chunk (4), n-group
  (NS/8), 8 (n), 4 (k)], each entry's part): per sub-product of NS
  outputs (64, or the width padded to 8 below that: csrc/wgmma_tf32.cuh
  `sub_n`) and 16-deep slice, a unit of hi then lo, each a
  grid of core matrices, row r and column c of core (kc, ng) holding
  B[16·slice + 4kc + c][NS·sub + 8ng + r]: Bᵀ K-major, wgmma's canonical
  layout without swizzle; columns past n_out hold `pad` (a zero)."""
  k, n = a.shape
  np_ = _pad8(n)
  ns = min(np_, _WG_SUB)
  full = torch.full((k, np_), pad, dtype=torch.long)
  full[:, :n] = a
  sub = torch.arange(np_ // ns).view(-1, 1, 1, 1, 1, 1)
  s = torch.arange(k // _WG_SLICE).view(1, -1, 1, 1, 1, 1)
  kc = torch.arange(4).view(1, 1, -1, 1, 1, 1)
  ng = torch.arange(ns // 8).view(1, 1, 1, -1, 1, 1)
  r = torch.arange(8).view(1, 1, 1, 1, -1, 1)
  c = torch.arange(4).view(1, 1, 1, 1, 1, -1)
  out = full[_WG_SLICE * s + 4 * kc + c, ns * sub + 8 * ng + r].unsqueeze(2)
  return (torch.cat([out, out], dim=2),
          torch.cat([torch.full_like(out, TC_HI), torch.full_like(out, TC_LO)],
                    dim=2))


def wgmma_layout_index(mlps: TCMlps, weight_count: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(index, part) of csrc/wgmma_tf32.cuh's wgmma pack of the MLPs `mlps`
  (K1's: `tc_mlps`, whose part flags it does not read: every product in
  two parts) of a packed weight vector of `weight_count` floats
  (`weight_count`: a zero pad; part TC_HI or TC_LO). Per MLP, in order,
  and per Dense layer
  W [in, out] (in = kh hidden rows ‖ kf init rows): B = W as [kh rows
  padded to 16, then kf rows padded to 16][out] in `_wgmma_block`'s
  order."""
  pad = weight_count
  blocks = []
  for pos, layers, _ in mlps:
    for j, (_, n_in, n_out) in enumerate(layers):
      kh = 0 if j == 0 else layers[0][2]
      w = pos + torch.arange(n_in * n_out).view(n_in, n_out)
      b = torch.full((_pad16(kh) + _pad16(n_in - kh), n_out), pad,
                     dtype=torch.long)
      b[:kh] = w[:kh]
      b[_pad16(kh):_pad16(kh) + n_in - kh] = w[kh:]
      blocks.append(_wgmma_block(b, pad))
      pos += n_in * n_out + n_out
  return (torch.cat([b.reshape(-1) for b, _ in blocks]),
          torch.cat([p.reshape(-1) for _, p in blocks]))


_WG_INDEX: Dict[Tuple[torch.device, str], Tuple[torch.Tensor,
                                                torch.Tensor]] = {}


def wgmma_pack(ws: torch.Tensor, enc_kind: str) -> torch.Tensor:
  """The packed weights `ws` of `enc_kind` pre-split into K1's wgmma pack
  (`wgmma_layout_index`), once per call."""
  key = (ws.device, enc_kind)
  if key not in _WG_INDEX:
    _WG_INDEX[key] = tuple(t.to(ws.device) for t in wgmma_layout_index(
        tc_mlps(enc_kind), ws.shape[0]))
  index, part = _WG_INDEX[key]
  hi, lo = tf32_split(F.pad(ws, (0, 1))[index])
  return torch.where(part == TC_HI, hi, lo)


def _backward_launch(ws: torch.Tensor, rays: torch.Tensor,
                     gin: torch.Tensor, ts: Optional[torch.Tensor],
                     feats: Optional[torch.Tensor] = None,
                     enc_kind: str = "cp", *, steps: int, t_near: float,
                     t_far: float, sigmoid_kind: str, sky_kind: str,
                     loss_mode: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """One render_bwd launch (+ its partial reduction) in mode `enc_kind`,
  with ts [T] or [N, T]; returns ([weight count + 1] = gradient ‖ loss,
  dfeat [N·T, 16] in hash mode else None)."""
  _check_cuda(rays, "render_bwd")
  ws = ws.detach()
  _check_call(ws, rays, steps, sigmoid_kind, sky_kind, enc_kind,
              BWD_MAX_STEPS[enc_kind], feats)
  width = 3 if loss_mode else 4
  if (gin.dtype != torch.float32 or tuple(gin.shape) != (rays.shape[0], width)
      or gin.device != rays.device or not gin.is_contiguous()):
    raise ValueError(f"{'target' if loss_mode else 'g'} must be contiguous "
                     f"float32 [{rays.shape[0]}, {width}] on {rays.device}, "
                     f"got {gin.dtype} {tuple(gin.shape)} on {gin.device}")
  if not ws.is_contiguous():
    raise ValueError("packed weights must be contiguous")
  n, count = rays.shape[0], ws.shape[0]
  out = torch.zeros(count + 1, dtype=torch.float32, device=rays.device)
  dfeat = (None if feats is None else
           torch.empty_like(feats))
  ts, dists = sample_grid(steps, t_near, t_far, rays.device, ts, n)
  if n == 0:
    return out, dfeat
  fq = freqs(enc_kind, rays.device)
  lib = _load_bwd_library(enc_kind)
  enc = ENC_KINDS.index(enc_kind)
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
  tcw = tc_pack(ws, enc_kind)
  stream = torch.cuda.current_stream(rays.device).cuda_stream
  err = lib.render_bwd_launch(
      rays.data_ptr(), ts.data_ptr(), dists.data_ptr(), ws.data_ptr(),
      tcw.data_ptr(), gin.data_ptr(), _ptr(feats), _ptr(fq), _ptr(dfeat),
      out.data_ptr(), partial.data_ptr(), stash.data_ptr(), n, steps,
      steps if ts.ndim == 2 else 0, blocks,
      FUSED_SIGMOID_KINDS.index(sigmoid_kind), int(sky_kind == "white"),
      int(loss_mode), 1.0 / (3 * n) if loss_mode else 0.0, enc, stream)
  _raise_on(err, lib, "render_bwd", "render_bwd")
  return out, dfeat


def plain_cp_render_grad(params: Params, rays: torch.Tensor, g: torch.Tensor,
                         *, steps: int = 64, t_near: float = 2.0,
                         t_far: float = 6.0, sigmoid_kind: str = "thin",
                         sky_kind: str = "black",
                         ts: Optional[torch.Tensor] = None,
                         enc_kind: str = "cp") -> torch.Tensor:
  """K2: d(Σ g·out)/d(packed weights) [weight count of enc_kind] for the
  render of rays [N, 6] (ts [T] or [N, T]) and the cotangent g [N, 4]
  (the weights output takes none). CUDA rays launch
  render_bwd.cu in mode G (each launch adds one to
  `plain_cp_render_grad.launches`); CPU rays take
  `plain_cp_render_grad_reference`."""
  _not_hash(enc_kind)
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_cp_render_grad_reference(params, rays, g, enc_kind=enc_kind,
                                          **kw)
  ws = pack_weights(params, rays.device, enc_kind)
  out, _ = _backward_launch(ws, rays, g, enc_kind=enc_kind, loss_mode=False,
                            **kw)
  plain_cp_render_grad.launches += 1
  return out[:ws.shape[0]]


plain_cp_render_grad.launches = 0


def plain_cp_train_step(params: Params, rays: torch.Tensor,
                        target: torch.Tensor, *, steps: int = 64,
                        t_near: float = 2.0, t_far: float = 6.0,
                        sigmoid_kind: str = "thin", sky_kind: str = "black",
                        ts: Optional[torch.Tensor] = None,
                        enc_kind: str = "cp"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K3, the one-kernel train step: (loss, d loss/d(packed weights)) for
  loss = mean((render(rays)_rgb − target)²), target [N, 3]. CUDA rays
  launch render_bwd.cu in mode L, which computes the loss and its
  cotangent from its own forward (each launch adds one to
  `plain_cp_train_step.launches`); CPU rays take
  `plain_cp_train_step_reference`. `unpack_grads` maps the gradient onto
  the state_dict keys."""
  _not_hash(enc_kind)
  kw = dict(steps=steps, t_near=t_near, t_far=t_far,
            sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  if rays.device.type == "cpu":
    return plain_cp_train_step_reference(params, rays, target,
                                         enc_kind=enc_kind, **kw)
  ws = pack_weights(params, rays.device, enc_kind)
  out, _ = _backward_launch(ws, rays, target, enc_kind=enc_kind,
                            loss_mode=True, **kw)
  plain_cp_train_step.launches += 1
  count = ws.shape[0]
  return out[count], out[:count]


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
                                enc_kind="hash", loss_mode=False, **kw)
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
                                enc_kind="hash", loss_mode=True, **kw)
  plain_hash_train_step.launches += 1
  return out[HASH_WEIGHT_COUNT], out[:HASH_WEIGHT_COUNT], dfeat


plain_hash_train_step.launches = 0


class PlainCPRender(torch.autograd.Function):
  """K1 forward, K2 backward (render.py `_make_diff_render`): packed
  weights of `enc_kind` (any kind but hash), rays [N, 6], ts [T], [N, T]
  or None -> [N, 4], or with `want_weights` ([N, 4], the compositing
  weights [N, T]). The gradient goes to the packed weights only; rays
  and ts get none, and the weights output is not differentiable (it
  drives the hierarchical sampling under stop-grad)."""

  @staticmethod
  def forward(ctx, ws, rays, ts, steps, t_near, t_far, sigmoid_kind,
              sky_kind, enc_kind="cp", want_weights=False):
    ctx.save_for_backward(ws, rays, ts)
    ctx.kw = dict(steps=steps, t_near=t_near, t_far=t_far,
                  sigmoid_kind=sigmoid_kind, sky_kind=sky_kind,
                  enc_kind=enc_kind)
    out = plain_cp_render(ws.detach(), rays, ts=ts,
                          want_weights=want_weights, **ctx.kw)
    if want_weights:
      ctx.mark_non_differentiable(out[1])
    return out

  @staticmethod
  def backward(ctx, g, *_):
    ws, rays, ts = ctx.saved_tensors
    dws = plain_cp_render_grad(ws.detach(), rays, g.contiguous(), ts=ts,
                               **ctx.kw)
    return dws, None, None, None, None, None, None, None, None, None


def plain_cp_render_train(ws: torch.Tensor, rays: torch.Tensor,
                          ts: Optional[torch.Tensor] = None, *,
                          steps: int = 64, t_near: float = 2.0,
                          t_far: float = 6.0, sigmoid_kind: str = "thin",
                          sky_kind: str = "black", enc_kind: str = "cp",
                          want_weights: bool = False):
  """Differentiable render (the two-kernel train path): packed weights
  (a leaf that requires grad) -> [N, 4] through `PlainCPRender` (with
  `want_weights`, also the non-differentiable weights [N, T])."""
  return PlainCPRender.apply(ws, rays, ts, steps, t_near, t_far,
                             sigmoid_kind, sky_kind, enc_kind, want_weights)


def _mip_kind(mip_kind: str) -> str:
  if mip_kind not in MIP_KINDS:
    raise NotImplementedError(f"fused kernel: mip kind {mip_kind}")
  return mip_kind


def fused_plain_mip_render(params: Params, rays: torch.Tensor, *,
                           mip_kind: str = "cone", **kw) -> torch.Tensor:
  """Render rays [N, 6] -> [N, 4] for PlainNeRF(mip=mip_kind): K1 with the
  IPE features of each sample's segment (`plain_cp_render`'s keywords)."""
  return plain_cp_render(params, rays, enc_kind=_mip_kind(mip_kind), **kw)


def fused_plain_mip_render_train(ws: torch.Tensor, rays: torch.Tensor,
                                 ts: Optional[torch.Tensor] = None, *,
                                 mip_kind: str = "cone",
                                 **kw) -> torch.Tensor:
  """Differentiable render of PlainNeRF(mip=mip_kind) (the two-kernel
  train path, K1 / K2 through `PlainCPRender`)."""
  return plain_cp_render_train(ws, rays, ts, enc_kind=_mip_kind(mip_kind),
                               **kw)


def fused_plain_mip_train_step(params: Params, rays: torch.Tensor,
                               target: torch.Tensor,
                               ts: Optional[torch.Tensor] = None, *,
                               mip_kind: str = "cone", **kw
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The one-kernel L2 train step of PlainNeRF(mip=mip_kind) (K3, see
  `plain_cp_train_step`): (loss, packed gradient)."""
  return plain_cp_train_step(params, rays, target, ts=ts,
                             enc_kind=_mip_kind(mip_kind), **kw)


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


# ---------------------------------------------------------------------------
# CoarseFineNeRF: the hierarchical render through K1 (and K2 in training)
# ---------------------------------------------------------------------------

COARSE_FINE_KINDS = ("cp", "posenc") + MIP_KINDS


def _coarse_fine(ws: Params, rays: torch.Tensor,
                 generator: Optional[torch.Generator],
                 ts: Optional[torch.Tensor], *, enc_kind: str, steps: int,
                 fine_steps: int, t_near: float, t_far: float,
                 sigmoid_kind: str, sky_kind: str, train: bool):
  """render.py `_coarse_fine`: K1 with the weights output on the coarse
  ts (shared [T], the uniform grid by default), the fine ts drawn by
  inverting the CDF of the stop-grad coarse weights (`generator`: a
  uniform u, else linspace), merged with the coarse ts into per-ray
  [N, steps + fine_steps], and K1 again on those. `train` renders both
  passes through `PlainCPRender` (K2 backward). Returns (fine [N, 4],
  coarse [N, 4])."""
  if enc_kind not in COARSE_FINE_KINDS:
    raise ValueError(f"coarse_fine kernels: enc_kind one of "
                     f"{COARSE_FINE_KINDS}, got {enc_kind!r}")
  ws = pack_weights(ws, rays.device, enc_kind)
  kw = dict(t_near=t_near, t_far=t_far, sigmoid_kind=sigmoid_kind,
            sky_kind=sky_kind, enc_kind=enc_kind)
  ts, _ = sample_grid(steps, t_near, t_far, rays.device, ts)

  def render(t, n_steps, want_weights):
    if train:
      return plain_cp_render_train(ws, rays, t, steps=n_steps,
                                   want_weights=want_weights, **kw)
    return plain_cp_render(ws, rays, steps=n_steps, ts=t,
                           want_weights=want_weights, **kw)

  out_c, w_c = render(ts, steps, True)
  ts_b = ts.expand(rays.shape[0], steps)
  fine = sampling.sample_pdf(ts_b, w_c.detach(), fine_steps,
                             generator=generator)
  all_ts = sampling.merge_ts(ts_b, fine).contiguous()
  return render(all_ts, steps + fine_steps, False), out_c


def fused_coarse_fine_render(params: Params, rays: torch.Tensor, *,
                             enc_kind: str = "cp", steps: int = 64,
                             fine_steps: int = 64, t_near: float = 2.0,
                             t_far: float = 6.0, sigmoid_kind: str = "thin",
                             sky_kind: str = "black") -> torch.Tensor:
  """Eval render of CoarseFineNeRF (enc_kind: cp, posenc or its mip kind):
  rays [N, 6] -> fine [N, 4], the deterministic CDF inversion (u =
  linspace). Two K1 launches: the coarse pass with weights, the fine pass
  on the merged per-ray ts."""
  out_f, _ = _coarse_fine(params, rays, None, None, enc_kind=enc_kind,
                          steps=steps, fine_steps=fine_steps, t_near=t_near,
                          t_far=t_far, sigmoid_kind=sigmoid_kind,
                          sky_kind=sky_kind, train=False)
  return out_f


def fused_coarse_fine_train(ws: torch.Tensor, rays: torch.Tensor,
                            ts: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None, *,
                            enc_kind: str = "cp", steps: int = 64,
                            fine_steps: int = 64, t_near: float = 2.0,
                            t_far: float = 6.0, sigmoid_kind: str = "thin",
                            sky_kind: str = "black"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Differentiable hierarchical render (the two-kernel path): packed
  weights ws (a leaf that requires grad), the step's shared coarse ts
  [T] and the generator of the fine u -> (fine [N, 4], coarse [N, 4]),
  each through `PlainCPRender` (K1 forward, K2 backward); the training
  loss supervises both."""
  return _coarse_fine(ws, rays, generator, ts, enc_kind=enc_kind,
                      steps=steps, fine_steps=fine_steps, t_near=t_near,
                      t_far=t_far, sigmoid_kind=sigmoid_kind,
                      sky_kind=sky_kind, train=True)
