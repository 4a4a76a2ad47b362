"""Train / eval driver: parameter init, the training loop with its kernel
gates, tiled view rendering, per-view PSNR.

Counterpart of `nerf_atlas_tpu/train/driver.py` (`TrainConfig`,
`_fused_common_ok`, `_fused_step_fn`, `_fused_train_fn`,
`make_train_step`, `train`, `init_model`, `_fused_render_fn`,
`render_view`, `test`, `train_progressive`, `render_over_time`), for
PlainNeRF (cp, hash, posenc, and mip cone or cylinder), TinyNeRF, NeRFAE,
CoarseFineNeRF, VolSDF (every SDF shape, --volsdf-alternate), the SDF
surface renderer and the dynamic models (DynamicNeRF: D-NeRF's Δx
warp and Spline-NeRF over any canonical but VolSDF, with an optional
per-time latent; DynamicNeRFAE; LongDynamicNeRF). The port's
modules own their parameters, so these functions take the model where the
JAX package takes (model, params), and a train step is a Python closure (no
jit). Unlike the JAX gates, a kernel gate never catches an exception: a
parameter tree that diverges from the kernel's, or a kernel that fails to
build or launch, raises.
"""
from __future__ import annotations

import math
import os
import struct
import time
import zlib
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data import sampler as sampler_lib
from ..models import (MODEL_KINDS, SDF, CoarseFineNeRF, DynamicNeRF,
                      NeRFAE, PlainNeRF, TinyNeRF, VolSDF, is_dynamic)
from ..ops import integrate, rays as rays_ops
from ..ops.kernels import render as k1
from ..ops.kernels import render_ae as k7
from ..ops.kernels import render_dyn as k9
from ..ops.kernels import render_volsdf as k8
from . import checkpoints, losses as losses_lib, optim as optim_lib
from . import regularizers

# which train path the most recent train() engaged: "fused-one-kernel"
# (K3 in the model's mode; for hash K5f + K3 + K5b; for NeRFAE K7b in
# loss mode; for VolSDF K8b in loss mode; for DynamicNeRF K9b in loss
# mode) | "fused" (K1 + K2 through PlainCPRender, PlainHashRender after
# HashEncode, K7f + K7b through AERender, K8f + K8b through VolSDFRender,
# K9f + K9b through DynRender, or for CoarseFineNeRF K1 + K2 twice, the
# coarse and the fine pass) | "oracle" (the module forward under
# autograd). Recorded into log.json by the runner.
LAST_TRAIN_PATH: Optional[str] = None

# the regularizers each model kind carries (the JAX package's
# REGULARIZERS and POINT_REGULARIZERS keys; "dynamic" is any dynamic
# model); every other active coefficient raises
MODEL_REGULARIZERS = {"ae": ("latent_l2",),
                      "volsdf": ("eikonal", "volsdf_scale", "surface_eikonal",
                                 "smooth_normals", "smooth_surface",
                                 "eikonal_random"),
                      "sdf": ("eikonal", "surface_eikonal", "smooth_normals",
                              "eikonal_random"),
                      "dynamic": ("delta_x", "offset", "rigidity_sparsity",
                                  "dyn_divergence", "ffjord_div",
                                  "spline_length", "spline_pt0")}
# the out-dict regularizers each kernel family takes (in the kernel, or,
# for NeRFAE's latent L2 and VolSDF's scale decay, beside it)
_KERNEL_REGULARIZERS = {"ae": ("latent_l2",),
                        "volsdf": ("eikonal", "volsdf_scale"),
                        "dynamic": ("delta_x",)}
# the in-kernel regularizer column (the 5th output) of each kernel family
_COLUMN_REGULARIZER = {"volsdf": "eikonal", "dynamic": "delta_x"}

@dataclass
class TrainConfig:
  """The JAX package's TrainConfig without `use_mesh` (the port trains on
  one device; the runner rejects a device mesh, ROADMAP Queue 1 #12). The
  port honours the fields up to `volsdf_alternate` below; `check_config`
  raises on the rest when they leave their defaults."""
  steps: int = 1000
  batch_size: int = 4096
  learning_rate: float = 5e-4
  opt_kind: str = "adam"
  loss_kinds: tuple = ("l2",)
  color_spaces: tuple = ("rgb",)
  tone_map: bool = False
  gamma_correct: bool = False
  reg_coeffs: Dict[str, float] = field(default_factory=dict)
  grad_clip: float = 0.0
  accum_steps: int = 1
  no_sched: bool = False
  sched_min: float = 5e-5
  seed: int = 0
  valid_freq: int = 500
  save_freq: int = 1000
  versioned_save: bool = False
  save_path: str = "outputs/model.ckpt"
  log_freq: int = 50
  duration_sec: float = 0.0
  pixel_jitter: float = 1.0
  train_only: Optional[Tuple[str, ...]] = None
  weight_decay: float = 0.0
  serial_idxs: bool = False
  end_bias: int = 0
  skip_loss: int = 0
  freeze_substr: Optional[str] = None
  style_weight: float = 0.0
  no_fused: bool = False
  smooth_eps: float = 1e-3
  smooth_eps_rng: bool = False
  smooth_ords: tuple = (2,)
  # --alt-train's cadence: step i's phase is (i // alt_train) % 2
  alt_train: int = 0
  volsdf_alternate: bool = False
  # not ported yet: (ROADMAP item) in the metadata
  model_parallel: int = field(default=1, metadata={"item": "Queue 1 #12"})
  train_camera: bool = field(default=False, metadata={"item": "Queue 1 #13"})
  profile_dir: Optional[str] = field(default=None,
                                     metadata={"item": "Queue 1 #13"})
  save_load_opt: bool = field(default=False, metadata={"item": "Queue 1 #13"})
  crop_size: int = field(default=0, metadata={"item": "Queue 1 #5"})
  style_img: Optional[str] = field(default=None,
                                   metadata={"item": "Queue 1 #5"})
  inc_fourier_freqs: bool = field(default=False,
                                  metadata={"item": "Queue 1 #13"})
  inc_fourier_rate: float = field(default=1.0005,
                                  metadata={"item": "Queue 1 #13"})
  omit_bg: bool = field(default=False, metadata={"item": "Queue 1 #13"})


def check_config(cfg: TrainConfig, model_kind: str = "plain"):
  """Raise NotImplementedError for a field the port does not carry yet
  set away from its default, and for an active regularizer that the
  model kind (a `models.MODEL_KINDS` key) does not carry."""
  default = TrainConfig()
  for f in fields(cfg):
    item = f.metadata.get("item")
    if item and getattr(cfg, f.name) != getattr(default, f.name):
      raise NotImplementedError(
          f"train config {f.name}={getattr(cfg, f.name)!r}: not ported yet "
          f"(ROADMAP {item})")
  carried = MODEL_REGULARIZERS.get(model_kind, ())
  active = sorted(k for k, v in (cfg.reg_coeffs or {}).items()
                  if v and k not in carried)
  if active:
    raise NotImplementedError(
        f"regularizers {active} for --model {model_kind}: arrive with their "
        "models (ROADMAP Queue 1 #10-#13)")


def model_kind(model) -> str:
  """The `models.MODEL_KINDS` key of a model ("dynamic" for a dynamic
  one)."""
  if is_dynamic(model):
    return "dynamic"
  return next(k for k, c in MODEL_KINDS.items() if isinstance(model, c))


def init_model(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
  """Draw every parameter from a CPU `torch.Generator` seeded with `seed`
  (the same weights on every device); returns the model."""
  model.reset_parameters(torch.Generator().manual_seed(seed))
  return model


def _fused_enc_kind(model) -> Optional[str]:
  """The kernels' mode for a model at the kernels' widths, with an rgb
  activation they implement and linear-in-t samples; None otherwise:
  - "tiny" for a TinyNeRF without mip (driver.py:198-206, :523-528,
    :1038-1048; the port builds TinyNeRF at the default arch only);
  - for a PlainNeRF with the View refl in identity space and
    intermediate_size 32: its `mip` ("cone" or "cylinder"), which
    overrides enc_kind as in JAX, else its enc_kind if "cp", "hash" or
    "posenc" (driver.py:230-295, :523-544, :1137-1183). The port's
    HashEncoder lets only `table_size` differ from the defaults, which is
    the JAX gate's rule (train/driver.py:254-261);
  - "ae" for a NeRFAE with the View refl, intermediate_size 32 and the
    latent normalized at `encoding_size` 32 (driver.py:332-336,
    :563-567, :1138-1151);
  - for a CoarseFineNeRF with the View refl and intermediate_size 32:
    its `mip`, else its enc_kind if "cp" or "posenc" (hash has no
    coarse_fine kernel path; driver.py:297-303, :1137-1152). The train
    gates also refuse timed data for it (`_data_ok`);
  - "volsdf" for a VolSDF with the MLP shape at its default widths (no
    sdf option but `sphere_init`), the View refl, `sdf_latent` 32, the
    softplus scale and no mip (driver.py:366-378, :587-597, :1104-1117).
    The port's VolSDF has no occlusion, integrator or light, so those
    rules cannot fail. The SDF surface renderer has no kernel.
  - "dyn-cp" / "dyn-posenc" for a DynamicNeRF over a plain canonical
    whose canonical_kwargs set nothing but enc_kind (cp or posenc),
    refl_kind (view), steps, t_near, t_far, sky_kind and sigmoid_kind,
    with the rigidity gate, no mip, no time latent, and spline_points at
    most k9.MAX_SPLINE, the kernels' packed width (driver.py:405-422,
    :617-629, :1064-1082; the JAX gates' spline_points rule cannot fail
    here: the port's DynamicNeRF refuses spline_points 1). The train
    gates also need the data's times (`_data_ok`). DynamicNeRFAE and
    LongDynamicNeRF have no kernel.
  Every gate refuses a model that reads a latent (latent_size != 0,
  driver.py:146, :1044-1148). The JAX gates also reject timed data for
  the static models: a static model on timed data trains as on static
  data (the JAX gates check the times only for their dynamic branch)."""
  if isinstance(model, SDF):
    return None
  if (model.sigmoid_kind not in k1.FUSED_SIGMOID_KINDS or model.lindisp
      or model.latent_size != 0):
    return None
  if is_dynamic(model):
    if not isinstance(model, DynamicNeRF):
      return None
    ck = model.canonical_kwargs
    return (f"dyn-{ck.get('enc_kind', 'cp')}"
            if (model.canonical_kind == "plain"
                and model.time_latent_size == 0
                and model.mip is None and model.with_rigidity
                and model.spline_points <= k9.MAX_SPLINE
                and ck.get("enc_kind", "cp") in k9.ENC_KINDS
                and ck.get("refl_kind", "view") == "view"
                and set(ck) <= _DYN_CANONICAL_KEYS) else None)
  if isinstance(model, VolSDF):
    return ("volsdf" if model.sdf_kind == "mlp" and model.refl_kind == "view"
            and model.scale_kind == "softplus" and model.sdf_latent == 32
            and model.mip is None
            and set(model.sdf_kwargs) <= {"sphere_init"} else None)
  if isinstance(model, TinyNeRF):
    return "tiny" if model.mip is None else None
  if model.refl_kind != "view" or model.intermediate_size != 32:
    return None
  if isinstance(model, NeRFAE):
    return ("ae" if model.mip is None and model.encoding_size == 32
            and model.normalize_latent else None)
  if isinstance(model, CoarseFineNeRF):
    return model.mip or (model.enc_kind if model.enc_kind in ("cp", "posenc")
                         else None)
  if isinstance(model, PlainNeRF) and model.refl_space == "identity":
    if model.mip is not None:
      return model.mip
    if model.enc_kind in ("cp", "hash", "posenc"):
      return model.enc_kind
  return None


_DYN_CANONICAL_KEYS = {"enc_kind", "refl_kind", "steps", "t_near", "t_far",
                       "sky_kind", "sigmoid_kind"}


def _dyn_enc(enc: Optional[str]) -> Optional[str]:
  """The canonical encoder of a D-NeRF kernel mode ("dyn-cp" -> "cp"),
  None for the other modes."""
  return enc[4:] if enc is not None and enc.startswith("dyn-") else None


def _pack(state_dict, device, enc: str, spline_points: int = 0
          ) -> torch.Tensor:
  """The packed weights of a model in the kernels' envelope."""
  if _dyn_enc(enc):
    return k9.pack_weights(state_dict, device, _dyn_enc(enc), spline_points)
  if enc == "ae":
    return k7.pack_weights_ae(state_dict, device)
  if enc == "volsdf":
    return k8.pack_weights(state_dict, device)
  return k1.pack_weights(state_dict, device, enc)


def _unpack_grads(model, enc: str,
                  packed: torch.Tensor) -> Dict[str, torch.Tensor]:
  if _dyn_enc(enc):
    return k9.unpack_grads(packed, _dyn_enc(enc), model.spline_points)
  if enc == "ae":
    return k7.unpack_grads_ae(packed)
  if enc == "volsdf":                 # d/ds chained to the raw scale
    return k8.unpack_grads(packed, model.density_scale)
  return k1.unpack_grads(packed)


def _fused_common_ok(model, cfg: TrainConfig) -> bool:
  """Config constraints of both training kernel gates
  (train/driver.py:135-155): black or white sky, no density noise, no
  per-ray jitter or lindisp, no crops, no camera training, no active
  out-dict regularizer but the kernel family's (`_KERNEL_REGULARIZERS`;
  NeRFAE's latent L2 the step adds outside the kernel,
  `regularizers.ae_latent_l2`), no omit-bg. The point-sampled
  regularizers pass: the two-kernel path adds them beside the kernels'
  loss by autograd (driver.py:721-733), the one-kernel gate refuses
  them (`_fused_step_fn`). Unlike the JAX gate
  there is no batch-multiple rule (the CUDA kernels mask the ragged
  edge) and no CPU rule (there the wrappers take their plain versions).
  The port's envelope is narrower in one rule: at most as many samples
  per ray as the backward kernel's shared memory holds (CoarseFineNeRF's
  fine pass takes steps + fine_steps; `k1.BWD_MAX_STEPS`: 460 for cone
  and cylinder, whose 96-row init feature takes the room, 1024 for the
  other plain modes; 512 for
  NeRFAE, `k7.BWD_MAX_STEPS`, and VolSDF, `k8.BWD_MAX_STEPS`; 389 for
  the D-NeRF modes with the cp canonical and 1024 with posenc,
  `k9.BWD_MAX_STEPS`, whose four MLP chains take the room), where the JAX
  gate engages its kernel at any count. A model with more steps trains
  through its module forward; its eval render still takes its forward
  kernel (up to 2048 steps). A VolSDF that computes normals engages only
  with the eikonal active, whose residual the kernels compute themselves
  (driver.py:374, :595)."""
  enc = _fused_enc_kind(model)
  if enc is None:
    return False
  allowed = _KERNEL_REGULARIZERS.get(model_kind(model), ())
  max_steps = {"ae": k7.BWD_MAX_STEPS, "volsdf": k8.BWD_MAX_STEPS,
               **{f"dyn-{e}": k9.BWD_MAX_STEPS[e] for e in k9.ENC_KINDS}}
  samples = model.steps + getattr(model, "fine_steps", 0)
  return not (
      samples > max_steps.get(enc, k1.BWD_MAX_STEPS.get(enc))
      or (enc == "volsdf" and model.with_normals
          and not (cfg.reg_coeffs or {}).get("eikonal"))
      or model.sky_kind not in ("black", "white")
      or model.density_noise != 0
      or model.per_ray_jitter or model.lindisp
      or cfg.train_camera or cfg.crop_size > 0
      or any(v for k, v in (cfg.reg_coeffs or {}).items()
             if k not in allowed and k not in regularizers.POINT_REGULARIZERS)
      or cfg.omit_bg)


def _kernel_kw(model) -> dict:
  kw = dict(steps=model.steps, t_near=model.t_near, t_far=model.t_far,
            sigmoid_kind=model.sigmoid_kind, sky_kind=model.sky_kind)
  if isinstance(model, VolSDF):
    kw["sphere_init"] = model.shape.sphere_init
  if isinstance(model, DynamicNeRF):
    kw.update(spline_points=model.spline_points,
              enc_kind=_dyn_enc(_fused_enc_kind(model)))
  return kw


def _data_ok(model, ds) -> bool:
  """A D-NeRF train gate engages only on timed data (driver.py:421,
  :628: `ds.times is None` refuses), a CoarseFineNeRF one only on static
  data (driver.py:303); the other models' gates do not look at the
  times."""
  timed = getattr(ds, "times", None) is not None
  if is_dynamic(model):
    return timed
  return not (timed and isinstance(model, CoarseFineNeRF))


def _step_ts(model, generator: torch.Generator, device) -> torch.Tensor:
  """The step's shared stratified ts [T] (driver.py:512-514 `_ts`)."""
  return rays_ops.compute_ts(model.t_near, model.t_far, model.steps,
                             perturb=1.0, generator=generator, device=device)


def _fused_step_fn(model, cfg: TrainConfig, ds) -> Optional[Callable]:
  """The one-kernel train step (driver.py:448-615): K3 in the model's
  mode (`_fused_enc_kind`), for hash K5f + K3 + K5b, for NeRFAE K7b in
  loss mode, for VolSDF K8b in loss mode with the eikonal inside, when
  the training loss is the kernel's (plain l2 on rgb, no colour
  transforms, tone map, gamma or style, 3- or 4-channel labels) and
  `_fused_common_ok` holds, with no active regularizer but the kernel
  family's (a point-sampled one sends the step to the two-kernel path,
  driver.py:483-495); None otherwise. VolSDF's scale decay reads
  the raw scale, which the kernel step does not return: with it the
  two-kernel path trains (driver.py:582-586). For DynamicNeRF K9b in
  loss mode, with --dp-weight's mean dp² inside (driver.py:617-641).
  None for a CoarseFineNeRF: it has no one-kernel step (its loss sums
  two passes, the fine one on positions drawn from the coarse one).
  Returns fn(rays, pix, generator, times=None) -> (loss, {state_dict key:
  gradient}); times [B] are the rays' times (DynamicNeRF's)."""
  if cfg.no_fused:
    return None
  g = cfg.gamma_correct
  gamma_active = bool(cfg.tone_map) or g is True or (
      not isinstance(g, bool) and g not in (0.0, 1.0))
  style_active = bool(cfg.style_img) and cfg.style_weight > 0
  if (tuple(cfg.loss_kinds) != ("l2",) or tuple(cfg.color_spaces) != ("rgb",)
      or gamma_active or style_active or ds.pixels.shape[-1] not in (3, 4)
      or cfg.volsdf_alternate or isinstance(model, CoarseFineNeRF)
      or not _fused_common_ok(model, cfg) or not _data_ok(model, ds)
      or (cfg.reg_coeffs or {}).get("volsdf_scale")
      or any(v for k, v in (cfg.reg_coeffs or {}).items()
             if k not in _KERNEL_REGULARIZERS.get(model_kind(model), ()))):
    return None
  enc = _fused_enc_kind(model)
  spline = getattr(model, "spline_points", 0)
  _pack(model.state_dict(), None, enc, spline)     # raises on divergence
  kw = _kernel_kw(model)
  eikonal = float((cfg.reg_coeffs or {}).get("eikonal") or 0.0)
  dp_weight = float((cfg.reg_coeffs or {}).get("delta_x") or 0.0)

  def fn(rays, pix, generator, times=None):
    ts = _step_ts(model, generator, rays.device)
    sd = model.state_dict()
    ws = _pack(sd, rays.device, enc, spline)
    target = pix[:, :3].contiguous()
    if _dyn_enc(enc):
      loss, grad = k9.fused_dyn_train_step(ws, rays, times, target, ts,
                                           dp_weight=dp_weight, **kw)
      return loss, _unpack_grads(model, enc, grad)
    if enc == "volsdf":
      loss, grad = k8.fused_volsdf_train_step(ws, rays, target, ts,
                                              eikonal_weight=eikonal, **kw)
      return loss, k8.unpack_grads(grad, model.density_scale)
    if enc == "ae":
      loss, grad = k7.fused_ae_train_step(ws, rays, target, ts, **kw)
      return loss, k7.unpack_grads_ae(grad)
    if enc == "hash":
      loss, grad, dtable = k1.fused_plain_hash_train_step(
          ws, k1.hash_table(sd), rays, target, ts, **kw)
      return loss, {**k1.unpack_grads(grad), k1.HASH_TABLE_KEY: dtable}
    loss, grad = k1.plain_cp_train_step(ws, rays, target, ts=ts,
                                        enc_kind=enc, **kw)
    return loss, k1.unpack_grads(grad)

  return fn


def _fused_train_fn(model, cfg: TrainConfig, ds) -> Optional[Callable]:
  """The two-kernel path (driver.py:158-401): K1 forward and K2 backward
  in the model's mode through `PlainCPRender`, for hash K5f/K5b
  (`HashEncode`) into K1/K2 (`PlainHashRender`), for NeRFAE K7f/K7b
  (`AERender`), for VolSDF K8f/K8b-G (`VolSDFRender`; with the eikonal
  active K8f's 5th column, its per-ray mean residual), for DynamicNeRF
  K9f/K9b-G (`DynRender`; with --dp-weight K9f's 5th column, the per-ray
  mean dp²), for CoarseFineNeRF `fused_coarse_fine_train` (K1 with
  weights and K1 on the fine ts, K2 behind each; driver.py:297-320), with
  the loss computed outside. Returns fn(ws, rays, generator, times=None)
  -> [N, 4] (with an in-kernel regularizer column [N, 5]; CoarseFineNeRF:
  (fine, coarse)), differentiable in the packed weights ws (and, for
  hash, in the model's table parameter), or None. --volsdf-alternate
  trains through the module (driver.py:377). The point-sampled
  regularizers (VolSDF's smoothness and random eikonal, the dynamic
  models' divergence and spline terms) add beside the kernels."""
  if (cfg.no_fused or cfg.volsdf_alternate
      or not _fused_common_ok(model, cfg) or not _data_ok(model, ds)):
    return None
  enc = _fused_enc_kind(model)
  _pack(model.state_dict(), None, enc,
        getattr(model, "spline_points", 0))        # raises on divergence
  kw = _kernel_kw(model)
  want_eikonal = bool((cfg.reg_coeffs or {}).get("eikonal"))
  want_dp = bool((cfg.reg_coeffs or {}).get("delta_x"))

  def fn(ws, rays, generator, times=None):
    ts = _step_ts(model, generator, rays.device)
    if isinstance(model, CoarseFineNeRF):
      return k1.fused_coarse_fine_train(ws, rays, ts, generator,
                                        enc_kind=enc,
                                        fine_steps=model.fine_steps, **kw)
    if _dyn_enc(enc):
      return k9.fused_dyn_render_train(ws, rays, times, ts, want_dp=want_dp,
                                       **kw)
    if enc == "volsdf":
      return k8.fused_volsdf_render_train(ws, rays, ts,
                                          want_eikonal=want_eikonal, **kw)
    if enc == "ae":
      return k7.fused_ae_render_train(ws, rays, ts, **kw)
    if enc == "hash":
      return k1.fused_plain_hash_render_train(
          ws, model.density_mlp.enc.table, rays, ts, **kw)
    return k1.plain_cp_render_train(ws, rays, ts, enc_kind=enc, **kw)

  return fn


def make_train_step(model, ds, loss_fn, opt: optim_lib.TrainOptimizer,
                    cfg: TrainConfig, fused_step=None, fused_train=None):
  """The per-step closure step(i, generator) -> {"loss", "mse"} (device
  scalars; loss = mse + the regularizer): sample a batch, get the
  gradient from the one-kernel step, from the two-kernel path, or from
  the module forward under autograd, mask it (train_only /
  freeze_substr), and step the optimizer. The hash table's gradient
  comes from K5b. NeRFAE's latent L2 (driver.py:672-683, :813-818) is
  the module's out["latent_l2"] on the oracle path; the fused paths add
  the point-sampled `regularizers.ae_latent_l2` and its autograd
  gradient to the kernel's. VolSDF's regularizers: on the oracle path
  the module's out["eikonal"] and out["scale"]
  (`regularizers.total_regularizer`); on the two-kernel path K8f's
  eikonal column (its mean over the rays) and the scale computed from
  the raw parameter (driver.py:724-735); the one-kernel step computes
  the eikonal inside K8b. DynamicNeRF's --dp-weight: on the oracle path
  the mean of out["dp"]² (`regularizers.delta_x`); on the two-kernel
  path K9f's dp² column (its mean over the rays, driver.py:724-731); the
  one-kernel step computes it inside K9b. The point-sampled regularizers
  (`regularizers.point_regularizers`: the SDF models' smoothness and
  random eikonal with the --smooth-* options, the dynamic models'
  divergence and spline terms) add to the two-kernel and the oracle
  path's loss by autograd (driver.py:721-733, :789-792), the out-dict
  ones (`regularizers.total_regularizer`) to the oracle's. CoarseFineNeRF's
  loss sums the fine and the coarse image's (driver.py:716-718,
  :786-787), on both paths. The SDF renderer's loss with 4-channel labels
  is the l2 on rgb plus the mean sigmoid BCE of out["sil_logit"] against
  the alpha (driver.py:769-780); a model with a throughput output and no
  logit appends it to rgb as the 4th channel (:781-784).
  --volsdf-alternate (driver.py:742-764): step i's phase (i // alt_train)
  % 2 trains the volume render (phase 0, its loss with the out-dict
  regularizers) or `surface_render` (phase 1, rgb with the throughput as
  the 4th channel), the point-sampled terms beside either; with
  alt_train > 0 the gradients of parameters whose names hold "analytic"
  are scaled by the phase and those holding "learned" by 1 − phase
  (driver.py:837-847; no port model has them yet). A
  dynamic model's batch carries each ray's time (its view's). A parameter
  that takes no gradient in a step (VolSDF's and DynamicNeRF's Fourier
  matrices; VolSDF's scale in a surface step) gets a zero one, so that
  the optimizer steps it as optax steps every parameter: weight decay
  shrinks it, Adam's moments decay and move it."""
  params = dict(model.named_parameters())
  device = next(model.parameters()).device
  enc = _fused_enc_kind(model)
  dynamic = is_dynamic(model)
  coeffs = cfg.reg_coeffs or {}
  latent_l2 = float(coeffs.get("latent_l2") or 0.0)
  column = float(coeffs.get(_COLUMN_REGULARIZER.get(model_kind(model), ""))
                 or 0.0)
  scale_decay = float(coeffs.get("volsdf_scale") or 0.0)
  smooth_opts = {"eps": cfg.smooth_eps, "eps_rng": cfg.smooth_eps_rng,
                 "ords": tuple(cfg.smooth_ords)}

  def points(generator):
    return regularizers.point_regularizers(model, generator, coeffs,
                                           smooth_opts)

  def module_loss(rays, pix, generator, timed):
    """(main, regularized loss) through the module forward."""
    out = model(rays, train=True, generator=generator, **timed)
    pred = out["rgb"]
    if "sil_logit" in out and pix.shape[-1] > 3:
      main = loss_fn(pred, pix[..., :3]) + F.binary_cross_entropy_with_logits(
          out["sil_logit"][..., 0], pix[..., 3])
    else:
      if "throughput" in out and pix.shape[-1] > 3:
        pred = torch.cat([pred, out["throughput"]], dim=-1)
      main = loss_fn(pred, pix)
    if "coarse_rgb" in out:
      main = main + loss_fn(out["coarse_rgb"], pix)
    return main, (main + regularizers.total_regularizer(out, coeffs)
                  + points(generator))

  def alternate_loss(rays, pix, generator, phase):
    """--volsdf-alternate's (main, loss) in `phase`."""
    if phase == 0:
      out = model(rays, train=True, generator=generator)
      main = loss_fn(out["rgb"], pix) + regularizers.total_regularizer(
          out, coeffs)
    else:
      out = model.surface_render(rays, train=True, generator=generator)
      pred = out["rgb"]
      if pix.shape[-1] > 3:
        pred = torch.cat([pred, out["throughput"]], dim=-1)
      main = loss_fn(pred, pix)
    return main, main + points(generator)

  def fused_regularizer(out, generator):
    """The regularizer of the two-kernel path, outside the kernels."""
    reg = points(generator)
    if latent_l2:
      reg = reg + latent_l2 * regularizers.ae_latent_l2(model, generator)
    if out.shape[-1] == 5:
      reg = reg + column * torch.mean(out[:, 4])
    if scale_decay:
      reg = reg + scale_decay * model.density_params()
    return reg

  def add_grads(grads):
    for key, grad in grads.items():
      p = params[key]
      p.grad = grad if p.grad is None else p.grad + grad

  def step(i: int, generator: torch.Generator):
    phase = (i // cfg.alt_train) % 2 if cfg.alt_train else 0
    opt.zero_grad()
    rays, pix, t, _ = ds.sample(
        generator, cfg.batch_size, jitter=cfg.pixel_jitter,
        serial_step=i if cfg.serial_idxs else None, end_bias=cfg.end_bias)
    timed = {"times": t} if dynamic else {}
    if fused_step is not None:
      main, grads = fused_step(rays, pix, generator, **timed)
      loss = main
      if latent_l2:
        reg = latent_l2 * regularizers.ae_latent_l2(model, generator)
        reg.backward()                # the encoder's .grad
        loss = main + reg.detach()
      add_grads(grads)
    elif fused_train is not None:
      ws = _pack(model.state_dict(), device, enc,
                 getattr(model, "spline_points", 0)).requires_grad_(True)
      out = fused_train(ws, rays, generator, **timed)
      if isinstance(out, tuple):        # coarse_fine: (fine, coarse)
        main = loss_fn(out[0][:, :3], pix) + loss_fn(out[1][:, :3], pix)
        out = out[0]
      else:
        main = loss_fn(out[:, :3], pix)
      loss = main + fused_regularizer(out, generator)
      loss.backward()       # hash: the table's .grad, ae: the encoder's,
      add_grads(_unpack_grads(model, enc, ws.grad))  # volsdf: the scale's
    elif cfg.volsdf_alternate:
      main, loss = alternate_loss(rays, pix, generator, phase)
      loss.backward()
    else:
      main, loss = module_loss(rays, pix, generator, timed)
      loss.backward()
    for p in params.values():
      if p.grad is None:
        p.grad = torch.zeros_like(p)
    for key, p in params.items():
      keep = (cfg.train_only is None
              or any(k in key for k in cfg.train_only))
      if not keep or (cfg.freeze_substr and cfg.freeze_substr in key):
        p.grad = torch.zeros_like(p.grad)
      elif cfg.alt_train > 0:
        if "analytic" in key:
          p.grad = p.grad * phase
        elif "learned" in key:
          p.grad = p.grad * (1 - phase)
    opt.step()
    return {"loss": loss.detach(), "mse": main.detach()}

  return step


def train(model, ds: sampler_lib.RayDataset, cfg: TrainConfig,
          config_dict: Optional[dict] = None,
          callback: Optional[Callable] = None) -> List[dict]:
  """The outer loop (driver.py:857-968); trains `model` in place and
  returns the logged history (loss, mse, step, psnr, steps_per_sec)."""
  global LAST_TRAIN_PATH
  check_config(cfg, model_kind(model))
  loss_fn = losses_lib.load_loss_fn(cfg.loss_kinds, cfg.color_spaces,
                                    cfg.tone_map, cfg.gamma_correct)
  opt = optim_lib.load_optimizer(
      model.parameters(), cfg.opt_kind, cfg.learning_rate,
      total_steps=cfg.steps, sched_min=cfg.sched_min,
      no_sched=cfg.no_sched, grad_clip=cfg.grad_clip,
      accum_steps=cfg.accum_steps, weight_decay=cfg.weight_decay)
  fused_step = _fused_step_fn(model, cfg, ds)
  fused_train = (None if fused_step is not None
                 else _fused_train_fn(model, cfg, ds))
  if fused_step is not None:
    LAST_TRAIN_PATH = "fused-one-kernel"
    print("[train] fused train kernel engaged (one-kernel step)")
  elif fused_train is not None:
    LAST_TRAIN_PATH = "fused"
    print("[train] fused train kernel engaged")
  else:
    LAST_TRAIN_PATH = "oracle"
    print("[train] path: oracle (plain torch)"
          + (" — forced by --no-fused" if cfg.no_fused else ""))
  step_fn = make_train_step(model, ds, loss_fn, opt, cfg,
                            fused_step=fused_step, fused_train=fused_train)

  generator = torch.Generator(device=ds.device).manual_seed(cfg.seed + 1234)
  history = []
  start = last_t = time.perf_counter()
  last_i = 0
  for i in range(cfg.steps):
    metrics = step_fn(i, generator)
    if ((i + 1) % cfg.log_freq == 0 or i == 0) and i >= cfg.skip_loss:
      m = {k: float(v) for k, v in metrics.items()}   # waits for the step
      if not math.isfinite(m["loss"]):
        raise FloatingPointError(
            f"non-finite loss {m['loss']} at step {i + 1}")
      now = time.perf_counter()
      m["step"] = i + 1
      m["psnr"] = float(losses_lib.mse2psnr(m["mse"]))
      m["steps_per_sec"] = (i + 1 - last_i) / max(now - last_t, 1e-9)
      last_t, last_i = now, i + 1
      history.append(m)
      if callback:
        callback(m)
    if cfg.save_freq and (i + 1) % cfg.save_freq == 0:
      checkpoints.save(cfg.save_path, model.state_dict(), config=config_dict,
                       step=i + 1, versioned=cfg.versioned_save)
    if cfg.valid_freq and (i + 1) % cfg.valid_freq == 0:
      _save_valid_image(model, ds, cfg, i + 1)
    if cfg.duration_sec and time.perf_counter() - start > cfg.duration_sec:
      break
  if cfg.save_freq:
    checkpoints.save(cfg.save_path, model.state_dict(), config=config_dict,
                     step=cfg.steps, versioned=cfg.versioned_save)
  return history


def train_progressive(model, ds: sampler_lib.RayDataset, cfg: TrainConfig,
                      segments: int = 4, config_dict: Optional[dict] = None,
                      callback: Optional[Callable] = None) -> List[dict]:
  """Progressive long-video training (driver.py:1232-1290): the views,
  time-sorted, split into `segments` windows [lo, hi) trained in turn,
  each `cfg.steps` steps with a fresh optimizer whose schedule is
  `cfg.steps` long, its rays from its window without pixel jitter, its
  draws from a generator seeded with seed + 99 + s, through the module
  forward under autograd with the out-dict regularizers only. Saves once
  at the end; returns the history (loss, mse, psnr, step, segment every
  `log_freq` steps)."""
  global LAST_TRAIN_PATH
  check_config(cfg, model_kind(model))
  LAST_TRAIN_PATH = "oracle"
  loss_fn = losses_lib.load_loss_fn(cfg.loss_kinds, cfg.color_spaces,
                                    cfg.tone_map, cfg.gamma_correct)
  fixed = [p for p in model.parameters() if not p.requires_grad]
  timed = is_dynamic(model)
  n, history = ds.num_views, []
  for s in range(segments):
    lo = (s * n) // segments
    hi = max(((s + 1) * n) // segments, lo + 1)
    opt = optim_lib.load_optimizer(
        model.parameters(), cfg.opt_kind, cfg.learning_rate,
        total_steps=cfg.steps, sched_min=cfg.sched_min,
        no_sched=cfg.no_sched, grad_clip=cfg.grad_clip,
        accum_steps=cfg.accum_steps)
    generator = torch.Generator(device=ds.device).manual_seed(
        cfg.seed + 99 + s)
    for i in range(cfg.steps):
      opt.zero_grad()
      rays, pix, t, _ = ds.sample(generator, cfg.batch_size,
                                  view_range=(lo, hi))
      out = model(rays, train=True, generator=generator,
                  **({"times": t} if timed else {}))
      main = loss_fn(out["rgb"], pix)
      loss = main + regularizers.total_regularizer(out, cfg.reg_coeffs)
      loss.backward()
      for p in fixed:
        p.grad = torch.zeros_like(p)
      opt.step()
      if (i + 1) % cfg.log_freq == 0:
        m = {"loss": float(loss.detach()), "mse": float(main.detach())}
        if not math.isfinite(m["loss"]):
          raise FloatingPointError(
              f"non-finite loss {m['loss']} at segment {s} step {i + 1}")
        m.update(step=i + 1, segment=s,
                 psnr=float(losses_lib.mse2psnr(m["mse"])))
        history.append(m)
        if callback:
          callback(m)
  if cfg.save_freq:
    checkpoints.save(cfg.save_path, model.state_dict(), config=config_dict,
                     step=segments * cfg.steps)
  return history


def _save_valid_image(model, ds, cfg: TrainConfig, step: int):
  """Validation render of view 0 at up to 64×64 (driver.py:1217-1229),
  written next to the checkpoint. A render error propagates."""
  img = render_view(model, ds, 0, min(ds.size, 64))
  out_dir = os.path.dirname(cfg.save_path) or "."
  os.makedirs(out_dir, exist_ok=True)
  write_png(os.path.join(out_dir, f"valid_{step:06d}.png"),
            to_u8(img[..., :3]))


def _fused_render_fn(model) -> Optional[Callable]:
  """rays [n, 6] -> rgb [n, 3] through K1 in the model's mode (cp,
  posenc, tiny, cone, cylinder), K5f + K1 (hash), K7f (ae), K8f (volsdf),
  K1 twice (a CoarseFineNeRF: the coarse pass with weights, the fine pass
  on the merged per-ray ts; `fused_coarse_fine_render`, driver.py:1180)
  or K9f (a DynamicNeRF, at each ray's time times [n]: fn(rays, times))
  when the model is in the kernels' envelope (`_fused_enc_kind`, any sky
  the kernel implements: the "random" sky is black at eval,
  driver.py:1045, :1145; D-NeRF's eval gate takes black and white only,
  driver.py:1075); None otherwise. A parameter tree that diverges from
  the default one raises (in `pack_weights`)."""
  enc = _fused_enc_kind(model)
  if enc is None or model.sky_kind not in integrate.SKY_KINDS or (
      _dyn_enc(enc) and model.sky_kind not in ("black", "white")):
    return None
  device = next(model.parameters()).device
  sd = model.state_dict()
  ws = _pack(sd, device, enc, getattr(model, "spline_points", 0))
  kw = _kernel_kw(model)

  def fn(rays_chunk, times_chunk=None):
    if isinstance(model, CoarseFineNeRF):
      return k1.fused_coarse_fine_render(ws, rays_chunk, enc_kind=enc,
                                         fine_steps=model.fine_steps,
                                         **kw)[:, :3]
    if _dyn_enc(enc):
      return k9.fused_dyn_render(ws, rays_chunk, times_chunk, **kw)[:, :3]
    if enc == "volsdf":
      return k8.fused_volsdf_render(ws, rays_chunk, **kw)[:, :3]
    if enc == "ae":
      return k7.fused_ae_render(ws, rays_chunk, **kw)[:, :3]
    if enc == "hash":
      return k1.fused_plain_hash_render(ws, k1.hash_table(sd), rays_chunk,
                                        **kw)[:, :3]
    return k1.plain_cp_render(ws, rays_chunk, enc_kind=enc, **kw)[:, :3]

  return fn


@torch.no_grad()
def render_view(model, ds: sampler_lib.RayDataset, view: int,
                render_size: Optional[int] = None, chunk: int = 65536,
                mode: str = "rgb",
                time_val: Optional[float] = None) -> np.ndarray:
  """Tiled no-grad rendering of one full view -> [S, S, C] numpy.

  mode: "rgb" | "depth" (expected termination depth) | "acc" (opacity)
  | "normals" (an SDF model's out["normals"]) | "flow" (a dynamic
  model's deformation out["dp"]) | "rigidity" (its out["rigidity"]), the
  per-sample maps weight-integrated along the ray, a per-ray one (the SDF
  renderer's normals) as it is (driver.py:1293-1360). rgb goes through
  the model's kernel when the model is in its envelope, everything else
  through the model's forward; a model that emits no such map raises
  KeyError. A model's `eval_chunk` (the SDF renderer's) bounds `chunk`.
  A dynamic model renders at `time_val`, else at the view's time
  ds.times[view] (driver.py:1320-1338); with neither it raises."""
  maps = {"normals": "normals", "flow": "dp", "rigidity": "rigidity"}
  if mode not in ("rgb", "depth", "acc", *maps):
    raise ValueError(f"unknown render mode {mode}")
  chunk = min(chunk, getattr(model, "eval_chunk", chunk))
  rs = render_size or ds.size
  rays = ds.view_rays(view, rs)
  timed = {}
  if is_dynamic(model):
    if time_val is None:
      if ds.times is None:
        raise ValueError("a dynamic model renders at a time: pass time_val "
                         "or give the dataset its views' times")
      time_val = float(ds.times[view])
    timed["times"] = torch.full((rays.shape[0],), time_val,
                                dtype=torch.float32, device=rays.device)
  fused = _fused_render_fn(model) if mode == "rgb" else None
  outs = []
  for i in range(0, rays.shape[0], chunk):
    rc = rays[i:i + chunk]
    tc = {k: v[i:i + chunk] for k, v in timed.items()}
    if fused is not None:
      outs.append(fused(rc, *tc.values()))
      continue
    out = model(rc, **tc)
    if mode == "depth":
      outs.append(integrate.depth_from_weights(out["weights"], out["ts"]))
    elif mode == "acc":
      outs.append(out["weights"].sum(-1, keepdim=True))
    elif mode in maps:
      val = out.get(maps[mode])
      if val is None:
        raise KeyError(f"model emits no '{maps[mode]}' (mode={mode})")
      w = out["weights"]
      outs.append(integrate.volumetric_integrate(w, val)
                  if val.ndim == w.ndim + 1 else val)
    else:
      outs.append(out["rgb"])
  return torch.cat(outs).reshape(rs, rs, -1).cpu().numpy()


def write_png(path: str, img: np.ndarray):
  """Write a uint8 image [H, W] or [H, W, C] (C = 1, 3 or 4) as an 8-bit
  PNG with zlib and struct alone."""
  img = np.ascontiguousarray(img, dtype=np.uint8)
  if img.ndim == 2:
    img = img[..., None]
  h, w, c = img.shape
  color_type = {1: 0, 3: 2, 4: 6}[c]
  rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                        axis=1)                  # filter byte 0 per row

  def chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

  png = (b"\x89PNG\r\n\x1a\n"
         + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0,
                                      0))
         + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
         + chunk(b"IEND", b""))
  with open(path, "wb") as f:
    f.write(png)


def to_u8(img):
  return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _query_normals(model, ds, view: int, render_size: Optional[int],
                   depth: np.ndarray, chunk: int) -> np.ndarray:
  """--depth-query-normal's map (driver.py:1437-1449): the model's SDF
  normals at each ray's expected termination point o + depth·d, unit
  length, mapped to [0, 1], black where the depth reaches t_far − 0.1."""
  rs = render_size or ds.size
  rays = ds.view_rays(view, rs).cpu().numpy().reshape(rs, rs, 6)
  isect = torch.from_numpy(rays[..., :3] + rays[..., 3:] * depth[..., None])
  isect = isect.reshape(-1, 3).to(ds.pixels.device)
  n = torch.cat([model.normals(p) for p in isect.split(chunk)])
  n = n.detach().cpu().numpy().reshape(rs, rs, 3)
  n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
  far = getattr(model, "t_far", 1e9)
  return np.where(depth[..., None] > far - 1e-1, 0.0, n * 0.5 + 0.5)


def test(model, ds: sampler_lib.RayDataset, out_dir: str = "outputs",
         render_size: Optional[int] = None, save_images: bool = True,
         chunk: int = 65536, only_view: Optional[int] = None,
         white_bg: bool = False, with_alpha: bool = False,
         save_depth: bool = False, extra_maps: tuple = (),
         depth_query_normal: bool = False):
  """Per-view PSNR + summary stats; writes results.txt (the JAX package's
  format) + test_###.png (+ depth_###.png with save_depth; + <map>_###.png
  for each of extra_maps ⊆ {normals, flow, rigidity}: the normals mapped
  from [−1, 1] to [0, 1], |flow| over its max, the rigidity in grey,
  driver.py:1450-1466; + query_normals_###.png with depth_query_normal,
  `_query_normals`, where the model has `normals`, else a note). `chunk`
  = rays per tiled render call (--test-crop-size²).

  only_view: test a single view (--render-frame). white_bg: composite the
  reference over white via its alpha (--test-white-bg). with_alpha: save
  RGBA using the accumulated opacity (--with-alpha). A render whose size
  differs from the reference raises (the JAX package resizes the
  reference with cv2, which the port does not carry)."""
  os.makedirs(out_dir, exist_ok=True)
  psnrs, lines = [], []
  views = range(ds.num_views) if only_view is None else [only_view]
  for v in views:
    img = render_view(model, ds, v, render_size, chunk=chunk)
    if save_depth or depth_query_normal:
      depth = render_view(model, ds, v, render_size, chunk=chunk,
                          mode="depth")[..., 0]
    if save_depth:
      dmin, dmax = float(depth.min()), float(depth.max())
      dn = (depth - dmin) / max(dmax - dmin, 1e-6)
      write_png(os.path.join(out_dir, f"depth_{v:03d}.png"), to_u8(dn))
    if depth_query_normal:
      if hasattr(model, "normals"):
        write_png(os.path.join(out_dir, f"query_normals_{v:03d}.png"),
                  to_u8(_query_normals(model, ds, v, render_size, depth,
                                       chunk)))
      else:
        print(f"[test] depth-query-normal unavailable: "
              f"{type(model).__name__} has no normals")
    for m in extra_maps:
      vis = render_view(model, ds, v, render_size, chunk=chunk, mode=m)
      if m == "normals":
        vis = vis * 0.5 + 0.5
      elif m == "flow":
        vis = np.abs(vis) / max(float(np.abs(vis).max()), 1e-6)
      if vis.shape[-1] == 1:
        vis = np.repeat(vis, 3, axis=-1)
      write_png(os.path.join(out_dir, f"{m}_{v:03d}.png"),
                to_u8(vis[..., :3]))
    ref_full = ds.pixels[v].cpu().numpy()
    ref = ref_full[..., :3]
    if white_bg and ref_full.shape[-1] > 3:
      a = ref_full[..., 3:4]
      ref = ref * a + (1.0 - a)
    if img.shape[:2] != ref.shape[:2]:
      raise ValueError(
          f"view {v}: render {img.shape[:2]} vs reference {ref.shape[:2]}; "
          "the port compares at the dataset's size only")
    mse = float(np.mean((img[..., :3] - ref) ** 2))
    p = float(-10 * math.log10(max(mse, 1e-10)))
    psnrs.append(p)
    lines.append(f"view {v:03d}: PSNR {p:.3f}")
    if save_images:
      save = np.clip(img[..., :3], 0, 1)
      if with_alpha:
        acc = render_view(model, ds, v, render_size, chunk=chunk, mode="acc")
        save = np.concatenate([save, np.clip(acc, 0, 1)], axis=-1)
      write_png(os.path.join(out_dir, f"test_{v:03d}.png"), to_u8(save))
  arr = np.asarray(psnrs)
  summary = (f"PSNR mean {arr.mean():.3f} median {np.median(arr):.3f} "
             f"min {arr.min():.3f} max {arr.max():.3f} var {arr.var():.4f}")
  lines.append(summary)
  with open(os.path.join(out_dir, "results.txt"), "w") as f:
    f.write("\n".join(lines) + "\n")
  return {"psnr_mean": float(arr.mean()), "psnr_median": float(np.median(arr)),
          "psnrs": psnrs, "summary": summary}


def render_over_time(model, ds: sampler_lib.RayDataset, view: int = 0,
                     frames: int = 24, render_size: Optional[int] = None,
                     end_sec: float = 1.0) -> np.ndarray:
  """A fixed camera (`view`) swept over t in [0, end_sec] in `frames`
  renders (driver.py:1535-1546) -> [frames, S, S, 3]."""
  return np.stack([
      render_view(model, ds, view, render_size,
                  time_val=end_sec * i / max(frames - 1, 1))
      for i in range(frames)])
