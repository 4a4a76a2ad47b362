"""The port's entry point: `python -m nerf_atlas_tpu_torch.runner ...`.

Takes the root `runner.py`'s flags (through the port's own copy of its
parser, `cli.py`) and runs the flow of its `main`: load the data, build
the model, initialize it from `--seed` or restore `--load`, train for
`--epochs` steps (through the one-kernel step where the gate allows,
log.json records the engaged path), then render and score the train and
test splits (results.txt, test_###.png, with --normals-images,
--flow-images and --rigidity-images normals_###.png, flow_###.png and
rigidity_###.png, with --depth-images depth_###.png, with
--depth-query-normal query_normals_###.png; --visualize names the same
maps). On timed data
(`--data-kind synthetic-dyn`) with a --dyn-model it also writes
--cluster-movement's clusters.png (k-means of the flow at t = 0.5),
--render-over-time's frames and --render-bezier-keyframes' keyframes. The
GPU machine has no matplotlib and no imageio, so the loss plot (loss.png)
is not written, the frames over time are over_time_###.png in place of
over_time.gif, the keyframes keyframe_##.png, and clusters.png takes
matplotlib's tab10 palette from ten RGB constants; every image goes
through `driver.write_png`.

Examples (procedural scene):
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model plain --size 48 --num-views 30 --epochs 1500 \
      --batch-size 4096 -lr 1e-3 --seed 0 --nosave --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model plain --size 800 --num-views 2 --epochs 0 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model plain --enc-kind hash --hash-table-log2 14 --size 48 \
      --num-views 30 --epochs 1500 --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model ae --normalize-latent --latent-l2-weight 1e-3 --size 48 \
      --num-views 30 --epochs 1500 --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model plain --enc-kind posenc --size 48 --num-views 30 \
      --epochs 1500 --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model plain --mip cone --size 48 --num-views 30 --epochs 1500 \
      --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model coarse_fine --mip cone --size 48 --num-views 30 \
      --epochs 1500 --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model tiny --size 48 --num-views 30 --epochs 3000 \
      --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model volsdf --sdf-kind mlp --sigmoid-kind upshifted \
      --sdf-eikonal 0.01 --size 48 --num-views 30 --epochs 1500 \
      --batch-size 4096 -lr 3e-4 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model volsdf --sigmoid-kind upshifted --sdf-eikonal 0.01 \
      --smooth-normals-weight 1e-3 --size 48 --num-views 30 --epochs 300 \
      --batch-size 4096 -lr 3e-4 --normals-images --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model volsdf --volsdf-alternate --alt-train 1 --sdf-kind siren \
      --size 48 --num-views 30 --epochs 300 --batch-size 4096 -lr 3e-4 \
      --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model sdf --sdf-kind mlp --isect-kind bisect --size 48 \
      --num-views 30 --epochs 1500 --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic-dyn \
      --model plain --enc-kind cp --dyn-model plain [--spline 4 \
      --dp-weight 1e-3] --size 48 --num-views 30 --epochs 1500 \
      --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic-dyn \
      --model plain --dyn-model plain --spline 4 --dp-weight 1e-3 \
      --spline-len-decay 1e-3 --spline-pt0-decay 1e-3 \
      --dyn-divergence-weight 1e-3 --flow-images --rigidity-images \
      --cluster-movement 3 --size 48 --num-views 30 --epochs 300 \
      --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic-dyn \
      --model ae --dyn-model ae --size 800 --num-views 1 --epochs 0 \
      --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic-dyn \
      --model plain --dyn-model long --long-vid-segments 4 \
      --long-vid-progressive-train 2 --size 48 --num-views 30 \
      --epochs 15 --batch-size 4096 -lr 1e-3 --outdir out
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic-dyn \
      --model plain --dyn-model plain --spline 4 --render-over-time 0 \
      --render-frames 4 --render-bezier-keyframes --size 800 \
      --num-views 1 --epochs 0 --notraintest --notest --outdir out
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from . import cli
from .data import load, sampler
from .models import load_dyn_model, load_model
from .train import checkpoints, driver

# flags the port does not carry yet: (attribute, ROADMAP item)
_UNSUPPORTED = (
    ("bendy", "Queue 1 #13"), ("neural_upsample", "Queue 1 #13"),
    ("with_canon", "Queue 1 #11"), ("light_kind", "Queue 1 #13"),
    ("replace", "Queue 1 #13"), ("cam_save_load", "Queue 1 #13"),
    ("msssim_loss", "Queue 1 #5"), ("exp_bg", "Queue 1 #13"),
    ("draw_colormap", "Queue 1 #13"), ("normals_from_depth", "Queue 1 #13"),
)
# --visualize's names -> the flags they set (runner.py:845-847)
_VISUALIZE = {"depth": "depth_images", "normals": "normals_images",
              "flow": "flow_images", "rigidity": "rigidity_images"}

# matplotlib's tab10 palette (its ten colours, `--cluster-movement`)
TAB10 = np.array([[0x1f, 0x77, 0xb4], [0xff, 0x7f, 0x0e], [0x2c, 0xa0, 0x2c],
                  [0xd6, 0x27, 0x28], [0x94, 0x67, 0xbd], [0x8c, 0x56, 0x4b],
                  [0xe3, 0x77, 0xc2], [0x7f, 0x7f, 0x7f], [0xbc, 0xbd, 0x22],
                  [0x17, 0xbe, 0xcf]]) / 255.0


def _check_supported(args):
  for flag, item in _UNSUPPORTED:
    if getattr(args, flag):
      raise NotImplementedError(
          f"--{flag.replace('_', '-')}: not ported yet (ROADMAP {item})")
  if args.model not in ("tiny", "plain", "ae", "coarse_fine", "volsdf",
                        "sdf"):
    raise NotImplementedError(
        f"--model {args.model}: the port has TinyNeRF, PlainNeRF, NeRFAE, "
        "CoarseFineNeRF, VolSDF and SDF so far (ROADMAP Queue 1 #13 the "
        "rest)")
  if args.ref_compat and args.model not in ("volsdf", "sdf"):
    what = ("the ref-hash encoder (ROADMAP Queue 1 #7) and the reference's "
            "widths (#13)" if args.model == "plain" else
            "the reference's widths (ROADMAP Queue 1 #13)")
    raise NotImplementedError(
        f"--ref-compat for --model {args.model}: {what} are not ported yet")
  if args.dyn_model not in (None, "plain", "ae", "long"):
    raise NotImplementedError(
        f"--dyn-model {args.dyn_model}: the port has 'plain', 'ae' and "
        "'long'; the voxel and rig models arrive with ROADMAP Queue 1 #11")


def build_model(args, device, dynamic: bool = False):
  """runner.py:build_model for --model tiny, plain, ae, coarse_fine and
  volsdf, and on timed data (`dynamic`) a dynamic model (runner.py:562-585):
  --dyn-model plain a DynamicNeRF (--spline, --dyn-refl-latent) and long a
  LongDynamicNeRF (--long-vid-segments) over the canonical --model (tiny,
  plain, ae or coarse_fine; volsdf raises, a fault of the reference), whose
  kwargs are --refl-kind but for tiny, and for plain also --enc-kind; ae a
  DynamicNeRFAE from the common kwargs alone (its NeRFAE takes the class
  defaults, whatever --encoding-size or --normalize-latent say). As in the
  root runner, --dyn-model on static data builds the static model. tiny
  takes the common kwargs only (runner.py:449-456). plain
  also takes --refl-kind, --mip, --enc-kind and --space-kind
  (runner.py:458-466); --hash-table-log2 N sets the hash table to 2^N
  entries per level when N is not the default 19 (runner.py:470-471).
  coarse_fine takes --refl-kind, --mip and --enc-kind (cp by default, not
  the class's hash; runner.py:459-467), and as in the root runner neither
  --space-kind nor --hash-table-log2. ae takes --refl-kind, --encoding-size
  and --normalize-latent (runner.py:483-486); like the root runner it
  ignores --mip, --enc-kind and --space-kind. volsdf takes --sdf-kind
  (every shape, unbounded: --bound-sphere-rad is the sdf model's),
  --refl-kind, --sphere-init / --no-sphere-init, --occ-kind and
  --integrator-kind (which the port's VolSDF refuses, ROADMAP Queue 1 #13),
  computes normals when --sdf-eikonal or --surface-eikonal is set, so
  that the eikonal reads them, and with --ref-compat takes the
  reference's MLP spectrum (128 frequencies at sigma 16/2π, no sphere
  init) for the mlp and curl-mlp kinds (curl-mlp has no such options and
  raises, as in the JAX package) and the "ident" scale (runner.py:503-531).
  sdf (runner.py:536-543) takes --sdf-kind, --refl-kind, --isect-kind,
  t_near = max(--near − 2, 0), t_far = --far, --sigmoid-kind, always a
  bounding sphere of --bound-sphere-rad (1.5 when not positive) and
  --sphere-init; the common kwargs are not its."""
  kwargs = dict(steps=args.steps, t_near=args.near, t_far=args.far,
                sky_kind=args.sky_kind, sigmoid_kind=args.sigmoid_kind,
                intermediate_size=args.intermediate_size,
                lindisp=args.lindisp, per_ray_jitter=args.per_ray_jitter,
                density_noise=args.density_noise)
  if dynamic and args.dyn_model is not None:
    if args.dyn_model == "ae":
      return load_dyn_model("ae", device=device, **kwargs)
    canon = {"refl_kind": args.refl_kind} if args.model != "tiny" else {}
    if args.model == "plain":
      canon["enc_kind"] = args.enc_kind
    if args.dyn_model == "long":
      return load_dyn_model("long", device=device, canonical_kind=args.model,
                            segments=args.long_vid_segments,
                            canonical_kwargs=canon, **kwargs)
    return load_dyn_model(
        "plain", device=device, canonical_kind=args.model,
        spline_points=args.spline, canonical_kwargs=canon,
        time_latent_size=args.dyn_refl_latent, **kwargs)
  if args.model == "tiny":
    return load_model("tiny", device=device, **kwargs)
  kwargs["refl_kind"] = args.refl_kind
  if args.model == "sdf":
    return load_model(
        "sdf", device=device, sdf_kind=args.sdf_kind,
        refl_kind=args.refl_kind, isect_kind=args.isect_kind,
        t_near=max(args.near - 2, 0.0), t_far=args.far,
        sigmoid_kind=args.sigmoid_kind, bounded=True,
        bound_radius=(args.bound_sphere_rad if args.bound_sphere_rad > 0
                      else 1.5),
        sdf_kwargs={"sphere_init": args.sphere_init})
  if args.model == "volsdf":
    ref = args.ref_compat
    kwargs.update(sdf_kind=args.sdf_kind, occ_kind=args.occ_kind,
                  integrator_kind=args.integrator_kind,
                  with_normals=(args.eikonal_weight > 0
                                or args.surface_eikonal > 0),
                  sdf_kwargs=(
                      {"sphere_init": False, "enc_freqs": 128,
                       "enc_sigma": 16 / (2 * math.pi)}
                      if ref and args.sdf_kind in ("mlp", "curl-mlp")
                      else {"sphere_init": args.sphere_init}),
                  **({"scale_kind": "ident"} if ref else {}))
    return load_model("volsdf", device=device, **kwargs)
  if args.model == "ae":
    kwargs.update(encoding_size=args.encoding_size,
                  normalize_latent=args.normalize_latent)
  elif args.model == "coarse_fine":
    kwargs.update(mip=args.mip, enc_kind=args.enc_kind)
  else:
    kwargs.update(mip=args.mip, enc_kind=args.enc_kind,
                  refl_space=args.space_kind)
    if args.enc_kind == "hash" and args.hash_table_log2 != 19:
      kwargs["table_size"] = 1 << args.hash_table_log2
  return load_model(args.model, device=device, **kwargs)


def make_train_config(args, dynamic: bool = False) -> driver.TrainConfig:
  """runner.py:make_train_config for the fields the port trains with
  (`dynamic`: the model is a dynamic one, whose regularizers are carried).
  Flags whose path is not ported raise NotImplementedError naming their
  ROADMAP item (here, or in `driver.check_config`)."""
  if args.crop_size > 0 or set(args.loss_fns) & {"ssim", "fft"}:
    raise NotImplementedError(
        "--crop-size / --loss-fns ssim|fft: crop batches arrive with "
        "ROADMAP Queue 1 #5")
  if args.train_parts != ["all"]:
    raise NotImplementedError(
        "--train-parts: the refl/occ/path-tf groups and camera training "
        "arrive with their models (ROADMAP Queue 1 #13)")
  # --mesh-devices 0 ("all") and 1 both train on the one device the port
  # uses; a mesh of several devices is data parallelism
  if args.mesh_devices > 1 or args.data_parallel:
    raise NotImplementedError(
        "--mesh-devices > 1 / --data-parallel: the port trains on one "
        "device; multi-GPU training arrives with ROADMAP Queue 1 #12")
  if args.volsdf_alternate:
    if args.model != "volsdf":
      raise ValueError("--volsdf-alternate needs --model volsdf")
    if args.alt_train == 0:
      args.alt_train = 2048           # the reference's run_len=4096 halves
  cfg = driver.TrainConfig(
      steps=args.epochs, batch_size=args.batch_size,
      learning_rate=args.learning_rate, opt_kind=args.opt_kind,
      loss_kinds=tuple(args.loss_fns),
      color_spaces=tuple(args.color_spaces), tone_map=args.tone_map,
      gamma_correct=(2.2 if args.gamma_correct
                     else args.gamma_correct_loss),
      reg_coeffs={
          "latent_l2": args.latent_l2_weight,
          "eikonal": args.eikonal_weight,
          "surface_eikonal": args.surface_eikonal,
          "delta_x": args.dp_weight,
          "offset": args.offset_decay,
          "rigidity_sparsity": args.rigidity_sparsity,
          "tv_sigma": args.tv_sigma,
          "tv_refl": args.tv_refl,
          "tv_bezier": args.tv_bezier,
          "tv_rigidity": args.tv_rigidity,
          "weight_sparsity": args.weight_sparsity,
          "volsdf_scale": args.volsdf_scale_decay,
          "occ_decay": args.occ_decay_weight,
          "smooth_normals": args.smooth_normals_weight,
          "smooth_surface": args.smooth_surface_weight,
          "smooth_occ": args.smooth_occ_weight,
          "view_variance": args.view_variance_weight,
          "eikonal_random": args.eikonal_random_weight,
          "dyn_divergence": args.dyn_divergence_weight,
          "ffjord_div": args.ffjord_div_decay,
          "spline_length": (args.spline_length_weight
                            + args.random_spline_len_decay
                            + args.voxel_random_spline_len_decay),
          "spline_pt0": args.spline_pt0_weight,
      },
      grad_clip=args.clip_gradients, accum_steps=args.opt_step,
      no_sched=args.no_sched, sched_min=args.sched_min, seed=args.seed,
      valid_freq=args.valid_freq, save_freq=args.save_freq,
      versioned_save=args.versioned_save,
      save_path=args.save or os.path.join(args.outdir, "model.ckpt"),
      duration_sec=args.duration_sec,
      train_only=cli._train_only_substrings(args.train_parts),
      profile_dir=args.profile_dir, save_load_opt=args.save_load_opt,
      alt_train=args.alt_train, inc_fourier_freqs=args.inc_fourier_freqs,
      crop_size=args.crop_size, style_img=args.style_img,
      style_weight=args.style_img_weight,
      model_parallel=args.model_parallel,
      weight_decay=args.decay, serial_idxs=args.serial_idxs,
      end_bias=args.higher_end_chance, omit_bg=args.omit_bg,
      skip_loss=args.skip_loss,
      freeze_substr="canonical" if args.fix_canon else None,
      smooth_eps=args.smooth_eps, smooth_eps_rng=args.smooth_eps_rng,
      smooth_ords=tuple(args.smooth_n_ord),
      volsdf_alternate=args.volsdf_alternate, no_fused=args.no_fused)
  driver.check_config(cfg, "dynamic" if dynamic else args.model)
  return cfg


def zero_flags(args):
  """The root runner's flag zeroing (runner.py:672-701): a regularizer
  weight that the model cannot carry is set to 0 with a warning (the
  occlusion terms always: the port has no occlusion, ROADMAP Queue 1
  #13)."""
  def zero(flag, why):
    if getattr(args, flag) > 0:
      print(f"[warn]: zeroing --{flag.replace('_', '-')}: {why}")
      setattr(args, flag, 0.0)

  if args.model != "volsdf":
    zero("volsdf_scale_decay", "model is not volsdf")
  if args.model not in ("volsdf", "sdf"):
    for flag in ("eikonal_weight", "eikonal_random_weight",
                 "surface_eikonal", "smooth_surface_weight"):
      zero(flag, "model has no SDF")
  if args.occ_kind not in ("all-learned", "joint-all-const"):
    zero("smooth_occ_weight", "occlusion is not (all-)learned")
    zero("occ_decay_weight", "occlusion is not all-learned")
  if args.dyn_model is None:
    for flag in ("dp_weight", "dyn_divergence_weight", "ffjord_div_decay",
                 "offset_decay", "rigidity_sparsity",
                 "spline_length_weight", "spline_pt0_weight",
                 "random_spline_len_decay", "voxel_random_spline_len_decay"):
      zero(flag, "model is not dynamic")
  if args.model != "voxel" and args.dyn_model != "voxel":
    for flag in ("tv_sigma", "tv_refl", "tv_bezier", "tv_rigidity"):
      zero(flag, "model is not voxel")
  if args.refl_kind == "pos" and args.view_variance_weight > 0:
    zero("view_variance_weight", "positional refl does not use view")


def _slice_views(ds, n: int):
  """--train-imgs: keep the first n views."""
  if n <= 0 or n >= ds.num_views:
    return ds
  cam = ds.camera
  return sampler.RayDataset(
      pixels=ds.pixels[:n],
      camera=type(cam)(cam.cam_to_world[:n], cam.focal), size=ds.size,
      times=None if ds.times is None else ds.times[:n])


def main(argv=None, device="cuda"):
  """Run the train + eval flow on `device` (the GPU by default; tests pass
  device="cpu"). Raises when the device is CUDA and none is present.
  Returns {"train", "test": driver.test results} plus, after training,
  "engaged_path" and "history"."""
  argv = list(sys.argv[1:] if argv is None else argv)
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("CUDA is not available; the port's runner needs a GPU")
  args = cli.arguments(argv)
  _check_supported(args)
  for vis in args.visualize:
    setattr(args, _VISUALIZE[vis], True)
  if args.nosave:
    args.save_freq = 0
  if not args.derive_kind and args.data_kind is None:
    raise ValueError("--data-kind is required when --derive-kind is unset")
  if args.timed_outdir:
    args.outdir = f"{args.outdir}-{time.strftime('%Y-%m-%d-%H%M%S')}"
  os.makedirs(args.outdir, exist_ok=True)

  load_kwargs = {}
  if args.data_kind in ("synthetic", "synthetic-dyn"):
    load_kwargs["num_views"] = args.num_views
  bundle = load(args.data, data_kind=args.data_kind, training=True,
                size=args.size, device=device, **load_kwargs)
  ds = sampler.RayDataset.from_bundle(bundle, size=args.size, device=device)
  ds = _slice_views(ds, args.train_imgs)
  dynamic = ds.times is not None and args.dyn_model is not None
  zero_flags(args)
  cfg = make_train_config(args, dynamic) if args.epochs > 0 else None
  model = build_model(args, device, dynamic)

  config_dict = {**vars(args), "argv": sys.argv, "name": args.name,
                 "device": str(device),
                 "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
  with open(os.path.join(args.outdir, args.log), "w") as f:
    json.dump(config_dict, f, indent=2, default=str)

  if args.load:
    raw = checkpoints.load(args.load)
    model.load_state_dict(raw["params"])    # strict: a divergent tree raises
    print(f"[load] restored {len(raw['params'])} tensors "
          f"(step {raw.get('step', 0)})")
  else:
    driver.init_model(model, args.seed)

  results = {}
  if cfg is not None:
    t0 = time.time()

    def log_cb(m):
      print(f"step {m['step']:6d}  loss {m['loss']:.5f}  "
            f"psnr {m['psnr']:.2f}  ({time.time() - t0:.0f}s)")

    if args.long_vid_progressive_train and dynamic:
      results["history"] = driver.train_progressive(
          model, ds, cfg, segments=_progressive_segments(args, ds),
          config_dict=config_dict, callback=log_cb)
    else:
      results["history"] = driver.train(model, ds, cfg,
                                        config_dict=config_dict,
                                        callback=log_cb)
    results["engaged_path"] = driver.LAST_TRAIN_PATH
    config_dict["engaged_path"] = driver.LAST_TRAIN_PATH
    with open(os.path.join(args.outdir, args.log), "w") as f:
      json.dump(config_dict, f, indent=2, default=str)

  test_kwargs = dict(
      render_size=args.render_size or None, save_depth=args.depth_images,
      chunk=(args.test_crop_size ** 2 if args.test_crop_size else 65536),
      only_view=args.render_frame if args.render_frame >= 0 else None,
      white_bg=args.test_white_bg, with_alpha=args.with_alpha,
      extra_maps=tuple(m for m, on in (("normals", args.normals_images),
                                       ("flow", args.flow_images),
                                       ("rigidity", args.rigidity_images))
                       if on),
      depth_query_normal=args.depth_query_normal)
  if not args.notraintest:
    results["train"] = driver.test(
        model, ds, out_dir=os.path.join(args.outdir, "train"), **test_kwargs)
    print("[train]", results["train"]["summary"])
  if not args.notest:
    tb = load(args.data, data_kind=args.data_kind, training=False,
              size=args.size, device=device, **load_kwargs)
    tds = sampler.RayDataset.from_bundle(tb, size=args.size, device=device)
    results["test"] = driver.test(
        model, tds, out_dir=os.path.join(args.outdir, "test"), **test_kwargs)
    print("[test]", results["test"]["summary"])
  if args.cluster_movement > 0 and dynamic:
    save_movement_clusters(model, ds, args.cluster_movement,
                           os.path.join(args.outdir, "clusters.png"))
  if args.render_over_time >= 0 and dynamic:
    _render_over_time(model, ds, args)
  return results


def _progressive_segments(args, ds) -> int:
  """--long-vid-progressive-train N's chunk count: N, or bare the
  --long-vid-segments, or the loaded span over --long-vid-chunk-len-sec
  (runner.py:921-931)."""
  segments = (args.long_vid_progressive_train
              if args.long_vid_progressive_train > 0
              else args.long_vid_segments)
  if args.long_vid_chunk_len_sec:
    span = ((args.end_sec - args.start_sec) if args.end_sec
            else ds.num_views / 30.0)
    segments = max(1, round(span / args.long_vid_chunk_len_sec))
    print(f"[video] {segments} progressive chunks of "
          f"{args.long_vid_chunk_len_sec}s")
  return segments


def _render_over_time(model, ds, args):
  """--render-over-time V: V's camera over t in [0, end] as
  over_time_###.png, and with --render-bezier-keyframes and --spline S > 1
  S frames at the control points' times as keyframe_##.png
  (runner.py:1008-1030)."""
  frames = driver.render_over_time(model, ds, view=args.render_over_time,
                                   frames=args.render_frames,
                                   end_sec=args.render_over_time_end_sec)
  for i, frame in enumerate(frames):
    driver.write_png(os.path.join(args.outdir, f"over_time_{i:03d}.png"),
                     driver.to_u8(frame[..., :3]))
  print(f"[time] wrote {len(frames)} frames over time")
  if args.render_bezier_keyframes and args.spline > 1:
    kf = driver.render_over_time(model, ds, view=args.render_over_time,
                                 frames=args.spline)
    for i, frame in enumerate(kf):
      driver.write_png(os.path.join(args.outdir, f"keyframe_{i:02d}.png"),
                       driver.to_u8(frame[..., :3]))
    print(f"[time] wrote {args.spline} keyframes")


def save_movement_clusters(model, ds, k: int, out_path: str):
  """--cluster-movement K: K-means (10 Lloyd steps from numpy's
  RandomState(0)) of view 0's weight-integrated flow at t = 0.5 and at
  up to 64×64, each pixel in its cluster's tab10 colour
  (runner.py:1032-1053)."""
  flow = driver.render_view(model, ds, 0, min(ds.size, 64), mode="flow",
                            time_val=0.5)                   # [S, S, 3]
  pts = flow.reshape(-1, 3)
  rng = np.random.RandomState(0)
  centers = pts[rng.choice(len(pts), k, replace=False)]
  for _ in range(10):
    assign = np.linalg.norm(pts[:, None] - centers[None], axis=-1).argmin(-1)
    for c in range(k):
      sel = pts[assign == c]
      if len(sel):
        centers[c] = sel.mean(0)
  img = TAB10[assign.reshape(flow.shape[:2]) % 10]
  driver.write_png(out_path, (img * 255).astype(np.uint8))
  print(f"[clusters] wrote {out_path}")


if __name__ == "__main__":
  main()
