"""The port's entry point: `python -m nerf_atlas_tpu_torch.runner ...`.

Takes the root `runner.py`'s flags (through the port's own copy of its
parser, `cli.py`) and runs the flow of its `main`: load the data, build
the model, initialize it from `--seed` or restore `--load`, train for
`--epochs` steps (through the one-kernel step where the gate allows,
log.json records the engaged path), then render and score the train and
test splits (results.txt, test_###.png). The loss plot (loss.png) is not written: it
needs matplotlib, which the GPU machine lacks.

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
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic-dyn \
      --model plain --enc-kind cp --dyn-model plain [--spline 4 \
      --dp-weight 1e-3] --size 48 --num-views 30 --epochs 1500 \
      --batch-size 4096 -lr 1e-3 --outdir out
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from . import cli
from .data import load, sampler
from .models import load_dyn_model, load_model
from .train import checkpoints, driver

# flags the port does not carry yet: (attribute, ROADMAP item)
_UNSUPPORTED = (
    ("bendy", "Queue 1 #13"),
    ("ref_compat", "Queue 1 #13"), ("neural_upsample", "Queue 1 #13"),
    ("with_canon", "Queue 1 #11"), ("light_kind", "Queue 1 #13"),
    ("replace", "Queue 1 #13"), ("cam_save_load", "Queue 1 #13"),
    ("msssim_loss", "Queue 1 #5"), ("normals_images", "Queue 1 #10"),
    ("flow_images", "Queue 1 #11"), ("rigidity_images", "Queue 1 #11"),
    ("visualize", "Queue 1 #10/#11"), ("exp_bg", "Queue 1 #13"),
    ("draw_colormap", "Queue 1 #13"), ("normals_from_depth", "Queue 1 #13"),
    ("depth_query_normal", "Queue 1 #10"),
    ("long_vid_progressive_train", "Queue 1 #11"),
    ("render_bezier_keyframes", "Queue 1 #11"),
)


def _check_supported(args):
  for flag, item in _UNSUPPORTED:
    if getattr(args, flag):
      raise NotImplementedError(
          f"--{flag.replace('_', '-')}: not ported yet (ROADMAP {item})")
  if args.model not in ("tiny", "plain", "ae", "coarse_fine", "volsdf"):
    raise NotImplementedError(
        f"--model {args.model}: the port has TinyNeRF, PlainNeRF, NeRFAE, "
        "CoarseFineNeRF and VolSDF so far (ROADMAP Queue 1 #10 sdf, #13 the "
        "rest)")
  if args.dyn_model not in (None, "plain"):
    raise NotImplementedError(
        f"--dyn-model {args.dyn_model}: the port has DynamicNeRF ('plain') "
        "so far (ROADMAP Queue 1 #11)")
  if args.dyn_refl_latent:
    raise NotImplementedError(
        "--dyn-refl-latent: the per-time refl latent arrives with ROADMAP "
        "Queue 1 #11")


def _check_dynamic(args):
  """The options that act on a dynamic run only (runner.py:1004-1025)."""
  for flag, on in (("render_over_time", args.render_over_time >= 0),
                   ("cluster_movement", args.cluster_movement > 0)):
    if on:
      raise NotImplementedError(
          f"--{flag.replace('_', '-')}: not ported yet (ROADMAP Queue 1 #11)")


def build_model(args, device, dynamic: bool = False):
  """runner.py:build_model for --model tiny, plain, ae, coarse_fine and
  volsdf, and on timed data (`dynamic`) with --dyn-model plain a DynamicNeRF
  over the plain canonical (--spline, --refl-kind, --enc-kind,
  --dyn-refl-latent; runner.py:562-576; another canonical raises, ROADMAP
  Queue 1 #11); as in the root runner, --dyn-model on static data builds the
  static model. tiny takes the common kwargs only (runner.py:449-456). plain
  also takes --refl-kind, --mip, --enc-kind and --space-kind
  (runner.py:458-466); --hash-table-log2 N sets the hash table to 2^N
  entries per level when N is not the default 19 (runner.py:470-471).
  coarse_fine takes --refl-kind, --mip and --enc-kind (cp by default, not
  the class's hash; runner.py:459-467), and as in the root runner neither
  --space-kind nor --hash-table-log2. ae takes --refl-kind, --encoding-size
  and --normalize-latent (runner.py:483-486); like the root runner it
  ignores --mip, --enc-kind and --space-kind. volsdf takes --sdf-kind,
  --refl-kind, --sphere-init / --no-sphere-init, --occ-kind and
  --integrator-kind (which the port's VolSDF refuses, ROADMAP Queue 1 #13),
  and computes normals when --sdf-eikonal or --surface-eikonal is set, so
  that the eikonal reads them (runner.py:503-531)."""
  kwargs = dict(steps=args.steps, t_near=args.near, t_far=args.far,
                sky_kind=args.sky_kind, sigmoid_kind=args.sigmoid_kind,
                intermediate_size=args.intermediate_size,
                lindisp=args.lindisp, per_ray_jitter=args.per_ray_jitter,
                density_noise=args.density_noise)
  if dynamic and args.dyn_model is not None:
    if args.model != "plain":
      raise NotImplementedError(
          f"--dyn-model {args.dyn_model} over --model {args.model}: the "
          "port's dynamic wrapper takes the plain canonical so far (ROADMAP "
          "Queue 1 #11)")
    return load_dyn_model(
        args.dyn_model, device=device, canonical_kind="plain",
        spline_points=args.spline,
        canonical_kwargs={"refl_kind": args.refl_kind,
                          "enc_kind": args.enc_kind},
        time_latent_size=args.dyn_refl_latent, **kwargs)
  if args.model == "tiny":
    return load_model("tiny", device=device, **kwargs)
  kwargs["refl_kind"] = args.refl_kind
  if args.model == "volsdf":
    kwargs.update(sdf_kind=args.sdf_kind, occ_kind=args.occ_kind,
                  integrator_kind=args.integrator_kind,
                  with_normals=(args.eikonal_weight > 0
                                or args.surface_eikonal > 0),
                  sdf_kwargs={"sphere_init": args.sphere_init})
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
  (`dynamic`: the model is a DynamicNeRF, whose --dp-weight is carried).
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
  if dynamic:
    _check_dynamic(args)
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
      white_bg=args.test_white_bg, with_alpha=args.with_alpha)
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
  return results


if __name__ == "__main__":
  main()
