"""The port's entry point: `python -m nerf_atlas_tpu_torch.runner ...`.

Takes the root `runner.py`'s flags (its `arguments`, pure argparse) and
runs the eval-only flow of its `main`: load the data, build the model,
initialize it from `--seed` or restore `--load`, then render and score
the train and test splits (results.txt, test_###.png). Training
(`--epochs > 0`) arrives with the backward kernels K2/K3.

Example (procedural scene, random weights):
  python -m nerf_atlas_tpu_torch.runner --data-kind synthetic \
      --model plain --size 800 --num-views 2 --epochs 0 --outdir out
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from .data import load, sampler
from .models import load_model
from .train import checkpoints, driver

# flags the eval path does not carry yet: (attribute, ROADMAP item)
_UNSUPPORTED = (
    ("bendy", "Queue 1 #13"), ("dyn_model", "Queue 1 #11"),
    ("ref_compat", "Queue 1 #13"), ("neural_upsample", "Queue 1 #13"),
    ("with_canon", "Queue 1 #11"), ("light_kind", "Queue 1 #13"),
    ("replace", "Queue 1 #13"), ("cam_save_load", "Queue 1 #13"),
    ("msssim_loss", "Queue 1 #5"), ("normals_images", "Queue 1 #10"),
    ("flow_images", "Queue 1 #11"), ("rigidity_images", "Queue 1 #11"),
    ("visualize", "Queue 1 #10/#11"), ("exp_bg", "Queue 1 #13"),
    ("draw_colormap", "Queue 1 #13"), ("normals_from_depth", "Queue 1 #13"),
    ("depth_query_normal", "Queue 1 #10"),
)


def _check_supported(args):
  if args.epochs > 0:
    raise NotImplementedError(
        "--epochs > 0: training arrives with the backward kernels K2/K3 "
        "(ROADMAP Queue 1 #5); run with --epochs 0")
  for flag, item in _UNSUPPORTED:
    if getattr(args, flag):
      raise NotImplementedError(
          f"--{flag.replace('_', '-')}: not ported yet (ROADMAP {item})")
  if args.model != "plain":
    raise NotImplementedError(
        f"--model {args.model}: the port has PlainNeRF only so far "
        "(ROADMAP Queue 1 #3, #8-#13)")


def build_model(args, device):
  """runner.py:build_model for --model plain (static data)."""
  kwargs = dict(steps=args.steps, t_near=args.near, t_far=args.far,
                sky_kind=args.sky_kind, sigmoid_kind=args.sigmoid_kind,
                intermediate_size=args.intermediate_size,
                lindisp=args.lindisp, per_ray_jitter=args.per_ray_jitter,
                refl_kind=args.refl_kind, mip=args.mip,
                enc_kind=args.enc_kind, refl_space=args.space_kind)
  return load_model(args.model, device=device, **kwargs)


def _slice_views(ds, n: int):
  """--train-imgs: keep the first n views."""
  if n <= 0 or n >= ds.num_views:
    return ds
  cam = ds.camera
  return sampler.RayDataset(
      pixels=ds.pixels[:n],
      camera=type(cam)(cam.cam_to_world[:n], cam.focal), size=ds.size)


def main(argv=None, device="cuda"):
  """Run the eval flow on `device` (the GPU by default; tests pass
  device="cpu"). Raises when the device is CUDA and none is present."""
  argv = list(sys.argv[1:] if argv is None else argv)
  if any(a == "--param-file" or a.startswith("--param-file=") for a in argv):
    raise NotImplementedError(
        "--param-file: the hyper-parameter loader lives in the JAX package "
        "(ROADMAP Queue 1 #13)")
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("CUDA is not available; the port's runner needs a GPU")
  import runner as cli   # the root runner.py: argparse + numpy only
  args = cli.arguments(argv)
  _check_supported(args)
  if not args.derive_kind and args.data_kind is None:
    raise ValueError("--data-kind is required when --derive-kind is unset")
  if args.timed_outdir:
    args.outdir = f"{args.outdir}-{time.strftime('%Y-%m-%d-%H%M%S')}"
  os.makedirs(args.outdir, exist_ok=True)

  load_kwargs = {}
  if args.data_kind == "synthetic":
    load_kwargs["num_views"] = args.num_views
  bundle = load(args.data, data_kind=args.data_kind, training=True,
                size=args.size, device=device, **load_kwargs)
  ds = sampler.RayDataset.from_bundle(bundle, size=args.size, device=device)
  ds = _slice_views(ds, args.train_imgs)
  model = build_model(args, device)

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
  model.eval()

  test_kwargs = dict(
      render_size=args.render_size or None, save_depth=args.depth_images,
      chunk=(args.test_crop_size ** 2 if args.test_crop_size else 65536),
      only_view=args.render_frame if args.render_frame >= 0 else None,
      white_bg=args.test_white_bg, with_alpha=args.with_alpha)
  results = {}
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
