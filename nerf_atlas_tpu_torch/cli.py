"""The port's command-line flags: its own copy of the root `runner.py`'s
`arguments()` (the same flag set, names, defaults and choices) and
`_train_only_substrings`.

The port keeps this copy so that it imports nothing of the JAX package's
entry point. `tests/test_torch_cli.py` holds the two parsers' namespaces
equal over the recipes the repo uses. `--param-file` raises: its loader
lives in the JAX package (ROADMAP Queue 1 #13).
"""
from __future__ import annotations

import argparse


def arguments(argv=None):
  a = argparse.ArgumentParser(description="nerf_atlas on PyTorch/CUDA")
  a.add_argument("-d", "--data", default="", help="path to data")
  a.add_argument("--data-kind", default=None,
                 choices=[None, "original", "dnerf", "dtu", "nerv_point",
                          "shiny", "single_video", "pixel-single", "synthetic",
                          "synthetic-dyn", "synthetic-lit", "synthetic-ff"],
                 help="dataset loader (default: derived from path)")
  a.add_argument("--derive-kind", action="store_false",
                 help="allow deriving the data kind from the path "
                      "(pass to require an explicit --data-kind)")
  a.add_argument("--size", type=int, default=64, help="training image size")
  a.add_argument("--train-imgs", type=int, default=-1,
                 help="limit the number of training views")
  a.add_argument("--outdir", default="outputs")
  a.add_argument("--timed-outdir", action="store_true",
                 help="append date+time of the run to --outdir")
  a.add_argument("--name", default="",
                 help="display name recorded in the log file")

  # model
  a.add_argument("--model", default="plain",
                 choices=["tiny", "plain", "ae", "coarse_fine", "volsdf",
                          "sdf", "voxel", "mpi", "rig", "spline", "hist",
                          "bendy", "recurrent", "pixel-single"])
  a.add_argument("--bendy", action="store_true",
                 help="curved rays through a learned IOR field "
                      "(shorthand for --model bendy)")
  a.add_argument("--dyn-model", default=None,
                 choices=[None, "plain", "ae", "long", "rig", "voxel"])
  a.add_argument("--with-canon", default=None,
                 help="checkpoint to preload as the canonical model of a "
                      "dynamic wrapper")
  a.add_argument("--fix-canon", action="store_true",
                 help="freeze the canonical model while training the warp")
  a.add_argument("--dyn-refl-latent", type=int, default=0,
                 help="latent size passed from the deformation to the "
                      "canonical reflectance")
  a.add_argument("--steps", type=int, default=64, help="samples per ray")
  a.add_argument("--near", type=float, default=2.0)
  a.add_argument("--far", type=float, default=6.0)
  a.add_argument("--lindisp", action="store_true",
                 help="sample linearly in disparity instead of depth")
  a.add_argument("--per-ray-jitter", action="store_true",
                 help="independent per-ray stratified sample jitter")
  a.add_argument("--mip", default=None, choices=[None, "cone", "cylinder"])
  a.add_argument("--enc-kind", default="cp",
                 choices=["cp", "hash", "posenc", "ref-hash"],
                 help="plain-NeRF spatial encoder (cp = factorized volume; "
                      "hash = the NGP hash grid; both take the fused "
                      "kernels; ref-hash = the reference's exact hash "
                      "grid incl. its descending-resolution schedule "
                      "bug, for parity diagnosis)")
  a.add_argument("--hash-table-log2", type=int, default=19,
                 help="hash-grid entries per level = 2^N (19 = the "
                      "reference default; the hash kernels take any N)")
  a.add_argument("--sigmoid-kind", default="thin")
  a.add_argument("--bg", "--sky-kind", dest="sky_kind", default="black",
                 choices=["black", "white", "random", "mlp"])
  a.add_argument("--intermediate-size", "--shape-to-refl-size",
                 dest="intermediate_size", type=int, default=32,
                 help="feature width passed from density to reflectance")
  a.add_argument("--encoding-size", type=int, default=32,
                 help="latent size of the auto-encoded NeRF (--model ae)")
  a.add_argument("--normalize-latent", action="store_true",
                 help="L2-normalize the AE latent")
  a.add_argument("--rig-points", type=int, default=32,
                 help="number of rig points (--model rig)")
  a.add_argument("--density-noise", type=float, default=0.0)
  a.add_argument("--voxel-resolution", type=int, default=64)
  a.add_argument("--spline", type=int, default=0,
                 help="spline control points for dynamic models (0=direct)")
  a.add_argument("--long-vid-segments", type=int, default=4)
  a.add_argument("--long-vid-progressive-train", type=int, nargs="?",
                 const=-1, default=0,
                 help="train time chunks sequentially; the optional int "
                      "is the chunk count (reference runner.py:322-325), "
                      "bare flag defers to --long-vid-segments/"
                      "--long-vid-chunk-len-sec")
  a.add_argument("--neural-upsample", action="store_true",
                 help="render low-res and neurally upsample")
  a.add_argument("--upsample-low-res", type=int, default=16)

  # reflectance / shading
  a.add_argument("--refl-kind", default="view",
                 choices=["pos", "view", "view-light", "pos-linear-view",
                          "basic", "diffuse", "cook-torrance", "rusin",
                          "rusin-helmholtz", "sph-har", "fourier",
                          "weighted", "alternating"])
  a.add_argument("--weighted-subrefl-kinds", nargs="+",
                 default=["diffuse", "rusin"],
                 help="sub-BRDFs for --refl-kind weighted")
  a.add_argument("--space-kind", default="identity",
                 choices=["identity", "surface", "none"])
  a.add_argument("--refl-order", type=int, default=2,
                 help="order for spherical-harmonic & Fourier-basis BRDFs")
  a.add_argument("--refl-bidirectional", action="store_true",
                 help="allow flipped normals in the diffuse BRDF")
  a.add_argument("--normal-kind", default="raw",
                 choices=["none", "elaz", "raw"],
                 help="how normals enter the 'basic' reflectance")
  a.add_argument("--feature-space", type=int, default=3,
                 help="reflectance output feature size (neural upsampling "
                      "renders features instead of RGB)")
  a.add_argument("--light-kind", default=None,
                 choices=[None, "point", "field", "dataset"])
  a.add_argument("--light-intensity", type=float, default=100.0,
                 help="intensity of dataset/point lights")
  a.add_argument("--point-light-position", type=float, nargs="+",
                 default=[0.0, 0.0, -3.0],
                 help="world position for --light-kind point (default: "
                      "collocate with each view's camera)")
  a.add_argument("--has-multi-light", action="store_true",
                 help="nerv_point: also evaluate the multi-point-light "
                      "test split")
  a.add_argument("--occ-kind", default=None,
                 choices=[None, "hard", "learned", "learned-const",
                          "all-learned", "joint-all-const"])
  a.add_argument("--all-learned-occ-kind", default="pos",
                 choices=["pos", "pos-elaz"],
                 help="inputs of the all-learned occlusion MLP")
  a.add_argument("--integrator-kind", default=None,
                 choices=[None, "direct", "path"])

  # checkpoint surgery / conversions (reference set_per_run,
  # runner.py:1041-1170)
  a.add_argument("--volsdf-direct-to-path", action="store_true",
                 help="convert a loaded direct-integration VolSDF to the "
                      "one-bounce path integrator")
  a.add_argument("--volsdf-alternate", action="store_true",
                 help="alternate volume/surface supervision for VolSDF "
                      "(sets --alt-train cadence on the sdf/volume halves)")
  a.add_argument("--all-learned-to-joint", action="store_true",
                 help="convert a loaded all-learned occlusion into the "
                      "joint learned+raycast-const kind")
  a.add_argument("--convert-analytic-to-alt", action="store_true",
                 help="wrap a loaded analytic (diffuse) BRDF into the "
                      "alternating analytic/learned optimization")
  a.add_argument("--autogamma-correct-loss", action="store_true",
                 help="infer the loss gamma from the dataset mean "
                      "luminance (imagick autogamma rule)")

  # sdf
  a.add_argument("--sdf-kind", default="mlp",
                 choices=["mlp", "siren", "curl-mlp", "local", "spheres",
                          "triangles"])
  a.add_argument("--bound-sphere-rad", type=float, default=-1,
                 help=">0 bounds the SDF by a sphere of this radius")
  a.add_argument("--isect-kind", "--sdf-isect-kind", dest="isect_kind",
                 default="bisect", choices=["bisect", "secant", "sphere"])
  a.add_argument("--sphere-init", dest="sphere_init", action="store_true",
                 default=True,
                 help="initialize the SDF to a unit sphere (analytic "
                      "bias; on by default)")
  a.add_argument("--no-sphere-init", dest="sphere_init",
                 action="store_false")

  # optimization
  a.add_argument("--epochs", type=int, default=1000,
                 help="training steps (ray batches)")
  a.add_argument("--batch-size", type=int, default=4096,
                 help="rays per step")
  a.add_argument("-lr", "--learning-rate", type=float, default=5e-4)
  a.add_argument("--opt-kind", default="adam",
                 choices=["adam", "adamw", "sgd", "rmsprop", "uniform_adam"])
  a.add_argument("--loss-fns", nargs="+", default=["l2"],
                 choices=["l2", "l1", "rmse", "fft", "ssim"])
  a.add_argument("--crop-size", type=int, default=0,
                 help="train on [V,c,c] image crops instead of flat ray "
                      "batches (auto-enabled for ssim/fft/style losses)")
  a.add_argument("--style-img", default=None,
                 help="style-transfer target image (enables style loss)")
  a.add_argument("--style-img-weight", type=float, default=1e-2)
  a.add_argument("--color-spaces", nargs="+", default=["rgb"],
                 choices=["rgb", "hsv", "luminance", "xyz"])
  a.add_argument("--tone-map", action="store_true")
  a.add_argument("--gamma-correct", action="store_true",
                 help="gamma-correct the loss at 2.2 (shorthand for "
                      "--gamma-correct-loss 2.2)")
  a.add_argument("--gamma-correct-loss", type=float, default=1.0,
                 help="gamma correct the training loss by this exponent")
  a.add_argument("--decay", type=float, default=0.0,
                 help="optimizer weight decay")
  a.add_argument("--no-sched", action="store_true")
  a.add_argument("--sched-min", type=float, default=5e-5)
  a.add_argument("--clip-gradients", type=float, default=0.0)
  a.add_argument("--opt-step", type=int, default=1,
                 help="gradient accumulation steps")
  a.add_argument("--seed", type=int, default=1337)
  a.add_argument("--duration-sec", type=float, default=0.0)
  a.add_argument("--inc-fourier-freqs", action="store_true",
                 help="grow Fourier encoder frequencies during training")
  a.add_argument("--time-gamma", action="store_true",
                 help="apply the time-conditioned image gamma exp(2t-1) "
                      "(dnerf loader; reference src/loaders.py:148)")
  a.add_argument("--serial-idxs", action="store_true",
                 help="train on views in serial (view = step %% N)")
  a.add_argument("--higher-end-chance", type=int, default=0,
                 help="extra draws of the first/last view per batch "
                      "(dynamic scenes: anchor the endpoints)")
  a.add_argument("--omit-bg", action="store_true",
                 help="skip mostly-background batches with some "
                      "probability (focus on the subject)")
  a.add_argument("--skip-loss", type=int, default=0,
                 help="suppress loss reporting for the first N steps")
  a.add_argument("--torchjit", action="store_true",
                 help="no-op (flag kept for reference recipe "
                      "compatibility)")
  a.add_argument("--debug-nans", action="store_true",
                 help="trap the first NaN at its producing op (SURVEY "
                      "§5 sanitizer)")
  a.add_argument("--data-parallel", action="store_true",
                 help="no-op unless --mesh-devices 1 was set: ray batches "
                      "data-parallel over the device mesh by default")
  a.add_argument("--no-fused", action="store_true",
                 help="force the plain (module under autograd) train "
                      "path even where a fused kernel would auto-engage "
                      "(A/B switch for kernel-vs-recipe attribution); "
                      "the engaged path is "
                      "recorded in log.json either way")

  # regularizers (reference flag names kept as aliases of the -weight
  # spellings introduced in round 1)
  a.add_argument("--latent-l2-weight", type=float, default=0.0)
  a.add_argument("--eikonal-weight", "--sdf-eikonal", dest="eikonal_weight",
                 type=float, default=0.0)
  a.add_argument("--surface-eikonal", type=float, default=0.0,
                 help="eikonal on surface-intersection points")
  a.add_argument("--dp-weight", "--delta-x-decay", dest="dp_weight",
                 type=float, default=0.0,
                 help="delta-x deformation magnitude reg")
  a.add_argument("--offset-decay", type=float, default=0.0,
                 help="NR-NeRF offset loss weight")
  a.add_argument("--rigidity-sparsity", type=float, default=0.0)
  a.add_argument("--tv-sigma", "--voxel-tv-sigma", dest="tv_sigma",
                 type=float, default=0.0)
  a.add_argument("--tv-refl", "--voxel-tv-rgb", dest="tv_refl",
                 type=float, default=0.0)
  a.add_argument("--tv-bezier", "--voxel-tv-bezier", dest="tv_bezier",
                 type=float, default=0.0)
  a.add_argument("--tv-rigidity", "--voxel-tv-rigidity",
                 dest="tv_rigidity", type=float, default=0.0)
  a.add_argument("--weight-sparsity", type=float, default=0.0)
  a.add_argument("--volsdf-scale-decay", type=float, default=0.0)
  a.add_argument("--occ-decay-weight", "--decay-all-learned-occ",
                 dest="occ_decay_weight", type=float, default=0.0,
                 help="decay learned occlusion toward visible")
  a.add_argument("--smooth-normals-weight", "--smooth-normals",
                 dest="smooth_normals_weight", type=float, default=0.0)
  a.add_argument("--smooth-surface-weight", "--smooth-surface",
                 dest="smooth_surface_weight", type=float, default=0.0)
  a.add_argument("--smooth-occ-weight", "--smooth-occ",
                 dest="smooth_occ_weight", type=float, default=0.0)
  a.add_argument("--smooth-eps", type=float, default=1e-3,
                 help="perturbation radius for the smoothness regs")
  a.add_argument("--smooth-eps-rng", action="store_true",
                 help="random perturbation radius instead of fixed")
  a.add_argument("--smooth-n-ord", nargs="+", type=int, default=[2],
                 choices=[1, 2],
                 help="vector norm order(s) for normal smoothing")
  a.add_argument("--view-variance-weight", "--view-variance-decay",
                 dest="view_variance_weight", type=float, default=0.0)
  a.add_argument("--eikonal-random-weight", type=float, default=0.0,
                 help="eikonal on uniform random points")
  a.add_argument("--dyn-divergence-weight", "--dyn-diverge-decay",
                 dest="dyn_divergence_weight", type=float, default=0.0,
                 help="divergence of the deformation field")
  a.add_argument("--ffjord-div-decay", type=float, default=0.0,
                 help="FFJORD stochastic divergence of the deformation "
                      "field, ramped in over training")
  a.add_argument("--spline-length-weight", "--spline-len-decay",
                 dest="spline_length_weight", type=float, default=0.0)
  a.add_argument("--spline-pt0-weight", "--spline-pt0-decay",
                 dest="spline_pt0_weight", type=float, default=0.0)
  a.add_argument("--random-spline-len-decay", type=float, default=0.0,
                 help="spline length on randomly sampled points")
  a.add_argument("--voxel-random-spline-len-decay", type=float,
                 default=0.0,
                 help="spline length on random voxel-grid chunks")

  # reporting / io
  a.add_argument("--valid-freq", type=int, default=500)
  a.add_argument("--save-freq", type=int, default=1000)
  a.add_argument("--versioned-save", action="store_true")
  a.add_argument("--nosave", action="store_true", help="do not checkpoint")
  a.add_argument("--log", default="log.json",
                 help="file name for the resolved-config dump")
  a.add_argument("--load", default=None, help="checkpoint to restore/graft")
  a.add_argument("--ref-compat", action="store_true",
                 help="build the model at the PyTorch reference's native "
                      "architecture dims so checkpoints imported by "
                      "scripts/import_reference_ckpt.py graft exactly")
  a.add_argument("--save-load-opt", action="store_true",
                 help="checkpoint and restore optimizer state too")
  a.add_argument("--cam-save-load", default=None,
                 help="path to save/restore the (trainable) camera")
  a.add_argument("--alt-train", type=int, default=0,
                 help=">0: toggle analytic/learned refl halves every N "
                      "steps (alternating reflectance)")
  a.add_argument("--replace", nargs="+", default=[],
                 help="submodule names to re-init on load (surgery), e.g. "
                      "refl sky_mlp occ")
  a.add_argument("--save", default=None, help="checkpoint path")
  a.add_argument("--notest", action="store_true")
  a.add_argument("--notraintest", action="store_true")
  a.add_argument("--test-crop-size", type=int, default=0,
                 help="eval render chunk (0 = whole image)")
  a.add_argument("--render-size", type=int, default=0,
                 help="eval render resolution (0 = dataset size)")
  a.add_argument("--depth-images", action="store_true",
                 help="save normalized depth maps at test time")
  a.add_argument("--normals-images", action="store_true",
                 help="save integrated normal maps at test time")
  a.add_argument("--flow-images", "--flow-map", dest="flow_images",
                 action="store_true",
                 help="save deformation magnitude maps (dynamic models)")
  a.add_argument("--rigidity-images", "--rigidity-map",
                 dest="rigidity_images", action="store_true",
                 help="save rigidity maps (dynamic models)")
  a.add_argument("--visualize", nargs="*", default=[],
                 choices=["depth", "normals", "flow", "rigidity"],
                 help="shorthand list form of the *-images flags")
  a.add_argument("--normals-from-depth", action="store_true",
                 help="extra normal maps from depth finite differences")
  a.add_argument("--depth-query-normal", action="store_true",
                 help="extra normal maps by querying SDF normals at the "
                      "termination depth")
  a.add_argument("--draw-colormap", action="store_true",
                 help="colormap the depth/extra maps")
  a.add_argument("--plt-cmap-kind", default="magma",
                 help="matplotlib colormap for --draw-colormap")
  a.add_argument("--with-alpha", action="store_true",
                 help="save test renders as RGBA (alpha = opacity)")
  a.add_argument("--test-white-bg", action="store_true",
                 help="composite masked references over white at test")
  a.add_argument("--exp-bg", action="store_true",
                 help="multiply saved test images by the label mask "
                      "(visualization only)")
  a.add_argument("--render-frame", type=int, default=-1,
                 help=">=0: test only this view")
  a.add_argument("--cluster-movement", type=int, default=0,
                 help=">0: save a k-means clustering of the deformation "
                      "field (dynamic models)")
  a.add_argument("--display-regularization", action="store_true",
                 help="print the regularization component of the loss")
  a.add_argument("--display-smoothness", action="store_true",
                 help="print smoothness regularizer values (alias of "
                      "--display-regularization: both show loss - mse)")
  a.add_argument("--y-scale", default="log",
                 choices=["linear", "log", "symlog", "logit"],
                 help="y scale of the loss plot")
  a.add_argument("--msssim-loss", action="store_true",
                 help="also report MS-SSIM at test time")
  a.add_argument("--render-over-time", type=int, default=-1,
                 help=">=0: render this view over swept time")
  a.add_argument("--render-frames", "--render-over-time-steps",
                 dest="render_frames", type=int, default=24)
  a.add_argument("--render-over-time-end-sec", type=float, default=1.0,
                 help="end of the swept time range")
  a.add_argument("--render-bezier-keyframes", action="store_true",
                 help="also render the spline keyframe times")
  a.add_argument("--num-views", type=int, default=8,
                 help="views for procedural synthetic data")

  # video
  a.add_argument("--start-sec", type=float, default=0.0,
                 help="start load time of a video dataset")
  a.add_argument("--end-sec", type=float, default=None,
                 help="end load time of a video dataset")
  a.add_argument("--long-vid-chunk-len-sec", type=float, default=None,
                 help="chunk length in seconds for progressive long-video "
                      "training (overrides --long-vid-segments)")
  a.add_argument("--static-vid-cam-angle-deg", type=float, default=40.0,
                 help="FOV for the static video camera")

  # parallelism
  a.add_argument("--mesh-devices", type=int, default=0,
                 help="devices in the data mesh (0 = all)")
  a.add_argument("--model-parallel", type=int, default=1,
                 help=">1: 2-D (data × model) mesh; large parameter "
                      "tensors (voxel grids, hash tables) shard over the "
                      "model axis (device_count must divide evenly)")

  # meta
  a.add_argument("--param-file", default=None,
                 help="JSON hyper-parameter file (overrides defaults)")
  a.add_argument("--train-parts", nargs="+", default=["all"],
                 choices=["all", "camera", "refl", "occ", "path-tf"],
                 help="which parameter groups to optimize (reference "
                      "runner.py:94-97; path-tf selects the refl group — "
                      "in this design the one-bounce transfer folds "
                      "through the BRDF itself, models/volsdf.py)")
  a.add_argument("--profile-dir", default=None,
                 help="capture a profiler trace of the train loop")
  a.add_argument("--loss-window", type=int, default=50,
                 help="smoothing window for the loss plot")
  args = a.parse_args(argv)
  if args.param_file:
    raise NotImplementedError(
        "--param-file: the hyper-parameter loader lives in the JAX package "
        "(ROADMAP Queue 1 #13)")
  return args


def _train_only_substrings(train_parts):
  """--train-parts → param-path substrings whose grads stay live
  (reference runner.py:1266-1280). "all" disables masking; "camera" is
  handled separately (train_camera); "path-tf" maps to the refl group
  because the one-bounce transfer folds through the BRDF itself
  (models/volsdf.py:_one_bounce)."""
  if "all" in train_parts:
    return None
  keys = tuple(sorted({
      {"refl": "refl", "occ": "occ", "path-tf": "refl"}[p]
      for p in train_parts if p not in ("camera",)}))
  return keys or None
