#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repo root: `python3 chip_smoke.py`. Phases, each printing its
line before the next starts:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles every hand-written kernel from nerf_atlas_tpu_torch/csrc;
  3. kernel vs plain torch on the card: K1 (render_fwd) on 4096 seeded rays
     at full width, 64 steps, over sky and rgb-activation kinds;
  4. main path: the port's runner renders and scores the procedural scene
     at 800x800 (2 views, train + test split, seeded random weights) and
     must launch K1;
  5. timing: one 800x800x64 frame through render_view (kernel) and through
     the plain-torch reference, plus one 65536-ray call of each;
  6. with `--profile` only: where one frame's time goes (torch.profiler
     trace of render_view: device idle share, per-kernel shares; host-side
     set-up and per-frame costs; SM clock and power under load).
The last three lines are the kernels' JSON record, the card's name and
power limit, and the device JSON. Any failure raises (non-zero exit, no
result lines).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SIZE = 800
STEPS = 64
CHUNK = 65536                 # render_view's rays per call
N_CHECK = 4096
# kernel vs reference: both float32, summation order differs (per-thread
# FMA chains vs cuBLAS tiles); 1e-4 abs on rgb and acc in [0, 1]
TOL = 1e-4


def _sync_time(fn):
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  return out, time.perf_counter() - t0


def _event_ms(fn, reps: int) -> float:
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  fn()                                        # warm-up
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def _check_rays(n: int, seed: int) -> np.ndarray:
  """Rays from a sphere of radius 4 aimed near the origin (they cross the
  CP bounding box), from numpy's seeded generator."""
  rng = np.random.default_rng(seed)
  o = rng.normal(size=(n, 3))
  o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
  d = -o / 4.0 + rng.normal(size=(n, 3)) * 0.15
  return np.concatenate([o, d], -1).astype(np.float32)


def _mean_s(fn, reps: int = 5) -> float:
  return sum(_sync_time(fn)[1] for _ in range(reps)) / reps


def _profile(card, model, ds, ws):
  """Phase 6: one traced frame through render_view, host-side costs of
  the serving path, and the card's clock and power under load."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile

  from nerf_atlas_tpu_torch.data import loaders
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  from nerf_atlas_tpu_torch.train import driver

  frames = [_sync_time(lambda: driver.render_view(model, ds, 0))[1]
            for _ in range(2)]
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    img, wall = _sync_time(lambda: driver.render_view(model, ds, 0))
  by_name = {}
  for e in prof.events():
    if e.device_type == DeviceType.CUDA:
      n, us = by_name.get(e.name, (0, 0.0))
      by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
  busy = sum(us for _, us in by_name.values()) / 1e6
  print(f"[profile] {card}: render_view frames {frames[0]:.4f} / "
        f"{frames[1]:.4f} s untraced; traced {wall:.4f} s wall, device "
        f"busy {busy:.4f} s, idle share "
        f"{(1 - busy / wall if busy else float('nan')):.4f}", flush=True)
  for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]:
    print(f"[profile]   {us / 1e6 / busy:8.4%} of device time: {n} x "
          f"{us / n / 1e3:.3f} ms  {name[:80]}", flush=True)
  if not by_name:
    print("[profile]   no device events in the trace: per-kernel shares "
          "not measured", flush=True)

  sd = model.state_dict()
  pack_ms = 1e3 * _mean_s(lambda: k1.pack_weights(sd, ws.device))
  rays_ms = 1e3 * _mean_s(lambda: ds.view_rays(0))
  with tempfile.TemporaryDirectory() as d:
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    png_s = _mean_s(lambda: driver.write_png(os.path.join(d, "f.png"), u8), 3)
  gt_s = _sync_time(lambda: loaders.load(
      "", data_kind="synthetic", size=SIZE, num_views=2,
      device=ws.device))[1]
  print(f"[profile] host: pack_weights {pack_ms:.3f} ms, view_rays "
        f"{rays_ms:.3f} ms per frame; write_png {png_s:.4f} s per "
        f"{SIZE}x{SIZE} image; ground truth for 2 views {gt_s:.4f} s "
        f"(set-up)", flush=True)

  big = ds.view_rays(0)[:4 * CHUNK].contiguous()
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0)
  k1.plain_cp_render(ws, big, **kw)                    # warm-up
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(3):
    k1.plain_cp_render(ws, big, **kw)
  end.record()
  smi = subprocess.run(                                # read while K1 runs
      ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  torch.cuda.synchronize()
  ms = start.elapsed_time(end) / 3
  tflops = 2 * 459520 * big.shape[0] * STEPS / ms / 1e9
  print(f"[profile] {card}: one {big.shape[0]}-ray x {STEPS}-step K1 call "
        f"{ms:.2f} ms = {tflops:.2f} TFLOP/s; under load: "
        f"{smi.stdout.strip()}", flush=True)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--profile", action="store_true",
                      help="add phase 6, the traced frame")
  args = parser.parse_args(argv)
  # ---- 1. device ----
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  print(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | count {torch.cuda.device_count()}",
        flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False     # the reference's matmuls
  torch.backends.cudnn.allow_tf32 = False

  from nerf_atlas_tpu_torch import models
  from nerf_atlas_tpu_torch import runner as port_runner
  from nerf_atlas_tpu_torch.data import loaders, sampler
  from nerf_atlas_tpu_torch.ops.kernels import build
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  from nerf_atlas_tpu_torch.train import driver

  # ---- 2. build ----
  built = build.build("render_fwd")
  regs = [ln.strip() for ln in built.log.splitlines()
          if "registers" in ln or "spill" in ln]
  print(f"[build] render_fwd.cu -> {built.path.name} in "
        f"{built.seconds:.1f} s | {' | '.join(regs)}", flush=True)

  # ---- 3. kernel vs reference on the card ----
  dev = torch.device("cuda")
  model = driver.init_model(models.PlainNeRF(steps=STEPS, device=dev),
                            seed=0)
  ws = k1.pack_weights(model.state_dict(), dev)
  amplified = dict(model.state_dict())
  amplified["refl.mlp.layer_out.weight"] = (
      amplified["refl.mlp.layer_out.weight"] * 40.0)
  amplified["density_mlp.layer_out.weight"] = (
      amplified["density_mlp.layer_out.weight"] * 8.0)
  ws_amp = k1.pack_weights(amplified, dev)
  rays = torch.from_numpy(_check_rays(N_CHECK, 0)).to(dev)
  max_err = 0.0
  cases = [(w, sky, kind) for w in ("seeded", "amplified")
           for sky in ("black", "white") for kind in ("thin", "normal",
                                                      "tanh")]
  for wname, sky, kind in cases:
    w = ws if wname == "seeded" else ws_amp
    kw = dict(steps=STEPS, t_near=2.0, t_far=6.0, sigmoid_kind=kind,
              sky_kind=sky)
    out = k1.plain_cp_render(w, rays, **kw)
    ref = k1.plain_cp_render_reference(w, rays, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
      raise RuntimeError(f"K1 output not finite ({wname}, {sky}, {kind})")
    e_rgb = float((out[:, :3] - ref[:, :3]).abs().max())
    e_acc = float((out[:, 3] - ref[:, 3]).abs().max())
    print(f"[check] {wname:9s} sky {sky:5s} {kind:6s}: max|rgb| {e_rgb:.3e} "
          f"max|acc| {e_acc:.3e} (tol {TOL:.0e}; ref rgb std "
          f"{float(ref[:, :3].std()):.3f})", flush=True)
    if not (e_rgb <= TOL and e_acc <= TOL):
      raise RuntimeError(f"K1 disagrees with its reference: {e_rgb}, {e_acc}")
    max_err = max(max_err, e_rgb, e_acc)

  # ---- 4. main path: the port's runner at 800x800 ----
  with tempfile.TemporaryDirectory() as outdir:
    k1.plain_cp_render.launches = 0
    argv = ["--data-kind", "synthetic", "--model", "plain", "--size",
            str(SIZE), "--num-views", "2", "--epochs", "0", "--outdir",
            outdir]
    results, secs = _sync_time(lambda: port_runner.main(argv))
    launches = k1.plain_cp_render.launches
    if launches <= 0:
      raise RuntimeError("the main path never launched K1")
    for split in ("train", "test"):
      if not os.path.exists(os.path.join(outdir, split, "results.txt")):
        raise RuntimeError(f"no {split}/results.txt")
      if not all(math.isfinite(p) for p in results[split]["psnrs"]):
        raise RuntimeError(f"{split} PSNR not finite: {results[split]}")
  n_rays = 2 * 2 * SIZE * SIZE
  print(f"[main] runner {SIZE}x{SIZE}x{STEPS}, 2 views x 2 splits: "
        f"{secs:.2f} s end to end (incl. ground-truth render + PNGs), "
        f"{n_rays / secs:,.0f} rays/s | K1 launches {launches} | PSNR train "
        f"{results['train']['psnr_mean']:.3f} test "
        f"{results['test']['psnr_mean']:.3f}", flush=True)

  # ---- 5. timing at the main path's shapes ----
  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=SIZE, num_views=1,
                   device=dev), size=SIZE, device=dev)
  frame_rays = ds.view_rays(0)
  call_rays = frame_rays[:CHUNK].contiguous()
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0)

  def ref_frame():
    return torch.cat([k1.plain_cp_render_reference(ws, frame_rays[i:i + CHUNK],
                                                   **kw)[:, :3]
                      for i in range(0, frame_rays.shape[0], CHUNK)])

  def kernel_frame():
    return driver.render_view(model, ds, 0)

  plain_ms = _event_ms(lambda: k1.plain_cp_render_reference(ws, call_rays,
                                                            **kw), 2)
  kernel_ms = _event_ms(lambda: k1.plain_cp_render(ws, call_rays, **kw), 3)
  kernel_ms2 = _event_ms(lambda: k1.plain_cp_render(ws, call_rays, **kw), 3)
  plain_ms2 = _event_ms(lambda: k1.plain_cp_render_reference(ws, call_rays,
                                                             **kw), 2)
  img_ref, ref_s = _sync_time(ref_frame)
  img_k, k_s = _sync_time(kernel_frame)
  frame_err = float(np.abs(img_k.reshape(-1, 3)
                           - img_ref.cpu().numpy()).max())
  if frame_err > TOL:
    raise RuntimeError(f"800x800 frame: kernel vs reference {frame_err}")
  max_err = max(max_err, frame_err)
  gflop = 2 * 459520 * CHUNK * STEPS / 1e9
  print(f"[time] {card}: one {CHUNK}-ray x {STEPS}-step call: K1 "
        f"{kernel_ms:.2f} / {kernel_ms2:.2f} ms "
        f"({gflop / kernel_ms:.2f} TFLOP/s), plain torch {plain_ms:.2f} / "
        f"{plain_ms2:.2f} ms", flush=True)
  print(f"[time] {card}: one {SIZE}x{SIZE}x{STEPS} frame: render_view (K1) "
        f"{k_s:.3f} s = {SIZE * SIZE / k_s:,.0f} rays/s, plain torch "
        f"{ref_s:.3f} s = {SIZE * SIZE / ref_s:,.0f} rays/s | frame max "
        f"diff {frame_err:.2e}", flush=True)

  if args.profile:
    _profile(card, model, ds, ws)

  print(json.dumps({"kernels": [{
      "name": "render_fwd", "route": "cuda",
      "source": "nerf_atlas_tpu_torch/csrc/render_fwd.cu",
      "replaces": "nerf_atlas_tpu/ops/pallas/render.py:586",
      "launches": launches, "max_abs_err": max_err,
      "ms": min(kernel_ms, kernel_ms2), "plain_ms": min(plain_ms, plain_ms2),
  }]}))
  print(card)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
  sys.exit(main())
