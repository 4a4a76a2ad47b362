"""Eval driver: parameter init, tiled view rendering, per-view PSNR.

Counterpart of `nerf_atlas_tpu/train/driver.py` (`init_model`,
`_fused_render_fn`, `render_view`, `test`). The port's modules own their
parameters, so these functions take the model where the JAX package takes
(model, params). The training loop (`train`, losses, optimizers) arrives
with the training slice (ROADMAP Queue 1 #5).
"""
from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ..data import sampler as sampler_lib
from ..models import PlainNeRF
from ..ops import integrate
from ..ops.kernels import render as k1


def init_model(model: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
  """Draw every parameter from a CPU `torch.Generator` seeded with `seed`
  (the same weights on every device); returns the model."""
  model.reset_parameters(torch.Generator().manual_seed(seed))
  return model


def _fused_render_fn(model) -> Optional[Callable]:
  """rays [n, 6] -> rgb [n, 3] through the K1 kernel wrapper when the
  model is the flagship (PlainNeRF, cp encoder, view refl in identity
  space, an rgb activation and sky the kernel implements); None
  otherwise. A parameter tree that diverges from the flagship's raises
  (in `pack_weights`)."""
  if (not isinstance(model, PlainNeRF) or model.enc_kind != "cp"
      or model.mip is not None or model.refl_kind != "view"
      or model.refl_space != "identity" or model.intermediate_size != 32
      or model.sigmoid_kind not in k1.FUSED_SIGMOID_KINDS
      or model.sky_kind not in integrate.SKY_KINDS
      # the kernel samples linearly in t
      or model.lindisp):
    return None
  device = next(model.parameters()).device
  ws = k1.pack_weights(model.state_dict(), device)  # raises on divergence

  def fn(rays_chunk):
    return k1.plain_cp_render(
        ws, rays_chunk, steps=model.steps, t_near=model.t_near,
        t_far=model.t_far, sigmoid_kind=model.sigmoid_kind,
        sky_kind=model.sky_kind)[:, :3]

  return fn


@torch.no_grad()
def render_view(model, ds: sampler_lib.RayDataset, view: int,
                render_size: Optional[int] = None, chunk: int = 65536,
                mode: str = "rgb") -> np.ndarray:
  """Tiled no-grad rendering of one full view -> [S, S, C] numpy.

  mode: "rgb" | "depth" (expected termination depth) | "acc" (opacity).
  rgb goes through the K1 kernel wrapper when the model is in its
  envelope, everything else through the model's forward."""
  if mode not in ("rgb", "depth", "acc"):
    raise NotImplementedError(
        f"render mode {mode}: normals/flow/rigidity maps arrive with their "
        "models (ROADMAP Queue 1 #10/#11)")
  rs = render_size or ds.size
  rays = ds.view_rays(view, rs)
  fused = _fused_render_fn(model) if mode == "rgb" else None
  outs = []
  for i in range(0, rays.shape[0], chunk):
    rc = rays[i:i + chunk]
    if fused is not None:
      outs.append(fused(rc))
      continue
    out = model(rc)
    if mode == "depth":
      outs.append(integrate.depth_from_weights(out["weights"], out["ts"]))
    elif mode == "acc":
      outs.append(out["weights"].sum(-1, keepdim=True))
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


def _to_u8(img):
  return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def test(model, ds: sampler_lib.RayDataset, out_dir: str = "outputs",
         render_size: Optional[int] = None, save_images: bool = True,
         chunk: int = 65536, only_view: Optional[int] = None,
         white_bg: bool = False, with_alpha: bool = False,
         save_depth: bool = False):
  """Per-view PSNR + summary stats; writes results.txt (the JAX package's
  format) + test_###.png (+ depth_###.png with save_depth). `chunk` =
  rays per tiled render call (--test-crop-size²).

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
    if save_depth:
      depth = render_view(model, ds, v, render_size, chunk=chunk,
                          mode="depth")[..., 0]
      dmin, dmax = float(depth.min()), float(depth.max())
      dn = (depth - dmin) / max(dmax - dmin, 1e-6)
      write_png(os.path.join(out_dir, f"depth_{v:03d}.png"), _to_u8(dn))
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
      write_png(os.path.join(out_dir, f"test_{v:03d}.png"), _to_u8(save))
  arr = np.asarray(psnrs)
  summary = (f"PSNR mean {arr.mean():.3f} median {np.median(arr):.3f} "
             f"min {arr.min():.3f} max {arr.max():.3f} var {arr.var():.4f}")
  lines.append(summary)
  with open(os.path.join(out_dir, "results.txt"), "w") as f:
    f.write("\n".join(lines) + "\n")
  return {"psnr_mean": float(arr.mean()), "psnr_median": float(np.median(arr)),
          "psnrs": psnrs, "summary": summary}
