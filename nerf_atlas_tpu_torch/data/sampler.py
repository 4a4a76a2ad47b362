"""Device-resident labels + camera: random training ray batches and the
eval ray grid.

Counterpart of `nerf_atlas_tpu/data/sampler.py:RayDataset`. Crop batches
(`sample_crop`, for the image-structured losses) arrive with ROADMAP
Queue 1 #5; until then `--crop-size` raises in the runner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch


@dataclass
class RayDataset:
  """Labels [N, S, S, C], camera and, for a dynamic scene, each view's
  time [N], on one device."""
  pixels: torch.Tensor
  camera: Any
  size: int = 256
  times: Optional[torch.Tensor] = None

  @classmethod
  def from_bundle(cls, bundle, size: int, device=None):
    labels, times = bundle.labels, None
    if isinstance(labels, tuple):
      labels, times = labels
    pixels = torch.as_tensor(labels, dtype=torch.float32, device=device)
    if times is not None:
      times = torch.as_tensor(times, dtype=torch.float32,
                              device=pixels.device)
    return cls(pixels=pixels, camera=bundle.camera.to(pixels.device),
               size=size, times=times)

  @property
  def num_views(self) -> int:
    return self.pixels.shape[0]

  @property
  def device(self) -> torch.device:
    return self.pixels.device

  def sample(self, generator: torch.Generator, batch_size: int,
             jitter: float = 0.0,
             view_range: Optional[Tuple[int, int]] = None,
             serial_step: Optional[int] = None, end_bias: int = 0):
    """Uniform random rays over all views and pixels, drawn from
    `generator` (on the labels' device).

    view_range=(lo, hi) restricts the views to [lo, hi). serial_step:
    train views in turn (view = step % N, --serial-idxs). end_bias > 0
    adds `end_bias` extra draws each of the first and last view to the
    pool (--higher-end-chance). jitter: centred sub-pixel ray jitter.
    Returns (rays [B, 6], pix [B, C], times [B] (each ray's view's time;
    None for a static scene), view [B]).
    """
    n, s, dev = self.num_views, self.size, self.device
    lo, hi = view_range if view_range is not None else (0, n)
    if serial_step is not None:
      view = torch.full((batch_size,), serial_step % n, dtype=torch.long,
                        device=dev)
    elif end_bias > 0:
      u = torch.randint(lo, hi + 2 * end_bias, (batch_size,),
                        generator=generator, device=dev)
      view = torch.where(u < hi, u, torch.where(u < hi + end_bias,
                                                torch.full_like(u, lo),
                                                torch.full_like(u, hi - 1)))
    else:
      view = torch.randint(lo, hi, (batch_size,), generator=generator,
                           device=dev)
    xy = torch.randint(0, s, (batch_size, 2), generator=generator,
                       device=dev)
    pix = self.pixels[view, xy[:, 1], xy[:, 0]]
    rays = self.camera.rays_at(view, xy.to(torch.float32) + 0.5, s,
                               jitter=jitter, generator=generator)
    return rays, pix, None if self.times is None else self.times[view], view

  def view_rays(self, view: int, render_size: Optional[int] = None):
    """All rays of one view at `render_size` (default: dataset size),
    flattened to [render_size**2, 6]."""
    rs = render_size or self.size
    scale = self.size / rs
    xs = (torch.arange(rs, dtype=torch.float32, device=self.device)
          + 0.5) * scale
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    xy = torch.stack([gx, gy], dim=-1)
    vidx = torch.full(xy.shape[:-1], view, dtype=torch.long,
                      device=self.device)
    return self.camera.rays_at(vidx, xy, self.size).reshape(-1, 6)
