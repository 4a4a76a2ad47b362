"""Device-resident labels + camera, and the eval ray grid.

Counterpart of `nerf_atlas_tpu/data/sampler.py:RayDataset`. Random ray
batches (`sample`, `sample_crop`) arrive with the training slice
(ROADMAP Queue 1 #5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass
class RayDataset:
  """Labels [N, S, S, C] and camera on one device."""
  pixels: torch.Tensor
  camera: Any
  size: int = 256

  @classmethod
  def from_bundle(cls, bundle, size: int, device=None):
    labels = bundle.labels
    if isinstance(labels, tuple):
      raise NotImplementedError(
          "timed (dynamic) datasets arrive with ROADMAP Queue 1 #11")
    pixels = torch.as_tensor(labels, dtype=torch.float32, device=device)
    return cls(pixels=pixels, camera=bundle.camera.to(pixels.device),
               size=size)

  @property
  def num_views(self) -> int:
    return self.pixels.shape[0]

  @property
  def device(self) -> torch.device:
    return self.pixels.device

  def sample(self, *args, **kwargs):
    raise NotImplementedError(
        "random ray batches arrive with the training slice (ROADMAP Queue 1 "
        "#5)")

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
