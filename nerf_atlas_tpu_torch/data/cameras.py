"""Pinhole cameras.

Counterpart of `nerf_atlas_tpu/data/cameras.py:NeRFCamera`. Ray
generation takes pixel coordinates per view (`rays_at`); the grid form
`sample_positions` serves tiled eval rendering. The orthogonal, static
and DTU cameras arrive with ROADMAP Queue 1 #4/#11.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class NeRFCamera:
  """Pinhole camera with per-view camera-to-world transforms.

  cam_to_world: [N, 4, 4] (world = R @ cam + t)
  focal: [] focal length in pixels (for the training image size).
  """
  cam_to_world: torch.Tensor
  focal: torch.Tensor

  def __len__(self):
    return self.cam_to_world.shape[0]

  def to(self, device) -> "NeRFCamera":
    return NeRFCamera(self.cam_to_world.to(device), self.focal.to(device))

  @classmethod
  def from_json_transforms(cls, frames_c2w, camera_angle_x: float,
                           width: int, device=None):
    """NeRF-synthetic JSON convention:
    focal = 0.5 * W / tan(0.5 * camera_angle_x)."""
    focal = 0.5 * width / math.tan(0.5 * camera_angle_x)
    return cls(cam_to_world=torch.as_tensor(frames_c2w, dtype=torch.float32,
                                            device=device),
               focal=torch.tensor(focal, dtype=torch.float32, device=device))

  def _pixel_dirs(self, xy, size: int):
    """Camera-space directions for pixel coords xy [..., 2] (x right,
    y down): (x-W/2)/f, -(y-H/2)/f, -1."""
    u = (xy[..., 0] - size * 0.5) / self.focal
    v = -(xy[..., 1] - size * 0.5) / self.focal
    return torch.stack([u, v, -torch.ones_like(u)], dim=-1)

  def rays_at(self, view_idx, xy, size: int, jitter: float = 0.0,
              generator: Optional[torch.Generator] = None):
    """Rays for pixel samples: view_idx [...] int, xy [..., 2] pixel
    coords. With jitter > 0 each sample moves by jitter·(u − 0.5), u
    uniform in [0, 1) per coordinate from `generator` (on xy's device):
    the centred sub-pixel jitter of training. Returns rays [..., 6]."""
    if jitter > 0:
      if generator is None:
        raise ValueError("pixel jitter requires a torch.Generator")
      u = torch.rand(xy.shape, generator=generator, dtype=xy.dtype,
                     device=xy.device)
      xy = xy + jitter * (u - 0.5)
    d_cam = self._pixel_dirs(xy, size)                      # [..., 3]
    c2w = self.cam_to_world[view_idx]                       # [..., 4, 4]
    r_d = torch.sum(c2w[..., :3, :3] * d_cam[..., None, :], dim=-1)
    r_o = c2w[..., :3, 3].expand(r_d.shape)
    return torch.cat([r_o, r_d], dim=-1)

  def sample_positions(self, positions, size: int):
    """Grid form: positions [H', W', 2] pixel coords -> rays
    [N, H', W', 6] for all N views."""
    n = len(self)
    view_idx = torch.arange(n, device=positions.device)[:, None, None]
    xy = positions.expand((n,) + positions.shape)
    return self.rays_at(view_idx, xy, size)
