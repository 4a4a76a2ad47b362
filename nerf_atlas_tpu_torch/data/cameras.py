"""Cameras: pinhole (NeRF convention), orthographic, static and DTU.

Counterpart of `nerf_atlas_tpu/data/cameras.py`: `NeRFCamera`,
`OrthogonalCamera`, `StaticCamera`, `DTUCamera` and `CAMERA_KINDS`. Ray
generation takes pixel coordinates per view (`rays_at`); the grid form
`sample_positions` serves tiled eval rendering. Each camera holds its
tensors on one device (`to`), takes pixel jitter from an explicit
`torch.Generator` on that device, and slices by view (`cam[idxs]`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


def _jittered(xy, jitter: float, generator: Optional[torch.Generator]):
  """xy moved by jitter·(u − 0.5), u uniform in [0, 1) per coordinate
  from `generator` (on xy's device): the centred sub-pixel jitter of
  training."""
  if jitter <= 0:
    return xy
  if generator is None:
    raise ValueError("pixel jitter requires a torch.Generator")
  u = torch.rand(xy.shape, generator=generator, dtype=xy.dtype,
                 device=xy.device)
  return xy + jitter * (u - 0.5)


def _matvec(m, v):
  """m [..., 3, 3] @ v [..., 3] -> [..., 3]."""
  return torch.sum(m * v[..., None, :], dim=-1)


def _grid(camera, positions, size: int, with_noise: float,
          generator: Optional[torch.Generator]):
  """Grid form: positions [H', W', 2] pixel coords -> rays [N, H', W', 6]
  for all N views."""
  n = len(camera)
  view_idx = torch.arange(n, device=positions.device)[:, None, None]
  xy = positions.expand((n,) + positions.shape)
  return camera.rays_at(view_idx, xy, size, jitter=with_noise,
                        generator=generator)


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

  def __getitem__(self, idxs) -> "NeRFCamera":
    return NeRFCamera(self.cam_to_world[idxs], self.focal)

  def to(self, device) -> "NeRFCamera":
    return NeRFCamera(self.cam_to_world.to(device), self.focal.to(device))

  @classmethod
  def identity(cls, n: int, focal: float = 1.0, device=None):
    """n views at the origin looking down −z."""
    c2w = torch.eye(4, device=device).expand(n, 4, 4)
    return cls(cam_to_world=c2w,
               focal=torch.tensor(focal, dtype=torch.float32, device=device))

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
    coords, jittered by `jitter` (`_jittered`). Returns rays [..., 6]."""
    xy = _jittered(xy, jitter, generator)
    d_cam = self._pixel_dirs(xy, size)                      # [..., 3]
    c2w = self.cam_to_world[view_idx]                       # [..., 4, 4]
    r_d = _matvec(c2w[..., :3, :3], d_cam)
    r_o = c2w[..., :3, 3].expand(r_d.shape)
    return torch.cat([r_o, r_d], dim=-1)

  def sample_positions(self, positions, size: int, with_noise: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    """Grid form: positions [H', W', 2] pixel coords -> rays
    [N, H', W', 6] for all N views."""
    return _grid(self, positions, size, with_noise, generator)

  def project_pts(self, pts, size: int):
    """World points [..., 3] -> pixel coords [..., 2] per camera (the
    inverse of `rays_at`), broadcast against the views."""
    c2w = self.cam_to_world
    local = torch.sum(c2w[..., :3, :3] * (pts - c2w[..., :3, 3])[..., None],
                      dim=-2)                               # R^T (p - t)
    z = -local[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = local[..., 0:1] / z * self.focal + size * 0.5
    v = -local[..., 1:2] / z * self.focal + size * 0.5
    return torch.cat([u, v], dim=-1)


@dataclass
class OrthogonalCamera:
  """Orthographic camera: parallel rays along each view's −z, over a
  square `view_width` wide."""
  cam_to_world: torch.Tensor                                # [N, 4, 4]
  view_width: float = 2.0

  def __len__(self):
    return self.cam_to_world.shape[0]

  def __getitem__(self, idxs) -> "OrthogonalCamera":
    return OrthogonalCamera(self.cam_to_world[idxs], self.view_width)

  def to(self, device) -> "OrthogonalCamera":
    return OrthogonalCamera(self.cam_to_world.to(device), self.view_width)

  def rays_at(self, view_idx, xy, size: int, jitter: float = 0.0,
              generator: Optional[torch.Generator] = None):
    xy = _jittered(xy, jitter, generator)
    uv = (xy / size - 0.5) * self.view_width
    c2w = self.cam_to_world[view_idx]
    offset = uv[..., 0:1] * c2w[..., :3, 0] - uv[..., 1:2] * c2w[..., :3, 1]
    r_o = c2w[..., :3, 3] + offset
    r_d = (-c2w[..., :3, 2]).expand(r_o.shape)
    return torch.cat([r_o, r_d], dim=-1)

  def sample_positions(self, positions, size: int, with_noise: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    return _grid(self, positions, size, with_noise, generator)


@dataclass
class StaticCamera:
  """`n_views` views sharing one pose at the origin looking down −z, with
  a FOV-derived focal (single-video data, where the camera never
  moves)."""
  focal: torch.Tensor
  n_views: int = 1

  def __len__(self):
    return self.n_views

  def __getitem__(self, idxs) -> "StaticCamera":
    n = (len(range(self.n_views)[idxs]) if isinstance(idxs, slice)
         else 1 if isinstance(idxs, int) else len(idxs))
    return StaticCamera(self.focal, n)

  def to(self, device) -> "StaticCamera":
    return StaticCamera(self.focal.to(device), self.n_views)

  @classmethod
  def from_fov(cls, fov_deg: float, width: int, n_views: int = 1,
               device=None):
    focal = 0.5 * width / math.tan(0.5 * math.radians(fov_deg))
    return cls(torch.tensor(focal, dtype=torch.float32, device=device),
               n_views)

  def rays_at(self, view_idx, xy, size: int, jitter: float = 0.0,
              generator: Optional[torch.Generator] = None):
    del view_idx
    xy = _jittered(xy, jitter, generator)
    u = (xy[..., 0] - size * 0.5) / self.focal
    v = -(xy[..., 1] - size * 0.5) / self.focal
    r_d = torch.stack([u, v, -torch.ones_like(u)], dim=-1)
    return torch.cat([torch.zeros_like(r_d), r_d], dim=-1)

  def sample_positions(self, positions, size: int, with_noise: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    xy = positions.expand((len(self),) + positions.shape)
    return self.rays_at(None, xy, size, jitter=with_noise,
                        generator=generator)


@dataclass
class DTUCamera:
  """Intrinsics camera of the DTU scans: per-view pose (camera-to-world)
  and intrinsics K; rays lift pixels through K⁻¹ and are normalised.

  pose: [N, 4, 4]; K: [N, 3, 3] (pixel units at the training size).
  """
  pose: torch.Tensor
  K: torch.Tensor

  def __len__(self):
    return self.pose.shape[0]

  def __getitem__(self, idxs) -> "DTUCamera":
    return DTUCamera(self.pose[idxs], self.K[idxs])

  def to(self, device) -> "DTUCamera":
    return DTUCamera(self.pose.to(device), self.K.to(device))

  def rays_at(self, view_idx, xy, size: int, jitter: float = 0.0,
              generator: Optional[torch.Generator] = None):
    del size                           # K already carries the pixel scale
    xy = _jittered(xy, jitter, generator)
    pose = self.pose[view_idx]
    k_inv = torch.linalg.inv(self.K)[view_idx]
    homog = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    r_d = _matvec(pose[..., :3, :3], _matvec(k_inv, homog))
    r_d = r_d / torch.clamp(torch.linalg.vector_norm(r_d, dim=-1,
                                                     keepdim=True), min=1e-8)
    r_o = pose[..., :3, 3].expand(r_d.shape)
    return torch.cat([r_o, r_d], dim=-1)

  def sample_positions(self, positions, size: int, with_noise: float = 0.0,
                       generator: Optional[torch.Generator] = None):
    return _grid(self, positions, size, with_noise, generator)


CAMERA_KINDS = {
    "nerf": NeRFCamera,
    "ortho": OrthogonalCamera,
    "static": StaticCamera,
    "dtu": DTUCamera,
}
