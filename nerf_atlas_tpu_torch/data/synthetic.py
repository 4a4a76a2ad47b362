"""The static procedural scene with analytic ground truth.

Counterpart of `nerf_atlas_tpu/data/synthetic.py`: colored soft spheres,
volume-rendered analytically with the port's own integrator. The poses
come from the same `np.random.default_rng(seed)` draws as the JAX
package's, so both packages see the same cameras and pixels. The
dynamic and lit variants arrive with ROADMAP Queue 1 #11/#13.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import cameras as cam_lib
from ..ops import integrate, rays as rays_ops


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
  """NeRF-convention camera-to-world [4, 4] (camera looks along -z)."""
  eye = torch.as_tensor(eye, dtype=torch.float32)
  target = torch.as_tensor(target, dtype=torch.float32)
  up = torch.as_tensor(up, dtype=torch.float32)
  fwd = eye - target  # camera -z points at target
  fwd = fwd / torch.linalg.vector_norm(fwd)
  right = torch.linalg.cross(up, fwd)
  right = right / torch.clamp(torch.linalg.vector_norm(right), min=1e-8)
  true_up = torch.linalg.cross(fwd, right)
  c2w = torch.eye(4)
  c2w[:3, 0] = right
  c2w[:3, 1] = true_up
  c2w[:3, 2] = fwd
  c2w[:3, 3] = eye
  return c2w


def hemisphere_poses(n: int, radius: float = 3.0, seed: int = 0):
  """n camera-to-world poses [n, 4, 4] looking at the origin, spread over
  the upper hemisphere (the NeRF-synthetic orbit). The forward-facing
  variant arrives with the MPI model (ROADMAP Queue 1 #13)."""
  rng = np.random.default_rng(seed)
  poses = []
  for i in range(n):
    azim = 2 * math.pi * (i / n) + rng.uniform(0, 0.1)
    elev = rng.uniform(0.15, 1.2)
    eye = (radius * math.cos(elev) * math.cos(azim),
           radius * math.sin(elev),
           radius * math.cos(elev) * math.sin(azim))
    poses.append(look_at(eye, (0.0, 0.0, 0.0)))
  return torch.stack(poses)


# scene definition: K spheres (center [3], radius, rgb [3], sharpness)
DEFAULT_SPHERES = dict(
    centers=torch.tensor([[0.0, 0.0, 0.0], [0.45, 0.3, 0.2],
                          [-0.4, -0.25, 0.3]]),
    radii=torch.tensor([0.42, 0.22, 0.18]),
    colors=torch.tensor([[0.9, 0.25, 0.2], [0.2, 0.8, 0.3],
                         [0.25, 0.3, 0.9]]),
    sigma=40.0,
)


def scene_density_rgb(pts, spheres=None):
  """Analytic density + rgb field at pts [..., 3] -> (density [...],
  rgb [..., 3])."""
  sp = spheres or DEFAULT_SPHERES
  centers = sp["centers"].to(pts.device)
  radii = sp["radii"].to(pts.device)
  colors = sp["colors"].to(pts.device)
  d = torch.linalg.vector_norm(pts[..., None, :] - centers, dim=-1) - radii
  inside = torch.sigmoid(-d * 60.0)                         # soft indicator
  density = sp["sigma"] * torch.amax(inside, dim=-1)
  w = torch.softmax(-d * 30.0, dim=-1)
  rgb = torch.sum(w[..., :, None] * colors, dim=-2)
  return density, rgb


def render_gt(camera, size: int, *, t_near=2.0, t_far=4.5, steps=96,
              chunk: int = 16384):
  """Ground-truth render of the scene for every camera view, on the
  camera's device. Returns imgs [N, size, size, 4] (rgb + alpha) numpy."""
  n = len(camera)
  device = camera.cam_to_world.device
  xs = torch.arange(size, dtype=torch.float32, device=device) + 0.5
  gy, gx = torch.meshgrid(xs, xs, indexing="ij")
  positions = torch.stack([gx, gy], dim=-1)                 # [S, S, 2]
  flat = camera.sample_positions(positions, size).reshape(-1, 6)
  outs = []
  for i in range(0, flat.shape[0], chunk):
    pts, ts, _, r_d = rays_ops.compute_pts_ts(flat[i:i + chunk], t_near,
                                              t_far, steps)
    density, rgb = scene_density_rgb(pts)
    _, weights = integrate.alpha_from_density(density, ts, r_d,
                                              softplus=False)
    img = integrate.volumetric_integrate(weights, rgb)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    outs.append(torch.cat([img, acc], dim=-1))
  return torch.cat(outs).reshape(n, size, size, 4).cpu().numpy()


def dataset(num_views: int = 8, size: int = 64, *, seed: int = 0,
            device=None):
  """(imgs [N,S,S,4] numpy, camera, None) in the loader contract. The
  dynamic, lit and white-background variants arrive with ROADMAP Queue 1
  #11/#13."""
  poses = hemisphere_poses(num_views, seed=seed)
  camera = cam_lib.NeRFCamera.from_json_transforms(
      poses, camera_angle_x=0.6911, width=size, device=device)
  return render_gt(camera, size), camera, None
