"""Ray sampling: stratified / linear-in-disparity t values and sample points.

Counterpart of `nerf_atlas_tpu/ops/rays.py`. Rays are `[..., 6]`
(origin ‖ direction); sample points are `[..., T, 3]`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def split_rays(rays) -> Tuple[torch.Tensor, torch.Tensor]:
  """rays [..., 6] -> (r_o [..., 3], r_d [..., 3])."""
  return rays[..., :3], rays[..., 3:6]


def compute_ts(
    near: float,
    far: float,
    steps: int,
    *,
    lindisp: bool = False,
    perturb: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
    device=None,
    batch_shape: Tuple[int, ...] = (),
) -> torch.Tensor:
  """t values along a ray: linear in t, or linear in disparity.

  With `perturb > 0` draws stratified-jittered samples inside the bins
  defined by the midpoints, from `generator` (which must live on
  `device`). `batch_shape=()` gives one jitter shared by all rays.

  Returns ts of shape batch_shape + [steps].
  """
  if lindisp:
    t_vals = torch.linspace(0.0, 1.0, steps, dtype=dtype, device=device)
    ts = 1.0 / (1.0 / max(near, 1e-10) * (1 - t_vals) + 1.0 / far * t_vals)
  else:
    ts = torch.linspace(near, far, steps, dtype=dtype, device=device)

  if perturb > 0:
    if generator is None:
      raise ValueError("stratified perturbation requires a torch.Generator")
    mids = 0.5 * (ts[:-1] + ts[1:])
    lower = torch.cat([mids, ts[-1:]])
    upper = torch.cat([ts[:1], mids])
    rand = torch.rand(batch_shape + (steps,), generator=generator,
                      dtype=dtype, device=device) * perturb
    ts = lower + (upper - lower) * rand
  elif batch_shape:
    ts = ts.expand(batch_shape + (steps,))
  return ts


def compute_pts(rays, ts) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Sample points along rays.

  rays: [..., 6]; ts: [T] or [..., T].
  Returns (pts [..., T, 3], r_o [..., 3], r_d [..., 3]).
  """
  r_o, r_d = split_rays(rays)
  pts = r_o[..., None, :] + ts[..., :, None] * r_d[..., None, :]
  return pts, r_o, r_d


def compute_pts_ts(
    rays,
    near: float,
    far: float,
    steps: int,
    *,
    lindisp: bool = False,
    perturb: float = 0.0,
    generator: Optional[torch.Generator] = None,
    per_ray_jitter: bool = False,
):
  """Fused `compute_ts` + point generation.

  Returns (pts [..., T, 3], ts, r_o, r_d).
  """
  batch_shape = (tuple(rays.shape[:-1]) if (per_ray_jitter and perturb > 0)
                 else ())
  ts = compute_ts(near, far, steps, lindisp=lindisp, perturb=perturb,
                  generator=generator, dtype=rays.dtype, device=rays.device,
                  batch_shape=batch_shape)
  pts, r_o, r_d = compute_pts(rays, ts)
  return pts, ts, r_o, r_d
