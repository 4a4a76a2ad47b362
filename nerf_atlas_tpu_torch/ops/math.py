"""Elementwise math: the sigmoid zoo, view-direction angles, PSNR.

Counterpart of `nerf_atlas_tpu/ops/math.py` (the parts the eval path
needs). Everything is a plain function on tensors.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# sigmoid zoo ("feature activations" applied to RGB-ish MLP outputs)
# ---------------------------------------------------------------------------

def fat_sigmoid(v, eps: float = 1e-2):
  """Sigmoid stretched to (-eps, 1+eps): no vanishing gradient at 0/1."""
  return torch.sigmoid(v) * (1 + 2 * eps) - eps


def thin_sigmoid(v, eps: float = 1e-2):
  """Sigmoid squeezed to (eps, 1-eps)."""
  return fat_sigmoid(v, -eps) + eps


def cyclic_sigmoid(v, eps: float = -1e-2, period: int = 5):
  return (torch.sin(v / period) + 1) / 2 * (1 + 2 * eps) - eps


def upshifted_sigmoid(v, eps: float = 1e-2):
  return torch.sigmoid(v) + eps


def upshifted_softplus(v, eps: float = 1e-2):
  return F.softplus(v) + eps


def leaky_softplus(v, alpha: float = 0.01):
  return torch.where(v >= 0, F.softplus(v - 3), alpha * v + 0.0485873515737)


def upshifted_relu(v, eps: float = 1e-2):
  return F.relu(v) + eps


SIGMOID_KINDS = {
    "normal": torch.sigmoid,
    "thin": thin_sigmoid,
    "tanh": torch.tanh,
    "cyclic": cyclic_sigmoid,
    "upshifted": upshifted_sigmoid,
    "fat": fat_sigmoid,
    "softmax": functools.partial(torch.softmax, dim=-1),
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.01),
    "relu": F.relu,
    "sin": torch.sin,
    "upshifted_softplus": upshifted_softplus,
    "upshifted_relu": upshifted_relu,
}


def load_sigmoid(kind: str = "thin"):
  fn = SIGMOID_KINDS.get(kind)
  if fn is None:
    raise NotImplementedError(f"Unknown sigmoid kind({kind})")
  return fn


def mse2psnr(x):
  return -10 * torch.log10(x)


# ---------------------------------------------------------------------------
# direction parameterizations
# ---------------------------------------------------------------------------

def normalize(v, dim: int = -1, eps: float = 1e-12):
  return v / torch.clamp(torch.linalg.vector_norm(v, dim=dim, keepdim=True),
                         min=eps)


def dir_to_elev_azim(direc):
  """Unit direction -> (elev=acos z, azim=atan2(y,x)); the reference's
  convention (acos rather than asin)."""
  lim = 1 - 1e-6
  d = torch.clamp(normalize(direc), -lim, lim)
  x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
  return torch.cat([torch.arccos(z), torch.atan2(y, x)], dim=-1)
