"""Elementwise math: the sigmoid zoo, the Laplace CDF, view-direction
angles, PSNR, colour spaces.

Counterpart of `nerf_atlas_tpu/ops/math.py` (the parts the main path
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


# ---------------------------------------------------------------------------
# distributions
# ---------------------------------------------------------------------------

def laplace_cdf(sdf_vals, scale):
  """CDF of a zero-mean Laplace distribution of scale `scale` at
  `sdf_vals` (VolSDF's density is laplace_cdf(−sdf, scale)/scale), in the
  JAX function's form: the clamps keep the branch `where` does not take
  finite, so no NaN leaks into its gradient (and at 0 the gradient splits
  as jnp.minimum's does)."""
  scaled = sdf_vals / scale
  zero = torch.zeros_like(scaled)
  return torch.where(scaled <= 0,
                     torch.exp(torch.minimum(scaled, zero)) / 2,
                     1 - torch.exp(-torch.maximum(scaled, zero)) / 2)


def smooth_min(v, k: float = 32.0, dim: int = 0):
  """Differentiable min along `dim`: −log(max(Σ exp(−k·v), 1e-4)) / k."""
  return -torch.log(torch.clamp(torch.sum(torch.exp(-k * v), dim=dim),
                                min=1e-4)) / k


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


# ---------------------------------------------------------------------------
# colour spaces (the loss's --color-spaces)
# ---------------------------------------------------------------------------

def rgb2hsv(v):
  """RGB -> (hue, saturation, value) as the JAX package computes it: V is
  the mean of max and min, hue in sextants from the max channel."""
  r, g, b = v[..., 0], v[..., 1], v[..., 2]
  max_val, max_ind = torch.max(v, dim=-1)
  min_val = torch.min(v, dim=-1).values
  c = max_val - min_val
  eps = 1e-8
  cc = torch.clamp(c, min=eps)
  h = torch.where(
      torch.abs(c) < eps, torch.zeros_like(c),
      torch.where(max_ind == 0, (g - b) / cc,
                  torch.where(max_ind == 1, 2 + (b - r) / cc,
                              4 + (r - g) / cc)))
  s = torch.where(torch.abs(max_val) < eps, torch.zeros_like(c),
                  c / torch.clamp(max_val, min=eps))
  return torch.stack([h, s, (max_val + min_val) / 2], dim=-1)


def rgb2luminance(v):
  r, g, b = v[..., 0:1], v[..., 1:2], v[..., 2:3]
  return 0.2126 * r + 0.7152 * g + 0.0722 * b


_RGB2XYZ = ((0.49, 0.31, 0.2),
            (0.17697, 0.8124, 0.01063),
            (0.0, 0.01, 0.99))


def rgb2xyz(v):
  m = torch.tensor(_RGB2XYZ, dtype=v.dtype, device=v.device)
  return torch.einsum("ij,...j->...i", m, v) / 0.17697
