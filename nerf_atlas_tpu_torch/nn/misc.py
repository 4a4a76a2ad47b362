"""Gram-matrix style loss.

Counterpart of `nerf_atlas_tpu/nn/misc.py:gram_matrix` and `StyleLoss`
(`--style-img`): the Gram-matrix distance between an image's and the
style image's features under a fixed random stack of three 3×3 stride-2
convolutions (16, 32, 64 features, ReLU), as in JAX (no pretrained VGG
is at hand). The rest of `misc` (EncodedGRU, PointNet, the Monte-Carlo
head) arrives with its models (ROADMAP Queue 1 #13).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .mlp import _TRUNC_STD


def gram_matrix(feats):
  """Normalized Gram matrix of NHWC features [..., H, W, C] ->
  [..., C, C]."""
  *batch, h, w, c = feats.shape
  f = feats.reshape(tuple(batch) + (h * w, c))
  return torch.einsum("...nc,...nd->...cd", f, f) / (h * w * c)


def _same_pad(size: int, kernel: int, stride: int):
  """flax's SAME padding along one axis: (before, after); at stride 2 and
  an even size that is (0, 1)."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


class StyleLoss(nn.Module):
  """`forward(img, style_img)` [V, H, W, 3] each -> the scalar style loss
  Σ over the three layers of mean((G(img) − G(style))²), the style side
  without gradient. The convolutions are frozen (no parameter takes a
  gradient); `conv_i` holds flax's `conv_i` (weight [out, in, 3, 3] =
  its kernel [3, 3, in, out] permuted)."""

  def __init__(self, features: Sequence[int] = (16, 32, 64), device=None):
    super().__init__()
    self.features = tuple(features)
    sizes = (3,) + self.features
    for i, (cin, cout) in enumerate(zip(sizes[:-1], sizes[1:])):
      setattr(self, f"conv_{i}", nn.Conv2d(cin, cout, 3, stride=2,
                                           device=device))
    for p in self.parameters():
      p.requires_grad_(False)

  @property
  def convs(self):
    return [getattr(self, f"conv_{i}") for i in range(len(self.features))]

  def reset_parameters(self, generator: torch.Generator):
    """flax's Conv init: lecun normal (truncated at 2σ) kernels, zero
    biases; drawn on the CPU from `generator`."""
    for conv in self.convs:
      fan_in = conv.weight[0].numel()
      std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
      w = torch.empty(conv.weight.shape)
      nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                            generator=generator)
      with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.zero_()

  def _feats(self, x):
    """NHWC -> the feature map of each layer, NHWC."""
    h = x.permute(0, 3, 1, 2)
    out = []
    for conv in self.convs:
      ph = _same_pad(h.shape[-2], 3, 2)
      pw = _same_pad(h.shape[-1], 3, 2)
      h = F.relu(conv(F.pad(h, (*pw, *ph))))
      out.append(h.permute(0, 2, 3, 1))
    return out

  def forward(self, img, style_img):
    with torch.no_grad():
      style = [gram_matrix(f) for f in self._feats(style_img)]
    return sum(torch.mean((gram_matrix(f) - g) ** 2)
               for f, g in zip(self._feats(img), style))
