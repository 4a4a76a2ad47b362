"""SkipConnMLP — the universal field MLP of the framework.

Counterpart of `nerf_atlas_tpu/nn/mlp.py`. Wiring (reference
src/neural_blocks.py:279-311):
  init = concat(x, enc(x), latent)      # raw input ALWAYS included
  h    = layer_in(init)
  for i in range(num_layers):
    if i % skip == 0 and i != num_layers - 1:
      h = concat(h, init)               # skip fires at i=0 too
    h = layer_i(act(h))                 # pre-activation order
  out  = layer_out(act(h))

Layers are `nn.Linear` named like the flax `Dense` modules, so the
`state_dict` keys follow the flax paths (`layer_in.weight` is the
transposed `layer_in/kernel`). A skip layer's input rows are ordered
[hidden ; init_feat].
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

INIT_KINDS = ("xavier", "kaiming", "siren", "zero")

# flax's truncated-normal variance scaling divides by the std of a unit
# normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def leaky_relu(v):
  return F.leaky_relu(v, 0.01)


def init_weight_(weight: torch.Tensor, kind: str,
                 generator: torch.Generator, w0: float = 30.0):
  """Fill a Linear weight [out, in] in place with the flax init `kind`:
  xavier | kaiming | zero | siren_first | siren | uniform_last.

  Draws on the CPU from `generator` and copies to the weight's device,
  so a seed gives the same weights on every device."""
  fan_out, fan_in = weight.shape
  w = torch.empty(weight.shape, dtype=torch.float32)
  if kind == "xavier":
    nn.init.xavier_uniform_(w, generator=generator)
  elif kind == "kaiming":
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
  elif kind == "zero":
    w.zero_()
  elif kind == "siren_first":
    nn.init.uniform_(w, -1.0 / fan_in, 1.0 / fan_in, generator=generator)
  elif kind == "siren":
    bound = math.sqrt(6.0 / fan_in) / w0
    nn.init.uniform_(w, -bound, bound, generator=generator)
  elif kind == "uniform_last":
    nn.init.uniform_(w, -1e-3, 1e-3, generator=generator)
  else:
    raise NotImplementedError(f"unknown init kind {kind}")
  with torch.no_grad():
    weight.copy_(w)


class SkipConnMLP(nn.Module):
  """MLP with periodic skip-concatenation of the encoded input.

  in_size:     raw input feature width (pre-encoding)
  out:         output feature width
  latent_size: width of the optional latent concatenated to the input
  enc:         optional encoder module applied to the raw input
  activation:  hidden nonlinearity (ignored for siren init, which uses
               sin(siren_w0 * x))
  init_kind:   one of INIT_KINDS
  zero_last / uniform_last: last-layer treatment
  """

  def __init__(self, in_size: int = 3, out: int = 3, latent_size: int = 0,
               enc: Optional[nn.Module] = None, num_layers: int = 5,
               hidden_size: int = 256, skip: int = 3,
               activation: Callable = leaky_relu, init_kind: str = "xavier",
               siren_w0: float = 30.0, zero_last: bool = False,
               uniform_last: bool = False, device=None):
    super().__init__()
    if init_kind not in INIT_KINDS:
      raise NotImplementedError(f"unknown init kind {init_kind}")
    self.in_size = in_size
    self.out = out
    self.latent_size = latent_size
    self.enc = enc
    self.num_layers = num_layers
    self.hidden_size = hidden_size
    self.skip = skip
    self.activation = activation
    self.init_kind = init_kind
    self.siren_w0 = siren_w0
    self.zero_last = zero_last
    self.uniform_last = uniform_last
    self.init_size = (in_size + (enc.size() if enc is not None else 0)
                      + latent_size)
    self.layer_in = nn.Linear(self.init_size, hidden_size, device=device)
    for i in range(num_layers):
      width = hidden_size + (self.init_size if self.skip_at(i) else 0)
      setattr(self, f"layer_{i}",
              nn.Linear(width, hidden_size, device=device))
    self.layer_out = nn.Linear(hidden_size, out, device=device)

  def skip_at(self, i: int) -> bool:
    return i % self.skip == 0 and i != self.num_layers - 1

  def hidden_layers(self):
    return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

  def reset_parameters(self, generator: torch.Generator):
    siren = self.init_kind == "siren"
    kind = "siren" if siren else self.init_kind
    if self.enc is not None and hasattr(self.enc, "reset_parameters"):
      self.enc.reset_parameters(generator)
    init_weight_(self.layer_in.weight, "siren_first" if siren else kind,
                 generator, self.siren_w0)
    for layer in self.hidden_layers():
      init_weight_(layer.weight, kind, generator, self.siren_w0)
    if self.zero_last:
      last = "zero"
    elif self.uniform_last:
      last = "uniform_last"
    else:
      last = kind
    init_weight_(self.layer_out.weight, last, generator, self.siren_w0)
    with torch.no_grad():
      for layer in [self.layer_in, *self.hidden_layers(), self.layer_out]:
        layer.bias.zero_()

  def act(self, v):
    if self.init_kind == "siren":
      return torch.sin(self.siren_w0 * v)
    return self.activation(v)

  def forward(self, x, latent: Optional[torch.Tensor] = None):
    parts = [x]
    if self.enc is not None:
      parts.append(self.enc(x))
    if latent is not None and self.latent_size > 0:
      parts.append(latent.expand(x.shape[:-1] + latent.shape[-1:]))
    elif self.latent_size != 0:
      raise ValueError(
          f"expected latent of size {self.latent_size}, got None")
    init_feat = torch.cat(parts, dim=-1)

    h = self.layer_in(init_feat)
    for i, layer in enumerate(self.hidden_layers()):
      if self.skip_at(i):
        h = torch.cat([h, init_feat], dim=-1)
      h = layer(self.act(h))
    return self.layer_out(self.act(h))
