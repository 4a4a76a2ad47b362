"""Transplant JAX-package parameters into the port.

`params_from_flax` turns the flax params of a `nerf_atlas_tpu` model,
given as a nested dict of numpy arrays (e.g.
`jax.tree.map(np.asarray, params)`), into the matching port module's
`state_dict`. Paths map one to one, joined with "."; for PlainNeRF:
  params/density_mlp/{enc/lines_0..3, layer_in, layer_0..4, layer_out}
  params/refl/mlp/{layer_in, layer_0..4, layer_out}
(PlainNeRF-hash has enc/table, posenc and mip no enc at all), for
TinyNeRF params/mlp/{layer_in, layer_0..5, layer_out}, and for
DynamicNeRF params/warp/{enc/B, layer_in, layer_0..4, layer_out},
params/rigidity/{layer_in, layer_0..2, layer_out} and the canonical
(any kind) under params/canonical (the warp's B lands at `warp.enc.B`,
where the port's SkipConnMLP keeps its encoder); a time latent of width
L widens the warp's layer_out by L and the canonical's first MLP and
refl inputs by L, which the Dense shapes carry. DynamicNeRFAE is
params/warp and the NeRFAE under params/canonical, LongDynamicNeRF
params/warp (layer_0..3), params/rigidity and params/canonical: the
same walk. One path moves:
flax binds an encoder built inside a shape's call to the shape, so the
VolSDF tree holds the Fourier matrix at params/shape/FourierEncoder_0/B,
beside params/shape/mlp, where the port's SkipConnMLP keeps its encoder
at shape.mlp.enc (`shape.mlp.enc.B`); so do the CurlMLP shape's, and
the Local shape's, beside params/shape/fine (`shape.fine.enc.B`). The
other shapes' trees (siren's shape/mlp; spheres' shape/centers,
shape/radii and shape/resid; triangles' shape/tris), a bounded shape's
(the same under shape/inner) and the SDF renderer's (shape and refl)
map one to one. VolSDF's raw scale `density_scale` is a 0-d array and
stays one. StyleLoss's params/conv_0..2 map to `conv_0..2`.
A flax `Dense.kernel` is [in, out] and a torch `Linear.weight` is
[out, in], so kernels are transposed; a flax `Conv.kernel` [kh, kw, in,
out] becomes a `Conv2d.weight` [out, in, kh, kw]. A skip layer's input rows are
ordered [hidden ; init_feat] in both packages, so nothing else moves.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
  tree = tree.get("params", tree)
  out: Dict[str, torch.Tensor] = {}

  def tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))

  def walk(node: Mapping, prefix: str):
    if "kernel" in node:                       # a flax Dense or Conv
      kernel = tensor(node["kernel"])
      out[prefix + "weight"] = (kernel.permute(3, 2, 0, 1) if kernel.ndim == 4
                                else kernel.t()).contiguous()
      if "bias" in node:
        out[prefix + "bias"] = tensor(node["bias"])
      return
    for key, value in node.items():
      if isinstance(value, Mapping):
        walk(value, f"{prefix}{key}.")
      else:
        out[prefix + key] = tensor(value)

  walk(tree, "")
  for key in [k for k in out if k.endswith("FourierEncoder_0.B")]:
    prefix = key[:-len("FourierEncoder_0.B")]
    for owner in ("mlp", "fine"):
      if prefix + owner + ".layer_in.weight" in out:
        out[prefix + owner + ".enc.B"] = out.pop(key)
        break
  return out
