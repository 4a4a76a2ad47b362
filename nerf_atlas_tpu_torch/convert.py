"""Transplant JAX-package parameters into the port.

`params_from_flax` turns the flax params of a `nerf_atlas_tpu` model,
given as a nested dict of numpy arrays (e.g.
`jax.tree.map(np.asarray, params)`), into the matching port module's
`state_dict`. Paths map one to one, joined with "."; for PlainNeRF:
  params/density_mlp/{enc/lines_0..3, layer_in, layer_0..4, layer_out}
  params/refl/mlp/{layer_in, layer_0..4, layer_out}
(PlainNeRF-hash has enc/table, posenc and mip no enc at all), and for
TinyNeRF params/mlp/{layer_in, layer_0..5, layer_out}.
A flax `Dense.kernel` is [in, out] and a torch `Linear.weight` is
[out, in], so kernels are transposed. A skip layer's input rows are
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
    if "kernel" in node:                       # a flax Dense
      out[prefix + "weight"] = tensor(node["kernel"]).t().contiguous()
      if "bias" in node:
        out[prefix + "bias"] = tensor(node["bias"])
      return
    for key, value in node.items():
      if isinstance(value, Mapping):
        walk(value, f"{prefix}{key}.")
      else:
        out[prefix + key] = tensor(value)

  walk(tree, "")
  return out
