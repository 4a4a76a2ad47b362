"""Dataset loaders. Contract: `load(...) -> DatasetBundle(labels, camera,
lights|None)` with labels imgs [N,S,S,C] float32 in [0, 1].

Counterpart of `nerf_atlas_tpu/data/loaders.py`. Only the procedural
`synthetic` scene is ported; the on-disk formats (original, dnerf, dtu,
nerv_point, shiny, video, single image) arrive with ROADMAP Queue 1
#4/#11.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

from . import synthetic


class DatasetBundle(NamedTuple):
  labels: Any            # imgs [N,S,S,C]
  camera: Any
  lights: Optional[Any]  # point-light positions [N, L, 3] or None


def synthetic_spheres(path: str = "", training: bool = True, size: int = 64,
                      num_views: int = 8, device=None):
  """Procedural golden scene (see synthetic.py). `path` ignored; the train
  split draws its poses from seed 0, the test split from seed 1."""
  del path
  labels, camera, lights = synthetic.dataset(
      num_views=num_views, size=size, seed=0 if training else 1,
      device=device)
  return DatasetBundle(labels, camera, lights)


LOADER_KINDS = {"synthetic": synthetic_spheres}


def kind_from_path(path: str) -> str:
  """Derive the loader kind from the data path (same rules as the JAX
  package)."""
  ext = os.path.splitext(path)[1].lower()
  if ext in (".mp4", ".gif", ".avi"):
    return "single_video"
  if ext in (".png", ".jpg", ".jpeg"):
    return "pixel-single"
  if os.path.isdir(path):
    if os.path.exists(os.path.join(path, "cameras.npz")):
      return "dtu"
    if os.path.exists(os.path.join(path, "poses_bounds.npy")):
      return "shiny"
    for name in ("transforms_train.json", "transforms.json"):
      p = os.path.join(path, name)
      if os.path.exists(p):
        with open(p) as f:
          return "dnerf" if '"time"' in f.read() else "original"
  return "synthetic"


def load(data_path: str, data_kind: Optional[str] = None,
         training: bool = True, size: int = 256, device=None,
         **kwargs) -> DatasetBundle:
  kind = data_kind or kind_from_path(data_path)
  fn = LOADER_KINDS.get(kind)
  if fn is None:
    raise NotImplementedError(
        f"data kind {kind}: only the procedural 'synthetic' scene is ported "
        "(the other loaders arrive with ROADMAP Queue 1 #4/#11)")
  return fn(data_path, training=training, size=size, device=device, **kwargs)
