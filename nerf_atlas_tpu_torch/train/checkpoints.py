"""Checkpoints: a torch `state_dict` plus a JSON config sidecar.

Counterpart of `nerf_atlas_tpu/train/checkpoints.py` (`save` / `load`).
Graft surgery (`graft`, `restore_or_graft`, remaps) arrives with ROADMAP
Queue 1 #13.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import torch


def save(path: str, params: Mapping[str, torch.Tensor],
         config: Optional[Dict[str, Any]] = None, step: int = 0,
         versioned: bool = False) -> str:
  """Write {"params": state_dict, "step": step} (tensors moved to the CPU)
  and, with `config`, `<path>.json`; returns the path written. versioned:
  write `<base>_<step:07d><ext>` instead (--versioned-save). The write
  goes to a temp file and an atomic rename, so a crash never corrupts an
  earlier checkpoint. Synchronous (the JAX package writes periodic saves
  on a thread)."""
  if versioned:
    base, ext = os.path.splitext(path)
    path = f"{base}_{step:07d}{ext}"
  os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
  payload = {"params": {k: v.detach().cpu() for k, v in params.items()},
             "step": step}
  tmp = path + ".tmp"
  torch.save(payload, tmp)
  os.replace(tmp, path)
  if config is not None:
    with open(path + ".json", "w") as f:
      json.dump(config, f, indent=2, default=str)
  return path


def load(path: str) -> Dict[str, Any]:
  """Read a checkpoint written by `save`: {"params": state_dict, "step"}."""
  return torch.load(path, map_location="cpu", weights_only=True)
