"""Model registry: TinyNeRF, PlainNeRF, NeRFAE, CoarseFineNeRF, VolSDF and
the SDF surface renderer, and the dynamic wrappers DynamicNeRF,
DynamicNeRFAE and LongDynamicNeRF (the voxel and rig ones arrive with
ROADMAP Queue 1 #11)."""
from .base import NeRFBase  # noqa: F401
from .dyn import (DYN_MODEL_KINDS, DynamicNeRF, DynamicNeRFAE,  # noqa: F401
                  LongDynamicNeRF, is_dynamic, load_dyn_model)
from .nerf import CoarseFineNeRF, NeRFAE, PlainNeRF, TinyNeRF
from .sdf import SDF
from .volsdf import VolSDF

MODEL_KINDS = {"tiny": TinyNeRF, "plain": PlainNeRF, "ae": NeRFAE,
               "coarse_fine": CoarseFineNeRF, "volsdf": VolSDF, "sdf": SDF}


def load_model(kind: str, **kwargs):
  ctor = MODEL_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"model kind {kind}: not ported yet (ROADMAP Queue 1 #10-#13)")
  return ctor(**kwargs)
