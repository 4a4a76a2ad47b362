"""Model registry (the port covers TinyNeRF, PlainNeRF, NeRFAE,
CoarseFineNeRF, VolSDF and, among the dynamic wrappers, DynamicNeRF so
far)."""
from .base import NeRFBase  # noqa: F401
from .dyn import DYN_MODEL_KINDS, DynamicNeRF, load_dyn_model  # noqa: F401
from .nerf import CoarseFineNeRF, NeRFAE, PlainNeRF, TinyNeRF
from .volsdf import VolSDF

MODEL_KINDS = {"tiny": TinyNeRF, "plain": PlainNeRF, "ae": NeRFAE,
               "coarse_fine": CoarseFineNeRF, "volsdf": VolSDF}


def load_model(kind: str, **kwargs):
  ctor = MODEL_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"model kind {kind}: not ported yet (ROADMAP Queue 1 #10-#13)")
  return ctor(**kwargs)
