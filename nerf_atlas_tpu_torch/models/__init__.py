"""Model registry (the port covers TinyNeRF, PlainNeRF and NeRFAE so
far)."""
from .base import NeRFBase  # noqa: F401
from .nerf import NeRFAE, PlainNeRF, TinyNeRF

MODEL_KINDS = {"tiny": TinyNeRF, "plain": PlainNeRF, "ae": NeRFAE}


def load_model(kind: str, **kwargs):
  ctor = MODEL_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"model kind {kind}: not ported yet (ROADMAP Queue 1 #8, #10-#13)")
  return ctor(**kwargs)
