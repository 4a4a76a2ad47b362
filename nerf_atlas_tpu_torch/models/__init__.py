"""Model registry (the port covers PlainNeRF so far)."""
from .base import NeRFBase  # noqa: F401
from .nerf import PlainNeRF

MODEL_KINDS = {"plain": PlainNeRF}


def load_model(kind: str, **kwargs):
  ctor = MODEL_KINDS.get(kind)
  if ctor is None:
    raise NotImplementedError(
        f"model kind {kind}: not ported yet (ROADMAP Queue 1 #3, #8-#13)")
  return ctor(**kwargs)
