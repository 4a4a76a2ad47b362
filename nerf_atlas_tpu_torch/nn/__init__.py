"""Neural building blocks: the skip-connected field MLP and encoders."""
from .encoders import CPEncoder, PositionalEncoder  # noqa: F401
from .mlp import INIT_KINDS, SkipConnMLP  # noqa: F401
