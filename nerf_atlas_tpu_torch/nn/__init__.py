"""Neural building blocks: the skip-connected field MLP and encoders."""
from .encoders import (  # noqa: F401
    CPEncoder, HashEncoder, PositionalEncoder)
from .mlp import INIT_KINDS, SkipConnMLP  # noqa: F401
