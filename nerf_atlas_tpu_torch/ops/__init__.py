"""Render core ops: rays, compositing, elementwise math, GPU kernels."""
from . import integrate, math, rays  # noqa: F401
