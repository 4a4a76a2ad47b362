"""Reflectance models."""
from .brdf import REFL_KINDS, IdentitySpace, View, load_refl  # noqa: F401
