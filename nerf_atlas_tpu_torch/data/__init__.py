"""Data layer: cameras, the procedural scene, loaders, the ray dataset."""
from .loaders import DatasetBundle, load  # noqa: F401
