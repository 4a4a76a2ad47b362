"""Hand-written GPU kernels (CUDA C++ for sm_90a) and their plain-torch
versions. Counterpart of `nerf_atlas_tpu/ops/pallas/`."""
from .render import (  # noqa: F401
    FUSED_SIGMOID_KINDS, plain_cp_render, plain_cp_render_reference)
