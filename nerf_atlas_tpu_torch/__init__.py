"""PyTorch/CUDA port of nerf_atlas_tpu.

The package mirrors `nerf_atlas_tpu`'s module paths and public names, so
each module's counterpart is found at the same path. It imports `torch`
and never `jax`. Parts the port does not cover yet raise
`NotImplementedError` naming the ROADMAP item that brings them.

Hand-written GPU kernels live in `csrc/` and are built at first use into
`build/kernels/` at the repo root (`ops/kernels/build.py`).
"""
