"""Build the hand-written CUDA kernels and load them with ctypes.

Each kernel source in `nerf_atlas_tpu_torch/csrc/` has a plain C
interface. At first use it is compiled with `nvcc` for `sm_90a` (Hopper)
into a shared library under `build/kernels/` at the repo root, named by a
hash of the source, of every header it includes from `csrc/` (quoted
`#include`, followed recursively) and of the flags, so an edited source
or header is rebuilt and an unchanged one is reused. A source may be
built in variants, each with its own `-D` defines (render_bwd.cu one per
encoder mode, render_dyn_fwd.cu and render_dyn_bwd.cu one per canonical
encoder and warp kind, so that the instantiations compile in parallel).
Nothing is built or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


@dataclass(frozen=True)
class Built:
  """A compiled kernel library: its path, the seconds the build took (0
  when an existing build was reused) and the compiler's report."""
  path: Path
  seconds: float
  log: str


def nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
  candidates = ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else [])
  candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
  for c in candidates:
    if c and os.path.exists(c):
      return c
  raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")


_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_digest(src: Path, defines: Tuple[str, ...] = ()) -> str:
  """16 hex digits of the sha256 of the source, then of each header it
  includes with quotes (depth first, each once, resolved beside the file
  that includes it), then of the flags (and the `-D` defines, if any)."""
  digest = hashlib.sha256()
  seen = set()

  def add(path: Path):
    if path in seen:
      return
    seen.add(path)
    text = path.read_bytes()
    digest.update(text)
    for name in _QUOTED_INCLUDE.findall(text):
      add((path.parent / name.decode()).resolve())

  add(src.resolve())
  digest.update(" ".join(NVCC_FLAGS + _define_flags(defines)).encode())
  return digest.hexdigest()[:16]


def _define_flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
  return tuple(f"-D{d}" for d in defines)


def build(name: str, defines: Tuple[str, ...] = ()) -> Built:
  """Compile csrc/<name>.cu (with `-D` for each of `defines`) into
  build/kernels/lib<name>-<hash>.so."""
  src = CSRC / f"{name}.cu"
  lib = BUILD_DIR / f"lib{name}-{source_digest(src, defines)}.so"
  if lib.exists():
    return Built(lib, 0.0, "")
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = lib.with_suffix(f".{os.getpid()}.tmp")
  t0 = time.perf_counter()
  proc = subprocess.run([nvcc(), *NVCC_FLAGS, *_define_flags(defines), "-o",
                         str(tmp), str(src)],
                        capture_output=True, text=True, check=False)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed to build {src} (rc {proc.returncode}):"
                       f"\n{proc.stdout}{proc.stderr}")
  os.replace(tmp, lib)
  return Built(lib, time.perf_counter() - t0, proc.stdout + proc.stderr)


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
  """Build (or reuse) csrc/<name>.cu and load the library."""
  return ctypes.CDLL(str(build(name, defines).path))
