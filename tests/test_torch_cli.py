"""The port's own flag parser and its import hygiene.

- `nerf_atlas_tpu_torch/cli.py:arguments` parses the same namespaces as
  the root `runner.arguments` (the JAX package's entry point, which only
  this test imports) over the defaults, the quality sweep's recipes for
  plain_cp and plain_hash (scripts/tpu_quality_sweep.py:52-60, 161-167)
  and `--enc-kind ref-hash`; `_train_only_substrings` agrees too.
- An AST walk over every module of `nerf_atlas_tpu_torch/` (NeRFAE's
  kernel wrappers and regularizers included, the PNG decoder and the
  loaders) and over `chip_smoke.py` finds no import of jax, flax, optax,
  the JAX package, the root runner, imageio, cv2, PIL or matplotlib.
"""
import ast
import os

import pytest

pytest.importorskip("torch")

import runner as root_runner  # noqa: E402

from nerf_atlas_tpu_torch import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = ["-d", "synth", "--size", "48", "--num-views", "30", "--epochs",
          "1500", "--near", "2", "--far", "6", "--batch-size", "4096",
          "--steps", "64", "--loss-fns", "l2", "--seed", "0", "--outdir",
          "outputs/quality", "--nosave", "--valid-freq", "0"]
ARGVS = [
    [],
    ["--data-kind", "synthetic", "--model", "plain", "--enc-kind", "cp",
     "-lr", "1e-3", *RECIPE],
    ["--data-kind", "synthetic", "--model", "plain", "--enc-kind", "hash",
     "--hash-table-log2", "14", "-lr", "1e-3", *RECIPE],
    ["--data-kind", "synthetic", "--enc-kind", "ref-hash"],
    ["--train-parts", "refl", "occ", "--loss-fns", "l1", "rmse",
     "--color-spaces", "rgb", "hsv", "--smooth-n-ord", "1", "2"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_port_parser_matches_root_runner(argv):
  ours, root = cli.arguments(argv), root_runner.arguments(argv)
  assert vars(ours) == vars(root)
  assert (cli._train_only_substrings(ours.train_parts)
          == root_runner._train_only_substrings(root.train_parts))


def test_param_file_raises():
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    cli.arguments(["--param-file", "x.json"])


# the JAX side, and the image packages the GPU machine does not have
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerf_atlas_tpu", "runner",
             "imageio", "cv2", "PIL", "matplotlib")


def _imports(path):
  tree = ast.parse(open(path).read(), path)
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module


def _port_files():
  root = os.path.join(REPO, "nerf_atlas_tpu_torch")
  files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
           if f.endswith(".py")]
  return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_port_and_chip_smoke_import_no_jax_and_no_root_runner():
  files = _port_files()
  assert len(files) >= 42, files
  names = {os.path.relpath(f, REPO) for f in files}
  assert {"nerf_atlas_tpu_torch/ops/kernels/render_ae.py",
          "nerf_atlas_tpu_torch/ops/kernels/render.py",
          "nerf_atlas_tpu_torch/ops/kernels/render_volsdf.py",
          "nerf_atlas_tpu_torch/ops/mip.py",
          "nerf_atlas_tpu_torch/train/regularizers.py",
          "nerf_atlas_tpu_torch/models/nerf.py",
          "nerf_atlas_tpu_torch/models/sdf.py",
          "nerf_atlas_tpu_torch/models/volsdf.py",
          "nerf_atlas_tpu_torch/models/dyn.py",
          "nerf_atlas_tpu_torch/ops/bezier.py",
          "nerf_atlas_tpu_torch/ops/march.py",
          "nerf_atlas_tpu_torch/ops/kernels/render_dyn.py",
          "nerf_atlas_tpu_torch/ops/sampling.py",
          "nerf_atlas_tpu_torch/train/driver.py",
          "nerf_atlas_tpu_torch/data/image_io.py",
          "nerf_atlas_tpu_torch/data/loaders.py",
          "nerf_atlas_tpu_torch/data/cameras.py",
          "nerf_atlas_tpu_torch/nn/misc.py",
          "nerf_atlas_tpu_torch/runner.py"} <= names
  for path in files:
    for name in _imports(path):
      top = name.split(".")[0]
      assert top not in FORBIDDEN, (os.path.relpath(path, REPO), name)
