"""The port's eval slice end to end on the CPU against the JAX package.

- the procedural dataset (size 16, 2 views) against
  `nerf_atlas_tpu.data.synthetic.dataset`: atol 1e-5 (float32 rendering of
  the same analytic scene, sums in another order);
- `nerf_atlas_tpu_torch.runner.main(..., device="cpu")` restoring a
  checkpoint transplanted from JAX params, against the JAX `driver.test`
  on the same params and data: per-view PSNR within 0.01 dB;
- the package imports no jax/flax/optax.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from nerf_atlas_tpu import data as jdata  # noqa: E402
from nerf_atlas_tpu import models as jmodels  # noqa: E402
from nerf_atlas_tpu.data import sampler as jsampler  # noqa: E402
from nerf_atlas_tpu.data import synthetic as jsynth  # noqa: E402
from nerf_atlas_tpu.train import driver as jdriver  # noqa: E402
from nerf_atlas_tpu_torch import convert, runner  # noqa: E402
from nerf_atlas_tpu_torch.data import synthetic as tsynth  # noqa: E402
from nerf_atlas_tpu_torch.train import checkpoints, driver  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, VIEWS, STEPS = 16, 2, 16


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_dataset_matches_jax(seed):
  imgs_j, cam_j, _ = jsynth.dataset(num_views=VIEWS, size=SIZE, seed=seed)
  imgs_t, cam_t, lights = tsynth.dataset(num_views=VIEWS, size=SIZE,
                                         seed=seed)
  assert lights is None and imgs_t.shape == (VIEWS, SIZE, SIZE, 4)
  np.testing.assert_allclose(cam_t.cam_to_world.numpy(),
                             np.asarray(cam_j.cam_to_world), atol=1e-6)
  np.testing.assert_allclose(float(cam_t.focal), float(cam_j.focal),
                             rtol=1e-7)
  np.testing.assert_allclose(imgs_t, np.asarray(imgs_j), atol=1e-5, rtol=0)
  assert imgs_t[..., 3].max() > 0.5        # the spheres are in view


def test_runner_slice_matches_jax_driver_test(tmp_path):
  """A JAX PlainNeRF-CP (seeded init) transplanted into a port checkpoint;
  both packages render and score the same views."""
  jmodel = jmodels.PlainNeRF(steps=STEPS)
  bundle = jdata.load("", data_kind="synthetic", training=True, size=SIZE,
                      num_views=VIEWS)
  jds = jsampler.RayDataset.from_bundle(bundle, size=SIZE)
  params = jdriver.init_model(jmodel, jds, seed=3)
  ckpt = checkpoints.save(
      str(tmp_path / "model.ckpt"),
      convert.params_from_flax(jax.tree.map(np.asarray, params)))

  outdir = tmp_path / "port"
  res = runner.main(["--data-kind", "synthetic", "--size", str(SIZE),
                     "--num-views", str(VIEWS), "--steps", str(STEPS),
                     "--epochs", "0", "--test-crop-size", str(SIZE),
                     "--load", ckpt, "--outdir", str(outdir)],
                    device="cpu")

  tbundle = jdata.load("", data_kind="synthetic", training=False, size=SIZE,
                       num_views=VIEWS)
  jtds = jsampler.RayDataset.from_bundle(tbundle, size=SIZE)
  for split, ds in (("train", jds), ("test", jtds)):
    ref = jdriver.test(jmodel, params, ds, out_dir=str(tmp_path / split),
                       chunk=SIZE * SIZE, save_images=False)
    np.testing.assert_allclose(res[split]["psnrs"], ref["psnrs"], atol=0.01)
    with open(outdir / split / "results.txt") as f:
      lines = f.read().splitlines()
    assert lines[0].startswith("view 000: PSNR ")
    assert lines[-1] == res[split]["summary"]
    assert np.isfinite(res[split]["psnr_mean"])
    import imageio.v2 as imageio
    png = imageio.imread(outdir / split / "test_001.png")
    assert png.shape == (SIZE, SIZE, 3) and png.dtype == np.uint8
  with open(outdir / "log.json") as f:
    assert json.load(f)["load"] == ckpt


def test_render_view_modes_match_jax():
  """depth/acc go through the port's PlainNeRF forward; rgb through the
  kernel wrapper (its CPU reference here)."""
  jmodel = jmodels.PlainNeRF(steps=STEPS, sky_kind="white")
  bundle = jdata.load("", data_kind="synthetic", training=True, size=8,
                      num_views=1)
  jds = jsampler.RayDataset.from_bundle(bundle, size=8)
  params = jdriver.init_model(jmodel, jds, seed=4)
  from nerf_atlas_tpu_torch import models as tmodels
  from nerf_atlas_tpu_torch.data import loaders, sampler
  tmodel = tmodels.PlainNeRF(steps=STEPS, sky_kind="white")
  tmodel.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  tds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=8, num_views=1), size=8)
  for mode, atol in (("rgb", 2e-4), ("acc", 2e-4), ("depth", 1e-3)):
    j = jdriver.render_view(jmodel, params, jds, 0, chunk=64, mode=mode)
    t = driver.render_view(tmodel, tds, 0, chunk=24, mode=mode)
    assert t.shape == j.shape, mode
    np.testing.assert_allclose(t, j, atol=atol, rtol=0, err_msg=mode)
  with pytest.raises(KeyError, match="normals"):    # an SDF model's map
    driver.render_view(tmodel, tds, 0, mode="normals")


def test_write_png_roundtrips(tmp_path):
  import imageio.v2 as imageio
  rng = np.random.default_rng(0)
  for shape in ((5, 7), (5, 7, 3), (5, 7, 4)):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / f"img{len(shape)}.png")
    driver.write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path), img)


@pytest.mark.parametrize("argv,error", [
    (["--epochs", "5", "--crop-size", "8"], NotImplementedError),
    (["--epochs", "5", "--mesh-devices", "4"], NotImplementedError),
    (["--epochs", "5", "--data-parallel"], NotImplementedError),
    # the smoothing options and --depth-query-normal run since the SDF
    # family's slice (tests/test_torch_sdf_train.py)
    (["--epochs", "5", "--omit-bg"], NotImplementedError),
    (["--epochs", "5", "--train-parts", "refl"], NotImplementedError),
    (["--param-file", "x.json"], NotImplementedError),
    (["--model", "coarse_fine", "--enc-kind", "ref-hash"],
     NotImplementedError),
    (["--enc-kind", "ref-hash"], NotImplementedError),
    (["--model", "voxel"], NotImplementedError),
    (["--data-kind", "dnerf"], NotImplementedError),
    (["--normals-from-depth"], NotImplementedError),
])
def test_runner_rejects_what_is_not_ported(argv, error, tmp_path):
  base = ["--data-kind", "synthetic", "--size", "4", "--num-views", "1",
          "--epochs", "0", "--outdir", str(tmp_path)]
  with pytest.raises(error):
    runner.main(base + argv, device="cpu")


def test_runner_needs_cuda_by_default(tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is present")
  with pytest.raises(RuntimeError, match="CUDA"):
    runner.main(["--epochs", "0", "--outdir", str(tmp_path)])


def test_port_imports_no_jax():
  code = (
      "import pkgutil, importlib, sys\n"
      "import nerf_atlas_tpu_torch as p\n"
      "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
      "p.__name__ + '.')]\n"
      "for m in mods: importlib.import_module(m)\n"
      "bad = sorted(m for m in sys.modules "
      "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
      "assert len(mods) >= 20, mods\n"
      "named = {p.__name__ + '.' + m for m in ('ops.mip', 'models.nerf', "
      "'ops.kernels.render', 'ops.kernels.render_ae', "
      "'ops.kernels.hash_encode', 'ops.sampling')}\n"
      "assert named <= set(mods), named - set(mods)\n"
      "assert not bad, bad\n")
  env = dict(os.environ, PYTHONPATH=REPO)
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr
