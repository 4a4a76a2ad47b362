"""The port's field modules (SkipConnMLP, CPEncoder, PositionalEncoder,
View) at narrow widths against flax `apply`, with the flax params
transplanted by `convert.params_from_flax`; plus the port-only pieces
around them (init kinds, cameras, checkpoints).

Tolerance: atol/rtol 1e-5, float32 on both sides (the JAX tests run at
matmul precision "highest"); the two differ only in summation order.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_atlas_tpu import nn as jnn  # noqa: E402
from nerf_atlas_tpu.data import cameras as jcams  # noqa: E402
from nerf_atlas_tpu.refl import brdf as jbrdf  # noqa: E402
from nerf_atlas_tpu_torch import convert  # noqa: E402
from nerf_atlas_tpu_torch import nn as tnn  # noqa: E402
from nerf_atlas_tpu_torch.data import cameras as tcams  # noqa: E402
from nerf_atlas_tpu_torch.refl import brdf as tbrdf  # noqa: E402
from nerf_atlas_tpu_torch.train import checkpoints  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _np_tree(params):
  return jax.tree.map(np.asarray, params)


def _pts(seed, n=48):
  # covers the CP bbox clamp: coordinates past ±1
  return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3)).astype(
      np.float32)


def _apply_both(jmod, tmod, *args, **kwargs):
  params = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, args),
                     **{k: jnp.asarray(v) for k, v in kwargs.items()})
  tmod.load_state_dict(convert.params_from_flax(_np_tree(params)))
  j = np.asarray(jmod.apply(params, *map(jnp.asarray, args),
                            **{k: jnp.asarray(v) for k, v in kwargs.items()}))
  with torch.no_grad():
    t = tmod(*map(torch.from_numpy, args),
             **{k: torch.from_numpy(v) for k, v in kwargs.items()})
  return t.numpy(), j


@pytest.mark.parametrize("init_kind", ["xavier", "kaiming", "siren"])
def test_skipconn_mlp_matches_flax(init_kind):
  kw = dict(in_size=3, out=4, num_layers=5, hidden_size=16, skip=3,
            init_kind=init_kind)
  t, j = _apply_both(jnn.SkipConnMLP(**kw), tnn.SkipConnMLP(**kw), _pts(0))
  np.testing.assert_allclose(t, j, **TOL)


def test_skipconn_mlp_with_encoder_and_latent_matches_flax():
  x = _pts(1)
  lat = np.random.default_rng(2).normal(size=(48, 5)).astype(np.float32)
  jm = jnn.SkipConnMLP(in_size=3, out=2, latent_size=5, num_layers=4,
                       hidden_size=16, skip=2,
                       enc=jnn.PositionalEncoder(input_dims=3, num_freqs=4))
  tm = tnn.SkipConnMLP(in_size=3, out=2, latent_size=5, num_layers=4,
                       hidden_size=16, skip=2,
                       enc=tnn.PositionalEncoder(input_dims=3, num_freqs=4))
  t, j = _apply_both(jm, tm, x, lat)
  np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("log_sampling,include_input",
                         [(True, False), (False, True)])
def test_positional_encoder_matches_flax(log_sampling, include_input):
  kw = dict(input_dims=3, max_freq_log2=6, num_freqs=10,
            log_sampling=log_sampling, include_input=include_input)
  x = _pts(3)
  j = np.asarray(jnn.PositionalEncoder(**kw).apply({}, jnp.asarray(x)))
  t = tnn.PositionalEncoder(**kw)(torch.from_numpy(x)).numpy()
  assert t.shape[-1] == tnn.PositionalEncoder(**kw).size()
  np.testing.assert_allclose(t, j, **TOL)


def test_cp_encoder_matches_flax():
  kw = dict(resolutions=(4, 8, 16), rank=2)
  x = _pts(4, 64)
  x[0] = [1.0, -1.0, 0.0]          # exactly on the bbox corners
  jm = jnn.CPEncoder(dtype=jnp.float32, **kw)
  params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
  tm = tnn.CPEncoder(**kw)
  tm.load_state_dict(convert.params_from_flax(_np_tree(params)))
  j = np.asarray(jm.apply(params, jnp.asarray(x)))
  with torch.no_grad():
    t = tm(torch.from_numpy(x).reshape(8, 8, 3))
  assert t.shape == (8, 8, 6)
  np.testing.assert_allclose(t.reshape(64, 6).numpy(), j, **TOL)


def test_view_refl_matches_flax():
  rng = np.random.default_rng(5)
  x = _pts(5, 32)
  view = rng.normal(size=(32, 3)).astype(np.float32)
  lat = rng.normal(size=(32, 6)).astype(np.float32)
  kw = dict(latent_size=6, hidden_size=16, num_layers=3, act="normal")
  jm = jbrdf.View(**kw)
  params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                   view=jnp.asarray(view), latent=jnp.asarray(lat))
  tm = tbrdf.load_refl("view", **kw)
  tm.load_state_dict(convert.params_from_flax(_np_tree(params)))
  j = np.asarray(jm.apply(params, jnp.asarray(x), view=jnp.asarray(view),
                          latent=jnp.asarray(lat)))
  with torch.no_grad():
    t = tm(torch.from_numpy(x), view=torch.from_numpy(view),
           latent=torch.from_numpy(lat)).numpy()
  np.testing.assert_allclose(t, j, **TOL)
  with pytest.raises(NotImplementedError):
    tbrdf.load_refl("rusin")


@torch.no_grad()
def test_init_kinds_follow_flax_distributions():
  g = torch.Generator().manual_seed(0)
  fan_in, w0 = 256, 30.0
  for kw, check in [
      (dict(init_kind="siren"),
       lambda m: (m.layer_in.weight.abs().max() <= 1 / 35 + 1e-7
                  and m.layer_1.weight.abs().max()
                  <= np.sqrt(6 / fan_in) / w0 + 1e-7)),
      (dict(zero_last=True), lambda m: m.layer_out.weight.abs().max() == 0),
      (dict(uniform_last=True),
       lambda m: 0 < m.layer_out.weight.abs().max() <= 1e-3),
      (dict(init_kind="zero"), lambda m: m.layer_1.weight.abs().max() == 0),
      (dict(init_kind="kaiming"),
       lambda m: abs(float(m.layer_1.weight.std()) * np.sqrt(fan_in / 2)
                     - 1.0) < 0.05),
      (dict(init_kind="xavier"),
       lambda m: m.layer_1.weight.abs().max() <= np.sqrt(6 / 512) + 1e-7),
  ]:
    m = tnn.SkipConnMLP(in_size=3, out=4, enc=tnn.CPEncoder(), **kw)
    m.reset_parameters(g)
    assert bool(check(m)), kw
    assert all(float(layer.bias.abs().max()) == 0
               for layer in [m.layer_in, m.layer_out, *m.hidden_layers()])
  with pytest.raises(NotImplementedError):
    tnn.SkipConnMLP(init_kind="orthogonal")
  # a seed gives the same weights every time
  a = tnn.SkipConnMLP(hidden_size=8)
  b = tnn.SkipConnMLP(hidden_size=8)
  a.reset_parameters(torch.Generator().manual_seed(3))
  b.reset_parameters(torch.Generator().manual_seed(3))
  assert torch.equal(a.layer_0.weight, b.layer_0.weight)


def test_camera_rays_match_jax():
  rng = np.random.default_rng(6)
  poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
  poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(3, 3, 3)))[0]
  poses[:, :3, 3] = rng.normal(size=(3, 3))
  jc = jcams.NeRFCamera.from_json_transforms(jnp.asarray(poses), 0.69, 20)
  tc = tcams.NeRFCamera.from_json_transforms(poses, 0.69, 20)
  xs = np.arange(20, dtype=np.float32) + 0.5
  grid = np.stack(np.meshgrid(xs, xs, indexing="ij")[::-1], -1)
  np.testing.assert_allclose(
      tc.sample_positions(torch.from_numpy(grid), 20).numpy(),
      np.asarray(jc.sample_positions(jnp.asarray(grid), 20)), atol=1e-6)
  vidx = rng.integers(0, 3, (40,))
  xy = rng.uniform(0, 20, (40, 2)).astype(np.float32)
  np.testing.assert_allclose(
      tc.rays_at(torch.from_numpy(vidx), torch.from_numpy(xy), 20).numpy(),
      np.asarray(jc.rays_at(jnp.asarray(vidx), jnp.asarray(xy), 20)),
      atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
  m = tnn.SkipConnMLP(hidden_size=8, enc=tnn.CPEncoder(resolutions=(4,)))
  m.reset_parameters(torch.Generator().manual_seed(0))
  path = checkpoints.save(str(tmp_path / "ck" / "model.ckpt"),
                          m.state_dict(), config={"seed": 0}, step=7)
  raw = checkpoints.load(path)
  assert raw["step"] == 7
  with open(path + ".json") as f:
    assert json.load(f) == {"seed": 0}
  m2 = tnn.SkipConnMLP(hidden_size=8, enc=tnn.CPEncoder(resolutions=(4,)))
  m2.load_state_dict(raw["params"])
  for k, v in m.state_dict().items():
    assert torch.equal(v, m2.state_dict()[k]), k
