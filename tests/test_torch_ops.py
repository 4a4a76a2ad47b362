"""The port's render-core ops (nerf_atlas_tpu_torch.ops: math, rays,
integrate) against the JAX ops on the same numpy inputs.

Tolerance: atol 1e-6. Both sides compute in float32 with the same formulas,
so they differ only by last-place rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from nerf_atlas_tpu.ops import integrate as jint  # noqa: E402
from nerf_atlas_tpu.ops import math as jmath  # noqa: E402
from nerf_atlas_tpu.ops import rays as jrays  # noqa: E402
from nerf_atlas_tpu_torch.ops import integrate as tint  # noqa: E402
from nerf_atlas_tpu_torch.ops import math as tmath  # noqa: E402
from nerf_atlas_tpu_torch.ops import rays as trays  # noqa: E402

ATOL = 1e-6


def _close(t, j, atol=ATOL):
  np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _rays(rng, n=32):
  r_o = rng.uniform(-1, 1, (n, 3)) + np.array([0.0, 0.0, 3.5])
  r_d = rng.normal(size=(n, 3)) * 0.3 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(jmath.SIGMOID_KINDS))
def test_sigmoid_zoo_matches_jax(kind):
  v = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32) * 4
  _close(tmath.load_sigmoid(kind)(torch.from_numpy(v)),
         jmath.load_sigmoid(kind)(jnp.asarray(v)))


def test_unknown_sigmoid_raises():
  with pytest.raises(NotImplementedError):
    tmath.load_sigmoid("nope")


def test_dir_to_elev_azim_and_psnr_match_jax():
  rng = np.random.default_rng(1)
  d = rng.normal(size=(128, 3)).astype(np.float32)
  d[0] = [0.0, 0.0, 2.0]           # the clipped poles
  d[1] = [0.0, 0.0, -0.5]
  _close(tmath.dir_to_elev_azim(torch.from_numpy(d)),
         jmath.dir_to_elev_azim(jnp.asarray(d)))
  x = rng.uniform(1e-4, 1.0, (16,)).astype(np.float32)
  _close(tmath.mse2psnr(torch.from_numpy(x)), jmath.mse2psnr(jnp.asarray(x)))


@pytest.mark.parametrize("lindisp", [False, True])
def test_compute_ts_matches_jax(lindisp):
  _close(trays.compute_ts(2.0, 6.0, 64, lindisp=lindisp),
         jrays.compute_ts(2.0, 6.0, 64, lindisp=lindisp))
  _close(trays.compute_ts(2.0, 6.0, 8, lindisp=lindisp, batch_shape=(5,)),
         jrays.compute_ts(2.0, 6.0, 8, lindisp=lindisp, batch_shape=(5,)))


def test_compute_ts_perturb_stays_in_bins():
  g = torch.Generator().manual_seed(0)
  base = trays.compute_ts(2.0, 6.0, 16)
  mids = 0.5 * (base[:-1] + base[1:])
  lower = torch.cat([mids, base[-1:]])
  upper = torch.cat([base[:1], mids])
  ts = trays.compute_ts(2.0, 6.0, 16, perturb=1.0, generator=g,
                        batch_shape=(7,))
  assert ts.shape == (7, 16)
  lo, hi = torch.minimum(lower, upper), torch.maximum(lower, upper)
  assert bool(((ts >= lo - 1e-6) & (ts <= hi + 1e-6)).all())
  assert not torch.equal(ts[0], ts[1])    # per-ray draws differ
  with pytest.raises(ValueError):
    trays.compute_ts(2.0, 6.0, 16, perturb=1.0)


@pytest.mark.parametrize("per_ray_ts", [False, True])
def test_compute_pts_ts_matches_jax(per_ray_ts):
  rng = np.random.default_rng(2)
  rays = _rays(rng)
  if per_ray_ts:
    ts = np.sort(rng.uniform(2, 6, (rays.shape[0], 12)), -1).astype(np.float32)
    t_out = trays.compute_pts(torch.from_numpy(rays), torch.from_numpy(ts))
    j_out = jrays.compute_pts(jnp.asarray(rays), jnp.asarray(ts))
  else:
    t_out = trays.compute_pts_ts(torch.from_numpy(rays), 2.0, 6.0, 12)
    j_out = jrays.compute_pts_ts(jnp.asarray(rays), 2.0, 6.0, 12)
  assert len(t_out) == len(j_out)
  for t, j in zip(t_out, j_out):
    _close(t, j)


def test_compositing_chain_matches_jax():
  rng = np.random.default_rng(3)
  rays = _rays(rng, 16)
  r_d = rays[:, 3:]
  ts = np.linspace(2, 6, 24).astype(np.float32)
  density = rng.normal(size=(16, 24)).astype(np.float32) * 3
  rgb = rng.uniform(size=(16, 24, 3)).astype(np.float32)
  T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
  J = jnp.asarray
  _close(tint.exclusive_cumprod(T(rgb[..., 0])),
         jint.exclusive_cumprod(J(rgb[..., 0])))
  _close(tint.exclusive_cumprod(T(rgb), dim=1),
         jint.exclusive_cumprod(J(rgb), axis=1))
  _close(tint.dists_from_ts(T(ts)), jint.dists_from_ts(J(ts)))
  d_t = tint.dists_from_ts(T(ts), T(r_d))
  d_j = np.asarray(jint.dists_from_ts(J(ts), J(r_d)))
  _close(d_t[:, :-1], d_j[:, :-1])
  # the 1e10 tail, scaled by ||r_d||: compare relatively
  np.testing.assert_allclose(d_t[:, -1].numpy(), d_j[:, -1], rtol=1e-6)
  for softplus in (True, False):
    a_t, w_t = tint.alpha_from_density(T(density), T(ts), T(r_d),
                                       softplus=softplus)
    a_j, w_j = jint.alpha_from_density(J(density), J(ts), J(r_d),
                                       softplus=softplus)
    _close(a_t, a_j)
    _close(w_t, w_j)
  alpha = rng.uniform(size=(16, 24)).astype(np.float32)
  _close(tint.alpha_composite(T(alpha)), jint.alpha_composite(J(alpha)))
  w = np.asarray(w_j)
  _close(tint.volumetric_integrate(T(w), T(rgb)),
         jint.volumetric_integrate(J(w), J(rgb)))
  _close(tint.depth_from_weights(T(w), T(ts)),
         jint.depth_from_weights(J(w), J(ts)))
  _close(tint.leftover_transmittance(T(w)),
         jint.leftover_transmittance(J(w)))
  for kind in ("black", "white", "random"):
    _close(tint.load_sky(kind)(T(w)), jint.load_sky(kind)(J(w)))
  with pytest.raises(NotImplementedError):
    tint.load_sky("mlp")
