"""TinyNeRF's training trajectory at the quality sweep's tiny recipe
(scripts/tpu_quality_sweep.py: synthetic, 48 px, 30 views, batch 4096,
64 samples, -lr 1e-3, seed 0), on the CPU, the port against the JAX
package from the same start:

- the JAX package's seed-0 initial tree (`driver.init_model` on the
  recipe's data, as the root runner builds it), carried into the port by
  `convert.params_from_flax`;
- STEPS steps of each side on the same batches (the port's sampler, with
  pixel jitter) and the same stratified ts (the JAX module's own draw,
  handed to the port's step): the JAX oracle (value_and_grad of the
  module forward + the JAX package's Adam chain) against the port's
  one-kernel step (the plain K3 on the CPU) and its Adam, both with the
  cosine schedule over STEPS;
- each side keeps its own weights and optimizer state from the start
  (nothing is re-synced), and the port uses its own posenc bands.

It prints both loss curves every 25 steps, and with
TINY_TRAJECTORY_OUT=<path> writes every step's losses, and the largest
relative weight difference every 25 steps, to that JSON file. It holds
the first step's loss to 1e-4 relative, and the mean loss of each 25-step
window to 10% relative of JAX's: a fault in the sky, the density offset
or the update moves the curve off JAX's, and a plateau that JAX leaves
and the port does not fails the window test.

slow (500 steps of both sides take about 50 minutes on 8 CPU threads):
  JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_tiny_trajectory.py
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nerf_atlas_tpu_torch import convert, models  # noqa: E402
from nerf_atlas_tpu_torch.data import loaders, sampler  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402

STEPS = int(os.environ.get("TINY_TRAJECTORY_STEPS", "500"))
SIZE, VIEWS, BATCH, LR, SEED, WINDOW = 48, 30, 4096, 1e-3, 0, 25


class _Batches:
  """A RayDataset stand-in: `sample` hands out the batch set for the
  step (the port's step draws its batch through `ds.sample`)."""

  def __init__(self, pixels):
    self.pixels = pixels
    self.batch = None

  def sample(self, generator, batch_size, **kw):
    return self.batch[0], self.batch[1], None, None


@pytest.mark.slow
def test_tiny_trains_along_the_jax_trajectory(monkeypatch):
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  from nerf_atlas_tpu.data import loaders as jloaders
  from nerf_atlas_tpu.data import sampler as jsampler
  from nerf_atlas_tpu.train import driver as jdriver
  from nerf_atlas_tpu.train import losses as jlosses
  from nerf_atlas_tpu.train import optim as joptim
  torch.set_num_threads(os.cpu_count() or 1)

  jmodel = jmodels.TinyNeRF(steps=64, t_near=2.0, t_far=6.0)
  jds = jsampler.RayDataset.from_bundle(
      jloaders.load("", data_kind="synthetic", training=True, size=SIZE,
                    num_views=VIEWS), size=SIZE)
  params = jdriver.init_model(jmodel, jds, SEED)
  tx = joptim.load_optimizer("adam", LR, total_steps=STEPS)
  state = tx.init(params)
  loss_fn = jlosses.load_loss_fn()

  @jax.jit
  def jax_step(params, state, rays, pix, key):
    def fn(p):
      out = jmodel.apply(p, rays, train=True, rngs={"sampler": key})
      return loss_fn(out["rgb"], pix), out["ts"]
    (loss, ts), grads = jax.value_and_grad(fn, has_aux=True)(params)
    updates, state = tx.update(grads, state, params)
    return jax.tree.map(lambda p, u: p + u, params, updates), state, loss, ts

  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=SIZE, num_views=VIEWS),
      size=SIZE)
  # both sides train on the port's batches; its labels are JAX's to
  # float32 round-off of the procedural renderer
  np.testing.assert_allclose(ds.pixels.numpy(), np.asarray(jds.pixels),
                             atol=1e-5)
  model = models.TinyNeRF(steps=64, t_near=2.0, t_far=6.0)
  model.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  cfg = driver.TrainConfig(steps=STEPS, batch_size=BATCH, learning_rate=LR)
  opt = optim.load_optimizer(model.parameters(), "adam", LR,
                             total_steps=STEPS)
  injected = _Batches(ds.pixels)
  step_ts = {}
  monkeypatch.setattr(driver, "_step_ts",
                      lambda model, generator, device: step_ts["ts"])
  fused_step = driver._fused_step_fn(model, cfg, injected)
  assert fused_step is not None
  step = driver.make_train_step(model, injected, losses.load_loss_fn(), opt,
                                cfg, fused_step=fused_step)

  gen = torch.Generator().manual_seed(SEED)
  key = jax.random.PRNGKey(SEED + 1234)
  curve = {"jax": [], "port": [], "weight_rel_diff": []}
  for i in range(STEPS):
    rays, pix, _, _ = ds.sample(gen, BATCH, jitter=cfg.pixel_jitter)
    key, k = jax.random.split(key)
    params, state, loss_j, ts = jax_step(params, state, jnp.asarray(
        rays.numpy()), jnp.asarray(pix.numpy()), k)
    step_ts["ts"] = torch.from_numpy(np.array(ts))
    injected.batch = (rays, pix)
    loss_p = float(step(i, gen)["loss"])
    curve["jax"].append(float(loss_j))
    curve["port"].append(loss_p)
    if (i + 1) % WINDOW == 0:
      ref = convert.params_from_flax(jax.tree.map(np.asarray, params))
      rel = max(float((p - ref[k2]).norm() / ref[k2].norm())
                for k2, p in model.state_dict().items())
      curve["weight_rel_diff"].append(rel)
      print(f"step {i + 1:4d}  loss jax {np.mean(curve['jax'][-WINDOW:]):.6f}"
            f"  port {np.mean(curve['port'][-WINDOW:]):.6f}"
            f"  weights rel {rel:.3e}", flush=True)
  out = os.environ.get("TINY_TRAJECTORY_OUT")
  if out:
    with open(out, "w") as f:
      json.dump(curve, f)
  j, p = np.asarray(curve["jax"]), np.asarray(curve["port"])
  assert abs(p[0] - j[0]) <= 1e-4 * j[0], (p[0], j[0])
  jw = j[:len(j) // WINDOW * WINDOW].reshape(-1, WINDOW).mean(1)
  pw = p[:len(p) // WINDOW * WINDOW].reshape(-1, WINDOW).mean(1)
  np.testing.assert_allclose(pw, jw, rtol=0.1)
