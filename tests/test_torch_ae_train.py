"""The NeRFAE training slice in the port, on the CPU against the JAX
package: the three train paths with the latent L2, the gates, the
runner.

- Three train steps of each port path (the one-kernel step K7b in loss
  mode, the two-kernel path through `AERender`, and `--no-fused`) with
  `--latent-l2-weight 1e-3`, on injected batches, against the same three
  steps composed in JAX (oracle value_and_grad + the JAX package's optax
  chain): the loss of each step 1e-5 relative, each gradient tensor of
  each step 1e-4 relative. The fused paths add the point-sampled
  `ae_latent_l2` on injected points (the JAX side evaluates
  `regularizers.ae_latent_l2` on the same points), the oracle path the
  module's out["latent_l2"] (the JAX `total_regularizer`). The biases
  start from seeded random values (tests/test_torch_train.py says why).
  Each step's batch keeps the rays `testing.ae_kink_free_rays` clears at
  that step's weights: a leaky-relu input within round-off of 0 in one
  of ~600k moves a float32 gradient tensor by ~1e-3 from float64
  (measured on these batches: 9.7e-4 with such rays, 1.0e-5 without).
  Before each step the port's weights are set to the JAX trajectory's:
  Adam's first updates are ±lr by the sign of each gradient entry, and
  the entries whose float32 sums cancel to round-off take either sign in
  two implementations, which moves the next step's gradients by 1e-4 to
  3e-4 (measured at -lr 2e-5 to 5e-4). The port's optimizer still steps
  and keeps its moments, and its last update, from the weights both
  sides share, is held against optax's entry by entry to 1e-2 of the
  learning rate (measured: at most 3.9e-3 of it).
- The gates engage the AE paths for the quality sweep's recipe and
  refuse `normalize_latent=False`, `encoding_size=48` and density noise;
  `check_config` allows `latent_l2` for a NeRFAE and for nothing else.
- The runner trains and renders `--model ae` on the CPU at a tiny size;
  `--ref-compat` raises, naming its ROADMAP item.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, runner, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_ae as k7  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402
from nerf_atlas_tpu_torch.train import regularizers  # noqa: E402

STEPS = 16
LATENT_L2 = 1e-3


def _rays(n, seed):
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(size=(n, 3)) * 0.1
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


def _jax_ts():
  import jax.numpy as jnp
  return torch.from_numpy(np.array(jnp.linspace(2.0, 6.0, STEPS,
                                                dtype=jnp.float32)))


class _InjectedBatches:
  """A RayDataset stand-in whose `sample` hands out fixed batches."""

  def __init__(self, batches):
    self.batches = list(batches)
    self.pixels = torch.zeros(1, 1, 1, 4)

  def sample(self, generator, batch_size, **kw):
    rays, pix = self.batches.pop(0)
    return torch.from_numpy(rays), torch.from_numpy(pix), None, None


@pytest.mark.parametrize("path", ["fused-one-kernel", "fused", "oracle"])
def test_three_steps_match_jax(path, monkeypatch):
  """Each step's loss (main + regularizer) and gradients against the JAX
  oracle + optax on injected batches and injected regularizer points,
  the eval grid as the step's ts."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  from nerf_atlas_tpu.train import losses as jlosses
  from nerf_atlas_tpu.train import optim as joptim
  from nerf_atlas_tpu.train import regularizers as jreg
  from nerf_atlas_tpu_torch.ops import rays as trays
  n, lr = 32, 5e-4
  rng = np.random.default_rng(3)
  batches = [(_rays(n, 10 + i), rng.uniform(0, 1, (n, 4)).astype(np.float32))
             for i in range(3)]
  points = [rng.uniform(-1.3, 1.3, (64, 3)).astype(np.float32)
            for _ in range(3)]
  jmodel = jmodels.NeRFAE(steps=STEPS, t_near=2.0, t_far=6.0,
                          refl_kind="view", normalize_latent=True)
  tree = jax.tree.map(np.asarray, jmodel.init(
      {"params": jax.random.PRNGKey(5), "sampler": jax.random.PRNGKey(6)},
      jnp.asarray(batches[0][0]), train=True))
  tree = jax.tree_util.tree_map_with_path(
      lambda p, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                    if "bias" in jax.tree_util.keystr(p) else v), tree)
  out_layer = tree["params"]["refl"]["mlp"]["layer_out"]
  out_layer["kernel"] = out_layer["kernel"] * 40.0

  tx = joptim.load_optimizer("adam", lr, total_steps=10)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)
  loss_fn = jlosses.load_loss_fn()
  ref_steps, kept, trajectory = [], [], []
  for (rays, pix), pts in zip(batches, points):
    trajectory.append(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    keep = testing.ae_kink_free_rays(trajectory[-1], torch.from_numpy(rays),
                                     _jax_ts(), STEPS).numpy()
    assert keep.sum() >= n // 2
    rays, pix = rays[keep], pix[keep]
    kept.append((rays, pix))

    def fn(p, rays=rays, pix=pix, pts=pts):
      out = jmodel.apply(p, jnp.asarray(rays))
      main = loss_fn(out["rgb"], jnp.asarray(pix))
      if path == "oracle":
        return main + LATENT_L2 * out["latent_l2"]
      with monkeypatch.context() as m:
        m.setattr(jreg.jax.random, "uniform",
                  lambda key, shape, **kw: jnp.asarray(pts))
        return main + LATENT_L2 * jreg.ae_latent_l2(
            jmodel.apply, p, jax.random.PRNGKey(0), n=pts.shape[0])
    with jax.default_matmul_precision("highest"):
      loss, grads = jax.value_and_grad(fn)(params)
    ref_steps.append((float(loss), convert.params_from_flax(
        jax.tree.map(np.asarray, grads))))
    updates, state = tx.update(grads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)

  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: _jax_ts())
  drawn = [torch.from_numpy(p) for p in points]
  monkeypatch.setattr(regularizers, "uniform_points",
                      lambda generator, n: drawn.pop(0))
  model = models.NeRFAE(steps=STEPS)
  model.load_state_dict(convert.params_from_flax(tree))
  ds = _InjectedBatches(kept)
  cfg = driver.TrainConfig(steps=10, batch_size=n, learning_rate=lr,
                           reg_coeffs={"latent_l2": LATENT_L2},
                           no_fused=path == "oracle")
  opt = optim.load_optimizer(model.parameters(), "adam", lr, total_steps=10)
  seen = []
  inner = opt.step

  def record():
    seen.append({k: p.grad.clone() for k, p in model.named_parameters()})
    inner()

  opt.step = record
  fused_step = driver._fused_step_fn(model, cfg, ds)
  fused_train = driver._fused_train_fn(model, cfg, ds)
  assert (fused_step is None) == (path == "oracle")
  if path == "fused":
    fused_step = None
  step = driver.make_train_step(model, ds, losses.load_loss_fn(), opt, cfg,
                                fused_step=fused_step,
                                fused_train=fused_train)
  gen = torch.Generator().manual_seed(0)
  for i, (loss_j, grads_j) in enumerate(ref_steps):
    with torch.no_grad():
      model.load_state_dict(trajectory[i])
    metrics = step(i, gen)
    loss = float(metrics["loss"])
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (path, i, loss, loss_j)
    assert float(metrics["mse"]) < loss               # mse = the main term
    for key, ref in grads_j.items():
      err = float((seen[i][key] - ref).norm() / ref.norm())
      assert err <= 1e-4, (path, i, key, err)
  if path != "oracle":
    assert not drawn                           # one draw per step
  # the third update, from the same weights on both sides: the port's Adam
  # (its moments from its own three gradients) against optax's
  final = convert.params_from_flax(jax.tree.map(np.asarray, params))
  for key, p in model.state_dict().items():
    update = p - trajectory[-1][key]
    err = float((update - (final[key] - trajectory[-1][key])).abs().max())
    assert err <= 1e-2 * lr, (path, key, err / lr)


def _dataset():
  from nerf_atlas_tpu_torch.data import loaders, sampler
  return sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=8, num_views=2), size=8)


def test_gates_engage_the_ae_paths():
  ds = _dataset()
  model = driver.init_model(models.NeRFAE(steps=STEPS), seed=0)
  assert driver._fused_enc_kind(model) == "ae"
  recipe = driver.TrainConfig(reg_coeffs={"latent_l2": 1e-3})
  assert driver._fused_step_fn(model, recipe, ds) is not None
  assert driver._fused_train_fn(model, recipe, ds) is not None
  assert driver._fused_render_fn(model) is not None
  l1 = driver.TrainConfig(loss_kinds=("l1",), reg_coeffs={"latent_l2": 1e-3})
  assert driver._fused_step_fn(model, l1, ds) is None
  assert driver._fused_train_fn(model, l1, ds) is not None
  for kw in (dict(normalize_latent=False), dict(encoding_size=48)):
    other = driver.init_model(models.NeRFAE(steps=STEPS, **kw), seed=0)
    assert driver._fused_enc_kind(other) is None, kw
    assert driver._fused_step_fn(other, recipe, ds) is None, kw
    assert driver._fused_train_fn(other, recipe, ds) is None, kw
    assert driver._fused_render_fn(other) is None, kw
  noisy = driver.init_model(models.NeRFAE(steps=STEPS, density_noise=0.5),
                            seed=0)
  assert driver._fused_step_fn(noisy, recipe, ds) is None
  assert driver._fused_train_fn(noisy, recipe, ds) is None
  assert driver._fused_render_fn(noisy) is not None   # eval has no noise
  # latent_l2 belongs to NeRFAE: the plain model's gates and config refuse
  plain = driver.init_model(models.PlainNeRF(steps=STEPS), seed=0)
  assert driver._fused_step_fn(plain, recipe, ds) is None
  driver.check_config(recipe, "ae")
  with pytest.raises(NotImplementedError, match="latent_l2"):
    driver.check_config(recipe, "plain")
  with pytest.raises(NotImplementedError, match="eikonal"):
    driver.check_config(driver.TrainConfig(reg_coeffs={"eikonal": 0.1}), "ae")
  assert driver.model_kind(model) == "ae"
  assert driver.model_kind(plain) == "plain"
  with pytest.raises(KeyError):
    k7.pack_weights_ae(plain.state_dict())         # a plain tree is no AE's
  sd = dict(model.state_dict())
  sd["encode.layer_out.weight"] = sd["encode.layer_out.weight"][:16]
  with pytest.raises(ValueError):
    k7.pack_weights_ae(sd)


def test_ae_defaults_and_unported_options():
  model = models.NeRFAE()
  assert (model.encoding_size, model.normalize_latent, model.refl_kind) == (
      32, True, "view")
  assert model.encode.init_size == 51 and model.encode.hidden_size == 256
  assert model.density_tfm.num_layers == 4
  assert model.density_tfm.hidden_size == 128
  assert model.refl.mlp.init_size == 69
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    models.NeRFAE(refl_kind="basic")
  assert models.load_model("ae").encoding_size == 32


def _run(tmp_path, name, *extra):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic", "--model", "ae",
                     "--normalize-latent", "--size", "16", "--num-views",
                     "4", "--steps", str(STEPS), "--batch-size", "64", "-lr",
                     "1e-3", "--seed", "0", "--valid-freq", "0", "--outdir",
                     str(out), *extra], device="cpu")
  return res, out


@pytest.mark.parametrize("extra,path", [
    ((), "fused-one-kernel"), (("--no-fused",), "oracle")])
def test_runner_trains_ae_on_cpu(tmp_path, extra, path):
  res0, _ = _run(tmp_path, "untrained", "--epochs", "0")
  res, out = _run(tmp_path, "trained", "--epochs", "12",
                  "--latent-l2-weight", "1e-3", *extra)
  assert res["engaged_path"] == path
  with open(out / "log.json") as f:
    logged = json.load(f)
  assert logged["engaged_path"] == path
  assert logged["model"] == "ae" and logged["normalize_latent"]
  first = res["history"][0]
  assert first["loss"] > first["mse"] > 0.0
  for split in ("train", "test"):
    assert all(np.isfinite(res[split]["psnrs"]))
    assert res[split]["psnr_mean"] > res0[split]["psnr_mean"] + 0.5
    lines = (out / split / "results.txt").read_text().splitlines()
    assert lines[-1].startswith("PSNR mean ")


def test_runner_ae_ref_compat_and_other_models_raise(tmp_path):
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    _run(tmp_path, "ref", "--epochs", "0", "--ref-compat")
  with pytest.raises(NotImplementedError, match="--model voxel"):
    runner.main(["--data-kind", "synthetic", "--model", "voxel", "--size",
                 "4", "--num-views", "1", "--epochs", "0", "--outdir",
                 str(tmp_path / "v")], device="cpu")
  with pytest.raises(NotImplementedError, match="latent_l2"):
    runner.main(["--data-kind", "synthetic", "--size", "4", "--num-views",
                 "1", "--epochs", "2", "--latent-l2-weight", "1e-3",
                 "--outdir", str(tmp_path / "p")], device="cpu")
