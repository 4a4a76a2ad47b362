"""The VolSDF training slice in the port, on the CPU against the JAX
package: the three train paths with the eikonal, the gates, the runner.

- Three train steps of each port path at the quality sweep's
  volsdf_eikonal recipe (`--sdf-eikonal 0.01`, `--sigmoid-kind
  upshifted`): the one-kernel step (K8b in loss mode with the eikonal
  inside), the two-kernel path through `VolSDFRender` with
  `--volsdf-scale-decay 1e-3` (K8f's eikonal column and the scale outside
  the kernels), and `--no-fused` (the module's out["eikonal"] and
  out["scale"]), on injected batches, against the same three steps
  composed in JAX (oracle value_and_grad + the JAX package's optax
  chain): each step's loss 1e-5 relative, each gradient tensor 1e-4
  relative, the raw scale included. Each step's batch keeps the rays
  `testing.volsdf_kink_free_rays` clears at that step's weights, and the
  port's weights are set to the JAX trajectory's before each step, as in
  tests/test_torch_ae_train.py (which says why); the last Adam update,
  from the weights both sides share, is held against optax's to 1e-2 of
  the learning rate. B's gradient is zero on both sides; with weight
  decay both optimizers shrink it (`test_fixed_fourier_matrix_...`).
- The gates engage the one-kernel step for the recipe, the two-kernel
  path with the scale decay or a non-l2 loss, and refuse the other SDF
  kinds' options, the ident scale, normals without the eikonal, density
  noise and more steps than K8b holds; `check_config` allows the eikonal
  and the scale decay for a VolSDF only.
- The runner trains and renders `--model volsdf` on the CPU at a tiny
  size through each path; the options not ported raise, naming their
  ROADMAP items.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, runner, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_volsdf as k8  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402

STEPS = 16
EIKONAL = 0.01
SCALE_DECAY = 1e-3


def _rays(n, seed):
  rng = np.random.default_rng(seed)
  o = rng.normal(size=(n, 3))
  o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
  d = -o / 4.0 + rng.normal(size=(n, 3)) * 0.15
  return np.concatenate([o, d], -1).astype(np.float32)


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


@functools.lru_cache(maxsize=None)
def _jax_oracle():
  """The JAX VolSDF of the recipe and its jitted value_and_grad of
  (params, rays, pix, scale decay) -> l2 + eikonal + scale decay · s,
  compiled once for every case (the batches keep KEEP rays)."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  from nerf_atlas_tpu.train import losses as jlosses
  jmodel = jmodels.VolSDF(sdf_kind="mlp", refl_kind="view", steps=STEPS,
                          t_near=2.0, t_far=6.0, with_normals=True,
                          sigmoid_kind="upshifted")
  loss_fn = jlosses.load_loss_fn()

  def fn(p, rays, pix, scale_decay):
    with jax.default_matmul_precision("highest"):
      out = jmodel.apply(p, rays)
      return (loss_fn(out["rgb"], pix) + EIKONAL * out["eikonal"]
              + scale_decay * out["scale"])

  return jmodel, jax.jit(jax.value_and_grad(fn))


KEEP = 12


@pytest.mark.parametrize("path", ["fused-one-kernel", "fused", "oracle"])
def test_three_steps_match_jax(path, monkeypatch):
  """Each step's loss (main + regularizers) and gradients against the
  JAX oracle + optax on injected batches, the eval grid as the step's
  ts."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import optim as joptim
  from nerf_atlas_tpu_torch.ops import rays as trays
  n, lr = 48, 3e-4
  scale_decay = 0.0 if path == "fused-one-kernel" else SCALE_DECAY
  rng = np.random.default_rng(3)
  batches = [(_rays(n, 10 + i), rng.uniform(0, 1, (n, 4)).astype(np.float32))
             for i in range(3)]
  jmodel, value_and_grad = _jax_oracle()
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
  ref_steps, kept, trajectory = [], [], []
  for rays, pix in batches:
    trajectory.append(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    keep = testing.volsdf_kink_free_rays(
        trajectory[-1], torch.from_numpy(rays), _jax_ts(), STEPS,
        exact_features=True).numpy()
    clear = np.flatnonzero(keep)[:KEEP]    # ~40% of the rays are clear
    assert clear.shape == (KEEP,)
    rays, pix = rays[clear], pix[clear]
    kept.append((rays, pix))
    loss, jgrads = value_and_grad(params, jnp.asarray(rays),
                                  jnp.asarray(pix), scale_decay)
    grads = convert.params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert float(grads[k8.B_KEY].abs().max()) == 0.0     # B: stop_gradient
    ref_steps.append((float(loss), grads))
    updates, state = tx.update(jgrads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)

  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: _jax_ts())
  model = models.VolSDF(steps=STEPS, with_normals=True,
                        sigmoid_kind="upshifted")
  model.load_state_dict(convert.params_from_flax(tree))
  ds = _InjectedBatches(kept)
  cfg = driver.TrainConfig(steps=10, batch_size=n, learning_rate=lr,
                           reg_coeffs={"eikonal": EIKONAL,
                                       "volsdf_scale": scale_decay},
                           no_fused=path == "oracle")
  opt = optim.load_optimizer(model.parameters(), "adam", lr, total_steps=10)
  seen = []
  inner = opt.step

  def record():
    seen.append({k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None})
    inner()

  opt.step = record
  fused_step = driver._fused_step_fn(model, cfg, ds)
  fused_train = driver._fused_train_fn(model, cfg, ds)
  assert (fused_step is not None) == (path == "fused-one-kernel")
  assert (fused_train is None) == (path == "oracle")
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
    assert set(seen[i]) == set(grads_j)
    assert not seen[i][k8.B_KEY].any()         # B: a zero gradient, as in JAX
    for key, grad in seen[i].items():
      if key == k8.B_KEY:
        continue
      ref = grads_j[key]
      err = float((grad - ref).norm() / ref.norm())
      assert err <= 1e-4, (path, i, key, err)
  # the third update, from the same weights on both sides: the port's Adam
  # (its moments from its own three gradients) against optax's
  final = convert.params_from_flax(jax.tree.map(np.asarray, params))
  for key, p in model.state_dict().items():
    update = p - trajectory[-1][key]
    err = float((update - (final[key] - trajectory[-1][key])).abs().max())
    assert err <= 1e-2 * lr, (path, key, err / lr)


def test_fixed_fourier_matrix_steps_as_in_jax():
  """optax steps every parameter, the stop-gradient B with its zero
  gradient too: under adamw's weight decay B shrinks in both packages."""
  from nerf_atlas_tpu.train import optim as joptim
  import jax.numpy as jnp
  lr, wd = 1e-3, 1e-2
  model = driver.init_model(models.VolSDF(steps=STEPS,
                                          sigmoid_kind="upshifted"), seed=0)
  b0 = model.shape.mlp.enc.B.detach().clone()
  rng = np.random.default_rng(0)
  ds = _InjectedBatches([(_rays(8, 1),
                          rng.uniform(0, 1, (8, 4)).astype(np.float32))])
  cfg = driver.TrainConfig(steps=10, batch_size=8, learning_rate=lr,
                           opt_kind="adamw", weight_decay=wd, no_fused=True)
  opt = optim.load_optimizer(model.parameters(), "adamw", lr, total_steps=10,
                             weight_decay=wd)
  driver.make_train_step(model, ds, losses.load_loss_fn(), opt, cfg)(
      0, torch.Generator().manual_seed(0))
  tx = joptim.load_optimizer("adamw", lr, total_steps=10, weight_decay=wd)
  b = jnp.asarray(b0.numpy())
  update, _ = tx.update(jnp.zeros_like(b), tx.init(b), b)
  got = model.shape.mlp.enc.B.detach().numpy()
  np.testing.assert_allclose(got, np.asarray(b + update), rtol=1e-6)
  assert not np.array_equal(got, b0.numpy())


def _dataset():
  from nerf_atlas_tpu_torch.data import loaders, sampler
  return sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=8, num_views=2), size=8)


def test_gates_engage_the_volsdf_paths():
  ds = _dataset()

  def model_of(**kw):
    kw.setdefault("with_normals", True)
    return driver.init_model(models.VolSDF(steps=STEPS, **kw), seed=0)

  model = model_of(sigmoid_kind="upshifted")
  assert driver._fused_enc_kind(model) == "volsdf"
  recipe = driver.TrainConfig(reg_coeffs={"eikonal": EIKONAL})
  assert driver._fused_step_fn(model, recipe, ds) is not None
  assert driver._fused_train_fn(model, recipe, ds) is not None
  assert driver._fused_render_fn(model) is not None
  for cfg in (driver.TrainConfig(reg_coeffs={"eikonal": EIKONAL,
                                             "volsdf_scale": 1e-3}),
              driver.TrainConfig(loss_kinds=("l1",),
                                 reg_coeffs={"eikonal": EIKONAL})):
    assert driver._fused_step_fn(model, cfg, ds) is None    # two kernels
    assert driver._fused_train_fn(model, cfg, ds) is not None
  no_eik = driver.TrainConfig()
  assert driver._fused_step_fn(model, no_eik, ds) is None   # normals, no eik
  assert driver._fused_train_fn(model, no_eik, ds) is None
  plain_sdf = model_of(with_normals=False)
  assert driver._fused_step_fn(plain_sdf, no_eik, ds) is not None
  off = driver.TrainConfig(no_fused=True, reg_coeffs={"eikonal": EIKONAL})
  assert driver._fused_step_fn(model, off, ds) is None
  assert driver._fused_train_fn(model, off, ds) is None
  for kw in (dict(scale_kind="ident"), dict(sdf_kwargs={"enc_freqs": 16}),
             dict(sdf_kwargs={"sphere_init": True, "enc_sigma": 2.0}),
             dict(sigmoid_kind="softmax"), dict(mip="cone")):
    other = model_of(**kw)
    assert driver._fused_enc_kind(other) is None, kw
    assert driver._fused_step_fn(other, recipe, ds) is None, kw
    assert driver._fused_train_fn(other, recipe, ds) is None, kw
    assert driver._fused_render_fn(other) is None, kw
  for kw in (dict(density_noise=0.5),
             dict(steps=k8.BWD_MAX_STEPS + 1)):
    m = driver.init_model(models.VolSDF(with_normals=True, **kw), seed=0)
    assert driver._fused_step_fn(m, recipe, ds) is None, kw
    assert driver._fused_train_fn(m, recipe, ds) is None, kw
    assert driver._fused_render_fn(m) is not None, kw
  at_cap = driver.init_model(models.VolSDF(steps=k8.BWD_MAX_STEPS,
                                           with_normals=True), seed=0)
  assert driver._fused_step_fn(at_cap, recipe, ds) is not None
  no_sphere = model_of(sdf_kwargs={"sphere_init": False})
  assert driver._fused_enc_kind(no_sphere) == "volsdf"
  assert driver._kernel_kw(no_sphere)["sphere_init"] is False
  driver.check_config(driver.TrainConfig(reg_coeffs={
      "eikonal": 0.1, "volsdf_scale": 1e-3, "surface_eikonal": 0.1,
      "eikonal_random": 0.1}), "volsdf")       # the last two since the family
  for key in ("latent_l2", "smooth_occ", "view_variance"):
    with pytest.raises(NotImplementedError, match=key):
      driver.check_config(driver.TrainConfig(reg_coeffs={key: 0.1}),
                          "volsdf")
  with pytest.raises(NotImplementedError, match="volsdf_scale"):
    driver.check_config(driver.TrainConfig(reg_coeffs={"volsdf_scale": 1.0}),
                        "plain")
  assert driver.model_kind(model) == "volsdf"


def _run(tmp_path, name, *extra):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic", "--model", "volsdf",
                     "--sigmoid-kind", "upshifted", "--size", "16",
                     "--num-views", "4", "--steps", str(STEPS),
                     "--batch-size", "64", "-lr", "1e-3", "--seed", "0",
                     "--valid-freq", "0", "--nosave", "--outdir", str(out),
                     *extra], device="cpu")
  return res, out


@pytest.fixture(scope="module")
def untrained(tmp_path_factory):
  """The runner's scores of the seed-0 model before training."""
  return _run(tmp_path_factory.mktemp("volsdf"), "untrained", "--epochs",
              "0")[0]


@pytest.mark.parametrize("extra,path", [
    ((), "fused-one-kernel"), (("--volsdf-scale-decay", "1e-3"), "fused"),
    (("--no-fused",), "oracle")])
def test_runner_trains_volsdf_on_cpu(tmp_path, untrained, extra, path):
  res0 = untrained
  res, out = _run(tmp_path, "trained", "--epochs", "12", "--sdf-eikonal",
                  str(EIKONAL), *extra)
  assert res["engaged_path"] == path
  with open(out / "log.json") as f:
    logged = json.load(f)
  assert logged["engaged_path"] == path and logged["model"] == "volsdf"
  first = res["history"][0]
  if path == "fused-one-kernel":          # the kernel's loss holds both terms
    assert first["loss"] == first["mse"] > 0.0
  else:
    assert first["loss"] > first["mse"] > 0.0
  for split in ("train", "test"):
    assert all(np.isfinite(res[split]["psnrs"]))
    assert res[split]["psnr_mean"] > res0[split]["psnr_mean"] + 0.5
    lines = (out / split / "results.txt").read_text().splitlines()
    assert lines[-1].startswith("PSNR mean ")


def test_runner_renders_volsdf_and_raises_on_unported_options(tmp_path):
  res, _ = _run(tmp_path, "render", "--epochs", "0", "--no-sphere-init")
  assert "engaged_path" not in res and np.isfinite(res["test"]["psnr_mean"])
  # --ref-compat, the other shapes, --volsdf-alternate and the surface
  # eikonal run since the SDF family's slice (tests/test_torch_sdf_train.py)
  for flags, item in ((("--occ-kind", "all-learned"), "Queue 1 #13"),
                      (("--integrator-kind", "direct"), "Queue 1 #13"),
                      (("--light-kind", "field"), "Queue 1 #13"),
                      (("--epochs", "2", "--view-variance-weight", "0.1"),
                       "view_variance")):
    with pytest.raises(NotImplementedError, match=item):
      _run(tmp_path, "bad", "--epochs", "0", *flags)
