"""The D-NeRF training slice in the port, on the CPU against the JAX
package: the three train paths, the gates, the runner.

- Three train steps of each port path, on injected batches with each
  ray's time, against the same three steps composed in JAX (oracle
  value_and_grad + the JAX package's optax chain): the one-kernel step
  (K9b in loss mode) at the dnerf_dx recipe and at the dnerf_spline_dp
  recipe (`--spline 4 --dp-weight 1e-3`, the dp² term inside the
  kernel), the two-kernel path through `DynRender` with `--loss-fns l1`
  and `--dp-weight 1e-3` (K9f's dp² column outside the kernels), and
  `--no-fused` with `--dp-weight 1e-3` (the module's out["dp"]): each
  step's loss 1e-5 relative, each gradient tensor 1e-4 relative, B's
  zero. As in tests/test_torch_dyn.py the port takes the JAX package's
  Fourier features and the JAX side runs op by op; each step's batch
  keeps the rays `testing.dyn_kink_free_rays` clears at that step's
  weights, and the port's weights are set to the JAX trajectory's before
  each step (tests/test_torch_ae_train.py says why); the last Adam
  update, from the weights both sides share, is held against optax's to
  1e-2 of the learning rate.
- The gates engage the one-kernel step for the recipes, the two-kernel
  path for another loss, the eval render at each view's time, and refuse
  static data, the options outside the kernels and more steps than K9b
  holds; `check_config` carries --dp-weight (and the other dynamic terms)
  for a dynamic model only;
  `render_view` raises without a time.
- The runner trains and renders `--data-kind synthetic-dyn --dyn-model
  plain` on the CPU at a tiny size through each path; the dynamic options
  not ported (voxel, rig, --with-canon, a VolSDF canonical) raise, naming
  their ROADMAP items.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, runner, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_dyn as k9  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402

from test_torch_dyn import (STEPS, jax_features, jax_tree, jax_ts,  # noqa: E402
                            rays_times)

DP = 1e-3
KEEP = 16


class _InjectedBatches:
  """A RayDataset stand-in whose `sample` hands out fixed batches with
  each ray's time."""

  def __init__(self, batches):
    self.batches = list(batches)
    self.pixels = torch.zeros(1, 1, 1, 4)
    self.times = torch.zeros(1)

  def sample(self, generator, batch_size, **kw):
    rays, pix, times = self.batches.pop(0)
    return (torch.from_numpy(rays), torch.from_numpy(pix),
            torch.from_numpy(times), None)


def _jax_step_loss(model, loss_kinds, dp):
  """The JAX train loss (driver.py compute_loss: main + dp · delta_x)."""
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import losses as jlosses
  loss_fn = jlosses.load_loss_fn(loss_kinds)

  def fn(p, rays, times, pix):
    out = model.apply(p, jnp.asarray(rays), times=jnp.asarray(times))
    return (loss_fn(out["rgb"], jnp.asarray(pix))
            + dp * jnp.mean(jnp.square(out["dp"])))

  return fn


@pytest.mark.parametrize("path,spline,loss_kinds,dp", [
    ("fused-one-kernel", 0, ("l2",), 0.0),
    ("fused-one-kernel", 4, ("l2",), DP),
    ("fused", 0, ("l1",), DP),
    ("oracle", 0, ("l2",), DP)],
    ids=["one-kernel-dx", "one-kernel-spline-dp", "two-kernel-l1-dp",
         "no-fused-dp"])
def test_three_steps_match_jax(path, spline, loss_kinds, dp, monkeypatch):
  """Each step's loss (main + dp term) and gradients against the JAX
  oracle + optax on injected batches, the eval grid as the step's ts."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import optim as joptim
  from nerf_atlas_tpu_torch.ops import rays as trays
  jax_features(monkeypatch, "cp")
  n, lr = 48, 1e-3
  rng = np.random.default_rng(3)
  batches = [(*rays_times(n, 10 + i),
              rng.uniform(0, 1, (n, 4)).astype(np.float32)) for i in range(3)]
  jmodel, tree = jax_tree("cp", spline, batches[0][0], batches[0][1], seed=5)
  loss_j_fn = _jax_step_loss(jmodel, loss_kinds, dp)

  tx = joptim.load_optimizer("adam", lr, total_steps=10)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)
  ref_steps, kept, trajectory = [], [], []
  for rays, times, pix in batches:
    trajectory.append(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    keep = testing.dyn_kink_free_rays(
        trajectory[-1], torch.from_numpy(rays), torch.from_numpy(times),
        jax_ts(), STEPS, "cp", spline).numpy()
    clear = np.flatnonzero(keep)[:KEEP]
    assert clear.shape == (KEEP,), keep.sum()
    rays, times, pix = rays[clear], times[clear], pix[clear]
    kept.append((rays, pix, times))
    with jax.default_matmul_precision("highest"):
      loss, jgrads = jax.value_and_grad(loss_j_fn)(params, rays, times, pix)
    grads = convert.params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert float(grads[k9.B_KEY].abs().max()) == 0.0     # B: stop_gradient
    ref_steps.append((float(loss), grads))
    updates, state = tx.update(jgrads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)

  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: jax_ts())
  model = models.DynamicNeRF(spline_points=spline, steps=STEPS,
                             canonical_kwargs={"enc_kind": "cp",
                                               "refl_kind": "view"})
  model.load_state_dict(convert.params_from_flax(tree))
  ds = _InjectedBatches(kept)
  cfg = driver.TrainConfig(steps=10, batch_size=KEEP, learning_rate=lr,
                           loss_kinds=loss_kinds, reg_coeffs={"delta_x": dp},
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
  step = driver.make_train_step(model, ds, losses.load_loss_fn(loss_kinds),
                                opt, cfg, fused_step=fused_step,
                                fused_train=fused_train)
  gen = torch.Generator().manual_seed(0)
  for i, (loss_j, grads_j) in enumerate(ref_steps):
    with torch.no_grad():
      model.load_state_dict(trajectory[i])
    metrics = step(i, gen)
    loss = float(metrics["loss"])
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (path, i, loss, loss_j)
    assert set(seen[i]) == set(grads_j)
    assert not seen[i][k9.B_KEY].any()         # B: a zero gradient, as in JAX
    for key, grad in seen[i].items():
      if key == k9.B_KEY:
        continue
      ref = grads_j[key]
      if key.startswith(("warp.", "rigidity.")):
        assert float(ref.norm()) > 0, key
      err = float((grad - ref).norm() / ref.norm())
      assert err <= 1e-4, (path, i, key, err)
  final = convert.params_from_flax(jax.tree.map(np.asarray, params))
  for key, p in model.state_dict().items():
    update = p - trajectory[-1][key]
    err = float((update - (final[key] - trajectory[-1][key])).abs().max())
    assert err <= 1e-2 * lr, (path, key, err / lr)


def _dataset(kind="synthetic-dyn"):
  from nerf_atlas_tpu_torch.data import loaders, sampler
  return sampler.RayDataset.from_bundle(
      loaders.load("", data_kind=kind, size=8, num_views=3), size=8)


def test_gates_engage_the_dynamic_paths():
  ds, static = _dataset(), _dataset("synthetic")

  def model_of(**kw):
    kw.setdefault("steps", STEPS)
    return driver.init_model(models.DynamicNeRF(**kw), seed=0)

  recipe, l1 = driver.TrainConfig(), driver.TrainConfig(loss_kinds=("l1",))
  for kw, enc in ((dict(), "dyn-cp"), (dict(spline_points=4), "dyn-cp"),
                  (dict(canonical_kwargs={"enc_kind": "posenc"}),
                   "dyn-posenc"),
                  (dict(spline_points=k9.MAX_SPLINE), "dyn-cp")):
    model = model_of(**kw)
    assert driver._fused_enc_kind(model) == enc, kw
    assert driver._fused_step_fn(model, recipe, ds) is not None, kw
    assert driver._fused_train_fn(model, recipe, ds) is not None, kw
    assert driver._fused_render_fn(model) is not None, kw
    assert driver._fused_step_fn(model, l1, ds) is None, kw   # two kernels
    assert driver._fused_train_fn(model, l1, ds) is not None, kw
    for cfg in (recipe, l1):                          # no times: no kernels
      assert driver._fused_step_fn(model, cfg, static) is None, kw
      assert driver._fused_train_fn(model, cfg, static) is None, kw
  dp = driver.TrainConfig(reg_coeffs={"delta_x": DP})
  assert driver._fused_step_fn(model_of(), dp, ds) is not None
  off = driver.TrainConfig(no_fused=True)
  assert driver._fused_step_fn(model_of(), off, ds) is None
  for kw in (dict(with_rigidity=False), dict(mip="cone"),
             dict(spline_points=k9.MAX_SPLINE + 1),
             dict(canonical_kwargs={"enc_kind": "hash"}),
             dict(canonical_kwargs={"intermediate_size": 32}),
             dict(sigmoid_kind="softmax")):
    other = model_of(**kw)
    assert driver._fused_enc_kind(other) is None, kw
    assert driver._fused_step_fn(other, recipe, ds) is None, kw
    assert driver._fused_train_fn(other, recipe, ds) is None, kw
    assert driver._fused_render_fn(other) is None, kw
  for kw in (dict(density_noise=0.5), dict(sky_kind="random"),
             dict(steps=k9.BWD_MAX_STEPS["cp"] + 1)):
    other = model_of(**kw)
    assert driver._fused_step_fn(other, recipe, ds) is None, kw
    assert driver._fused_train_fn(other, recipe, ds) is None, kw
  assert driver._fused_render_fn(model_of(
      steps=k9.BWD_MAX_STEPS["cp"] + 1)) is not None
  assert driver._fused_render_fn(model_of(sky_kind="random")) is None
  at_cap = model_of(steps=k9.BWD_MAX_STEPS["cp"])
  assert driver._fused_step_fn(at_cap, recipe, ds) is not None
  posenc_cap = model_of(steps=k9.BWD_MAX_STEPS["cp"] + 1,
                        canonical_kwargs={"enc_kind": "posenc"})
  assert driver._fused_step_fn(posenc_cap, recipe, ds) is not None
  assert driver.model_kind(model_of()) == "dynamic"
  driver.check_config(dp, "dynamic")
  with pytest.raises(NotImplementedError, match="delta_x"):
    driver.check_config(dp, "plain")
  for key in ("offset", "rigidity_sparsity", "dyn_divergence",
              "spline_length", "spline_pt0"):    # carried since the family
    driver.check_config(driver.TrainConfig(reg_coeffs={key: 0.1}),
                        "dynamic")
    assert driver._fused_step_fn(model_of(), driver.TrainConfig(
        reg_coeffs={key: 0.1}), ds) is None


def test_render_view_takes_each_views_time():
  ds = _dataset()
  model = driver.init_model(models.DynamicNeRF(steps=8), seed=0)
  sd = model.state_dict()
  sd["warp.layer_out.weight"].normal_(0.0, 0.3,
                                      generator=torch.Generator().manual_seed(1))
  img = driver.render_view(model, ds, 2, chunk=24)
  times = torch.full((64,), float(ds.times[2]))
  with torch.no_grad():
    ref = model(ds.view_rays(2), times=times)["rgb"].reshape(8, 8, 3)
  np.testing.assert_allclose(img, ref.numpy(), atol=1e-6)
  at0 = driver.render_view(model, ds, 2, time_val=0.0)
  assert np.abs(at0 - img).max() > 1e-4           # another time, another image
  depth = driver.render_view(model, ds, 2, mode="depth")
  assert depth.shape == (8, 8, 1)
  with pytest.raises(ValueError, match="time"):
    driver.render_view(model, _dataset("synthetic"), 0)


def _run(tmp_path, name, *extra):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic-dyn", "--model", "plain",
                     "--dyn-model", "plain", "--size", "8", "--num-views",
                     "3", "--steps", "8", "--batch-size", "32", "-lr",
                     "1e-3", "--seed", "0", "--valid-freq", "0", "--nosave",
                     "--outdir", str(out), *extra], device="cpu")
  return res, out


@pytest.mark.parametrize("extra,path", [
    ((), "fused-one-kernel"),
    (("--spline", "4", "--dp-weight", "1e-3"), "fused-one-kernel"),
    (("--loss-fns", "l1", "--dp-weight", "1e-3"), "fused"),
    (("--no-fused",), "oracle")])
def test_runner_trains_dnerf_on_cpu(tmp_path, extra, path):
  res, out = _run(tmp_path, "trained", "--epochs", "4", *extra)
  assert res["engaged_path"] == path
  with open(out / "log.json") as f:
    logged = json.load(f)
  assert logged["engaged_path"] == path and logged["dyn_model"] == "plain"
  assert all(np.isfinite(h["loss"]) for h in res["history"])
  for split in ("train", "test"):
    assert all(np.isfinite(res[split]["psnrs"]))
    lines = (out / split / "results.txt").read_text().splitlines()
    assert lines[-1].startswith("PSNR mean ")


def test_runner_renders_dnerf_and_raises_on_unported_options(tmp_path):
  """The options still to port raise, naming their ROADMAP item or the
  reference's fault; the rest of the family's flags run in
  tests/test_torch_dyn_family_train.py."""
  res, _ = _run(tmp_path, "render", "--epochs", "0")
  assert "engaged_path" not in res and np.isfinite(res["test"]["psnr_mean"])
  for flags in (("--dyn-model", "voxel"), ("--dyn-model", "rig"),
                ("--with-canon", "canonical.ckpt")):
    with pytest.raises(NotImplementedError, match="Queue 1 #11"):
      _run(tmp_path, "bad", "--epochs", "0", *flags)
  with pytest.raises(NotImplementedError, match="Queue 3"):
    _run(tmp_path, "bad", "--epochs", "0", "--model", "volsdf")
