"""The port's training slice on the CPU against the JAX package.

- `train/optim.py:load_optimizer` against `nerf_atlas_tpu.train.optim`
  (optax) over 5 updates with the same seeded gradients: 1e-6.
- `train/losses.py:load_loss_fn` against the JAX losses: 1e-6.
- The learning rate applied at each of the quality recipe's 1500 updates
  is optax's cosine schedule: 1e-6.
- `compute_ts` jitter stays inside its bins; `rays_at` jitter moves a
  pixel by at most half a pixel; `RayDataset.sample` shapes and ranges;
  the sampled rays, labels and stratified ts follow the JAX package's
  distributions (two-sample tests).
- The train-mode `PlainNeRF` forward against the JAX oracle's train-mode
  apply on the oracle's own jittered ts: 2e-4 (the eval tolerance of
  tests/test_torch_render.py).
- Three steps of the port's train step, on each of its three paths, with
  injected batches against the same three steps composed in JAX (oracle
  value_and_grad + the JAX package's optax chain): every parameter
  tensor within 1e-4 relative. The biases start from seeded random values
  rather than flax's zeros: Adam divides each gradient component by its
  own running RMS, so a component summed with heavy cancellation (a bias
  gradient is a sum over every sample point) carries its float32
  relative error (~1e-3 here) into its step at full size, and a zero
  bias is nothing but those steps (measured: 1.2e-3 on the density
  layer_in bias from zeros at -lr 1e-3).
- The runner trains end to end on the CPU (log.json carries the engaged
  path) and the kernel gates pick the path the JAX gates pick.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nerf_atlas_tpu import models as jmodels  # noqa: E402
from nerf_atlas_tpu.train import losses as jlosses  # noqa: E402
from nerf_atlas_tpu.train import optim as joptim  # noqa: E402
from nerf_atlas_tpu_torch import convert, models, runner  # noqa: E402
from nerf_atlas_tpu_torch.data import cameras, loaders, sampler  # noqa: E402
from nerf_atlas_tpu_torch.ops import rays as trays  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402

STEPS = 16


# ---------------------------------------------------------------------------
# optimizers and losses
# ---------------------------------------------------------------------------

OPT_CASES = [
    ("adam", {}),
    ("adam", dict(no_sched=True)),
    ("adam", dict(grad_clip=0.5, weight_decay=0.1)),
    ("adamw", {}),
    ("adamw", dict(weight_decay=0.05)),
    ("sgd", dict(grad_clip=0.3)),
    ("rmsprop", {}),
]


@pytest.mark.parametrize("kind,kw", OPT_CASES)
def test_load_optimizer_matches_optax(kind, kw):
  rng = np.random.default_rng(0)
  shapes = {"a": (3, 4), "b": (5,)}
  init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
  kw = dict(learning_rate=1e-2, total_steps=8, sched_min=1e-3, **kw)
  tx = joptim.load_optimizer(kind, **kw)
  jparams = {k: jnp.asarray(v) for k, v in init.items()}
  state = tx.init(jparams)
  tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in init.items()}
  opt = optim.load_optimizer(tparams.values(), kind, **kw)
  for _ in range(5):
    grads = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                               state, jparams)
    jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
    opt.zero_grad()
    for k, p in tparams.items():
      p.grad = torch.from_numpy(grads[k])
    opt.step()
  for k in shapes:
    np.testing.assert_allclose(tparams[k].detach().numpy(),
                               np.asarray(jparams[k]), atol=1e-6, rtol=1e-6)


def test_cosine_decay_is_optax_schedule():
  import optax
  sched = optax.cosine_decay_schedule(1e-3, 10, alpha=0.05)
  for step in range(13):
    assert optim.cosine_decay(step, 10, 0.05) * 1e-3 == pytest.approx(
        float(sched(step)), rel=1e-6)


def test_applied_learning_rate_is_optax_schedule_over_the_recipe():
  """The learning rate each update of the optimizer applies over the
  quality sweep's 1500 steps (-lr 1e-3, the default --sched-min 5e-5)
  and past them is optax's cosine schedule at that update's count."""
  import optax
  want = np.asarray(optax.cosine_decay_schedule(1e-3, 1500, alpha=0.05)(
      jnp.arange(1510)))
  p = torch.nn.Parameter(torch.zeros(1))
  opt = optim.load_optimizer([p], "adam", 1e-3, total_steps=1500,
                             sched_min=5e-5)
  got = []
  for _ in range(1510):
    got.append(opt.opt.param_groups[0]["lr"])
    p.grad = torch.ones(1)
    opt.step()
  np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unported_optimizer_options_raise():
  p = [torch.nn.Parameter(torch.zeros(2))]
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    optim.load_optimizer(p, "uniform_adam")
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    optim.load_optimizer(p, "adam", accum_steps=2)


LOSS_CASES = [
    (("l2",), ("rgb",), False, False),
    (("l1", "rmse"), ("rgb", "luminance"), False, False),
    (("l2",), ("hsv", "xyz"), True, False),
    (("l2",), ("rgb",), False, True),
    (("l1",), ("rgb",), False, 1.8),
]


@pytest.mark.parametrize("kinds,spaces,tone,gamma", LOSS_CASES)
@pytest.mark.parametrize("channels", [3, 4])
def test_load_loss_fn_matches_jax(kinds, spaces, tone, gamma, channels):
  rng = np.random.default_rng(1)
  pred = rng.uniform(0, 1, (64, channels)).astype(np.float32)
  target = rng.uniform(0, 1, (64, 4)).astype(np.float32)
  pred[0, :3] = [0.3, 0.3, 0.3]                     # hsv's grey branch
  j = jlosses.load_loss_fn(kinds, spaces, tone, gamma)(
      jnp.asarray(pred), jnp.asarray(target))
  t = losses.load_loss_fn(kinds, spaces, tone, gamma)(
      torch.from_numpy(pred), torch.from_numpy(target))
  np.testing.assert_allclose(float(t), float(j), rtol=1e-6, atol=1e-7)
  np.testing.assert_allclose(float(losses.mse2psnr(float(t))),
                             float(jlosses.mse2psnr(j)), rtol=1e-6)


def test_crop_losses_raise():
  """ssim and fft need crops [..., H, W, C]: on a flat ray batch [N, C]
  they raise, as JAX's do (they run on crops since the captured-scenes
  slice, tests/test_torch_crop.py)."""
  flat = torch.rand(64, 3)
  for kind in ("ssim", "fft"):
    with pytest.raises((RuntimeError, IndexError)):
      losses.load_loss_fn((kind,))(flat, flat)
    with pytest.raises(Exception):
      jlosses.load_loss_fn((kind,))(jnp.asarray(flat.numpy()),
                                    jnp.asarray(flat.numpy()))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lindisp", [False, True])
def test_compute_ts_jitter_stays_in_its_bins(lindisp):
  grid = trays.compute_ts(2.0, 6.0, 32, lindisp=lindisp)
  mids = 0.5 * (grid[:-1] + grid[1:])
  lower = torch.cat([mids, grid[-1:]])
  upper = torch.cat([grid[:1], mids])
  lo, hi = torch.minimum(lower, upper), torch.maximum(lower, upper)
  gen = torch.Generator().manual_seed(0)
  for batch in ((), (5,)):
    ts = trays.compute_ts(2.0, 6.0, 32, lindisp=lindisp, perturb=1.0,
                          generator=gen, batch_shape=batch)
    assert ts.shape == batch + (32,)
    assert bool(((ts >= lo) & (ts <= hi)).all())
    assert float(ts.std()) > 0
  with pytest.raises(ValueError):
    trays.compute_ts(2.0, 6.0, 32, perturb=1.0)


def test_rays_at_jitter_is_centred_and_bounded():
  cam = cameras.NeRFCamera(torch.eye(4)[None].repeat(2, 1, 1),
                           torch.tensor(10.0))
  xy = torch.rand(500, 2, generator=torch.Generator().manual_seed(1)) * 16
  view = torch.zeros(500, dtype=torch.long)
  r0 = cam.rays_at(view, xy, 16)
  r1 = cam.rays_at(view, xy, 16, jitter=1.0,
                   generator=torch.Generator().manual_seed(2))
  # identity pose: r_d = ((x − 8)/f, −(y − 8)/f, −1)
  dx = (r1[:, 3] - r0[:, 3]) * 10.0
  dy = -(r1[:, 4] - r0[:, 4]) * 10.0
  for d in (dx, dy):
    assert float(d.abs().max()) <= 0.5 + 1e-5
    assert abs(float(d.mean())) < 0.05 and float(d.abs().max()) > 0.4
  assert torch.equal(r0[:, :3], r1[:, :3])
  with pytest.raises(ValueError):
    cam.rays_at(view, xy, 16, jitter=1.0)


def _dataset(size=8, views=3):
  return sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=size, num_views=views),
      size=size)


def test_sampling_statistics_match_jax():
  """The training batches and sample positions the port draws follow the
  JAX package's distributions, not just its ranges: 200k jittered rays
  of the procedural scene (views, pixels' labels, ray directions) and
  4000 stratified ts vectors, each compared by a two-sample
  Kolmogorov-Smirnov test (the views by a chi-squared test of their
  counts). Both streams are seeded, so the p-values are fixed; measured:
  views 0.84, directions >= 0.14, labels >= 0.87, ts >= 0.065 over the 64
  bins. A jitter of 0.5 instead of 1, no jitter, a quarter-pixel shift or
  perturb 0.9 each give p < 2e-4 (ts: 2e-23)."""
  from scipy import stats
  from nerf_atlas_tpu.data import load as jload
  from nerf_atlas_tpu.data import sampler as jsampler
  from nerf_atlas_tpu.ops import rays as jrays
  n, size, views = 200_000, 8, 5
  jds = jsampler.RayDataset.from_bundle(
      jload("", data_kind="synthetic", size=size, num_views=views), size=size)
  rays_j, pix_j, _, view_j = jax.tree.map(
      np.asarray, jds.sample(jax.random.PRNGKey(0), n, jitter=1.0))
  rays_t, pix_t, _, view_t = _dataset(size, views).sample(
      torch.Generator().manual_seed(0), n, jitter=1.0)
  rays_t, pix_t, view_t = rays_t.numpy(), pix_t.numpy(), view_t.numpy()
  counts = np.stack([np.bincount(view_j, minlength=views),
                     np.bincount(view_t, minlength=views)])
  assert stats.chi2_contingency(counts).pvalue > 1e-3
  for c in range(3, 6):
    assert stats.ks_2samp(rays_j[:, c], rays_t[:, c]).pvalue > 1e-3, c
  # the two scenes' labels agree to 1e-5 (test_torch_slice.py), not bit
  # for bit: compare them at 1e-3
  for c in range(pix_j.shape[-1]):
    assert stats.ks_2samp(np.round(pix_j[:, c], 3),
                          np.round(pix_t[:, c], 3)).pvalue > 1e-3, c

  keys = jax.random.split(jax.random.PRNGKey(1), 4000)
  ts_j = np.asarray(jax.vmap(lambda k: jrays.compute_ts(
      2.0, 6.0, 64, perturb=1.0, key=k))(keys))
  gen = torch.Generator().manual_seed(1)
  ts_t = np.stack([trays.compute_ts(2.0, 6.0, 64, perturb=1.0,
                                    generator=gen).numpy()
                   for _ in range(4000)])
  p = [stats.ks_2samp(ts_j[:, i], ts_t[:, i]).pvalue for i in range(64)]
  assert min(p) > 1e-3 / 64, min(p)           # Bonferroni over the bins


def test_sample_shapes_and_ranges():
  ds = _dataset()
  gen = torch.Generator().manual_seed(0)
  rays, pix, t, view = ds.sample(gen, 200, jitter=1.0)
  assert rays.shape == (200, 6) and pix.shape == (200, 4) and t is None
  assert view.shape == (200,) and set(view.tolist()) == {0, 1, 2}
  flat = ds.pixels.reshape(3, -1, 4)
  for i in range(0, 200, 37):      # each label is a pixel of its view
    assert bool((flat[view[i]] == pix[i]).all(-1).any())
  cams = ds.camera.cam_to_world[view, :3, 3]
  assert torch.equal(rays[:, :3], cams)
  _, _, _, view = ds.sample(gen, 50, serial_step=7)
  assert set(view.tolist()) == {7 % 3}
  _, _, _, view = ds.sample(gen, 400, end_bias=5)
  counts = torch.bincount(view, minlength=3)
  assert counts[0] > counts[1] and counts[2] > counts[1]
  _, _, _, view = ds.sample(gen, 50, view_range=(1, 2))
  assert set(view.tolist()) == {1}


# ---------------------------------------------------------------------------
# the train-mode model and the train step against JAX
# ---------------------------------------------------------------------------

def _rays(n, seed):
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(size=(n, 3)) * 0.1
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


def _jax_params(jmodel, rays, seed=0):
  params = jmodel.init({"params": jax.random.PRNGKey(seed),
                        "sampler": jax.random.PRNGKey(seed + 1)},
                       jnp.asarray(rays), train=True)
  return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("sky_kind", ["black", "white"])
def test_train_forward_matches_jax_on_its_ts(sky_kind, monkeypatch):
  rays = _rays(48, 0)
  jmodel = jmodels.PlainNeRF(steps=STEPS, sky_kind=sky_kind)
  tree = _jax_params(jmodel, rays)
  out_j = jmodel.apply(tree, jnp.asarray(rays), train=True,
                       rngs={"sampler": jax.random.PRNGKey(7)})
  ts_j = torch.from_numpy(np.asarray(out_j["ts"]))
  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: ts_j)
  model = models.PlainNeRF(steps=STEPS, sky_kind=sky_kind)
  model.load_state_dict(convert.params_from_flax(tree))
  out = model(torch.from_numpy(rays), train=True,
              generator=torch.Generator().manual_seed(0))
  np.testing.assert_allclose(out["rgb"].detach().numpy(),
                             np.asarray(out_j["rgb"]), atol=2e-4, rtol=0)
  assert not torch.equal(ts_j, torch.linspace(2, 6, STEPS))


def test_train_mode_noise_and_random_sky():
  rays = torch.from_numpy(_rays(32, 1))
  model = driver.init_model(models.PlainNeRF(steps=STEPS, sky_kind="random",
                                             density_noise=1.0), seed=0)
  gen = torch.Generator().manual_seed(0)
  with torch.no_grad():
    a = model(rays, train=True, generator=gen)
    b = model(rays, train=True, generator=gen)
    ev = model(rays)
  assert not torch.equal(a["rgb"], b["rgb"])        # ts, noise, sky drawn
  assert torch.equal(ev["ts"], torch.linspace(2, 6, STEPS))
  black = driver.init_model(models.PlainNeRF(steps=STEPS), seed=0)
  with torch.no_grad():
    assert torch.equal(ev["rgb"], black(rays)["rgb"])   # eval sky: black


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
  n, lr = 32, 5e-4                    # the runner's default -lr
  rng = np.random.default_rng(3)
  batches = [(_rays(n, 10 + i), rng.uniform(0, 1, (n, 4)).astype(np.float32))
             for i in range(3)]
  jmodel = jmodels.PlainNeRF(steps=STEPS)
  tree = _jax_params(jmodel, batches[0][0], seed=5)
  tree = jax.tree_util.tree_map_with_path(
      lambda path, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                       if "bias" in jax.tree_util.keystr(path) else v), tree)

  tx = joptim.load_optimizer("adam", lr, total_steps=10)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)
  loss_fn = jlosses.load_loss_fn()
  for rays, pix in batches:
    def fn(p, rays=rays, pix=pix):
      return loss_fn(jmodel.apply(p, jnp.asarray(rays))["rgb"],
                     jnp.asarray(pix))
    with jax.default_matmul_precision("highest"):
      grads = jax.grad(fn)(params)
    updates, state = tx.update(grads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
  ref = convert.params_from_flax(jax.tree.map(np.asarray, params))

  # the port on the same batches, with the eval grid for the step's ts
  monkeypatch.setattr(trays, "compute_ts", lambda near, far, steps, **kw:
                      torch.linspace(near, far, steps))
  model = models.PlainNeRF(steps=STEPS)
  model.load_state_dict(convert.params_from_flax(tree))
  ds = _InjectedBatches(batches)
  cfg = driver.TrainConfig(steps=10, batch_size=n, learning_rate=lr,
                           no_fused=path == "oracle")
  opt = optim.load_optimizer(model.parameters(), "adam", lr, total_steps=10)
  fused_step = driver._fused_step_fn(model, cfg, ds)
  fused_train = driver._fused_train_fn(model, cfg, ds)
  if path == "fused":
    fused_step = None
  step = driver.make_train_step(model, ds, losses.load_loss_fn(), opt, cfg,
                                fused_step=fused_step,
                                fused_train=fused_train)
  gen = torch.Generator().manual_seed(0)
  for i in range(3):
    step(i, gen)
  for key, value in model.state_dict().items():
    err = float((value - ref[key]).norm() / ref[key].norm())
    assert err <= 1e-4, (path, key, err)


# ---------------------------------------------------------------------------
# gates and the runner
# ---------------------------------------------------------------------------

def test_gates_pick_the_paths_of_the_jax_gates():
  ds = _dataset()
  cfg = driver.TrainConfig()
  flagship = driver.init_model(models.PlainNeRF(steps=STEPS), seed=0)
  assert driver._fused_step_fn(flagship, cfg, ds) is not None
  l1 = driver.TrainConfig(loss_kinds=("l1",))
  assert driver._fused_step_fn(flagship, l1, ds) is None
  assert driver._fused_train_fn(flagship, l1, ds) is not None
  posenc = driver.init_model(models.PlainNeRF(steps=STEPS, enc_kind="posenc"),
                             seed=0)
  assert driver._fused_step_fn(posenc, cfg, ds) is not None
  assert driver._fused_train_fn(posenc, cfg, ds) is not None
  for kw in (dict(sky_kind="random"), dict(density_noise=0.5),
             dict(per_ray_jitter=True), dict(lindisp=True),
             dict(enc_kind="posenc", density_noise=0.5),
             dict(sigmoid_kind="softmax")):
    m = driver.init_model(models.PlainNeRF(steps=STEPS, **kw), seed=0)
    assert driver._fused_step_fn(m, cfg, ds) is None, kw
    assert driver._fused_train_fn(m, cfg, ds) is None, kw
  off = driver.TrainConfig(no_fused=True)
  assert driver._fused_step_fn(flagship, off, ds) is None
  assert driver._fused_train_fn(flagship, off, ds) is None
  crops = driver.TrainConfig(crop_size=8)          # the JAX gates' rule
  driver.check_config(crops)
  assert driver._fused_step_fn(flagship, crops, ds) is None
  assert driver._fused_train_fn(flagship, crops, ds) is None
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    driver.check_config(driver.TrainConfig(omit_bg=True))
  with pytest.raises(NotImplementedError, match="regularizers"):
    driver.check_config(driver.TrainConfig(reg_coeffs={"eikonal": 0.1}))


def _run(tmp_path, name, *extra):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic", "--size", "16",
                     "--num-views", "4", "--steps", str(STEPS),
                     "--batch-size", "64", "-lr", "1e-3", "--seed", "0",
                     "--valid-freq", "8", "--outdir", str(out), *extra],
                    device="cpu")
  return res, out


def test_runner_trains_on_cpu(tmp_path):
  res0, _ = _run(tmp_path, "untrained", "--epochs", "0")
  res, out = _run(tmp_path, "trained", "--epochs", "16")
  with open(out / "log.json") as f:
    assert json.load(f)["engaged_path"] == "fused-one-kernel"
  assert res["engaged_path"] == "fused-one-kernel"
  assert np.isfinite(res["history"][0]["loss"])
  for split in ("train", "test"):     # the loss fell: PSNR rose
    assert res[split]["psnr_mean"] > res0[split]["psnr_mean"] + 1.0
  assert (out / "model.ckpt").exists() and (out / "valid_000016.png").exists()


@pytest.mark.parametrize("flags", [("--no-fused",),
                                   ("--density-noise", "0.5")])
def test_runner_no_fused_takes_the_oracle(tmp_path, flags):
  res, out = _run(tmp_path, "oracle", "--epochs", "2", *flags, "--nosave")
  assert res["engaged_path"] == "oracle"
  assert not (out / "model.ckpt").exists()
  with open(out / "log.json") as f:
    assert json.load(f)["engaged_path"] == "oracle"
