"""Crop training on the CPU against the JAX package: crop batches, the
image-structured losses, the style loss, MS-SSIM eval.

- `RayDataset.crop_at` given JAX's draws (view, top-left) gathers JAX's
  `sample_crop` labels bit for bit and its rays within 1e-6, on a static
  RGBA, a timed and a DTU scene, and with a crop wider than the image
  (indices clamped, as JAX's gather clamps them); `sample_crop`'s own
  draws follow JAX's distribution (two-sample tests) and range.
- `fft_loss`, `ssim`, `ssim_loss`, `ms_ssim`, `gram_matrix` and
  `StyleLoss` (flax's params carried by `convert`; even and odd sizes,
  flax's SAME padding) against JAX: the value within 1e-5 relative, the
  gradient in the image within 1e-4 relative.
- Three train steps match JAX + optax (each step's loss 1e-5, each
  gradient tensor 1e-4 relative, the last Adam update 1e-2 of the
  learning rate): crop mode with `--loss-fns l2 ssim fft` and a style
  image (VolSDF-SIREN through the module forward, as in JAX), and an RGBA
  `original` fixture through the port's one-kernel step (PlainNeRF-CP,
  the plain K3 on the CPU).
- The runner trains BASELINE config #1 cut to size (`--model tiny
  --data-kind original --crop-size --loss-fns l2 ssim fft --style-img
  --msssim-loss`) on the module path and writes MS-SSIM; ssim, fft and
  a style image set crops of 32 by themselves; the kernel gates refuse
  crops; a render of another size is scored against the reference
  resized by INTER_LINEAR.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import cv2  # noqa: E402
import imageio.v2 as imageio  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from nerf_atlas_tpu import models as jmodels  # noqa: E402
from nerf_atlas_tpu.data import loaders as jloaders  # noqa: E402
from nerf_atlas_tpu.data import sampler as jsampler  # noqa: E402
from nerf_atlas_tpu.nn import misc as jmisc  # noqa: E402
from nerf_atlas_tpu.train import driver as jdriver  # noqa: E402
from nerf_atlas_tpu.train import losses as jlosses  # noqa: E402
from nerf_atlas_tpu.train import optim as joptim  # noqa: E402
from nerf_atlas_tpu_torch import cli, convert, models, runner, testing  # noqa: E402,E501
from nerf_atlas_tpu_torch.data import image_io, loaders, sampler  # noqa: E402
from nerf_atlas_tpu_torch.nn import misc  # noqa: E402
from nerf_atlas_tpu_torch.ops import rays as trays  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402

STEPS = 16


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
  d = tmp_path_factory.mktemp("crop_scenes")
  roots = {k: str(d / k) for k in ("lego", "jj", "scan")}
  testing.write_nerf_synthetic(roots["lego"], 3, 2, 24)
  testing.write_nerf_synthetic(roots["jj"], 4, 2, 20, dynamic=True)
  testing.write_dtu(roots["scan"], 2, 30, 24)
  rng = np.random.default_rng(0)
  roots["style"] = str(d / "style.png")
  testing.write_png_filtered(roots["style"], rng.integers(
      0, 256, (40, 36, 3)).astype(np.uint8))
  return roots


def _datasets(root, kind, size):
  jds = jsampler.RayDataset.from_bundle(
      jloaders.load(root, kind, size=size), size=size)
  tds = sampler.RayDataset.from_bundle(
      loaders.load(root, kind, size=size), size=size)
  return jds, tds


@pytest.mark.parametrize("name,kind,size,crop,views", [
    ("lego", "original", 24, 8, 3), ("jj", "dnerf", 20, 6, 2),
    ("scan", "dtu", 16, 5, 2), ("lego", "original", 12, 16, 2)])
def test_crop_at_gathers_jax_crops(scenes, name, kind, size, crop, views):
  jds, tds = _datasets(scenes[name], kind, size)
  for seed in range(3):
    key = jax.random.PRNGKey(seed)
    k1, k2, _ = jax.random.split(key, 3)
    view = jax.random.randint(k1, (views,), 0, jds.num_views)
    top_left = jax.random.randint(k2, (views, 2), 0, max(size - crop, 1))
    rays_j, pix_j, t_j, view_j = jds.sample_crop(key, crop, views)
    rays, pix, t, view_t = tds.crop_at(
        torch.as_tensor(np.array(view), dtype=torch.long),
        torch.as_tensor(np.array(top_left), dtype=torch.long), crop)
    np.testing.assert_array_equal(view_t.numpy(), np.asarray(view_j))
    np.testing.assert_array_equal(pix.numpy(), np.asarray(pix_j))
    np.testing.assert_allclose(rays.numpy(), np.asarray(rays_j), atol=1e-6,
                               rtol=0)
    if t_j is None:
      assert t is None
    else:
      np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))


def test_sample_crop_draws_follow_jax(scenes):
  jds, tds = _datasets(scenes["lego"], "original", 24)
  crop, views = 5, 3000
  _, _, _, view_j = jds.sample_crop(jax.random.PRNGKey(0), crop, views)
  k2 = jax.random.split(jax.random.PRNGKey(0), 3)[1]
  tl_j = np.asarray(jax.random.randint(k2, (views, 2), 0, 24 - crop))
  gen = torch.Generator().manual_seed(0)
  rays, pix, _, view_t = tds.sample_crop(gen, crop, views, jitter=1.0)
  assert rays.shape == (views, crop, crop, 6) and pix.shape[-1] == 4
  # the same generator's draws again: the views, then the corners
  gen = torch.Generator().manual_seed(0)
  v = torch.randint(0, tds.num_views, (views,), generator=gen)
  tl_t = torch.randint(0, 24 - crop, (views, 2), generator=gen)
  assert torch.equal(v, view_t)
  assert 0 <= int(tl_t.min()) and int(tl_t.max()) <= 24 - crop - 1
  assert stats.ks_2samp(view_t.numpy(), np.asarray(view_j)).pvalue > 1e-3
  for c in range(2):
    assert stats.ks_2samp(tl_t[:, c].numpy(), tl_j[:, c]).pvalue > 1e-3


def _images(shape, seed):
  rng = np.random.default_rng(seed)
  base = rng.uniform(0, 1, shape[:-3] + (1, 1, shape[-1]))
  x = np.linspace(0, 1, shape[-2])[None, :, None]
  y = np.linspace(0, 1, shape[-3])[:, None, None]
  img = base * np.sin(4 * x + 3 * y) ** 2 + rng.normal(0, 0.1, shape)
  return np.clip(img, 0, 1).astype(np.float32)


def _value_and_grad_pair(jfn, tfn, x, ref):
  jv, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(x), jnp.asarray(ref))
  xt = torch.tensor(x, requires_grad=True)
  tv = tfn(xt, torch.as_tensor(ref))
  tv.backward()
  return (float(tv.detach()), float(jv)), (xt.grad.numpy(), np.asarray(jg))


def _assert_close(values, grads):
  (tv, jv), (tg, jg) = values, grads
  assert abs(tv - jv) <= 1e-5 * abs(jv) + 1e-12, (tv, jv)
  err = np.linalg.norm(tg - jg) / max(np.linalg.norm(jg), 1e-30)
  assert err <= 1e-4, err


@pytest.mark.parametrize("name,shape", [
    ("fft", (2, 16, 16, 3)), ("fft", (3, 15, 20, 3)),
    ("ssim", (2, 32, 32, 3)), ("ssim_loss", (2, 24, 20, 3)),
    ("ms_ssim", (64, 64, 3)), ("ms_ssim", (2, 48, 40, 3)),
    ("ms_ssim", (16, 16, 3))])
def test_image_losses_match_jax(name, shape):
  jfn = {"fft": jlosses.fft_loss, "ssim": jlosses.ssim,
         "ssim_loss": jlosses.ssim_loss, "ms_ssim": jlosses.ms_ssim}[name]
  tfn = {"fft": losses.fft_loss, "ssim": losses.ssim,
         "ssim_loss": losses.ssim_loss, "ms_ssim": losses.ms_ssim}[name]
  x, ref = _images(shape, 0), _images(shape, 1)
  with jax.default_matmul_precision("highest"):
    _assert_close(*_value_and_grad_pair(jfn, tfn, x, ref))
  np.testing.assert_allclose(losses._gaussian_kernel().numpy(),
                             np.asarray(jlosses._gaussian_kernel()),
                             rtol=1e-6)


def test_loss_fn_composes_crop_losses_as_jax():
  x, ref = _images((2, 16, 16, 3), 2), _images((2, 16, 16, 4), 3)
  kinds = ("l2", "ssim", "fft")
  j = jlosses.load_loss_fn(kinds)(jnp.asarray(x), jnp.asarray(ref))
  t = losses.load_loss_fn(kinds)(torch.as_tensor(x), torch.as_tensor(ref))
  np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def _style_params(img, style):
  mod = jmisc.StyleLoss()
  return mod, mod.init(jax.random.PRNGKey(0), jnp.asarray(img),
                       jnp.asarray(style))


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 33, 27, 3)])
def test_style_loss_matches_jax(shape):
  img, style = _images(shape, 4), _images((1,) + shape[1:], 5)
  style = np.broadcast_to(style, shape).copy()
  jmod, params = _style_params(img, style)
  tmod = misc.StyleLoss()
  tmod.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, params)))
  assert not any(p.requires_grad for p in tmod.parameters())
  g_j = np.asarray(jmisc.gram_matrix(jnp.asarray(img)))
  g_t = misc.gram_matrix(torch.as_tensor(img)).numpy()
  np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1e-7)
  with jax.default_matmul_precision("highest"):
    _assert_close(*_value_and_grad_pair(
        lambda x, s: jmod.apply(params, x, s), tmod, img, style))


def test_style_init_is_flax_lecun_normal():
  mod = misc.StyleLoss()
  mod.reset_parameters(torch.Generator().manual_seed(0))
  for conv in mod.convs:
    fan_in = conv.weight[0].numel()
    w = conv.weight.flatten()
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / fan_in) / 0.8796 + 1e-6
    assert abs(float(w.std()) - np.sqrt(1 / fan_in)) < 0.2 * np.sqrt(
        1 / fan_in)
    assert float(conv.bias.abs().max()) == 0.0


# ---------------------------------------------------------------------------
# three train steps against JAX + optax
# ---------------------------------------------------------------------------

def _jax_grid(near, far, steps, **kw):
  """The JAX package's eval grid as the step's ts (jnp.linspace differs
  from torch.linspace in the last bit of some entries)."""
  return torch.from_numpy(np.array(jnp.linspace(near, far, steps,
                                                dtype=jnp.float32)))


class _Injected:
  """A RayDataset stand-in that hands out fixed batches: flat rays from
  `sample`, crops from `sample_crop`."""

  def __init__(self, batches, channels=4):
    self.batches = list(batches)
    self.pixels = torch.zeros(1, 1, 1, channels)
    self.times = None

  def _next(self):
    rays, pix = self.batches.pop(0)
    return torch.from_numpy(rays), torch.from_numpy(pix), None, None

  def sample(self, generator, batch_size, **kw):
    return self._next()

  def sample_crop(self, generator, crop_size, views_per_batch=1, **kw):
    rays, pix, t, v = self._next()
    assert rays.shape[:3] == (views_per_batch, crop_size, crop_size)
    return rays, pix, t, v


def _three_steps_match(jmodel, tree, batches, jloss, model, cfg, monkeypatch,
                       **step_kw):
  """Three steps of JAX (jitted value_and_grad + optax's Adam) against
  three of the port's `make_train_step` on the same batches, as
  tests/test_torch_k4_train.py holds its families: the port's weights set
  to the JAX trajectory's before each step, each step's loss within 1e-5
  and each gradient tensor within 1e-4 relative, and the last Adam
  update, from the weights both sides share, within 1e-2 of the learning
  rate (Adam's first updates are ±lr by the sign of each gradient entry,
  and entries that cancel to round-off take either sign in two float32
  implementations). The port takes JAX's ts grid."""
  monkeypatch.setattr(trays, "compute_ts", _jax_grid)
  lr = cfg.learning_rate
  tx = joptim.load_optimizer("adam", lr, total_steps=cfg.steps)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)

  def fn(p, rays, pix):
    return jloss(jmodel.apply(p, rays)["rgb"], pix)

  value_and_grad = jax.jit(jax.value_and_grad(fn))
  ref_steps, trajectory = [], []
  for rays, pix in batches:
    trajectory.append(convert.params_from_flax(
        jax.tree.map(np.asarray, params)))
    with jax.default_matmul_precision("highest"):
      loss, grads = value_and_grad(params, jnp.asarray(rays),
                                   jnp.asarray(pix))
    ref_steps.append((float(loss), convert.params_from_flax(
        jax.tree.map(np.asarray, grads))))
    updates, state = tx.update(grads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
  final = convert.params_from_flax(jax.tree.map(np.asarray, params))

  ds = _Injected(batches)
  opt = optim.load_optimizer(model.parameters(), "adam", lr,
                             total_steps=cfg.steps)
  seen, inner = [], opt.step

  def record():
    seen.append({k: p.grad.clone() for k, p in model.named_parameters()})
    inner()

  opt.step = record
  step = driver.make_train_step(model, ds, losses.load_loss_fn(
      cfg.loss_kinds), opt, cfg, **step_kw)
  gen = torch.Generator().manual_seed(0)
  for i, (loss_j, grads_j) in enumerate(ref_steps):
    with torch.no_grad():
      model.load_state_dict(trajectory[i])
    loss = float(step(i, gen)["loss"])
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (i, loss, loss_j)
    for key, ref in grads_j.items():
      err = float((seen[i][key] - ref).norm() / ref.norm())
      assert err <= 1e-4, (i, key, err)
  for key, p in model.state_dict().items():
    update = p - trajectory[-1][key]
    err = float((update - (final[key] - trajectory[-1][key])).abs().max())
    assert err <= 1e-2 * lr, (key, err / lr)


def _jax_tree(jmodel, rays, seed, rng):
  """flax's init, its biases from seeded random values
  (tests/test_torch_train.py: a zero bias's first Adam steps are all
  round-off)."""
  tree = jax.tree.map(np.asarray, jmodel.init(
      {"params": jax.random.PRNGKey(seed),
       "sampler": jax.random.PRNGKey(seed + 1)}, jnp.asarray(rays),
      train=True))
  return jax.tree_util.tree_map_with_path(
      lambda path, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                       if "bias" in jax.tree_util.keystr(path) else v), tree)


def test_three_crop_steps_with_ssim_fft_style_match_jax(scenes, monkeypatch):
  """VolSDF with the SIREN shape: a field without leaky-relu kinks or
  grid cells. In dense crops the leaky and grid fields put points within
  round-off of a kink or a cell face, where two float32 implementations
  take different branches (measured here: TinyNeRF 1.9e-4, PlainNeRF-CP
  1.2e-3 on one gradient tensor); the flat tests cut such rays, which a
  crop cannot lose. TinyNeRF trains on crops in the runner test below."""
  c, views, weight = 16, 2, 1.0
  tds = sampler.RayDataset.from_bundle(
      loaders.load(scenes["lego"], "original", size=24), size=24)
  gen = torch.Generator().manual_seed(1)
  batches = []
  for _ in range(3):
    rays, pix, _, _ = tds.sample_crop(gen, c, views)
    batches.append((rays.numpy(), pix.numpy()))
  kinds = ("l2", "ssim", "fft")
  jcfg = jdriver.TrainConfig(crop_size=c, style_img=scenes["style"],
                             style_weight=weight, loss_kinds=kinds)
  jstyle = jdriver._make_style_fn(jcfg)
  jloss_fn = jlosses.load_loss_fn(kinds)

  def jloss(pred, pix):
    return jloss_fn(pred, pix) + weight * jstyle(pred)

  kw = dict(steps=STEPS, sdf_kind="siren", sigmoid_kind="upshifted")
  jmodel = jmodels.VolSDF(**kw)
  tree = _jax_tree(jmodel, batches[0][0], 5, np.random.default_rng(3))
  model = models.VolSDF(**kw)
  cfg = driver.TrainConfig(steps=10, batch_size=views * c * c,
                           learning_rate=5e-4, loss_kinds=kinds, crop_size=c,
                           style_img=scenes["style"], style_weight=weight)
  ds = _Injected(batches)
  assert driver._fused_step_fn(model, cfg, ds) is None
  assert driver._fused_train_fn(model, cfg, ds) is None
  # the style module's params: flax's, from the same PRNGKey(0) init
  style = np.asarray(imageio.imread(scenes["style"]), np.float32) / 255.0
  style = cv2.resize(style[..., :3], (c, c))[None]
  _, sparams = _style_params(style, style)
  style_fn = driver._make_style_fn(cfg)
  style_fn.module.load_state_dict(convert.params_from_flax(
      jax.tree.map(np.asarray, sparams)))
  _three_steps_match(jmodel, tree, batches, jloss, model, cfg, monkeypatch,
                     style_fn=style_fn)


def test_three_steps_on_an_rgba_fixture_through_the_main_step(scenes,
                                                               monkeypatch):
  n = 48
  tds = sampler.RayDataset.from_bundle(
      loaders.load(scenes["lego"], "original", size=24), size=24)
  jds = jsampler.RayDataset.from_bundle(
      jloaders.load(scenes["lego"], "original", size=24), size=24)
  np.testing.assert_array_equal(tds.pixels.numpy(), np.asarray(jds.pixels))
  assert tds.pixels.shape[-1] == 4
  gen = torch.Generator().manual_seed(2)
  batches = []
  for _ in range(3):
    rays, pix, _, _ = tds.sample(gen, n)
    batches.append((rays.numpy(), pix.numpy()))
  jmodel = jmodels.PlainNeRF(steps=STEPS)
  tree = _jax_tree(jmodel, batches[0][0], 7, np.random.default_rng(4))
  model = models.PlainNeRF(steps=STEPS)
  cfg = driver.TrainConfig(steps=10, batch_size=n, learning_rate=5e-4)
  fused_step = driver._fused_step_fn(model, cfg, _Injected(batches))
  assert fused_step is not None                      # the one-kernel step
  _three_steps_match(jmodel, tree, batches, jlosses.load_loss_fn(), model,
                     cfg, monkeypatch, fused_step=fused_step)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_runner_trains_baseline_config_1_with_msssim(scenes, tmp_path):
  argv = ["-d", scenes["lego"], "--data-kind", "original", "--model", "tiny",
          "--size", "24", "--steps", "8", "--crop-size", "16",
          "--loss-fns", "l2", "ssim", "fft", "--style-img", scenes["style"],
          "--msssim-loss", "--epochs", "3", "--batch-size", "512",
          "--nosave", "--outdir", str(tmp_path)]
  results = runner.main(argv, device="cpu")
  assert results["engaged_path"] == "oracle"
  for split in ("train", "test"):
    assert len(results[split]["ssims"]) == (3 if split == "train" else 2)
    assert all(np.isfinite(results[split]["ssims"]))
    with open(os.path.join(tmp_path, split, "results.txt")) as f:
      text = f.read()
    assert "MS-SSIM" in text and "MS-SSIM mean" in text


@pytest.mark.parametrize("flags,crop", [
    (["--loss-fns", "l2", "ssim"], 32), (["--loss-fns", "fft"], 32),
    (["--style-img", "x.png"], 32), (["--crop-size", "8"], 8),
    (["--loss-fns", "l1"], 0)])
def test_crop_size_auto_set_as_the_root_runner(flags, crop):
  args = cli.arguments(["--data-kind", "synthetic", "--epochs", "5", *flags])
  assert runner.make_train_config(args).crop_size == crop


def test_eval_scores_a_render_of_another_size_against_a_resized_ref(
    tmp_path):
  ds = sampler.RayDataset.from_bundle(
      loaders.load("", "synthetic", size=12, num_views=1), size=12)
  model = driver.init_model(models.TinyNeRF(steps=8), seed=0)
  out = driver.test(model, ds, out_dir=str(tmp_path), render_size=8)
  img = driver.render_view(model, ds, 0, 8)
  ref = image_io.resize_linear(ds.pixels[0, ..., :3].numpy(), (8, 8))
  mse = float(np.mean((img[..., :3] - ref) ** 2))
  np.testing.assert_allclose(out["psnrs"][0], -10 * np.log10(mse),
                             rtol=1e-6)
