"""The K4 training slice in the port (PlainNeRF-posenc, MipNeRF cone and
cylinder, TinyNeRF), on the CPU against the JAX package: the three train
paths, the gates, the runner.

- Three train steps of each port path (the one-kernel step K3, the
  two-kernel path K1 + K2 through `PlainCPRender`, and `--no-fused`) in
  each mode, on injected batches, against the same three steps composed
  in JAX (oracle value_and_grad + the JAX package's optax chain): the
  loss of each step 1e-5 relative, each gradient tensor of each step
  1e-4 relative, as tests/test_torch_ae_train.py holds NeRFAE: seeded
  biases, each step's batch cut to the rays `testing.kink_free_rays`
  clears at that step's weights, the port's weights set to the JAX
  trajectory's before each step (Adam's first updates are ±lr by the
  sign of each gradient entry, and entries that cancel to round-off take
  either sign in two float32 implementations), and the port's last Adam
  update, from the weights both sides share, held against optax's to
  1e-2 of the learning rate. The port takes the JAX eval grid as the
  step's ts and the JAX package's posenc bands (tests/test_torch_k4.py
  says why).
- The gates engage each family in its envelope (the step, the two-kernel
  path and the eval render) and return None outside it.
- The runner trains and renders `--enc-kind posenc`, `--mip cone` and
  `--model tiny` on the CPU at a tiny size through the one-kernel step;
  TinyNeRF at other widths raises, naming its ROADMAP item.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, runner, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402

from test_torch_k4 import jax_bands, jax_model, port_model  # noqa: E402

STEPS = 16
MODES = ["posenc", "tiny", "cone", "cylinder"]


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


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", ["fused-one-kernel", "fused", "oracle"])
def test_three_steps_match_jax(mode, path, monkeypatch):
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import losses as jlosses
  from nerf_atlas_tpu.train import optim as joptim
  from nerf_atlas_tpu_torch.ops import rays as trays
  jax_bands(monkeypatch)
  n, lr = 32, 5e-4
  rng = np.random.default_rng(3)
  batches = [(_rays(n, 10 + i), rng.uniform(0, 1, (n, 4)).astype(np.float32))
             for i in range(3)]
  jmodel = jax_model(mode)
  tree = jax.tree.map(np.asarray, jmodel.init(
      {"params": jax.random.PRNGKey(5), "sampler": jax.random.PRNGKey(6)},
      jnp.asarray(batches[0][0]), train=True))
  tree = jax.tree_util.tree_map_with_path(
      lambda p, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                    if "bias" in jax.tree_util.keystr(p) else v), tree)

  tx = joptim.load_optimizer("adam", lr, total_steps=10)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)
  loss_fn = jlosses.load_loss_fn()
  ref_steps, kept, trajectory = [], [], []
  for rays, pix in batches:
    trajectory.append(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    keep = testing.kink_free_rays(trajectory[-1], torch.from_numpy(rays),
                                  _jax_ts(), STEPS, enc_kind=mode).numpy()
    assert keep.sum() >= n // 2
    rays, pix = rays[keep], pix[keep]
    kept.append((rays, pix))

    def fn(p, rays=rays, pix=pix):
      return loss_fn(jmodel.apply(p, jnp.asarray(rays))["rgb"],
                     jnp.asarray(pix))
    with jax.default_matmul_precision("highest"):
      loss, grads = jax.value_and_grad(fn)(params)
    ref_steps.append((float(loss), convert.params_from_flax(
        jax.tree.map(np.asarray, grads))))
    updates, state = tx.update(grads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)

  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: _jax_ts())
  model = port_model(mode)
  model.load_state_dict(convert.params_from_flax(tree))
  ds = _InjectedBatches(kept)
  cfg = driver.TrainConfig(steps=10, batch_size=n, learning_rate=lr,
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
    loss = float(step(i, gen)["loss"])
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (path, i, loss, loss_j)
    for key, ref in grads_j.items():
      err = float((seen[i][key] - ref).norm() / ref.norm())
      assert err <= 1e-4, (path, i, key, err)
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


def _gates(model, cfg, ds):
  return (driver._fused_step_fn(model, cfg, ds),
          driver._fused_train_fn(model, cfg, ds),
          driver._fused_render_fn(model))


@pytest.mark.parametrize("mode", MODES)
def test_gates_engage_each_family_in_its_envelope(mode):
  ds = _dataset()
  cfg = driver.TrainConfig()
  model = driver.init_model(port_model(mode), seed=0)
  assert driver._fused_enc_kind(model) == mode
  assert all(fn is not None for fn in _gates(model, cfg, ds))
  l1 = driver.TrainConfig(loss_kinds=("l1",))
  step, train, _ = _gates(model, l1, ds)
  assert step is None and train is not None
  off = driver.TrainConfig(no_fused=True)
  assert _gates(model, off, ds)[:2] == (None, None)
  # outside the envelope: sky, noise, activation, sampling, widths
  noisy = driver.init_model(port_model(mode, density_noise=0.5), seed=0)
  step, train, render = _gates(noisy, cfg, ds)
  assert step is None and train is None and render is not None
  rnd = driver.init_model(port_model(mode, sky_kind="random"), seed=0)
  step, train, render = _gates(rnd, cfg, ds)
  assert step is None and train is None
  assert render is not None                    # "random" is black at eval
  outside = [dict(sigmoid_kind="softmax"), dict(lindisp=True)]
  if mode == "tiny":
    outside.append(dict(mip="cone"))           # the JAX tiny gate's rule
  else:
    outside.append(dict(intermediate_size=16))
  for kw in outside:
    other = driver.init_model(port_model(mode, **kw), seed=0)
    assert driver._fused_enc_kind(other) is None, kw
    assert _gates(other, cfg, ds) == (None, None, None), kw
  if mode in k1.MIP_KINDS:                      # mip overrides enc_kind
    hashed = models.PlainNeRF(steps=STEPS, mip=mode, enc_kind="hash")
    assert driver._fused_enc_kind(hashed) == mode
    assert "density_mlp.enc.table" not in hashed.state_dict()
  assert driver.model_kind(model) == ("tiny" if mode == "tiny" else "plain")


@pytest.mark.parametrize("mode", MODES)
def test_train_gates_hold_the_backward_step_cap(mode):
  """The port's one narrower train rule (`driver._fused_common_ok`): a
  ray of more samples than K2/K3 hold in shared memory (460 for mip,
  1024 for the other modes) trains through the module forward, K1 still
  renders it, and the wrapper's refusal names the cap."""
  ds = _dataset()
  cfg = driver.TrainConfig()
  cap = k1.BWD_MAX_STEPS[mode]
  at = driver.init_model(port_model(mode, steps=cap), seed=0)
  assert all(fn is not None for fn in _gates(at, cfg, ds))
  over = driver.init_model(port_model(mode, steps=cap + 1), seed=0)
  step, train, render = _gates(over, cfg, ds)
  assert step is None and train is None and render is not None
  ws = k1.pack_weights(over.state_dict(), "cpu", mode)
  rays = torch.from_numpy(_rays(2, 0))
  with pytest.raises(ValueError, match=rf"\[2, {cap}\], got {cap + 1}"):
    k1._check_call(ws, rays, cap + 1, "thin", "black", mode, cap)


def test_tiny_init_follows_the_jax_distributions():
  """The port's seeded TinyNeRF init draws from the JAX model's
  distributions (xavier uniform weights, zero biases, the same shapes):
  the two seed-0 inits differ as draws, not in kind."""
  import jax
  import jax.numpy as jnp
  tree = jax_model("tiny").init(
      {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
      jnp.zeros((8, 6)), train=True)
  ref = convert.params_from_flax(jax.tree.map(np.asarray, tree))
  sd = driver.init_model(port_model("tiny"), seed=0).state_dict()
  assert {k: tuple(v.shape) for k, v in sd.items()} == {
      k: tuple(v.shape) for k, v in ref.items()}
  for key, w in sd.items():
    if key.endswith(".bias"):
      assert float(w.abs().max()) == float(ref[key].abs().max()) == 0.0
      continue
    bound = np.sqrt(6.0 / sum(w.shape))
    for v in (w, ref[key]):
      assert bound * 0.98 <= float(v.abs().max()) <= bound * (1 + 1e-6)
    if w.numel() >= 4096:
      assert float(w.std()) == pytest.approx(bound / np.sqrt(3), rel=0.02)


def test_tiny_defaults_and_unported_widths():
  model = models.TinyNeRF()
  assert model.mlp.init_size == 51 and model.mlp.hidden_size == 128
  assert model.mlp.num_layers == 6 and model.mlp.out == 4
  assert models.load_model("tiny").mip is None
  models.TinyNeRF(mlp_kwargs={"num_layers": 6, "hidden_size": 128})
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    models.TinyNeRF(mlp_kwargs={"hidden_size": 256})
  mip = models.PlainNeRF(mip="cylinder")
  assert mip.density_mlp.init_size == 96 and mip.density_mlp.enc is None
  with pytest.raises(NotImplementedError):
    models.PlainNeRF(mip="sphere")


FAMILIES = {"posenc": ("--model", "plain", "--enc-kind", "posenc"),
            "mip-cone": ("--model", "plain", "--mip", "cone"),
            "tiny": ("--model", "tiny")}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_runner_trains_each_family_on_cpu(tmp_path, family):
  def run(name, *extra):
    out = tmp_path / name
    res = runner.main(["--data-kind", "synthetic", *FAMILIES[family],
                       "--size", "16", "--num-views", "4", "--steps",
                       str(STEPS), "--batch-size", "64", "-lr", "1e-3",
                       "--seed", "0", "--valid-freq", "0", "--outdir",
                       str(out), *extra], device="cpu")
    return res, out

  res0, _ = run("untrained", "--epochs", "0")
  res, out = run("trained", "--epochs", "12")
  assert res["engaged_path"] == "fused-one-kernel"
  with open(out / "log.json") as f:
    assert json.load(f)["engaged_path"] == "fused-one-kernel"
  assert np.isfinite(res["history"][0]["loss"])
  for split in ("train", "test"):
    assert all(np.isfinite(res[split]["psnrs"]))
    assert res[split]["psnr_mean"] > res0[split]["psnr_mean"] + 0.5
    lines = (out / split / "results.txt").read_text().splitlines()
    assert lines[-1].startswith("PSNR mean ")
  if family == "tiny":
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
      run("ref", "--epochs", "0", "--ref-compat")
