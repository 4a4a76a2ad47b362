"""CoarseFineNeRF training in the port, on the CPU against the JAX package:
the two train paths, the gates, the runner.

- Three train steps of the two-kernel path (K1 + K2 twice through
  `fused_coarse_fine_train`) and of `--no-fused` (the module forward
  under autograd), in cp and cone, on injected batches, against the same
  three steps composed in JAX: the JAX model's coarse pass, the JAX
  package's `sample_pdf` with the step's key and `merge_ts`, the fine
  pass, the sum of both passes' l2 (train/driver.py:716-718, :786-787),
  `jax.value_and_grad` and the JAX package's optax chain. The loss of
  each step 1e-5 relative, each gradient tensor 1e-4 relative, the
  port's last Adam update 1e-2 of the learning rate, as
  tests/test_torch_k4_train.py holds the K4 modes (seeded biases, the
  port's weights set to the JAX trajectory's before each step). The port
  takes each step's ts (`compute_ts` of the step's first key) and u (the
  `jax.random.uniform` draw `sample_pdf` makes from its second key), and
  the JAX package's IPE scales (tests/test_torch_coarse_fine.py says
  why). In cone the port's fine pass also takes JAX's merged ts, after
  its own are held to them at 1e-5 abs (measured 1.4e-6): the two CDFs
  differ by round-off (XLA and torch sum in different orders), the
  inversion carries that into the fine positions, and the IPE's 2^15
  band turns a 1.4e-6 shift of a narrow segment into a 5e-4 relative
  change of a weight gradient (0.046 rad of phase). cp is held through
  its own sampling. Each batch holds only rays that `testing.kink_free_rays`
  clears on both passes' ts at that step's weights (a ray that does not is
  swapped for a spare one, so that the batch keeps its shape and each row
  its u).
- The gates: the two-kernel path and the eval render engage for cp,
  posenc, cone and cylinder; none for hash, a refl other than View,
  intermediate ≠ 32, timed data, or more samples per ray (steps +
  fine_steps) than K2 holds; the one-kernel step never.
- The runner trains and renders `--model coarse_fine --mip cone` on the
  CPU at a tiny size through the two-kernel path, passes --enc-kind (cp
  by default, not the class's hash), and trains `--enc-kind hash`
  through the module forward.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import cli, convert, models, runner  # noqa: E402
from nerf_atlas_tpu_torch import testing  # noqa: E402
from nerf_atlas_tpu_torch.ops import sampling  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, losses, optim  # noqa: E402

from test_torch_coarse_fine import FINE, STEPS, jax_model  # noqa: E402
from test_torch_coarse_fine import jax_numerics, jax_pass  # noqa: E402
from test_torch_coarse_fine import port_model  # noqa: E402
from test_torch_k4_train import _InjectedBatches, _rays  # noqa: E402

MODES = ["cp", "posenc", "cone", "cylinder"]
LR = 5e-4


def _jax_step_fn(model, rays, pix, ts, key):
  """One coarse_fine step of the JAX model on given ts [T] and the
  sample_pdf key: (fine_ts(params) -> the fine pass's merged ts, the
  coarse pass, the JAX package's `sample_pdf` and `merge_ts`, run
  eagerly; loss(params, all_ts) -> the sum of both passes' l2, the fine
  pass on all_ts). The fine ts enter the gradient as the constants they
  are (the sampling takes no gradient): traced under value_and_grad,
  XLA's sampling moves them by up to 9.5e-7, which in cone moves a
  weight gradient by 2.3e-4."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import sampling as jsampling
  from nerf_atlas_tpu.train import losses as jlosses
  loss_fn = jlosses.load_loss_fn()

  def sample(m, rays):
    w = jax.lax.stop_gradient(jax_pass(m, rays, ts)["weights"])
    ts_b = jnp.broadcast_to(ts, w.shape)
    return jsampling.merge_ts(ts_b, jsampling.sample_pdf(
        ts_b, w, N=m.fine_steps, key=key))

  def passes(m, rays, all_ts):
    return (loss_fn(jax_pass(m, rays, all_ts)["rgb"], jnp.asarray(pix))
            + loss_fn(jax_pass(m, rays, ts)["rgb"], jnp.asarray(pix)))

  def fine_ts(p):
    return np.array(model.apply(p, jnp.asarray(rays), method=sample))

  def loss(p, all_ts):
    return model.apply(p, jnp.asarray(rays), jnp.asarray(all_ts),
                       method=passes)

  return fine_ts, loss


@functools.lru_cache(maxsize=None)
def _jax_trajectory(mode):
  """Three JAX steps: (initial tree, [(rays, pix, ts, u, the fine pass's
  merged ts, loss, grads, weights before the step)], the weights after
  the third step)."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import rays as jrays
  from nerf_atlas_tpu.train import optim as joptim
  n = 24
  rng = np.random.default_rng(3)
  jmodel = jax_model(mode)
  rays0 = _rays(n, 10)
  tree = jax.tree.map(np.asarray, jmodel.init(
      {"params": jax.random.PRNGKey(5), "sampler": jax.random.PRNGKey(6)},
      jnp.asarray(rays0), train=True))
  tree = jax.tree_util.tree_map_with_path(
      lambda p, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                    if "bias" in jax.tree_util.keystr(p) else v), tree)
  tx = joptim.load_optimizer("adam", LR, total_steps=10)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)
  steps = []
  for i in range(3):
    k_ts, k_pdf = jax.random.split(jax.random.PRNGKey(20 + i))
    ts = jrays.compute_ts(2.0, 6.0, STEPS, perturb=1.0, key=k_ts)
    pool = _rays(3 * n, 10 + i)
    pix = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    weights = convert.params_from_flax(jax.tree.map(np.asarray, params))
    rows, spare = list(range(n)), n
    # swap in spare rays until every ray clears the kinks on both passes
    # (a fixed batch shape: each row keeps its u and its target)
    while True:
      rays = pool[rows]
      fine_fn, loss_fn = _jax_step_fn(jmodel, rays, pix, ts, k_pdf)
      tr, all_ts = torch.from_numpy(rays), fine_fn(params)
      keep = (testing.kink_free_rays(weights, tr, torch.from_numpy(
          np.array(ts)), STEPS, enc_kind=mode)
              & testing.kink_free_rays(weights, tr, torch.from_numpy(all_ts),
                                       STEPS + FINE, enc_kind=mode)).numpy()
      if keep.all():
        break
      for j in np.flatnonzero(~keep):
        rows[j], spare = spare, spare + 1
      assert spare <= len(pool)
    with jax.default_matmul_precision("highest"):
      loss, grads = jax.value_and_grad(loss_fn)(params, all_ts)
    u = np.array(jax.random.uniform(k_pdf, (rays.shape[0], FINE),
                                    dtype=jnp.float32))
    steps.append((rays, pix, np.array(ts), u, all_ts, float(loss),
                  convert.params_from_flax(jax.tree.map(np.asarray, grads)),
                  weights))
    updates, state = tx.update(grads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
  return tree, steps, convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params))


@pytest.mark.parametrize("mode", ["cp", "cone"])
@pytest.mark.parametrize("path", ["fused", "oracle"])
def test_three_steps_match_jax(mode, path, monkeypatch):
  from nerf_atlas_tpu_torch.ops import rays as trays
  jax_numerics(monkeypatch, mode)
  tree, ref_steps, final = _jax_trajectory(mode)
  model = port_model(mode)
  model.load_state_dict(convert.params_from_flax(tree))
  ds = _InjectedBatches([(r, p) for r, p, *_ in ref_steps])
  cfg = driver.TrainConfig(steps=10, batch_size=24, learning_rate=LR,
                           no_fused=path == "oracle")
  opt = optim.load_optimizer(model.parameters(), "adam", LR, total_steps=10)
  seen = []
  inner = opt.step

  def record():
    seen.append({k: p.grad.clone() for k, p in model.named_parameters()})
    inner()

  opt.step = record
  assert driver._fused_step_fn(model, cfg, ds) is None
  fused_train = driver._fused_train_fn(model, cfg, ds)
  assert (fused_train is None) == (path == "oracle")
  step = driver.make_train_step(model, ds, losses.load_loss_fn(), opt, cfg,
                                fused_train=fused_train)
  gen = torch.Generator().manual_seed(0)
  merge = sampling.merge_ts

  def jax_merged(all_ts):
    def merged(coarse, fine):
      own = merge(coarse, fine)
      np.testing.assert_allclose(own.detach().numpy(), all_ts, atol=1e-5,
                                 rtol=0)
      return torch.from_numpy(all_ts)
    return merged

  for i, (_, _, ts, u, all_ts, loss_j, grads_j, weights) in enumerate(
      ref_steps):
    monkeypatch.setattr(trays, "compute_ts",
                        lambda *a, ts=ts, **kw: torch.from_numpy(ts))
    monkeypatch.setattr(sampling, "uniform_u",
                        lambda *a, u=u, **kw: torch.from_numpy(u))
    if mode in k1.MIP_KINDS:
      monkeypatch.setattr(sampling, "merge_ts", jax_merged(all_ts))
    with torch.no_grad():
      model.load_state_dict(weights)
    loss = float(step(i, gen)["loss"])
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (path, i, loss, loss_j)
    for key, ref in grads_j.items():
      err = float((seen[i][key] - ref).norm() / ref.norm())
      assert err <= 1e-4, (path, i, key, err)
  for key, p in model.state_dict().items():
    before = ref_steps[-1][-1][key]
    err = float(((p - before) - (final[key] - before)).abs().max())
    assert err <= 1e-2 * LR, (path, key, err / LR)


def _dataset(kind="synthetic"):
  from nerf_atlas_tpu_torch.data import loaders, sampler
  return sampler.RayDataset.from_bundle(
      loaders.load("", data_kind=kind, size=8, num_views=2), size=8)


def _gates(model, cfg, ds):
  return (driver._fused_step_fn(model, cfg, ds),
          driver._fused_train_fn(model, cfg, ds),
          driver._fused_render_fn(model))


@pytest.mark.parametrize("mode", MODES)
def test_gates_engage_coarse_fine_in_its_envelope(mode):
  ds, cfg = _dataset(), driver.TrainConfig()
  model = driver.init_model(port_model(mode), seed=0)
  assert driver._fused_enc_kind(model) == mode
  assert driver.model_kind(model) == "coarse_fine"
  step, train, render = _gates(model, cfg, ds)
  assert step is None and train is not None and render is not None
  # no one-kernel step for any coarse_fine, whatever the loss
  assert _gates(model, driver.TrainConfig(loss_kinds=("l1",)), ds)[0] is None
  assert _gates(model, driver.TrainConfig(no_fused=True), ds)[:2] == (None,
                                                                      None)
  # outside the envelope
  if mode in k1.MIP_KINDS:                     # mip overrides enc_kind
    hashed = models.CoarseFineNeRF(steps=STEPS, mip=mode, enc_kind="hash")
    assert driver._fused_enc_kind(hashed) == mode
  hashed = driver.init_model(models.CoarseFineNeRF(steps=STEPS), seed=0)
  assert driver._fused_enc_kind(hashed) is None
  assert _gates(hashed, cfg, ds) == (None, None, None)
  for kw in (dict(intermediate_size=16), dict(sigmoid_kind="softmax"),
             dict(lindisp=True)):
    other = driver.init_model(port_model(mode, **kw), seed=0)
    assert _gates(other, cfg, ds) == (None, None, None), kw
  other = port_model(mode)
  other.refl_kind = "basic"                    # the port's refl is View only
  assert _gates(other, cfg, ds) == (None, None, None)
  timed = _dataset("synthetic-dyn")
  assert timed.times is not None
  assert _gates(model, cfg, timed)[:2] == (None, None)
  # the fine pass is steps + fine_steps samples: K2's cap
  cap = k1.BWD_MAX_STEPS[mode]
  at = driver.init_model(port_model(mode, steps=cap - 64, fine_steps=64),
                         seed=0)
  assert _gates(at, cfg, ds)[1] is not None
  over = driver.init_model(port_model(mode, steps=cap - 63, fine_steps=64),
                           seed=0)
  step, train, render = _gates(over, cfg, ds)
  assert step is None and train is None and render is not None


def test_runner_builds_coarse_fine_with_its_flags():
  """The runner passes --enc-kind (cp by default: runner.py:459-467), --mip
  and --refl-kind; the class's own default encoder is hash."""
  args = cli.arguments(["--data-kind", "synthetic", "--model", "coarse_fine"])
  model = runner.build_model(args, "cpu")
  assert isinstance(model, models.CoarseFineNeRF)
  assert (model.enc_kind, model.mip, model.fine_steps) == ("cp", None, 64)
  assert models.CoarseFineNeRF().enc_kind == "hash"
  args = cli.arguments(["--data-kind", "synthetic", "--model", "coarse_fine",
                        "--mip", "cone", "--steps", "32"])
  model = runner.build_model(args, "cpu")
  assert (model.mip, model.steps) == ("cone", 32)
  assert driver._fused_enc_kind(model) == "cone"


def _run(tmp_path, name, *extra):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic", "--model", "coarse_fine",
                     "--size", "12", "--num-views", "3", "--steps", "8",
                     "--batch-size", "48", "-lr", "1e-3", "--seed", "0",
                     "--valid-freq", "0", "--outdir", str(out), *extra],
                    device="cpu")
  return res, out


def test_runner_trains_coarse_fine_mip_on_cpu(tmp_path, monkeypatch):
  calls = {"fused": 0, "forward": 0}
  inner_fused = k1.fused_coarse_fine_render
  inner_forward = models.CoarseFineNeRF.forward

  def fused(*a, **kw):
    calls["fused"] += 1
    return inner_fused(*a, **kw)

  def forward(self, *a, **kw):
    calls["forward"] += 1
    return inner_forward(self, *a, **kw)

  monkeypatch.setattr(k1, "fused_coarse_fine_render", fused)
  monkeypatch.setattr(models.CoarseFineNeRF, "forward", forward)
  res0, _ = _run(tmp_path, "untrained", "--mip", "cone", "--epochs", "0")
  res, out = _run(tmp_path, "trained", "--mip", "cone", "--epochs", "10")
  assert res["engaged_path"] == "fused"
  with open(out / "log.json") as f:
    assert json.load(f)["engaged_path"] == "fused"
  assert calls["forward"] == 0 and calls["fused"] > 0
  assert all(np.isfinite(h["loss"]) for h in res["history"])
  for split in ("train", "test"):
    assert all(np.isfinite(res[split]["psnrs"]))
    assert res[split]["psnr_mean"] > res0[split]["psnr_mean"] + 0.5
    lines = (out / split / "results.txt").read_text().splitlines()
    assert lines[-1].startswith("PSNR mean ")


def test_runner_trains_coarse_fine_hash_through_the_module(tmp_path):
  res, out = _run(tmp_path, "hash", "--enc-kind", "hash", "--epochs", "3")
  assert res["engaged_path"] == "oracle"
  assert all(np.isfinite(h["loss"]) for h in res["history"])
  assert all(np.isfinite(res["test"]["psnrs"]))
  res, _ = _run(tmp_path, "nofused", "--mip", "cone", "--epochs", "2",
                "--no-fused", "--notraintest")
  assert res["engaged_path"] == "oracle"
