"""The PlainNeRF-hash slice in the port: K1/K2/K3 in hash mode, the train
paths, the gates and the runner, on the CPU against the JAX package.

- The plain K1-hash (`plain_hash_render_reference` on the features of the
  plain K5f) and the port's `PlainNeRF(enc_kind="hash")` against the JAX
  `PlainNeRF(enc_kind="hash", enc_kwargs={"table_size": 2^12})` forward
  at full width: 2e-4 on rgb and acc, as for cp (tests/test_torch_render.py).
- The plain K3-hash and K2-hash (autograd through the plain K1-hash; the
  table gradient chained through the plain K5b) against `jax.value_and_grad`
  through the JAX model at matmul precision "highest": loss 1e-5 relative,
  each gradient tensor (the table's included) 1e-4 relative.
- Three train steps of each port path (the one-kernel step K5f + K3 +
  K5b, the two-kernel path through `HashEncode` and `PlainHashRender`,
  and `--no-fused`) against the same three steps composed in JAX (oracle
  value_and_grad + optax): the loss of each step 1e-5 relative, each
  gradient tensor of each step 1e-4 relative, the table's included.
- `params_from_flax` carries the table as it is; Adam stays dense over
  the table as optax's does; a checkpoint carries the table.
- The gates engage the hash paths; the runner trains and renders
  PlainNeRF-hash on the CPU; `--enc-kind ref-hash` raises.
- `cuda`-marked cases: K1/K2/K3 in hash mode and the chained table
  gradient against their plain versions on the card (run with
  `python -m pytest --noconftest -m cuda tests/test_torch_hash_render.py`).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, runner, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import hash_encode as hk  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402
from nerf_atlas_tpu_torch.train import checkpoints, driver  # noqa: E402
from nerf_atlas_tpu_torch.train import losses, optim  # noqa: E402

STEPS = 16
N = 48
TABLE = 1 << 12
CASES = [("black", "thin", False), ("black", "thin", True),
         ("white", "normal", True), ("random", "tanh", True)]


def _rays(n=N, seed=0):
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(size=(n, 3)) * 0.1
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


def _amplify(tree):
  """Output layers scaled and the table spread to U(-1, 1)-like values so
  that rgb spans (0, 1) and the features move density."""
  p = tree["params"]
  p["refl"]["mlp"]["layer_out"]["kernel"] = (
      p["refl"]["mlp"]["layer_out"]["kernel"] * 40.0)
  p["density_mlp"]["layer_out"]["kernel"] = (
      p["density_mlp"]["layer_out"]["kernel"] * 8.0)
  p["density_mlp"]["enc"]["table"] = p["density_mlp"]["enc"]["table"] * 1e4
  return tree


def _jax_model(sky_kind="black", sigmoid_kind="thin", rays=None,
               amplify=False, seed=0):
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  model = jmodels.PlainNeRF(steps=STEPS, t_near=2.0, t_far=6.0,
                            sky_kind=sky_kind, sigmoid_kind=sigmoid_kind,
                            enc_kind="hash",
                            enc_kwargs={"table_size": TABLE})
  params = model.init({"params": jax.random.PRNGKey(seed),
                       "sampler": jax.random.PRNGKey(seed + 1)},
                      jnp.asarray(_rays() if rays is None else rays),
                      train=True)
  tree = jax.tree.map(np.asarray, params)
  return model, (_amplify(tree) if amplify else tree)


def _jax_ts(steps=STEPS):
  """The JAX package's eval grid: jnp.linspace, which differs from
  torch.linspace in the last bit of some entries. A hash grid with
  U(-1, 1) entries turns one ulp of a sample point into ~1e-4 of its
  finest level's features, so the port is handed the grid the JAX model
  used."""
  import jax.numpy as jnp
  return torch.from_numpy(np.array(jnp.linspace(2.0, 6.0, steps,
                                                dtype=jnp.float32)))


def _feats(sd, rays, ts):
  return hk.hash_encode_reference(sd[k1.HASH_TABLE_KEY], k1.hash_pts(rays, ts))


@pytest.mark.parametrize("sky_kind,sigmoid_kind,amplify", CASES)
def test_plain_hash_render_and_module_match_jax(sky_kind, sigmoid_kind,
                                                amplify, monkeypatch):
  import jax.numpy as jnp
  from nerf_atlas_tpu_torch.ops import rays as trays
  rays = _rays()
  model, tree = _jax_model(sky_kind, sigmoid_kind, rays, amplify)
  out_j = model.apply(tree, jnp.asarray(rays))
  rgb_j = np.asarray(out_j["rgb"])
  acc_j = np.asarray(out_j["weights"]).sum(-1)
  sd = convert.params_from_flax(tree)
  assert np.array_equal(sd[k1.HASH_TABLE_KEY].numpy(),
                        tree["params"]["density_mlp"]["enc"]["table"])
  tr, ts = torch.from_numpy(rays), _jax_ts()
  kw = dict(steps=STEPS, sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
  ref = k1.plain_hash_render_reference(sd, tr, _feats(sd, tr, ts), ts=ts,
                                       **kw)
  np.testing.assert_allclose(ref[:, :3].numpy(), rgb_j, atol=2e-4, rtol=0)
  np.testing.assert_allclose(ref[:, 3].numpy(), acc_j, atol=2e-4, rtol=0)
  before = k1.plain_hash_render.launches
  grid = torch.linspace(2.0, 6.0, STEPS)
  assert torch.equal(k1.fused_plain_hash_render(
      k1.pack_weights(sd, enc_kind="hash"), sd[k1.HASH_TABLE_KEY], tr, **kw),
      k1.plain_hash_render_reference(sd, tr, _feats(sd, tr, grid), **kw))
  assert k1.plain_hash_render.launches == before     # no kernel on the CPU
  monkeypatch.setattr(trays, "compute_ts", lambda *a, **k: ts)
  port = models.PlainNeRF(steps=STEPS, enc_kind="hash", table_size=TABLE,
                          sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  port.load_state_dict(sd)
  with torch.no_grad():
    out = port(tr)
  np.testing.assert_allclose(out["rgb"].numpy(), rgb_j, atol=2e-4, rtol=0)
  if amplify:
    assert rgb_j.std() > 0.05


def _jax_value_and_grads(model, tree, rays, target=None, g=None):
  import jax
  import jax.numpy as jnp

  def fn(p):
    out = model.apply(p, jnp.asarray(rays))
    if target is not None:
      return jnp.mean((out["rgb"] - jnp.asarray(target)) ** 2)
    full = jnp.concatenate([out["rgb"], out["weights"].sum(-1)[:, None]], -1)
    return jnp.sum(full * jnp.asarray(g))

  with jax.default_matmul_precision("highest"):
    value, grads = jax.value_and_grad(fn)(jax.tree.map(jnp.asarray, tree))
  return float(value), {k: v.numpy() for k, v in convert.params_from_flax(
      jax.tree.map(np.asarray, grads)).items()}


def _assert_grads(ours, ref, rtol=1e-4):
  assert set(ours) == set(ref)
  for key, r in ref.items():
    got = np.asarray(ours[key])
    err = np.linalg.norm(got - r) / max(np.linalg.norm(r), 1e-30)
    assert err <= rtol, (key, err)


@pytest.mark.parametrize("sky_kind,sigmoid_kind,amplify", CASES[1:])
def test_plain_hash_k2_k3_match_jax(sky_kind, sigmoid_kind, amplify):
  rays = _rays(seed=1)
  model, tree = _jax_model(sky_kind, sigmoid_kind, rays, amplify)
  rng = np.random.default_rng(2)
  target = rng.uniform(size=(N, 3)).astype(np.float32)
  g = rng.normal(size=(N, 4)).astype(np.float32)
  sd = convert.params_from_flax(tree)
  tr, ts = torch.from_numpy(rays), _jax_ts()
  kw = dict(steps=STEPS, sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  pts = k1.hash_pts(tr, ts)
  table = sd[k1.HASH_TABLE_KEY]

  loss_j, grads_j = _jax_value_and_grads(model, tree, rays, target=target)
  loss, dws, dtable = k1.fused_plain_hash_train_step(
      sd, table, tr, torch.from_numpy(target), **kw)
  assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
  _assert_grads({**k1.unpack_grads(dws), k1.HASH_TABLE_KEY: dtable},
                grads_j)

  _, grads_j = _jax_value_and_grads(model, tree, rays, g=g)
  dws, dfeat = k1.plain_hash_render_grad(sd, tr, _feats(sd, tr, ts),
                                         torch.from_numpy(g), **kw)
  dtable = hk.hash_encode_table_grad(pts, dfeat, TABLE)
  _assert_grads({**k1.unpack_grads(dws), k1.HASH_TABLE_KEY: dtable},
                grads_j)
  # the autograd Functions on the CPU: the same numbers
  ws = k1.pack_weights(sd, enc_kind="hash").requires_grad_(True)
  leaf = table.clone().requires_grad_(True)
  out = k1.fused_plain_hash_render_train(ws, leaf, tr, **kw)
  (out * torch.from_numpy(g)).sum().backward()
  torch.testing.assert_close(ws.grad, dws, rtol=1e-6, atol=1e-9)
  torch.testing.assert_close(leaf.grad, dtable, rtol=1e-6, atol=1e-9)


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
  """Each step's loss and gradients (table included) against the JAX
  oracle + optax on injected batches, the eval grid as the step's ts.
  The biases start from seeded random values (see tests/test_torch_train.py
  for why a zero bias would only measure its float32 cancellation)."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import losses as jlosses
  from nerf_atlas_tpu.train import optim as joptim
  from nerf_atlas_tpu_torch.ops import rays as trays
  n, lr = 32, 5e-4
  rng = np.random.default_rng(3)
  batches = [(_rays(n, 10 + i), rng.uniform(0, 1, (n, 4)).astype(np.float32))
             for i in range(3)]
  jmodel, tree = _jax_model(rays=batches[0][0], seed=5)
  tree = jax.tree_util.tree_map_with_path(
      lambda p, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                    if "bias" in jax.tree_util.keystr(p) else v), tree)
  tree["params"]["density_mlp"]["enc"]["table"] = rng.uniform(
      -1, 1, tree["params"]["density_mlp"]["enc"]["table"].shape).astype(
          np.float32)

  tx = joptim.load_optimizer("adam", lr, total_steps=10)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)
  loss_fn = jlosses.load_loss_fn()
  ref_steps = []
  for rays, pix in batches:
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
  model = models.PlainNeRF(steps=STEPS, enc_kind="hash", table_size=TABLE)
  model.load_state_dict(convert.params_from_flax(tree))
  ds = _InjectedBatches(batches)
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
    loss = float(step(i, gen)["loss"])
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (path, i, loss, loss_j)
    _assert_grads({k: v.numpy() for k, v in seen[i].items()},
                  {k: v.numpy() for k, v in grads_j.items()})


def test_adam_stays_dense_over_the_table():
  """An entry whose gradient is zero at a step still moves by its running
  moments, as under optax.adam."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import optim as joptim
  rng = np.random.default_rng(4)
  init = rng.uniform(-1e-4, 1e-4, (64, 2)).astype(np.float32)
  grads = [rng.normal(size=(64, 2)).astype(np.float32) for _ in range(3)]
  grads[1][:32] = 0.0                        # untouched rows at step 2
  grads[2][16:48] = 0.0
  tx = joptim.load_optimizer("adam", 1e-3, total_steps=10)
  jp = jnp.asarray(init)
  state = tx.init(jp)
  p = torch.nn.Parameter(torch.from_numpy(init.copy()))
  opt = optim.load_optimizer([p], "adam", 1e-3, total_steps=10)
  for g in grads:
    updates, state = tx.update(jnp.asarray(g), state, jp)
    jp = jp + updates
    opt.zero_grad()
    p.grad = torch.from_numpy(g)
    opt.step()
  np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-7,
                             rtol=1e-6)
  assert not np.allclose(np.asarray(jp)[:16], init[:16])
  del jax


def test_checkpoint_carries_the_table(tmp_path):
  model = driver.init_model(models.PlainNeRF(steps=STEPS, enc_kind="hash",
                                             table_size=1 << 8), seed=3)
  path = checkpoints.save(str(tmp_path / "m.ckpt"), model.state_dict())
  again = models.PlainNeRF(steps=STEPS, enc_kind="hash", table_size=1 << 8)
  again.load_state_dict(checkpoints.load(path)["params"])
  assert torch.equal(again.density_mlp.enc.table,
                     model.density_mlp.enc.table)
  other = models.PlainNeRF(steps=STEPS, enc_kind="hash", table_size=1 << 9)
  with pytest.raises(RuntimeError):
    other.load_state_dict(checkpoints.load(path)["params"])


def test_gates_engage_the_hash_paths():
  from nerf_atlas_tpu_torch.data import loaders, sampler
  ds = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=8, num_views=2), size=8)
  model = driver.init_model(models.PlainNeRF(steps=STEPS, enc_kind="hash",
                                             table_size=1 << 8), seed=0)
  assert driver._fused_enc_kind(model) == "hash"
  cfg = driver.TrainConfig()
  assert driver._fused_step_fn(model, cfg, ds) is not None
  assert driver._fused_train_fn(model, cfg, ds) is not None
  assert driver._fused_render_fn(model) is not None
  l1 = driver.TrainConfig(loss_kinds=("l1",))
  assert driver._fused_step_fn(model, l1, ds) is None
  assert driver._fused_train_fn(model, l1, ds) is not None
  noisy = models.PlainNeRF(steps=STEPS, enc_kind="hash", table_size=1 << 8,
                           density_noise=0.5)
  assert driver._fused_step_fn(noisy, cfg, ds) is None
  with pytest.raises(NotImplementedError, match="table_size"):
    models.PlainNeRF(enc_kind="cp", table_size=1 << 8)
  with pytest.raises(NotImplementedError, match="Queue 1 #7"):
    models.PlainNeRF(enc_kind="ref-hash")
  sd = dict(model.state_dict())
  sd[k1.HASH_TABLE_KEY] = sd[k1.HASH_TABLE_KEY][:100]
  with pytest.raises(ValueError):
    k1.pack_weights(sd, enc_kind="hash")
  with pytest.raises(KeyError):
    k1.pack_weights(model.state_dict())          # a hash tree is not cp


def _run(tmp_path, name, *extra):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic", "--size", "16",
                     "--num-views", "4", "--steps", str(STEPS),
                     "--batch-size", "64", "-lr", "1e-3", "--seed", "0",
                     "--enc-kind", "hash", "--hash-table-log2", "12",
                     "--valid-freq", "0", "--outdir", str(out), *extra],
                    device="cpu")
  return res, out


def test_runner_trains_hash_on_cpu(tmp_path):
  res0, _ = _run(tmp_path, "untrained", "--epochs", "0")
  res, out = _run(tmp_path, "trained", "--epochs", "12")
  assert res["engaged_path"] == "fused-one-kernel"
  with open(out / "log.json") as f:
    logged = json.load(f)
  assert logged["engaged_path"] == "fused-one-kernel"
  assert logged["hash_table_log2"] == 12
  raw = checkpoints.load(str(out / "model.ckpt"))
  assert raw["params"][k1.HASH_TABLE_KEY].shape == (8 << 12, 2)
  for split in ("train", "test"):
    assert all(np.isfinite(res[split]["psnrs"]))
    assert res[split]["psnr_mean"] > res0[split]["psnr_mean"] + 1.0
    lines = (out / split / "results.txt").read_text().splitlines()
    assert lines[0].startswith("view 000: PSNR ")
    assert lines[-1].startswith("PSNR mean ")


def test_runner_ref_hash_raises(tmp_path):
  with pytest.raises(NotImplementedError, match="Queue 1 #7"):
    _run(tmp_path, "ref", "--epochs", "0", "--enc-kind", "ref-hash")


def _cuda_case(n, steps, sky, seed, table_size=1 << 14):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run the kernels")
  torch.backends.cuda.matmul.allow_tf32 = False
  model = driver.init_model(models.PlainNeRF(
      steps=steps, enc_kind="hash", table_size=table_size, sky_kind=sky),
      seed=seed)
  sd = dict(model.state_dict())
  sd[k1.HASH_TABLE_KEY] = sd[k1.HASH_TABLE_KEY] * 1e4
  sd = {k: v.cuda() for k, v in sd.items()}
  gen = torch.Generator(device="cuda").manual_seed(seed)
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                           device="cuda")
  rays = torch.from_numpy(_rays(n, seed)).cuda()
  feats = hk.hash_encode(sd[k1.HASH_TABLE_KEY], k1.hash_pts(rays, ts))
  ws = k1.pack_weights(sd, "cuda", "hash")
  return sd, ws, rays, ts, feats, gen, dict(steps=steps, sky_kind=sky, ts=ts)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n", [(64, 1001), (16, 77)])
def test_cuda_hash_render_matches_plain(steps, n):
  """K1-hash vs the plain K1-hash on the card: 1e-4 abs."""
  _, ws, rays, _, feats, _, kw = _cuda_case(n, steps, "white", 1)
  before = k1.plain_hash_render.launches
  out = k1.plain_hash_render(ws, rays, feats, **kw)
  torch.cuda.synchronize()
  assert k1.plain_hash_render.launches == before + 1
  ref = k1.plain_hash_render_reference(ws, rays, feats, **kw)
  assert float((out - ref).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n", [(64, 300), (16, 77)])
def test_cuda_hash_k2_k3_match_plain(steps, n):
  """K2/K3-hash vs their plain versions: loss 1e-5 relative; each weight
  gradient tensor and dfeat 1e-4 relative with a zero cotangent on the
  rays near a leaky-relu kink (`kink_free_rays`); the chained table
  gradient (K3 -> K5b) against autograd through the plain path, 1e-4."""
  sd, ws, rays, ts, feats, gen, kw = _cuda_case(n, steps, "black", 2)
  keep = testing.kink_free_rays(ws, rays, ts, steps, feats=feats)
  out = k1.plain_hash_render_reference(ws, rays, feats, **kw)[:, :3]
  target = torch.where(keep[:, None], torch.rand(n, 3, device="cuda",
                                                 generator=gen), out)
  target = target.contiguous()
  loss, dws, dfeat = k1.plain_hash_train_step(ws, rays, feats, target, **kw)
  loss_r, dws_r, dfeat_r = k1.plain_hash_train_step_reference(
      ws, rays, feats, target, **kw)
  assert abs(float(loss) - float(loss_r)) <= 1e-5 * float(loss_r)
  ug, ur = k1.unpack_grads(dws), k1.unpack_grads(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
  assert float((dfeat - dfeat_r).norm() / dfeat_r.norm()) <= 1e-4
  g = torch.randn(n, 4, device="cuda", generator=gen) * keep[:, None]
  dws, dfeat = k1.plain_hash_render_grad(ws, rays, feats, g, **kw)
  dws_r, dfeat_r = k1.plain_hash_render_grad_reference(ws, rays, feats, g,
                                                       **kw)
  ug, ur = k1.unpack_grads(dws), k1.unpack_grads(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
  assert float((dfeat - dfeat_r).norm() / dfeat_r.norm()) <= 1e-4
  table = sd[k1.HASH_TABLE_KEY]
  _, _, dtable = k1.fused_plain_hash_train_step(ws, table, rays, target,
                                                **kw)
  leaf = table.clone().requires_grad_(True)
  pts = k1.hash_pts(rays, ts)
  out = k1.plain_hash_render_reference(
      ws, rays, hk.hash_encode_reference(leaf, pts), **kw)
  torch.mean((out[:, :3] - target) ** 2).backward()
  assert float((dtable - leaf.grad).norm() / leaf.grad.norm()) <= 1e-4
