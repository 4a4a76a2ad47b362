"""Training the rest of the dynamic family in the port, on the CPU against
the JAX package: the train paths, progressive training, the gates, the
maps and frames (tests/test_torch_dyn_family_regs.py holds the
point-sampled regularizers' path, with `three_steps` below, and the
runner).

- `three_steps`: three train steps on injected batches with each ray's
  time, against the same three steps composed in JAX (value_and_grad
  through the JAX model + the JAX package's optax chain), each step's
  loss 1e-5 relative and each gradient tensor 1e-4 relative. Here:
  DynamicNeRFAE with --dp-weight, LongDynamicNeRF (posenc canonical)
  with the NR-NeRF offset, and DynamicNeRF with an 8-wide time latent
  (posenc canonical) with --dp-weight, the offset and the rigidity
  sparsity, through the module forward (`oracle`), the out-dict
  regularizers added by `total_regularizer`. As in
  tests/test_torch_dyn_train.py the port takes the JAX package's
  Fourier features (keeping their derivative in x,
  tests/test_torch_dyn_family.py `jax_features_in_x`) and posenc bands,
  each step's rays and points are those clear of the leaky-relu kinks at
  that step's weights (`testing.dyn_kink_free_rays` for the kernel path,
  `kink_free` for the module forwards and the points), the port's
  weights are set to the JAX trajectory's before each step and its last
  Adam update, from the weights both sides share, is held against optax's
  to 1e-2 of the learning rate. A one-element gradient (the rigidity's
  output bias) that misses the gate is held to a float64 witness
  (`_check_step`). DynamicNeRFAE's biases start seeded
  (tests/test_torch_ae_train.py says why).
- `train_progressive`: 2 segments × 2 steps of a LongDynamicNeRF, each
  segment's fresh optimizer (a schedule of cfg.steps), its views' window,
  no pixel jitter and its generator's seed (seed + 99 + s), against the
  JAX composition, the same way.
- The gates: point-sampled terms send a D-NeRF to the two-kernel path,
  out-dict terms, a time latent, another canonical, DynamicNeRFAE and
  LongDynamicNeRF to the module forward; a static model with a latent
  leaves every kernel; `check_config` carries the dynamic terms. The
  flow and rigidity render modes and `render_over_time`.
"""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, testing  # noqa: E402
from nerf_atlas_tpu_torch.train import (driver, losses, optim,  # noqa: E402
                                        regularizers)

from test_torch_dyn import STEPS, jax_features, jax_ts, rays_times  # noqa: E402
from test_torch_dyn_family import (jax_draws, jax_features_in_x,  # noqa: E402
                                   jax_model, kink_free, port_model,
                                   replay_encoders)
from test_torch_dyn_train import _InjectedBatches  # noqa: E402

N, KEEP, POINTS = 48, 16, 32
POSENC = {"enc_kind": "posenc"}
POINT_COEFFS = {"delta_x": 1e-3, "spline_length": 1e-3, "spline_pt0": 1e-3,
                "dyn_divergence": 1e-3, "ffjord_div": 1e-3}
# case -> (tests/test_torch_dyn_family.py CASES name, extra kwargs,
# coefficients, the port's path)
TRAIN_CASES = {
    "ae": ("ae", {}, {"delta_x": 1e-3}, "oracle"),
    "long": ("long", {"canonical_kwargs": POSENC}, {"offset": 1e-3},
             "oracle"),
    "latent": ("latent", {"canonical_kwargs": POSENC},
               {"delta_x": 1e-3, "offset": 1e-3, "rigidity_sparsity": 1e-3},
               "oracle"),
    "spline-points": ("tiny", {"canonical_kind": "plain", "spline_points": 4,
                               "canonical_kwargs": {"enc_kind": "cp",
                                                    "refl_kind": "view"}},
                      POINT_COEFFS, "fused"),
}


@functools.lru_cache(maxsize=None)
def _jax_start(case):
  """The JAX model of a case and its start (the warp active; seeded
  biases for DynamicNeRFAE)."""
  import jax
  name, extra, _, _ = TRAIN_CASES[case]
  rays, times = rays_times(N, 10)
  model, tree = jax_model(name, rays, times, seed=5, **extra)
  if case == "ae":
    rng = np.random.default_rng(6)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                      if "bias" in jax.tree_util.keystr(p)
                      and "warp" not in jax.tree_util.keystr(p) else v),
        tree)
  return model, tree


def _port_of(case, state_dict):
  name, extra, _, _ = TRAIN_CASES[case]
  return port_model(name, state_dict, **extra)


def _patch_features(monkeypatch, case):
  jax_features(monkeypatch, "cp" if case == "spline-points" else "posenc")
  jax_features_in_x(monkeypatch)


def _clear_rays(case, model, rays, times):
  r, t = torch.from_numpy(rays), torch.from_numpy(times)
  if case == "spline-points":
    keep = testing.dyn_kink_free_rays(model.state_dict(), r, t, jax_ts(),
                                      STEPS, "cp", 4)
  else:
    keep = kink_free(model, lambda m, dt: m(r.to(dt), times=t.to(dt)),
                     r.shape[0])
  clear = np.flatnonzero(keep.numpy())[:KEEP]
  assert clear.shape == (KEEP,), int(keep.sum())
  return clear


def _clear_draws(name, model, key):
  """The JAX draws of a point-sampled term at `key`, less the points near
  a kink at the model's weights (the first POINTS of them)."""
  from test_torch_dyn_family import _eval_points
  draws = jax_draws(name, key)
  fn, axis = _eval_points(name, draws)
  keep = kink_free(model, fn, draws[0].shape[0], axis)
  assert int(keep.sum()) >= POINTS
  return tuple(d[keep][:POINTS] for d in draws)


def _jax_loss(model, coeffs, draws, monkeypatch):
  """The JAX train loss on a batch: l2 + `total_regularizer` + each
  point-sampled term on its given draws (driver.py:789-792)."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import losses as jlosses
  from nerf_atlas_tpu.train import regularizers as jreg
  loss_fn = jlosses.load_loss_fn()

  def fn(p, rays, times, pix):
    out = model.apply(p, jnp.asarray(rays), times=jnp.asarray(times))
    loss = loss_fn(out["rgb"], jnp.asarray(pix)) + jreg.total_regularizer(
        out, coeffs)
    for name, d in draws.items():
      uniforms = iter(jnp.asarray(x.numpy()) for x in d[:2])
      with monkeypatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda *a, **kw: next(uniforms))
        mp.setattr(jax.random, "rademacher",
                   lambda *a, d=d, **kw: jnp.asarray(d[2].numpy()))
        loss = loss + coeffs[name] * jreg.POINT_REGULARIZERS[name](
            model.apply, p, jax.random.PRNGKey(0), n=d[0].shape[0])
    return loss

  return fn


def _jax_steps(case, batches, monkeypatch, segments=None):
  """The JAX trajectory on `batches` [(rays, times, pix)]: each step's
  (loss, gradients), the kept batches and draws, the weights before each
  step and after the last. `segments` (progressive training): a fresh
  optimizer every len(batches) // segments steps."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import optim as joptim
  _, _, coeffs, _ = TRAIN_CASES[case]
  jmodel, tree = _jax_start(case)
  per = len(batches) // (segments or 1)
  tx = joptim.load_optimizer("adam", LR, total_steps=10 if not segments
                             else per)
  params = jax.tree.map(jnp.asarray, copy.deepcopy(tree))
  ref, kept, drawn, trajectory = [], [], [], []
  port = _port_of(case, None)
  for i, (rays, times, pix) in enumerate(batches):
    if i % per == 0:
      state = tx.init(params)
    trajectory.append(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    port.load_state_dict(trajectory[-1])
    clear = _clear_rays(case, port, rays, times)
    rays, times, pix = rays[clear], times[clear], pix[clear]
    kept.append((rays, pix, times))
    draws = {name: _clear_draws(name, port, jax.random.PRNGKey(100 + i))
             for name, c in coeffs.items()
             if c and name in regularizers.POINT_REGULARIZERS}
    drawn.append(draws)
    with jax.default_matmul_precision("highest"):
      loss, grads = jax.value_and_grad(_jax_loss(jmodel, coeffs, draws,
                                                 monkeypatch))(
          params, rays, times, pix)
    ref.append((float(loss), convert.params_from_flax(
        jax.tree.map(np.asarray, grads))))
    updates, state = tx.update(grads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
  final = convert.params_from_flax(jax.tree.map(np.asarray, params))
  return ref, kept, drawn, trajectory, final


def _inject_draws(monkeypatch, drawn):
  """The port's point-sampled terms take the JAX draws, step by step."""
  queues = {}
  for step in drawn:
    for name, d in step.items():
      queues.setdefault(name, []).append(d)
  for name, q in queues.items():
    term = regularizers.POINT_REGULARIZERS[name][1]
    monkeypatch.setitem(regularizers.POINT_REGULARIZERS, name,
                        (lambda generator, q=q: q.pop(0), term))
  return queues


def _float64_grads(case, state_dict, batch):
  """The gradient of the module-forward loss (l2 + `total_regularizer`)
  in float64 at `state_dict` on `batch`, each encoder's output taking its
  float32 values (`replay_encoders`)."""
  rays, pix, times = (torch.from_numpy(a) for a in batch)
  coeffs = TRAIN_CASES[case][2]
  m32, feats = _port_of(case, state_dict), []
  replay_encoders(m32, feats, replay=False)
  with torch.no_grad():
    m32(rays, times=times)
  m64 = _port_of(case, state_dict).double()
  replay_encoders(m64, feats, replay=True)
  out = m64(rays.double(), times=times.double())
  loss = (torch.mean(torch.square(out["rgb"] - pix[:, :3].double()))
          + regularizers.total_regularizer(out, coeffs))
  loss.backward()
  return {k: p.grad for k, p in m64.named_parameters() if p.grad is not None}


def _check_step(case, i, loss, loss_j, grads, grads_j, witness=None):
  """Loss 1e-5 relative, each gradient tensor 1e-4 relative. A
  one-element tensor (the rigidity's output bias: a sum of signed terms
  that cancel) that misses the gate is held as chip_smoke holds K9b's
  (`testing.float64_witness_ratio`): within twice the JAX side's distance
  to the float64 gradient `witness()`, the floor half the gate."""
  assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (case, i, loss, loss_j)
  assert set(grads) == set(grads_j)
  for key, ref in grads_j.items():
    if key.endswith("enc.B"):
      assert not grads[key].any()            # B: a zero gradient, as in JAX
      continue
    assert float(ref.norm()) > 0, key
    err = float((grads[key] - ref).norm() / ref.norm())
    if err > 1e-4 and ref.numel() == 1 and witness is not None:
      w64 = witness()[key]
      ek = float((grads[key].double() - w64).norm() / w64.norm())
      ej = float((ref.double() - w64).norm() / w64.norm())
      assert ek <= 2 * max(ej, 5e-5), (case, i, key, err, ek, ej)
      continue
    assert err <= 1e-4, (case, i, key, err)


def _check_last_update(case, model, trajectory, final):
  for key, p in model.state_dict().items():
    update = p - trajectory[-1][key]
    err = float((update - (final[key] - trajectory[-1][key])).abs().max())
    assert err <= 1e-2 * LR, (case, key, err / LR)


LR = 1e-3


def _batches(count, n=N):
  rng = np.random.default_rng(3)
  return [(*rays_times(n, 20 + i),
           rng.uniform(0, 1, (n, 4)).astype(np.float32))
          for i in range(count)]


def three_steps(case, monkeypatch):
  """Three steps of `case` against JAX + optax (the module docstring)."""
  from nerf_atlas_tpu_torch.ops import rays as trays
  _patch_features(monkeypatch, case)
  _, _, coeffs, path = TRAIN_CASES[case]
  ref, kept, drawn, trajectory, final = _jax_steps(case, _batches(3),
                                                   monkeypatch)
  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: jax_ts())
  queues = _inject_draws(monkeypatch, drawn)
  model = _port_of(case, trajectory[0])
  ds = _InjectedBatches(kept)
  cfg = driver.TrainConfig(steps=10, batch_size=KEEP, learning_rate=LR,
                           reg_coeffs=coeffs)
  opt = optim.load_optimizer(model.parameters(), "adam", LR, total_steps=10)
  seen, inner = [], opt.step

  def record():
    seen.append({k: p.grad.clone() for k, p in model.named_parameters()})
    inner()

  opt.step = record
  fused_step = driver._fused_step_fn(model, cfg, ds)
  fused_train = driver._fused_train_fn(model, cfg, ds)
  assert fused_step is None
  assert (fused_train is not None) == (path == "fused")
  step = driver.make_train_step(model, ds, losses.load_loss_fn(), opt, cfg,
                                fused_step=fused_step,
                                fused_train=fused_train)
  gen = torch.Generator().manual_seed(0)
  for i, (loss_j, grads_j) in enumerate(ref):
    with torch.no_grad():
      model.load_state_dict(trajectory[i])
    metrics = step(i, gen)
    assert float(metrics["mse"]) < float(metrics["loss"])
    witness = (None if path == "fused" else functools.partial(
        _float64_grads, case, trajectory[i], kept[i]))
    _check_step(case, i, float(metrics["loss"]), loss_j, seen[i], grads_j,
                witness)
  assert not any(queues.values())                  # one draw a step a term
  _check_last_update(case, model, trajectory, final)


@pytest.mark.parametrize("case", ["ae", "long", "latent"])
def test_three_steps_match_jax(case, monkeypatch):
  three_steps(case, monkeypatch)


class _Windows(_InjectedBatches):
  """Injected batches that record each draw's view range, pixel jitter
  and generator seed."""

  def __init__(self, batches, num_views):
    super().__init__(batches)
    self.pixels = torch.zeros(num_views, 1, 1, 4)
    self.device = torch.device("cpu")
    self.calls = []

  @property
  def num_views(self):
    return self.pixels.shape[0]

  def sample(self, generator, batch_size, **kw):
    self.calls.append((kw.get("view_range"), kw.get("jitter", 0.0),
                       generator.initial_seed()))
    return super().sample(generator, batch_size, **kw)


def test_progressive_training_matches_jax(monkeypatch, tmp_path):
  from nerf_atlas_tpu_torch.ops import rays as trays
  case = "long"
  _patch_features(monkeypatch, case)
  ref, kept, _, trajectory, final = _jax_steps(case, _batches(4),
                                               monkeypatch, segments=2)
  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: jax_ts())
  model = _port_of(case, trajectory[0])
  ds = _Windows(kept, num_views=5)
  seen, made, inner_load = [], [], optim.load_optimizer

  def load_optimizer(params, *args, **kw):
    opt = inner_load(params, *args, **kw)
    made.append(kw)
    inner = opt.step

    def record():
      seen.append({k: p.grad.clone() for k, p in model.named_parameters()})
      inner()
    opt.step = record
    return opt

  monkeypatch.setattr(driver.optim_lib, "load_optimizer", load_optimizer)
  losses_seen = []

  def callback(m):
    losses_seen.append(m)
    k = len(losses_seen)
    if k < len(trajectory):               # the JAX weights for the next step
      with torch.no_grad():
        model.load_state_dict(trajectory[k])

  cfg = driver.TrainConfig(steps=2, batch_size=KEEP, learning_rate=LR,
                           log_freq=1, seed=7, reg_coeffs={"offset": 1e-3},
                           save_path=str(tmp_path / "model.ckpt"))
  history = driver.train_progressive(model, ds, cfg, segments=2,
                                     callback=callback)
  assert driver.LAST_TRAIN_PATH == "oracle" and history == losses_seen
  assert [h["segment"] for h in history] == [0, 0, 1, 1]
  assert [c[0] for c in ds.calls] == [(0, 2)] * 2 + [(2, 5)] * 2
  assert all(c[1] == 0.0 for c in ds.calls)                # no pixel jitter
  assert [c[2] for c in ds.calls] == [106] * 2 + [107] * 2
  assert [kw["total_steps"] for kw in made] == [2, 2]
  assert (tmp_path / "model.ckpt").exists()
  for i, (loss_j, grads_j) in enumerate(ref):
    _check_step(case, i, history[i]["loss"], loss_j, seen[i], grads_j,
                functools.partial(_float64_grads, case, trajectory[i],
                                  kept[i]))
  _check_last_update(case, model, trajectory, final)


def test_progressive_training_checks_finite_losses():
  rays, times = rays_times(8, 1)
  ds = _Windows([(rays, np.full((8, 4), np.nan, np.float32), times)], 2)
  cfg = driver.TrainConfig(steps=1, batch_size=8, log_freq=1, save_freq=0)
  with pytest.raises(FloatingPointError):
    driver.train_progressive(port_model("long"), ds, cfg, segments=1)


# ---- the gates ----

def _dataset(kind="synthetic-dyn", size=8, views=3):
  from nerf_atlas_tpu_torch.data import loaders, sampler
  return sampler.RayDataset.from_bundle(
      loaders.load("", data_kind=kind, size=size, num_views=views), size=size)


def test_gates_choose_the_paths():
  ds = _dataset()
  recipe = driver.TrainConfig()

  def paths(model, **coeffs):
    cfg = driver.TrainConfig(reg_coeffs=coeffs)
    return (driver._fused_step_fn(model, cfg, ds) is not None,
            driver._fused_train_fn(model, cfg, ds) is not None)

  def dnerf(**kw):
    kw.setdefault("steps", STEPS)
    return driver.init_model(models.DynamicNeRF(**kw), seed=0)

  spline = dnerf(spline_points=4)
  assert paths(spline) == (True, True)
  assert paths(spline, delta_x=1e-3) == (True, True)       # one kernel
  for name in ("spline_length", "spline_pt0", "dyn_divergence",
               "ffjord_div"):                               # two kernels
    assert paths(spline, **{name: 1e-3}) == (False, True), name
    assert paths(spline, delta_x=1e-3, **{name: 1e-3}) == (False, True)
  for name in ("offset", "rigidity_sparsity"):              # module forward
    assert paths(spline, **{name: 1e-3}) == (False, False), name
    assert paths(spline, spline_length=1e-3, **{name: 1e-3}) == (False,
                                                                 False)
  others = [dnerf(time_latent_size=8), dnerf(canonical_kind="tiny"),
            dnerf(canonical_kind="ae"),
            dnerf(canonical_kind="coarse_fine",
                  canonical_kwargs={"enc_kind": "cp"}),
            driver.init_model(models.DynamicNeRFAE(steps=STEPS), seed=0),
            driver.init_model(models.LongDynamicNeRF(steps=STEPS), seed=0)]
  for model in others:
    assert driver._fused_enc_kind(model) is None, type(model)
    assert paths(model) == (False, False)
    assert paths(model, spline_length=1e-3) == (False, False)
    assert driver._fused_render_fn(model) is None
    assert driver.model_kind(model) == "dynamic"
  for static in (models.PlainNeRF(latent_size=4, steps=STEPS),
                 models.NeRFAE(latent_size=4, steps=STEPS),
                 models.TinyNeRF(latent_size=4, steps=STEPS),
                 models.CoarseFineNeRF(latent_size=4, enc_kind="cp",
                                       steps=STEPS)):
    assert driver._fused_enc_kind(static) is None, type(static)
    assert driver._fused_step_fn(static, recipe, _dataset("synthetic")) is None
  for name in driver.MODEL_REGULARIZERS["dynamic"]:
    driver.check_config(driver.TrainConfig(reg_coeffs={name: 0.1}),
                        "dynamic")
    if name != "delta_x":
      with pytest.raises(NotImplementedError, match="Queue 1"):
        driver.check_config(driver.TrainConfig(reg_coeffs={name: 0.1}),
                            "plain")


def test_render_maps_and_frames_over_time():
  ds = _dataset()
  model = driver.init_model(models.DynamicNeRF(steps=8), seed=0)
  with torch.no_grad():
    model.warp.layer_out.weight.normal_(
        0.0, 0.3, generator=torch.Generator().manual_seed(1))
  flow = driver.render_view(model, ds, 1, mode="flow", chunk=24)
  rig = driver.render_view(model, ds, 1, mode="rigidity")
  times = torch.full((64,), float(ds.times[1]))
  with torch.no_grad():
    out = model(ds.view_rays(1), times=times)
  want = (out["weights"][..., None] * out["dp"]).sum(-2).reshape(8, 8, 3)
  np.testing.assert_allclose(flow, want.numpy(), atol=1e-6)
  assert rig.shape == (8, 8, 1) and float(np.abs(flow).max()) > 1e-4
  frames = driver.render_over_time(model, ds, view=1, frames=3, end_sec=0.5)
  assert frames.shape == (3, 8, 8, 3)
  np.testing.assert_allclose(
      frames[2], driver.render_view(model, ds, 1, time_val=0.5), atol=0)
  long = driver.init_model(models.LongDynamicNeRF(steps=8), seed=0)
  with pytest.raises(KeyError, match="rigidity"):
    driver.render_view(long, ds, 0, mode="rigidity")
  with pytest.raises(KeyError, match="normals"):   # an SDF model's map
    driver.render_view(model, ds, 0, mode="normals")
