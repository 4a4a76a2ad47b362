"""Training the rest of the SDF family in the port, on the CPU against the
JAX package: the SDF renderer's loss, --volsdf-alternate, the smoothness
terms on VolSDF's two-kernel path, the gates and the runner.

- `three_steps`: three train steps on injected batches against the same
  three steps composed in JAX (a jitted value_and_grad through the JAX
  model + the JAX package's optax chain): each step's loss 1e-5
  relative, each gradient tensor 1e-4 relative (`check_grads`), the last
  Adam update, from the weights both sides share, 1e-2 of the learning
  rate. The port's weights are set to the JAX trajectory's before each
  step (tests/test_torch_ae_train.py says why). Cases:
  - `sdf`: `--model sdf` (the MLP shape in its bounding sphere, bisect,
    32 scan steps) through the module forward: l2 on rgb plus the mean
    sigmoid BCE of sil_logit against the alpha, which
    `F.binary_cross_entropy_with_logits` computes as optax's
    `sigmoid_binary_cross_entropy` + mean does. Each batch keeps the rays
    whose scan clears 0 and whose surface and best points clear the
    kinks (tests/test_torch_sdf.py `scan_clear`, `kink_free`).
  - `alternate`: `--volsdf-alternate --alt-train 1`: step 0 the volume
    render (the rays `testing.volsdf_kink_free_rays` clears), step 1
    `surface_render` (its rgb and throughput against 4-channel labels; the
    rays as for `sdf`), step 2 the volume render again.
  - `smooth`: VolSDF-MLP with the eikonal, --smooth-normals-weight,
    --smooth-surface-weight and --eikonal-random-weight on the two-kernel
    path (on the CPU the plain K8f with its eikonal column and the plain
    K8b-G), the point terms by autograd on the JAX package's own draws
    less the points near a kink, against the JAX module's out["eikonal"]
    and the JAX terms.
  As in tests/test_torch_volsdf_train.py both sides take the JAX eval
  grid as the step's ts.
- The gates: the smoothness terms and the random eikonal keep a VolSDF
  on the two-kernel path, out of the one-kernel step; the surface eikonal
  (an out-dict term) and --volsdf-alternate send it to the module
  forward, as do the other shapes and the ref-compat options; the SDF
  renderer has no kernel; `check_config` carries the new terms for
  VolSDF and SDF only. `render_view`'s normals mode.
- The runner on the CPU at a tiny size: `--model sdf` with each
  --isect-kind, `--model volsdf` with each --sdf-kind and
  --bound-sphere-rad, --volsdf-alternate, --ref-compat, the smoothness
  and eikonal flags, --normals-images, --depth-query-normal and
  --visualize, the zeroing warnings; what stays unported raises, naming
  its ROADMAP item.
"""
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, runner, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops import march as tmarch  # noqa: E402
from nerf_atlas_tpu_torch.train import (driver, losses, optim,  # noqa: E402
                                        regularizers)

from test_torch_sdf import (SCAN, activate, check_grads, kink_free,  # noqa: E402
                            rays, scan_clear)

STEPS = 16
LR = 1e-3
N_RAYS, KEEP = 48, 12
POINTS, KEEP_POINTS = 64, 16
EIKONAL = 0.01
SMOOTH = {"smooth_normals": 1e-3, "smooth_surface": 1e-3,
          "eikonal_random": 1e-3}


def jax_ts():
  import jax.numpy as jnp
  return torch.from_numpy(np.array(jnp.linspace(2.0, 6.0, STEPS,
                                                dtype=jnp.float32)))


class _InjectedBatches:
  """A RayDataset stand-in whose `sample` hands out fixed batches."""

  def __init__(self, batches):
    self.batches = list(batches)
    self.pixels = torch.zeros(1, 1, 1, 4)

  def sample(self, generator, batch_size, **kw):
    rays_, pix = self.batches.pop(0)
    return torch.from_numpy(rays_), torch.from_numpy(pix), None, None


def _model_kwargs(case):
  if case == "sdf":
    return dict(sdf_kind="mlp", march_steps=SCAN, t_near=0.0, t_far=6.0,
                sigmoid_kind="upshifted")
  return dict(sdf_kind="mlp", steps=STEPS, t_near=2.0, t_far=6.0,
              sigmoid_kind="upshifted", with_normals=case == "smooth")


def _port_model(case, state_dict=None):
  cls = models.SDF if case == "sdf" else models.VolSDF
  model = cls(**_model_kwargs(case))
  if state_dict is not None:
    model.load_state_dict(state_dict)
  return model


@functools.lru_cache(maxsize=None)
def _jax_case(case):
  """The JAX model of a case, its start (seeded biases, the View's output
  ×40) and its jitted value_and_grad of the step's loss:
  fn(params, rays, pix, phase, key, idx) (phase: --volsdf-alternate's;
  key and idx [3, KEEP_POINTS]: the point terms' draws and kept rows)."""
  import jax
  import jax.numpy as jnp
  import optax
  from nerf_atlas_tpu import models as jmodels
  from nerf_atlas_tpu.train import losses as jlosses
  from nerf_atlas_tpu.train import regularizers as jreg
  kw = _model_kwargs(case)
  jm = (jmodels.SDF(**kw) if case == "sdf" else jmodels.VolSDF(**kw))
  tree = jax.tree.map(np.asarray, jm.init(
      {"params": jax.random.PRNGKey(5), "sampler": jax.random.PRNGKey(6)},
      jnp.asarray(rays(4, 0)), train=True))
  tree = activate(tree, 15)
  out_layer = tree["params"]["refl"]["mlp"]["layer_out"]
  out_layer["kernel"] = out_layer["kernel"] * 40.0
  loss_fn = jlosses.load_loss_fn()

  def fn(p, r, pix, phase, key, idx):
    if case == "sdf":
      out = jm.apply(p, r)
      return loss_fn(out["rgb"], pix[..., :3]) + jnp.mean(
          optax.sigmoid_binary_cross_entropy(out["sil_logit"][..., 0],
                                             pix[..., 3]))
    if case == "alternate" and phase == 1:
      out = jm.apply(p, r, method="surface_render")
      return loss_fn(jnp.concatenate([out["rgb"], out["throughput"]], -1),
                     pix)
    out = jm.apply(p, r)
    loss = loss_fn(out["rgb"], pix)
    if case == "smooth":
      loss = loss + EIKONAL * out["eikonal"]
      for j, (name, c) in enumerate(SMOOTH.items()):
        def apply_kept(q, x, *a, method=None, j=j, **k):
          return jm.apply(q, x[idx[j]], *a, method=method, **k)
        extra = {} if name == "eikonal_random" else {"eps": 1e-3}
        loss = loss + c * jreg.POINT_REGULARIZERS[name](
            apply_kept, p, key[j], n=POINTS, **extra)
    return loss

  return jm, tree, jax.jit(jax.value_and_grad(fn), static_argnums=3)


def _jax_draws(name, key):
  """The JAX term's own draws at `key` (regularizers.py:157-200), eps
  1e-3 as TrainConfig's smooth_eps."""
  import jax
  from nerf_atlas_tpu.train import regularizers as jreg
  if name == "eikonal_random":
    return (torch.from_numpy(np.array(jax.random.uniform(
        key, (POINTS, 3), minval=-1.5, maxval=1.5))),)
  k1, k2 = jax.random.split(key)
  return tuple(torch.from_numpy(np.array(a)) for a in (
      jax.random.uniform(k1, (POINTS, 3), minval=-1, maxval=1),
      jreg._perturbation(k2, POINTS, 1e-3, False)))


def _clear_rays(case, phase, model, r):
  """The rays of a batch both packages agree on (the module docstring)."""
  if case != "sdf" and phase == 0:
    keep = testing.volsdf_kink_free_rays(model.state_dict(),
                                         torch.from_numpy(r), jax_ts(),
                                         STEPS, exact_features=True)
  else:
    value = model.value if case == "sdf" else model.sdf_value
    near = 0.0 if case == "sdf" else 2.0
    steps = SCAN if case == "sdf" else 32
    keep = scan_clear(value, r, near, 6.0, steps)
    o, d = torch.from_numpy(r[:, :3]), torch.from_numpy(r[:, 3:])
    with torch.no_grad():
      _, best, t_lo, t_hi, _ = tmarch.throughput_with_sign_change(
          value, o, d, near, 6.0, batch_size=steps)
      pts = tmarch.bisection(value, o, d, t_lo, t_hi)
    keep &= kink_free(model.shape, best) & kink_free(model.shape, pts)
  clear = np.flatnonzero(keep.numpy())[:KEEP]
  assert clear.shape == (KEEP,), int(keep.sum())
  return clear


def three_steps(case, monkeypatch):
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import optim as joptim
  from nerf_atlas_tpu_torch.ops import rays as trays
  jm, tree, value_and_grad = _jax_case(case)
  rng = np.random.default_rng(7)
  tx = joptim.load_optimizer("adam", LR, total_steps=10)
  params = jax.tree.map(jnp.asarray, tree)
  state = tx.init(params)
  ref, kept, trajectory, queues = [], [], [], {n: [] for n in SMOOTH}
  port = _port_model(case)
  for i in range(3):
    phase = i % 2 if case == "alternate" else 0
    trajectory.append(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
    port.load_state_dict(trajectory[-1])
    r = rays(N_RAYS, 30 + i)
    pix = rng.uniform(0, 1, (N_RAYS, 4)).astype(np.float32)
    clear = _clear_rays(case, phase, port, r)
    kept.append((r[clear], pix[clear]))
    keys = jax.random.split(jax.random.PRNGKey(40 + i), len(SMOOTH))
    idx = np.zeros((len(SMOOTH), KEEP_POINTS), np.int32)
    if case == "smooth":
      for j, name in enumerate(SMOOTH):
        draws = _jax_draws(name, keys[j])
        keep = kink_free(port.shape, draws[0])
        if len(draws) > 1:
          keep &= kink_free(port.shape, draws[0] + draws[1])
        idx[j] = np.flatnonzero(keep.numpy())[:KEEP_POINTS]
        queues[name].append(tuple(d[idx[j]] for d in draws))
    loss, jgrads = value_and_grad(params, jnp.asarray(r[clear]),
                                  jnp.asarray(pix[clear]), phase, keys,
                                  jnp.asarray(idx))
    ref.append((float(loss),
                convert.params_from_flax(jax.tree.map(np.asarray, jgrads))))
    updates, state = tx.update(jgrads, state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)

  monkeypatch.setattr(trays, "compute_ts", lambda *a, **kw: jax_ts())
  for name, q in queues.items():
    term = regularizers.POINT_REGULARIZERS[name][1]
    monkeypatch.setitem(regularizers.POINT_REGULARIZERS, name,
                        (lambda generator, q=q, **kw: q.pop(0), term))
  model = _port_model(case, trajectory[0])
  ds = _InjectedBatches(kept)
  cfg = driver.TrainConfig(
      steps=10, batch_size=KEEP, learning_rate=LR,
      reg_coeffs={"eikonal": EIKONAL, **SMOOTH} if case == "smooth" else {},
      volsdf_alternate=case == "alternate",
      alt_train=1 if case == "alternate" else 0)
  opt = optim.load_optimizer(model.parameters(), "adam", LR, total_steps=10)
  seen, inner = [], opt.step

  def record():
    seen.append({k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None})
    inner()

  opt.step = record
  fused_step = driver._fused_step_fn(model, cfg, ds)
  fused_train = driver._fused_train_fn(model, cfg, ds)
  assert fused_step is None
  assert (fused_train is not None) == (case == "smooth")
  step = driver.make_train_step(model, ds, losses.load_loss_fn(), opt, cfg,
                                fused_step=fused_step,
                                fused_train=fused_train)
  gen = torch.Generator().manual_seed(0)
  witnessed = set()
  for i, (loss_j, grads_j) in enumerate(ref):
    with torch.no_grad():
      model.load_state_dict(trajectory[i])
    loss = float(step(i, gen)["loss"])
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j), (case, i, loss, loss_j)
    witness = functools.partial(_float64_grads, case, i % 2 if case ==
                                "alternate" else 0, trajectory[i], kept[i])
    witnessed |= _check_scalars(seen[i], grads_j, witness, (case, i))
    check_grads(seen[i], grads_j, what=(case, i))
  assert not any(queues.values())            # one draw a step and a term
  final = convert.params_from_flax(jax.tree.map(np.asarray, params))
  for key in witnessed:      # optax's update from the port's own gradients
    w = {key: jnp.asarray(trajectory[0][key].numpy())}
    st = tx.init(w)
    for i in range(3):
      u, st = tx.update({key: jnp.asarray(seen[i][key].numpy())}, st, w)
      final[key] = trajectory[i][key] + torch.from_numpy(np.array(u[key]))
  for key, p in model.state_dict().items():
    update = p - trajectory[-1][key]
    err = float((update - (final[key] - trajectory[-1][key])).abs().max())
    assert err <= 1e-2 * LR, (case, key, err / LR)


def _module_loss(case, phase, model, r, pix):
  """The step's loss through the module (the sdf and alternate cases)."""
  if case == "alternate" and phase == 1:
    out = model.surface_render(r)
    pred = torch.cat([out["rgb"], out["throughput"]], -1)
    return torch.mean((pred[:, :3] - pix[:, :3]) ** 2) + torch.mean(
        (pred[:, 3:] - pix[:, 3:]) ** 2)
  out = model(r)
  loss = torch.mean((out["rgb"] - pix[:, :3]) ** 2)
  if case == "sdf":
    loss = loss + torch.nn.functional.binary_cross_entropy_with_logits(
        out["sil_logit"][..., 0], pix[:, 3])
  return loss


def _float64_grads(case, phase, state_dict, batch):
  """The gradient of the module loss in float64 at `state_dict` on
  `batch`, each Fourier encoder's output taking its float32 values
  (tests/test_torch_dyn_family.py `replay_encoders`)."""
  from test_torch_dyn_family import replay_encoders
  r, pix = (torch.from_numpy(a) for a in batch)
  m32, feats = _port_model(case, state_dict), []
  replay_encoders(m32, feats, replay=False)
  with torch.no_grad():
    _module_loss(case, phase, m32, r, pix)
  m64 = _port_model(case, state_dict).double()
  replay_encoders(m64, feats, replay=True)
  _module_loss(case, phase, m64, r.double(), pix.double()).backward()
  return {k: p.grad for k, p in m64.named_parameters() if p.grad is not None}


def _check_scalars(grads, grads_j, witness, what):
  """A one-element gradient (the raw Laplace scale: a sum of signed terms
  that cancel) that misses 1e-4 is held as
  tests/test_torch_dyn_family_train.py `_check_step` holds one: within
  twice the JAX side's distance to the float64 gradient `witness()`, the
  floor half the gate. Such a tensor passes `check_grads` then, and the
  last update holds the port's Adam against optax on the port's own
  gradients for it. Returns the names held so."""
  held = set()
  for key, ref in grads_j.items():
    if key in grads and ref.numel() == 1 and ref.any():
      got = grads[key]
      if float((got - ref).norm() / ref.norm()) > 1e-4:
        w64 = witness()[key]
        ek = float((got.double() - w64).norm() / w64.norm())
        ej = float((ref.double() - w64).norm() / w64.norm())
        assert ek <= 2 * max(ej, 5e-5), (what, key, ek, ej)
        grads_j[key] = got.clone()
        held.add(key)
  return held


@pytest.mark.parametrize("case", ["sdf", "alternate", "smooth"])
def test_three_steps_match_jax(case, monkeypatch):
  three_steps(case, monkeypatch)


def test_alt_train_masks_analytic_and_learned_parameters():
  """--alt-train's mask (driver.py:837-847): "analytic" gradients × the
  phase, "learned" ones × (1 − phase); no port model has such names, so a
  VolSDF subclass carries them."""

  class Halves(models.VolSDF):
    def __init__(self):
      super().__init__(steps=4)
      self.analytic = torch.nn.Parameter(torch.ones(2))
      self.learned = torch.nn.Parameter(torch.ones(2))

    def forward(self, r, train=False, generator=None):
      out = super().forward(r, train, generator)
      out["rgb"] = out["rgb"] + 1e-2 * (self.analytic + self.learned).sum()
      return out

  model = driver.init_model(Halves(), seed=0)
  ds = _InjectedBatches([(rays(4, i), np.zeros((4, 3), np.float32))
                         for i in range(3)])
  cfg = driver.TrainConfig(steps=3, alt_train=1, no_fused=True)
  opt = optim.load_optimizer(model.parameters(), "adam", LR, total_steps=3)
  seen, inner = [], opt.step
  opt.step = lambda: (seen.append({k: p.grad.clone() for k, p in
                                   model.named_parameters()
                                   if p.grad is not None}), inner())
  step = driver.make_train_step(model, ds, losses.load_loss_fn(), opt, cfg)
  for i in range(3):
    step(i, torch.Generator().manual_seed(0))
    phase = i % 2
    assert bool((seen[i]["analytic"] == 0).all()) == (phase == 0)
    assert bool((seen[i]["learned"] == 0).all()) == (phase == 1)
    assert bool(seen[i]["refl.mlp.layer_out.bias"].any())


def _dataset():
  from nerf_atlas_tpu_torch.data import loaders, sampler
  return sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=8, num_views=2), size=8)


def test_gates_route_the_sdf_family():
  ds = _dataset()
  vol = driver.init_model(models.VolSDF(steps=STEPS, with_normals=True),
                          seed=0)
  smooth = driver.TrainConfig(reg_coeffs={"eikonal": EIKONAL, **SMOOTH})
  assert driver._fused_step_fn(vol, smooth, ds) is None
  assert driver._fused_train_fn(vol, smooth, ds) is not None
  for name in SMOOTH:                        # each alone, without normals
    plain = driver.init_model(models.VolSDF(steps=STEPS), seed=0)
    cfg = driver.TrainConfig(reg_coeffs={name: 1e-3})
    assert driver._fused_step_fn(plain, cfg, ds) is None
    assert driver._fused_train_fn(plain, cfg, ds) is not None
  for cfg in (driver.TrainConfig(reg_coeffs={"eikonal": EIKONAL,
                                             "surface_eikonal": 0.1}),
              driver.TrainConfig(reg_coeffs={"eikonal": EIKONAL},
                                 volsdf_alternate=True, alt_train=2048)):
    assert driver._fused_step_fn(vol, cfg, ds) is None
    assert driver._fused_train_fn(vol, cfg, ds) is None
  for kind in ("siren", "curl-mlp", "local", "spheres", "triangles"):
    other = driver.init_model(models.VolSDF(steps=STEPS, sdf_kind=kind),
                              seed=0)
    assert driver._fused_enc_kind(other) is None, kind
    assert driver._fused_render_fn(other) is None, kind
  sdf = driver.init_model(models.SDF(march_steps=8), seed=0)
  assert driver._fused_enc_kind(sdf) is None
  assert driver._fused_step_fn(sdf, driver.TrainConfig(), ds) is None
  assert driver._fused_train_fn(sdf, driver.TrainConfig(), ds) is None
  assert driver._fused_render_fn(sdf) is None
  assert driver.model_kind(sdf) == "sdf"
  for name in ("surface_eikonal", *SMOOTH):
    driver.check_config(driver.TrainConfig(reg_coeffs={name: 0.1}), "volsdf")
    with pytest.raises(NotImplementedError, match=name):
      driver.check_config(driver.TrainConfig(reg_coeffs={name: 0.1}),
                          "plain")
  for name in ("eikonal", "surface_eikonal", "smooth_normals",
               "eikonal_random"):
    driver.check_config(driver.TrainConfig(reg_coeffs={name: 0.1}), "sdf")
  for name in ("smooth_surface", "volsdf_scale", "smooth_occ"):
    with pytest.raises(NotImplementedError, match=name):
      driver.check_config(driver.TrainConfig(reg_coeffs={name: 0.1}), "sdf")
  driver.check_config(driver.TrainConfig(
      smooth_eps=0.1, smooth_eps_rng=True, smooth_ords=(1, 2), alt_train=4,
      volsdf_alternate=True), "volsdf")


def test_render_view_normals_maps():
  ds = _dataset()
  sdf = driver.init_model(models.SDF(march_steps=8), seed=0)
  n = driver.render_view(sdf, ds, 0, mode="normals")
  assert n.shape == (8, 8, 3) and np.isfinite(n).all()
  vol = driver.init_model(models.VolSDF(steps=8, with_normals=True), seed=0)
  n = driver.render_view(vol, ds, 0, mode="normals")
  assert n.shape == (8, 8, 3) and float(np.abs(n).max()) > 0
  with pytest.raises(KeyError, match="normals"):
    driver.render_view(driver.init_model(models.VolSDF(steps=8), seed=0),
                       ds, 0, mode="normals")
  with pytest.raises(ValueError, match="render mode"):
    driver.render_view(vol, ds, 0, mode="albedo")
  assert models.SDF.eval_chunk == 16384


# ---- the runner ----

def _run(tmp_path, name, *extra, model="volsdf"):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic", "--model", model,
                     "--size", "6", "--num-views", "2", "--steps", "8",
                     "--batch-size", "24", "-lr", "1e-3", "--seed", "0",
                     "--valid-freq", "0", "--nosave", "--outdir", str(out),
                     *extra], device="cpu")
  return res, out


def _finite(res):
  assert all(np.isfinite(h["loss"]) for h in res.get("history", []))
  for split in ("train", "test"):
    assert np.isfinite(res[split]["psnrs"]).all()


@pytest.mark.parametrize("isect", ["bisect", "secant", "sphere"])
def test_runner_trains_sdf_on_cpu(tmp_path, isect):
  res, out = _run(tmp_path, isect, "--epochs", "2", "--isect-kind", isect,
                  "--normals-images", "--ref-compat", model="sdf")
  assert res["engaged_path"] == "oracle"
  _finite(res)
  first = res["history"][0]
  assert first["loss"] == first["mse"] > 0.0     # l2 + the silhouette BCE
  with open(out / "log.json") as f:
    assert json.load(f)["engaged_path"] == "oracle"
  for split in ("train", "test"):
    for v in range(2):
      assert (out / split / f"normals_{v:03d}.png").exists()
  args = runner.cli.arguments(["--model", "sdf", "--isect-kind", isect,
                               "--near", "1.5", "--bound-sphere-rad", "0.9"])
  model = runner.build_model(args, "cpu")
  assert isinstance(model, models.SDF) and model.isect_kind == isect
  assert model.t_near == 0.0 and model.bounded
  assert model.shape.radius == 0.9
  assert runner.build_model(runner.cli.arguments(["--model", "sdf"]),
                            "cpu").shape.radius == 1.5


@pytest.mark.parametrize("kind", ["mlp", "siren", "curl-mlp", "local",
                                  "spheres", "triangles"])
def test_runner_takes_every_sdf_kind(tmp_path, kind):
  res, _ = _run(tmp_path, kind, "--epochs", "1", "--sdf-kind", kind,
                "--bound-sphere-rad", "1.2", "--no-sphere-init")
  assert res["engaged_path"] == ("fused-one-kernel" if kind == "mlp"
                                 else "oracle")
  _finite(res)


def test_runner_volsdf_alternate_smoothness_and_maps(tmp_path, capsys):
  res, out = _run(tmp_path, "alt", "--epochs", "3", "--volsdf-alternate",
                  "--alt-train", "1", "--visualize", "depth", "normals",
                  "--sdf-eikonal", "0.01")
  assert res["engaged_path"] == "oracle"
  _finite(res)
  for m in ("depth", "normals", "test"):
    assert (out / "test" / f"{m}_000.png").exists()
  args = runner.cli.arguments(["--model", "volsdf", "--volsdf-alternate",
                               "--epochs", "1"])
  assert runner.make_train_config(args).alt_train == 2048
  assert args.alt_train == 2048
  with pytest.raises(ValueError, match="volsdf"):
    runner.make_train_config(runner.cli.arguments(["--volsdf-alternate"]))

  res, out = _run(tmp_path, "smooth", "--epochs", "2", "--sdf-eikonal",
                  "0.01", "--smooth-normals-weight", "1e-3",
                  "--smooth-surface-weight", "1e-3", "--smooth-eps", "0.01",
                  "--smooth-eps-rng", "--smooth-n-ord", "1", "2",
                  "--eikonal-random-weight", "1e-3", "--depth-query-normal")
  assert res["engaged_path"] == "fused"
  _finite(res)
  assert res["history"][0]["loss"] > res["history"][0]["mse"]
  assert (out / "train" / "query_normals_001.png").exists()
  cfg = runner.make_train_config(runner.cli.arguments([
      "--model", "volsdf", "--smooth-eps", "0.01", "--smooth-eps-rng",
      "--smooth-n-ord", "1", "2", "--epochs", "1"]))
  assert (cfg.smooth_eps, cfg.smooth_eps_rng, cfg.smooth_ords) == (
      0.01, True, (1, 2))

  res, _ = _run(tmp_path, "surf", "--epochs", "2", "--surface-eikonal",
                "0.1", "--ref-compat")
  assert res["engaged_path"] == "oracle"
  _finite(res)
  model = runner.build_model(runner.cli.arguments(
      ["--model", "volsdf", "--ref-compat"]), "cpu")
  assert model.scale_kind == "ident"
  assert model.sdf_kwargs == {"sphere_init": False, "enc_freqs": 128,
                              "enc_sigma": 16 / (2 * np.pi)}
  assert model.shape.mlp.enc.freqs == 128
  assert driver._fused_enc_kind(model) is None
  with pytest.raises(TypeError):       # CurlMLP takes no spectrum (as JAX)
    runner.build_model(runner.cli.arguments(
        ["--model", "volsdf", "--ref-compat", "--sdf-kind", "curl-mlp"]),
        "cpu")
  capsys.readouterr()


def test_runner_zeroes_flags_and_raises_on_what_stays_unported(tmp_path,
                                                               capsys):
  res, _ = _run(tmp_path, "zero", "--epochs", "1", "--sdf-eikonal", "0.1",
                "--smooth-surface-weight", "0.1", "--smooth-occ-weight",
                "0.1", "--tv-sigma", "0.1", "--dp-weight", "0.1",
                model="plain")
  assert res["engaged_path"] == "fused-one-kernel"
  said = capsys.readouterr().out
  for flag in ("eikonal-weight", "smooth-surface-weight", "smooth-occ-weight",
               "tv-sigma", "dp-weight"):
    assert f"zeroing --{flag}" in said, flag
  for flags, item in ((("--occ-kind", "all-learned"), "Queue 1 #13"),
                      (("--integrator-kind", "direct"), "Queue 1 #13"),
                      (("--light-kind", "point"), "Queue 1 #13"),
                      (("--normals-from-depth",), "Queue 1 #13"),
                      (("--model", "voxel"), "Queue 1 #13"),
                      (("--model", "plain", "--ref-compat"), "Queue 1 #7"),
                      (("--model", "ae", "--ref-compat"), "Queue 1 #13")):
    with pytest.raises(NotImplementedError, match=item):
      _run(tmp_path, "bad", "--epochs", "0", *flags)
  with pytest.raises(NotImplementedError, match="view_variance"):
    _run(tmp_path, "bad", "--epochs", "1", "--view-variance-weight", "0.1")
