"""The rest of the dynamic family in the port, on the CPU against the JAX
package: DynamicNeRFAE, LongDynamicNeRF, DynamicNeRF with the per-time
refl latent and over the tiny, ae and coarse_fine canonicals, the Bezier
kit's Frenet normal and arc length, and the dynamic regularizers.

- Each model's forward (rgb, weights, dp and rigidity where it emits one)
  against the JAX model with the params carried across by
  `convert.params_from_flax`, at 2e-4, the warp made active (seeded
  0.03·N(0, 1) layer_out weights, 0.01·N(0, 1) biases) so that dp is not
  zero. The port takes the JAX FourierEncoder's features
  (tests/test_torch_dyn.py `jax_features` says why). The ae and
  coarse_fine canonicals read a 4-wide time latent, the plain one an
  8-wide one: each canonical's `latent` argument is held too.
- `params_from_flax` on each new tree: the port's keys and shapes.
- `frenet_normal` and `arc_len` against the JAX ones.
- The out-dict regularizers (NR-NeRF offset, rigidity sparsity) on shared
  dp, rigidity and weights: value 1e-5 relative, the gradient in dp and
  rigidity 1e-4 relative, finite at dp = 0 (the warp's zero start).
- The point-sampled ones (divergence, FFJORD divergence, spline length,
  spline point 0) on DynamicNeRF's Δx and S = 4 spline warps (over the
  tiny canonical: the terms read the warp and the rigidity alone) and a
  LongDynamicNeRF, on the JAX package's own draws less the points whose
  leaky-relu inputs lie near the kink (`kink_free`; ~1e-3 of a gradient
  tensor moves between any two float32 evaluations, float64 included,
  when one does): value 1e-5 relative, each parameter gradient 1e-4
  relative (spline point 0 is zero for the two Bezier warps, whose first
  control point is pinned to 0; a tensor whose gradient vanishes is held
  against 1e-3 of the largest one's norm). The divergence terms differentiate the
  warp in x: the port's Fourier features keep their derivative there;
  `point_regularizers` sums them in the coefficients' order from one
  generator; DynamicNeRFAE, which has no delta_x, raises.
- DynamicNeRF over VolSDF raises, naming the reference's fault.
Training, the gates and the runner: tests/test_torch_dyn_family_train.py.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models  # noqa: E402
from nerf_atlas_tpu_torch.models.base import broadcast_latent  # noqa: E402
from nerf_atlas_tpu_torch.nn import SkipConnMLP  # noqa: E402
from nerf_atlas_tpu_torch.ops import bezier  # noqa: E402
from nerf_atlas_tpu_torch.train import regularizers  # noqa: E402

from test_torch_dyn import STEPS, jax_features, rays_times  # noqa: E402

N = 24
CP = {"enc_kind": "cp"}
# name -> (the port's class name, constructor kwargs): the JAX package's
# class of the same name takes the same kwargs
CASES = {
    "ae": ("DynamicNeRFAE", {}),
    "long": ("LongDynamicNeRF", {"canonical_kwargs": CP}),
    "latent": ("DynamicNeRF", {"time_latent_size": 8,
                               "canonical_kwargs": CP}),
    "tiny": ("DynamicNeRF", {"canonical_kind": "tiny"}),
    "ae-canonical": ("DynamicNeRF", {"canonical_kind": "ae",
                                     "time_latent_size": 4}),
    "coarse_fine": ("DynamicNeRF", {"canonical_kind": "coarse_fine",
                                    "time_latent_size": 4}),
}


def activate_warp(tree, seed):
  """Seeded 0.03·N(0, 1) weights and 0.01·N(0, 1) biases for the warp's
  zero-initialized layer_out."""
  rng = np.random.default_rng(seed)
  wl = tree["params"]["warp"]["layer_out"]
  wl["kernel"] = (0.03 * rng.normal(size=wl["kernel"].shape)).astype(
      np.float32)
  wl["bias"] = (0.01 * rng.normal(size=wl["bias"].shape)).astype(np.float32)
  return tree


def jax_model(name, rays, times, seed=0, **extra):
  """The JAX model of CASES[name] (its kwargs updated by `extra`) and its
  seed params with the warp active."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  cls, kw = CASES[name]
  model = getattr(jmodels, cls)(steps=STEPS, **{**kw, **extra})
  tree = jax.tree.map(np.asarray, model.init(
      {"params": jax.random.PRNGKey(seed),
       "sampler": jax.random.PRNGKey(seed + 1)}, jnp.asarray(rays),
      times=jnp.asarray(times), train=True))
  return model, activate_warp(tree, seed + 3)


def port_model(name, state_dict=None, **extra):
  cls, kw = CASES[name]
  model = getattr(models, cls)(steps=STEPS, **{**kw, **extra})
  if state_dict is not None:
    model.load_state_dict(state_dict)
  return model


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
  rays, times = rays_times(N, 1)
  model, tree = jax_model(request.param, rays, times)
  return (request.param, model, tree, convert.params_from_flax(tree), rays,
          times)


def replay_encoders(model, feats: list, replay: bool):
  """Hooks on every MLP encoder of `model`: record its outputs into
  `feats` in call order, or (`replay`) give each call the recorded
  output's values, keeping the derivative of its own evaluation."""
  it = iter(feats)
  for mod in model.modules():
    if isinstance(mod, SkipConnMLP) and mod.enc is not None:
      mod.enc.register_forward_hook(
          lambda _m, _i, out: (
              out + (next(it).to(out.dtype) - out).detach() if replay
              else feats.append(out.detach())))


def kink_free(model, fn, n: int, axis: int = 0, margin: float = 10.0):
  """Bool [n]: the rows (index `axis` of every leaky-relu input of the
  model's MLPs, which `fn(model, dtype)` evaluates) whose inputs all lie
  further from 0 than `margin` times their float32-vs-float64 difference,
  per value and per column RMS. The float64 evaluation takes each MLP
  encoder's float32 output (its Fourier, posenc or grid features, whose
  phases round alike in the port and the JAX package and would otherwise
  carry the sample points' round-off at up to hundreds of radians); a
  column equal in both evaluations (an input carried as it is, such as
  the time) rounds nowhere and is skipped."""
  runs, feats = [], []
  for dtype in (torch.float32, torch.float64):
    m, zs = copy.deepcopy(model).to(dtype), []
    replay_encoders(m, feats, replay=dtype == torch.float64)
    for mod in m.modules():
      if not isinstance(mod, SkipConnMLP) or mod.init_kind == "siren":
        continue
      act = mod.activation

      def record(v, act=act, zs=zs):
        zs.append(v.detach().double())
        return act(v)

      mod.activation = record
    with torch.no_grad():
      fn(m, dtype)
    runs.append(zs)
  keep = torch.ones(n, dtype=torch.bool)
  for a, b in zip(*runs):
    d = (a - b).abs()
    rms = d.square().mean(dim=tuple(range(d.ndim - 1)), keepdim=True).sqrt()
    near = (a.abs() <= margin * torch.maximum(d, rms)) & (rms > 0)
    keep &= ~near.movedim(axis, 0).reshape(n, -1).any(1)
  return keep


def jax_out(model, tree, rays, times):
  import jax
  import jax.numpy as jnp
  with jax.default_matmul_precision("highest"):
    out = model.apply(tree, jnp.asarray(rays), times=jnp.asarray(times))
  return {k: np.asarray(v) for k, v in out.items()}


def test_new_models_match_jax(family, monkeypatch):
  name, model, tree, sd, rays, times = family
  jax_features(monkeypatch, "cp")
  ref = jax_out(model, tree, rays, times)
  assert float(np.abs(ref["dp"]).max()) > 1e-4          # the warp is active
  port = port_model(name, sd)
  with torch.no_grad():
    out = port(torch.from_numpy(rays), times=torch.from_numpy(times))
  assert set(out) == set(ref), name
  for key in ("rgb", "weights", "dp", "rigidity"):
    if key in ref:
      np.testing.assert_allclose(out[key].numpy(), ref[key], atol=2e-4,
                                 err_msg=f"{name} {key}")


def test_params_from_flax_maps_the_new_trees(family):
  name, _, _, sd, _, _ = family
  port = port_model(name)
  want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
  assert {k: tuple(v.shape) for k, v in sd.items()} == want
  assert sd["warp.enc.B"].shape == (3 if name == "long" else 4, 32)
  out = sd["warp.layer_out.weight"].shape[0]
  assert out == {"ae": 3 + 32, "long": 3 * 3 * 4, "latent": 3 + 8,
                 "tiny": 3, "ae-canonical": 3 + 4,
                 "coarse_fine": 3 + 4}[name]
  if name == "latent":       # the refl reads [features ; 8-wide latent]
    assert sd["canonical.refl.mlp.layer_in.weight"].shape[1] == 3 + 2 + 32 + 8


def test_broadcast_latent():
  lat = torch.arange(6.0).reshape(2, 3)
  got = broadcast_latent(lat, (2, 5, 3), 3)
  assert got.shape == (2, 5, 3) and torch.equal(got[:, 4], lat)
  assert broadcast_latent(lat, (2, 5, 3), 0) is None
  assert broadcast_latent(None, (2, 5, 3), 3) is None


def test_volsdf_canonical_raises_naming_the_reference_fault():
  for cls in (models.DynamicNeRF, models.LongDynamicNeRF):
    with pytest.raises(NotImplementedError, match="dyn.py:108"):
      cls(canonical_kind="volsdf")


# ---- the Bezier kit ----

def test_frenet_normal_and_arc_len_match_jax():
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import bezier as jbezier
  rng = np.random.default_rng(5)
  ctrl = rng.normal(size=(4, 10, 3)).astype(np.float32)
  t = rng.uniform(0, 1, (10, 1)).astype(np.float32)
  got = bezier.frenet_normal(torch.from_numpy(ctrl), torch.from_numpy(t), 4)
  ref = jbezier.frenet_normal(jnp.asarray(ctrl), jnp.asarray(t), 4)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
  np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                             atol=1e-6)
  for samples in (2, 16):
    got = bezier.arc_len(torch.from_numpy(ctrl), samples)
    ref = jbezier.arc_len(jnp.asarray(ctrl), samples)
    assert got.shape == (10,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
  line = torch.stack([torch.zeros(3), torch.ones(3) / 3,
                      2 * torch.ones(3) / 3, torch.ones(3)])
  assert abs(float(bezier.arc_len(line)) - 3 ** 0.5) < 1e-6


# ---- the regularizers ----

def _rel(a, b):
  return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
               / max(np.linalg.norm(np.asarray(b)), 1e-30))


@pytest.mark.parametrize("rigidity", [True, False])
@pytest.mark.parametrize("zero_dp", [False, True])
def test_out_dict_regularizers_match_jax(rigidity, zero_dp):
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import regularizers as jreg
  rng = np.random.default_rng(7)
  dp = (0 if zero_dp else 0.05) * rng.normal(size=(6, 16, 3))
  rig = rng.uniform(0.05, 0.95, (6, 16, 1))
  w = rng.uniform(0, 0.2, (6, 16))
  arrays = [a.astype(np.float32) for a in (dp, rig, w)]
  for name, fn in (("offset", regularizers.offset_nrnerf),
                   ("rigidity_sparsity", regularizers.rigidity_sparsity)):
    if name == "rigidity_sparsity" and not rigidity:
      continue

    def jfn(d, r):
      out = {"dp": d, "weights": jnp.asarray(arrays[2])}
      if rigidity:
        out["rigidity"] = r
      return jreg.REGULARIZERS[name](out)

    val_j, grads_j = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
    d, r = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:2])
    out = {"dp": d, "weights": torch.from_numpy(arrays[2])}
    if rigidity:
      out["rigidity"] = r
    val = fn(out)
    val.backward()
    val = val.detach()
    assert abs(float(val) - float(val_j)) <= 1e-5 * abs(float(val_j)), name
    assert regularizers.REGULARIZERS[name] is fn
    for got, ref in zip((d.grad, r.grad), grads_j):
      if np.abs(ref).max() == 0:
        assert got is None or float(got.abs().max()) == 0.0, name
        continue
      assert np.isfinite(got.numpy()).all()
      assert _rel(got.numpy(), ref) <= 1e-4, name
  assert regularizers.offset_nrnerf({}) == 0.0
  assert regularizers.rigidity_sparsity({}) == 0.0


def _eval_points(name, draws):
  """fn(model, dtype) evaluating the points a term reads, and the axis of
  the points in its activations."""
  if name in ("dyn_divergence", "ffjord_div"):
    pts, t, _ = draws
    return (lambda m, dt: m.delta_x(pts.to(dt), t.to(dt))), 0
  (pts,) = draws
  if name == "spline_pt0":
    return (lambda m, dt: m.delta_x(
        pts.to(dt), torch.zeros(pts.shape[0], 1, dtype=dt))), 0

  def length(m, dt):
    ts = (torch.arange(8) * (1 / 7)).to(dt)     # the term's float32 times
    m.delta_x(pts.to(dt).expand(8, -1, 3),
              ts[:, None, None].expand(8, pts.shape[0], 1))
  return length, 1


def jax_on_draws(monkeypatch, name, model, tree, draws):
  """The JAX term's value and parameter gradient on `draws` (the JAX
  random draws it makes replaced by them, in its order)."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import regularizers as jreg
  uniforms = iter(jnp.asarray(d.numpy()) for d in draws[:2])
  with monkeypatch.context() as mp:
    mp.setattr(jax.random, "uniform", lambda *a, **kw: next(uniforms))
    mp.setattr(jax.random, "rademacher",
               lambda *a, **kw: jnp.asarray(draws[2].numpy()))
    with jax.default_matmul_precision("highest"):
      val, grads = jax.value_and_grad(
          lambda p: jreg.POINT_REGULARIZERS[name](
              model.apply, p, jax.random.PRNGKey(0),
              n=draws[0].shape[0]))(tree)
  return float(val), convert.params_from_flax(jax.tree.map(np.asarray,
                                                           grads))


def jax_draws(name, key):
  """The JAX package's draws of a point-sampled regularizer
  (train/regularizers.py:242-309), as the port's draw functions return
  them."""
  import jax
  import jax.numpy as jnp
  if name in ("dyn_divergence", "ffjord_div"):
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.uniform(k1, (512, 3), minval=-1, maxval=1),
             jax.random.uniform(k2, (512, 1)),
             jax.random.rademacher(k3, (512, 3), dtype=jnp.float32))
  else:
    draws = (jax.random.uniform(key, (256, 3), minval=-1, maxval=1),)
  return tuple(torch.from_numpy(np.array(d)) for d in draws)


POINT_NAMES = ("dyn_divergence", "ffjord_div", "spline_length", "spline_pt0")
KEEP_POINTS = 128      # of the kink-free draws (the CPU time of the JAX side)


def jax_features_in_x(monkeypatch):
  """As `jax_features`, with the port's own derivative in x kept: the
  port's features take the JAX FourierEncoder's values by a detached
  correction, so that the divergence terms (which differentiate the warp
  in x) see the JAX features' values and the derivative 2πB·cos at the
  JAX phases."""
  import jax.numpy as jnp
  from nerf_atlas_tpu_torch.nn import FourierEncoder, encoders

  def forward(self, x):
    xj, bj = jnp.asarray(x.detach().numpy()), jnp.asarray(
        self.B.detach().numpy())
    mapped_j = 2 * np.pi * (xj @ bj)
    mapped = encoders.fourier_phases(x, self.B)
    mapped = mapped + (torch.from_numpy(np.array(mapped_j))
                       - mapped).detach()
    feats = torch.cat([torch.sin(mapped), torch.cos(mapped)], dim=-1)
    ref = torch.from_numpy(np.array(jnp.concatenate(
        [jnp.sin(mapped_j), jnp.cos(mapped_j)], axis=-1)))
    return feats + (ref - feats).detach()

  monkeypatch.setattr(FourierEncoder, "forward", forward)


@pytest.fixture(scope="module", params=["dx", "spline", "long"])
def warped(request):
  """A DynamicNeRF with D-NeRF's Δx warp and one with Spline-NeRF's S = 4
  warp, over the tiny canonical, and a LongDynamicNeRF, each with the
  warp active."""
  rays, times = rays_times(N, 2)
  extra = {"spline_points": 4} if request.param == "spline" else {}
  case = "long" if request.param == "long" else "tiny"
  model, tree = jax_model(case, rays, times, seed=4, **extra)
  return case, extra, model, tree, convert.params_from_flax(tree)


@pytest.mark.parametrize("name", POINT_NAMES)
def test_point_regularizers_match_jax(warped, name, monkeypatch):
  import jax
  case, extra, model, tree, sd = warped
  jax_features_in_x(monkeypatch)
  port = port_model(case, sd, **extra)
  draws = jax_draws(name, jax.random.PRNGKey(11))
  n = draws[0].shape[0]
  fn, axis = _eval_points(name, draws)
  keep = kink_free(port, fn, n, axis)
  assert int(keep.sum()) >= n // 2, int(keep.sum())
  draws = tuple(d[keep][:KEEP_POINTS] for d in draws)
  val_j, grads_j = jax_on_draws(monkeypatch, name, model, tree, draws)
  val = regularizers.POINT_REGULARIZERS[name][1](port, *draws)
  val.backward()
  val = val.detach()
  assert abs(float(val) - val_j) <= 1e-5 * abs(val_j), (name, float(val),
                                                        val_j)
  grads = {k: p.grad for k, p in port.named_parameters()}
  scale = max(float(g.norm()) for g in grads_j.values())
  for k, ref in grads_j.items():
    got = grads[k]
    if float(ref.abs().max()) == 0.0:
      assert got is None or float(got.abs().max()) == 0.0, k
      continue
    # a vanishing gradient (layer_out.bias under spline length: the
    # bias cancels between the times, leaving ~1e-6 of round-off) is
    # held against 1e-3 of the largest tensor's norm
    err = float((got - ref).norm() / max(float(ref.norm()), 1e-3 * scale))
    assert err <= 1e-4, (case, name, k, err)
  pinned = name == "spline_pt0" and bool(extra or case == "long")
  assert (val_j == 0.0) == pinned


def test_point_regularizers_dispatch_in_order():
  model = port_model("tiny", spline_points=4)
  coeffs = {"spline_pt0": 0.5, "delta_x": 3.0, "dyn_divergence": 0.25,
            "ffjord_div": 0.0}
  got = regularizers.point_regularizers(
      model, torch.Generator().manual_seed(3), coeffs)
  gen = torch.Generator().manual_seed(3)
  want = (0.5 * regularizers.spline_pt0(model,
                                        *regularizers.spline_draws(gen))
          + 0.25 * regularizers.dyn_divergence(
              model, *regularizers.divergence_draws(gen)))
  assert float(got) == float(want)
  pts, t, eps = regularizers.divergence_draws(
      torch.Generator().manual_seed(0))
  assert pts.shape == (512, 3) and t.shape == (512, 1)
  assert float(pts.abs().max()) <= 1.0 and 0 <= float(t.min())
  assert set(eps.unique().tolist()) == {-1.0, 1.0}
  assert regularizers.point_regularizers(model, None, {"offset": 1.0}) == 0.0
  ae = port_model("ae")
  for name in POINT_NAMES:
    with pytest.raises(NotImplementedError, match="delta_x"):
      regularizers.point_regularizers(ae, torch.Generator(), {name: 1.0})
