"""The VolSDF slice in the port: the Fourier encoder, the Laplace CDF, the
SDF MLP, the module with its eikonal, and K8f/K8b's plain versions, on
the CPU against the JAX package.

- `FourierEncoder`, `laplace_cdf` and the SDF `MLP` (both sphere inits)
  against the JAX ones, params transplanted by `convert.params_from_flax`:
  2e-4 (the Laplace CDF and its gradient 1e-6).
- The port's `VolSDF` forward with normals and the plain K8f
  (`volsdf_render_reference`, with and without the eikonal column)
  against the JAX `VolSDF` at full width: rgb, acc, sdf and the scale
  2e-4. The eikonal (the module's mean and K8f's per-ray column) is held
  to 1e-4 relative on the rays `testing.volsdf_kink_free_rays` clears
  (`exact_features`): the Fourier phases reach a few hundred radians,
  where XLA's dot and the port's three rounded products can differ in
  the last bit (3.05e-5 between 256 and 512), so a leaky-relu input of
  the SDF MLP near 0 can take the other slope in one of them and move
  that point's ∇ₓsdf itself.
- The plain K8b in modes G and L, with and without the eikonal (autograd
  through the plain K8f, the eikonal's second-order gradient by
  `create_graph=True`), against `jax.value_and_grad` through the JAX
  model at matmul precision "highest": loss 1e-5 relative, each gradient
  tensor 1e-4 relative, the raw scale included, on the cleared rays.
- `params_from_flax` moves the Fourier matrix from
  `shape/FourierEncoder_0/B` to `shape.mlp.enc.B`; `pack_weights` /
  `unpack_grads` (the scale's gradient chained through softplus);
  the CPU wrappers and `VolSDFRender`; the build key's headers.
- `cuda`-marked cases: K8f (both forms) and K8b (both modes, eikonal on
  and off, at 4096 rays) against their plain versions on the card, and
  two K8b launches bit for bit (`python -m pytest --noconftest -m cuda
  tests/test_torch_volsdf.py`).
The train paths, the gates and the runner: tests/test_torch_volsdf_train.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, testing  # noqa: E402
from nerf_atlas_tpu_torch.nn import FourierEncoder  # noqa: E402
from nerf_atlas_tpu_torch.nn.encoders import fourier_phases  # noqa: E402
from nerf_atlas_tpu_torch.ops import math as tmath  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import build  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_volsdf as k8  # noqa: E402

STEPS = 16
N = 24
EIK_RTOL = 1e-4


def _rays(n=N, seed=0):
  """Rays from a sphere of radius 4 aimed near the origin: they cross the
  unit sphere the SDF starts as."""
  rng = np.random.default_rng(seed)
  o = rng.normal(size=(n, 3))
  o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
  d = -o / 4.0 + rng.normal(size=(n, 3)) * 0.15
  return np.concatenate([o, d], -1).astype(np.float32)


def _jax_ts():
  import jax.numpy as jnp
  return torch.from_numpy(np.array(jnp.linspace(2.0, 6.0, STEPS,
                                                dtype=jnp.float32)))


@pytest.fixture(scope="module")
def oracle():
  """The JAX VolSDF (with normals) and its seed-0 params with seeded
  biases and the View's output layer ×40 (rgb spans (0, 1)), the rays,
  the transplanted state_dict and the rays both sides agree on to
  float32 order (`volsdf_kink_free_rays`, exact features)."""
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  rays = _rays()
  model = jmodels.VolSDF(sdf_kind="mlp", refl_kind="view", steps=STEPS,
                         t_near=2.0, t_far=6.0, with_normals=True,
                         sigmoid_kind="upshifted")
  tree = jax.tree.map(np.asarray, model.init(
      {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
      jnp.asarray(rays), train=True))
  rng = np.random.default_rng(7)
  tree = jax.tree_util.tree_map_with_path(
      lambda p, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                    if "bias" in jax.tree_util.keystr(p) else v), tree)
  out_layer = tree["params"]["refl"]["mlp"]["layer_out"]
  out_layer["kernel"] = out_layer["kernel"] * 40.0
  sd = convert.params_from_flax(tree)
  keep = testing.volsdf_kink_free_rays(sd, torch.from_numpy(rays), _jax_ts(),
                                       STEPS, exact_features=True).numpy()
  assert keep.sum() >= N // 2, keep.sum()
  return model, tree, sd, rays, keep


def _jax_out(model, tree, rays):
  import jax
  import jax.numpy as jnp
  with jax.default_matmul_precision("highest"):
    out = model.apply(tree, jnp.asarray(rays))
  return {k: np.asarray(v) for k, v in out.items()}


def test_fourier_encoder_matches_jax():
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu.nn import FourierEncoder as JFourier
  x = np.random.default_rng(1).uniform(-6, 6, (64, 3)).astype(np.float32)
  jenc = JFourier(input_dims=3, freqs=32, sigma=4.0)
  params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x))
  ref = np.asarray(jenc.apply(params, jnp.asarray(x)))
  enc = FourierEncoder(3, 32, 4.0)
  enc.load_state_dict(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
  assert enc.size() == 64 and not enc.B.requires_grad
  xt = torch.from_numpy(x).requires_grad_(True)
  got = enc(xt)
  np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-4)
  got.sum().backward()                      # B is fixed: x's gradient only
  assert enc.B.grad is None and xt.grad is not None
  # the phases: three rounded products summed in axis order, then ×2π
  B = enc.B.detach().numpy()
  want = ((x[:, :1] * B[0] + x[:, 1:2] * B[1]) + x[:, 2:3] * B[2]
          ) * np.float32(2 * np.pi)
  np.testing.assert_array_equal(
      fourier_phases(torch.from_numpy(x), enc.B).numpy(), want)
  enc.reset_parameters(torch.Generator().manual_seed(0))
  std = float(enc.B.std())
  assert 2.5 < std < 5.5, std                # N(0, 4²) over 96 draws


def test_laplace_cdf_matches_jax():
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops.math import laplace_cdf as jcdf
  v = np.linspace(-3, 3, 101).astype(np.float32)
  scale = np.float32(0.0956)
  ref = np.asarray(jcdf(jnp.asarray(v), scale))
  ref_grad = np.asarray(jax.grad(lambda a: jcdf(a, scale).sum())(
      jnp.asarray(v)))
  vt = torch.from_numpy(v).requires_grad_(True)
  got = tmath.laplace_cdf(vt, torch.tensor(scale))
  got.sum().backward()
  np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-6)
  np.testing.assert_allclose(vt.grad.numpy(), ref_grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sphere_init", [True, False])
def test_sdf_mlp_matches_jax(sphere_init):
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu.models.sdf import MLP as JMLP
  from nerf_atlas_tpu_torch.models.sdf import MLP, load_sdf_shape
  pts = np.random.default_rng(3).uniform(-1.5, 1.5, (96, 3)).astype(
      np.float32)
  jm = JMLP(sphere_init=sphere_init)
  params = jm.init(jax.random.PRNGKey(4), jnp.asarray(pts))
  with jax.default_matmul_precision("highest"):
    sdf_j, lat_j = jm.apply(params, jnp.asarray(pts))
  tm = load_sdf_shape("mlp", sphere_init=sphere_init)
  assert isinstance(tm, MLP)
  tm.load_state_dict(convert.params_from_flax(
      {"params": {"mlp": jax.tree.map(np.asarray, params)["params"]["mlp"],
                  "FourierEncoder_0": jax.tree.map(
                      np.asarray, params)["params"]["FourierEncoder_0"]}}))
  sdf_t, lat_t = tm(torch.from_numpy(pts))
  np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j),
                             atol=2e-4)
  np.testing.assert_allclose(lat_t.detach().numpy(), np.asarray(lat_j),
                             atol=2e-4)


def test_module_and_plain_k8f_match_jax(oracle):
  model, tree, sd, rays, keep = oracle
  ref = _jax_out(model, tree, rays)
  tmodel = models.VolSDF(steps=STEPS, with_normals=True,
                         sigmoid_kind="upshifted")
  tmodel.load_state_dict(sd)
  with torch.no_grad():
    out = tmodel(torch.from_numpy(rays))
  for key in ("rgb", "weights", "sdf_vals", "scale"):
    np.testing.assert_allclose(out[key].numpy(), ref[key], atol=2e-4,
                               err_msg=key)
  e_ref = np.square(np.linalg.norm(ref["normals"], axis=-1) - 1.0)
  kept = rays[keep]
  with torch.no_grad():
    out_k = tmodel(torch.from_numpy(kept))
  eik_ref = e_ref[keep].mean()
  assert abs(float(out_k["eikonal"]) - eik_ref) <= EIK_RTOL * eik_ref
  assert float(out["eikonal"]) > 1.0     # the residual is well above 0
  for want_eikonal in (False, True):
    got = k8.volsdf_render_reference(sd, torch.from_numpy(rays), steps=STEPS,
                                     sigmoid_kind="upshifted", ts=_jax_ts(),
                                     want_eikonal=want_eikonal)
    assert got.shape == (N, 5 if want_eikonal else 4)
    assert not got.requires_grad
    got = got.numpy()
    np.testing.assert_allclose(got[:, :3], ref["rgb"], atol=2e-4)
    np.testing.assert_allclose(got[:, 3], ref["weights"].sum(-1), atol=2e-4)
    if want_eikonal:
      e_ray = e_ref.mean(-1)
      np.testing.assert_allclose(got[keep, 4], e_ray[keep], rtol=EIK_RTOL)
  assert float(ref["rgb"].std()) > 0.05


def _jax_loss(model, mode, eikonal, rays, arg):
  """The JAX oracle's loss of mode G (Σ g·[rgb ‖ acc (‖ per-ray mean
  eikonal)]) or L (mean L2 + eikonal weight × mean eikonal)."""
  import jax.numpy as jnp

  def fn(p):
    out = model.apply(p, jnp.asarray(rays))
    acc = out["weights"].sum(-1, keepdims=True)
    e_ray = jnp.mean(jnp.square(jnp.linalg.norm(out["normals"], axis=-1)
                                - 1.0), axis=-1, keepdims=True)
    if mode == "G":
      cols = [out["rgb"], acc] + ([e_ray] if eikonal else [])
      return jnp.sum(jnp.concatenate(cols, -1) * jnp.asarray(arg))
    loss = jnp.mean((out["rgb"] - jnp.asarray(arg)) ** 2)
    return loss + eikonal * jnp.mean(e_ray)

  return fn


@pytest.mark.parametrize("mode,eikonal", [("G", 0.0), ("G", 1.0),
                                          ("L", 0.0), ("L", 0.01)])
def test_plain_k8b_matches_jax(oracle, mode, eikonal):
  jax = pytest.importorskip("jax")
  model, tree, sd, rays, keep = oracle
  rays = rays[keep]
  n = rays.shape[0]
  rng = np.random.default_rng(11)
  if mode == "G":
    arg = rng.normal(size=(n, 5 if eikonal else 4)).astype(np.float32)
  else:
    arg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
  with jax.default_matmul_precision("highest"):
    loss_j, grads_j = jax.value_and_grad(
        _jax_loss(model, mode, eikonal, rays, arg))(tree)
  grads_j = convert.params_from_flax(jax.tree.map(np.asarray, grads_j))
  kw = dict(steps=STEPS, sigmoid_kind="upshifted", ts=_jax_ts())
  r = torch.from_numpy(rays)
  if mode == "G":
    packed = k8.volsdf_render_grad_reference(
        sd, r, torch.from_numpy(arg), want_eikonal=bool(eikonal), **kw)
    loss = None
  else:
    loss, packed = k8.volsdf_train_step_reference(
        sd, r, torch.from_numpy(arg), eikonal_weight=eikonal, **kw)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
  grads = k8.unpack_grads(packed, sd[k8.SCALE_KEY])
  assert set(grads) == set(grads_j) - {k8.B_KEY}
  assert float(np.abs(grads_j[k8.B_KEY]).max()) == 0.0   # B: no gradient
  assert float(packed[k8.B_OFFSET:k8.MLP_OFFSET].abs().max()) == 0.0
  for key, ref in grads_j.items():
    if key == k8.B_KEY:
      continue
    err = float((grads[key] - ref).norm() / ref.norm())
    assert err <= 1e-4, (mode, eikonal, key, err)


def test_params_from_flax_moves_the_fourier_matrix(oracle):
  _, tree, sd, _, _ = oracle
  assert k8.B_KEY in sd and "shape.FourierEncoder_0.B" not in sd
  np.testing.assert_array_equal(
      sd[k8.B_KEY].numpy(), tree["params"]["shape"]["FourierEncoder_0"]["B"])
  assert sd[k8.SCALE_KEY].shape == ()
  model = models.VolSDF(steps=STEPS)
  assert set(model.state_dict()) == set(sd)
  assert float(model.density_scale) == pytest.approx(-2.3)
  assert float(models.VolSDF(scale_kind="ident").density_scale) == (
      pytest.approx(0.1))


def test_pack_and_unpack(oracle):
  _, _, sd, rays, _ = oracle
  ws = k8.pack_weights(sd)
  assert ws.shape == (k8.WEIGHT_COUNT,) == (552325,)
  assert float(ws[0]) == pytest.approx(
      float(torch.nn.functional.softplus(sd[k8.SCALE_KEY]) + 1e-4))
  np.testing.assert_array_equal(
      ws[k8.B_OFFSET:k8.MLP_OFFSET].view(3, -1).numpy(), sd[k8.B_KEY].numpy())
  back = k8.unpack_grads(ws, sd[k8.SCALE_KEY])
  for key, value in back.items():
    if key != k8.SCALE_KEY:
      assert torch.equal(value, sd[key]), key
  raw = sd[k8.SCALE_KEY]
  assert float(back[k8.SCALE_KEY]) == pytest.approx(
      float(ws[0] * torch.sigmoid(raw)), rel=1e-6)   # d/ds · ds/draw
  wt = k8._transposed(ws)
  _, i0, o0 = k8.LAYERS[0]
  name, i, o = k8.LAYERS[1]                  # layer_0 after layer_in
  pos = k8.MLP_OFFSET + i0 * o0 + o0
  np.testing.assert_array_equal(wt[pos:pos + i * o].view(o, i).numpy(),
                                sd[f"{name}.weight"].numpy())
  bad = dict(sd)
  del bad[k8.B_KEY]
  with pytest.raises(KeyError):
    k8.pack_weights(bad)
  with pytest.raises(ValueError):
    k8.pack_weights(ws[:-1])


def test_cpu_wrappers_take_the_plain_versions(oracle):
  _, _, sd, rays, keep = oracle
  r = torch.from_numpy(rays[keep][:6])
  ws = k8.pack_weights(sd)
  kw = dict(steps=STEPS, sigmoid_kind="upshifted", sky_kind="white")
  launches = (k8.fused_volsdf_render.launches,
              k8.fused_volsdf_render_grad.launches,
              k8.fused_volsdf_train_step.launches)
  for want in (False, True):
    out = k8.fused_volsdf_render(ws, r, want_eikonal=want, **kw)
    ref = k8.volsdf_render_reference(ws, r, want_eikonal=want, **kw)
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    leaf = ws.clone().requires_grad_(True)
    (k8.fused_volsdf_render_train(leaf, r, want_eikonal=want, **kw) * g
     ).sum().backward()
    direct = k8.fused_volsdf_render_grad(ws, r, g, want_eikonal=want, **kw)
    assert torch.equal(leaf.grad, direct)
  target = torch.rand(6, 3, generator=torch.Generator().manual_seed(2))
  loss, grad = k8.fused_volsdf_train_step(ws, r, target, eikonal_weight=0.01,
                                          **kw)
  ref_loss, ref_grad = k8.volsdf_train_step_reference(
      ws, r, target, eikonal_weight=0.01, **kw)
  assert torch.equal(loss, ref_loss) and torch.equal(grad, ref_grad)
  assert launches == (k8.fused_volsdf_render.launches,
                      k8.fused_volsdf_render_grad.launches,
                      k8.fused_volsdf_train_step.launches)
  with pytest.raises(ValueError, match="steps"):
    k8.volsdf_render_reference(ws, r, steps=4096)


def test_kink_free_rule_flags_near_zero_pre_activations(oracle):
  _, _, sd, rays, _ = oracle
  r = torch.from_numpy(rays)
  card = testing.volsdf_kink_free_rays(sd, r, _jax_ts(), STEPS)
  exact = testing.volsdf_kink_free_rays(sd, r, _jax_ts(), STEPS,
                                        exact_features=True)
  assert card.dtype == torch.bool and card.shape == (N,)
  assert bool((exact <= card).all())     # exact features flag more rays
  assert bool(testing.volsdf_kink_free_rays(sd, r, _jax_ts(), STEPS,
                                            margin=0.0).all())


def test_unported_sdf_kinds_and_options_raise():
  from nerf_atlas_tpu_torch.models.sdf import load_sdf_shape
  for kind in ("siren", "curl-mlp", "local", "spheres", "triangles"):
    with pytest.raises(NotImplementedError, match="Queue 1 #10/#13"):
      load_sdf_shape(kind)
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    load_sdf_shape("mlp", bounded=True)
  for kw in (dict(occ_kind="all-learned"), dict(integrator_kind="direct"),
             dict(light_kind="field")):
    with pytest.raises(NotImplementedError, match="Queue 1 #13"):
      models.VolSDF(**kw)
  with pytest.raises(NotImplementedError, match="Queue 1 #13"):
    models.VolSDF().surface_render(torch.zeros(1, 6))
  assert isinstance(models.load_model("volsdf"), models.VolSDF)


def test_volsdf_sources_share_the_headers():
  for name in ("render_volsdf_fwd", "render_volsdf_bwd"):
    text = (build.CSRC / f"{name}.cu").read_text()
    assert '#include "render_volsdf.cuh"' in text
  header = (build.CSRC / "render_volsdf.cuh").read_text()
  assert '#include "render_common.cuh"' in header
  common = (build.CSRC / "render_common.cuh").read_text()
  for helper in ("mlp_input_grad", "seed_column"):   # K8f's eikonal column
    assert f" {helper}(" in common, helper
  assert " mlp_input_grad_adjoint(" not in common
  # K8b's chain and adjoint: the tensor-core counterparts, which both
  # backward sources (K8b, K9b) include
  tc = (build.CSRC / "mma_tf32.cuh").read_text()
  for helper in ("mlp_input_grad", "mlp_input_grad_adjoint", "mlp_bwd"):
    assert f" {helper}(" in tc, helper
  for name in ("render_volsdf_bwd", "render_dyn_bwd"):
    assert '#include "mma_tf32.cuh"' in (build.CSRC / f"{name}.cu").read_text()
  fwd = build.source_digest(build.CSRC / "render_volsdf_fwd.cu")
  bwd = build.source_digest(build.CSRC / "render_volsdf_bwd.cu")
  assert len(fwd) == len(bwd) == 16 and fwd != bwd


# ---- on the card ----

def _cuda_case(n, steps, seed):
  if not torch.cuda.is_available():
    pytest.skip("needs CUDA")
  torch.backends.cuda.matmul.allow_tf32 = False
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  from nerf_atlas_tpu_torch.train import driver
  sd = dict(driver.init_model(models.VolSDF(steps=steps), seed=0)
            .state_dict())
  sd["refl.mlp.layer_out.weight"] = sd["refl.mlp.layer_out.weight"] * 40.0
  ws = k8.pack_weights(sd, "cuda")
  gen = torch.Generator(device="cuda").manual_seed(seed)
  ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                           device="cuda")
  rays = torch.from_numpy(_rays(n, seed)).cuda()
  keep = testing.volsdf_kink_free_rays(ws, rays, ts, steps)
  return sd, ws, rays, ts, gen, keep


@pytest.mark.cuda
@pytest.mark.parametrize("want_eikonal", [False, True])
def test_cuda_k8f_matches_plain(want_eikonal):
  _, ws, rays, ts, _, keep = _cuda_case(301, 64, 1)
  kw = dict(steps=64, ts=ts, sigmoid_kind="upshifted",
            want_eikonal=want_eikonal)
  got = k8.fused_volsdf_render(ws, rays, **kw)
  ref = k8.volsdf_render_reference(ws, rays, **kw)
  torch.cuda.synchronize()
  assert float((got[:, :4] - ref[:, :4]).abs().max()) <= 1e-4
  if want_eikonal:
    assert float((got[keep, 4] - ref[keep, 4]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode,eikonal", [("G", False), ("G", True),
                                          ("L", False), ("L", True)])
def test_cuda_k8b_matches_plain(mode, eikonal):
  """At chip_smoke's 4096 rays: the eikonal's weight gradient sums
  per-point terms that mostly cancel, and its float32 rounding, in the
  kernel and in the plain version alike, falls as 1/√rays below the 1e-4
  gate only there (chip_smoke prints the floor at 301 and 1001 rays)."""
  sd, ws, rays, ts, gen, keep = _cuda_case(4096, 64, 2)
  n = rays.shape[0]
  kw = dict(steps=64, sigmoid_kind="upshifted")
  if mode == "G":
    g = torch.randn(n, 5 if eikonal else 4, device="cuda", generator=gen)
    g = (g * keep[:, None]).contiguous()
    got = k8.fused_volsdf_render_grad(ws, rays, g, ts=ts,
                                      want_eikonal=eikonal, **kw)
    ref = k8.volsdf_render_grad_reference(ws, rays, g, ts=ts,
                                          want_eikonal=eikonal, **kw)
  else:
    out = k8.volsdf_render_reference(ws, rays, ts=ts, **kw)[:, :3]
    target = torch.where(keep[:, None], torch.rand(n, 3, device="cuda",
                                                   generator=gen), out)
    weight = 0.01 if eikonal else 0.0
    loss, got = k8.fused_volsdf_train_step(ws, rays, target.contiguous(), ts,
                                           eikonal_weight=weight, **kw)
    loss_r, ref = k8.volsdf_train_step_reference(
        ws, rays, target, ts=ts, eikonal_weight=weight, **kw)
    assert abs(float(loss) - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    again = k8.fused_volsdf_train_step(ws, rays, target.contiguous(), ts,
                                       eikonal_weight=weight, **kw)
    assert torch.equal(again[1], got) and torch.equal(again[0], loss)
  torch.cuda.synchronize()
  ug = k8.unpack_grads(got, sd[k8.SCALE_KEY].cuda())
  ur = k8.unpack_grads(ref, sd[k8.SCALE_KEY].cuda())
  for key in ur:
    err = float((ug[key] - ur[key]).norm() / ur[key].norm())
    assert err <= 1e-4, (key, err)
