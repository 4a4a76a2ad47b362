"""The D-NeRF slice in the port: the dynamic scene, the sampler's times,
the Bezier kit, the DynamicNeRF module and K9f/K9b's plain versions, on
the CPU against the JAX package, in four modes: the cp and posenc
canonical, each with the Δx warp and the Spline-NeRF warp at S = 4.

- The dynamic scene's images and times, the sampler's per-ray times,
  `de_casteljau`, `cubic_bezier` and `bezier_derivative` against the JAX
  ones; the Bernstein weights against autograd through de Casteljau at
  S = 2, 4 and 5 (the backward's adjoint of the spline).
- The warp's Fourier features against the JAX FourierEncoder: XLA's dot
  sums the four products in another order, so at σ = 16 the phases (up
  to ~800 radians on these rays) differ by up to two float32 ulps of the
  largest phase (measured 1.2e-4 on 40% of them); the features are held
  to that plus 1e-6.
- The port's DynamicNeRF forward and the plain K9f (with the dp² column)
  against the JAX DynamicNeRF with the params transplanted by
  `convert.params_from_flax` and the warp's zero layer_out replaced by
  seeded 0.03·N(0, 1) weights and 0.01·N(0, 1) biases (max|dp| > 1e-4):
  rgb, acc, dp and the dp column 2e-4.
- The plain K9b in modes G and L, each with and without the dp² term,
  against `jax.value_and_grad` through the JAX model at matmul precision
  "highest": loss 1e-5 relative, each gradient tensor 1e-4 relative, the
  warp's and the rigidity's gradients non-zero, B's zero. Here the port
  takes the JAX package's Fourier features (and, for posenc, its bands,
  as tests/test_torch_k4.py does): a phase ulp moves a warp
  pre-activation across the leaky-relu kink on most rays, so the two
  chains are held on the same features, and on the rays
  `testing.dyn_kink_free_rays` clears.
- `params_from_flax` puts the warp's B at `warp.enc.B`; `pack_weights` /
  `unpack_grads` (the spline's padded layer_out); the CPU wrappers and
  `DynRender`; the kink-free rule; the options not ported (the voxel and
  rig models, a VolSDF canonical); the sources' headers and build
  variants.
- `cuda`-marked cases: K9f (both forms) and K9b (both modes, dp on and
  off) against their plain versions on the card in every mode, two K9b
  launches bit for bit (`python -m pytest --noconftest -m cuda
  tests/test_torch_dyn.py`).
The train paths, the gates and the runner: tests/test_torch_dyn_train.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, testing  # noqa: E402
from nerf_atlas_tpu_torch.data import sampler, synthetic  # noqa: E402
from nerf_atlas_tpu_torch.nn import FourierEncoder  # noqa: E402
from nerf_atlas_tpu_torch.ops import bezier  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import build  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_dyn as k9  # noqa: E402

STEPS = 16
N = 48
MODES = [("cp", 0), ("cp", 4), ("posenc", 0), ("posenc", 4)]
IDS = ["cp-dx", "cp-spline4", "posenc-dx", "posenc-spline4"]


def rays_times(n, seed, steps_origin=3.5):
  """Rays from (0, 0, 3.5) about −z (they cross the CP box) and each
  ray's time, from numpy's seeded generator."""
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, steps_origin]], (n, 1))
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return (np.concatenate([r_o, r_d], -1).astype(np.float32),
          rng.uniform(0, 1, n).astype(np.float32))


def jax_ts(steps=STEPS):
  import jax.numpy as jnp
  return torch.from_numpy(np.array(jnp.linspace(2.0, 6.0, steps,
                                                dtype=jnp.float32)))


def jax_tree(enc, spline, rays, times, seed=0):
  """The JAX DynamicNeRF and its seed params with the warp active (seeded
  0.03·N(0, 1) layer_out weights, 0.01·N(0, 1) biases) and the View's
  output layer ×40 (rgb spans (0, 1))."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  model = jmodels.DynamicNeRF(
      canonical_kind="plain", canonical_kwargs={"enc_kind": enc},
      spline_points=spline, with_rigidity=True, steps=STEPS, t_near=2.0,
      t_far=6.0)
  tree = jax.tree.map(np.asarray, model.init(
      {"params": jax.random.PRNGKey(seed),
       "sampler": jax.random.PRNGKey(seed + 1)}, jnp.asarray(rays),
      times=jnp.asarray(times), train=True))
  rng = np.random.default_rng(seed + 3)
  wl = tree["params"]["warp"]["layer_out"]
  wl["kernel"] = (0.03 * rng.normal(size=wl["kernel"].shape)).astype(
      np.float32)
  wl["bias"] = (0.01 * rng.normal(size=wl["bias"].shape)).astype(np.float32)
  out_layer = tree["params"]["canonical"]["refl"]["mlp"]["layer_out"]
  out_layer["kernel"] = out_layer["kernel"] * 40.0
  return model, tree


def jax_features(monkeypatch, enc):
  """Make the port's Fourier features (the module's FourierEncoder and the
  plain K9f's warp init feature) the JAX FourierEncoder's, and for posenc
  its bands (tests/test_torch_k4.py `jax_bands`)."""
  import jax.numpy as jnp
  from nerf_atlas_tpu.nn import FourierEncoder as JFourier
  from test_torch_k4 import jax_bands

  def features(x, B):
    enc_j = JFourier(input_dims=B.shape[0], freqs=B.shape[1])
    return torch.from_numpy(np.array(enc_j.apply(
        {"params": {"B": jnp.asarray(B.detach().numpy())}},
        jnp.asarray(x.detach().numpy()))))

  monkeypatch.setattr(FourierEncoder, "forward",
                      lambda self, x: features(x, self.B))
  monkeypatch.setattr(k9, "warp_init_feature",
                      lambda x, fb: torch.cat([x, features(x, fb)], dim=-1))
  if enc == "posenc":
    jax_bands(monkeypatch)


@pytest.fixture(scope="module", params=MODES, ids=IDS)
def oracle(request):
  enc, spline = request.param
  rays, times = rays_times(N, 1)
  model, tree = jax_tree(enc, spline, rays, times)
  return enc, spline, model, tree, convert.params_from_flax(tree), rays, times


def jax_out(model, tree, rays, times):
  import jax
  import jax.numpy as jnp
  with jax.default_matmul_precision("highest"):
    out = model.apply(tree, jnp.asarray(rays), times=jnp.asarray(times))
  return {k: np.asarray(v) for k, v in out.items()}


# ---- data, sampler, Bezier ----

@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_scene_matches_jax(seed):
  from nerf_atlas_tpu.data import synthetic as jsynth
  (imgs_j, times_j), _, _ = jsynth.dataset(num_views=3, size=8, dynamic=True,
                                           seed=seed)
  (imgs_t, times_t), cam, lights = synthetic.dataset(
      num_views=3, size=8, dynamic=True, seed=seed)
  assert lights is None and imgs_t.shape == (3, 8, 8, 4)
  np.testing.assert_array_equal(times_t, times_j)
  np.testing.assert_allclose(imgs_t, np.asarray(imgs_j), atol=1e-5, rtol=0)
  static, _, _ = synthetic.dataset(num_views=3, size=8, seed=seed)
  assert np.abs(static - imgs_t).max() > 0.05      # the first sphere moved


def test_sampler_returns_each_rays_view_time():
  from nerf_atlas_tpu_torch.data import loaders
  bundle = loaders.load("", data_kind="synthetic-dyn", size=8, num_views=4)
  ds = sampler.RayDataset.from_bundle(bundle, size=8)
  np.testing.assert_array_equal(ds.times.numpy(),
                                np.linspace(0, 1, 4).astype(np.float32))
  gen = torch.Generator().manual_seed(0)
  rays, pix, t, view = ds.sample(gen, 64, jitter=1.0)
  assert torch.equal(t, ds.times[view]) and rays.shape == (64, 6)
  static = sampler.RayDataset.from_bundle(
      loaders.load("", data_kind="synthetic", size=8, num_views=4), size=8)
  assert static.times is None
  assert static.sample(torch.Generator().manual_seed(0), 8)[2] is None


def test_bezier_kit_matches_jax():
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import bezier as jbezier
  rng = np.random.default_rng(4)
  ctrl = rng.normal(size=(4, 10, 3)).astype(np.float32)
  t = rng.uniform(0, 1, (10, 1)).astype(np.float32)
  ct, tt = torch.from_numpy(ctrl), torch.from_numpy(t)
  for fn, jfn, kw in ((bezier.de_casteljau, jbezier.de_casteljau, {}),
                      (bezier.cubic_bezier, jbezier.cubic_bezier, {}),
                      (bezier.bezier_derivative, jbezier.bezier_derivative,
                       {"deriv": 2})):
    got = fn(ct, tt, 4, **kw).numpy()
    ref = np.asarray(jfn(jnp.asarray(ctrl), jnp.asarray(t), 4, **kw))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
  np.testing.assert_array_equal(
      bezier.de_casteljau(ct, tt, 4).numpy(),
      np.asarray(jbezier.de_casteljau(jnp.asarray(ctrl), jnp.asarray(t), 4)))


@pytest.mark.parametrize("spline", [2, 4, 5])
def test_bernstein_weights_are_de_casteljaus_adjoint(spline):
  """K9b scatters d spl into control point j by B_{j,S−1}(t); autograd
  through the forward's repeated lerp gives the same cotangent."""
  rng = np.random.default_rng(spline)
  ctrl = torch.from_numpy(rng.normal(size=(spline - 1, 64, 3)).astype(
      np.float32)).requires_grad_(True)
  t = torch.from_numpy(rng.uniform(0, 1, (64, 1)).astype(np.float32))
  g = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
  full = torch.cat([torch.zeros_like(ctrl[:1]), ctrl])        # P_0 = 0
  (bezier.de_casteljau(full, t, spline) * g).sum().backward()
  weights = bezier.bernstein_weights(t, spline - 1)
  want = torch.stack([w * g for w in weights])
  np.testing.assert_allclose(ctrl.grad.numpy(), want.numpy(), rtol=1e-5,
                             atol=1e-6)


# ---- the Fourier features, the module and the plain K9f ----

def test_fourier_features_match_jax_to_two_phase_ulps():
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.nn import FourierEncoder as JFourier
  from nerf_atlas_tpu_torch.nn.encoders import fourier_phases
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  rays, times = rays_times(256, 2)
  pts = k1.hash_pts(torch.from_numpy(rays), jax_ts()).view(256, STEPS, 3)
  x = torch.cat([pts, torch.from_numpy(times)[:, None, None].expand(
      -1, STEPS, 1)], -1)
  jenc = JFourier(input_dims=4, freqs=32, sigma=16.0)
  params = jenc.init(jax.random.PRNGKey(2), jnp.asarray(x.numpy()))
  ref = np.asarray(jenc.apply(params, jnp.asarray(x.numpy())))
  enc = FourierEncoder(4, 32, 16.0)
  enc.load_state_dict(convert.params_from_flax(jax.tree.map(np.asarray,
                                                            params)))
  got = enc(x).detach().numpy()
  phase = float(fourier_phases(x, enc.B).abs().max())
  tol = 2 * float(np.spacing(np.float32(phase))) + 1e-6
  err = float(np.abs(got - ref).max())
  assert 300 < phase < 2000 and err <= tol, (phase, err, tol)


def test_module_and_plain_k9f_match_jax(oracle, monkeypatch):
  enc, spline, model, tree, sd, rays, times = oracle
  if enc == "posenc":
    from test_torch_k4 import jax_bands
    jax_bands(monkeypatch)
  ref = jax_out(model, tree, rays, times)
  assert float(np.abs(ref["dp"]).max()) > 1e-4          # the warp is active
  tmodel = models.DynamicNeRF(canonical_kwargs={"enc_kind": enc},
                              spline_points=spline, steps=STEPS)
  tmodel.load_state_dict(sd)
  with torch.no_grad():
    out = tmodel(torch.from_numpy(rays), times=torch.from_numpy(times))
  for key in ("rgb", "weights", "dp", "rigidity"):
    np.testing.assert_allclose(out[key].numpy(), ref[key], atol=2e-4,
                               err_msg=key)
  got = k9.dyn_render_reference(sd, torch.from_numpy(rays),
                                torch.from_numpy(times), steps=STEPS,
                                spline_points=spline, enc_kind=enc,
                                want_dp=True, ts=jax_ts()).numpy()
  np.testing.assert_allclose(got[:, :3], ref["rgb"], atol=2e-4)
  np.testing.assert_allclose(got[:, 3], ref["weights"].sum(-1), atol=2e-4)
  np.testing.assert_allclose(got[:, 4], np.square(ref["dp"]).mean((1, 2)),
                             atol=2e-4, rtol=1e-4)
  assert float(ref["rgb"].std()) > 0.05


def _jax_value_and_grad(model, tree, rays, times, g, target, mode, dp):
  """The JAX oracle's value_and_grad of Σ g·[rgb ‖ acc ‖ per-ray mean dp²]
  (mode G) or mean L2 + dp × mean dp² (mode L), run op by op (eagerly),
  as the port's injected features are computed: under jit XLA may fuse
  the sample points' product and sum, and move the phases again."""
  import jax
  import jax.numpy as jnp

  def fn(p):
    out = model.apply(p, jnp.asarray(rays), times=jnp.asarray(times))
    acc = out["weights"].sum(-1, keepdims=True)
    m = jnp.mean(jnp.mean(jnp.square(out["dp"]), axis=-1), axis=-1,
                 keepdims=True)
    if mode == "G":
      return jnp.sum(jnp.concatenate([out["rgb"], acc, m], -1) * g)
    return jnp.mean((out["rgb"] - target) ** 2) + dp * jnp.mean(m)

  with jax.default_matmul_precision("highest"):
    return jax.value_and_grad(fn)(tree)


KEEP = 16


@pytest.mark.parametrize("mode,dp", [("G", 0.0), ("G", 1.0), ("L", 0.0),
                                     ("L", 1e-3)])
def test_plain_k9b_matches_jax(oracle, mode, dp, monkeypatch):
  jax = pytest.importorskip("jax")
  enc, spline, model, tree, sd, rays, times = oracle
  jax_features(monkeypatch, enc)
  keep = testing.dyn_kink_free_rays(sd, torch.from_numpy(rays),
                                    torch.from_numpy(times), jax_ts(), STEPS,
                                    enc, spline).numpy()
  clear = np.flatnonzero(keep)[:KEEP]     # one shape for every mode and case
  assert clear.shape == (KEEP,), keep.sum()
  rays, times = rays[clear], times[clear]
  n = rays.shape[0]
  rng = np.random.default_rng(11)
  g = rng.normal(size=(n, 5)).astype(np.float32)
  if not dp:
    g[:, 4] = 0.0
  target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
  arg = g[:, :5 if dp else 4].copy() if mode == "G" else target
  loss_j, grads_j = _jax_value_and_grad(model, tree, rays, times, g, target,
                                        mode, dp)
  grads_j = convert.params_from_flax(jax.tree.map(np.asarray, grads_j))
  kw = dict(steps=STEPS, ts=jax_ts(), spline_points=spline, enc_kind=enc)
  r, t = torch.from_numpy(rays), torch.from_numpy(times)
  if mode == "G":
    packed = k9.dyn_render_grad_reference(sd, r, t, torch.from_numpy(arg),
                                          want_dp=bool(dp), **kw)
  else:
    loss, packed = k9.dyn_train_step_reference(sd, r, t,
                                               torch.from_numpy(arg),
                                               dp_weight=dp, **kw)
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
  grads = k9.unpack_grads(packed, enc, spline)
  assert set(grads) == set(grads_j) - {k9.B_KEY}
  assert float(np.abs(grads_j[k9.B_KEY]).max()) == 0.0   # B: no gradient
  lay = k9.layout(enc, spline)
  assert float(packed[:lay.warp_offset].abs().max()) == 0.0
  for key, ref in grads_j.items():
    if key == k9.B_KEY:
      continue
    if key.startswith(("warp.", "rigidity.")):
      assert float(ref.norm()) > 0 and float(grads[key].norm()) > 0, key
    err = float((grads[key] - ref).norm() / ref.norm())
    assert err <= 1e-4, (mode, dp, key, err)


# ---- the tree, the packing, the wrappers ----

def test_params_from_flax_maps_the_dynamic_tree(oracle):
  enc, spline, _, tree, sd, _, _ = oracle
  np.testing.assert_array_equal(sd[k9.B_KEY].numpy(),
                                tree["params"]["warp"]["enc"]["B"])
  model = models.DynamicNeRF(canonical_kwargs={"enc_kind": enc},
                             spline_points=spline, steps=STEPS)
  assert set(model.state_dict()) == set(sd)
  assert sd[k9.B_KEY].shape == (3 if spline else 4, 32)
  assert not model.warp.enc.B.requires_grad


def test_pack_and_unpack(oracle):
  enc, spline, _, _, sd, _, _ = oracle
  lay = k9.layout(enc, spline)
  ws = k9.pack_weights(sd, enc_kind=enc, spline_points=spline)
  assert ws.shape == (lay.weight_count,)
  np.testing.assert_array_equal(ws[:lay.warp_offset].numpy(),
                                sd[k9.B_KEY].numpy().reshape(-1))
  back = k9.unpack_grads(ws, enc, spline)
  assert set(back) == set(sd) - {k9.B_KEY}
  for key, value in back.items():
    assert torch.equal(value, sd[key]), key
  _, warp, _, canon = k9._unpack(ws, lay)
  w_out, b_out = warp[-1]
  real = 3 if spline == 0 else 3 * (spline - 1)
  assert w_out.shape[1] == (3 if spline == 0 else k9.SPLINE_OUT)
  assert not w_out[:, real:].any() and not b_out[real:].any()
  from nerf_atlas_tpu_torch.ops.kernels import render as k1
  assert canon.shape == (k1.LAYOUTS[enc].weight_count,)
  # K9b's TC pack indexes every Dense W of the four MLPs (their biases
  # are read from the packed vector), and nothing else but the zero pad
  index, _ = k1.tc_layout_index(lay.tc_mlps, lay.weight_count)
  dense = set()
  for pos, layers, _ in lay.tc_mlps:
    for _, i, o in layers:
      dense.update(range(pos, pos + i * o))
      pos += i * o + o
  assert set(index.tolist()) == dense | {lay.weight_count}
  bad = dict(sd)
  del bad["rigidity.layer_in.bias"]
  with pytest.raises(KeyError):
    k9.pack_weights(bad, enc_kind=enc, spline_points=spline)
  with pytest.raises(ValueError):
    k9.pack_weights(sd, enc_kind=enc, spline_points=5 if spline else 2)
  with pytest.raises(ValueError):
    k9.pack_weights(ws[:-1], enc_kind=enc, spline_points=spline)


def test_cpu_wrappers_take_the_plain_versions(oracle):
  enc, spline, _, _, sd, rays, times = oracle
  r, t = torch.from_numpy(rays[:6]), torch.from_numpy(times[:6])
  ws = k9.pack_weights(sd, enc_kind=enc, spline_points=spline)
  kw = dict(steps=STEPS, spline_points=spline, enc_kind=enc,
            sky_kind="white")
  launches = (k9.fused_dyn_render.launches, k9.fused_dyn_render_grad.launches,
              k9.fused_dyn_train_step.launches)
  for want in (False, True):
    out = k9.fused_dyn_render(ws, r, t, want_dp=want, **kw)
    ref = k9.dyn_render_reference(ws, r, t, want_dp=want, **kw)
    assert torch.equal(out, ref) and out.shape == (6, 5 if want else 4)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    leaf = ws.clone().requires_grad_(True)
    (k9.fused_dyn_render_train(leaf, r, t, want_dp=want, **kw) * g
     ).sum().backward()
    direct = k9.fused_dyn_render_grad(ws, r, t, g, want_dp=want, **kw)
    assert torch.equal(leaf.grad, direct)
  target = torch.rand(6, 3, generator=torch.Generator().manual_seed(2))
  loss, grad = k9.fused_dyn_train_step(ws, r, t, target, dp_weight=1e-3,
                                       **kw)
  ref_loss, ref_grad = k9.dyn_train_step_reference(ws, r, t, target,
                                                   dp_weight=1e-3, **kw)
  assert torch.equal(loss, ref_loss) and torch.equal(grad, ref_grad)
  assert launches == (k9.fused_dyn_render.launches,
                      k9.fused_dyn_render_grad.launches,
                      k9.fused_dyn_train_step.launches)
  with pytest.raises(ValueError, match="times"):
    k9.dyn_render_reference(ws, r, t[:5], **kw)
  with pytest.raises(ValueError, match="steps"):
    k9.dyn_render_reference(ws, r, t, **dict(kw, steps=4096))


def test_kink_free_rule_flags_kinks_and_taps(oracle):
  enc, spline, _, _, sd, rays, times = oracle
  r, t = torch.from_numpy(rays), torch.from_numpy(times)
  card = testing.dyn_kink_free_rays(sd, r, t, jax_ts(), STEPS, enc, spline)
  exact = testing.dyn_kink_free_rays(sd, r, t, jax_ts(), STEPS, enc, spline,
                                     exact_features=True)
  assert card.dtype == torch.bool and card.shape == (N,)
  assert bool((exact <= card).all())     # exact features flag more rays
  assert 0 < int(card.sum()) < N
  assert bool(testing.dyn_kink_free_rays(sd, r, t, jax_ts(), STEPS, enc,
                                         spline, margin=0.0).all())


def test_unported_dynamic_options_raise():
  """The voxel and rig dynamic models (ROADMAP Queue 1 #11) and a VolSDF
  canonical (the reference's fault, ROADMAP Queue 3) raise; the time
  latent, the other canonicals, DynamicNeRFAE and LongDynamicNeRF are
  held against JAX in tests/test_torch_dyn_family.py."""
  for kind in ("voxel", "rig"):
    with pytest.raises(NotImplementedError, match="Queue 1 #11"):
      models.load_dyn_model(kind)
  with pytest.raises(NotImplementedError, match="Queue 3"):
    models.DynamicNeRF(canonical_kind="volsdf")
  assert set(models.DYN_MODEL_KINDS) == {"plain", "ae", "long"}
  with pytest.raises(ValueError):
    models.DynamicNeRF(spline_points=1)
  with pytest.raises(ValueError):
    k9.layout("cp", k9.MAX_SPLINE + 1)
  with pytest.raises(NotImplementedError):
    k9.layout("hash", 0)
  model = models.DynamicNeRF(steps=4)
  with pytest.raises(ValueError, match="time"):
    model(torch.zeros(2, 6))


def test_dyn_sources_share_the_headers():
  header = (build.CSRC / "render_dyn.cuh").read_text()
  assert '#include "render_plain.cuh"' in header
  plain = (build.CSRC / "render_plain.cuh").read_text()
  for helper in ("cp_encode_rows", "cp_backward", "posenc_position_grad",
                 "cp_tap", "cp_lerp"):
    assert f" {helper}(" in plain, helper
  k2 = (build.CSRC / "render_bwd.cu").read_text()
  assert "cp_backward<false>(" in k2 and "cp_encode_rows(" in k2
  assert "float cp_tap(" not in k2          # one copy, in render_plain.cuh
  digests = set()
  for name in ("render_dyn_fwd", "render_dyn_bwd"):
    text = (build.CSRC / f"{name}.cu").read_text()
    assert '#include "render_dyn.cuh"' in text
    for enc, spline in k9.variants():
      digests.add(build.source_digest(build.CSRC / f"{name}.cu",
                                      k9.defines(enc, spline)))
  assert len(digests) == 8
  assert k9.defines("posenc", 4) == ("RENDER_DYN_ENC=2",
                                     "RENDER_DYN_SPLINE=1")


# ---- on the card ----

def _cuda_case(enc, spline, n, steps, seed):
  if not torch.cuda.is_available():
    pytest.skip("needs CUDA")
  torch.backends.cuda.matmul.allow_tf32 = False
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  from nerf_atlas_tpu_torch.train import driver
  sd = dict(driver.init_model(models.DynamicNeRF(
      canonical_kwargs={"enc_kind": enc}, spline_points=spline,
      steps=steps), seed=0).state_dict())
  rng = np.random.default_rng(seed)
  for key, scale in (("warp.layer_out.weight", 0.03),
                     ("warp.layer_out.bias", 0.01)):
    sd[key] = torch.from_numpy((scale * rng.normal(size=sd[key].shape)
                                ).astype(np.float32))
  sd["canonical.refl.mlp.layer_out.weight"] = (
      sd["canonical.refl.mlp.layer_out.weight"] * 40.0)
  ws = k9.pack_weights(sd, "cuda", enc, spline)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                           device="cuda")
  rays, times = (torch.from_numpy(a).cuda() for a in rays_times(n, seed))
  keep = testing.dyn_kink_free_rays(ws, rays, times, ts, steps, enc, spline)
  return ws, rays, times, ts, gen, keep


@pytest.mark.cuda
@pytest.mark.parametrize("enc,spline", MODES, ids=IDS)
def test_cuda_k9f_matches_plain(enc, spline):
  ws, rays, times, ts, _, _ = _cuda_case(enc, spline, 301, 64, 1)
  for want_dp in (False, True):
    kw = dict(steps=64, ts=ts, spline_points=spline, enc_kind=enc,
              want_dp=want_dp)
    got = k9.fused_dyn_render(ws, rays, times, **kw)
    ref = k9.dyn_render_reference(ws, rays, times, **kw)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("enc,spline", MODES, ids=IDS)
@pytest.mark.parametrize("mode,dp", [("G", False), ("G", True),
                                     ("L", False), ("L", True)])
def test_cuda_k9b_matches_plain(enc, spline, mode, dp):
  """On the rays `dyn_kink_free_rays` clears, given alone: the dp² term's
  cotangent reaches every ray it is given. g is uniform in [0, 1): under
  a zero-mean g the rigidity's one-element output bias gradient is a sum
  that can fall near 0 while its rounding does not (chip_smoke's
  `_check_dyn_bwd` says more). A tensor over the gate passes only where
  float32 itself is not that precise: the plain version's own distance to
  the float64 gradient (`testing.dyn_float64_grad`) over half the gate,
  and the kernel's within twice it (`testing.float64_witness_ratio`).
  Such tensors are sums that cancel (the warp's three-element output bias
  under the posenc canonical, whose top bands turn a warped point's
  last-bit rounding into a ~1e-4 phase), and no product precision moves
  them: with every MLP product in float64, rounded once, the plain
  version lands as far from the float64 gradient
  (`test_k9b_posenc_floor_is_float32`)."""
  ws, rays, times, ts, gen, keep = _cuda_case(enc, spline, 4096, 64, 2)
  rays, times = rays[keep].contiguous(), times[keep].contiguous()
  n = rays.shape[0]
  kw = dict(steps=64, spline_points=spline, enc_kind=enc)
  if mode == "G":
    g = torch.rand(n, 5 if dp else 4, device="cuda", generator=gen)
    got = k9.fused_dyn_render_grad(ws, rays, times, g, ts=ts, want_dp=dp,
                                   **kw)
    ref = k9.dyn_render_grad_reference(ws, rays, times, g, ts=ts, want_dp=dp,
                                       **kw)
  else:
    target = torch.rand(n, 3, device="cuda", generator=gen)
    weight = 1e-3 if dp else 0.0
    loss, got = k9.fused_dyn_train_step(ws, rays, times, target, ts,
                                        dp_weight=weight, **kw)
    loss_r, ref = k9.dyn_train_step_reference(ws, rays, times, target, ts=ts,
                                              dp_weight=weight, **kw)
    assert abs(float(loss) - float(loss_r)) <= 1e-5 * abs(float(loss_r))
    again = k9.fused_dyn_train_step(ws, rays, times, target, ts,
                                    dp_weight=weight, **kw)
    assert torch.equal(again[1], got) and torch.equal(again[0], loss)
  torch.cuda.synchronize()
  ug, ur = k9.unpack_grads(got, enc, spline), k9.unpack_grads(ref, enc, spline)
  over = {}
  for key in ur:
    err = float((ug[key] - ur[key]).norm() / ur[key].norm())
    if not err <= 1e-4:
      over[key] = err
  if over:
    arg = g if mode == "G" else target
    w64 = testing.dyn_float64_grad(ws, rays, times, ts, arg,
                                   loss_mode=mode == "L",
                                   dp_weight=0.0 if mode == "G" else weight,
                                   spline_points=spline, enc_kind=enc)
    for key, err in over.items():
      ratio, _, ek, ep = testing.float64_witness_ratio(
          lambda x: {key: k9.unpack_grads(x, enc, spline)[key]}, got, ref,
          w64, 5e-5)
      assert ep > 5e-5 and ratio <= testing.WITNESS_RATIO, (key, err, ek, ep)
