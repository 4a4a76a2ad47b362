"""CoarseFineNeRF in the port: hierarchical sampling, the module, and the
per-ray-ts and weights modes of K1/K2 (ROADMAP's K6), on the CPU against
the JAX package.

- `ops/sampling.py` against `nerf_atlas_tpu/ops/sampling.py` on the same
  seeded inputs: the CDF (`pdf_cdf`) to 1e-6 abs (measured 7.2e-7: XLA
  and torch sum the 64 weights and their prefix sums in different
  orders); the inversion, given JAX's CDF and JAX's u (the
  `jax.random.uniform` draw of a key, or jnp.linspace), bit for bit, held
  at 1e-6 abs on ts in [2, 6]; `linspace_u` is jnp.linspace bit for bit;
  `merge_ts` exactly. The two CDFs are not held end to end through the
  inversion: where a bin holds little mass, or at u = 1, the inverse
  turns a round-off of the CDF into a jump (measured 0.17 at u = 1 on
  random weights), in the JAX package's own TPU and CPU forms alike.
- The port's `CoarseFineNeRF` forward and the plain
  `fused_coarse_fine_render` against JAX `CoarseFineNeRF.apply` at eval
  (cp, posenc, cone, cylinder; params carried across by
  `convert.params_from_flax`): rgb, coarse_rgb and coarse_weights 2e-4
  abs. The port takes the JAX eval grid, the JAX package's posenc bands
  (tests/test_torch_k4.py says why) and, for mip, its IPE scales: XLA's
  exp2 is one ulp off 2^13 and 2^15, and the fine pass puts samples on
  the zero-width last bin (t_far, repeated), whose segments leave those
  bands undamped, so that ulp moves a feature by 0.05 (the port's exact
  powers of two agree with a float64 evaluation).
- The plain K1 with per-ray ts [N, T] and the weights output against the
  JAX model's own `query` + `finish` on the same ts (the fine pass's
  merged ts): rgb, acc and weights 2e-4 abs.
- The plain K2 (cotangent mode) and K3 (loss mode) with per-ray ts
  against `jax.value_and_grad` through `query` + `finish` on the same
  ts: loss 1e-5 relative, each gradient tensor 1e-4 relative, with a
  zero cotangent (the render as the target) on the rays
  `testing.kink_free_rays` flags.
- `PlainCPRender` with the weights output: the weights are the plain
  K1's and take no gradient; the gradient is the plain K2's. The
  wrappers check per-ray shapes.
- A `slow` case: the plain K1 against the Pallas K1 in interpret mode
  with [N, T] ts and `want_weights` (bf16 weights), at the 2e-2 tier.
- `cuda`-marked cases: K1 with per-ray ts and weights against its plain
  version (1e-4 abs; shared and expanded ts bit for bit) and K2 per ray
  against autograd through the plain K1; run them with
  `python -m pytest --noconftest -m cuda tests/test_torch_coarse_fine.py`.
The training paths, the gates and the runner:
tests/test_torch_coarse_fine_train.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops import mip as tmip  # noqa: E402
from nerf_atlas_tpu_torch.ops import sampling  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402
from nerf_atlas_tpu_torch.train import driver  # noqa: E402

from test_torch_k4 import _jax_params, _jax_ts, _rays, amplify  # noqa: E402
from test_torch_k4 import jax_bands  # noqa: E402

STEPS = 16
FINE = 16
MODES = ["cp", "posenc", "cone", "cylinder"]


def jax_scales(monkeypatch):
  """Make the port's IPE (the modules' and the plain versions') use the
  JAX package's scales, jnp.exp2 of 0..15 on the CPU (one ulp off 2^13
  and 2^15)."""
  import jax.numpy as jnp

  def scales(min_deg, max_deg, dtype=torch.float32, device=None):
    return torch.from_numpy(np.array(jnp.exp2(jnp.arange(
        min_deg, max_deg, dtype=jnp.float32)))).to(device=device, dtype=dtype)

  monkeypatch.setattr(tmip, "ipe_scales", scales)


def jax_numerics(monkeypatch, mode):
  """The JAX package's bands (posenc) and scales (mip) in the port."""
  if mode == "posenc":
    jax_bands(monkeypatch)
  if mode in k1.MIP_KINDS:
    jax_scales(monkeypatch)


def _mip_enc(mode):
  """(mip, enc_kind) of a kernel mode's CoarseFineNeRF."""
  return (mode, "cp") if mode in k1.MIP_KINDS else (None, mode)


def jax_model(mode, steps=STEPS, fine_steps=FINE, **kw):
  from nerf_atlas_tpu import models as jmodels
  mip, enc = _mip_enc(mode)
  return jmodels.CoarseFineNeRF(steps=steps, t_near=2.0, t_far=6.0,
                                fine_steps=fine_steps, enc_kind=enc, mip=mip,
                                **kw)


def port_model(mode, steps=STEPS, fine_steps=FINE, **kw):
  mip, enc = _mip_enc(mode)
  return models.CoarseFineNeRF(steps=steps, fine_steps=fine_steps,
                               enc_kind=enc, mip=mip, **kw)


def jax_pass(m, rays, ts):
  """One pass of the JAX CoarseFineNeRF `m` (bound) on ts [T] or [N, T]
  at eval: `query` + `finish`, as its __call__ runs each pass."""
  import jax.numpy as jnp
  from nerf_atlas_tpu.models.base import view_per_sample
  r_o, r_d = rays[..., :3], rays[..., 3:]
  if ts.ndim == 1:
    ts = jnp.broadcast_to(ts, r_o.shape[:-1] + ts.shape)
  pts = r_o[..., None, :] + ts[..., :, None] * r_d[..., None, :]
  density, rgb = m.query(pts, view=view_per_sample(r_d, ts.shape[-1]),
                         mip_feats=m.mip_encode(r_o, r_d, ts))
  return m.finish(density, rgb, ts, r_d, False)


# ---------------------------------------------------------------------------
# ops/sampling.py
# ---------------------------------------------------------------------------

def _pdf_inputs(n=256, steps=64, seed=0):
  """Sorted z in [2, 6] and weights: most bins empty, some rays with a
  heavy last bin (the 1e10 tail that takes a sky ray's leftover
  transmittance)."""
  rng = np.random.default_rng(seed)
  z = np.sort(rng.uniform(2.0, 6.0, (n, steps)), -1).astype(np.float32)
  w = rng.exponential(size=(n, steps)) * (rng.uniform(size=(n, steps)) < 0.3)
  w[::3, -1] += 5.0
  return z, w.astype(np.float32)


def _jax_cdf(w):
  """The CDF the JAX package's `sample_pdf` builds on the CPU."""
  import jax.numpy as jnp
  w = jnp.asarray(w) + 1e-5
  cdf = jnp.cumsum(w / jnp.sum(w, axis=-1, keepdims=True), axis=-1)
  return np.array(jnp.concatenate([jnp.zeros_like(cdf[..., :1]), cdf], -1))


@pytest.mark.parametrize("n", [2, 16, 64, 128])
def test_linspace_u_is_jnp_linspace(n):
  import jax.numpy as jnp
  np.testing.assert_array_equal(
      sampling.linspace_u(n).numpy(),
      np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))
  assert sampling.linspace_u(n, (3,)).shape == (3, n)


def test_pdf_cdf_matches_jax():
  _, w = _pdf_inputs()
  cdf = sampling.pdf_cdf(torch.from_numpy(w)).numpy()
  assert cdf.shape == (256, 65) and np.all(cdf[:, 0] == 0)
  np.testing.assert_allclose(cdf, _jax_cdf(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("key", [None, 3])
def test_inverse_cdf_matches_jax(key):
  """Given JAX's CDF and u, the inversion is JAX's: u from a key (the
  draw `jax.random.uniform(key, [N, 64])` the JAX function makes) or, at
  key None, linspace."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import sampling as jsampling
  z, w = _pdf_inputs()
  jkey = None if key is None else jax.random.PRNGKey(key)
  ref = np.asarray(jsampling.sample_pdf(jnp.asarray(z), jnp.asarray(w), N=64,
                                        key=jkey))
  if key is None:
    u = sampling.linspace_u(64, (256,))
  else:
    u = torch.from_numpy(np.array(jax.random.uniform(jkey, (256, 64),
                                                     dtype=jnp.float32)))
  got = sampling.invert_cdf(torch.from_numpy(z),
                            torch.from_numpy(_jax_cdf(w)), u).numpy()
  assert got.shape == (256, 64)
  assert np.all(np.diff(got, axis=-1) >= 0)
  assert got.min() >= 2.0 and got.max() <= 6.0
  np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_merge_ts_matches_jax():
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import sampling as jsampling
  z, w = _pdf_inputs(seed=1)
  fine = np.asarray(jsampling.sample_pdf(jnp.asarray(z), jnp.asarray(w),
                                         N=64))
  for coarse in (z, z[0]):                    # per-ray and shared
    ref = np.asarray(jsampling.merge_ts(jnp.asarray(coarse),
                                        jnp.asarray(fine)))
    got = sampling.merge_ts(torch.from_numpy(coarse),
                            torch.from_numpy(fine)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sample_pdf_draws_u_from_its_generator():
  z, w = (torch.from_numpy(a) for a in _pdf_inputs(n=8, seed=2))
  got = sampling.sample_pdf(z, w, 32, generator=torch.Generator()
                            .manual_seed(4))
  u = sampling.uniform_u((8,), 32, torch.Generator().manual_seed(4))
  assert torch.equal(got, sampling.invert_cdf(z, sampling.pdf_cdf(w), u))
  assert torch.equal(sampling.sample_pdf(z, w, 32), sampling.invert_cdf(
      z, sampling.pdf_cdf(w), sampling.linspace_u(32, (8,))))


# ---------------------------------------------------------------------------
# the module and the plain hierarchical render
# ---------------------------------------------------------------------------

CASES = [("black", "thin", False), ("white", "normal", True)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sky_kind,sigmoid_kind,amp", CASES)
def test_module_and_plain_render_match_jax(mode, sky_kind, sigmoid_kind, amp,
                                           monkeypatch):
  import jax.numpy as jnp
  from nerf_atlas_tpu_torch.ops import rays as trays
  jax_numerics(monkeypatch, mode)
  rays = _rays()
  model = jax_model(mode, sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  tree = _jax_params(model, rays)
  if amp:
    tree = amplify(tree, "cone")
  out_j = {k: np.asarray(v) for k, v in model.apply(tree, jnp.asarray(rays))
           .items()}
  sd = convert.params_from_flax(tree)
  tr, ts = torch.from_numpy(rays), _jax_ts()
  monkeypatch.setattr(trays, "compute_ts", lambda *a, **k: ts)
  port = port_model(mode, sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  port.load_state_dict(sd)
  with torch.no_grad():
    out = port(tr)
  for key in ("rgb", "coarse_rgb", "coarse_weights"):
    np.testing.assert_allclose(out[key].numpy(), out_j[key], atol=2e-4,
                               rtol=0, err_msg=key)
  assert out["weights"].shape == (48, STEPS + FINE)
  monkeypatch.setattr(k1, "sample_grid", _jax_grid(k1.sample_grid, ts))
  fused = k1.fused_coarse_fine_render(
      sd, tr, enc_kind=mode, steps=STEPS, fine_steps=FINE,
      sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
  np.testing.assert_allclose(fused[:, :3].numpy(), out_j["rgb"], atol=2e-4,
                             rtol=0)
  if amp:
    assert out_j["rgb"].std() > 0.03


def _jax_grid(inner, ts):
  """`sample_grid` with the JAX eval grid in place of torch.linspace."""
  def grid(steps, t_near, t_far, device=None, ts_=None, n_rays=None):
    if ts_ is None and steps == ts.shape[0]:
      ts_ = ts
    return inner(steps, t_near, t_far, device, ts_, n_rays)
  return grid


def test_class_defaults_are_the_jax_class_defaults():
  """CoarseFineNeRF's own default encoder is hash, as in JAX (the runner
  passes --enc-kind, cp by default: tests/test_torch_coarse_fine_train.py
  pins that); its tree carries across from flax."""
  model = models.CoarseFineNeRF()
  assert (model.enc_kind, model.fine_steps, model.refl_kind) == ("hash", 64,
                                                                  "view")
  assert "density_mlp.enc.table" in model.state_dict()
  assert models.load_model("coarse_fine", enc_kind="cp").enc_kind == "cp"
  rays = _rays(8)
  for mode in MODES:
    tree = _jax_params(jax_model(mode), rays)
    sd = convert.params_from_flax(tree)
    assert set(sd) == set(port_model(mode).state_dict())
    assert set(sd) == set(models.PlainNeRF(
        mip=_mip_enc(mode)[0], enc_kind=_mip_enc(mode)[1]).state_dict())
    assert k1.pack_weights(sd, enc_kind=mode).shape == (
        k1.LAYOUTS[mode].weight_count,)
  with pytest.raises(NotImplementedError):
    models.CoarseFineNeRF(enc_kind="ref-hash")


# ---------------------------------------------------------------------------
# the plain K1 / K2 / K3 with per-ray ts
# ---------------------------------------------------------------------------

def _merged_ts(model, tree, rays):
  """The fine pass's per-ray ts [N, STEPS + FINE] of the JAX model."""
  import jax.numpy as jnp
  return torch.from_numpy(np.asarray(model.apply(tree, jnp.asarray(rays))
                                     ["ts"]))


@pytest.mark.parametrize("mode", MODES)
def test_plain_k1_per_ray_matches_jax_query(mode, monkeypatch):
  import jax.numpy as jnp
  jax_numerics(monkeypatch, mode)
  rays = _rays(seed=2)
  model = jax_model(mode, sky_kind="white", sigmoid_kind="normal")
  tree = amplify(_jax_params(model, rays), "cone")
  ts = _merged_ts(model, tree, rays)
  assert ts.shape == (48, STEPS + FINE)
  ref = model.apply(tree, jnp.asarray(rays), jnp.asarray(ts.numpy()),
                    method=jax_pass)
  out, w = k1.plain_cp_render_reference(
      convert.params_from_flax(tree), torch.from_numpy(rays),
      steps=STEPS + FINE, ts=ts, sky_kind="white", sigmoid_kind="normal",
      enc_kind=mode, want_weights=True)
  np.testing.assert_allclose(out[:, :3].numpy(), np.asarray(ref["rgb"]),
                             atol=2e-4, rtol=0)
  np.testing.assert_allclose(out[:, 3].numpy(),
                             np.asarray(ref["weights"]).sum(-1), atol=2e-4,
                             rtol=0)
  np.testing.assert_allclose(w.numpy(), np.asarray(ref["weights"]),
                             atol=2e-4, rtol=0)


def _jax_value_and_grads(model, tree, rays, ts, target=None, g=None):
  import jax
  import jax.numpy as jnp

  def fn(p):
    out = model.apply(p, jnp.asarray(rays), jnp.asarray(ts), method=jax_pass)
    if target is not None:
      return jnp.mean((out["rgb"] - jnp.asarray(target)) ** 2)
    full = jnp.concatenate([out["rgb"], out["weights"].sum(-1)[:, None]], -1)
    return jnp.sum(full * jnp.asarray(g))

  with jax.default_matmul_precision("highest"):
    value, grads = jax.value_and_grad(fn)(jax.tree.map(jnp.asarray, tree))
  return float(value), {k: v.numpy() for k, v in convert.params_from_flax(
      jax.tree.map(np.asarray, grads)).items()}


def _assert_grads(packed, ref, rtol=1e-4):
  ours = {k: v.numpy() for k, v in k1.unpack_grads(packed).items()}
  assert set(ours) == set(ref)
  for key, r in ref.items():
    err = np.linalg.norm(ours[key] - r) / max(np.linalg.norm(r), 1e-30)
    assert err <= rtol, (key, err)


@pytest.mark.parametrize("mode", MODES)
def test_plain_k3_and_k2_per_ray_match_jax(mode, monkeypatch):
  jax_numerics(monkeypatch, mode)
  rays = _rays(seed=3)
  model = jax_model(mode, sky_kind="white", sigmoid_kind="normal")
  tree = amplify(_jax_params(model, rays), "cone")
  ts = _merged_ts(model, tree, rays)
  sd = convert.params_from_flax(tree)
  tr, n = torch.from_numpy(rays), rays.shape[0]
  kw = dict(steps=STEPS + FINE, sky_kind="white", sigmoid_kind="normal",
            ts=ts, enc_kind=mode)
  keep = testing.kink_free_rays(sd, tr, ts, STEPS + FINE,
                                enc_kind=mode).numpy()
  assert keep.sum() >= n // 2
  rng = np.random.default_rng(4)
  out = k1.plain_cp_render_reference(sd, tr, **kw)[:, :3].numpy()
  target = np.where(keep[:, None], rng.uniform(size=(n, 3)), out).astype(
      np.float32)
  g = (rng.normal(size=(n, 4)) * keep[:, None]).astype(np.float32)
  loss_j, grads_j = _jax_value_and_grads(model, tree, rays, ts.numpy(),
                                         target=target)
  loss, dws = k1.plain_cp_train_step(sd, tr, torch.from_numpy(target), **kw)
  assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
  _assert_grads(dws, grads_j)
  _, grads_j = _jax_value_and_grads(model, tree, rays, ts.numpy(), g=g)
  _assert_grads(k1.plain_cp_render_grad(sd, tr, torch.from_numpy(g), **kw),
                grads_j)


@pytest.mark.parametrize("mode", MODES)
def test_weights_output_and_per_ray_shapes(mode):
  """PlainCPRender's weights output is the plain K1's, takes no
  gradient, and leaves the gradient the plain K2's; the wrappers on CPU
  rays launch nothing; per-ray ts of the wrong shape raise."""
  model = driver.init_model(port_model(mode, sky_kind="white"), seed=3)
  ws = k1.pack_weights(model.state_dict(), enc_kind=mode)
  rays = torch.from_numpy(_rays(12, 4))
  gen = torch.Generator().manual_seed(0)
  ts = torch.sort(torch.rand(12, STEPS, generator=gen) * 4 + 2, -1).values
  kw = dict(steps=STEPS, sky_kind="white", enc_kind=mode)
  launches = k1.plain_cp_render.launches, k1.plain_cp_render_grad.launches
  out, w = k1.plain_cp_render(ws, rays, ts=ts, want_weights=True, **kw)
  ref, w_ref = k1.plain_cp_render_reference(ws, rays, ts=ts, want_weights=True,
                                            **kw)
  assert torch.equal(out, ref) and torch.equal(w, w_ref)
  assert torch.equal(out[:, 3], w.sum(-1))
  assert torch.equal(out, k1.plain_cp_render(ws, rays, ts=ts, **kw))
  for i in (0, 7):                              # a ray's own row
    one = k1.plain_cp_render_reference(ws, rays[i:i + 1], ts=ts[i], **kw)
    torch.testing.assert_close(one, ref[i:i + 1], rtol=0, atol=1e-6)
  leaf = ws.clone().requires_grad_(True)
  o, wt = k1.plain_cp_render_train(leaf, rays, ts, want_weights=True, **kw)
  assert o.requires_grad and not wt.requires_grad
  assert torch.equal(wt, w_ref)
  g = torch.randn(12, 4, generator=gen)
  (o * g).sum().backward()
  torch.testing.assert_close(leaf.grad, k1.plain_cp_render_grad(
      ws, rays, g, ts=ts, **kw), rtol=1e-6, atol=1e-9)
  assert (k1.plain_cp_render.launches,
          k1.plain_cp_render_grad.launches) == launches
  with pytest.raises(ValueError, match="ts must be"):
    k1.plain_cp_render(ws, rays, ts=ts[:5], **kw)
  with pytest.raises(ValueError, match="ts must be"):
    k1.plain_cp_render(ws, rays, ts=ts[:, :-1], **kw)
  with pytest.raises(ValueError, match="ts must be"):     # other kernels
    k1.sample_grid(STEPS, 2.0, 6.0, "cpu", ts)
  np.testing.assert_array_equal(
      k1.hash_pts(rays, ts).view(12, STEPS, 3).numpy(),
      (rays[:, None, :3] + ts[..., None] * rays[:, None, 3:6]).numpy())


def test_coarse_fine_render_is_two_passes():
  """`fused_coarse_fine_render` = K1 with weights on the grid, the
  linspace inversion, K1 on the merged per-ray ts; the train entry point
  returns (fine, coarse) through PlainCPRender, u from its generator."""
  model = driver.init_model(port_model("cone", sky_kind="white"), seed=1)
  ws = k1.pack_weights(model.state_dict(), enc_kind="cone")
  rays = torch.from_numpy(_rays(10, 5))
  kw = dict(sky_kind="white", enc_kind="cone")
  out_c, w_c = k1.plain_cp_render(ws, rays, steps=STEPS, want_weights=True,
                                  **kw)
  grid = torch.linspace(2.0, 6.0, STEPS).expand(10, STEPS)
  all_ts = sampling.merge_ts(grid, sampling.sample_pdf(grid, w_c, FINE))
  fine = k1.plain_cp_render(ws, rays, steps=STEPS + FINE,
                            ts=all_ts.contiguous(), **kw)
  assert torch.equal(k1.fused_coarse_fine_render(
      ws, rays, steps=STEPS, fine_steps=FINE, **kw), fine)
  leaf = ws.clone().requires_grad_(True)
  f, c = k1.fused_coarse_fine_train(leaf, rays, None,
                                    torch.Generator().manual_seed(2),
                                    steps=STEPS, fine_steps=FINE, **kw)
  assert torch.equal(c, out_c) and f.shape == (10, 4) and f.requires_grad
  (f.sum() + c.sum()).backward()
  assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().sum() > 0
  with pytest.raises(ValueError, match="coarse_fine"):
    k1.fused_coarse_fine_render(ws, rays, enc_kind="tiny")


@pytest.mark.slow
@pytest.mark.parametrize("mode", MODES)
def test_plain_k1_per_ray_matches_pallas_interpret(mode):
  """The plain K1 with per-ray ts and weights against the Pallas K1
  (`_forward_call` in interpret mode, [N, T] ts, want_weights, bf16
  weights): 2e-2, the tier tests/test_pallas_render.py holds the Pallas
  kernel to."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops.math import dir_to_elev_azim
  from nerf_atlas_tpu.ops.pallas import render as pr
  rays = _rays(64)
  model = jax_model(mode, sky_kind="white")
  tree = _jax_params(model, rays)
  ts = _merged_ts(model, tree, rays)
  steps = STEPS + FINE
  ws = tuple(pr._flatten_params(jax.tree.map(jnp.asarray, tree),
                                enc_kind=mode))
  ws = tuple(w.astype(jnp.bfloat16) if w.ndim >= 2 and w.shape[0] > 1 else w
             for w in ws)
  jr, jt = jnp.asarray(rays), jnp.asarray(ts.numpy())
  out, w = pr._forward_call(ws, jr, dir_to_elev_azim(jr[:, 3:6]), jt,
                            pr._dists_base(jt), steps=steps, block_rays=32,
                            interpret=True, sky_white=True, enc_kind=mode,
                            want_weights=True)
  ref, w_ref = k1.plain_cp_render_reference(
      convert.params_from_flax(tree), torch.from_numpy(rays), steps=steps,
      ts=ts, sky_kind="white", enc_kind=mode, want_weights=True)
  np.testing.assert_allclose(ref.numpy(), np.asarray(out), atol=2e-2)
  np.testing.assert_allclose(w_ref.numpy(), np.asarray(w), atol=2e-2)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

def _cuda_case(mode, n, steps, seed):
  """Seeded weights (rgb ×8), rays and per-ray ts: the merged ts of a
  coarse pass (K1 with weights) on the card."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run K1/K2")
  torch.backends.cuda.matmul.allow_tf32 = False
  model = driver.init_model(port_model(mode, steps=steps // 2,
                                       fine_steps=steps // 2,
                                       sky_kind="white"), seed=seed)
  sd = dict(model.state_dict())
  sd["refl.mlp.layer_out.weight"] = sd["refl.mlp.layer_out.weight"] * 8.0
  ws = k1.pack_weights(sd, "cuda", mode)
  rays = torch.from_numpy(_rays(n, seed)).cuda()
  _, w_c = k1.plain_cp_render(ws, rays, steps=steps // 2, sky_kind="white",
                              enc_kind=mode, want_weights=True)
  grid = torch.linspace(2.0, 6.0, steps // 2, device="cuda").expand(
      n, steps // 2)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  ts = sampling.merge_ts(grid, sampling.sample_pdf(
      grid, w_c, steps // 2, generator=gen)).contiguous()
  return ws, rays, ts, gen, dict(steps=steps, sky_kind="white", ts=ts,
                                 enc_kind=mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("steps,n", [(128, 1001), (16, 77)])
def test_cuda_k1_per_ray_matches_plain(mode, steps, n):
  """K1 with per-ray ts and weights vs its plain version on the card:
  1e-4 abs on rgb, acc and weights; a shared ts and the same ts expanded
  to [N, T] give the same bits."""
  ws, rays, ts, _, kw = _cuda_case(mode, n, steps, 1)
  before = k1.plain_cp_render.launches
  out, w = k1.plain_cp_render(ws, rays, want_weights=True, **kw)
  torch.cuda.synchronize()
  assert k1.plain_cp_render.launches == before + 1
  ref, w_ref = k1.plain_cp_render_reference(ws, rays, want_weights=True, **kw)
  assert float((out - ref).abs().max()) < 1e-4
  assert float((w - w_ref).abs().max()) < 1e-4
  shared = dict(kw, ts=ts[0].contiguous())
  a = k1.plain_cp_render(ws, rays, want_weights=True, **shared)
  b = k1.plain_cp_render(ws, rays, want_weights=True, **dict(
      kw, ts=ts[0].expand(n, steps).contiguous()))
  assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
  assert torch.equal(a[0], k1.plain_cp_render(ws, rays, **shared))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("steps,n", [(128, 300), (16, 77)])
def test_cuda_k2_per_ray_matches_plain(mode, steps, n):
  """K2 (and K3) with per-ray ts vs autograd through the plain K1: loss
  1e-5 relative, each gradient tensor 1e-4 relative with a zero
  cotangent on the rays near a leaky-relu kink; two launches bit for
  bit."""
  ws, rays, ts, gen, kw = _cuda_case(mode, n, steps, 2)
  keep = testing.kink_free_rays(ws, rays, ts, steps, enc_kind=mode)
  g = torch.randn(n, 4, device="cuda", generator=gen) * keep[:, None]
  dws = k1.plain_cp_render_grad(ws, rays, g, **kw)
  dws_r = k1.plain_cp_render_grad_reference(ws, rays, g, **kw)
  ug, ur = k1.unpack_grads(dws), k1.unpack_grads(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
  assert torch.equal(dws, k1.plain_cp_render_grad(ws, rays, g, **kw))
  out = k1.plain_cp_render_reference(ws, rays, **kw)[:, :3]
  target = torch.where(keep[:, None], torch.rand(n, 3, device="cuda",
                                                 generator=gen), out)
  loss, dws = k1.plain_cp_train_step(ws, rays, target.contiguous(), **kw)
  loss_r, dws_r = k1.plain_cp_train_step_reference(ws, rays,
                                                   target.contiguous(), **kw)
  assert abs(float(loss) - float(loss_r)) <= 1e-5 * float(loss_r)
  ug, ur = k1.unpack_grads(dws), k1.unpack_grads(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
