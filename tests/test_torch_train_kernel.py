"""K2/K3 (the backward of the fused PlainNeRF-CP render, and its loss
mode) in the port.

- The plain K2 (`plain_cp_render_grad` on CPU rays: autograd through the
  plain K1) and the plain K3 (`plain_cp_train_step`) at full width, 16
  steps, 64 rays, against the JAX oracle: `jax.value_and_grad` of
  Σ g·[rgb ‖ acc] and of mean((rgb − target)²) through `PlainNeRF.apply`
  on the eval grid, with matmul precision "highest", over the sky and
  rgb-activation cases of tests/test_torch_render.py. Tolerances: loss
  relative 1e-5, per-tensor ‖Δ‖/‖g_jax‖ 1e-4. Measured gap: loss ≤ 4e-7
  relative, gradients ≤ 2e-5 (the float32 summation order; at this size
  no leaky-relu pre-activation sits within round-off of its kink).
- `PlainCPRender` on the CPU equals its plain version; `unpack_grads`
  round-trips.
- A slow case against the Pallas kernels themselves in interpret mode
  (`fused_plain_cp_train_step`, `fused_plain_cp_render_train`) on a
  jittered ts, held as tests/test_pallas_render.py holds those kernels to
  the float32 oracle (their bf16 tier): every tensor's cosine > 0.98
  (per-tensor magnitude error on a small-norm tensor is bf16 noise: 0.065
  on a CP line table here) and a global relative Frobenius error < 5%
  (the recorded bf16 floor of these kernels is 0.026–0.041,
  BENCH_NOTES.md:164-166, :211-214; measured here 0.035 with the plain
  rgb loss, whose density-path gradient is small at a random init), the
  loss to 1e-2.
- `cuda`-marked cases: the kernels against their plain versions on the
  card; skipped without one (run them with
  `python -m pytest --noconftest -m cuda tests/test_torch_train_kernel.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402

STEPS = 16
N = 64
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
CASES = [("black", "thin", False), ("black", "thin", True),
         ("white", "normal", True), ("random", "tanh", True),
         ("white", "fat", True), ("black", "leaky_relu", True)]


def _rays(n=N, seed=0):
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(size=(n, 3)) * 0.1
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


def _amplify(tree):
  p = tree["params"]
  p["refl"]["mlp"]["layer_out"]["kernel"] = (
      p["refl"]["mlp"]["layer_out"]["kernel"] * 40.0)
  p["density_mlp"]["layer_out"]["kernel"] = (
      p["density_mlp"]["layer_out"]["kernel"] * 8.0)
  for li in range(4):
    p["density_mlp"]["enc"][f"lines_{li}"] = (
        p["density_mlp"]["enc"][f"lines_{li}"] * 4.0)
  return tree


def _jax_model(sky_kind, sigmoid_kind, rays, amplify):
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  model = jmodels.PlainNeRF(steps=STEPS, t_near=2.0, t_far=6.0,
                            sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  params = model.init({"params": jax.random.PRNGKey(0),
                       "sampler": jax.random.PRNGKey(1)},
                      jnp.asarray(rays), train=True)
  tree = jax.tree.map(np.asarray, params)
  return model, (_amplify(tree) if amplify else tree)


def _jax_grads(model, tree, rays, g=None, target=None):
  """(value, {state_dict key: numpy grad}) of Σ g·out or the l2 loss."""
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


def _assert_grads(packed, ref, rtol):
  ours = {k: v.numpy() for k, v in k1.unpack_grads(packed).items()}
  assert set(ours) == set(ref)
  for key, r in ref.items():
    err = np.linalg.norm(ours[key] - r) / max(np.linalg.norm(r), 1e-30)
    assert err <= rtol, (key, err)


@pytest.mark.parametrize("sky_kind,sigmoid_kind,amplify", CASES)
def test_plain_k3_matches_jax_value_and_grad(sky_kind, sigmoid_kind,
                                             amplify):
  rays = _rays()
  model, tree = _jax_model(sky_kind, sigmoid_kind, rays, amplify)
  target = np.random.default_rng(1).uniform(size=(N, 3)).astype(np.float32)
  loss_j, grads_j = _jax_grads(model, tree, rays, target=target)
  loss, grad = k1.plain_cp_train_step(
      convert.params_from_flax(tree), torch.from_numpy(rays),
      torch.from_numpy(target), steps=STEPS, sigmoid_kind=sigmoid_kind,
      sky_kind=sky_kind)
  assert abs(float(loss) - loss_j) <= LOSS_RTOL * abs(loss_j)
  _assert_grads(grad, grads_j, GRAD_RTOL)


@pytest.mark.parametrize("sky_kind,sigmoid_kind,amplify", CASES)
def test_plain_k2_matches_jax_vjp(sky_kind, sigmoid_kind, amplify):
  rays = _rays(seed=2)
  model, tree = _jax_model(sky_kind, sigmoid_kind, rays, amplify)
  g = np.random.default_rng(3).normal(size=(N, 4)).astype(np.float32)
  _, grads_j = _jax_grads(model, tree, rays, g=g)
  grad = k1.plain_cp_render_grad(
      convert.params_from_flax(tree), torch.from_numpy(rays),
      torch.from_numpy(g), steps=STEPS, sigmoid_kind=sigmoid_kind,
      sky_kind=sky_kind)
  _assert_grads(grad, grads_j, GRAD_RTOL)


def _seeded_ws(seed=0, **kw):
  from nerf_atlas_tpu_torch import models
  from nerf_atlas_tpu_torch.train import driver
  model = driver.init_model(models.PlainNeRF(steps=STEPS, **kw), seed=seed)
  return model, k1.pack_weights(model.state_dict())


def test_plain_cp_render_function_on_cpu_is_the_plain_version():
  _, ws = _seeded_ws()
  rays = torch.from_numpy(_rays(40))
  ts = torch.sort(torch.rand(STEPS, generator=torch.Generator()
                             .manual_seed(0)) * 4 + 2).values
  g = torch.randn(40, 4, generator=torch.Generator().manual_seed(1))
  leaf = ws.clone().requires_grad_(True)
  out = k1.plain_cp_render_train(leaf, rays, ts, steps=STEPS,
                                 sky_kind="white")
  (out * g).sum().backward()
  ref = k1.plain_cp_render_reference(ws, rays, steps=STEPS, ts=ts,
                                     sky_kind="white")
  ref_grad = k1.plain_cp_render_grad_reference(ws, rays, g, steps=STEPS,
                                               ts=ts, sky_kind="white")
  assert torch.equal(out.detach(), ref)
  torch.testing.assert_close(leaf.grad, ref_grad, rtol=1e-6, atol=1e-9)
  before = (k1.plain_cp_render_grad.launches,
            k1.plain_cp_train_step.launches)
  k1.plain_cp_train_step(ws, rays, torch.rand(40, 3), steps=STEPS, ts=ts)
  assert (k1.plain_cp_render_grad.launches,
          k1.plain_cp_train_step.launches) == before   # no kernel on CPU


def test_unpack_grads_round_trips():
  model, ws = _seeded_ws(seed=3)
  sd = model.state_dict()
  unpacked = k1.unpack_grads(ws)
  assert set(unpacked) == set(sd)
  for key, v in sd.items():
    assert torch.equal(unpacked[key], v), key
  assert torch.equal(k1.pack_weights(unpacked), ws)


def test_kink_free_rays_follows_its_margin():
  _, ws = _seeded_ws()
  rays = torch.from_numpy(_rays(16))
  ts = torch.linspace(2.0, 6.0, STEPS)
  keep = testing.kink_free_rays(ws, rays, ts, STEPS)
  assert keep.shape == (16,) and keep.dtype == torch.bool
  assert bool(testing.kink_free_rays(ws, rays, ts, STEPS, margin=0.0).all())
  assert not bool(testing.kink_free_rays(ws, rays, ts, STEPS,
                                        margin=1e30).any())


def test_k2_k3_wrappers_reject_bad_inputs():
  _, ws = _seeded_ws()
  rays = torch.from_numpy(_rays(8))
  with pytest.raises(ValueError):
    k1.plain_cp_render_grad(ws, rays.to("meta"), torch.zeros(8, 4),
                            steps=STEPS)
  with pytest.raises(ValueError):   # ts of the wrong length
    k1.plain_cp_train_step(ws, rays, torch.zeros(8, 3), steps=STEPS,
                           ts=torch.linspace(2, 6, STEPS + 1))
  with pytest.raises(NotImplementedError):
    k1.plain_cp_train_step(ws, rays, torch.zeros(8, 3), steps=STEPS,
                           sigmoid_kind="softmax")


@pytest.mark.slow
def test_plain_k2_k3_match_pallas_kernels_interpret():
  """Against the Pallas kernels themselves (bf16 matmuls, interpret mode)
  on a jittered shared ts, at their bf16 tier."""
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops.pallas.render import (fused_plain_cp_render_train,
                                                fused_plain_cp_train_step)
  rays = _rays()
  _, tree = _jax_model("white", "thin", rays, amplify=False)
  rng = np.random.default_rng(4)
  ts = np.sort(rng.uniform(2.0, 6.0, STEPS)).astype(np.float32)
  target = rng.uniform(size=(N, 3)).astype(np.float32)
  g = rng.normal(size=(N, 4)).astype(np.float32)
  params = jax.tree.map(jnp.asarray, tree)
  kw = dict(steps=STEPS, sky_kind="white", interpret=True)
  loss_p, grads_p = fused_plain_cp_train_step(
      params, jnp.asarray(rays), jnp.asarray(target), jnp.asarray(ts)[None],
      **kw)
  vjp_p = jax.grad(lambda p: jnp.sum(fused_plain_cp_render_train(
      p, jnp.asarray(rays), jnp.asarray(ts)[None], block_rays=32,
      bwd_block_rays=16, **kw) * jnp.asarray(g)))(params)
  sd = convert.params_from_flax(tree)
  kt = dict(steps=STEPS, sky_kind="white", ts=torch.from_numpy(ts))
  loss, grad = k1.plain_cp_train_step(sd, torch.from_numpy(rays),
                                      torch.from_numpy(target), **kt)
  grad2 = k1.plain_cp_render_grad(sd, torch.from_numpy(rays),
                                  torch.from_numpy(g), **kt)
  assert abs(float(loss) - float(loss_p)) <= 1e-2 * abs(float(loss_p))
  for ours, pallas in ((grad, grads_p), (grad2, vjp_p)):
    ref = {k: v.numpy().astype(np.float64) for k, v in
           convert.params_from_flax(jax.tree.map(np.asarray, pallas)).items()}
    got = {k: v.numpy().astype(np.float64)
           for k, v in k1.unpack_grads(ours).items()}
    num = sum(np.sum((got[k] - r) ** 2) for k, r in ref.items())
    den = sum(np.sum(r ** 2) for r in ref.values())
    assert np.sqrt(num / den) < 0.05
    for k, r in ref.items():
      cos = np.sum(got[k] * r) / (np.linalg.norm(got[k]) * np.linalg.norm(r))
      assert cos > 0.98, (k, cos)


def _cuda_case(steps, n, sky, kind, seed):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run K2/K3")
  torch.backends.cuda.matmul.allow_tf32 = False
  _, ws = _seeded_ws(seed=seed, sky_kind=sky)
  ws = ws.cuda()
  gen = torch.Generator(device="cuda").manual_seed(seed)
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                           device="cuda")
  rays = torch.from_numpy(_rays(n, seed)).cuda()
  return ws, rays, ts, gen, dict(steps=steps, sky_kind=sky,
                                 sigmoid_kind=kind, ts=ts)


def _rel(a, b):
  ua, ub = k1.unpack_grads(a), k1.unpack_grads(b)
  return max(float((ua[k] - ub[k]).norm() / ub[k].norm()) for k in ub)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n,sky,kind", [(16, 77, "white", "thin"),
                                              (16, 1001, "black", "tanh"),
                                              (100, 33, "white", "normal")])
def test_cuda_k3_matches_plain(steps, n, sky, kind):
  """K3 vs the plain K3 on the card: loss 1e-5 relative over all rays;
  each gradient tensor 1e-4 relative (float32 both sides, summation
  order differs) with the rays near a leaky-relu kink held at their
  rendered colour, i.e. a zero cotangent (`kink_free_rays`)."""
  ws, rays, ts, gen, kw = _cuda_case(steps, n, sky, kind, 5)
  target = torch.rand(n, 3, device="cuda", generator=gen)
  before = k1.plain_cp_train_step.launches
  loss, _ = k1.plain_cp_train_step(ws, rays, target, **kw)
  torch.cuda.synchronize()
  assert k1.plain_cp_train_step.launches == before + 1
  loss_r, _ = k1.plain_cp_train_step_reference(ws, rays, target, **kw)
  assert abs(float(loss) - float(loss_r)) <= 1e-5 * float(loss_r)
  keep = testing.kink_free_rays(ws, rays, ts, steps)
  out = k1.plain_cp_render_reference(ws, rays, **kw)[:, :3]
  target = torch.where(keep[:, None], target, out).contiguous()
  grad = k1.plain_cp_train_step(ws, rays, target, **kw)[1]
  grad_r = k1.plain_cp_train_step_reference(ws, rays, target, **kw)[1]
  assert _rel(grad, grad_r) <= 1e-4
  again = k1.plain_cp_train_step(ws, rays, target, **kw)[1]
  assert torch.equal(grad, again)                  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n", [(16, 77), (64, 9)])
def test_cuda_k2_matches_plain(steps, n):
  """K2 vs the plain K2, each gradient tensor 1e-4 relative, with a zero
  cotangent on the rays near a leaky-relu kink (`kink_free_rays`)."""
  ws, rays, ts, gen, kw = _cuda_case(steps, n, "white", "thin", 6)
  g = torch.randn(n, 4, device="cuda", generator=gen)
  g = g * testing.kink_free_rays(ws, rays, ts, steps)[:, None]
  grad = k1.plain_cp_render_grad(ws, rays, g, **kw)
  grad_r = k1.plain_cp_render_grad_reference(ws, rays, g, **kw)
  assert _rel(grad, grad_r) <= 1e-4
