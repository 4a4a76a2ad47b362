"""K1 (the fused PlainNeRF-CP forward render) in the port.

- `plain_cp_render_reference` and the port's `PlainNeRF` at full width
  against the JAX `PlainNeRF.apply` oracle: the oracle the Pallas kernel
  itself is held to (tests/test_pallas_render.py). Both sides run in
  float32 (JAX at matmul precision "highest"); the measured gap is ~3e-7,
  so atol 2e-4 on rgb and acc leaves room for summation order while still
  catching any wiring error (those move rgb by >= 1e-3 here).
- A slow case against the Pallas kernel itself in interpret mode, at its
  bf16 tier (atol 2e-2, the tier test_pallas_render.py uses).
- The CUDA kernel against the reference on the card; skipped without one
  (run it on a GPU machine with
  `python -m pytest --noconftest -m cuda tests/test_torch_render.py`).

JAX is imported inside the tests that use it, so that the CUDA test runs
where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models as tmodels  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402

STEPS = 16
ATOL = 2e-4


def _rays(n=64, seed=0):
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(size=(n, 3)) * 0.1
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


def _amplify(tree):
  """Scale the output layers and CP lines so rgb spans (0, 1) and density
  varies along rays (a random init renders near-constant grey)."""
  p = tree["params"]
  p["refl"]["mlp"]["layer_out"]["kernel"] = (
      p["refl"]["mlp"]["layer_out"]["kernel"] * 40.0)
  p["density_mlp"]["layer_out"]["kernel"] = (
      p["density_mlp"]["layer_out"]["kernel"] * 8.0)
  for li in range(4):
    p["density_mlp"]["enc"][f"lines_{li}"] = (
        p["density_mlp"]["enc"][f"lines_{li}"] * 4.0)
  return tree


def _jax_oracle(sky_kind, sigmoid_kind, rays, amplify):
  """(numpy params tree, oracle rgb [N, 3], oracle acc [N]) from the JAX
  PlainNeRF at full width."""
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  model = jmodels.PlainNeRF(steps=STEPS, t_near=2.0, t_far=6.0,
                            sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  params = model.init({"params": jax.random.PRNGKey(0),
                       "sampler": jax.random.PRNGKey(1)},
                      jnp.asarray(rays), train=True)
  tree = jax.tree.map(np.asarray, params)
  if amplify:
    tree = _amplify(tree)
  out = model.apply(tree, jnp.asarray(rays))
  return (tree, np.asarray(out["rgb"]),
          np.asarray(out["weights"]).sum(-1))


CASES = [("black", "thin", False), ("black", "thin", True),
         ("white", "normal", True), ("random", "tanh", True),
         ("white", "fat", True), ("black", "leaky_relu", True)]


@pytest.mark.parametrize("sky_kind,sigmoid_kind,amplify", CASES)
def test_reference_and_module_match_jax_oracle(sky_kind, sigmoid_kind,
                                               amplify):
  rays = _rays()
  tree, rgb_j, acc_j = _jax_oracle(sky_kind, sigmoid_kind, rays, amplify)
  sd = convert.params_from_flax(tree)
  kw = dict(steps=STEPS, t_near=2.0, t_far=6.0, sigmoid_kind=sigmoid_kind,
            sky_kind=sky_kind)
  ref = k1.plain_cp_render_reference(sd, torch.from_numpy(rays), **kw)
  np.testing.assert_allclose(ref[:, :3].numpy(), rgb_j, atol=ATOL, rtol=0)
  np.testing.assert_allclose(ref[:, 3].numpy(), acc_j, atol=ATOL, rtol=0)

  model = tmodels.PlainNeRF(steps=STEPS, sky_kind=sky_kind,
                            sigmoid_kind=sigmoid_kind)
  model.load_state_dict(sd)
  with torch.no_grad():
    out = model(torch.from_numpy(rays))
  np.testing.assert_allclose(out["rgb"].numpy(), rgb_j, atol=ATOL, rtol=0)
  np.testing.assert_allclose(out["weights"].sum(-1).numpy(), acc_j,
                             atol=ATOL, rtol=0)
  if amplify:    # the case actually exercises the range
    assert rgb_j.std() > 0.05


def _seeded_model(**kw):
  from nerf_atlas_tpu_torch.train import driver
  return driver.init_model(tmodels.PlainNeRF(steps=STEPS, **kw), seed=0)


def test_cpu_wrapper_takes_the_reference_and_packs_weights():
  model = _seeded_model()
  rays = torch.from_numpy(_rays(40))
  before = k1.plain_cp_render.launches
  out = k1.plain_cp_render(model.state_dict(), rays, steps=STEPS)
  ws = k1.pack_weights(model.state_dict())
  assert ws.shape == (k1.WEIGHT_COUNT,) and ws.is_contiguous()
  packed = k1.plain_cp_render(ws, rays, steps=STEPS)
  ref = k1.plain_cp_render_reference(model.state_dict(), rays, steps=STEPS)
  assert torch.equal(out, ref) and torch.equal(packed, ref)
  assert out.shape == (40, 4) and bool(torch.isfinite(out).all())
  assert k1.plain_cp_render.launches == before   # no kernel on the CPU


def test_wrapper_rejects_bad_inputs():
  model = _seeded_model()
  sd = model.state_dict()
  rays = torch.from_numpy(_rays(8))
  with pytest.raises(ValueError):
    k1.plain_cp_render(sd, rays.double(), steps=STEPS)
  with pytest.raises(ValueError):
    k1.plain_cp_render(sd, rays[:, :5], steps=STEPS)
  with pytest.raises(ValueError):
    k1.plain_cp_render(sd, rays.t().contiguous().t(), steps=STEPS)
  with pytest.raises(NotImplementedError):
    k1.plain_cp_render(sd, rays, steps=STEPS, sigmoid_kind="softmax")
  with pytest.raises(NotImplementedError):
    k1.plain_cp_render(sd, rays, steps=STEPS, sky_kind="mlp")
  with pytest.raises(ValueError):
    k1.plain_cp_render(sd, rays.to("meta"), steps=STEPS)
  with pytest.raises(ValueError):
    k1.pack_weights(torch.zeros(10))
  bad = dict(sd)
  bad.pop("refl.mlp.layer_2.bias")
  with pytest.raises(KeyError):
    k1.pack_weights(bad)
  bad = dict(sd)
  bad["density_mlp.layer_1.weight"] = bad["density_mlp.layer_1.weight"][:8]
  with pytest.raises(ValueError):
    k1.pack_weights(bad)


def test_fused_gate_covers_the_flagship_only():
  from nerf_atlas_tpu_torch.train import driver
  assert driver._fused_render_fn(_seeded_model()) is not None
  assert driver._fused_render_fn(_seeded_model(sky_kind="white")) is not None
  assert driver._fused_render_fn(_seeded_model(enc_kind="posenc")) is not None
  for kw in (dict(enc_kind="posenc", sigmoid_kind="softmax"),
             dict(sigmoid_kind="softmax"), dict(lindisp=True),
             dict(intermediate_size=16)):
    assert driver._fused_render_fn(_seeded_model(**kw)) is None, kw


@pytest.mark.slow
def test_reference_matches_pallas_kernel_interpret():
  """Against the Pallas kernel itself (bf16 matmuls, interpret mode), on
  the seeded init that tests/test_pallas_render.py holds it to the oracle
  with (amplified weights scale its bf16 error past the tier)."""
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops.pallas import fused_plain_cp_render
  rays = _rays()
  tree, _, _ = _jax_oracle("white", "thin", rays, amplify=False)
  fused = np.asarray(fused_plain_cp_render(
      jax.tree.map(jnp.asarray, tree), jnp.asarray(rays), steps=STEPS,
      t_near=2.0, t_far=6.0, block_rays=32, interpret=True,
      sky_kind="white"))
  ref = k1.plain_cp_render_reference(
      convert.params_from_flax(tree), torch.from_numpy(rays), steps=STEPS,
      sky_kind="white").numpy()
  np.testing.assert_allclose(ref, fused, atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n", [(64, 4099), (16, 1000), (100, 77)])
def test_cuda_kernel_matches_reference(steps, n):
  """Kernel vs plain torch on the card: float32 on both sides, summation
  order differs; atol 1e-4 on rgb and acc."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run K1")
  torch.backends.cuda.matmul.allow_tf32 = False
  model = tmodels.PlainNeRF(steps=steps, sky_kind="white")
  from nerf_atlas_tpu_torch.train import driver
  driver.init_model(model, seed=1).cuda()
  rays = torch.from_numpy(_rays(n)).cuda()
  before = k1.plain_cp_render.launches
  out = k1.plain_cp_render(model.state_dict(), rays, steps=steps,
                           sky_kind="white")
  torch.cuda.synchronize()
  assert k1.plain_cp_render.launches == before + 1
  ref = k1.plain_cp_render_reference(model.state_dict(), rays, steps=steps,
                                     sky_kind="white")
  assert float((out - ref).abs().max()) < 1e-4
