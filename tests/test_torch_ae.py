"""The NeRFAE slice in the port: the module, K7f/K7b's plain versions,
the latent L2 and the kernel gates, on the CPU against the JAX package.

- The port's `NeRFAE` and the plain K7f (`ae_render_reference`) against
  the JAX `NeRFAE` forward at full width, params transplanted by
  `convert.params_from_flax`: rgb, acc and `latent_l2` 2e-4, over sky ×
  rgb activation, with the output layers amplified so that rgb spans
  (0, 1), and with a zeroed encoder output layer (raw encoding 0: the
  1e-6 clamp of the normalize).
- The plain K7b in both modes (autograd through the plain K7f) against
  `jax.value_and_grad` through the JAX model at matmul precision
  "highest": loss 1e-5 relative, each gradient tensor 1e-4 relative, with
  a zero cotangent on the rays `testing.ae_kink_free_rays` flags. Here
  the biases start from seeded random values and only the View's output
  layer is amplified: with zero biases and density_tfm's output ×8 the
  JAX float32 oracle is itself up to 1.5e-4 from a float64 evaluation on
  density_tfm's gradients, the port's plain version 6e-5 (measured on
  these rays), which leaves no room under 1e-4.
- `ae_latent_l2` on injected points against the JAX
  `regularizers.ae_latent_l2`: value 1e-5 relative, each encoder gradient
  tensor 1e-4 relative.
- `params_from_flax` carries the NeRFAE tree (`encode`, `density_tfm`,
  `refl/mlp`) onto the port's state_dict keys.
- The build cache key follows the headers a kernel source includes.
- `cuda`-marked cases: K7f and K7b (both modes) against their plain
  versions on the card, and `AERender`'s gradient against mode G's (run
  with `python -m pytest --noconftest -m cuda tests/test_torch_ae.py`).
- A `slow` case: the plain K7f against the Pallas K7f in interpret mode
  at the Pallas bf16 tolerance.
The train paths, the gates and the runner: tests/test_torch_ae_train.py.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import build  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_ae as k7  # noqa: E402
from nerf_atlas_tpu_torch.train import driver, regularizers  # noqa: E402

STEPS = 16
N = 48
CASES = [("black", "thin", False), ("black", "thin", True),
         ("white", "normal", True), ("random", "tanh", True)]


def _rays(n=N, seed=0):
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(size=(n, 3)) * 0.1
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


def _amplify(tree, density=8.0):
  """Output layers scaled so that rgb spans (0, 1) and density varies."""
  p = tree["params"]
  p["refl"]["mlp"]["layer_out"]["kernel"] = (
      p["refl"]["mlp"]["layer_out"]["kernel"] * 40.0)
  p["density_tfm"]["layer_out"]["kernel"] = (
      p["density_tfm"]["layer_out"]["kernel"] * density)
  return tree


def _random_biases(tree, seed):
  """Every bias drawn from N(0, 0.1²) (flax initializes them to 0)."""
  import jax
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map_with_path(
      lambda p, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                    if "bias" in jax.tree_util.keystr(p) else v), tree)


def _jax_model(sky_kind="black", sigmoid_kind="thin", rays=None,
               amplify=False, seed=0):
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  model = jmodels.NeRFAE(steps=STEPS, t_near=2.0, t_far=6.0,
                         sky_kind=sky_kind, sigmoid_kind=sigmoid_kind,
                         refl_kind="view", normalize_latent=True)
  params = model.init({"params": jax.random.PRNGKey(seed),
                       "sampler": jax.random.PRNGKey(seed + 1)},
                      jnp.asarray(_rays() if rays is None else rays),
                      train=True)
  tree = jax.tree.map(np.asarray, params)
  return model, (_amplify(tree) if amplify else tree)


def _jax_ts(steps=STEPS):
  """The JAX package's eval grid (jnp.linspace, which differs from
  torch.linspace in the last bit of some entries; posenc multiplies a
  sample point by up to 64)."""
  import jax.numpy as jnp
  return torch.from_numpy(np.array(jnp.linspace(2.0, 6.0, steps,
                                                dtype=jnp.float32)))


def _port(sd, **kw):
  model = models.NeRFAE(steps=STEPS, **kw)
  model.load_state_dict(sd)
  return model


@pytest.mark.parametrize("sky_kind,sigmoid_kind,amplify",
                         CASES + [("white", "thin", "zero-encoding")])
def test_ae_module_and_plain_k7f_match_jax(sky_kind, sigmoid_kind, amplify,
                                           monkeypatch):
  import jax.numpy as jnp
  from nerf_atlas_tpu_torch.ops import rays as trays
  rays = _rays()
  model, tree = _jax_model(sky_kind, sigmoid_kind, rays, bool(amplify))
  if amplify == "zero-encoding":
    enc_out = tree["params"]["encode"]["layer_out"]
    enc_out["kernel"] = np.zeros_like(enc_out["kernel"])
    enc_out["bias"] = np.zeros_like(enc_out["bias"])
  out_j = model.apply(tree, jnp.asarray(rays))
  rgb_j = np.asarray(out_j["rgb"])
  acc_j = np.asarray(out_j["weights"]).sum(-1)
  sd = convert.params_from_flax(tree)
  tr, ts = torch.from_numpy(rays), _jax_ts()
  kw = dict(steps=STEPS, sigmoid_kind=sigmoid_kind, sky_kind=sky_kind)
  ref = k7.ae_render_reference(sd, tr, ts=ts, **kw)
  np.testing.assert_allclose(ref[:, :3].numpy(), rgb_j, atol=2e-4, rtol=0)
  np.testing.assert_allclose(ref[:, 3].numpy(), acc_j, atol=2e-4, rtol=0)
  before = k7.fused_ae_render.launches
  assert torch.equal(k7.fused_ae_render(k7.pack_weights_ae(sd), tr, **kw),
                     k7.ae_render_reference(sd, tr, **kw))
  assert k7.fused_ae_render.launches == before        # no kernel on the CPU
  monkeypatch.setattr(trays, "compute_ts", lambda *a, **k: ts)
  port = _port(sd, sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  with torch.no_grad():
    out = port(tr)
  np.testing.assert_allclose(out["rgb"].numpy(), rgb_j, atol=2e-4, rtol=0)
  np.testing.assert_allclose(out["weights"].numpy(),
                             np.asarray(out_j["weights"]), atol=2e-4, rtol=0)
  np.testing.assert_allclose(float(out["latent_l2"]),
                             float(out_j["latent_l2"]), rtol=2e-4, atol=0)
  if amplify is True:
    assert rgb_j.std() > 0.05
  if amplify == "zero-encoding":
    assert float(out_j["latent_l2"]) == 0.0
    np.testing.assert_array_equal(
        port.encoding(torch.zeros(4, 3)).detach().numpy(), np.zeros((4, 32)))


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


@pytest.mark.parametrize("sky_kind,sigmoid_kind", [c[:2] for c in CASES[1:]])
def test_plain_k7b_matches_jax(sky_kind, sigmoid_kind):
  rays = _rays(seed=1)
  model, tree = _jax_model(sky_kind, sigmoid_kind, rays)
  tree = _random_biases(_amplify(tree, density=1.0), 7)
  sd = convert.params_from_flax(tree)
  tr, ts = torch.from_numpy(rays), _jax_ts()
  kw = dict(steps=STEPS, sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts)
  keep = testing.ae_kink_free_rays(sd, tr, ts, STEPS).numpy()
  assert keep.sum() >= N // 2
  rng = np.random.default_rng(2)
  out = k7.ae_render_reference(sd, tr, **kw)[:, :3].numpy()
  target = np.where(keep[:, None], rng.uniform(size=(N, 3)), out).astype(
      np.float32)
  g = (rng.normal(size=(N, 4)) * keep[:, None]).astype(np.float32)

  loss_j, grads_j = _jax_value_and_grads(model, tree, rays, target=target)
  loss, dws = k7.fused_ae_train_step(sd, tr, torch.from_numpy(target),
                                     **kw)
  assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
  _assert_grads(k7.unpack_grads_ae(dws), grads_j)

  _, grads_j = _jax_value_and_grads(model, tree, rays, g=g)
  dws = k7.fused_ae_render_grad(sd, tr, torch.from_numpy(g), **kw)
  _assert_grads(k7.unpack_grads_ae(dws), grads_j)
  # the autograd Function on the CPU: the same numbers
  ws = k7.pack_weights_ae(sd).requires_grad_(True)
  out = k7.fused_ae_render_train(ws, tr, **kw)
  (out * torch.from_numpy(g)).sum().backward()
  torch.testing.assert_close(ws.grad, dws, rtol=1e-6, atol=1e-9)


def test_ae_latent_l2_matches_jax(monkeypatch):
  """The point-sampled latent L2 on the same injected points: the value
  and each encoder tensor's gradient (the other parameters get none)."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import regularizers as jreg
  pts = np.random.default_rng(5).uniform(-1.3, 1.3, (256, 3)).astype(
      np.float32)
  model, tree = _jax_model()
  monkeypatch.setattr(jreg.jax.random, "uniform",
                      lambda key, shape, **kw: jnp.asarray(pts))
  with jax.default_matmul_precision("highest"):
    value_j, grads_j = jax.value_and_grad(
        lambda p: jreg.ae_latent_l2(model.apply, p, jax.random.PRNGKey(0),
                                    n=256))(jax.tree.map(jnp.asarray, tree))
  grads_j = convert.params_from_flax(jax.tree.map(np.asarray, grads_j))
  monkeypatch.setattr(regularizers, "uniform_points",
                      lambda generator, n: torch.from_numpy(pts))
  port = _port(convert.params_from_flax(tree))
  value = regularizers.ae_latent_l2(port, torch.Generator(), n=256)
  value.backward()
  value = float(value.detach())
  assert abs(value - float(value_j)) <= 1e-5 * abs(float(value_j))
  got = {k: p.grad for k, p in port.named_parameters() if p.grad is not None}
  assert set(got) == {k for k in grads_j if k.startswith("encode.")}
  _assert_grads({k: v.numpy() for k, v in got.items()},
                {k: grads_j[k].numpy() for k in got})
  assert regularizers.latent_l2({}) == 0.0


def test_uniform_points_draw_in_the_box():
  pts = regularizers.uniform_points(torch.Generator().manual_seed(0), 4096)
  assert pts.shape == (4096, 3)
  assert float(pts.min()) >= -1.3 and float(pts.max()) <= 1.3
  assert abs(float(pts.mean())) < 0.05


def test_params_from_flax_carries_the_ae_tree():
  _, tree = _jax_model()
  sd = convert.params_from_flax(tree)
  port = models.NeRFAE(steps=STEPS)
  assert set(sd) == set(port.state_dict())
  for key, value in port.state_dict().items():
    assert tuple(sd[key].shape) == tuple(value.shape), key
  np.testing.assert_array_equal(
      sd["encode.layer_0.weight"].numpy(),
      tree["params"]["encode"]["layer_0"]["kernel"].T)
  assert k7.pack_weights_ae(sd).shape == (k7.WEIGHT_COUNT,)
  assert k7.WEIGHT_COUNT == 564804
  back = k7.unpack_grads_ae(k7.pack_weights_ae(sd))
  assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_init_follows_the_jax_distributions():
  """Encoder and density_tfm xavier, View siren, zero biases, with the
  layer shapes of the JAX model."""
  model = driver.init_model(models.NeRFAE(steps=STEPS), seed=0)
  sd = model.state_dict()
  w = sd["encode.layer_1.weight"]
  bound = np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
  assert float(w.abs().max()) <= bound
  assert float(w.std()) == pytest.approx(bound / np.sqrt(3), rel=0.02)
  first = sd["refl.mlp.layer_in.weight"]
  assert float(first.abs().max()) <= 1.0 / first.shape[1]
  assert all(float(v.abs().max()) == 0.0 for k, v in sd.items()
             if k.endswith(".bias"))


def test_build_key_follows_included_headers(tmp_path):
  """An edited header, or one it includes in turn, changes the key of
  every source that includes it, and nothing else does; a source without
  quoted includes keeps the key of its bytes and the flags alone."""
  (tmp_path / "a.cu").write_text('#include "b.cuh"\nint a;\n')
  (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
  (tmp_path / "c.cuh").write_text("int c;\n")
  (tmp_path / "other.cuh").write_text("int o;\n")
  (tmp_path / "plain.cu").write_text("#include <cuda_runtime.h>\nint p;\n")
  key = build.source_digest(tmp_path / "a.cu")
  (tmp_path / "other.cuh").write_text("int o2;\n")
  assert build.source_digest(tmp_path / "a.cu") == key
  (tmp_path / "c.cuh").write_text("int c2;\n")
  assert build.source_digest(tmp_path / "a.cu") != key
  plain = (tmp_path / "plain.cu").read_bytes()
  assert build.source_digest(tmp_path / "plain.cu") == hashlib.sha256(
      plain + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
  ae_src = build.CSRC / "render_ae_fwd.cu"
  assert b'#include "render_ae.cuh"' in ae_src.read_bytes()
  assert build.source_digest(ae_src) != hashlib.sha256(
      ae_src.read_bytes() + " ".join(build.NVCC_FLAGS).encode()
  ).hexdigest()[:16]


@pytest.mark.slow
def test_plain_k7f_matches_pallas_interpret():
  """The plain K7f against the Pallas K7f (interpret mode, bf16 weights):
  2e-2, the Pallas kernel's own tolerance, on the seeded weights of
  tests/test_pallas_ae.py (amplified ones put the bf16 error past it)."""
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops.pallas.render_ae import fused_ae_render
  rays = _rays(64)
  _, tree = _jax_model(rays=rays)
  fused = fused_ae_render(tree, jnp.asarray(rays), steps=STEPS, t_near=2.0,
                          t_far=6.0, block_rays=32, interpret=True)
  ref = k7.ae_render_reference(convert.params_from_flax(tree),
                               torch.from_numpy(rays), steps=STEPS,
                               ts=_jax_ts())
  np.testing.assert_allclose(ref.numpy(), np.asarray(fused), atol=2e-2)


def _cuda_case(n, steps, sky, seed):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run the kernels")
  torch.backends.cuda.matmul.allow_tf32 = False
  model = driver.init_model(models.NeRFAE(steps=steps, sky_kind=sky),
                            seed=seed)
  sd = dict(model.state_dict())
  sd["refl.mlp.layer_out.weight"] = sd["refl.mlp.layer_out.weight"] * 40.0
  sd["density_tfm.layer_out.weight"] = (
      sd["density_tfm.layer_out.weight"] * 8.0)
  ws = k7.pack_weights_ae(sd, "cuda")
  gen = torch.Generator(device="cuda").manual_seed(seed)
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                           device="cuda")
  rays = torch.from_numpy(_rays(n, seed)).cuda()
  return ws, rays, ts, gen, dict(steps=steps, sky_kind=sky, ts=ts)


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n", [(64, 1001), (16, 77)])
@pytest.mark.parametrize("sky", ["black", "white"])
def test_cuda_k7f_matches_plain(steps, n, sky):
  """K7f vs the plain K7f on the card: 1e-4 abs."""
  ws, rays, _, _, kw = _cuda_case(n, steps, sky, 1)
  for ts in (None, kw["ts"]):
    before = k7.fused_ae_render.launches
    out = k7.fused_ae_render(ws, rays, **dict(kw, ts=ts))
    torch.cuda.synchronize()
    assert k7.fused_ae_render.launches == before + 1
    ref = k7.ae_render_reference(ws, rays, **dict(kw, ts=ts))
    assert float((out - ref).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n", [(64, 300), (16, 77)])
def test_cuda_k7b_matches_plain(steps, n):
  """K7b in both modes vs its plain versions: loss 1e-5 relative; each
  gradient tensor 1e-4 relative with a zero cotangent on the rays near a
  leaky-relu kink (`ae_kink_free_rays`); AERender's gradient equals mode
  G's bit for bit, and two launches agree bit for bit."""
  ws, rays, ts, gen, kw = _cuda_case(n, steps, "white", 2)
  keep = testing.ae_kink_free_rays(ws, rays, ts, steps)
  out = k7.ae_render_reference(ws, rays, **kw)[:, :3]
  target = torch.where(keep[:, None], torch.rand(n, 3, device="cuda",
                                                 generator=gen), out)
  target = target.contiguous()
  step_kw = {k: v for k, v in kw.items() if k != "ts"}
  loss, dws = k7.fused_ae_train_step(ws, rays, target, ts, **step_kw)
  loss_r, dws_r = k7.ae_train_step_reference(ws, rays, target, **kw)
  assert abs(float(loss) - float(loss_r)) <= 1e-5 * float(loss_r)
  ug, ur = k7.unpack_grads_ae(dws), k7.unpack_grads_ae(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
  g = torch.randn(n, 4, device="cuda", generator=gen) * keep[:, None]
  dws = k7.fused_ae_render_grad(ws, rays, g, **kw)
  dws_r = k7.ae_render_grad_reference(ws, rays, g, **kw)
  ug, ur = k7.unpack_grads_ae(dws), k7.unpack_grads_ae(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
  assert torch.equal(dws, k7.fused_ae_render_grad(ws, rays, g, **kw))
  leaf = ws.clone().requires_grad_(True)
  (k7.fused_ae_render_train(leaf, rays, ts, **step_kw) * g).sum().backward()
  assert torch.equal(leaf.grad, dws)
