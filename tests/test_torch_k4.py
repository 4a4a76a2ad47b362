"""The K4 slice in the port: PlainNeRF-posenc, MipNeRF's cone and
cylinder IPE, and TinyNeRF (the posenc, tiny, cone and cylinder modes of
K1/K2/K3), on the CPU against the JAX package.

- `ops/mip.py`, each function, against `nerf_atlas_tpu/ops/mip.py` on
  the same seeded inputs: the frustum moments, the segments and the
  lifted means agree bit for bit (both packages round each operation
  once, in the same order); the IPE features to 1e-6 abs (measured 1.2e-7,
  one float32 ulp of a sine near 1). Against a float64 evaluation both
  are 2.8e-5 off at 64 steps, equally (the float32 rounding of a mean
  times 2^15): XLA and torch do not round an IPE mean differently on the
  CPU, so the tolerance hides no port-only error.
- The port's `PlainNeRF(enc_kind="posenc")`, `PlainNeRF(mip="cone" |
  "cylinder")` and `TinyNeRF` forwards and the plain K1 of each mode
  (`plain_cp_render_reference` with `enc_kind`) against the JAX model's
  apply at full width, params carried across by
  `convert.params_from_flax`: rgb and acc 2e-4 abs, over sky × rgb
  activation, seeded and with the output layers amplified. The port
  takes the JAX package's eval grid and posenc bands here: XLA's
  2.0 ** jnp.linspace(0, 6, 10) is up to 8.2e-6 (several ulps) from the
  exact power where torch's is correctly rounded, and with the output
  layer ×40 and tanh that alone moves rgb by 2.7e-4 (2.7e-5 with the
  bands shared).
- The plain K3 (loss mode) and K2 (cotangent mode) of each mode against
  `jax.value_and_grad` through the JAX model at matmul precision
  "highest": loss 1e-5 relative, each gradient tensor 1e-4 relative, with
  a zero cotangent (or the render as the target) on the rays
  `testing.kink_free_rays` flags.
- `params_from_flax` carries TinyNeRF's `mlp/...` tree and the mip
  PlainNeRF's tree (no `enc/...`); the wrappers on CPU rays are their
  plain versions and launch nothing; `PlainCPRender` in each mode equals
  its plain K2.
- A `slow` case per mode: the plain K1 against the Pallas K1 in
  interpret mode (bf16 weights), at the 2e-2 tier tests/test_pallas_render.py
  holds it to.
- `cuda`-marked cases: K1, K2 and K3 of each mode against their plain
  versions on the card (K1 1e-4 abs; K2/K3 loss 1e-5, each gradient
  tensor 1e-4 on kink-free rays), two launches bit for bit; run them
  with `python -m pytest --noconftest -m cuda tests/test_torch_k4.py`.
The train paths, the gates and the runner: tests/test_torch_k4_train.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models, testing  # noqa: E402
from nerf_atlas_tpu_torch.ops import mip as tmip  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import build  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402
from nerf_atlas_tpu_torch.train import driver  # noqa: E402

STEPS = 16
N = 48
MODES = ["posenc", "tiny", "cone", "cylinder"]
CASES = [("black", "thin", False), ("black", "thin", True),
         ("white", "normal", True), ("random", "tanh", True)]


def _rays(n=N, seed=0):
  rng = np.random.default_rng(seed)
  r_o = np.tile([[0.0, 0.0, 3.5]], (n, 1)) + rng.normal(size=(n, 3)) * 0.1
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  return np.concatenate([r_o, r_d], -1).astype(np.float32)


def _jax_ts(steps=STEPS):
  """The JAX package's eval grid (jnp.linspace differs from
  torch.linspace in the last bit of some entries)."""
  import jax.numpy as jnp
  return torch.from_numpy(np.array(jnp.linspace(2.0, 6.0, steps,
                                                dtype=jnp.float32)))


def jax_model(mode, steps=STEPS, **kw):
  """The JAX model of a mode."""
  from nerf_atlas_tpu import models as jmodels
  base = dict(steps=steps, t_near=2.0, t_far=6.0, **kw)
  if mode == "tiny":
    return jmodels.TinyNeRF(**base)
  if mode in k1.MIP_KINDS:
    return jmodels.PlainNeRF(mip=mode, **base)
  return jmodels.PlainNeRF(enc_kind=mode, **base)


def port_model(mode, steps=STEPS, **kw):
  """The port's model of a mode."""
  if mode == "tiny":
    return models.TinyNeRF(steps=steps, **kw)
  if mode in k1.MIP_KINDS:
    return models.PlainNeRF(steps=steps, mip=mode, **kw)
  return models.PlainNeRF(steps=steps, enc_kind=mode, **kw)


def amplify(tree, mode, density=8.0):
  """Output layers scaled so that rgb spans (0, 1) and density varies
  along the rays (a random init renders near-constant grey)."""
  p = tree["params"]
  if mode == "tiny":
    w = p["mlp"]["layer_out"]["kernel"]
    p["mlp"]["layer_out"]["kernel"] = np.concatenate(
        [w[:, :1] * density, w[:, 1:] * 40.0], axis=1)
  else:
    p["refl"]["mlp"]["layer_out"]["kernel"] = (
        p["refl"]["mlp"]["layer_out"]["kernel"] * 40.0)
    p["density_mlp"]["layer_out"]["kernel"] = (
        p["density_mlp"]["layer_out"]["kernel"] * density)
  return tree


def jax_bands(monkeypatch):
  """Make the port's PositionalEncoder (the modules', the plain
  versions' and the kernels' bands) use the JAX package's bands."""
  import jax.numpy as jnp
  from nerf_atlas_tpu_torch.nn import encoders

  def bands(self, device=None):
    return torch.from_numpy(np.array(
        2.0 ** jnp.linspace(self.min_freq_log2, self.max_freq_log2,
                            self.num_freqs))).to(device)

  monkeypatch.setattr(encoders.PositionalEncoder, "freqs", bands)


def _jax_params(model, rays, seed=0):
  import jax
  import jax.numpy as jnp
  params = model.init({"params": jax.random.PRNGKey(seed),
                       "sampler": jax.random.PRNGKey(seed + 1)},
                      jnp.asarray(rays), train=True)
  return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# ops/mip.py
# ---------------------------------------------------------------------------

def _mip_inputs(n=32, steps=64, seed=0):
  rays = _rays(n, seed)
  ts = np.linspace(2.0, 6.0, steps, dtype=np.float32)
  return rays[:, :3], rays[:, 3:], np.ascontiguousarray(
      np.broadcast_to(ts, (n, steps)))


def _both(fn_name, *args):
  """(JAX result, port result) of the function of that name."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import mip as jmip
  j = getattr(jmip, fn_name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args])
  t = getattr(tmip, fn_name)(*[torch.from_numpy(a)
                               if isinstance(a, np.ndarray) else a
                               for a in args])
  j = jax.tree.map(np.asarray, j)
  t = tuple(x.numpy() for x in t) if isinstance(t, tuple) else t.numpy()
  return j, t


MIP_FNS = ["expected_sin", "lift_gaussian", "conical_frustum_to_gaussian",
           "cylinder_to_gaussian", "integrated_pos_enc_diag", "mip_segments",
           "pixel_radii", "radii_from_dirs", "load_mip"]


@pytest.mark.parametrize("fn", MIP_FNS)
def test_mip_op_matches_jax(fn):
  r_o, r_d, ts = _mip_inputs()
  rng = np.random.default_rng(1)
  t0, t1 = (a.numpy() for a in tmip.mip_segments(torch.from_numpy(ts)))
  rad = np.full_like(t0, 1e-3)
  if fn == "expected_sin":
    x = rng.normal(size=(64, 7)).astype(np.float32) * 50
    var = rng.uniform(0, 2, (64, 7)).astype(np.float32)
    (yj, vj), (yt, vt) = _both(fn, x, var)
    np.testing.assert_allclose(yt, yj, atol=1e-6, rtol=0)
    np.testing.assert_allclose(vt, vj, atol=1e-6, rtol=0)
  elif fn == "lift_gaussian":
    args = [rng.uniform(2, 6, (32, 64)).astype(np.float32) for _ in range(3)]
    (mj, cj), (mt, ct) = _both(fn, r_d, *args)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(ct, cj, rtol=1e-6, atol=0)
  elif fn in ("conical_frustum_to_gaussian", "cylinder_to_gaussian"):
    (mj, cj), (mt, ct) = _both(fn, r_d, t0, t1, rad)
    np.testing.assert_array_equal(mt, mj)         # the means bit for bit
    np.testing.assert_allclose(ct, cj, rtol=1e-6, atol=0)
  elif fn == "integrated_pos_enc_diag":
    # the Gaussians the models encode (the frustums of the segments):
    # their variance damps every band whose phase leaves sin's accurate
    # range in XLA's float32 sin (a phase of ~1e5 rad with no damping
    # puts XLA's sin 4e-3 from torch's)
    mean, cov = (a.numpy() for a in tmip.conical_frustum_to_gaussian(
        torch.from_numpy(r_d), *(torch.from_numpy(a) for a in (t0, t1, rad))))
    x = (mean + r_o[:, None, :]).astype(np.float32)
    fj, ft = _both(fn, x, cov, 0, 16)
    assert ft.shape == (32, 64, 96)
    np.testing.assert_allclose(ft, fj, atol=1e-6, rtol=0)
  elif fn == "mip_segments":
    (aj, bj), (at, bt) = _both(fn, ts)
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_array_equal(bt, bj)
    assert np.all(np.isfinite(bt)) and bt[0, -1] > ts[0, -1]
  elif fn == "pixel_radii":
    j, t = _both(fn, 400.0)
    np.testing.assert_allclose(t, j, rtol=1e-7)
  elif fn == "radii_from_dirs":
    grid = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    j, t = _both(fn, grid)
    assert t.shape == (2, 5, 6, 1)
    np.testing.assert_allclose(t, j, rtol=1e-6)
  else:
    from nerf_atlas_tpu.ops import mip as jmip
    assert tmip.load_mip(None) is None
    for kind in ("cone", "cylinder"):
      jenc, tenc = jmip.load_mip(kind), tmip.load_mip(kind)
      assert tenc.size() == jenc.size() == 16
      import jax.numpy as jnp
      fj = np.asarray(jenc(*(jnp.asarray(a) for a in (r_o, r_d, t0, t1,
                                                       rad))))
      ft = tenc(*(torch.from_numpy(a) for a in (r_o, r_d, t0, t1,
                                                 rad))).numpy()
      np.testing.assert_allclose(ft, fj, atol=1e-6, rtol=0)
      f64 = tenc(*(torch.from_numpy(a).double() for a in (r_o, r_d, t0, t1,
                                                          rad))).numpy()
      # both float32 evaluations sit equally far from float64 (measured
      # 2.8e-5: a mean's float32 rounding at the 2^15 scale)
      assert np.abs(ft - f64).max() < 1e-4
      assert np.abs(fj - f64).max() == pytest.approx(
          np.abs(ft - f64).max(), rel=0.05)
    with pytest.raises(NotImplementedError):
      tmip.load_mip("sphere")


# ---------------------------------------------------------------------------
# the modules and the plain K1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sky_kind,sigmoid_kind,amp", CASES)
def test_module_and_plain_k1_match_jax(mode, sky_kind, sigmoid_kind, amp,
                                       monkeypatch):
  import jax.numpy as jnp
  from nerf_atlas_tpu_torch.ops import rays as trays
  jax_bands(monkeypatch)
  rays = _rays()
  model = jax_model(mode, sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  tree = _jax_params(model, rays)
  if amp:
    tree = amplify(tree, mode)
  out_j = model.apply(tree, jnp.asarray(rays))
  rgb_j = np.asarray(out_j["rgb"])
  acc_j = np.asarray(out_j["weights"]).sum(-1)
  sd = convert.params_from_flax(tree)
  tr, ts = torch.from_numpy(rays), _jax_ts()
  kw = dict(steps=STEPS, sigmoid_kind=sigmoid_kind, sky_kind=sky_kind,
            enc_kind=mode)
  ref = k1.plain_cp_render_reference(sd, tr, ts=ts, **kw)
  np.testing.assert_allclose(ref[:, :3].numpy(), rgb_j, atol=2e-4, rtol=0)
  np.testing.assert_allclose(ref[:, 3].numpy(), acc_j, atol=2e-4, rtol=0)
  monkeypatch.setattr(trays, "compute_ts", lambda *a, **k: ts)
  port = port_model(mode, sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  port.load_state_dict(sd)
  with torch.no_grad():
    out = port(tr)
  np.testing.assert_allclose(out["rgb"].numpy(), rgb_j, atol=2e-4, rtol=0)
  np.testing.assert_allclose(out["weights"].numpy(),
                             np.asarray(out_j["weights"]), atol=2e-4, rtol=0)
  if amp:
    assert rgb_j.std() > 0.03


# ---------------------------------------------------------------------------
# the plain K2 / K3
# ---------------------------------------------------------------------------

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


def _assert_grads(packed, ref, rtol=1e-4):
  ours = {k: v.numpy() for k, v in k1.unpack_grads(packed).items()}
  assert set(ours) == set(ref)
  for key, r in ref.items():
    err = np.linalg.norm(ours[key] - r) / max(np.linalg.norm(r), 1e-30)
    assert err <= rtol, (key, err)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sky_kind,sigmoid_kind", [c[:2] for c in CASES[1:]])
def test_plain_k3_and_k2_match_jax(mode, sky_kind, sigmoid_kind,
                                   monkeypatch):
  jax_bands(monkeypatch)
  rays = _rays(seed=1)
  model = jax_model(mode, sky_kind=sky_kind, sigmoid_kind=sigmoid_kind)
  tree = amplify(_jax_params(model, rays), mode)
  sd = convert.params_from_flax(tree)
  tr, ts = torch.from_numpy(rays), _jax_ts()
  kw = dict(steps=STEPS, sigmoid_kind=sigmoid_kind, sky_kind=sky_kind, ts=ts,
            enc_kind=mode)
  keep = testing.kink_free_rays(sd, tr, ts, STEPS, enc_kind=mode).numpy()
  assert keep.sum() >= N // 2
  rng = np.random.default_rng(2)
  out = k1.plain_cp_render_reference(sd, tr, **kw)[:, :3].numpy()
  target = np.where(keep[:, None], rng.uniform(size=(N, 3)), out).astype(
      np.float32)
  g = (rng.normal(size=(N, 4)) * keep[:, None]).astype(np.float32)

  loss_j, grads_j = _jax_value_and_grads(model, tree, rays, target=target)
  loss, dws = k1.plain_cp_train_step(sd, tr, torch.from_numpy(target), **kw)
  assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
  _assert_grads(dws, grads_j)

  _, grads_j = _jax_value_and_grads(model, tree, rays, g=g)
  dws = k1.plain_cp_render_grad(sd, tr, torch.from_numpy(g), **kw)
  _assert_grads(dws, grads_j)


# ---------------------------------------------------------------------------
# trees, wrappers, layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["tiny", "cone"])
def test_params_from_flax_carries_the_tree(mode):
  rays = _rays(8)
  tree = _jax_params(jax_model(mode), rays)
  sd = convert.params_from_flax(tree)
  port = port_model(mode)
  assert set(sd) == set(port.state_dict())
  for key, value in port.state_dict().items():
    assert tuple(sd[key].shape) == tuple(value.shape), key
  prefix = "mlp" if mode == "tiny" else "density_mlp"
  np.testing.assert_array_equal(
      sd[f"{prefix}.layer_0.weight"].numpy(),
      tree["params"][prefix]["layer_0"]["kernel"].T)
  if mode == "tiny":
    assert set(tree["params"]) == {"mlp"}
    assert sd["mlp.layer_0.weight"].shape == (128, 128 + 51)
  else:
    assert "enc" not in tree["params"]["density_mlp"]
    assert sd["density_mlp.layer_in.weight"].shape == (256, 96)
  ws = k1.pack_weights(sd, enc_kind=mode)
  assert ws.shape == (k1.LAYOUTS[mode].weight_count,)
  back = k1.unpack_grads(ws)
  assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_layouts_and_weight_counts():
  counts = {k: v.weight_count for k, v in k1.LAYOUTS.items()}
  assert counts == {"cp": 467620, "hash": 449572, "posenc": 483364,
                    "tiny": 119300, "cone": 508708, "cylinder": 508708}
  assert k1.ENC_KINDS == ("cp", "hash", "posenc", "tiny", "cone",
                          "cylinder")
  assert k1.LAYOUTS["tiny"].refl_layers == ()
  assert k1.LAYOUTS["tiny"].n_layers == 6 and k1.LAYOUTS["cone"].n_layers == 5
  np.testing.assert_array_equal(k1.freqs("posenc").numpy(),
                                2.0 ** np.linspace(0, 6, 10, dtype=np.float32))
  assert k1.freqs("tiny").shape == (8,) and k1.freqs("cone") is None
  for mode in MODES:   # pack_weights raises on another mode's tree
    sd = driver.init_model(port_model(mode), seed=0).state_dict()
    for other in MODES:
      if k1.LAYOUTS[other].weight_count != k1.LAYOUTS[mode].weight_count:
        with pytest.raises((KeyError, ValueError)):
          k1.pack_weights(sd, enc_kind=other)


@pytest.mark.parametrize("mode", MODES)
def test_wrappers_on_cpu_are_the_plain_versions(mode):
  model = driver.init_model(port_model(mode, sky_kind="white"), seed=3)
  ws = k1.pack_weights(model.state_dict(), enc_kind=mode)
  rays = torch.from_numpy(_rays(12, 4))
  ts = torch.linspace(2.0, 6.0, STEPS) + 0.01
  kw = dict(steps=STEPS, sky_kind="white", ts=ts, enc_kind=mode)
  counts = (k1.plain_cp_render.launches, k1.plain_cp_render_grad.launches,
            k1.plain_cp_train_step.launches)
  ref = k1.plain_cp_render_reference(ws, rays, **kw)
  assert torch.equal(k1.plain_cp_render(ws, rays, **kw), ref)
  g = torch.randn(12, 4, generator=torch.Generator().manual_seed(0))
  dws = k1.plain_cp_render_grad(ws, rays, g, **kw)
  leaf = ws.clone().requires_grad_(True)
  step_kw = dict(steps=STEPS, sky_kind="white")
  if mode in k1.MIP_KINDS:
    assert torch.equal(k1.fused_plain_mip_render(ws, rays, mip_kind=mode,
                                                 **{k: v for k, v in kw.items()
                                                    if k != "enc_kind"}), ref)
    out = k1.fused_plain_mip_render_train(leaf, rays, ts, mip_kind=mode,
                                          **step_kw)
    loss, grad = k1.fused_plain_mip_train_step(ws, rays, ref[:, :3] * 0.5,
                                               ts, mip_kind=mode, **step_kw)
  else:
    out = k1.plain_cp_render_train(leaf, rays, ts, enc_kind=mode, **step_kw)
    loss, grad = k1.plain_cp_train_step(ws, rays, ref[:, :3] * 0.5, **kw)
  (out * g).sum().backward()
  torch.testing.assert_close(leaf.grad, dws, rtol=1e-6, atol=1e-9)
  loss_r, grad_r = k1.plain_cp_train_step_reference(ws, rays,
                                                    ref[:, :3] * 0.5, **kw)
  assert torch.equal(loss, loss_r) and torch.equal(grad, grad_r)
  assert (k1.plain_cp_render.launches, k1.plain_cp_render_grad.launches,
          k1.plain_cp_train_step.launches) == counts   # no kernel on the CPU
  with pytest.raises(ValueError):
    k1.plain_cp_render(ws, rays, steps=STEPS, enc_kind="hash")
  if mode in k1.MIP_KINDS:
    with pytest.raises(NotImplementedError):
      k1.fused_plain_mip_render(ws, rays, mip_kind="sphere")


def test_every_render_source_includes_the_common_header():
  """One header holds the device helpers: the four render sources include
  it (K1 and K2/K3 through render_plain.cuh, which also holds their
  shared layout and encoder, K7f/K7b through render_ae.cuh), and no
  source defines a helper it has."""
  common = (build.CSRC / "render_common.cuh").read_text()
  helpers = ("activate", "act_grad", "sigmoid", "softplus", "rgb_act",
             "sample_point", "ray_setup", "accumulate", "dense_fwd",
             "dense_bwd", "load_act", "act_rows", "reduce_partials_kernel")
  for name in helpers:
    assert f" {name}(" in common, name
  # K7b's FMA backward layers went when its products moved to the tensor
  # cores (mma_tf32.cuh `mlp_bwd`)
  for name in ("dw_cols", "load_col", "db_col", "dw_small", "hidden_bwd",
               "input_bwd"):
    assert f" {name}(" not in common, name
  for src in ("render_fwd.cu", "render_bwd.cu", "render_ae_fwd.cu",
              "render_ae_bwd.cu", "render_ae.cuh"):
    text = (build.CSRC / src).read_text()
    for name in helpers + ("encode_tile",):
      assert f"void {name}(" not in text and f"float {name}(" not in text, (
          src, name)
  for src, header in (("render_plain.cuh", "render_common.cuh"),
                      ("render_ae.cuh", "render_common.cuh"),
                      ("render_fwd.cu", "render_plain.cuh"),
                      ("render_bwd.cu", "render_plain.cuh"),
                      ("render_ae_fwd.cu", "render_ae.cuh"),
                      ("render_ae_bwd.cu", "render_ae.cuh")):
    assert f'#include "{header}"' in (build.CSRC / src).read_text(), src


def test_render_bwd_builds_per_mode():
  """render_bwd.cu is built once per mode (a -D define), each its own
  library key; the define-free key is the source's and flags' alone."""
  src = build.CSRC / "render_bwd.cu"
  keys = {build.source_digest(src, k1.bwd_defines(kind))
          for kind in k1.ENC_KINDS}
  assert len(keys) == len(k1.ENC_KINDS)
  assert build.source_digest(src) not in keys
  assert k1.bwd_defines("tiny") == ("RENDER_BWD_ENC=3",)


@pytest.mark.slow
@pytest.mark.parametrize("mode", MODES)
def test_plain_k1_matches_pallas_interpret(mode):
  """The plain K1 against the Pallas K1 (interpret mode, bf16 weights):
  2e-2, the tier tests/test_pallas_render.py holds the Pallas kernel to,
  on the seeded init."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops.pallas import render as pr
  rays = _rays(64)
  tree = _jax_params(jax_model(mode, sky_kind="white"), rays)
  jtree = jax.tree.map(jnp.asarray, tree)
  if mode in k1.MIP_KINDS:
    fused = pr.fused_plain_mip_render(
        jtree, jnp.asarray(rays), mip_kind=mode, steps=STEPS, t_near=2.0,
        t_far=6.0, block_rays=32, interpret=True, sky_kind="white")
  else:
    fused = pr.fused_plain_cp_render(
        jtree, jnp.asarray(rays), steps=STEPS, t_near=2.0, t_far=6.0,
        block_rays=32, interpret=True, sky_kind="white", enc_kind=mode)
  ref = k1.plain_cp_render_reference(
      convert.params_from_flax(tree), torch.from_numpy(rays), steps=STEPS,
      ts=_jax_ts(), sky_kind="white", enc_kind=mode)
  np.testing.assert_allclose(ref.numpy(), np.asarray(fused), atol=2e-2)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

def _cuda_case(mode, n, steps, sky, seed):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run K1/K2/K3")
  torch.backends.cuda.matmul.allow_tf32 = False
  model = driver.init_model(port_model(mode, steps=steps, sky_kind=sky),
                            seed=seed)
  sd = dict(model.state_dict())
  prefix = "mlp" if mode == "tiny" else "refl.mlp"
  sd[f"{prefix}.layer_out.weight"] = sd[f"{prefix}.layer_out.weight"] * 8.0
  ws = k1.pack_weights(sd, "cuda", mode)
  gen = torch.Generator(device="cuda").manual_seed(seed)
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  ts = rays_ops.compute_ts(2.0, 6.0, steps, perturb=1.0, generator=gen,
                           device="cuda")
  rays = torch.from_numpy(_rays(n, seed)).cuda()
  return ws, rays, ts, gen, dict(steps=steps, sky_kind=sky, ts=ts,
                                 enc_kind=mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("steps,n", [(64, 1001), (16, 77)])
def test_cuda_k1_matches_plain(mode, steps, n):
  """K1 vs the plain K1 on the card: 1e-4 abs, on the grid and on a
  jittered ts."""
  ws, rays, _, _, kw = _cuda_case(mode, n, steps, "white", 1)
  for ts in (None, kw["ts"]):
    before = k1.plain_cp_render.launches
    out = k1.plain_cp_render(ws, rays, **dict(kw, ts=ts))
    torch.cuda.synchronize()
    assert k1.plain_cp_render.launches == before + 1
    ref = k1.plain_cp_render_reference(ws, rays, **dict(kw, ts=ts))
    assert float((out - ref).abs().max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("steps,n", [(64, 300), (16, 77)])
def test_cuda_k2_k3_match_plain(mode, steps, n):
  """K3 and K2 vs their plain versions: loss 1e-5 relative; each gradient
  tensor 1e-4 relative with a zero cotangent on the rays near a
  leaky-relu kink; PlainCPRender's gradient equals K2's bit for bit, and
  two launches of K3 and of K2 agree bit for bit."""
  ws, rays, ts, gen, kw = _cuda_case(mode, n, steps, "white", 2)
  keep = testing.kink_free_rays(ws, rays, ts, steps, enc_kind=mode)
  out = k1.plain_cp_render_reference(ws, rays, **kw)[:, :3]
  target = torch.where(keep[:, None], torch.rand(n, 3, device="cuda",
                                                 generator=gen), out)
  target = target.contiguous()
  loss, dws = k1.plain_cp_train_step(ws, rays, target, **kw)
  loss_r, dws_r = k1.plain_cp_train_step_reference(ws, rays, target, **kw)
  assert abs(float(loss) - float(loss_r)) <= 1e-5 * float(loss_r)
  ug, ur = k1.unpack_grads(dws), k1.unpack_grads(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
  again = k1.plain_cp_train_step(ws, rays, target, **kw)
  assert torch.equal(loss, again[0]) and torch.equal(dws, again[1])
  g = torch.randn(n, 4, device="cuda", generator=gen) * keep[:, None]
  dws = k1.plain_cp_render_grad(ws, rays, g, **kw)
  dws_r = k1.plain_cp_render_grad_reference(ws, rays, g, **kw)
  ug, ur = k1.unpack_grads(dws), k1.unpack_grads(dws_r)
  assert max(float((ug[k] - ur[k]).norm() / ur[k].norm()) for k in ur) <= 1e-4
  assert torch.equal(dws, k1.plain_cp_render_grad(ws, rays, g, **kw))
  leaf = ws.clone().requires_grad_(True)
  (k1.plain_cp_render_train(leaf, rays, ts, steps=steps, sky_kind="white",
                            enc_kind=mode) * g).sum().backward()
  assert torch.equal(leaf.grad, dws)
