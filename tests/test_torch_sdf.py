"""The rest of the SDF family in the port, on the CPU against the JAX
package: `smooth_min`, the six SDF shapes bounded or not, the marchers,
the SDF surface renderer, `VolSDF.surface_render` and the SDF
regularizers.

- `smooth_min` (both sides of its 1e-4 clamp): 1e-6.
- Each shape (mlp, siren, curl-mlp, local, spheres, triangles), plain and
  in a UnitSphere, on 48 points in [−1.2, 1.2]³ with the parameters
  carried across by `convert.params_from_flax` (seeded 0.1·N(0, 1)
  biases, and 0.05·N(0, 1) weights for an all-zero layer, so that every
  part is active): sdf and latent 2e-4; the normals (CurlMLP's second
  order) and the gradient of Σ c·sdf in every parameter 1e-4 relative
  per tensor, on the points whose leaky-relu inputs all clear 0 by ten
  times their float32-vs-float64 distance (`kink_free`: the float64 run
  takes exact Fourier phases, so the margin covers the phases' rounding,
  which differs between the packages at tens of radians).
- The marchers on an analytic bumpy sphere (the same function in both
  packages, 64 rays, some missing): the scan's bracket and hits, and the
  hits of bisect, secant and sphere marching, exact on the rays whose
  scan values all clear 0 by 1e-4 and whose minimum is unique by 1e-4
  (sphere: whose every step's distance clears eps by 1e-5); the points
  and the best position 1e-5 (sphere 1e-4: its t sums 32 steps), the
  throughput 1e-6. XLA fuses r_o + t·r_d, so the points differ by an ulp.
- The SDF renderer (MLP shape in its bounding sphere, 32 scan steps) with
  each intersector, and `VolSDF.surface_render`, on the rays `scan_clear`
  keeps (sphere marching: `sphere_clear`, every step's distance off eps
  by 1e-5 and t off far by 1e-4) that also clear the kinks at their
  surface points: hits exact, pts 1e-5, rgb 2e-4, sil_logit 500 × 2e-6
  (throughput and weights a quarter of that: the sigmoid's slope), normals
  1e-4 relative. Sphere marching's pts 2e-3: its t sums the MLP's values
  along the ray, whose Fourier phases at |p| ≈ 4 (~170 rad) round
  differently in the two packages, ~1e-3 of a value there; its shading
  (rgb, normals, sil_logit) is held to the JAX modules at the port's end
  points.
- The regularizers: `surface_eikonal` on shared normals and weights
  (value 1e-6 relative, gradients 1e-5); `smooth_normals` (orders 1 and
  2, eps fixed and drawn), `smooth_surface` and `eikonal_random` on a
  VolSDF (MLP shape) and `smooth_normals` on the bounded spheres shape,
  on the JAX package's own draws less the points near a kink: value 1e-5
  relative, each parameter gradient 1e-4 relative. The port's draws: the
  shapes and ranges the JAX ones have.
The train paths and the runner: tests/test_torch_sdf_train.py.
"""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import convert, models  # noqa: E402
from nerf_atlas_tpu_torch.models import sdf as tsdf  # noqa: E402
from nerf_atlas_tpu_torch.nn import SkipConnMLP  # noqa: E402
from nerf_atlas_tpu_torch.ops import march as tmarch  # noqa: E402
from nerf_atlas_tpu_torch.ops import math as tmath  # noqa: E402
from nerf_atlas_tpu_torch.train import regularizers  # noqa: E402

KINDS = ("mlp", "siren", "curl-mlp", "local", "spheres", "triangles")
N = 48
SCAN = 32
MARGIN = 1e-4


def points(n, seed, scale=1.2):
  rng = np.random.default_rng(seed)
  return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def rays(n, seed, spread=0.3):
  """Rays from a sphere of radius 4 aimed near the origin (the wider the
  spread, the more miss the unit sphere)."""
  rng = np.random.default_rng(seed)
  o = rng.normal(size=(n, 3))
  o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
  d = -o / 4.0 + rng.normal(size=(n, 3)) * spread
  return np.concatenate([o, d], -1).astype(np.float32)


def activate(tree, seed):
  """Seeded 0.1·N(0, 1) biases and 0.05·N(0, 1) kernels where a layer
  starts at zero (the spheres' residual MLP)."""
  import jax
  rng = np.random.default_rng(seed)

  def leaf(path, v):
    key = jax.tree_util.keystr(path)
    if "bias" in key:
      return (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    if "kernel" in key and not np.any(v):
      return (0.05 * rng.normal(size=v.shape)).astype(np.float32)
    return v

  return jax.tree_util.tree_map_with_path(leaf, tree)


def kink_free(module, pts, margin: float = 10.0):
  """Bool [n]: the points whose leaky-relu inputs (every non-siren
  SkipConnMLP of `module`, evaluated by `module(pts)`) all lie further
  from 0 than `margin` times their float32-vs-float64 distance, per value
  and per column RMS. The float64 run computes its own (exact) Fourier
  phases."""
  pts = torch.as_tensor(pts)
  runs = []
  for dtype in (torch.float32, torch.float64):
    m, zs = copy.deepcopy(module).to(dtype), []
    for mod in m.modules():
      if isinstance(mod, SkipConnMLP) and mod.init_kind != "siren":
        def record(v, act=mod.activation, zs=zs):
          zs.append(v.detach().double())
          return act(v)
        mod.activation = record
    with torch.no_grad():
      m(pts.to(dtype))
    runs.append(zs)
  n = pts.shape[0]
  keep = torch.ones(n, dtype=torch.bool)
  for a, b in zip(*runs):
    d = (a - b).abs()
    rms = d.square().mean(dim=0, keepdim=True).sqrt()
    keep &= ~(a.abs() <= margin * torch.maximum(d, rms)).reshape(n, -1).any(1)
  return keep


def rel(a, b):
  a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
  return float((a - b).norm() / b.norm())


def check_grads(got: dict, ref: dict, tol=1e-4, what=""):
  """Each gradient tensor 1e-4 relative. A parameter the port's autograd
  leaves without one (B, which takes none, and those the term does not
  read) has a zero gradient in JAX; a zero JAX gradient (the normals of a
  leaky-relu MLP do not move with its biases: act″ = 0) is held at 1e-6
  of the largest tensor's norm."""
  assert set(got) <= set(ref), (what, set(got) - set(ref))
  scale = max(float(r.norm()) for r in ref.values())
  assert got and scale > 0, what
  for key, r in ref.items():
    if key not in got:
      assert not r.any(), (what, key)
    elif not r.any():
      assert float(got[key].abs().max()) <= 1e-6 * scale, (what, key)
    else:
      assert rel(got[key], r) <= tol, (what, key, rel(got[key], r))


def port_grads(module):
  return {k: p.grad for k, p in module.named_parameters()
          if p.grad is not None}


def test_smooth_min_matches_jax():
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops import math as jmath
  rng = np.random.default_rng(0)
  for v in (rng.normal(size=(16, 40)).astype(np.float32) * 0.2,
            np.full((4, 3), 0.5, np.float32)):      # Σ exp under 1e-4
    ref = np.asarray(jmath.smooth_min(jnp.asarray(v), k=32.0, axis=0))
    got = tmath.smooth_min(torch.from_numpy(v), k=32.0, dim=0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


# ---- the shapes ----

def jax_shape(kind, bounded):
  """The JAX shape, its activated params, and a function of (x [n, 3], c
  [n]) giving its forward, normals and (value, parameter gradient) of
  Σ c·sdf at x, in one jit."""
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.models import sdf as jsdf
  m = jsdf.load_sdf_shape(kind, latent_out=32, bounded=bounded)
  tree = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(3),
                                         jnp.asarray(points(4, 0))))
  tree = activate(tree, 11)
  vg = jax.value_and_grad(lambda p, x, c: jnp.sum(m.apply(p, x)[0] * c))
  fn = jax.jit(lambda p, x, c: (m.apply(p, x),
                                m.apply(p, x, method="normals"),
                                vg(p, x, c)))
  return tree, lambda x, c: jax.tree.map(
      np.asarray, fn(tree, jnp.asarray(x), jnp.asarray(c)))


@pytest.mark.parametrize("bounded", [False, True], ids=["plain", "bounded"])
@pytest.mark.parametrize("kind", KINDS)
def test_shapes_match_jax(kind, bounded):
  x = points(N, 5)
  tree, outputs = jax_shape(kind, bounded)
  shape = tsdf.load_sdf_shape(kind, latent_out=32, bounded=bounded)
  shape.load_state_dict(convert.params_from_flax(tree))
  keep = kink_free(shape, x).numpy()
  assert keep.sum() >= N // 3, keep.sum()
  c = np.random.default_rng(2).normal(size=N).astype(np.float32)
  (sd_j, lat_j), n_j, (val_j, g_j) = outputs(x, c * keep)  # Σ over kept
  with torch.no_grad():
    sd, lat = shape(torch.from_numpy(x))
  np.testing.assert_allclose(sd.numpy(), sd_j, atol=2e-4)
  np.testing.assert_allclose(lat.numpy(), lat_j, atol=2e-4)
  assert lat.shape == (N, 32)

  xk = x[keep]
  n_j = n_j[keep]
  n_t = shape.normals(torch.from_numpy(xk))
  assert n_t.requires_grad                     # differentiable again
  with torch.no_grad():
    n_0 = shape.normals(torch.from_numpy(xk))
  assert not n_0.requires_grad and torch.equal(n_0, n_t.detach())
  assert rel(n_t.detach(), n_j) <= 1e-4, rel(n_t.detach(), n_j)

  val = torch.sum(shape(torch.from_numpy(xk))[0]
                  * torch.from_numpy(c[keep]))
  val.backward()
  assert abs(float(val) - float(val_j)) <= 1e-4 * max(abs(float(val_j)), 1)
  check_grads(port_grads(shape), convert.params_from_flax(g_j),
              what=(kind, bounded))


def test_shape_options_and_bound():
  assert set(tsdf.SDF_KINDS) == set(KINDS)
  with pytest.raises(NotImplementedError, match="unknown sdf kind"):
    tsdf.load_sdf_shape("cube")
  bounded = tsdf.load_sdf_shape("siren", bounded=True, bound_radius=0.5,
                                sphere_init=False, enc_freqs=128)
  assert isinstance(bounded, tsdf.UnitSphere) and bounded.radius == 0.5
  assert not bounded.inner.sphere_init     # the other options stay behind
  far = torch.tensor([[3.0, 0.0, 0.0]])
  assert float(bounded.value(far)) >= 2.5 - 1e-6
  with pytest.raises(TypeError):           # as flax refuses it
    tsdf.load_sdf_shape("curl-mlp", enc_freqs=128)


# ---- the marchers ----

def bumpy_jax(x):
  import jax.numpy as jnp
  return (jnp.linalg.norm(x, axis=-1) - 1.0 + 0.05 * jnp.sin(3 * x[..., 0])
          * jnp.sin(3 * x[..., 1]) * jnp.sin(3 * x[..., 2]))


def bumpy(x):
  return (torch.linalg.vector_norm(x, dim=-1) - 1.0 + 0.05
          * torch.sin(3 * x[..., 0]) * torch.sin(3 * x[..., 1])
          * torch.sin(3 * x[..., 2]))


def scan_clear(sdf_fn, r, near, far, steps, margin=MARGIN):
  """Bool [n]: the rays whose dense scan (`throughput_with_sign_change`'s
  S + 1 points) keeps every value off 0 by `margin` and whose minimum
  leads the runner-up by `margin`: the sign tests and the argmin cannot
  flip between two implementations there."""
  r = torch.as_tensor(r)
  ts = near + ((far - near) / steps) * torch.arange(1, steps + 1,
                                                    dtype=torch.float32)
  ts = torch.cat([torch.tensor([near]), ts])
  with torch.no_grad():
    sd = sdf_fn(r[:, None, :3] + ts[:, None] * r[:, None, 3:6])
  two = torch.topk(sd, 2, dim=-1, largest=False).values
  return ((sd.abs() > margin).all(-1)
          & (two[:, 1] - two[:, 0] > margin))


@functools.lru_cache(maxsize=None)
def jax_marchers():
  import jax
  from nerf_atlas_tpu.ops import march as jmarch
  kw = dict(near=2.0, far=6.0)
  return {
      "scan": jax.jit(lambda o, d: jmarch.throughput_with_sign_change(
          bumpy_jax, o, d, batch_size=SCAN, **kw)),
      "bisect": jax.jit(lambda o, d: jmarch.bisect(bumpy_jax, o, d,
                                                   iters=SCAN, **kw)),
      "secant": jax.jit(lambda o, d: jmarch.secant(bumpy_jax, o, d,
                                                   iters=SCAN, **kw)),
      "sphere": jax.jit(lambda o, d: jmarch.sphere_march(
          bumpy_jax, o, d, iters=SCAN, **kw))}


def test_marchers_match_jax():
  import jax.numpy as jnp
  r = rays(64, 1)
  keep = scan_clear(bumpy, r, 2.0, 6.0, SCAN).numpy()
  assert keep.sum() >= 40, keep.sum()
  o, d = torch.from_numpy(r[:, :3]), torch.from_numpy(r[:, 3:])
  jo, jd = jnp.asarray(r[:, :3]), jnp.asarray(r[:, 3:])
  fns = jax_marchers()
  kw = dict(near=2.0, far=6.0)

  got = tmarch.throughput_with_sign_change(bumpy, o, d, batch_size=SCAN, **kw)
  ref = [np.asarray(a) for a in fns["scan"](jo, jd)]
  tput, best, t_lo, t_hi, hits = (a.detach().numpy() for a in got)
  np.testing.assert_array_equal(hits[keep], ref[4][keep])
  np.testing.assert_array_equal(t_lo[keep], ref[2][keep])
  np.testing.assert_array_equal(t_hi[keep], ref[3][keep])
  np.testing.assert_allclose(best[keep], ref[1][keep], atol=1e-5)
  np.testing.assert_allclose(tput[keep], ref[0][keep], atol=1e-6)
  assert 0 < hits[keep].sum() < keep.sum()       # both hits and misses

  for kind in ("bisect", "secant"):
    got = [a.detach().numpy()
           for a in tmarch.INTERSECTION_KINDS[kind](bumpy, o, d, iters=SCAN,
                                                    **kw)]
    ref = [np.asarray(a) for a in fns[kind](jo, jd)]
    np.testing.assert_array_equal(got[1][keep], ref[1][keep], err_msg=kind)
    for i, atol in ((0, 1e-5), (2, 1e-5), (3, 1e-6)):
      np.testing.assert_allclose(got[i][keep], ref[i][keep], atol=atol,
                                 err_msg=f"{kind} output {i}")
    hit = keep & got[1]
    assert np.abs(bumpy(torch.from_numpy(got[0][hit]))).max() < 1e-5, kind

  seen = []

  def recorded(x):
    v = bumpy(x)
    seen.append(v)
    return v

  got = tmarch.sphere_march(recorded, o, d, iters=SCAN, **kw)
  ref = fns["sphere"](jo, jd)
  assert got[3] is None and ref[3] is None
  ref = [np.asarray(a) for a in ref[:3]]
  clear = keep & ((torch.stack(seen) - 1e-3).abs() > 1e-5).all(0).numpy()
  assert clear.sum() >= 30, clear.sum()
  np.testing.assert_array_equal(got[1].numpy()[clear], ref[1][clear])
  np.testing.assert_allclose(got[0].numpy()[clear], ref[0][clear], atol=1e-4)
  np.testing.assert_allclose(got[2].numpy()[clear], ref[2][clear], atol=1e-4)
  assert set(tmarch.INTERSECTION_KINDS) == {"bisect", "secant", "sphere"}
  with pytest.raises(NotImplementedError):
    tmarch.load_intersection_kind("newton")


def test_scan_jitter_and_gradient_path():
  """The generator jitters the scan's extent by U(0, 2/S); only the
  throughput keeps a graph to the SDF's parameters."""
  o = torch.tensor([[0.0, 0.0, 4.0]])
  d = torch.tensor([[0.0, 0.0, -1.0]])
  shape = tsdf.load_sdf_shape("spheres")
  shape.reset_parameters(torch.Generator().manual_seed(0))
  g = torch.Generator().manual_seed(3)
  _, best, t_lo, t_hi, _ = tmarch.throughput_with_sign_change(
      shape.value, o, d, 2.0, 6.0, batch_size=8, generator=g)
  _, best0, _, _, _ = tmarch.throughput_with_sign_change(
      shape.value, o, d, 2.0, 6.0, batch_size=8)
  assert not torch.equal(best, best0)
  tput, best, _, _, _ = tmarch.throughput_with_sign_change(
      shape.value, o, d, 2.0, 6.0, batch_size=8)
  assert tput.requires_grad and not best.requires_grad
  pts = tmarch.bisection(shape.value, o, d, t_lo, t_hi)
  assert not pts.requires_grad


# ---- the SDF renderer and VolSDF's surface render ----

@functools.lru_cache(maxsize=None)
def jax_sdf(isect):
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  m = jmodels.SDF(sdf_kind="mlp", isect_kind=isect, march_steps=SCAN,
                  t_near=2.0, t_far=6.0, sigmoid_kind="upshifted")
  tree = jax.tree.map(np.asarray, m.init(jax.random.PRNGKey(4),
                                         jnp.asarray(rays(4, 0))))
  tree = activate(tree, 12)
  out_layer = tree["params"]["refl"]["mlp"]["layer_out"]
  out_layer["kernel"] = out_layer["kernel"] * 40.0
  return m, tree, jax.jit(lambda p, r: m.apply(p, r))


def port_sdf(isect, tree):
  model = models.SDF(sdf_kind="mlp", isect_kind=isect, march_steps=SCAN,
                     t_near=2.0, t_far=6.0, sigmoid_kind="upshifted")
  model.load_state_dict(convert.params_from_flax(tree))
  return model


def sphere_clear(sdf_fn, r, near, far, steps, eps=1e-3):
  """Bool [n]: the rays whose sphere march (`march.sphere_march`) keeps
  every step's distance off eps by 1e-5 and its t off far by 1e-4."""
  r = torch.as_tensor(r)
  o, d = r[:, :3], r[:, 3:6]
  seen = []

  def recorded(x):
    v = sdf_fn(x)
    t = ((x - o) * d).sum(-1) / (d * d).sum(-1)
    seen.append(((v - eps).abs() > 1e-5) & ((t - far).abs() > 1e-4))
    return v

  tmarch.sphere_march(recorded, o, d, iters=steps, near=near, far=far)
  return torch.stack(seen).all(0)


def clear_rays(model, value, r, near, far, steps, isect="bisect"):
  """The rays `scan_clear` (or for sphere marching `sphere_clear`) keeps
  whose surface points (the model's out["pts"]) also clear the kinks."""
  out = model(torch.from_numpy(r))
  keep = (sphere_clear if isect == "sphere" else scan_clear)(
      value, r, near, far, steps)
  return (keep & kink_free(model.shape, out["pts"].detach())).numpy(), out


def _shade(mod, x, view):
  """The JAX SDF renderer's shading at given points: (refl rgb, normals,
  sdf)."""
  _, latent = mod.shape(x)
  n = mod.normals(x)
  return mod.refl(x, view=view, normal=n, latent=latent), n, mod.value(x)


@pytest.mark.parametrize("isect", ["bisect", "secant", "sphere"])
def test_sdf_renderer_matches_jax(isect):
  import jax
  import jax.numpy as jnp
  m, tree, fwd = jax_sdf(isect)
  model = port_sdf(isect, tree)
  r = rays(48, 2)
  keep, out = clear_rays(model, model.value, r, 2.0, 6.0, SCAN, isect)
  assert keep.sum() >= 16, keep.sum()
  ref = {k: np.asarray(v) for k, v in fwd(tree, jnp.asarray(r)).items()}
  assert set(out) == set(ref)
  got = {k: v.detach().numpy() for k, v in out.items()}
  np.testing.assert_array_equal(got["hits"][keep], ref["hits"][keep])
  assert 0 < got["hits"][keep].sum() < keep.sum()
  if isect == "sphere":
    np.testing.assert_allclose(got["pts"][keep], ref["pts"][keep], atol=2e-3)
    # the shading held at the port's own end points
    view = r[:, 3:] / np.linalg.norm(r[:, 3:], axis=-1, keepdims=True)
    rgb, n, val = (np.asarray(a) for a in jax.jit(
        lambda p, x, v: m.apply(p, x, v, method=_shade))(
            tree, jnp.asarray(got["pts"]), jnp.asarray(view)))
    logit = -500.0 * val[:, None]
    sig = 1 / (1 + np.exp(-logit.astype(np.float64)))
    ref.update(rgb=np.where(got["hits"][:, None], rgb, 0.0), normals=n,
               sil_logit=logit, throughput=sig, weights=sig,
               pts=got["pts"])
  tol = {"pts": 1e-5, "rgb": 2e-4, "sil_logit": 500 * 2e-6,
         "throughput": 500 * 2e-6 / 4, "weights": 500 * 2e-6 / 4}
  for key, atol in tol.items():
    np.testing.assert_allclose(got[key][keep], ref[key][keep], atol=atol,
                               err_msg=f"{isect} {key}")
  assert rel(got["normals"][keep], ref["normals"][keep]) <= 1e-4
  assert float(np.abs(got["rgb"][~got["hits"]]).max(initial=0)) == 0.0


def test_volsdf_surface_render_matches_jax():
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  jm = jmodels.VolSDF(sdf_kind="mlp", steps=16, t_near=2.0, t_far=6.0,
                      sigmoid_kind="upshifted")
  r = rays(48, 3)
  tree = activate(jax.tree.map(np.asarray, jm.init(
      {"params": jax.random.PRNGKey(6), "sampler": jax.random.PRNGKey(7)},
      jnp.asarray(r[:4]), train=True)), 13)
  out_layer = tree["params"]["refl"]["mlp"]["layer_out"]
  out_layer["kernel"] = out_layer["kernel"] * 40.0
  ref = {k: np.asarray(v) for k, v in jax.jit(
      lambda p, x: jm.apply(p, x, method="surface_render"))(
          tree, jnp.asarray(r)).items()}
  model = models.VolSDF(steps=16, sigmoid_kind="upshifted")
  model.load_state_dict(convert.params_from_flax(tree))
  out = model.surface_render(torch.from_numpy(r))
  assert set(out) == set(ref) == {"rgb", "hits", "throughput"}
  keep = scan_clear(model.sdf_value, r, 2.0, 6.0, 32).numpy()
  assert keep.sum() >= 24, keep.sum()
  got = {k: v.detach().numpy() for k, v in out.items()}
  np.testing.assert_array_equal(got["hits"][keep], ref["hits"][keep])
  assert 0 < got["hits"][keep].sum() < keep.sum()
  np.testing.assert_allclose(got["rgb"][keep], ref["rgb"][keep], atol=2e-4)
  np.testing.assert_allclose(got["throughput"][keep],
                             ref["throughput"][keep], atol=500 * 2e-6 / 4)
  assert got["throughput"].shape == (48, 1)


# ---- the regularizers ----

def test_surface_eikonal_matches_jax():
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu.train import regularizers as jreg
  rng = np.random.default_rng(4)
  for n_shape, w_shape in (((6, 8, 3), (6, 8)), ((6, 3), (6, 1))):
    n = rng.normal(size=n_shape).astype(np.float32)
    w = rng.uniform(0, 1, w_shape).astype(np.float32)
    val_j, (gn_j, gw_j) = jax.value_and_grad(
        lambda a, b: jreg.surface_eikonal({"normals": a, "weights": b}),
        argnums=(0, 1))(jnp.asarray(n), jnp.asarray(w))
    nt = torch.from_numpy(n).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    val = regularizers.surface_eikonal({"normals": nt, "weights": wt})
    val.backward()
    assert abs(float(val) - float(val_j)) <= 1e-6 * abs(float(val_j))
    assert rel(nt.grad, np.asarray(gn_j)) <= 1e-5
    gw_j = np.asarray(gw_j)
    if gw_j.any():
      assert rel(wt.grad, gw_j) <= 1e-5
    else:       # [N, 1] weights: Σ w·Σ ei / Σ w does not depend on them
      assert float(wt.grad.abs().max()) <= 1e-6
  assert regularizers.surface_eikonal({}) == 0.0
  assert regularizers.REGULARIZERS["surface_eikonal"] is (
      regularizers.surface_eikonal)


# (name, kwargs of the JAX term and the port's draws/term, the model)
REG_CASES = {
    "smooth_normals-2": ("smooth_normals", {"eps": 1e-2}, "volsdf"),
    "smooth_normals-1-2-rng": ("smooth_normals",
                               {"eps": 0.05, "eps_rng": True,
                                "ords": (1, 2)}, "volsdf"),
    "smooth_surface": ("smooth_surface", {"eps": 1e-2}, "volsdf"),
    "eikonal_random": ("eikonal_random", {}, "volsdf"),
    "smooth_normals-spheres": ("smooth_normals", {"eps": 1e-2}, "spheres"),
}
REG_POINTS = 64


@functools.lru_cache(maxsize=None)
def jax_reg_model(which):
  import jax
  import jax.numpy as jnp
  from nerf_atlas_tpu import models as jmodels
  if which == "volsdf":
    m = jmodels.VolSDF(sdf_kind="mlp", steps=16)
    tree = m.init({"params": jax.random.PRNGKey(8),
                   "sampler": jax.random.PRNGKey(9)},
                  jnp.asarray(rays(4, 0)), train=True)
  else:
    m = jmodels.SDF(sdf_kind="spheres", march_steps=8)
    tree = m.init(jax.random.PRNGKey(8), jnp.asarray(rays(4, 0)))
  return m, activate(jax.tree.map(np.asarray, tree), 14)


def jax_draws(name, key, kw):
  """The JAX term's own draws at `key` (train/regularizers.py:157-200)."""
  import jax
  from nerf_atlas_tpu.train import regularizers as jreg
  if name == "eikonal_random":
    return (jax.random.uniform(key, (REG_POINTS, 3), minval=-1.5,
                               maxval=1.5),)
  k1, k2 = jax.random.split(key)
  return (jax.random.uniform(k1, (REG_POINTS, 3), minval=-1, maxval=1),
          jreg._perturbation(k2, REG_POINTS, kw.get("eps", 1e-2),
                             kw.get("eps_rng", False)))


@pytest.mark.parametrize("case", list(REG_CASES))
def test_point_regularizers_match_jax(case):
  import jax
  from nerf_atlas_tpu.train import regularizers as jreg
  name, kw, which = REG_CASES[case]
  jm, tree = jax_reg_model(which)
  port = (models.VolSDF(steps=16) if which == "volsdf"
          else models.SDF(sdf_kind="spheres", march_steps=8))
  port.load_state_dict(convert.params_from_flax(tree))
  key = jax.random.PRNGKey(21)
  draws = [torch.from_numpy(np.array(a)) for a in jax_draws(name, key, kw)]
  keep = kink_free(port.shape, draws[0])
  if len(draws) > 1:
    keep &= kink_free(port.shape, draws[0] + draws[1])
  idx = np.flatnonzero(keep.numpy())
  assert idx.size >= REG_POINTS // 3, idx.size

  def apply_kept(p, x, *args, method=None, **kwargs):
    return jm.apply(p, x[idx], *args, method=method, **kwargs)

  val_j, g_j = jax.jit(jax.value_and_grad(
      lambda p: jreg.POINT_REGULARIZERS[name](apply_kept, p, key,
                                              n=REG_POINTS, **kw)))(tree)
  ref = convert.params_from_flax(jax.tree.map(np.asarray, g_j))
  term = regularizers.POINT_REGULARIZERS[name][1]
  ords = {"ords": kw["ords"]} if "ords" in kw else {}
  val = term(port, *(d[idx] for d in draws), **ords)
  val.backward()
  assert abs(float(val) - float(val_j)) <= 1e-5 * abs(float(val_j)), (
      float(val), float(val_j))
  check_grads(port_grads(port), ref, what=case)


def test_point_regularizer_draws_and_options():
  g = torch.Generator().manual_seed(0)
  pts, delta = regularizers.smooth_draws(g, 100, eps=0.1)
  assert pts.shape == delta.shape == (100, 3)
  assert float(pts.abs().max()) <= 1.0
  np.testing.assert_allclose(delta.norm(dim=-1).numpy(), 0.1, rtol=1e-5)
  _, delta = regularizers.smooth_draws(g, 100, eps=0.1, eps_rng=True)
  radii = delta.norm(dim=-1)
  assert float(radii.max()) <= 0.1 and float(radii.std()) > 0.01
  (pts,) = regularizers.eikonal_draws(g, 100)
  assert 1.0 < float(pts.abs().max()) <= 1.5
  model = models.VolSDF(steps=8)
  model.reset_parameters(torch.Generator().manual_seed(0))
  coeffs = {"smooth_normals": 1.0, "smooth_surface": 2.0,
            "eikonal_random": 3.0}
  opts = {"eps": 1e-3, "eps_rng": False, "ords": (1,)}
  got = regularizers.point_regularizers(
      model, torch.Generator().manual_seed(5), coeffs, opts)
  g = torch.Generator().manual_seed(5)
  want = (regularizers.smooth_normals(
              model, *regularizers.smooth_draws(g, eps=1e-3), ords=(1,))
          + 2.0 * regularizers.smooth_surface(
              model, *regularizers.smooth_draws(g, eps=1e-3))
          + 3.0 * regularizers.eikonal_random(
              model, *regularizers.eikonal_draws(g)))
  assert float(got) == pytest.approx(float(want), rel=1e-6)
