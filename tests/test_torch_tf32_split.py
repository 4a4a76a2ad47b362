"""Split TF32 (the tensor-core products of K2/K3, csrc/mma_tf32.cuh) held
to the K2/K3 gates on the CPU.

K2/K3 run every MLP product (the forward's recompute, the input and the
weight gradients) as three TF32 products per float32 product: hi·hi +
hi·lo + lo·hi of hi = tf32(x), lo = tf32(x − hi). That is not float32-
exact: each term carries up to ~3·2^-22 of |ab| where a float32 FMA
carries 2^-24. These tests run the plain K3 (`plain_cp_train_step` on
CPU rays: autograd through the plain K1) with every MLP product through
`testing.split_tf32_matmul` (put in place of `render._matmul` by
monkeypatch, so the plain version itself gains no switch) and hold it to
the float32 plain K3 with PERF.md §2's K2/K3 gates: loss 1e-5 relative,
each of the gradient tensors 1e-4 relative (‖Δ‖/‖ref‖) on the rays clear
of leaky-relu kinks (`testing.kink_free_rays` with chip_smoke.py's
margin 10; the other rays get a zero cotangent), at full width, 256 rays
× 64 steps, for cp and posenc, seeded and amplified weights. Also: the
TF32 rounding is round-to-nearest with ties away from zero, and the
split's error bound, in two parts and in three.

K9b and K8b (csrc/render_dyn_bwd.cu, render_volsdf_bwd.cu) run the same
products; the emulation is differentiable twice (its backward products
are the emulation again), so VolSDF's eikonal, a gradient of a gradient,
runs through it too. The plain K9b (cp Δx, cp spline S = 4 with the dp²
term, posenc Δx) and K8b are held to the same gates at 256 rays × 64 on
the rays the kink rules clear, given alone (the dp² and the eikonal
terms reach every ray they are given). K8b's SDF MLP runs its forward
products in three parts (`testing.k8b_split_tf32_mlp`), as the kernel
does: with the eikonal over all 4096 rays of chip_smoke.py's check (its
L2 term on the kink-free rays), the recompute's rounding decides the
act′ of points within round-off of the kink on the other rays: with two
parts the gradient reads 1.07e-4 from the float32 plain version, with
three 1.03e-4, with float64 products rounded once 9.62e-5, the float32
floor (`test_k8b_eikonal_floor_is_the_recompute`, `slow`); there the
split is held to a float64 witness as the float32 plain version is.
K9b's one-element output biases under the posenc canonical at 4096 rays
sit at float32's own floor whatever the products' precision
(`test_k9b_posenc_floor_is_float32`, `slow`). The emulation takes each
MLP's parts from the kernel's TC pack list (`testing.split_tf32_mlp`).
The layout of the TC pack is checked for K2/K3's, NeRFAE's, VolSDF's and
the four D-NeRF layouts.

K1 (csrc/render_fwd.cu) runs its forward products by wgmma in the same
split: the plain K1 so computed holds K1's 1e-4 abs gate in all six
modes, on shared and per-ray ts and on its weights output, and K1's
wgmma pack gives back each layer's Wᵀ as its hi and lo parts. K7b
(csrc/render_ae_bwd.cu) runs its products as K8b does, the encoder's and
density_tfm's forward in three parts (`testing.k7b_split_tf32_mlp`):
the plain K7b so computed holds K7b's gates on the kink-free rays; at
4096 rays every part assignment does (`test_k7b_parts_by_group`,
`slow`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nerf_atlas_tpu_torch import testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_ae as k7  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render_dyn as k9  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import (  # noqa: E402
    render_volsdf as k8)

STEPS = 64
N = 256
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
KINK_MARGIN = 10.0


def test_tf32_round_is_nearest_ties_away():
  ulp = 2.0 ** -10                       # TF32's ulp at [1, 2)
  x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + ulp,
                    -(1 + ulp / 2), 1 + 1.5 * ulp, 3.0, 0.0, -0.0,
                    float("inf"), -float("inf")])
  want = [1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp), 1 + 2 * ulp, 3.0, 0.0,
          -0.0, float("inf"), -float("inf")]
  assert k1.tf32_round(x).tolist() == want
  assert torch.isnan(k1.tf32_round(torch.tensor([float("nan")]))).all()


def test_split_error_bound():
  """x − (hi + lo) ≤ 2^-22·|x|, hi and lo TF32 values; the three-product
  matmul sits within 3·2^-22·Σ|a||b| of float64."""
  gen = torch.Generator().manual_seed(0)
  x = torch.randn(100000, generator=gen) * torch.exp(
      torch.randn(100000, generator=gen) * 4)
  hi, lo = k1.tf32_split(x)
  for part in (hi, lo):
    assert torch.equal(k1.tf32_round(part), part)
  err = (x.double() - hi.double() - lo.double()).abs()
  assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
  a = torch.randn(64, 256, generator=gen)
  b = torch.randn(256, 96, generator=gen)
  got = testing.split_tf32_matmul(a, b).double()
  exact = a.double() @ b.double()
  scale = a.double().abs() @ b.double().abs()
  # the products' error plus float32 summation over 256 terms
  assert bool(((got - exact).abs() <= (3 * 2.0 ** -22 + 256 * 2.0 ** -24)
               * scale).all())
  # three parts: x − (hi + mid + lo) ≤ 2^-33·|x|, the dropped products ≤
  # ~3·2^-33 of |ab|, so the float32 sums dominate
  parts = testing._split3(x)
  for part in parts:
    assert torch.equal(k1.tf32_round(part), part)
  err = (x.double() - sum(p.double() for p in parts)).abs()
  assert bool((err <= 2.0 ** -33 * x.double().abs()).all())
  got3 = testing.split_tf32_matmul_fwd3(a, b).double()
  assert bool(((got3 - exact).abs() <= (4 * 2.0 ** -33 + 256 * 2.0 ** -24)
               * scale).all())


def test_split_second_order_within_bound():
  """The gradient of a gradient through the emulation (an MLP's input
  gradient squared, differentiated by the weights, as VolSDF's eikonal
  is) sits within the split's error of float64: each of the four
  products on its path (the forward, the input gradient, and that
  one's two adjoints) carries ≤ ~3·2^-22 relative, so ‖Δ‖/‖ref‖ ≤
  16·2^-22; the first derivative is the same bits as without the graph."""
  gen = torch.Generator().manual_seed(4)
  a = torch.randn(64, 48, generator=gen)
  w1 = (torch.randn(48, 96, generator=gen) / 7).requires_grad_(True)
  w2 = (torch.randn(96, 8, generator=gen) / 10).requires_grad_(True)
  for product in (testing.split_tf32_matmul, testing.split_tf32_matmul_fwd3):
    x = a.clone().requires_grad_(True)
    y = product(torch.nn.functional.leaky_relu(product(x, w1), 0.01), w2)
    (gx,) = torch.autograd.grad(y[:, 0].sum(), x, create_graph=True)
    (gx_once,) = torch.autograd.grad(
        product(torch.nn.functional.leaky_relu(product(x, w1), 0.01),
                w2)[:, 0].sum(), x)
    assert torch.equal(gx.detach(), gx_once)
    g1, g2 = torch.autograd.grad((gx ** 2).sum(), (w1, w2))
    x64, v1, v2 = (t.detach().double().requires_grad_(True)
                   for t in (a, w1, w2))
    y64 = torch.nn.functional.leaky_relu(x64 @ v1, 0.01) @ v2
    (gx64,) = torch.autograd.grad(y64[:, 0].sum(), x64, create_graph=True)
    r1, r2 = torch.autograd.grad((gx64 ** 2).sum(), (v1, v2))
    for got, ref in ((g1, r1), (g2, r2)):
      assert float((got.double() - ref).norm() / ref.norm()) <= 16 * 2.0 ** -22


def _rays(n, seed):
  """Rays from a sphere of radius 4 aimed near the origin, through the CP
  box (chip_smoke.py's check rays)."""
  rng = np.random.default_rng(seed)
  o = rng.normal(size=(n, 3))
  o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
  d = -o / 4.0 + rng.normal(size=(n, 3)) * 0.15
  return torch.from_numpy(np.concatenate([o, d], -1).astype(np.float32))


def _weights(enc_kind, amplified):
  from nerf_atlas_tpu_torch import models
  from nerf_atlas_tpu_torch.train import driver
  sd = dict(driver.init_model(models.PlainNeRF(steps=STEPS,
                                               enc_kind=enc_kind),
                              seed=0).state_dict())
  if amplified:
    sd["refl.mlp.layer_out.weight"] = sd["refl.mlp.layer_out.weight"] * 40.0
    sd["density_mlp.layer_out.weight"] = (
        sd["density_mlp.layer_out.weight"] * 8.0)
  return k1.pack_weights(sd, enc_kind=enc_kind)


def _rel(a, b):
  ua, ub = k1.unpack_grads(a), k1.unpack_grads(b)
  return max(float((ua[k] - ub[k]).norm() / ub[k].norm()) for k in ub)


@pytest.mark.parametrize("enc_kind", ["cp", "posenc"])
@pytest.mark.parametrize("amplified", [False, True])
def test_plain_k3_split_tf32_within_k3_gates(monkeypatch, enc_kind,
                                             amplified):
  ws = _weights(enc_kind, amplified)
  rays = _rays(N, 1)
  gen = torch.Generator().manual_seed(2)
  ts = torch.sort(torch.rand(STEPS, generator=gen) * 4 + 2).values
  kw = dict(steps=STEPS, ts=ts, enc_kind=enc_kind, sky_kind="white",
            sigmoid_kind="thin")
  keep = testing.kink_free_rays(ws, rays, ts, STEPS, KINK_MARGIN,
                                enc_kind=enc_kind)
  assert int(keep.sum()) >= N // 4
  out = k1.plain_cp_render_reference(ws, rays, **kw)[:, :3]
  target = torch.rand(N, 3, generator=gen)
  masked = torch.where(keep[:, None], target, out).contiguous()
  loss_f32, _ = k1.plain_cp_train_step(ws, rays, target, **kw)
  _, grad_f32 = k1.plain_cp_train_step(ws, rays, masked, **kw)
  monkeypatch.setattr(k1, "_matmul", testing.split_tf32_matmul)
  loss_tc, _ = k1.plain_cp_train_step(ws, rays, target, **kw)
  _, grad_tc = k1.plain_cp_train_step(ws, rays, masked, **kw)
  assert not torch.equal(grad_tc, grad_f32)        # the emulation ran
  assert abs(float(loss_tc - loss_f32)) <= LOSS_RTOL * float(loss_f32)
  assert _rel(grad_tc, grad_f32) <= GRAD_RTOL


def _pad16(n):
  return -(-n // 16) * 16


def _skip_at(i, nl):
  return i % 3 == 0 and i != nl - 1


def _tc_layouts():
  """(name, its MLPs (render.TCMlps), packed weight count): K2/K3's six,
  NeRFAE's (K7b), VolSDF's and the four D-NeRF layouts."""
  out = [(e, k1.tc_mlps(e), k1.LAYOUTS[e].weight_count)
         for e in k1.ENC_KINDS]
  out.append(("ae", k7.TC_MLPS, k7.WEIGHT_COUNT))
  out.append(("volsdf", k8.TC_MLPS, k8.WEIGHT_COUNT))
  for (enc, warp), lay in k9.LAYOUTS.items():
    out.append((f"dyn-{enc}-{warp}", lay.tc_mlps, lay.weight_count))
  return out


@pytest.mark.parametrize("name,mlps,count", _tc_layouts(),
                         ids=[t[0] for t in _tc_layouts()])
def test_tc_pack_layout(name, mlps, count):
  """`render.tc_pack_mlps`, read at the offsets csrc/mma_tf32.cuh computes
  (`tc_offset`: per MLP and Dense layer the forward block [kh ‖ kf
  rows][out], then [out][kh] and [out][kf]; 16-deep slices, hi then lo,
  in mma fragment order; an MLP whose forward runs in three parts has
  its forward blocks raw, one part per slice), gives back each layer's W
  in its forward block and Wᵀ in its input-gradient blocks, as hi + lo
  within 2^-22 (raw: exactly), with zeros in the padding. K2/K3's pack is
  `render.tc_pack`, the bytes render_bwd.cu reads since it was written."""
  gen = torch.Generator().manual_seed(3)
  ws = torch.randn(count, generator=gen)
  pack = k1.tc_pack_mlps(ws, mlps)
  if name in k1.ENC_KINDS:
    assert torch.equal(pack, k1.tc_pack(ws, name))

  def block(off, k, m, parts=2):
    """The block at `off` as [pad16(k)][pad16(m)] (fragment order: per
    16-deep slice its parts, each [k-step][m-tile][lane][4] holding
    A[16mt + g + 8(j % 2)][8kk + t + 4(j // 2)], g = lane // 4, t = lane
    % 4), summed over its parts, and the block's end."""
    kp, mp = _pad16(k), _pad16(m)
    b = pack[off:off + parts * kp * mp].view(kp // 16, parts, 2, mp // 16,
                                             32, 4)
    b = b.double().sum(dim=1)
    s, kk, mt, lane, j = torch.meshgrid(
        *[torch.arange(n) for n in b.shape], indexing="ij")
    out = torch.zeros(kp, mp, dtype=torch.float64)
    out[16 * s + 8 * kk + lane % 4 + 4 * (j // 2),
        16 * mt + lane // 4 + 8 * (j % 2)] = b
    return out, off + parts * kp * mp

  def close(got, want, exact=False):
    if exact:
      assert torch.equal(got, want)
    else:
      assert bool(((got - want).abs() <= 2.0 ** -22 * want.abs()).all())

  off = 0
  for pos, layers, three in mlps:
    nl = len(layers) - 2
    for j, (_, n_in, n_out) in enumerate(layers):
      w = ws[pos:pos + n_in * n_out].view(n_in, n_out).double()
      pos += n_in * n_out + n_out
      kh = 0 if j == 0 else layers[0][2]
      kf = n_in - kh
      assert kf == (n_in if j == 0 else
                    (kf if 1 <= j <= nl and _skip_at(j - 1, nl) else 0))
      fwd, off = block(off, _pad16(kh) + kf, n_out, 1 if three else 2)
      close(fwd[:kh, :n_out], w[:kh], three)
      close(fwd[_pad16(kh):_pad16(kh) + kf, :n_out], w[kh:], three)
      assert float(fwd[kh:_pad16(kh)].abs().sum()) == 0.0
      assert float(fwd[_pad16(kh) + kf:].abs().sum()) == 0.0
      assert float(fwd[:, n_out:].abs().sum()) == 0.0
      for part in (w[:kh], w[kh:]):
        if part.shape[0]:
          bwd, off = block(off, n_out, part.shape[0])
          close(bwd[:n_out, :part.shape[0]], part.t())
          assert float(bwd.abs().sum() - bwd[:n_out, :part.shape[0]].abs()
                       .sum()) == 0.0
  assert off == pack.numel()


# ---- K1 (csrc/render_fwd.cu on wgmma) and its wgmma pack ----

K1_TOL = 1e-4
K1_MODES = ("cp", "hash", "posenc", "tiny", "cone", "cylinder")


def _k1_weights(mode):
  """Seeded full-width weights of a K1 mode with chip_smoke.py's
  amplification: rgb's output layer ×40 and density's ×8 (tiny: the rows
  of its one layer_out), so that rgb spans (0, 1) and density varies."""
  from nerf_atlas_tpu_torch import models
  from nerf_atlas_tpu_torch.train import driver
  if mode == "tiny":
    model = models.TinyNeRF(steps=STEPS)
  elif mode in k1.MIP_KINDS:
    model = models.PlainNeRF(steps=STEPS, mip=mode)
  else:
    model = models.PlainNeRF(steps=STEPS, enc_kind=mode)
  sd = dict(driver.init_model(model, seed=0).state_dict())
  if mode == "tiny":
    w = sd["mlp.layer_out.weight"]
    sd["mlp.layer_out.weight"] = torch.cat([w[:1] * 8.0, w[1:] * 40.0])
  else:
    sd["refl.mlp.layer_out.weight"] = sd["refl.mlp.layer_out.weight"] * 40.0
    sd["density_mlp.layer_out.weight"] = (
        sd["density_mlp.layer_out.weight"] * 8.0)
  return k1.pack_weights(sd, enc_kind=mode)


@pytest.mark.parametrize("per_ray", [False, True], ids=["shared-ts",
                                                         "per-ray-ts"])
@pytest.mark.parametrize("mode", K1_MODES)
def test_plain_k1_split_tf32_within_k1_gate(monkeypatch, mode, per_ray):
  """The plain K1 with every MLP product in split TF32 (`render._matmul`
  through `testing.split_tf32_matmul`: the products K1's wgmma forms,
  lo·hi + hi·lo + hi·hi of activations and weights) against itself in
  float32, in each of the six modes, on a jittered shared ts [T] or each
  ray's own sorted ts [N, T]: rgb and acc within K1's gate (1e-4 abs),
  and the compositing weights (the weights output CoarseFineNeRF samples
  from) too, at full width, 256 rays × 64 steps, white sky."""
  ws = _k1_weights(mode)
  rays = _rays(N, 3)
  gen = torch.Generator().manual_seed(4)
  if per_ray:
    ts = torch.sort(torch.rand(N, STEPS, generator=gen) * 4 + 2).values
  else:
    ts = torch.sort(torch.rand(STEPS, generator=gen) * 4 + 2).values
  kw = dict(steps=STEPS, ts=ts, sky_kind="white", sigmoid_kind="normal",
            want_weights=True)
  if mode == "hash":
    feats = torch.rand(N * STEPS, 16, generator=gen) * 2 - 1
    run = lambda: k1._plain_render(  # noqa: E731
        ws, rays, feats, "hash", t_near=2.0, t_far=6.0, **kw)
  else:
    run = lambda: k1.plain_cp_render_reference(  # noqa: E731
        ws, rays, enc_kind=mode, **kw)
  out_f32, w_f32 = run()
  monkeypatch.setattr(k1, "_matmul", testing.split_tf32_matmul)
  out_tc, w_tc = run()
  assert not torch.equal(out_tc, out_f32)          # the emulation ran
  assert float(out_f32[:, :3].std()) > 0.05        # rgb varies
  e_out = float((out_tc - out_f32).abs().max())
  e_w = float((w_tc - w_f32).abs().max())
  print(f"K1-{mode} {'per-ray' if per_ray else 'shared'} ts: out {e_out:.3e}, "
        f"weights {e_w:.3e}")
  assert e_out <= K1_TOL and e_w <= K1_TOL


def test_k1_float64_witness_is_the_plain_render():
  """`testing.k1_float64_render` (chip_smoke.py holds each K1 line to it)
  is the plain K1 with float64 products: float64 out, within K1's gate of
  the float32 plain version, not equal to it, and `render._matmul` put
  back."""
  ws = _k1_weights("cone")
  rays = _rays(32, 7)
  kw = dict(steps=16, sky_kind="white", sigmoid_kind="tanh",
            enc_kind="cone")
  ref = k1.plain_cp_render_reference(ws, rays, **kw)
  w64 = testing.k1_float64_render(ws, rays, **kw)
  assert w64.dtype == torch.float64 and k1._matmul is torch.matmul
  assert 0.0 < float((w64 - ref.double()).abs().max()) <= K1_TOL


def _pad8(n):
  return -(-n // 8) * 8


@pytest.mark.parametrize("mode", K1_MODES)
def test_wgmma_pack_layout(mode):
  """`render.wgmma_pack`, read at the offsets csrc/wgmma_tf32.cuh computes
  (`layer_offset`: per MLP and Dense layer [pad16(kh) + pad16(kf)][pad8(
  out)] hi and lo; per sub-product of `sub_n(out)` outputs and 16-deep
  slice a unit of hi then lo, each [k-chunk][n-group][8 n][4 k]: the core
  matrices of wgmma's K-major layout without swizzle), gives back each
  layer's Wᵀ [out][in] as its TF32 hi and lo parts (hi = tf32(w), lo =
  tf32(w − hi)), with zeros in the padding."""
  count = k1.LAYOUTS[mode].weight_count
  gen = torch.Generator().manual_seed(5)
  ws = torch.randn(count, generator=gen)
  pack = k1.wgmma_pack(ws, mode)

  def block(off, k, n):
    """The hi and lo parts of the block at `off` as Bᵀ [pad8(n)][k], and
    the block's end."""
    np_, ns = _pad8(n), min(_pad8(n), 64)
    b = pack[off:off + 2 * k * np_].view(np_ // ns, k // 16, 2, 4, ns // 8,
                                          8, 4)
    sub, s, part, kc, ng, r, c = torch.meshgrid(
        *[torch.arange(x) for x in b.shape], indexing="ij")
    out = torch.zeros(2, np_, k)
    out[part, ns * sub + 8 * ng + r, 16 * s + 4 * kc + c] = b
    return out[0], out[1], off + 2 * k * np_

  off = 0
  for pos, layers, _ in k1.tc_mlps(mode):
    nl = len(layers) - 2
    for j, (_, n_in, n_out) in enumerate(layers):
      w = ws[pos:pos + n_in * n_out].view(n_in, n_out)
      pos += n_in * n_out + n_out
      kh = 0 if j == 0 else layers[0][2]
      kf = n_in - kh
      assert kf == (n_in if j == 0 else
                    (kf if 1 <= j <= nl and _skip_at(j - 1, nl) else 0))
      hi, lo, off = block(off, _pad16(kh) + _pad16(kf), n_out)
      want_hi, want_lo = k1.tf32_split(w.t().contiguous())
      for got, want in ((hi, want_hi), (lo, want_lo)):
        assert torch.equal(got[:n_out, :kh], want[:, :kh])
        assert torch.equal(got[:n_out, _pad16(kh):_pad16(kh) + kf],
                           want[:, kh:])
        assert float(got[:, kh:_pad16(kh)].abs().sum()) == 0.0
        assert float(got[:, _pad16(kh) + kf:].abs().sum()) == 0.0
        assert float(got[n_out:].abs().sum()) == 0.0
  assert off == pack.numel()


# ---- K7b (csrc/render_ae_bwd.cu) ----

def _ae_case(n, seed=0):
  """A NeRFAE at full width, its View's output layer ×40 and
  density_tfm's ×8 (chip_smoke.py's amplified check weights), rays
  through the CP box, a jittered ts, and the rays
  `testing.ae_kink_free_rays` clears (chip_smoke.py's margin)."""
  from nerf_atlas_tpu_torch import models
  from nerf_atlas_tpu_torch.train import driver
  sd = dict(driver.init_model(models.NeRFAE(steps=STEPS), seed=0)
            .state_dict())
  sd["refl.mlp.layer_out.weight"] = sd["refl.mlp.layer_out.weight"] * 40.0
  sd["density_tfm.layer_out.weight"] = (
      sd["density_tfm.layer_out.weight"] * 8.0)
  ws = k7.pack_weights_ae(sd)
  rays = _rays(n, seed)
  gen = torch.Generator().manual_seed(6)
  ts = torch.sort(torch.rand(STEPS, generator=gen) * 4 + 2).values
  keep = testing.ae_kink_free_rays(ws, rays, ts, STEPS, KINK_MARGIN)
  assert int(keep.sum()) >= n // 16
  return ws, rays, ts, keep, gen


@pytest.mark.parametrize("mode", ["G", "L"])
@pytest.mark.parametrize("sky,kind", [("white", "thin"), ("black", "normal")])
def test_plain_k7b_split_tf32_within_k7b_gates(monkeypatch, mode, sky, kind):
  """The plain K7b (autograd through the plain K7f) with its three MLPs'
  products in split TF32 as K7b runs them (`testing.k7b_split_tf32_mlp`:
  the encoder's and density_tfm's forward in three parts, the View's in
  two, from `render_ae.TC_MLPS`), against itself in float32, on the
  kink-free rays (the others get a zero cotangent, as chip_smoke.py
  checks K7b): mode G (random g) and mode L (random target; loss 1e-5
  relative), each gradient tensor 1e-4 (‖Δ‖/‖ref‖)."""
  ws, rays, ts, keep, gen = _ae_case(N)
  kw = dict(steps=STEPS, ts=ts, sky_kind=sky, sigmoid_kind=kind)
  if mode == "G":
    arg = torch.randn(N, 4, generator=gen) * keep[:, None]
    run = lambda: (None, k7.ae_render_grad_reference(  # noqa: E731
        ws, rays, arg, **kw))
  else:
    out = k7.ae_render_reference(ws, rays, **kw)[:, :3]
    arg = torch.where(keep[:, None], torch.rand(N, 3, generator=gen), out)
    run = lambda: k7.ae_train_step_reference(ws, rays, arg,  # noqa: E731
                                             **kw)
  loss_f32, grad_f32 = run()
  monkeypatch.setattr(k1, "_mlp", testing.k7b_split_tf32_mlp(k1._mlp))
  loss_tc, grad_tc = run()
  assert not torch.equal(grad_tc, grad_f32)        # the emulation ran
  if mode == "L":
    assert abs(float(loss_tc - loss_f32)) <= LOSS_RTOL * float(loss_f32)
  errs = _rel_errs(k7.unpack_grads_ae, grad_tc, grad_f32)
  print(f"K7b-{mode} sky {sky} {kind}: worst tensor "
        f"{max(errs.values()):.3e} ({int(keep.sum())} kink-free rays)")
  assert max(errs.values()) <= GRAD_RTOL, max(errs.items(),
                                              key=lambda kv: kv[1])


@pytest.mark.slow
def test_k7b_parts_by_group(monkeypatch):
  """Which of K7b's MLPs need their forward products in three parts, at
  chip_smoke.py's 4096 rays × 64: the plain K7b in both modes with each
  assignment of two or three parts to (encoder, density_tfm, View) against
  the float32 plain version on the kink-free rays; every assignment holds
  the gates (`-s` prints the distances), so the emulation does not decide
  between them: `render_ae.TC_MLPS` keeps three on the leaky MLPs, whose
  recompute sets the backward's slopes, as K9b's do."""
  n = 4096
  ws, rays, ts, keep, gen = _ae_case(n)
  kw = dict(steps=STEPS, ts=ts, sky_kind="white", sigmoid_kind="thin")
  g = torch.randn(n, 4, generator=gen) * keep[:, None]
  out = k7.ae_render_reference(ws, rays, **kw)[:, :3]
  target = torch.where(keep[:, None], torch.rand(n, 3, generator=gen), out)

  def run():
    return (k7.ae_train_step_reference(ws, rays, target, **kw)[1],
            k7.ae_render_grad_reference(ws, rays, g, **kw))

  ref = run()
  orig = k1._mlp
  for flags in ((False, False, False), (True, False, False),
                (False, True, False), (True, True, False),
                (True, True, True)):
    mlps = tuple((pos, grp, f) for (pos, grp, _), f in zip(k7.TC_MLPS,
                                                           flags))
    monkeypatch.setattr(k1, "_mlp", testing.split_tf32_mlp(orig, mlps))
    got = run()
    monkeypatch.setattr(k1, "_mlp", orig)
    worst = [max(_rel_errs(k7.unpack_grads_ae, a, b).values())
             for a, b in zip(got, ref)]
    print(f"three parts (encoder, density_tfm, View) {flags}: L "
          f"{worst[0]:.3e}, G {worst[1]:.3e} ({int(keep.sum())} kink-free "
          f"rays)")
    assert max(worst) <= GRAD_RTOL


# ---- K9b and K8b ----

def _dyn_case(enc, spline, n, seed=2, chunk=None):
  """A DynamicNeRF at full width with the warp active (its zero layer_out
  replaced by seeded 0.03·N(0, 1) weights and 0.01·N(0, 1) biases) and
  the View's output layer amplified by 40, as chip_smoke.py checks K9b;
  rays from (0, 0, 3.5) about −z with times in [0, 1), jittered ts; the
  rays `testing.dyn_kink_free_rays` clears, alone."""
  from nerf_atlas_tpu_torch import models
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  from nerf_atlas_tpu_torch.train import driver
  sd = dict(driver.init_model(models.DynamicNeRF(
      canonical_kwargs={"enc_kind": enc}, spline_points=spline,
      steps=STEPS), seed=0).state_dict())
  rng = np.random.default_rng(seed)
  for key, scale in (("warp.layer_out.weight", 0.03),
                     ("warp.layer_out.bias", 0.01)):
    sd[key] = torch.from_numpy((scale * rng.normal(size=sd[key].shape)
                                ).astype(np.float32))
  sd["canonical.refl.mlp.layer_out.weight"] = (
      sd["canonical.refl.mlp.layer_out.weight"] * 40.0)
  ws = k9.pack_weights(sd, enc_kind=enc, spline_points=spline)
  gen = torch.Generator().manual_seed(seed)
  ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen)
  r_d = rng.normal(size=(n, 3)) * 0.2 + np.array([0.0, 0.0, -1.0])
  rays = torch.from_numpy(np.concatenate(
      [np.tile([[0.0, 0.0, 3.5]], (n, 1)), r_d], -1).astype(np.float32))
  times = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
  keep = testing.dyn_kink_free_rays(ws, rays, times, ts, STEPS, enc, spline,
                                    KINK_MARGIN, chunk=chunk)
  assert int(keep.sum()) >= n // 8
  return ws, rays[keep].contiguous(), times[keep].contiguous(), ts, gen


def _rel_errs(unpack, got, ref):
  ug, ur = unpack(got), unpack(ref)
  return {k: float((ug[k].double() - ur[k].double()).norm()
                   / ur[k].double().norm()) for k in ur}


@pytest.mark.parametrize("enc,spline,dp_weight",
                         [("cp", 0, 0.0), ("cp", 4, 1e-3), ("posenc", 0, 0.0)],
                         ids=["cp-dx", "cp-spline4-dp", "posenc-dx"])
def test_plain_k9b_split_tf32_within_k9b_gates(monkeypatch, enc, spline,
                                               dp_weight):
  """The plain K9b-L (autograd through the plain K9f) with its four MLPs'
  products in split TF32 as K9b runs them (`testing.k9b_split_tf32_mlp`:
  the warp's, the rigidity's and the density MLP's forward in three
  parts), against itself in float32: loss 1e-5 relative, each gradient
  tensor 1e-4, the warp's and the rigidity's gradients non-zero. The
  warp's Fourier rows and the posenc bands stay float32
  (`fourier_phases`, `POSENCS`: not `render._matmul`)."""
  ws, rays, times, ts, gen = _dyn_case(enc, spline, N)
  target = torch.rand(rays.shape[0], 3, generator=gen)
  kw = dict(steps=STEPS, ts=ts, spline_points=spline, enc_kind=enc,
            dp_weight=dp_weight)
  loss_f32, grad_f32 = k9.dyn_train_step_reference(ws, rays, times, target,
                                                   **kw)
  monkeypatch.setattr(k1, "_mlp", testing.k9b_split_tf32_mlp(
      k1._mlp, k9.layout(enc, spline)))
  loss_tc, grad_tc = k9.dyn_train_step_reference(ws, rays, times, target,
                                                 **kw)
  assert not torch.equal(grad_tc, grad_f32)        # the emulation ran
  assert abs(float(loss_tc - loss_f32)) <= LOSS_RTOL * float(loss_f32)
  errs = _rel_errs(lambda g: k9.unpack_grads(g, enc, spline), grad_tc,
                   grad_f32)
  assert max(errs.values()) <= GRAD_RTOL, max(errs.items(),
                                              key=lambda kv: kv[1])
  assert all(float(v.norm()) > 0 for k, v in k9.unpack_grads(
      grad_tc, enc, spline).items() if k.startswith(("warp.", "rigidity.")))


@pytest.mark.parametrize("name", ["ae", "volsdf", "dyn-cp-dx",
                                  "dyn-cp-spline4", "dyn-posenc-dx",
                                  "dyn-posenc-spline4"])
def test_split_mlp_takes_its_parts_from_the_tc_pack(name):
  """`testing.split_tf32_mlp` runs each MLP of a backward kernel's TC pack
  list (the one the wrapper packs, K7b's and K8b's `TC_MLPS`, K9b's
  `Layout.tc_mlps`) in the parts its flag says, known by its Dense
  shapes, and refuses an MLP the list does not hold."""
  if name == "ae":
    mlps = k7.TC_MLPS
  elif name == "volsdf":
    mlps = k8.TC_MLPS
  else:
    _, enc, warp = name.split("-")
    mlps = k9.layout(enc, 0 if warp == "dx" else 4).tc_mlps
  seen = []

  def mlp(init_feat, layers, act, n_layers):
    seen.append(k1._matmul)

  run = testing.split_tf32_mlp(mlp, mlps)
  for _, layers, three in mlps:
    run(None, [(torch.empty(i, o), torch.empty(o)) for _, i, o in layers],
        None, None)
    assert seen[-1] is (testing.split_tf32_matmul_fwd3 if three
                        else testing.split_tf32_matmul)
  assert k1._matmul is not seen[-1]                  # restored
  with pytest.raises(KeyError):
    run(None, [(torch.empty(3, 2), torch.empty(2))], None, None)


@pytest.mark.slow
def test_k9b_posenc_floor_is_float32(monkeypatch):
  """K9b posenc Δx at the cuda test's 4096 rays × 64 (mode G: g uniform
  in [0, 1); mode L: a uniform target), on the kink-free rays: the plain
  float32 version, the same with K9b's products
  (`testing.k9b_split_tf32_mlp`), with one product group at a time in
  two parts and the others float32 (the recompute `fwd`, the input
  gradients `fwd/dx`, the weight gradients `fwd/dw`), and with every MLP
  product in float64 rounded once, each against the float64 gradient
  (`testing.dyn_float64_grad`). Prints each one's worst tensor distance,
  its distance from the float32 plain version and its worst per-tensor
  ratio to the plain version's distance, with and without the floor
  (`-s`). Holds that the output biases' float32 floor is not the
  products: K9b's products within `testing.float64_witness_ratio`'s limit
  (floor half the gate); the float64 products at least half as far from
  the float64 gradient as the plain version (its worst tensors); the input
  and weight gradient groups alone within 1e-5 of the plain version.
  ~3 minutes on 2 CPU threads."""
  ws, rays, times, ts, gen = _dyn_case("posenc", 0, 4096, chunk=256)
  n = rays.shape[0]
  kw = dict(steps=STEPS, ts=ts, spline_points=0, enc_kind="posenc")
  unpack = lambda g: k9.unpack_grads(g.float(), "posenc", 0)  # noqa: E731
  lay = k9.layout("posenc", 0)
  for mode in ("G", "L"):
    arg = torch.rand(n, 4 if mode == "G" else 3, generator=gen)

    def grad(matmul=None, mlp=None):
      with monkeypatch.context() as m:
        if matmul is not None:
          m.setattr(k1, "_matmul", matmul)
        if mlp is not None:
          m.setattr(k1, "_mlp", mlp)
        if mode == "G":
          return k9.dyn_render_grad_reference(ws, rays, times, arg, **kw)
        return k9.dyn_train_step_reference(ws, rays, times, arg, **kw)[1]

    ref = grad()
    w64 = testing.dyn_float64_grad(ws, rays, times, ts, arg,
                                   loss_mode=mode == "L", enc_kind="posenc")
    d_ref = max(_rel_errs(unpack, ref, w64).values())
    runs = {"K9b's products": grad(mlp=testing.k9b_split_tf32_mlp(
        k1._mlp, lay))}
    for group in ("fwd", "fwd/dx", "fwd/dw"):
      runs[f"{group} alone"] = grad(
          lambda a, b, parts={group: 2}: _GroupProduct.apply(a, b, "fwd",
                                                            parts))
    runs["float64 products"] = grad(
        lambda a, b: _GroupProduct.apply(
            a, b, "fwd", {"fwd": 0, "fwd/dx": 0, "fwd/dw": 0}))
    dist = {}
    for name, got in runs.items():
      to_ref = max(_rel_errs(unpack, got, ref).values())
      dist[name] = (max(_rel_errs(unpack, got, w64).values()), to_ref)
      ratio, key, ek, ep = testing.float64_witness_ratio(unpack, got, ref,
                                                         w64, GRAD_RTOL / 2)
      raw, rkey, _, _ = testing.float64_witness_ratio(unpack, got, ref, w64,
                                                      0.0)
      print(f"K9b-{mode} posenc dx, 4096 rays ({n} kink-free): {name}: "
            f"to float64 {dist[name][0]:.3e} (plain {d_ref:.3e}), to the "
            f"plain version {to_ref:.3e}; worst ratio {ratio:.2f} ({key}: "
            f"{ek:.2e} vs {ep:.2e}), unfloored {raw:.2f} ({rkey})")
      if name == "K9b's products":
        assert ratio <= testing.WITNESS_RATIO, (mode, key, ek, ep)
    assert dist["float64 products"][0] >= 0.5 * d_ref, (mode, dist)
    assert max(dist["fwd/dx alone"][1], dist["fwd/dw alone"][1]) <= 1e-5, (
        mode, dist)


def _volsdf_case(n, amplified, seed=2):
  """A VolSDF at full width (seed 0; amplified: the View's output layer
  by 40), chip_smoke.py's check rays, jittered ts, and the rays
  `testing.volsdf_kink_free_rays` clears."""
  from nerf_atlas_tpu_torch import models
  from nerf_atlas_tpu_torch.ops import rays as rays_ops
  from nerf_atlas_tpu_torch.train import driver
  sd = dict(driver.init_model(models.VolSDF(steps=STEPS), seed=0)
            .state_dict())
  if amplified:
    sd["refl.mlp.layer_out.weight"] = sd["refl.mlp.layer_out.weight"] * 40.0
  ws = k8.pack_weights(sd)
  gen = torch.Generator().manual_seed(seed)
  ts = rays_ops.compute_ts(2.0, 6.0, STEPS, perturb=1.0, generator=gen)
  rays = _rays(n, seed)
  keep = testing.volsdf_kink_free_rays(ws, rays, ts, STEPS, KINK_MARGIN)
  assert int(keep.sum()) >= n // 2
  return sd, ws, rays, ts, gen, keep


def _k8b(monkeypatch, mode, ws, rays, ts, cot, weight, split):
  """(loss or None, gradient) of the plain K8b in `mode` (G: cotangent
  `cot` [N, 5] or [N, 4]; L: target `cot`, eikonal weight `weight`),
  its MLP products as K8b's tensor cores form them when `split`."""
  kw = dict(steps=STEPS, ts=ts, sigmoid_kind="upshifted")
  with monkeypatch.context() as m:
    if split:
      m.setattr(k1, "_mlp", testing.k8b_split_tf32_mlp(k1._mlp))
    if mode == "G":
      return None, k8.volsdf_render_grad_reference(
          ws, rays, cot, want_eikonal=cot.shape[1] == 5, **kw)
    return k8.volsdf_train_step_reference(ws, rays, cot,
                                          eikonal_weight=weight, **kw)


@pytest.mark.parametrize("mode,eikonal", [("L", False), ("L", True),
                                          ("G", True)])
@pytest.mark.parametrize("amplified", [False, True])
def test_plain_k8b_split_tf32_within_k8b_gates(monkeypatch, mode, eikonal,
                                               amplified):
  """The plain K8b (autograd through the plain K8f; with the eikonal, its
  second-order gradient through the emulation) with K8b's tensor-core
  products against itself in float32, on the kink-free rays alone: loss
  1e-5 relative, each gradient tensor (the learned scale's among them)
  1e-4. With the eikonal, the split's distance to the float64 witness
  (`testing.volsdf_float64_grad`) is also held to twice the float32 plain
  version's (measured 0.9–1.2×)."""
  sd, ws, rays, ts, gen, keep = _volsdf_case(N, amplified)
  rays = rays[keep].contiguous()
  n = rays.shape[0]
  if mode == "G":
    cot = torch.randn(n, 5 if eikonal else 4, generator=gen)
  else:
    cot = torch.rand(n, 3, generator=gen)
  weight = 0.01 if eikonal else 0.0
  loss_f32, grad_f32 = _k8b(monkeypatch, mode, ws, rays, ts, cot, weight,
                            False)
  loss_tc, grad_tc = _k8b(monkeypatch, mode, ws, rays, ts, cot, weight, True)
  assert not torch.equal(grad_tc, grad_f32)        # the emulation ran
  if mode == "L":
    assert abs(float(loss_tc - loss_f32)) <= LOSS_RTOL * float(loss_f32)
  raw = sd[k8.SCALE_KEY]
  errs = _rel_errs(lambda g: k8.unpack_grads(g, raw), grad_tc, grad_f32)
  assert max(errs.values()) <= GRAD_RTOL, max(errs.items(),
                                              key=lambda kv: kv[1])
  if mode == "L" and eikonal:
    w64 = testing.volsdf_float64_grad(ws, rays, ts, cot, "upshifted",
                                      "black", weight)
    d_tc = max(_rel_errs(lambda g: k8.unpack_grads(g.float(), raw),
                         grad_tc, w64).values())
    d_f32 = max(_rel_errs(lambda g: k8.unpack_grads(g.float(), raw),
                          grad_f32, w64).values())
    assert d_tc <= 2.0 * d_f32, (d_tc, d_f32)


@pytest.mark.slow
@pytest.mark.parametrize("amplified", [False, True])
def test_plain_k8b_split_tf32_eikonal_at_4096_rays(monkeypatch, amplified):
  """chip_smoke.py's K8b-L eikonal check on the CPU: 4096 rays × 64, the
  L2 term on the kink-free rays (the others' target is their own
  render), the eikonal over all rays, so the act′ of points within
  round-off of the kink on the other rays enters. There two float32
  implementations differ by ~1e-4 (`test_k8b_eikonal_floor_is_the_recompute`),
  so the split is held to the float64 witness
  (`testing.volsdf_float64_grad`) as the float32 plain version is: its
  worst tensor's distance to the witness within 1.1 times the float32
  plain version's, and the loss to 1e-5 relative; `-s` prints the
  distances. ~5 minutes on 2 CPU threads."""
  n = 4096
  sd, ws, rays, ts, gen, keep = _volsdf_case(n, amplified)
  out = k8.volsdf_render_reference(ws, rays, steps=STEPS, ts=ts,
                                   sigmoid_kind="upshifted")[:, :3]
  target = torch.where(keep[:, None], torch.rand(n, 3, generator=gen),
                       out).contiguous()
  loss_f32, grad_f32 = _k8b(monkeypatch, "L", ws, rays, ts, target, 0.01,
                            False)
  loss_tc, grad_tc = _k8b(monkeypatch, "L", ws, rays, ts, target, 0.01, True)
  assert abs(float(loss_tc - loss_f32)) <= LOSS_RTOL * float(loss_f32)
  w64 = testing.volsdf_float64_grad(ws, rays, ts, target, "upshifted",
                                    "black", 0.01)

  def worst(grad):
    return max(_rel_errs(lambda g: k8.unpack_grads(g.float(),
                                                   sd[k8.SCALE_KEY]),
                         grad, w64).values())
  split_f32 = max(_rel_errs(lambda g: k8.unpack_grads(g, sd[k8.SCALE_KEY]),
                            grad_tc, grad_f32).values())
  print(f"K8b-L eikonal, 4096 rays, amplified {amplified}: split vs float32 "
        f"{split_f32:.3e}; vs the float64 witness: split "
        f"{worst(grad_tc):.3e}, float32 {worst(grad_f32):.3e}")
  assert worst(grad_tc) <= 1.1 * worst(grad_f32), (worst(grad_tc),
                                                   worst(grad_f32))


class _GroupProduct(torch.autograd.Function):
  """a @ b tagged with its product group, at the precision `parts` gives
  that group (1: float32, 2 or 3: split TF32, 0: float64 rounded once);
  its backward's products are tagged `role`/dx (input gradient) and
  `role`/dw (weight gradient)."""

  @staticmethod
  def forward(ctx, a, b, role, parts):
    ctx.save_for_backward(a, b)
    ctx.role, ctx.parts = role, parts
    p = parts.get(role, 1)
    if p == 1:
      return a @ b
    if p == 0:
      return (a.double() @ b.double()).float()
    return testing._split_product(a, b, p)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    return (_GroupProduct.apply(g, b.t(), ctx.role + "/dx", ctx.parts),
            _GroupProduct.apply(a.t(), g, ctx.role + "/dw", ctx.parts),
            None, None)


@pytest.mark.slow
def test_k8b_eikonal_floor_is_the_recompute(monkeypatch):
  """K8b-L with the eikonal in chip_smoke.py's form (4096 rays, the L2 on
  the kink-free rays, the eikonal over all), one product group at a time
  in split TF32 (two parts) and the others float32, against the float32
  plain version: the recompute (`fwd`), the first-order input and weight
  gradients (`fwd/dx`, `fwd/dw`; the transpose chain is among the input
  gradients), the eikonal adjoint's forward-like products (`fwd/dx/dx`)
  and its rank-64 updates (`fwd/dx/dw`); then the recompute in three
  parts and as float64 products rounded once. Prints the worst tensor's
  ‖Δ‖/‖ref‖ of each (`-s`); holds that the recompute carries the
  difference: every other group alone stays under 1e-5, and the
  recompute in two parts, and as float64 products, moves the gradient at
  least ten times as far as any other group. ~6 minutes on 2 CPU
  threads."""
  sd, ws, rays, ts, gen, keep = _volsdf_case(4096, True)
  out = k8.volsdf_render_reference(ws, rays, steps=STEPS, ts=ts,
                                   sigmoid_kind="upshifted")[:, :3]
  target = torch.where(keep[:, None], torch.rand(4096, 3, generator=gen),
                       out).contiguous()
  kw = dict(steps=STEPS, ts=ts, sigmoid_kind="upshifted", eikonal_weight=0.01)
  _, ref = k8.volsdf_train_step_reference(ws, rays, target, **kw)
  raw = sd[k8.SCALE_KEY]
  groups = ["fwd", "fwd/dx", "fwd/dw", "fwd/dx/dx", "fwd/dx/dw"]
  worst = {}
  for name, parts in ([(g, {g: 2}) for g in groups]
                      + [("fwd, three parts", {"fwd": 3}),
                         ("fwd, float64 products", {"fwd": 0})]):
    monkeypatch.setattr(k1, "_matmul",
                        lambda a, b, parts=parts: _GroupProduct.apply(
                            a, b, "fwd", parts))
    _, got = k8.volsdf_train_step_reference(ws, rays, target, **kw)
    errs = _rel_errs(lambda g: k8.unpack_grads(g, raw), got, ref)
    key = max(errs, key=errs.get)
    worst[name] = errs[key]
    print(f"K8b-L eikonal, 4096 rays: {name} vs float32: {errs[key]:.3e} "
          f"({key})")
  others = max(worst[g] for g in groups[1:])
  assert others <= 1e-5, worst
  assert min(worst["fwd"], worst["fwd, float64 products"]) >= 10 * others, (
      worst)
