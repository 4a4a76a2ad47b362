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
split's error bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from nerf_atlas_tpu_torch import testing  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import render as k1  # noqa: E402

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


@pytest.mark.parametrize("enc_kind", list(k1.ENC_KINDS))
def test_tc_pack_layout(enc_kind):
  """`render.tc_pack`, read at the offsets csrc/mma_tf32.cuh computes
  (`tc_offset`: per Dense layer the forward block [kh ‖ kf rows][out],
  then [out][kh] and [out][kf]; 16-deep slices, hi then lo, in mma
  fragment order),
  gives back each layer's W in its forward block and Wᵀ in its
  input-gradient blocks, as hi + lo within 2^-22, with zeros in the
  padding."""
  layout = k1.LAYOUTS[enc_kind]
  gen = torch.Generator().manual_seed(3)
  ws = torch.randn(layout.weight_count, generator=gen)
  pack = k1.tc_pack(ws, enc_kind)
  w_all = k1._unpack(ws)

  def block(off, k, m):
    """hi + lo of the block at `off` as [pad16(k)][pad16(m)] (fragment
    order: per 16-deep slice, hi then lo, each [k-step][m-tile][lane][4]
    holding A[16mt + g + 8(j % 2)][8kk + t + 4(j // 2)], g = lane // 4, t
    = lane % 4), and the block's end."""
    kp, mp = _pad16(k), _pad16(m)
    b = pack[off:off + 2 * kp * mp].view(kp // 16, 2, 2, mp // 16, 32, 4)
    b = (b[:, 0] + b[:, 1]).double()
    s, kk, mt, lane, j = torch.meshgrid(
        *[torch.arange(n) for n in b.shape], indexing="ij")
    out = torch.zeros(kp, mp, dtype=torch.float64)
    out[16 * s + 8 * kk + lane % 4 + 4 * (j // 2),
        16 * mt + lane // 4 + 8 * (j % 2)] = b
    return out, off + 2 * kp * mp

  def close(got, want):
    assert bool(((got - want).abs() <= 2.0 ** -22 * want.abs()).all())

  off = 0
  for layers in (w_all[1], w_all[2]):
    nl = len(layers) - 2
    for j, (w, _) in enumerate(layers):
      n_in, n_out = w.shape
      kh = 0 if j == 0 else layers[0][0].shape[1]
      kf = n_in - kh
      assert kf == (n_in if j == 0 else
                    (kf if 1 <= j <= nl and _skip_at(j - 1, nl) else 0))
      w = w.double()
      fwd, off = block(off, _pad16(kh) + kf, n_out)
      close(fwd[:kh, :n_out], w[:kh])
      close(fwd[_pad16(kh):_pad16(kh) + kf, :n_out], w[kh:])
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
