"""K5f / K5b (the NGP hash-grid lookup and its table gradient) in the port.

- `hash_encode_reference` and the port's `HashEncoder` against
  `nerf_atlas_tpu.nn.HashEncoder.apply` at T = 2^10 and 2^14 (at 2^10
  level 0 is indexed densely and levels 1-7 by the hash; at 2^14 levels 0
  and 1 densely) on random points, points on the grid lines of every
  level, points on the bbox faces and points outside the bbox, with a
  table drawn from U(-1, 1) so that every corner weighs in: 1e-6 abs.
  Both sides round every float operation in the same order, so a point
  on a grid line floors to the same cell (measured: equal bit for bit).
- The table gradient (`hash_encode_table_grad_reference`, the plain K5b,
  and `HashEncode`'s backward on the CPU) against `jax.grad` of the XLA
  HashEncoder: ‖Δ‖/‖ref‖ ≤ 1e-6 per level (the scatter-add's order
  differs).
- A `slow` case against the Pallas kernel `hash_encode(...,
  interpret=True)`, whose table is rounded to bf16 (hash_encode.py:234):
  1e-2 relative to the features' magnitude.
- `cuda`-marked cases: the kernels against their plain versions on the
  card (run with `python -m pytest --noconftest -m cuda
  tests/test_torch_hash.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch.nn import HashEncoder  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import hash_encode as hk  # noqa: E402

TABLE_SIZES = [1 << 10, 1 << 14]


def _points(seed=0):
  """Random points in and around the bbox, points on the grid lines of
  every level, on the bbox faces and outside it: [P, 3] float32."""
  rng = np.random.default_rng(seed)
  parts = [rng.uniform(-1.0, 1.0, (200, 3)), rng.uniform(-3.0, 3.0, (40, 3))]
  for r in hk.resolutions():
    k = rng.integers(0, r, (6, 3))
    parts.append(k / (r - 1) * 2.0 - 1.0)           # on grid lines
  face = rng.uniform(-1.0, 1.0, (24, 3))
  face[np.arange(24), np.arange(24) % 3] = np.where(np.arange(24) % 2, 1.0,
                                                    -1.0)
  parts += [face, [[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1e10, -1e10, 0.5]]]
  return np.concatenate(parts).astype(np.float32)


def _table(size, seed=1):
  rng = np.random.default_rng(seed)
  return rng.uniform(-1.0, 1.0, (8 * size, 2)).astype(np.float32)


def _jax_encode(table, pts):
  jax = pytest.importorskip("jax")
  import jax.numpy as jnp
  from nerf_atlas_tpu.nn import HashEncoder as JHashEncoder
  enc = JHashEncoder(table_size=table.shape[0] // 8)
  return enc, jnp, jax


def test_resolutions_match_jax():
  from nerf_atlas_tpu.nn import HashEncoder as JHashEncoder
  assert hk.resolutions() == JHashEncoder()._resolutions()
  assert hk.resolutions() == [16 << i for i in range(8)]


@pytest.mark.parametrize("size", TABLE_SIZES)
def test_encode_matches_jax_hash_encoder(size):
  table, pts = _table(size), _points()
  enc, jnp, _ = _jax_encode(table, pts)
  ref = np.asarray(enc.apply({"params": {"table": jnp.asarray(table)}},
                             jnp.asarray(pts)))
  got = hk.hash_encode_reference(torch.from_numpy(table),
                                 torch.from_numpy(pts)).numpy()
  np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
  module = HashEncoder(table_size=size)
  module.load_state_dict({"table": torch.from_numpy(table)})
  with torch.no_grad():
    out = module(torch.from_numpy(pts).reshape(-1, 5, 3))
  np.testing.assert_allclose(out.reshape(-1, 16).numpy(), ref, atol=1e-6,
                             rtol=0)
  # the CPU wrapper is the plain version, and launches nothing
  before = hk.hash_encode.launches
  assert torch.equal(hk.hash_encode(torch.from_numpy(table),
                                    torch.from_numpy(pts)),
                     torch.from_numpy(got))
  assert hk.hash_encode.launches == before


@pytest.mark.parametrize("size", TABLE_SIZES)
def test_table_grad_matches_jax_grad(size):
  table, pts = _table(size), _points(2)
  g = np.random.default_rng(3).normal(size=(pts.shape[0], 16)).astype(
      np.float32)
  enc, jnp, jax = _jax_encode(table, pts)
  ref = np.asarray(jax.grad(lambda t: jnp.sum(enc.apply(
      {"params": {"table": t}}, jnp.asarray(pts)) * jnp.asarray(g)))(
          jnp.asarray(table)))
  plain = hk.hash_encode_table_grad_reference(
      torch.from_numpy(pts), torch.from_numpy(g), size).numpy()
  leaf = torch.from_numpy(table).requires_grad_(True)
  out = hk.HashEncode.apply(leaf, torch.from_numpy(pts))
  (out * torch.from_numpy(g)).sum().backward()
  before = hk.hash_encode_table_grad.launches
  wrapped = hk.hash_encode_table_grad(torch.from_numpy(pts),
                                      torch.from_numpy(g), size).numpy()
  assert hk.hash_encode_table_grad.launches == before
  for got in (plain, leaf.grad.numpy(), wrapped):
    for level in range(8):
      sl = slice(level * size, (level + 1) * size)
      err = np.linalg.norm(got[sl] - ref[sl]) / np.linalg.norm(ref[sl])
      assert err <= 1e-6, (level, err)


def test_encoder_init_and_checks():
  module = HashEncoder(table_size=1 << 8)
  module.reset_parameters(torch.Generator().manual_seed(0))
  t = module.table.detach()
  assert t.shape == (8 << 8, 2) and module.size() == 16
  assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 3e-5
  with pytest.raises(ValueError):
    HashEncoder(table_size=1000)
  with pytest.raises(ValueError):                  # 7 levels
    hk.hash_encode(torch.zeros(7 * 16, 2), torch.zeros(4, 3))
  with pytest.raises(ValueError):
    hk.hash_encode(torch.zeros(8 * 16, 2), torch.zeros(4, 2))
  with pytest.raises(ValueError):
    hk.hash_encode_table_grad(torch.zeros(4, 3), torch.zeros(4, 8), 16)


@pytest.mark.slow
def test_encode_matches_pallas_kernel_interpret():
  """Against the Pallas kernel itself (interpret mode): its table rows are
  rounded to bf16 (hash_encode.py:234), so 1e-2 of the features' RMS."""
  import jax.numpy as jnp
  from nerf_atlas_tpu.ops.pallas.hash_encode import hash_encode
  size = 1 << 10
  table, pts = _table(size), _points(4)
  ref = np.asarray(hash_encode(jnp.asarray(table), jnp.asarray(pts),
                               table_size=size, block_pts=128,
                               interpret=True))
  got = hk.hash_encode_reference(torch.from_numpy(table),
                                 torch.from_numpy(pts)).numpy()
  scale = np.sqrt(np.mean(ref ** 2))
  assert np.abs(got - ref).max() <= 1e-2 * scale


def _cuda_points(n, seed):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run K5f/K5b")
  base = _points(seed)
  pts = np.concatenate([base] * (n // len(base) + 1))[:n]
  return torch.from_numpy(pts).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1 << 14, 1 << 19])
def test_cuda_hash_encode_matches_plain(size):
  """K5f vs the plain K5f on the card: the same float operations in the
  same order, so 1e-6 abs (measured: equal)."""
  pts = _cuda_points(5000, 5)
  table = torch.from_numpy(_table(size)).cuda()
  before = hk.hash_encode.launches
  out = hk.hash_encode(table, pts)
  torch.cuda.synchronize()
  assert hk.hash_encode.launches == before + 1
  ref = hk.hash_encode_reference(table, pts)
  assert float((out - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1 << 14, 1 << 19])
def test_cuda_table_grad_matches_plain(size):
  """K5b vs the plain K5b: float atomics sum in another order, so per level
  ‖Δ‖/‖ref‖ ≤ 1e-5."""
  pts = _cuda_points(5000, 6)
  g = torch.randn(pts.shape[0], 16, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
  before = hk.hash_encode_table_grad.launches
  got = hk.hash_encode_table_grad(pts, g, size)
  torch.cuda.synchronize()
  assert hk.hash_encode_table_grad.launches == before + 1
  ref = hk.hash_encode_table_grad_reference(pts, g, size)
  for level in range(8):
    sl = slice(level * size, (level + 1) * size)
    assert float((got[sl] - ref[sl]).norm() / ref[sl].norm()) <= 1e-5
