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
- K5f's corner-pair rule (`testing.k5f_corner_pairs`, the kernel's rule
  on the host) at T = 1, 2, 2^10, 2^14 and 2^19: every pair it joins is
  one aligned pair of rows, 2k and 2k + 1, so one 16-byte load holds both
  corners' rows as `_corners` gives them, and the kernel's loads
  emulated on the host (`testing.k5f_emulate`) give the plain K5f's bits;
  no pair is joined where x is clamped or at T = 1; the joined share per
  level is printed (`-s`) and held near half.
- `cuda`-marked cases: the kernels against their plain versions on the
  card (run with `python -m pytest --noconftest -m cuda
  tests/test_torch_hash.py`); K5f bit for bit at T = 1 to 2^19 and a
  ragged point count, and a table view that is not 16-byte aligned
  refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import testing  # noqa: E402
from nerf_atlas_tpu_torch.nn import HashEncoder  # noqa: E402
from nerf_atlas_tpu_torch.ops.kernels import hash_encode as hk  # noqa: E402

TABLE_SIZES = [1 << 10, 1 << 14]
# K5f's pair rule: T = 1 (no pair), 2, every level hashed (2^10), and the
# train step's and the default tables (levels 0 and 0-2 dense)
PAIR_SIZES = [1, 2, 1 << 10, 1 << 14, 1 << 19]


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


@pytest.mark.parametrize("size", PAIR_SIZES)
def test_k5f_pair_rule_joins_one_aligned_pair(size):
  """Each pair the kernel joins is rows 2k and 2k + 1 (in either order),
  so the 16-byte load of that aligned pair yields both corners' rows as
  `_corners` gives them; the emulated loads give the plain K5f's bits."""
  table, pts = torch.from_numpy(_table(size)), torch.from_numpy(_points())
  quads = table.reshape(-1, 4)
  for li, c, a, b, joined in testing.k5f_corner_pairs(pts, size):
    a, b = a[joined], b[joined]
    assert torch.equal(torch.minimum(a, b) % 2, torch.zeros_like(a))
    assert torch.equal((a - b).abs(), torch.ones_like(a)), (li, c)
    pair = quads[a // 2]
    odd = (a % 2 == 1)[:, None]
    assert torch.equal(torch.where(odd, pair[:, 2:], pair[:, :2]), table[a])
    assert torch.equal(torch.where(odd, pair[:, :2], pair[:, 2:]), table[b])
  assert torch.equal(testing.k5f_emulate(table, pts),
                     hk.hash_encode_reference(table, pts))


@pytest.mark.parametrize("size", PAIR_SIZES)
def test_k5f_pair_rule_never_joins_clamped_x(size):
  """Where x is clamped (lo_x = res − 1: on the bbox face x = 1 or beyond
  it) corners c and c | 1 share a row, and at T = 1 every corner is row
  0 of its level: no pair is joined there."""
  pts = torch.from_numpy(_points())
  xn = torch.clamp((pts[:, 0] - hk.BBOX[0]) / (hk.BBOX[1] - hk.BBOX[0]),
                   0.0, 1.0)
  for li, c, a, b, joined in testing.k5f_corner_pairs(pts, size):
    r = hk.resolutions()[li]
    clamped = torch.floor(xn * float(r - 1)).long() == r - 1
    assert int(clamped.sum()) >= 10
    assert not bool(joined[clamped].any()), (li, c)
    assert torch.equal(a[clamped], b[clamped])
    if size == 1:
      assert not bool(joined.any())


@pytest.mark.parametrize("size", PAIR_SIZES)
def test_k5f_joined_share_per_level(size):
  """The share of corner pairs one 16-byte load serves, per level: about
  half (lo_x even, and in a hashed level the two rows always fall in one
  aligned pair then), none at T = 1, most at T = 2 (two rows a level)."""
  share = testing.k5f_joined_share(torch.from_numpy(_points()), size)
  print(f"T={size}: joined share per level "
        f"{' '.join(f'{v:.3f}' for v in share)}")
  if size == 1:
    assert share == [0.0] * 8
  elif size == 2:
    assert min(share) > 0.9
  else:
    assert 0.4 <= min(share) and max(share) <= 0.6, share


def _cuda_points(n, seed):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run K5f/K5b")
  base = _points(seed)
  pts = np.concatenate([base] * (n // len(base) + 1))[:n]
  return torch.from_numpy(pts).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("size", PAIR_SIZES)
def test_cuda_hash_encode_matches_plain(size):
  """K5f vs the plain K5f on the card: the same float operations in the
  same order, so 1e-6 abs and bit for bit, at 5000 points and at 77 (a
  ragged tile of the 256-point blocks); two launches the same bits."""
  for n in (5000, 77):
    pts = _cuda_points(n, 5)
    table = torch.from_numpy(_table(size)).cuda()
    before = hk.hash_encode.launches
    out = hk.hash_encode(table, pts)
    again = hk.hash_encode(table, pts)
    torch.cuda.synchronize()
    assert hk.hash_encode.launches == before + 2
    ref = hk.hash_encode_reference(table, pts)
    assert float((out - ref).abs().max()) <= 1e-6
    assert torch.equal(out, ref) and torch.equal(out, again)


@pytest.mark.cuda
def test_cuda_hash_encode_refuses_misaligned_table(cuda_device):
  """K5f reads aligned pairs of rows as 16-byte vectors: a table view 8
  bytes off a 16-byte boundary is refused."""
  size = 1 << 10
  flat = torch.zeros(8 * size * 2 + 2, device=cuda_device)
  table = flat[2:].view(8 * size, 2)
  assert table.data_ptr() % 16 == 8 and table.is_contiguous()
  with pytest.raises(ValueError, match="16-byte"):
    hk.hash_encode(table, _cuda_points(100, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1 << 14, 1 << 19])
def test_cuda_table_grad_matches_plain(size):
  """K5b vs the plain K5b: K5b sums in 64-bit fixed point (order-free),
  the plain version in float32 with index_add_, so per level ‖Δ‖/‖ref‖ ≤
  1e-5."""
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


@pytest.fixture
def cuda_device():
  """The card, or a skip where there is none (decided when the test runs)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device (and nvcc) to build and run K5b")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1 << 14, 1 << 19])
def test_cuda_table_grad_is_order_free(cuda_device, size):
  """K5b's integer sums are associative: two launches, and the points
  (with their cotangents) in a permuted order, give the same bits."""
  base = _points(7)
  pts = torch.from_numpy(np.concatenate([base] * (20000 // len(base) + 1))
                         [:20000]).to(cuda_device)
  g = torch.randn(pts.shape[0], 16, device=cuda_device,
                  generator=torch.Generator(device=cuda_device).manual_seed(1))
  got = hk.hash_encode_table_grad(pts, g, size)
  again = hk.hash_encode_table_grad(pts, g, size)
  perm = torch.randperm(pts.shape[0], device=cuda_device,
                        generator=torch.Generator(
                            device=cuda_device).manual_seed(2))
  permuted = hk.hash_encode_table_grad(pts[perm].contiguous(),
                                       g[perm].contiguous(), size)
  assert torch.equal(got, again)
  assert torch.equal(got, permuted)
