"""The port's on-disk data layer on the CPU against imageio, cv2 and the
JAX package.

- `image_io.read_png` equals `imageio.v2.imread` bit for bit on cv2-written
  8-bit grey, RGB and RGBA (libpng's adaptive filters), a 16-bit RGB and a
  16-bit grey image, a PIL palette image with tRNS (4- and 8-bit), PIL's
  grey + alpha, and one hand-written PNG per filter type; the full 16-bit
  samples equal cv2's IMREAD_UNCHANGED and the palette's tRNS alpha PIL's
  RGBA conversion. Interlaced PNGs, JPEGs and bad CRCs raise.
- `testing.encode_png` (the fixtures' writer, row r filtered by r mod 5)
  reads back through imageio unchanged.
- `resize_area` equals cv2's INTER_AREA within 1e-6 abs (downscales at
  800→128, 64→48, 1600×1200→192, 2× and 4× boxes, the identity 24→24,
  enlargements);
  `resize_linear` equals cv2's INTER_LINEAR within 1e-5, and with
  OpenCV's IPP path off bit for bit (IPP's own INTER_LINEAR lies up to
  3.8e-5 from OpenCV's C path at 1600×1200→192).
- `write_png`, moved from the driver, writes the old writer's bytes.
- Each loader (original with and without white_bg, dnerf with the Gibson
  quirks and time_gamma, dtu, shiny with and without hwf_cxcy.npy,
  pixel-single, synthetic-ff) and `kind_from_path` equal the JAX
  package's on the same directory: labels and times within 1e-6, rays_at
  over every pixel within 1e-5.
- Each camera's rays_at and sample_positions (and NeRFCamera's
  project_pts and identity) equal JAX's within 1e-5, jitter off.
- The runner trains and tests on original, dnerf and dtu fixtures through
  the one-kernel step (the kernels' plain versions on the CPU).
"""
import json
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import cv2  # noqa: E402
import imageio.v2 as imageio  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from nerf_atlas_tpu.data import cameras as jcameras  # noqa: E402
from nerf_atlas_tpu.data import loaders as jloaders  # noqa: E402
from nerf_atlas_tpu.data import synthetic as jsynthetic  # noqa: E402
from nerf_atlas_tpu_torch import runner, testing  # noqa: E402
from nerf_atlas_tpu_torch.data import cameras, image_io, loaders  # noqa: E402
from nerf_atlas_tpu_torch.train import driver  # noqa: E402


def _smooth(h, w, c, seed=0):
  """A smooth image with noise in [0, 1]: libpng's adaptive filtering
  picks different filters across its rows."""
  rng = np.random.default_rng(seed)
  x = np.linspace(0, 1, w)[None, :, None]
  y = np.linspace(0, 1, h)[:, None, None]
  base = np.sin(7 * x + 3 * y * np.arange(1, c + 1)) * 0.5 + 0.5
  base[h // 3:h // 2] = 0.2                       # flat rows: None / Up
  return np.clip(base + rng.normal(0, 0.05, (h, w, c)), 0, 1)


def _filters(path):
  """The filter type of each row of an 8-bit, non-interlaced PNG."""
  data = open(path, "rb").read()
  pos, idat, hdr = 8, b"", None
  while pos < len(data):
    (n,) = struct.unpack(">I", data[pos:pos + 4])
    tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
    if tag == b"IHDR":
      hdr = struct.unpack(">IIBBBBB", body)
    if tag == b"IDAT":
      idat += body
    pos += 12 + n
  w, h, depth, ctype = hdr[:4]
  ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
  stride = (w * ch * depth + 7) // 8
  return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
      h, stride + 1)[:, 0]


# libpng's adaptive filter choice (cv2's own default is Sub on every row)
ADAPTIVE = [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]


def _write_cases(d):
  """{name: path} of the decoder's cases."""
  cases = {}
  for c, name in ((1, "cv2_grey"), (3, "cv2_rgb"), (4, "cv2_rgba")):
    img = (_smooth(37, 41, c) * 255).astype(np.uint8)
    cases[name] = str(d / f"{name}.png")
    cv2.imwrite(cases[name], img[..., 0] if c == 1 else img, ADAPTIVE)
  cases["cv2_rgb16"] = str(d / "rgb16.png")
  cv2.imwrite(cases["cv2_rgb16"], (_smooth(20, 23, 3) * 65535).astype(
      np.uint16), ADAPTIVE)
  cases["cv2_grey16"] = str(d / "grey16.png")
  cv2.imwrite(cases["cv2_grey16"], (_smooth(20, 23, 1)[..., 0] * 65535
                                    ).astype(np.uint16), ADAPTIVE)
  cases["pil_grey_alpha"] = str(d / "la.png")
  Image.fromarray((_smooth(19, 17, 2) * 255).astype(np.uint8), "LA").save(
      cases["pil_grey_alpha"])
  rng = np.random.default_rng(1)
  for colours, name in ((7, "pil_palette4"), (200, "pil_palette8")):
    p = Image.fromarray(rng.integers(0, colours, (16, 21)).astype(np.uint8),
                        "P")
    p.putpalette(list(rng.integers(0, 256, 3 * colours)))
    cases[name] = str(d / f"{name}.png")
    p.save(cases[name], transparency=bytes(
        rng.integers(0, 256, colours // 2).astype(np.uint8)))
  img = (_smooth(15, 13, 3, seed=2) * 255).astype(np.uint8)
  for f in range(5):
    cases[f"filter{f}"] = str(d / f"filter{f}.png")
    testing.write_png_filtered(cases[f"filter{f}"], img, filters=[f] * 15)
  return cases


CASES = ["cv2_grey", "cv2_rgb", "cv2_rgba", "cv2_rgb16", "cv2_grey16",
         "pil_grey_alpha", "pil_palette4", "pil_palette8", "filter0",
         "filter1", "filter2", "filter3", "filter4"]


@pytest.fixture(scope="module")
def png_cases(tmp_path_factory):
  return _write_cases(tmp_path_factory.mktemp("png"))


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("name", CASES)
def test_read_png_equals_imageio(png_cases, name):
  path = png_cases[name]
  ref, got = imageio.imread(path), image_io.read_png(path)
  assert got.dtype == ref.dtype and got.shape == ref.shape
  np.testing.assert_array_equal(got, ref)
  np.testing.assert_array_equal(image_io.imread(path),
                                jloaders._imread(path))


def test_cv2_writes_every_filter_and_hand_written_ones_one_each(png_cases):
  """The cases reach all five unfilters: libpng's adaptive choice mixes
  them in cv2's files; each filterN file holds filter N alone."""
  seen = set()
  for name in ("cv2_grey", "cv2_rgb", "cv2_rgba"):
    seen |= set(_filters(png_cases[name]).tolist())
  assert len(seen) >= 3 and seen & {3, 4}, seen
  for f in range(5):
    assert set(_filters(png_cases[f"filter{f}"]).tolist()) == {f}


def test_full_16_bit_samples_and_palette_alpha(png_cases):
  """decode_png keeps what imageio drops: 16-bit colour samples whole
  (cv2's IMREAD_UNCHANGED, BGR) and a palette's tRNS alpha (PIL's RGBA
  conversion)."""
  path = png_cases["cv2_rgb16"]
  img = image_io.decode_png(open(path, "rb").read())
  ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
  assert img.samples.dtype == np.uint16
  np.testing.assert_array_equal(img.samples, ref)
  for name in ("pil_palette4", "pil_palette8"):
    img = image_io.decode_png(open(png_cases[name], "rb").read())
    ref = np.asarray(Image.open(png_cases[name]).convert("RGBA"))
    np.testing.assert_array_equal(img.palette_rgba(), ref)


@pytest.mark.parametrize("shape,dtype", [
    ((13, 17), np.uint8), ((13, 17, 2), np.uint8), ((13, 17, 3), np.uint8),
    ((13, 17, 4), np.uint8), ((13, 17, 3), np.uint16), ((13, 17), np.uint16)])
def test_encode_png_reads_back(tmp_path, shape, dtype):
  rng = np.random.default_rng(0)
  img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
  path = str(tmp_path / "e.png")
  testing.write_png_filtered(path, img)
  assert _filters(path).tolist() == [r % 5 for r in range(13)] \
      or dtype == np.uint16
  got = image_io.decode_png(open(path, "rb").read()).samples
  np.testing.assert_array_equal(got.reshape(img.shape), img)
  if dtype == np.uint8 or len(shape) == 2:        # imageio keeps these
    np.testing.assert_array_equal(imageio.imread(path), img)


def test_unreadable_files_raise(tmp_path, png_cases):
  data = bytearray(open(png_cases["cv2_rgb"], "rb").read())
  interlaced = bytearray(data)
  interlaced[28] = 1                                  # IHDR's interlace byte
  crc = zlib.crc32(bytes(interlaced[12:29])) & 0xFFFFFFFF
  interlaced[29:33] = struct.pack(">I", crc)
  with pytest.raises(NotImplementedError, match="interlaced"):
    image_io.decode_png(bytes(interlaced))
  bad = bytearray(data)
  bad[30] ^= 0xFF                                     # IHDR's CRC
  with pytest.raises(ValueError, match="CRC"):
    image_io.decode_png(bytes(bad))
  jpg = str(tmp_path / "x.jpg")
  cv2.imwrite(jpg, (_smooth(8, 8, 3) * 255).astype(np.uint8))
  with pytest.raises(NotImplementedError, match="Queue 4 #1"):
    image_io.imread(jpg)


RESIZE_AREA = [((800, 800, 4), (128, 128)), ((64, 64, 3), (48, 48)),
               ((1200, 1600, 3), (192, 192)), ((24, 24, 4), (24, 24)),
               ((16, 16, 3), (40, 40)), ((20, 13, 3), (7, 33)),
               ((64, 64, 3), (16, 16)), ((64, 48, 1), (16, 12)),
               ((30, 30), (10, 10)), ((24, 26, 4), (13, 12)),
               ((24, 26), (13, 12))]


@pytest.mark.parametrize("shape,dsize", RESIZE_AREA)
def test_resize_area_equals_cv2(shape, dsize):
  img = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
  ref = cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)
  got = image_io.resize_area(img, dsize)
  assert got.shape == ref.shape and got.dtype == np.float32
  np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


RESIZE_LINEAR = [((64, 64, 3), (32, 32)), ((48, 48, 3), (32, 32)),
                 ((40, 40, 4), (32, 32)), ((32, 32, 3), (64, 64)),
                 ((128, 128, 3), (96, 96)), ((20, 13, 3), (7, 33)),
                 ((128, 128, 3), (64, 64))]


@pytest.mark.parametrize("shape,dsize", RESIZE_LINEAR)
def test_resize_linear_equals_cv2(shape, dsize):
  img = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
  got = image_io.resize_linear(img, dsize)
  np.testing.assert_allclose(got, cv2.resize(img, dsize), atol=1e-5, rtol=0)
  ipp = cv2.ipp.useIPP()
  try:
    cv2.ipp.setUseIPP(False)
    np.testing.assert_array_equal(got, cv2.resize(img, dsize))
    big = np.random.default_rng(2).uniform(0, 1, (1200, 1600, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(image_io.resize_linear(big, (192, 192)),
                                  cv2.resize(big, (192, 192)))
  finally:
    cv2.ipp.setUseIPP(ipp)


def _old_write_png(path, img):
  """The driver's PNG writer before it moved to `image_io` (verbatim)."""
  img = np.ascontiguousarray(img, dtype=np.uint8)
  if img.ndim == 2:
    img = img[..., None]
  h, w, c = img.shape
  color_type = {1: 0, 3: 2, 4: 6}[c]
  rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                        axis=1)

  def chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

  png = (b"\x89PNG\r\n\x1a\n"
         + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0,
                                      0))
         + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
         + chunk(b"IEND", b""))
  with open(path, "wb") as f:
    f.write(png)


def test_write_png_moved_without_changing_its_bytes(tmp_path):
  assert driver.write_png is image_io.write_png
  img = (_smooth(23, 31, 4) * 255).astype(np.uint8)
  image_io.write_png(str(tmp_path / "new.png"), img)
  _old_write_png(str(tmp_path / "old.png"), img)
  assert (open(tmp_path / "new.png", "rb").read()
          == open(tmp_path / "old.png", "rb").read())


# ---------------------------------------------------------------------------
# loaders and cameras against the JAX package
# ---------------------------------------------------------------------------

def _pixel_grid(size):
  xs = np.arange(size, dtype=np.float32) + 0.5
  gx, gy = np.meshgrid(xs, xs, indexing="xy")
  return np.stack([gx, gy], -1)


def _assert_rays_equal(tcam, jcam, size):
  """rays_at over every pixel of every view, port vs JAX: 1e-5."""
  xy = _pixel_grid(size)
  n = len(tcam)
  view = np.broadcast_to(np.arange(n)[:, None, None], (n, size, size))
  xy = np.broadcast_to(xy, (n, size, size, 2))
  ref = np.asarray(jax.jit(lambda v, p: jcam.rays_at(v, p, size))(
      jnp.asarray(view), jnp.asarray(xy)))          # jit: one compile
  got = tcam.rays_at(torch.as_tensor(view.copy()),
                     torch.as_tensor(xy.copy()), size).numpy()
  np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _assert_bundles_equal(tb, jb, size):
  tl, jl = tb.labels, jb.labels
  if isinstance(jl, tuple):
    np.testing.assert_allclose(tl[1], jl[1], atol=1e-6, rtol=0)
    tl, jl = tl[0], jl[0]
  assert tl.shape == jl.shape and tl.dtype == np.float32
  np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-6, rtol=0)
  _assert_rays_equal(tb.camera, jb.camera, size)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
  """On-disk scenes written from the port's procedural scene."""
  d = tmp_path_factory.mktemp("scenes")
  roots = {k: str(d / k) for k in ("lego", "jj", "scan", "gibson_room",
                                   "shiny", "shiny_hwf")}
  testing.write_nerf_synthetic(roots["lego"], 3, 2, 24)
  testing.write_nerf_synthetic(roots["jj"], 4, 3, 20, dynamic=True)
  testing.write_dtu(roots["scan"], 3, 40, 30)
  # Gibson: degrees, world-to-camera matrices, `timestep` outside [0, 1]
  root = roots["gibson_room"]
  poses = jsynthetic.hemisphere_poses(3)
  frames = []
  for i in range(3):
    rel = f"train/r_{i}"
    testing.write_png_filtered(os.path.join(root, rel + ".png"),
                               (_smooth(32, 32, 3, seed=i) * 255).astype(
                                   np.uint8))
    frames.append({"file_path": rel, "timestep": float(2 - i),
                   "transform_matrix": np.linalg.inv(
                       np.asarray(poses[i])).tolist()})
  with open(os.path.join(root, "transforms_train.json"), "w") as f:
    json.dump({"camera_angle_x": float(np.degrees(0.6911)),
               "frames": frames}, f)
  # shiny (LLFF): poses_bounds.npy (+ hwf_cxcy.npy), images/
  n, w = 9, 32
  poses = np.asarray(jsynthetic.hemisphere_poses(n))
  llff = np.concatenate([-poses[:, :3, 1:2], poses[:, :3, 0:1],
                         poses[:, :3, 2:4]], -1)
  bds = np.tile(np.array([[2.0, 6.0]]), (n, 1))
  for key, hwf in (("shiny", True), ("shiny_hwf", False)):
    root = roots[key]
    os.makedirs(os.path.join(root, "images"))
    if hwf:
      np.save(os.path.join(root, "poses_bounds.npy"),
              np.concatenate([llff.reshape(n, 12), bds], -1))
      np.save(os.path.join(root, "hwf_cxcy.npy"),
              np.array([w, w, 40.0, 40.0, 16.0, 16.0]))
    else:
      hwf_col = np.tile(np.array([w, w, 40.0])[None, :, None], (n, 1, 1))
      np.save(os.path.join(root, "poses_bounds.npy"),
              np.concatenate([np.concatenate([llff, hwf_col], -1).reshape(
                  n, 15), bds], -1))
    for i in range(n):
      testing.write_png_filtered(
          os.path.join(root, "images", f"{i:03d}.png"),
          (_smooth(w, w, 3, seed=10 + i) * 255).astype(np.uint8))
  roots["single"] = str(d / "single.png")
  testing.write_png_filtered(roots["single"], (_smooth(20, 20, 3) * 255
                                               ).astype(np.uint8))
  return roots


@pytest.mark.parametrize("name,kind,kw,size", [
    ("lego", "original", {}, 16),
    ("lego", "original", {"white_bg": True}, 24),
    ("jj", "dnerf", {}, 16),
    ("jj", "dnerf", {"time_gamma": True}, 12),
    ("gibson_room", "dnerf", {}, 16),
    ("scan", "dtu", {}, 16),
    ("shiny", "shiny", {}, 16),
    ("shiny_hwf", "shiny", {}, 16),
    ("single", "pixel-single", {}, 16),
])
def test_loader_equals_jax(scenes, name, kind, kw, size):
  root = scenes[name]
  splits = (True,) if name == "gibson_room" else (True, False)
  for training in splits:
    jb = jloaders.load(root, kind, training=training, size=size, **kw)
    tb = loaders.load(root, kind, training=training, size=size, **kw)
    _assert_bundles_equal(tb, jb, size)
  assert loaders.kind_from_path(root) == jloaders.kind_from_path(root)
  if name != "gibson_room":             # Gibson's `timestep` reads as original
    assert loaders.kind_from_path(root) == kind


def test_synthetic_front_facing_equals_jax():
  for training in (True, False):
    jb = jloaders.load("", "synthetic-ff", training=training, size=8,
                       num_views=3)
    tb = loaders.load("", "synthetic-ff", training=training, size=8,
                      num_views=3)
    np.testing.assert_allclose(tb.labels, jb.labels, atol=2e-5, rtol=0)
    _assert_rays_equal(tb.camera, jb.camera, 8)
  assert loaders.kind_from_path("") == jloaders.kind_from_path("")


@pytest.mark.parametrize("kind,item", [
    ("nerv_point", "Queue 4 #2"), ("single_video", "Queue 4 #3"),
    ("synthetic-lit", "Queue 1 #13")])
def test_waiting_kinds_raise_naming_their_item(kind, item):
  with pytest.raises(NotImplementedError, match=item):
    loaders.load("", kind, size=8)


def _jax_and_port_cameras():
  poses = np.array(jsynthetic.hemisphere_poses(3))
  rng = np.random.default_rng(0)
  K = np.tile(np.array([[30.0, 0.5, 11.0], [0, 28.0, 9.0], [0, 0, 1.0]],
                       np.float32), (3, 1, 1))
  K[:, 0, 0] += rng.uniform(0, 5, 3).astype(np.float32)
  return [
      (jcameras.NeRFCamera.from_json_transforms(poses, 0.6911, 20),
       cameras.NeRFCamera.from_json_transforms(poses, 0.6911, 20)),
      (jcameras.NeRFCamera.identity(2, focal=10.0),
       cameras.NeRFCamera.identity(2, focal=10.0)),
      (jcameras.OrthogonalCamera(jnp.asarray(poses), view_width=1.5),
       cameras.OrthogonalCamera(torch.as_tensor(poses), view_width=1.5)),
      (jcameras.StaticCamera.from_fov(50.0, 20, n_views=3),
       cameras.StaticCamera.from_fov(50.0, 20, n_views=3)),
      (jcameras.DTUCamera(pose=jnp.asarray(poses), K=jnp.asarray(K)),
       cameras.DTUCamera(pose=torch.as_tensor(poses), K=torch.as_tensor(K))),
  ]


@pytest.mark.parametrize("which", range(5))
def test_camera_equals_jax(which):
  jcam, tcam = _jax_and_port_cameras()[which]
  assert len(tcam) == len(jcam)
  _assert_rays_equal(tcam, jcam, 20)
  pos = _pixel_grid(20)[::3, ::2]
  ref = np.asarray(jax.jit(lambda p: jcam.sample_positions(p, 20))(
      jnp.asarray(pos)))
  got = tcam.sample_positions(torch.as_tensor(pos), 20).numpy()
  np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
  sub_j, sub_t = jcam[np.arange(1)], tcam[:1]
  assert len(sub_t) == len(sub_j) == 1
  if which == 0:
    pts = np.random.default_rng(1).normal(size=(5, 1, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.project_pts(torch.as_tensor(pts), 20).numpy(),
        np.asarray(jcam.project_pts(jnp.asarray(pts), 20)), atol=1e-4,
        rtol=1e-5)
  assert set(cameras.CAMERA_KINDS) == set(jcameras.CAMERA_KINDS)


def test_camera_jitter_moves_pixels_by_at_most_half():
  _, tcam = _jax_and_port_cameras()[4]
  xy = torch.as_tensor(_pixel_grid(20)).reshape(-1, 2)
  view = torch.zeros(xy.shape[0], dtype=torch.long)
  base = tcam.rays_at(view, xy, 20)
  gen = torch.Generator().manual_seed(0)
  moved = tcam.rays_at(view, xy, 20, jitter=1.0, generator=gen)
  lo = tcam.rays_at(view, xy - 0.5, 20)
  hi = tcam.rays_at(view, xy + 0.5, 20)
  assert not torch.equal(moved, base)
  span = (hi - lo).abs()[:, 3:].max()
  assert float((moved - base).abs()[:, 3:].max()) <= float(span)
  with pytest.raises(ValueError, match="Generator"):
    tcam.rays_at(view, xy, 20, jitter=1.0)


# ---------------------------------------------------------------------------
# the runner on on-disk fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,extra", [
    ("lego", ["--data-kind", "original", "--mip", "cone"]),
    ("jj", ["--data-kind", "dnerf", "--dyn-model", "plain",
            "--dp-weight", "1e-3"]),
    ("scan", ["--data-kind", "dtu", "--model", "volsdf", "--sdf-kind", "mlp",
              "--sigmoid-kind", "upshifted", "--eikonal-weight", "0.1"]),
])
def test_runner_trains_on_disk_fixtures(scenes, tmp_path, name, extra):
  argv = ["-d", scenes[name], *extra, "--size", "12", "--steps", "8",
          "--epochs", "3", "--batch-size", "64", "--nosave",
          "--outdir", str(tmp_path)]
  results = runner.main(argv, device="cpu")
  assert results["engaged_path"] == "fused-one-kernel"
  with open(tmp_path / "log.json") as f:
    assert json.load(f)["engaged_path"] == "fused-one-kernel"
  for split in ("train", "test"):
    assert np.isfinite(results[split]["psnr_mean"])
    assert os.path.exists(tmp_path / split / "test_000.png")
