"""PNG reading and writing, and cv2's INTER_AREA and INTER_LINEAR resizes,
with numpy and zlib alone.

Counterpart of `nerf_atlas_tpu/data/loaders.py:_imread` (imageio) and
`_resize` (`cv2.resize(..., interpolation=cv2.INTER_AREA)`), and of
`cv2.resize`'s default INTER_LINEAR, which the JAX package's driver
applies to the style image and to an eval reference of another size. The
GPU machine has no imageio, cv2 or PIL, so the port carries its own.

- `decode_png(data)` parses a PNG (IHDR, PLTE, tRNS, IDAT, IEND; every
  CRC checked, other chunks skipped), inflates it and undoes the five row
  filters for bit depths 8 and 16 of colour types 0, 2, 4 and 6 and for
  palette images at 1, 2, 4 or 8 bits. Adam7 interlacing, JPEG and
  sub-byte grey raise. The filters are undone along anti-diagonals: byte
  (r, c) depends only on (r, c − bpp), (r − 1, c) and (r − 1, c − bpp),
  so pixel column p of row r waits only on diagonals r + p − 1 and
  r + p − 2, and a whole diagonal is one numpy step: H + W steps an
  image, whatever its filters (Paeth and Average are sequential along a
  row; a column loop would take H·W steps).
- `read_png(path)` returns what `imageio.v2.imread` (Pillow) returns for
  the same file: grey [H, W], grey + alpha [H, W, 2], RGB, RGBA and
  palette images as uint8 [H, W, 3|4] (a palette expanded to RGB, its tRNS
  alpha dropped, as Pillow's conversion does), 16-bit grey as uint16, and
  16-bit colour, as Pillow reads it, as the high byte of each sample
  (16-bit grey + alpha as RGBA). `imread(path)` scales it to float32 as
  `_imread` does: uint8 /255, uint16 /65535.
- `resize_area` and `resize_linear` are `cv2.resize` on float32 images
  with INTER_AREA and INTER_LINEAR, computed as OpenCV computes them
  (float32 sums in its order): integer downscales as box means, other
  downscales by fractional-area weights, INTER_AREA enlargements by
  OpenCV's area-mode bilinear weights, INTER_LINEAR by half-pixel centres
  with a replicated border. Like cv2, a single-channel [H, W, 1] input
  comes back [h, w].
"""
from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# ROADMAP items of the formats the port does not read
JPEG_ITEM = "Queue 4 #1"

# samples per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# filtered bytes of the images unfiltered in one lockstep group, at most
_LOCKSTEP_BYTES = 1 << 26


class PNGImage(NamedTuple):
  """A decoded PNG: `samples` [H, W, C] uint8 or uint16 (C the colour
  type's channel count; a palette image's indices [H, W, 1] uint8),
  `palette` [K, 3] uint8 and `palette_alpha` [K] uint8 (tRNS, 255 past
  its end) for a palette image, else None."""
  samples: np.ndarray
  color_type: int
  bit_depth: int
  palette: Optional[np.ndarray] = None
  palette_alpha: Optional[np.ndarray] = None

  def palette_rgba(self) -> np.ndarray:
    """A palette image expanded through PLTE and tRNS -> uint8 [H, W, 4]."""
    rgba = np.concatenate([self.palette, self.palette_alpha[:, None]], -1)
    return rgba[self.samples[..., 0]]


def _chunks(data: bytes):
  """(tag, payload) of each chunk, each CRC checked."""
  pos = len(PNG_SIGNATURE)
  while pos + 12 <= len(data):
    (length,) = struct.unpack(">I", data[pos:pos + 4])
    tag = data[pos + 4:pos + 8]
    body = data[pos + 8:pos + 8 + length]
    (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
    if len(body) != length or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
      raise ValueError(f"PNG chunk {tag!r}: truncated or bad CRC")
    yield tag, body
    pos += 12 + length
    if tag == b"IEND":
      return
  raise ValueError("PNG ends before its IEND chunk")


def _paeth(a, b, c):
  pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _skewed(buf: np.ndarray, offset: int, diagonals: int) -> np.ndarray:
  """A view v[d, i] = buf[i, offset + d − i] of buf [R, L, ...] (no copy),
  shape [diagonals, R, ...]; offset ≥ R − 1 keeps every element inside
  buf."""
  s_row, s_col = buf.strides[:2]
  base = buf[:, offset:]
  return np.lib.stride_tricks.as_strided(
      base, (diagonals,) + buf.shape[:1] + buf.shape[2:],
      (s_col, s_row - s_col) + buf.strides[2:])


def unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
  """Undo PNG row filtering of N images in lockstep. rows [N, H, 1 +
  stride] uint8 (each row's filter type, then its filtered bytes), bpp
  the filter's bytes per pixel -> [N, H, stride] uint8. Diagonal d holds
  the pixel columns p = d − r of rows r (strided views of row-major
  buffers padded by H columns on the left); its predictors read
  diagonals d − 1 (left, above) and d − 2 (above-left)."""
  kinds = rows[..., 0]
  if kinds.max(initial=0) > 4:
    raise ValueError(f"PNG filter type {int(kinds.max())} (0-4 exist)")
  raw = rows[..., 1:]
  if not kinds.any():
    return raw.copy()
  n, h, stride = raw.shape
  p_cols = stride // bpp
  steps = h + p_cols - 1
  # filtered bytes at column h + p of row r; reconstructed ones at column
  # h + 3 + p of row r + 1, row 0 and the pad zero
  src = np.zeros((h, h + p_cols, n, bpp), np.int16)
  src[:, h:] = raw.reshape(n, h, p_cols, bpp).transpose(1, 2, 0, 3)
  out = np.zeros((h + 1, h + 3 + p_cols, n, bpp), np.int16)
  diag = _skewed(src, h, steps)                  # diag[d, r]: pixel (r, d-r)
  rec = _skewed(out, h + 2, steps + 2)           # rec[d + 2, r + 1]: same
  kind = kinds.T.astype(np.int16)[..., None]                # [H, N, 1]
  for d in range(steps):
    lo, hi = max(0, d - p_cols + 1), min(d, h - 1) + 1
    prev, prev2 = rec[d + 1], rec[d]           # d < 2: zero pad columns
    a, b, c = prev[lo + 1:hi + 1], prev[lo:hi], prev2[lo:hi]
    f = kind[lo:hi]
    pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
        f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
    rec[d + 2, lo + 1:hi + 1] = (diag[d, lo:hi] + pred) & 255
  res = out[1:, h + 3:].astype(np.uint8)                    # [H, P, N, bpp]
  return res.transpose(2, 0, 1, 3).reshape(n, h, stride)


class _Parsed(NamedTuple):
  header: tuple                          # (w, h, depth, colour type)
  palette: Optional[np.ndarray]
  trns: Optional[np.ndarray]
  rows: np.ndarray                       # [H, 1 + stride] uint8


def _parse(data: bytes) -> _Parsed:
  """Check a PNG's chunks and inflate its image data."""
  if data[:3] == JPEG_SIGNATURE:
    raise NotImplementedError(
        f"JPEG images: the port reads PNG only (ROADMAP {JPEG_ITEM})")
  if data[:8] != PNG_SIGNATURE:
    raise ValueError("not a PNG file")
  header, palette, trns, idat = None, None, None, []
  for tag, body in _chunks(data):
    if tag == b"IHDR":
      header = struct.unpack(">IIBBBBB", body)
    elif tag == b"PLTE":
      palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    elif tag == b"tRNS":
      trns = np.frombuffer(body, np.uint8)
    elif tag == b"IDAT":
      idat.append(body)
  if header is None:
    raise ValueError("PNG without an IHDR chunk")
  w, h, depth, ctype, _, _, interlace = header
  if interlace:
    raise NotImplementedError("Adam7-interlaced PNG: not supported")
  if ctype not in _CHANNELS:
    raise ValueError(f"PNG colour type {ctype}")
  ok_depths = (1, 2, 4, 8) if ctype == 3 else (8, 16)
  if depth not in ok_depths:
    raise NotImplementedError(
        f"PNG bit depth {depth} for colour type {ctype}: the port reads "
        f"{ok_depths}")
  if ctype == 3 and palette is None:
    raise ValueError("palette PNG without a PLTE chunk")
  stride = (w * _CHANNELS[ctype] * depth + 7) // 8
  raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
  if raw.size < h * (stride + 1):
    raise ValueError("PNG image data is shorter than its size")
  return _Parsed((w, h, depth, ctype), palette, trns,
                 raw[:h * (stride + 1)].reshape(h, stride + 1))


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
  """Unfiltered rows [N, H, stride] -> samples [N, H, W, ch]."""
  n, h, _ = rows.shape
  if depth == 16:
    return (rows[..., 0::2].astype(np.uint16) << 8
            | rows[..., 1::2]).reshape(n, h, w, ch)        # big-endian
  if depth == 8:
    return rows.reshape(n, h, w, ch)
  bits = np.unpackbits(rows, axis=-1).reshape(n, h, -1, depth)
  weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
  return (bits * weights).sum(-1, dtype=np.uint8)[:, :, :w, None]


def decode_pngs(datas: Sequence[bytes]) -> List[PNGImage]:
  """Decode PNG files' bytes (module docstring). Images of one size and
  format unfilter in lockstep, up to _LOCKSTEP_BYTES of filtered rows at
  a time."""
  parsed = [_parse(d) for d in datas]
  out: List[Optional[PNGImage]] = [None] * len(parsed)
  groups = {}
  for i, p in enumerate(parsed):
    groups.setdefault(p.header, []).append(i)
  for (w, h, depth, ctype), idx in groups.items():
    ch = _CHANNELS[ctype]
    per = max(1, _LOCKSTEP_BYTES // parsed[idx[0]].rows.nbytes)
    for k in range(0, len(idx), per):
      part = idx[k:k + per]
      rows = unfilter(np.stack([parsed[i].rows for i in part]),
                      max(1, ch * depth // 8))
      for i, samples in zip(part, _samples(rows, w, depth, ch)):
        out[i] = PNGImage(samples, ctype, depth)
        p = parsed[i]
        if ctype == 3:
          alpha = np.full(len(p.palette), 255, np.uint8)
          if p.trns is not None:
            alpha[:len(p.trns)] = p.trns[:len(p.palette)]
          if samples.max(initial=0) >= len(p.palette):
            raise ValueError("PNG palette index past the PLTE entries")
          out[i] = out[i]._replace(palette=p.palette, palette_alpha=alpha)
  return out


def decode_png(data: bytes) -> PNGImage:
  """Decode one PNG file's bytes (module docstring)."""
  return decode_pngs([data])[0]


def _as_imageio(img: PNGImage) -> np.ndarray:
  """The array imageio (Pillow) gives for a decoded PNG."""
  s = img.samples
  if img.color_type == 3:
    return img.palette[s[..., 0]]
  if img.bit_depth == 16 and img.color_type != 0:
    s = (s >> 8).astype(np.uint8)              # Pillow keeps the high byte
    if img.color_type == 4:                    # ... and reads LA;16 as RGBA
      s = s[..., [0, 0, 0, 1]]
  return s[..., 0] if img.color_type == 0 else s


def read_pngs(paths: Sequence[str]) -> List[np.ndarray]:
  """The arrays `imageio.v2.imread` gives for the PNGs at `paths`
  (module docstring), decoded in lockstep where their sizes agree."""
  datas = []
  for path in paths:
    with open(path, "rb") as f:
      datas.append(f.read())
  return [_as_imageio(img) for img in decode_pngs(datas)]


def read_png(path: str) -> np.ndarray:
  """`read_pngs` of one file."""
  return read_pngs([path])[0]


def _to_float(img: np.ndarray) -> np.ndarray:
  scale = {np.uint8: 255.0, np.uint16: 65535.0}[img.dtype.type]
  return img.astype(np.float32) / scale


def imreads(paths: Sequence[str]) -> List[np.ndarray]:
  """`loaders._imread` of each path: `read_pngs` as float32, uint8 /255,
  uint16 /65535."""
  return [_to_float(img) for img in read_pngs(paths)]


def imread(path: str) -> np.ndarray:
  """`imreads` of one file."""
  return _to_float(read_png(path))


def write_png(path: str, img: np.ndarray):
  """Write a uint8 image [H, W] or [H, W, C] (C = 1, 3 or 4) as an 8-bit
  PNG with zlib and struct alone."""
  img = np.ascontiguousarray(img, dtype=np.uint8)
  if img.ndim == 2:
    img = img[..., None]
  h, w, c = img.shape
  color_type = {1: 0, 3: 2, 4: 6}[c]
  rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)],
                        axis=1)                  # filter byte 0 per row

  def chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

  png = (PNG_SIGNATURE
         + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0,
                                      0))
         + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
         + chunk(b"IEND", b""))
  with open(path, "wb") as f:
    f.write(png)


# --------------------------------------------------------------------------
# cv2.resize
# --------------------------------------------------------------------------

def _area_tab(ssize: int, dsize: int, scale: float):
  """OpenCV's computeResizeAreaTab: per destination index its source
  taps and weights, in order -> (src [dsize, K], weight [dsize, K]
  float32), padded with weight 0."""
  taps = []
  for dx in range(dsize):
    fsx1 = dx * scale
    fsx2 = fsx1 + scale
    cell = min(scale, ssize - fsx1)
    sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
    sx2 = min(sx2, ssize - 1)
    sx1 = min(sx1, sx2)
    row = []
    if sx1 - fsx1 > 1e-3:
      row.append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
    row += [(sx, np.float32(1.0 / cell)) for sx in range(sx1, sx2)]
    if fsx2 - sx2 > 1e-3:
      row.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    taps.append(row)
  k = max(len(t) for t in taps)
  src = np.zeros((dsize, k), np.int64)
  wgt = np.zeros((dsize, k), np.float32)
  for i, row in enumerate(taps):
    for j, (s, a) in enumerate(row):
      src[i, j], wgt[i, j] = s, a
  return src, wgt


def _linear_tab(ssize: int, dsize: int, scale: float, inv_scale: float,
                area_mode: bool):
  """OpenCV's two-tap coefficients per destination index -> (s, f
  float32): taps s and s + 1 weighted 1 − f and f (area mode: the
  INTER_AREA enlargement's weights)."""
  s = np.empty(dsize, np.int64)
  f = np.empty(dsize, np.float32)
  for d in range(dsize):
    if area_mode:
      si = int(np.floor(d * scale))
      fi = np.float32((d + 1) - (si + 1) * inv_scale)
      fi = np.float32(0.0) if fi <= 0 else np.float32(fi - np.floor(fi))
    else:
      fi = np.float32((d + 0.5) * scale - 0.5)
      si = int(np.floor(fi))
      fi = np.float32(fi - np.float32(si))
    s[d], f[d] = si, fi
  return s, f


def _box_mean(img: np.ndarray, ky: int, kx: int) -> np.ndarray:
  """OpenCV's resizeAreaFast: the mean of each ky × kx box, its float32
  sum taken in row-major order four taps at a time; for 2 × 2 boxes of 1
  or 4 channels its SIMD path's ((a + b) + (c + d)) instead, over the
  whole row for 4 channels and its first 4·⌊w/4⌋ outputs for 1."""
  h, w = img.shape[0] // ky, img.shape[1] // kx
  boxes = img.reshape(h, ky, w, kx, -1)
  taps = [boxes[:, sy, :, sx] for sy in range(ky) for sx in range(kx)]
  total = np.zeros_like(taps[0])
  k = 0
  while k <= len(taps) - 4:
    total = total + (((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3])
    k += 4
  for t in taps[k:]:
    total = total + t
  if ky == kx == 2 and img.shape[2] in (1, 4):
    simd = (taps[0] + taps[1]) + (taps[2] + taps[3])
    lanes = w if img.shape[2] == 4 else w - w % 4
    total[:, :lanes] = simd[:, :lanes]
  return total * np.float32(1.0 / (ky * kx))


def _area_down(img: np.ndarray, dw: int, dh: int, scale_x: float,
               scale_y: float) -> np.ndarray:
  """OpenCV's resizeArea: horizontal taps accumulated per source row,
  then vertical taps accumulated per destination row, in float32."""
  xs, xw = _area_tab(img.shape[1], dw, scale_x)
  ys, yw = _area_tab(img.shape[0], dh, scale_y)
  rows = np.zeros((img.shape[0], dw, img.shape[2]), np.float32)
  for k in range(xs.shape[1]):
    rows = rows + img[:, xs[:, k]] * xw[:, k, None]
  out = rows[ys[:, 0]] * yw[:, 0, None, None]
  for k in range(1, ys.shape[1]):
    out = out + rows[ys[:, k]] * yw[:, k, None, None]
  return out


def _bilinear(img: np.ndarray, dw: int, dh: int, scale_x: float,
              scale_y: float, area_mode: bool) -> np.ndarray:
  """OpenCV's resizeGeneric with two taps per axis: along x a tap past
  either edge moves to the edge with weight 0, along y the two rows are
  clipped to the image and keep their weights."""
  h, w = img.shape[:2]
  sx, fx = _linear_tab(w, dw, scale_x, dw / w, area_mode)
  sy, fy = _linear_tab(h, dh, scale_y, dh / h, area_mode)
  edge = (sx < 0) | (sx >= w - 1)
  fx[edge] = 0.0
  sx = np.clip(sx, 0, w - 1)
  one = np.float32(1.0)
  rows = (img[:, sx] * (one - fx)[:, None]
          + img[:, np.minimum(sx + 1, w - 1)] * fx[:, None])   # [H, dw, C]
  return (rows[np.clip(sy, 0, h - 1)] * (one - fy)[:, None, None]
          + rows[np.clip(sy + 1, 0, h - 1)] * fy[:, None, None])


def _resize(img: np.ndarray, dsize: Tuple[int, int], area: bool):
  img = np.asarray(img, np.float32)
  squeeze = img.ndim == 2 or img.shape[2] == 1
  src = img.reshape(img.shape[0], img.shape[1], -1)
  dw, dh = dsize
  h, w = src.shape[:2]
  if (dw, dh) == (w, h):
    out = src.copy()
  else:
    inv_x, inv_y = dw / w, dh / h
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    fast = abs(scale_x - ix) < eps and abs(scale_y - iy) < eps
    if not area and fast and ix == 2 and iy == 2:
      area = True                    # cv2: a 2x linear downscale is a box
    if area and scale_x >= 1 and scale_y >= 1:
      out = (_box_mean(src, iy, ix) if fast
             else _area_down(src, dw, dh, scale_x, scale_y))
    else:
      out = _bilinear(src, dw, dh, scale_x, scale_y, area_mode=area)
  return out[..., 0] if squeeze else out


def resize_area(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
  """`cv2.resize(img, dsize, interpolation=cv2.INTER_AREA)` for a float32
  image [H, W] or [H, W, C]; dsize = (width, height)."""
  return _resize(img, dsize, area=True)


def resize_linear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
  """`cv2.resize(img, dsize)` (INTER_LINEAR) for a float32 image [H, W] or
  [H, W, C]; dsize = (width, height)."""
  return _resize(img, dsize, area=False)
