"""Dataset loaders. Contract: `load(...) -> DatasetBundle(labels, camera,
lights|None)` with labels imgs [N,S,S,C] float32 in [0, 1], or (imgs,
times [N]) for a dynamic scene.

Counterpart of `nerf_atlas_tpu/data/loaders.py`:
  original      NeRF-synthetic / NeRFactor JSON + PNGs (alpha kept as the
                4th channel; `white_bg` composites over white)
  dnerf         D-NeRF JSON with per-frame times (+ the Gibson quirks)
  dtu           DTU scans: cameras.npz projection matrices, image/ and
                mask/ (the mask as the 4th channel)
  shiny         NeX's LLFF layout (poses_bounds.npy, optional hwf_cxcy.npy)
  pixel-single  one image with an identity camera
  synthetic, synthetic-dyn, synthetic-ff   the procedural scene
Images are read by the port's own PNG decoder and resized by its copy of
cv2's INTER_AREA (`image_io`), so labels equal the JAX loaders'. JPEG
images raise (ROADMAP Queue 4 #1), and so do `nerv_point` (EXR and point
lights), `single_video` (a video decoder) and `synthetic-lit` (point
lights), naming their ROADMAP items. Labels stay numpy on the host; each
camera's tensors lie on `device`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import cameras as cam_lib
from . import image_io, synthetic

# images decoded (in lockstep) and resized per group
_READ_GROUP = 16


class DatasetBundle(NamedTuple):
  labels: Any            # imgs [N,S,S,C], or (imgs, times [N])
  camera: Any
  lights: Optional[Any]  # point-light positions [N, L, 3] or None


def _resize(img: np.ndarray, size: int) -> np.ndarray:
  """`loaders._resize`: INTER_AREA to size × size unless already so."""
  if img.shape[0] == size and img.shape[1] == size:
    return img
  return image_io.resize_area(img, (size, size))


def _read_all(paths: Sequence[str], fn: Callable) -> List[Any]:
  """fn(float32 image) of each path (`image_io.imreads`), a group of
  files at a time."""
  out = []
  for i in range(0, len(paths), _READ_GROUP):
    out += [fn(img) for img in image_io.imreads(paths[i:i + _READ_GROUP])]
  return out


def _frame_path(path: str, frame: dict) -> str:
  fp = os.path.join(path, frame["file_path"])
  return fp if os.path.splitext(fp)[1] else fp + ".png"


def _white_bg(img: np.ndarray, white_bg: bool) -> np.ndarray:
  if img.shape[-1] == 4 and white_bg:
    rgb, a = img[..., :3], img[..., 3:]
    img = np.concatenate([rgb * a + (1 - a), a], -1)
  return img


def original(path: str, training: bool = True, size: int = 256,
             white_bg: bool = False, device=None):
  """NeRF-synthetic format: transforms_{train,test}.json (or
  transforms.json) + RGBA PNGs. The alpha channel rides through as the
  4th label channel either way."""
  kind = "train" if training else "test"
  tfs_path = os.path.join(path, f"transforms_{kind}.json")
  if not os.path.exists(tfs_path):
    tfs_path = os.path.join(path, "transforms.json")
  with open(tfs_path) as f:
    meta = json.load(f)
  frames = meta["frames"]
  imgs = _read_all([_frame_path(path, fr) for fr in frames],
                   lambda img: _white_bg(_resize(img, size), white_bg))
  poses = np.stack([np.asarray(fr["transform_matrix"], np.float32)
                    for fr in frames])
  camera = cam_lib.NeRFCamera.from_json_transforms(
      poses, float(meta["camera_angle_x"]), size, device=device)
  return DatasetBundle(np.stack(imgs), camera, None)


def dnerf(path: str, training: bool = True, size: int = 256,
          white_bg: bool = False, time_gamma: bool = False, device=None):
  """D-NeRF format: frames carry a `time` (or Gibson `timestep`) field;
  frames sorted by time, times normalized to [0, 1] only when they fall
  outside it. On a path naming "gibson", camera_angle_x is in degrees and
  the matrices are world-to-camera (inverted here). time_gamma: each
  image's rgb ** exp(2t − 1), alpha untouched."""
  kind = "train" if training else "test"
  with open(os.path.join(path, f"transforms_{kind}.json")) as f:
    meta = json.load(f)
  is_gibson = "gibson" in path.lower()

  def frame_time(fr):
    return float(fr.get("time", fr.get("timestep", 0.0)))

  frames = sorted(meta["frames"], key=frame_time)
  imgs = np.stack(_read_all(
      [_frame_path(path, fr) for fr in frames],
      lambda img: _white_bg(_resize(img, size), white_bg)))
  poses = []
  for frame in frames:
    tf = np.asarray(frame["transform_matrix"], np.float32)
    poses.append(np.linalg.inv(tf) if is_gibson else tf)
  times = np.asarray([frame_time(fr) for fr in frames], np.float32)
  if times.min() < 0 or times.max() > 1:
    span = max(times.max() - times.min(), 1e-8)
    times = np.clip((times - times.min()) / span, 0.0, 1.0)
  if time_gamma:
    g = np.exp(2.0 * times - 1.0)[:, None, None, None]
    imgs = np.concatenate([imgs[..., :3] ** g, imgs[..., 3:]], -1)
  cam_angle = float(meta["camera_angle_x"])
  if is_gibson:
    cam_angle *= np.pi / 180.0
  camera = cam_lib.NeRFCamera.from_json_transforms(
      np.stack(poses), cam_angle, size, device=device)
  return DatasetBundle((imgs, times), camera, None)


def _decompose_projection(P: np.ndarray):
  """P = K [R | t] -> (K, R, camera centre) by RQ decomposition, K's
  diagonal positive, det R = +1, K[2, 2] = 1."""
  import scipy.linalg
  K, R = scipy.linalg.rq(P[:, :3])
  signs = np.sign(np.diag(K))
  signs[signs == 0] = 1
  K = K * signs[None, :]
  R = R * signs[:, None]
  if np.linalg.det(R) < 0:
    R = -R
  t = np.linalg.solve(K, P[:, 3])
  center = -R.T @ t
  return K / K[2, 2], R, center


def dtu(path: str, training: bool = True, size: int = 256,
        with_mask: bool = True, max_views: Optional[int] = None,
        device=None):
  """DTU scan: image/*.png + mask/*.png + cameras.npz with world_mat_i
  (projection) and scale_mat_i (scene normalization). Every image is
  squeezed to size × size; K rescales by size/W and size/H. The mask is
  the 4th channel, thresholded at 0.5. Both splits are all views."""
  del training
  npz = np.load(os.path.join(path, "cameras.npz"))
  img_dir = os.path.join(path, "image")
  names = sorted(os.listdir(img_dir))
  if max_views:
    names = names[:max_views]
  shapes = []

  def rgb(img):
    shapes.append(img.shape[:2])
    return _resize(img, size)[..., :3]

  imgs = _read_all([os.path.join(img_dir, n) for n in names], rgb)
  masked = [with_mask and os.path.exists(os.path.join(path, "mask", n))
            for n in names]

  def mask(m):
    m = _resize(m, size)
    m = m[..., :1] if m.ndim == 3 else m[..., None]
    return (m > 0.5).astype(np.float32)

  masks = iter(_read_all([os.path.join(path, "mask", n)
                          for n, on in zip(names, masked) if on], mask))
  poses, Ks = [], []
  for i, ((orig_h, orig_w), on) in enumerate(zip(shapes, masked)):
    if on:
      imgs[i] = np.concatenate([imgs[i], next(masks)], -1)
    P = npz[f"world_mat_{i}"][:3] @ npz.get(f"scale_mat_{i}", np.eye(4))
    K, R, center = _decompose_projection(P)
    K = np.diag([size / orig_w, size / orig_h, 1.0]) @ K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = center
    poses.append(pose)
    Ks.append(K.astype(np.float32))
  camera = cam_lib.DTUCamera(
      pose=torch.as_tensor(np.stack(poses), device=device),
      K=torch.as_tensor(np.stack(Ks), device=device))
  return DatasetBundle(np.stack(imgs), camera, None)


def shiny(path: str, training: bool = True, size: int = 256,
          test_every: int = 8, device=None):
  """NeX "shiny" dataset (LLFF layout): poses_bounds.npy (+ optional
  hwf_cxcy.npy intrinsics) + images/. LLFF pose columns [down, right,
  back] become NeRF's [right, up, back], translations scale by
  1/(0.75·near), the focal by size/W; every `test_every`-th view is the
  held-out split."""
  poses_arr = np.load(os.path.join(path, "poses_bounds.npy"))
  hwf_path = os.path.join(path, "hwf_cxcy.npy")
  if os.path.exists(hwf_path):
    _, w, fx, fy, _, _ = np.load(hwf_path).astype(np.float64)
    if abs(fx - fy) >= 1e-3 * max(fx, fy):
      raise ValueError(f"shiny: fx {fx} and fy {fy} differ")
    poses = poses_arr[:, :-2].reshape(-1, 3, 4)
  else:
    poses = poses_arr[:, :-2].reshape(-1, 3, 5)
    _, w, fx = poses[0, :, 4]
    poses = poses[:, :, :4]
  bds = poses_arr[:, -2:]
  poses = np.concatenate(
      [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:4]], -1)
  poses[:, :, 3] *= 1.0 / (0.75 * max(float(bds.min()), 1e-6))
  img_dir = os.path.join(path, "images")
  names = sorted(f for f in os.listdir(img_dir)
                 if f.lower().endswith((".jpg", ".jpeg", ".png")))
  if len(names) != poses.shape[0]:
    raise ValueError(f"shiny: {len(names)} images, {poses.shape[0]} poses")
  keep = [i for i in range(len(names))
          if (i % test_every == 0) != training] or list(range(len(names)))
  imgs = _read_all([os.path.join(img_dir, names[i]) for i in keep],
                   lambda img: _resize(img, size)[..., :3])
  c2w = np.tile(np.eye(4, dtype=np.float32), (len(keep), 1, 1))
  c2w[:, :3, :4] = poses[keep].astype(np.float32)
  camera = cam_lib.NeRFCamera(
      cam_to_world=torch.as_tensor(c2w, device=device),
      focal=torch.tensor(fx * size / w, dtype=torch.float32, device=device))
  return DatasetBundle(np.stack(imgs), camera, None)


def single_image(path: str, training: bool = True, size: int = 256,
                 device=None):
  """One image + an identity camera with focal size/2 (PixelNeRF
  single-view)."""
  del training
  img = _resize(image_io.imread(path), size)[None]
  camera = cam_lib.NeRFCamera.identity(1, focal=size * 0.5, device=device)
  return DatasetBundle(img, camera, None)


def synthetic_spheres(path: str = "", training: bool = True, size: int = 64,
                      num_views: int = 8, dynamic: bool = False,
                      front_facing: bool = False, device=None):
  """Procedural golden scene (see synthetic.py). `path` ignored; the train
  split draws its poses from seed 0, the test split from seed 1."""
  del path
  labels, camera, lights = synthetic.dataset(
      num_views=num_views, size=size, dynamic=dynamic,
      seed=0 if training else 1, front_facing=front_facing, device=device)
  return DatasetBundle(labels, camera, lights)


def synthetic_dynamic(*args, **kwargs):
  """The dynamic procedural scene (`--data-kind synthetic-dyn`)."""
  return synthetic_spheres(*args, dynamic=True, **kwargs)


def synthetic_front_facing(*args, **kwargs):
  """The procedural scene from LLFF-style poses (`--data-kind
  synthetic-ff`)."""
  return synthetic_spheres(*args, front_facing=True, **kwargs)


LOADER_KINDS = {
    "original": original,
    "dnerf": dnerf,
    "dtu": dtu,
    "shiny": shiny,
    "pixel-single": single_image,
    "synthetic": synthetic_spheres,
    "synthetic-dyn": synthetic_dynamic,
    "synthetic-ff": synthetic_front_facing,
}
# kinds the port cannot load yet -> what they wait for
_WAITING = {
    "nerv_point": "EXR images (ROADMAP Queue 4 #2) and point lights "
                  "(Queue 1 #13)",
    "single_video": "a video decoder (ROADMAP Queue 4 #3)",
    "synthetic-lit": "point lights (ROADMAP Queue 1 #13)",
}


def kind_from_path(path: str) -> str:
  """Derive the loader kind from the data path (same rules as the JAX
  package)."""
  ext = os.path.splitext(path)[1].lower()
  if ext in (".mp4", ".gif", ".avi"):
    return "single_video"
  if ext in (".png", ".jpg", ".jpeg"):
    return "pixel-single"
  if os.path.isdir(path):
    if os.path.exists(os.path.join(path, "cameras.npz")):
      return "dtu"
    if os.path.exists(os.path.join(path, "poses_bounds.npy")):
      return "shiny"
    for name in ("transforms_train.json", "transforms.json"):
      p = os.path.join(path, name)
      if os.path.exists(p):
        with open(p) as f:
          return "dnerf" if '"time"' in f.read() else "original"
  return "synthetic"


def load(data_path: str, data_kind: Optional[str] = None,
         training: bool = True, size: int = 256, device=None,
         **kwargs) -> DatasetBundle:
  kind = data_kind or kind_from_path(data_path)
  if kind in _WAITING:
    raise NotImplementedError(
        f"data kind {kind}: waits for {_WAITING[kind]}")
  fn = LOADER_KINDS.get(kind)
  if fn is None:
    raise NotImplementedError(f"unknown data kind {kind}")
  return fn(data_path, training=training, size=size, device=device, **kwargs)
