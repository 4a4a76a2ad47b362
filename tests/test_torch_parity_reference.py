"""The port against the original PyTorch repo's own outputs.

Mirrors the `tests/test_parity_reference.py` cases for the modules the
port carries (render core, cameras, sigmoid zoo, positional encoder,
SkipConnMLP weight transplant), on the same fixture keys of
`tests/fixtures/parity_reference.npz` and with the same tolerances. The
reference puts the sample axis T first; the port puts it last, so the
fixtures are moveaxis'd as in the JAX tests. These are plain torch on
small arrays, so they run in the fast tier.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch.data.cameras import NeRFCamera  # noqa: E402
from nerf_atlas_tpu_torch.nn import (PositionalEncoder,  # noqa: E402
                                     SkipConnMLP)
from nerf_atlas_tpu_torch.ops import integrate  # noqa: E402
from nerf_atlas_tpu_torch.ops import math as tmath  # noqa: E402
from nerf_atlas_tpu_torch.ops import rays as rays_ops  # noqa: E402

FIX = os.path.join(os.path.dirname(__file__), "fixtures",
                   "parity_reference.npz")


@pytest.fixture(scope="module")
def fx():
  assert os.path.exists(FIX), (
      "run scripts/gen_parity_fixtures.py to generate parity fixtures")
  return dict(np.load(FIX))


def t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def close(a, b, tol=2e-5):
  a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
  np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                             atol=tol)


@pytest.mark.parametrize("tag,softplus", [("softplus", True), ("relu", False)])
def test_alpha_chain(fx, tag, softplus):
  # torch's softplus switches to identity above threshold=20 in the
  # reference as here; the tolerance stays the JAX test's
  tol = 1e-4 if softplus else 2e-5
  density = np.moveaxis(fx["alpha_in_0"], 0, -1)    # [B, H, W, T]
  ts = fx["alpha_in_1"]
  r_d = fx["alpha_in_2"]
  rgb = np.moveaxis(fx["alpha_in_3"], 0, -2)        # [B, H, W, T, 3]
  alpha, weights = integrate.alpha_from_density(t(density), t(ts), t(r_d),
                                                softplus=softplus)
  close(alpha, np.moveaxis(fx[f"alpha_out_{tag}_0"], 0, -1), tol=tol)
  close(weights, np.moveaxis(fx[f"alpha_out_{tag}_1"], 0, -1), tol=tol)
  img = integrate.volumetric_integrate(weights, t(rgb))
  close(img, fx[f"alpha_out_{tag}_2"], tol=tol)


def test_exclusive_cumprod(fx):
  x = np.moveaxis(fx["cumuprod_0"], 0, -1)
  close(integrate.exclusive_cumprod(t(x)),
        np.moveaxis(fx["cumuprod_1"], 0, -1))


@pytest.mark.parametrize("tag,lindisp", [("linear", False), ("lindisp", True)])
def test_compute_pts_ts(fx, tag, lindisp):
  T = fx[f"pts_out_{tag}_1"].shape[0]
  pts, ts, r_o, r_d = rays_ops.compute_pts_ts(t(fx["pts_in_0"]), 2.0, 6.0,
                                              T, lindisp=lindisp)
  close(ts, fx[f"pts_out_{tag}_1"])
  close(pts, np.moveaxis(fx[f"pts_out_{tag}_0"], 0, -2))
  close(r_o, fx[f"pts_out_{tag}_2"])
  close(r_d, fx[f"pts_out_{tag}_3"])


def test_nerf_camera_rays(fx):
  c2w34 = fx["camera_in_0"]                          # [N, 3, 4]
  n = c2w34.shape[0]
  bottom = np.broadcast_to(np.array([0.0, 0, 0, 1], np.float32), (n, 1, 4))
  cam = NeRFCamera(cam_to_world=t(np.concatenate([c2w34, bottom], axis=1)),
                   focal=t(np.asarray(fx["camera_in_1"])))
  rays = cam.sample_positions(t(fx["camera_in_2"]), size=8)
  close(rays, fx["camera_rays_0"], tol=1e-4)


@pytest.mark.parametrize("kind", ["fat", "thin", "upshifted",
                                  "upshifted_softplus", "upshifted_relu"])
def test_sigmoid_zoo(fx, kind):
  fn = {"fat": tmath.fat_sigmoid, "thin": tmath.thin_sigmoid,
        "upshifted": tmath.upshifted_sigmoid,
        "upshifted_softplus": tmath.upshifted_softplus,
        "upshifted_relu": tmath.upshifted_relu}[kind]
  tol = 1e-4 if "softplus" in kind else 2e-5
  close(fn(t(fx["sigmoid_in_0"])), fx[f"sigmoid_{kind}_0"], tol=tol)


@pytest.mark.parametrize("tag,log", [("lin", False), ("log", True)])
def test_positional_encoder(fx, tag, log):
  pe = PositionalEncoder(input_dims=3, max_freq_log2=4.0,
                         min_freq_log2=1.0 if log else 0.0, num_freqs=6,
                         log_sampling=log, include_input=False)
  close(pe.freqs(), fx[f"posenc_{tag}_0"])            # band convention
  close(pe(t(fx["fourier_1"])), fx[f"posenc_{tag}_1"], tol=1e-4)


@pytest.mark.parametrize("init", ["default", "xavier", "siren", "kaiming",
                                  "zero"])
def test_skipconnmlp_transplant_plain(fx, init):
  """Identical weights -> identical outputs for every reference init kind:
  the reference's Linear names map onto the port's (init -> layer_in,
  layers.i -> layer_i, out -> layer_out) with no transpose, both being
  torch [out, in]."""
  tag = f"plain_{init}"
  mlp = SkipConnMLP(in_size=3, out=4, num_layers=5, hidden_size=32, skip=3)
  names = {"layer_in": "init", "layer_out": "out",
           **{f"layer_{i}": f"layers.{i}" for i in range(5)}}
  mlp.load_state_dict({f"{ours}.{p}": t(fx[f"mlp_{tag}_w_{ref}.{p}"])
                       for ours, ref in names.items()
                       for p in ("weight", "bias")})
  with torch.no_grad():
    out = mlp(t(fx[f"mlp_{tag}_io_0"]))
  close(out, fx[f"mlp_{tag}_io_1"], tol=1e-4)
