"""The point-sampled dynamic regularizers on the two-kernel path, and the
runner's dynamic flags, on the CPU against the JAX package (split from
tests/test_torch_dyn_family_train.py, whose helpers these tests use).

- Three train steps, as tests/test_torch_dyn_family_train.py holds them
  (loss 1e-5 relative, each gradient tensor 1e-4 relative, the last Adam
  update 1e-2 of the learning rate), of DynamicNeRF's S = 4 spline over
  plain-cp with --dp-weight, spline length, spline point 0, divergence
  and FFJORD divergence on the two-kernel path (`fused`: the plain K9f
  with its dp² column and the plain K9b-G, the point-sampled terms by
  autograd on the JAX package's draws, the JAX side's draws replaced by
  the same points).
- The runner on the CPU at a tiny size: the flow and rigidity maps, the
  frames over time, the keyframes and clusters.png (tab10's colours),
  each new --dyn-model and flag, and its build rules.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from nerf_atlas_tpu_torch import runner  # noqa: E402

from test_torch_dyn_family_train import _dataset, three_steps  # noqa: E402


def test_three_steps_match_jax(monkeypatch):
  three_steps("spline-points", monkeypatch)


# ---- the runner ----

def _run(tmp_path, name, *extra):
  out = tmp_path / name
  res = runner.main(["--data-kind", "synthetic-dyn", "--model", "plain",
                     "--dyn-model", "plain", "--size", "8", "--num-views",
                     "3", "--steps", "8", "--batch-size", "32", "-lr",
                     "1e-3", "--seed", "0", "--valid-freq", "0", "--nosave",
                     "--outdir", str(out), *extra], device="cpu")
  return res, out


def _png_shape(path):
  import struct
  data = path.read_bytes()
  assert data[:8] == b"\x89PNG\r\n\x1a\n"
  return struct.unpack(">II", data[16:24])


def test_runner_writes_maps_frames_keyframes_and_clusters(tmp_path):
  res, out = _run(
      tmp_path, "spline", "--spline", "4", "--epochs", "2", "--dp-weight",
      "1e-3", "--spline-len-decay", "1e-3", "--spline-pt0-decay", "1e-3",
      "--dyn-divergence-weight", "1e-3", "--flow-images",
      "--rigidity-images", "--cluster-movement", "3", "--render-over-time",
      "1", "--render-frames", "2", "--render-bezier-keyframes")
  assert res["engaged_path"] == "fused"
  for split in ("train", "test"):
    for m in ("flow", "rigidity", "test"):
      for v in range(3):
        assert _png_shape(out / split / f"{m}_{v:03d}.png") == (8, 8)
  assert sorted(p.name for p in out.glob("over_time_*.png")) == [
      "over_time_000.png", "over_time_001.png"]
  assert sorted(p.name for p in out.glob("keyframe_*.png")) == [
      f"keyframe_{i:02d}.png" for i in range(4)]
  assert _png_shape(out / "clusters.png") == (8, 8)
  matplotlib = pytest.importorskip("matplotlib")
  want = np.array(matplotlib.colormaps["tab10"].colors)
  np.testing.assert_array_equal(runner.TAB10, want)
  img = (runner.TAB10 * 255).astype(np.uint8)
  np.testing.assert_array_equal(
      img, (matplotlib.colormaps["tab10"](np.arange(10))[:, :3] * 255
            ).astype(np.uint8))


@pytest.mark.parametrize("extra,cls", [
    (("--model", "ae", "--dyn-model", "ae", "--dp-weight", "1e-3"),
     "DynamicNeRFAE"),
    (("--dyn-model", "long", "--long-vid-segments", "2", "--offset-decay",
      "1e-3"), "LongDynamicNeRF"),
    (("--dyn-model", "long", "--long-vid-progressive-train", "2",
      "--epochs", "50"), "LongDynamicNeRF"),
    (("--dyn-refl-latent", "4", "--offset-decay", "1e-3",
      "--rigidity-sparsity", "1e-3", "--ffjord-div-decay", "1e-3"),
     "DynamicNeRF"),
    (("--model", "tiny", "--spline-len-decay", "1e-3"), "DynamicNeRF"),
    (("--model", "coarse_fine", "--enc-kind", "cp"), "DynamicNeRF")])
def test_runner_trains_the_family_on_cpu(tmp_path, extra, cls):
  res, out = _run(tmp_path, "run", "--epochs", "2", *extra)
  assert res["engaged_path"] == "oracle"
  assert all(np.isfinite(h["loss"]) for h in res["history"])
  if "--long-vid-progressive-train" in extra:      # logged every 50 steps
    assert [(h["segment"], h["step"]) for h in res["history"]] == [
        (0, 50), (1, 50)]
  with open(out / "log.json") as f:
    assert json.load(f)["engaged_path"] == "oracle"
  for split in ("train", "test"):
    assert np.isfinite(res[split]["psnrs"]).all()
  args = runner.cli.arguments(["--data-kind", "synthetic-dyn",
                               "--dyn-model", "plain", *extra])
  assert type(runner.build_model(args, "cpu", dynamic=True)).__name__ == cls


def test_runner_build_rules():
  def build(*flags):
    args = runner.cli.arguments(["--data-kind", "synthetic-dyn", *flags])
    return runner.build_model(args, "cpu", dynamic=True)

  ae = build("--dyn-model", "ae", "--encoding-size", "16",
             "--normalize-latent", "--refl-kind", "view")
  assert ae.canonical.encoding_size == 32 and ae.canonical.normalize_latent
  plain = build("--dyn-model", "plain", "--enc-kind", "posenc", "--spline",
                "3", "--dyn-refl-latent", "4")
  assert plain.canonical_kwargs == {"refl_kind": "view",
                                    "enc_kind": "posenc"}
  assert plain.canonical.latent_size == 4 and plain.spline_points == 3
  tiny = build("--dyn-model", "plain", "--model", "tiny")
  assert tiny.canonical_kwargs == {}
  cf = build("--dyn-model", "long", "--model", "coarse_fine",
             "--long-vid-segments", "3")
  assert cf.canonical_kwargs == {"refl_kind": "view"} and cf.segments == 3
  assert cf.canonical.enc_kind == "hash"           # the class's default
  with pytest.raises(NotImplementedError, match="dyn.py:108"):
    build("--dyn-model", "plain", "--model", "volsdf")
  static = runner.build_model(runner.cli.arguments(
      ["--data-kind", "synthetic", "--dyn-model", "ae"]), "cpu")
  assert type(static).__name__ == "PlainNeRF"
  args = runner.cli.arguments(["--long-vid-progressive-train"])
  assert runner._progressive_segments(args, _dataset()) == 4
  args = runner.cli.arguments(["--long-vid-progressive-train",
                               "--long-vid-chunk-len-sec", "0.05"])
  assert runner._progressive_segments(args, _dataset(views=6)) == 4
