"""Loss composition: base losses × colour spaces × tone map / gamma.

Counterpart of `nerf_atlas_tpu/train/losses.py`: the training loss is a
sum over the selected base losses (l2 / l1 / rmse) in the selected
colour spaces (rgb / hsv / luminance / xyz), after an optional tone map
x/(1+x) and gamma decoding, plus an l2 term on a 4th (mask) channel when
both prediction and target carry one. All losses take flat ray batches
[N, C]. The image-structured losses (fft, ssim, ms-ssim) need crop
batches and arrive with ROADMAP Queue 1 #5.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..ops.math import rgb2hsv, rgb2luminance, rgb2xyz


def l2(x, ref):
  return torch.mean((x - ref) ** 2)


def l1(x, ref):
  return torch.mean(torch.abs(x - ref))


def rmse(x, ref):
  return torch.sqrt(torch.clamp(l2(x, ref), min=1e-12))


LOSS_KINDS = {"l2": l2, "l1": l1, "rmse": rmse}
CROP_LOSS_KINDS = ("fft", "ssim")

COLOR_SPACES = {
    "rgb": lambda v: v,
    "hsv": rgb2hsv,
    "luminance": rgb2luminance,
    "xyz": rgb2xyz,
}


def mse2psnr(mse):
  """PSNR of a mean squared error (a tensor or a float), clamped at
  1e-10."""
  return -10.0 * torch.log10(torch.clamp(torch.as_tensor(mse), min=1e-10))


def psnr(x, ref):
  return mse2psnr(l2(x, ref))


def load_loss_fn(loss_kinds: Sequence[str] = ("l2",),
                 color_spaces: Sequence[str] = ("rgb",),
                 tone_map: bool = False, gamma_correct=False) -> Callable:
  """loss(pred [N, 3|4], target [N, C]) -> scalar.

  gamma_correct: bool (True -> 2.2) or a float gamma (1.0 and False are
  the identity)."""
  for k in loss_kinds:
    if k in CROP_LOSS_KINDS:
      raise NotImplementedError(
          f"loss {k}: needs crop batches, which arrive with ROADMAP Queue 1 "
          "#5")
    if k not in LOSS_KINDS:
      raise NotImplementedError(f"unknown loss kind {k}")
  for c in color_spaces:
    if c not in COLOR_SPACES:
      raise NotImplementedError(f"unknown color space {c}")
  fns = [LOSS_KINDS[k] for k in loss_kinds]
  spaces = [COLOR_SPACES[c] for c in color_spaces]
  gamma = (2.2 if gamma_correct is True
           else float(gamma_correct) if gamma_correct else 1.0)

  def loss(pred, target):
    pred_rgb = pred[..., :3]
    targ_rgb = target[..., :3]
    if tone_map:
      pred_rgb = pred_rgb / (1 + pred_rgb)
      targ_rgb = targ_rgb / (1 + targ_rgb)
    if gamma != 1.0:
      pred_rgb = torch.sign(pred_rgb) * torch.abs(pred_rgb) ** (1 / gamma)
      targ_rgb = torch.sign(targ_rgb) * torch.abs(targ_rgb) ** (1 / gamma)
    total = 0.0
    for f in fns:
      for s in spaces:
        total = total + f(s(pred_rgb), s(targ_rgb))
    if pred.shape[-1] > 3 and target.shape[-1] > 3:
      total = total + l2(pred[..., 3:4], target[..., 3:4])
    return total

  return loss
