"""Loss composition: base losses × colour spaces × tone map / gamma.

Counterpart of `nerf_atlas_tpu/train/losses.py`: the training loss is a
sum over the selected base losses (l2 / l1 / rmse / fft / ssim) in the
selected colour spaces (rgb / hsv / luminance / xyz), after an optional
tone map x/(1+x) and gamma decoding, plus an l2 term on a 4th (mask)
channel when both prediction and target carry one. l2, l1 and rmse take
flat ray batches [N, C]; the image-structured fft and ssim take crops
[..., H, W, C] (crop batches), and so does `ms_ssim`, the eval's
MS-SSIM.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from ..ops.math import rgb2hsv, rgb2luminance, rgb2xyz


def l2(x, ref):
  return torch.mean((x - ref) ** 2)


def l1(x, ref):
  return torch.mean(torch.abs(x - ref))


def rmse(x, ref):
  return torch.sqrt(torch.clamp(l2(x, ref), min=1e-12))


def fft_loss(x, ref):
  """Spectral L2 over the last three axes [..., H, W, C]: rfft2 over H
  and W."""
  fx = torch.fft.rfft2(x, dim=(-3, -2))
  fr = torch.fft.rfft2(ref, dim=(-3, -2))
  return torch.mean(torch.abs(fx - fr) ** 2)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None,
                     dtype=torch.float32):
  xs = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2
  g = torch.exp(-0.5 * (xs / sigma) ** 2)
  g = g / g.sum()
  return g[:, None] * g[None, :]


def ssim(x, ref, *, max_val: float = 1.0):
  """Single-scale SSIM over [..., H, W, C]: an 11×11 Gaussian (σ 1.5)
  filtered depthwise, VALID; the mean over channels and windows."""
  c = x.shape[-1]
  kern = _gaussian_kernel(device=x.device, dtype=x.dtype)[None, None].expand(
      c, 1, 11, 11)

  def filt(img):
    img4 = img.reshape((-1,) + img.shape[-3:]).permute(0, 3, 1, 2)
    out = F.conv2d(img4, kern, groups=c).permute(0, 2, 3, 1)
    return out.reshape(img.shape[:-3] + out.shape[-3:])

  mu_x, mu_r = filt(x), filt(ref)
  mu_x2, mu_r2, mu_xr = mu_x ** 2, mu_r ** 2, mu_x * mu_r
  sx = filt(x * x) - mu_x2
  sr = filt(ref * ref) - mu_r2
  sxr = filt(x * ref) - mu_xr
  c1 = (0.01 * max_val) ** 2
  c2 = (0.03 * max_val) ** 2
  score = ((2 * mu_xr + c1) * (2 * sxr + c2)) / (
      (mu_x2 + mu_r2 + c1) * (sx + sr + c2))
  return torch.mean(score)


def ssim_loss(x, ref):
  return 1.0 - ssim(x, ref)


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2(img):
  """2x average-pool over [..., H, W, C] (an odd last row or column is
  dropped)."""
  h, w = img.shape[-3] // 2, img.shape[-2] // 2
  img = img[..., :h * 2, :w * 2, :]
  img = img.reshape(img.shape[:-3] + (h, 2, w, 2, img.shape[-1]))
  return img.mean(dim=(-4, -2))


def ms_ssim(x, ref, *, max_val: float = 1.0, levels: int = 5):
  """Multi-scale SSIM over [..., H, W, C] with the standard 5-level
  weights, fewer levels (weights renormalised) while an image's side
  halved stays under 11."""
  h = min(x.shape[-3], x.shape[-2])
  usable = 1
  while usable < levels and (h >> usable) >= 11:
    usable += 1
  weights = torch.tensor(_MSSSIM_WEIGHTS[:usable], dtype=torch.float32)
  weights = weights / weights.sum()
  total = 1.0
  for i in range(usable):
    s = ssim(x, ref, max_val=max_val)
    total = total * torch.clamp(s, min=1e-6) ** weights[i].to(s.device)
    if i + 1 < usable:
      x, ref = _downsample2(x), _downsample2(ref)
  return total


LOSS_KINDS = {"l2": l2, "l1": l1, "rmse": rmse, "fft": fft_loss,
              "ssim": ssim_loss}

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
  """loss(pred [..., 3|4], target [..., C]) -> scalar ([N, C] ray
  batches; [..., H, W, C] crops for fft and ssim).

  gamma_correct: bool (True -> 2.2) or a float gamma (1.0 and False are
  the identity)."""
  for k in loss_kinds:
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
