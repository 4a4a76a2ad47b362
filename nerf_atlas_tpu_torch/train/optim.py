"""Optimizers with the JAX package's (optax's) semantics.

Counterpart of `nerf_atlas_tpu/train/optim.py:load_optimizer`: the chain
[clip by global norm] -> [add decayed weights] -> optimizer, with the
learning rate on optax's cosine decay to `sched_min` over the run
(`no_sched` keeps it constant). Every optimizer keeps optax's defaults,
not torch's: adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root),
adamw (weight decay 1e-4 unless --decay sets it), sgd (no momentum) and
rmsprop (decay 0.9, eps 1e-8 inside the square root). UniformAdam and
gradient accumulation arrive with ROADMAP Queue 1 #13.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


def cosine_decay(step: int, total_steps: int, alpha: float) -> float:
  """optax.cosine_decay_schedule's factor at `step` (step 0 is the first
  update): (1 − α)·½(1 + cos(π·min(step, total)/total)) + α."""
  frac = min(step, total_steps) / total_steps
  return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha


class RMSprop(torch.optim.Optimizer):
  """optax.rmsprop: nu = d·nu + (1 − d)·g²; p −= lr·g/√(nu + eps)."""

  def __init__(self, params, lr: float, decay: float = 0.9,
               eps: float = 1e-8):
    super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

  @torch.no_grad()
  def step(self, closure=None):
    for group in self.param_groups:
      for p in group["params"]:
        if p.grad is None:
          continue
        nu = self.state[p].setdefault("nu", torch.zeros_like(p))
        nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                         value=1 - group["decay"])
        p.addcdiv_(p.grad, torch.sqrt(nu + group["eps"]), value=-group["lr"])


class TrainOptimizer:
  """The optimizer chain over a list of parameters: `step()` applies
  clipping and decay to their .grad, steps the optimizer and the
  schedule."""

  def __init__(self, opt: torch.optim.Optimizer,
               sched: torch.optim.lr_scheduler.LRScheduler,
               grad_clip: float, weight_decay: float):
    self.opt = opt
    self.sched = sched
    self.grad_clip = grad_clip
    self.weight_decay = weight_decay

  @property
  def params(self):
    return [p for g in self.opt.param_groups for p in g["params"]]

  def zero_grad(self):
    self.opt.zero_grad(set_to_none=True)

  @torch.no_grad()
  def step(self):
    grads = [p.grad for p in self.params if p.grad is not None]
    if self.grad_clip > 0 and grads:
      # optax.clip_by_global_norm: scale by max_norm/norm when norm is
      # larger
      norm = torch.linalg.vector_norm(
          torch.stack([torch.linalg.vector_norm(g) for g in grads]))
      scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                          self.grad_clip / norm)
      for g in grads:
        g.mul_(scale)
    if self.weight_decay:
      for p in self.params:
        if p.grad is not None:
          p.grad.add_(p, alpha=self.weight_decay)
    self.opt.step()
    self.sched.step()


OPT_KINDS = ("adam", "adamw", "sgd", "rmsprop")


def load_optimizer(params: Iterable[torch.nn.Parameter], kind: str = "adam",
                   learning_rate: float = 5e-4,
                   total_steps: Optional[int] = None,
                   sched_min: float = 5e-5, no_sched: bool = False,
                   grad_clip: float = 0.0, accum_steps: int = 1,
                   weight_decay: float = 0.0) -> TrainOptimizer:
  if kind == "uniform_adam":
    raise NotImplementedError(
        "--opt-kind uniform_adam: arrives with ROADMAP Queue 1 #13")
  if kind not in OPT_KINDS:
    raise NotImplementedError(f"unknown optimizer kind {kind}")
  if accum_steps > 1:
    raise NotImplementedError(
        "--opt-step > 1 (gradient accumulation): arrives with ROADMAP "
        "Queue 1 #13")
  params = list(params)
  if kind == "adam":
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
  elif kind == "adamw":
    # the decay lives in AdamW itself, as in optax.adamw
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay or 1e-4)
  elif kind == "sgd":
    opt = torch.optim.SGD(params, lr=learning_rate)
  else:
    opt = RMSprop(params, lr=learning_rate)
  if no_sched or total_steps is None:
    factor = lambda step: 1.0  # noqa: E731
  else:
    alpha = sched_min / learning_rate
    factor = lambda step: cosine_decay(step, total_steps, alpha)  # noqa: E731
  sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
  return TrainOptimizer(opt, sched, grad_clip,
                        0.0 if kind == "adamw" else weight_decay)
