"""LR schedules (port of `repro/optim/schedule.py`). WSD (Warmup-Stable-
Decay) is included because minicpm-2b is trained with it (arXiv:2404.06395):
linear warmup, long stable plateau, then a short sharp decay.

`step` is a host int or a 0-d tensor; the result is a 0-d float32 tensor on
the step's device (the CPU for a host int), computed in float32 as the
reference computes it."""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def wsd(step, *, peak_lr: float, warmup_steps: int, stable_steps: int,
        decay_steps: int, final_frac: float = 0.1):
    s = _step_f32(step)
    warm = peak_lr * s / max(warmup_steps, 1)
    stable = torch.full_like(s, peak_lr)
    d = (s - warmup_steps - stable_steps) / max(decay_steps, 1)
    decay = peak_lr * torch.pow(final_frac, torch.clamp(d, 0.0, 1.0))
    return torch.where(s < warmup_steps, warm,
                       torch.where(s < warmup_steps + stable_steps, stable,
                                   decay))


def cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
           final_frac: float = 0.1):
    s = _step_f32(step)
    warm = peak_lr * s / max(warmup_steps, 1)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup_steps, warm, peak_lr * cos)


SCHEDULES = {"wsd": wsd, "cosine": cosine}
