"""LR schedules.  minicpm-2b trains with WSD (warmup-stable-decay,
arXiv:2404.06395); everything else defaults to cosine.

The counterpart of the JAX package's ``repro/optim/schedule.py``: the
step (an int or a tensor) is taken as float32 and every product is
float32, as ``jnp`` computes it; the result is a 0-d float32 tensor on
the step's device.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def wsd_schedule(step, base_lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.1) -> torch.Tensor:
    """Warmup-Stable-Decay: linear warmup, flat plateau, 1-cycle decay."""
    step = _f32(step)
    warm = base_lr * torch.clamp((step + 1) / max(1, warmup), max=1.0)
    in_decay = torch.clamp((step - warmup - stable) / max(1, decay),
                           0.0, 1.0)
    decay_mult = 1.0 - (1.0 - final_frac) * in_decay
    return torch.where(step < warmup + stable, warm, base_lr * decay_mult)


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = base_lr * torch.clamp((step + 1) / max(1, warmup), max=1.0)
    t = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, base_lr * cos)


def make_schedule(kind: str, base_lr: float, total_steps: int,
                  warmup: int | None = None):
    warmup = warmup if warmup is not None else max(10, total_steps // 50)
    if kind == "wsd":
        stable = int(0.8 * (total_steps - warmup))
        decay = total_steps - warmup - stable
        return lambda s: wsd_schedule(s, base_lr, warmup, stable, decay)
    return lambda s: cosine_schedule(s, base_lr, warmup, total_steps)
