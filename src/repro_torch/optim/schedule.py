"""Learning-rate schedules, pure functions of the step counter
(counterpart of ``repro/optim/schedule.py``); fp32 0-dim tensors."""

from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        t = torch.clamp(s, max=total_steps) / max(total_steps, 1)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (min_frac + (1 - min_frac) * cos)

    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), min_frac)

    def lr(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return lr
