"""LR schedules (step-indexed callables; port of
``repro.optim.schedules``). ``step`` is an int tensor, as the optimizers
pass it."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(torch.as_tensor(step).float() / total_steps, max=1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return torch.tensor(lr, dtype=torch.float32) * (
            final_frac + (1 - final_frac) * cos)

    return f


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(1, total_steps - warmup_steps), final_frac)

    def f(step):
        s = torch.as_tensor(step).float()
        warm = torch.tensor(lr, dtype=torch.float32) * s / max(1, warmup_steps)
        return torch.where(s < warmup_steps, warm,
                           cos(torch.as_tensor(step) - warmup_steps))

    return f
