"""Learning-rate schedules (the port of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def cosine_schedule(peak: float, warmup_steps: int, total_steps: int,
                    floor_frac: float = 0.1):
    """``lr(step)``: linear warm-up from 0 at step 0 to ``peak`` at
    ``warmup_steps``, then a cosine down to ``floor_frac · peak`` at
    ``total_steps``.  Computed in f32 as JAX computes it; returns a 0-dim
    f32 tensor on the CPU."""

    def lr(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = peak * s / max(1.0, warmup_steps)
        prog = torch.clamp((s - warmup_steps) / max(1.0, total_steps - warmup_steps),
                           0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                      * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return lr
