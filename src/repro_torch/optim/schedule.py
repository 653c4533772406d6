"""LR schedules (step -> multiplier on the base LR), port of
``repro/optim/schedule.py``: fp32 tensors in, fp32 tensors out."""
from __future__ import annotations

import math

import torch


def cosine_with_warmup(step, *, warmup_steps: int, total_steps: int,
                       min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step) -> torch.Tensor:
    return torch.ones_like(torch.as_tensor(step, dtype=torch.float32))
