"""Learning-rate schedules as step -> multiplier functions (port of
``repro.optim.schedules``).  They compute in float32 on the host, as the
JAX package's do in float32 (its Python constants weakly typed): each
returns a 0-d float32 CPU tensor."""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def constant():
    return lambda step: torch.ones((), dtype=torch.float32)


def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        prog = ((s - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f


def warmup_linear(warmup: int, total: int, floor: float = 0.0):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        lin = (1.0 - (s - warmup) / max(total - warmup, 1)).clamp(floor, 1.0)
        return torch.where(s < warmup, warm, lin)
    return f
