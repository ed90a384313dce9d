"""Token samplers (port of ``repro.serve.sampler``: greedy, temperature,
top-k).  Random draws come from an explicit ``torch.Generator`` on the
logits' device; the same seed gives other numbers than ``jax.random``,
so only greedy is token-for-token comparable across the two packages."""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor,
           gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int32; ties take the lowest index."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _categorical(z: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row of z (..., V) from softmax(z) -> (...) int64."""
    probs = torch.softmax(z.to(torch.float32), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    pick = torch.multinomial(flat, 1, generator=gen)
    return pick.reshape(probs.shape[:-1])


def temperature(logits: torch.Tensor, gen: torch.Generator,
                temp: float = 1.0) -> torch.Tensor:
    z = logits / max(temp, 1e-4)
    return _categorical(z, gen).to(torch.int32)


def top_k(logits: torch.Tensor, gen: torch.Generator, k: int = 40,
          temp: float = 1.0) -> torch.Tensor:
    vals, idx = torch.topk(logits, k, dim=-1)
    pick = _categorical(vals / max(temp, 1e-4), gen)
    return torch.gather(idx, -1, pick.unsqueeze(-1))[..., 0].to(torch.int32)
