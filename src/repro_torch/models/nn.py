"""Norms and the embedding (port of ``repro.models.nn``).

Layers are frozen dataclasses holding shapes only; parameters are plain
dicts of tensors (the JAX package's layout, so ``repro_torch.bridge`` maps
one onto the other key for key).  ``init`` takes an explicit
``torch.Generator`` and device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

Params = Dict[str, Any]


def truncated_normal(gen: torch.Generator, shape, std: float,
                     device) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2], by inverse CDF from ``gen``."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    z = math.sqrt(2) * torch.erfinv(2 * (lo + (hi - lo) * u) - 1)
    return std * z.clamp(-2.0, 2.0)


@dataclasses.dataclass(frozen=True)
class RMSNorm:
    dim: int
    eps: float = 1e-6

    def init(self, device) -> Params:
        return {"scale": torch.ones(self.dim, device=device)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.to(torch.float32)
        var = (x * x).mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps) * params["scale"]
        return y.to(dt)


@dataclasses.dataclass(frozen=True)
class Embedding:
    vocab: int
    dim: int

    def init(self, gen: torch.Generator, device) -> Params:
        # d^-0.5: unit-scale activations after the sqrt(d) input multiplier
        # and O(1) logits as the tied LM head
        return {"embedding": truncated_normal(gen, (self.vocab, self.dim),
                                              self.dim ** -0.5, device)}

    def apply(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        return params["embedding"][ids.long()]

    def attend(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits (float32, like the JAX einsum of a
        compute-dtype x against the float32 table)."""
        return torch.matmul(x.to(torch.float32), params["embedding"].T)
