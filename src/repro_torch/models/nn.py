"""Norms, the embedding and the fp dense head (port of ``repro.models.nn``).

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

from repro_torch import tree
from repro_torch.models import sharding
from repro_torch.models.sharding import P

Params = Dict[str, Any]

# a (in, out) matrix's spec by its partition
MATRIX_SPECS = {"col": P(None, "model"), "row": P("model", None),
                "none": P(None, None)}


def truncated_normal(gen: torch.Generator, shape, std: float,
                     device) -> torch.Tensor:
    """std * N(0, 1) truncated to [-2, 2], by inverse CDF from ``gen``:
    std * clamp(sqrt(2) * erfinv(2 * (lo + (hi - lo) * u) - 1), -2, 2) of
    uniforms u, computed in place (the same float32 operations), so a
    draw holds one tensor of its shape (a vocabulary-wide head's would
    otherwise hold four)."""
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u.mul_(hi - lo).add_(lo).mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2))
    return u.clamp_(-2.0, 2.0).mul_(std)


def stack_spec(spec: Any) -> Any:
    """Prepend a None (layer) axis to every spec of a tree: the spec of
    the JAX package's stacked leaf of a per-layer leaf."""
    return tree.map(lambda s: P(None, *s), spec)


@dataclasses.dataclass(frozen=True)
class RMSNorm:
    dim: int
    eps: float = 1e-6

    def init(self, device) -> Params:
        return {"scale": torch.ones(self.dim, device=device)}

    def specs(self) -> Params:
        return {"scale": P(None)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.to(torch.float32)
        var = (x * x).mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps) * params["scale"]
        return y.to(dt)


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    dim: int
    eps: float = 1e-6

    def init(self, device) -> Params:
        return {"scale": torch.ones(self.dim, device=device),
                "bias": torch.zeros(self.dim, device=device)}

    def specs(self) -> Params:
        return {"scale": P(None), "bias": P(None)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.to(torch.float32)
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return (y * params["scale"] + params["bias"]).to(dt)


def make_norm(kind: str, dim: int):
    return RMSNorm(dim) if kind == "rmsnorm" else LayerNorm(dim)


@dataclasses.dataclass(frozen=True)
class Embedding:
    vocab: int
    dim: int

    def init(self, gen: torch.Generator, device) -> Params:
        # d^-0.5: unit-scale activations after the sqrt(d) input multiplier
        # and O(1) logits as the tied LM head
        return {"embedding": truncated_normal(gen, (self.vocab, self.dim),
                                              self.dim ** -0.5, device)}

    def specs(self) -> Params:
        return {"embedding": P("model", None)}

    def apply(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        """The table's rows of ``ids``.  On a mesh (the table this rank's
        block of the vocabulary): ``block_rows`` summed over "model"
        (exact: one term of each is not zero)."""
        table = params["embedding"]
        if sharding.placed_block(table, (0,))[0] is None:
            return table[ids.long()]
        return sharding.decode_split(table).mesh.all_reduce(
            self.block_rows(params, ids), "model")

    def block_rows(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        """The float32 rows of ``ids`` that this rank's vocabulary block
        holds, zeros for every other id: the rank's term of the lookup,
        which a sum over "model" completes (a mesh prefill
        reduce-scatters it onto the sequence's blocks)."""
        table = params["embedding"]
        _, lo, hi = sharding.placed_block(table, (0,))
        local = ids.long() - lo
        inside = (local >= 0) & (local < hi - lo)
        rows = table[local.clamp(0, hi - lo - 1)]
        return torch.where(inside[..., None], rows, 0.0)

    def attend(self, params: Params, x: torch.Tensor,
               gather: bool = True) -> torch.Tensor:
        """Tied-embedding logits (float32, like the JAX einsum of a
        compute-dtype x against the float32 table); on a mesh, this
        rank's vocabulary block's, all-gathered along the vocabulary
        (with ``gather`` False: the block's alone)."""
        table = params["embedding"]
        d, _, _ = sharding.placed_block(table, (0,))
        lg = torch.matmul(x.to(torch.float32), table.T)
        if d is None or not gather:
            return lg
        return sharding.decode_split(table).mesh.all_gather(
            lg, "model", lg.dim() - 1)


@dataclasses.dataclass(frozen=True)
class Dense:
    """fp dense layer (the untied LM head): a plain matmul, which lies
    outside every kernel of the JAX package too."""
    in_dim: int
    out_dim: int
    use_bias: bool = True
    partition: str = "col"          # col | row | none (sharding of (in, out))

    def init(self, gen: torch.Generator, device) -> Params:
        p = {"kernel": truncated_normal(gen, (self.in_dim, self.out_dim),
                                        1.0 / math.sqrt(self.in_dim),
                                        device)}
        if self.use_bias:
            p["bias"] = torch.zeros(self.out_dim, device=device)
        return p

    def specs(self) -> Params:
        ps = MATRIX_SPECS[self.partition]
        out = {"kernel": ps}
        if self.use_bias:
            out["bias"] = P(ps[1]) if self.partition == "col" else P(None)
        return out

    def apply(self, params: Params, x: torch.Tensor,
              gather: bool = True) -> torch.Tensor:
        """x @ kernel (+ bias) in the promoted dtype of x and the kernel,
        as the JAX einsum promotes (a bf16 x meets a float32 kernel in
        float32).  On a mesh (the kernel this rank's block of its output
        columns, the untied head's vocabulary): this rank's columns,
        all-gathered along them (with ``gather`` False: its own alone)."""
        kernel = params["kernel"]
        d, _, _ = sharding.placed_block(kernel, (1,))
        dt = torch.promote_types(x.dtype, kernel.dtype)
        y = torch.matmul(x.to(dt), kernel.to(dt))
        if self.use_bias:
            y = y + params["bias"]
        if d is None or not gather:
            return y
        return sharding.decode_split(kernel).mesh.all_gather(
            y, "model", y.dim() - 1)
