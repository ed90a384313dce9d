"""Token samplers (port of ``repro.serve.sampler``: greedy, temperature,
top-k) and the speculative-decode acceptance math.

Random draws come from an explicit ``torch.Generator`` on the logits'
device; the same seed gives other numbers than ``jax.random``, so only
greedy is token-for-token comparable across the two packages.

The speculative half is rejection-sampling verification: the draft
proposes d_i ~ q_i, the target scores p_i, d_i is accepted with
probability min(1, p_i(d_i) / q_i(d_i)), and the first rejection resamples
from norm(max(p_i - q_i, 0)), so every emitted token is distributed as the
target sampler's.  Greedy verification is exact argmax matching, which
makes greedy speculative decode equal to plain decode token for token.
``speculative_accept`` and ``categorical`` take their uniforms as a
tensor when asked, so a captured CUDA graph can run them on uniforms drawn
outside it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

UNIFORM_BITS = 23   # uniforms from 23-bit integers: u in (0, 1), exact


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
    """Draws among the k largest logits; among equal logits the lowest
    indices are kept, as ``lax.top_k`` keeps them in the JAX package (a
    stable descending sort, as in ``sampling_probs``)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    pick = _categorical(vals / max(temp, 1e-4), gen)
    return torch.gather(idx, -1, pick.unsqueeze(-1))[..., 0].to(torch.int32)


# -- speculative decoding: sampler distributions and batch acceptance --------


def uniforms(bits: torch.Tensor) -> torch.Tensor:
    """Integers in [0, 2**23) -> float32 uniforms in (0, 1), each exact."""
    return (bits.to(torch.float32) + 0.5) * 2.0 ** -UNIFORM_BITS


def categorical(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``probs`` (..., V), not necessarily normalized,
    by inverting its cumulative sum at the uniforms ``u`` (...): the
    first index whose cumulative sum exceeds u * total.  An index of zero
    probability is never drawn.  -> (...) int64."""
    cdf = probs.to(torch.float32).cumsum(-1)
    t = u[..., None] * cdf[..., -1:]
    idx = torch.searchsorted(cdf, t, right=True)[..., 0]
    # u * total may round up to the total: stay on the last index drawn
    last = probs.shape[-1] - 1 - torch.argmax(
        (probs > 0).flip(-1).to(torch.int32), dim=-1)
    return torch.minimum(idx, last)


def sampling_probs(logits: torch.Tensor, sampler: str, temp: float = 1.0,
                   k: int = 40) -> torch.Tensor:
    """The exact distribution the named sampler draws from: logits (...,
    V) -> float32 probs (..., V).  Greedy is a point mass on the argmax
    (ties: the lowest index); ``top_k`` keeps the lowest indices among
    equal logits, as ``lax.top_k`` does in the JAX package (a stable
    descending sort; ``torch.topk`` promises no order among ties)."""
    if sampler == "greedy":
        idx = torch.argmax(logits, dim=-1, keepdim=True)
        return torch.zeros(logits.shape, dtype=torch.float32,
                           device=logits.device).scatter_(-1, idx, 1.0)
    z = logits.to(torch.float32) / max(temp, 1e-4)
    if sampler == "temperature":
        return torch.softmax(z, dim=-1)
    if sampler == "top_k":
        vals, idx = torch.sort(z, dim=-1, descending=True, stable=True)
        pk = torch.softmax(vals[..., :k], dim=-1)
        return torch.zeros_like(z).scatter_(-1, idx[..., :k], pk)
    raise ValueError(f"unknown sampler {sampler!r}")


def speculative_accept(drafts: torch.Tensor, q_probs: Optional[torch.Tensor],
                       logits: torch.Tensor,
                       gen: Optional[torch.Generator] = None, *,
                       sampler: str = "greedy", temp: float = 1.0,
                       k: int = 40, u: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-verify k drafted tokens against k+1 rows of target logits.

    drafts (B, k) draft tokens; q_probs (B, k, V) the draft's proposal
    distributions (None for greedy, which matches argmaxes and draws
    nothing); logits (B, k+1, V) target logits, row j scoring the token
    after prefix + d_1..d_j (row k is the bonus position).  The stochastic
    samplers take k+1 uniforms per row: ``u`` (B, k+1) in (0, 1) if
    given, else drawn from ``gen``; the first k decide acceptance, the
    last draws the residual or bonus token.

    Returns (out (B, k+1) int32, n_accept (B,) int32): row b emits
    out[b, :n_accept[b] + 1], the accepted prefix and one target token;
    later positions are padding."""
    b, kd = drafts.shape
    drafts = drafts.long()
    i = torch.arange(kd + 1, device=drafts.device)[None, :]
    if sampler == "greedy":
        tgt = torch.argmax(logits, dim=-1)                    # (B, k+1)
        accept = (drafts == tgt[:, :kd]).to(torch.int64)
        n = torch.cumprod(accept, dim=1).sum(dim=1)           # (B,)
        bonus = torch.gather(tgt, 1, n[:, None])              # (B, 1)
    else:
        if u is None:
            u = torch.rand((b, kd + 1), generator=gen,
                           device=logits.device)
        p = sampling_probs(logits, sampler, temp, k)          # (B,k+1,V)
        p_d = torch.gather(p[:, :kd], -1, drafts[..., None])[..., 0]
        q_d = torch.gather(q_probs, -1, drafts[..., None])[..., 0]
        # accept iff u < min(1, p/q)  <=>  u * q < p  (d ~ q, so q > 0)
        accept = (u[:, :kd] * q_d < p_d).to(torch.int64)
        n = torch.cumprod(accept, dim=1).sum(dim=1)
        # residuals max(p - q, 0) per draft row (all zero where p == q:
        # then p itself); the bonus row draws from the target
        resid = torch.clamp_min(p[:, :kd] - q_probs, 0.0)
        rsum = resid.sum(-1, keepdim=True)
        resid = torch.where(rsum > 0, resid, p[:, :kd])
        full = torch.cat([resid, p[:, kd:]], dim=1)           # (B,k+1,V)
        r_n = torch.gather(full, 1, n[:, None, None].expand(
            b, 1, full.shape[-1]))[:, 0]                      # (B, V)
        bonus = categorical(r_n, u[:, kd])[:, None]
    drafts_pad = torch.cat([drafts, drafts[:, -1:]], dim=1)
    out = torch.where(i < n[:, None], drafts_pad,
                      torch.where(i == n[:, None], bonus, 0))
    return out.to(torch.int32), n.to(torch.int32)
