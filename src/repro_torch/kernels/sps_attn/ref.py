"""Plain PyTorch version of the fused SPS attention kernel: unfused but
packed end to end (the mirror of the JAX ``ref.sps_attention_popcount``),
batched and GQA-aware like the kernel; and ``sps_attention_int8``, the
tensor-core kernel's two integer matrix products written plainly (a test
helper).

Beyond the TPU kernel's contract (the port's own operands): ``lens``
(per-sequence key lengths), ``window`` (a causal sliding window: key c is
visible from query row r iff ``r - window < c <= r``) and a row table of
thresholds (``theta`` (H, T): query row r reads column ``min(r, T-1)``).
With none of them the function is the JAX ``ref`` bit for bit."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing


def v_transpose_packed(v_vals: torch.Tensor) -> torch.Tensor:
    """(..., L, d_h) ±1 values -> (..., d_h, ceil(L/32)) V^T packed along L
    (the layout of the context path and of the decode V cache)."""
    return packing.pack_signs(v_vals.transpose(-1, -2))


def theta_rows(theta: torch.Tensor, length: int) -> torch.Tensor:
    """The threshold of each query row, (H, L, 1): ``theta`` (H,) for
    every row, or a row table (H, T) read at column min(row, T-1)."""
    if theta.dim() == 1:
        return theta[:, None, None]
    rows = torch.arange(length, device=theta.device).clamp(
        max=theta.shape[1] - 1)
    return theta[:, rows, None]


def sps_attention_gqa(q_bits: torch.Tensor, k_bits: torch.Tensor,
                      vt_bits: torch.Tensor, theta: torch.Tensor, *,
                      d_h: int, causal: bool = True,
                      lens: Optional[torch.Tensor] = None,
                      window: int = 0) -> torch.Tensor:
    """q_bits (B, H, L, dhp), k_bits (B, Hkv, L, dhp), vt_bits
    (B, Hkv, d_h, ceil(L/32)), theta (H,) or (H, T) int32 -> (B, H, L,
    d_h) int32.  ``lens`` (B,) int32, if given, masks the keys at columns
    >= lens[b] out of every row of sequence b (a ragged, right-padded
    batch); ``window`` > 0 (causal only) masks the keys at columns <=
    row - window."""
    groups = q_bits.shape[1] // k_bits.shape[1]
    length = q_bits.shape[2]
    kh = k_bits.repeat_interleave(groups, dim=1)
    vth = vt_bits.repeat_interleave(groups, dim=1)
    c = packing.xnor_popcount_score(q_bits.unsqueeze(3), kh.unsqueeze(2),
                                    d_h)                       # (B,H,L,L)
    probs = c >= theta_rows(theta.to(torch.int32), length)[None]
    if causal:
        probs = torch.tril(probs)
        if window:
            probs = torch.triu(probs, diagonal=1 - window)
    if lens is not None:
        cols = torch.arange(probs.shape[-1], device=probs.device)
        probs = probs & (cols[None, :] < lens[:, None])[:, None, None, :]
    # and_dc context: the -L + dc terms telescope to -nnz (pad columns
    # are 0 in both operands)
    probs_p = packing.pack_bits(probs)                          # (B,H,L,Lw)
    nnz = probs.sum(-1, dtype=torch.int32)
    pc = packing.popcount_words(probs_p.unsqueeze(3) & vth.unsqueeze(2)
                                ).sum(-1, dtype=torch.int32)    # (B,H,L,dh)
    return 2 * pc - nnz.unsqueeze(-1)


def sps_attention_int8(q_bits: torch.Tensor, k_bits: torch.Tensor,
                       vt_bits: torch.Tensor, theta: torch.Tensor, *,
                       d_h: int, causal: bool = True) -> torch.Tensor:
    """The tensor-core kernel's arithmetic as plain integer matrix
    products, a test helper that no model path calls.  Every bit of the
    32 * dhp-bit rows unpacks to ±1 and the score is the int32 dot
    product minus the pad (a pad bit adds +1 where q and k agree, -1
    where they differ, as the popcount form counts it, so this equals
    ``sps_attention_gqa`` for any words); the probabilities are {0,1};
    V^T unpacks to ±1 along the keys, and the context is P @ V, the
    and_dc context itself.  Same contract as ``sps_attention_gqa``."""
    groups = q_bits.shape[1] // k_bits.shape[1]
    length = q_bits.shape[2]
    bits = q_bits.shape[-1] * packing.WORD
    q = packing.unpack_signs(q_bits, bits, torch.int32)
    k = packing.unpack_signs(k_bits, bits, torch.int32).repeat_interleave(
        groups, dim=1)
    c = torch.matmul(q, k.transpose(-1, -2)) - (bits - d_h)   # (B,H,L,L)
    probs = c >= theta.to(torch.int32)[None, :, None, None]
    if causal:
        probs = torch.tril(probs)
    v = packing.unpack_signs(vt_bits, length, torch.int32).repeat_interleave(
        groups, dim=1)                                          # (B,H,dh,L)
    return torch.matmul(probs.to(torch.int32), v.transpose(-1, -2))
