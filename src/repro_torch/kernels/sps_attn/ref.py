"""Plain PyTorch version of the fused SPS attention kernel: unfused but
packed end to end (the mirror of the JAX ``ref.sps_attention_popcount``),
batched and GQA-aware like the kernel."""
from __future__ import annotations

import torch

from repro_torch.core import packing


def v_transpose_packed(v_vals: torch.Tensor) -> torch.Tensor:
    """(..., L, d_h) ±1 values -> (..., d_h, ceil(L/32)) V^T packed along L
    (the layout of the context path and of the decode V cache)."""
    return packing.pack_signs(v_vals.transpose(-1, -2))


def sps_attention_gqa(q_bits: torch.Tensor, k_bits: torch.Tensor,
                      vt_bits: torch.Tensor, theta: torch.Tensor, *,
                      d_h: int, causal: bool = True) -> torch.Tensor:
    """q_bits (B, H, L, dhp), k_bits (B, Hkv, L, dhp), vt_bits
    (B, Hkv, d_h, ceil(L/32)), theta (H,) int32 -> (B, H, L, d_h) int32."""
    groups = q_bits.shape[1] // k_bits.shape[1]
    kh = k_bits.repeat_interleave(groups, dim=1)
    vth = vt_bits.repeat_interleave(groups, dim=1)
    c = packing.xnor_popcount_score(q_bits.unsqueeze(3), kh.unsqueeze(2),
                                    d_h)                       # (B,H,L,L)
    probs = c >= theta.to(torch.int32)[None, :, None, None]
    if causal:
        probs = torch.tril(probs)
    # and_dc context: the -L + dc terms telescope to -nnz (pad columns
    # are 0 in both operands)
    probs_p = packing.pack_bits(probs)                          # (B,H,L,Lw)
    nnz = probs.sum(-1, dtype=torch.int32)
    pc = packing.popcount_words(probs_p.unsqueeze(3) & vth.unsqueeze(2)
                                ).sum(-1, dtype=torch.int32)    # (B,H,L,dh)
    return 2 * pc - nnz.unsqueeze(-1)
