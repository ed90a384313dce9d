"""Plain PyTorch versions of the RBMM kernels (unblocked Eq. 7, and the
Eq. 10 threshold epilogue of ``rbmm_binary``), and the integer product of
unpacked values they are held to (``rbmm_int_dense``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import packing


def rbmm_int(a: torch.Tensor, b: torch.Tensor, k: int, *,
             scheme: str = "xnor",
             dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., M, Kp) x (..., P, Kp) int32 words -> (..., M, P) int32."""
    aa = a.unsqueeze(-2)
    bb = b.unsqueeze(-3)
    if scheme == "xnor":
        pc = packing.popcount_words(~(aa ^ bb)).sum(-1, dtype=torch.int32)
        pad = a.shape[-1] * packing.WORD - k
        return 2 * pc - (k + 2 * pad)
    if dc is None:
        dc = packing.dc_count(a, k)
    pc = packing.popcount_words(aa & bb).sum(-1, dtype=torch.int32)
    return 2 * pc - k + dc.unsqueeze(-1).to(torch.int32)


def rbmm_binary(a: torch.Tensor, b: torch.Tensor, k: int,
                theta: torch.Tensor, *, scheme: str = "xnor",
                dc: Optional[torch.Tensor] = None, causal: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bits = c >= theta (theta broadcast against the (..., M, P) scores),
    causally masked to col <= row if asked -> ({0,1} bits (..., M, P)
    int32, zeros per row (..., M) int32)."""
    c = rbmm_int(a, b, k, scheme=scheme, dc=dc)
    bits = (c >= theta.to(torch.int32)).to(torch.int32)
    if causal:
        bits = torch.tril(bits)
    dc_ret = bits.shape[-1] - bits.sum(-1, dtype=torch.int32)
    return bits, dc_ret


def rbmm_int_dense(a_vals: torch.Tensor, b_vals: torch.Tensor
                   ) -> torch.Tensor:
    """Ground-truth integer product of +-1 / {0,1} value matrices: (M, K)
    x (P, K) -> (M, P) int32, a_vals @ b_vals.T on unpacked values (what
    ``rbmm_int`` computes from their packed words).  The integers are
    summed in int64 on the CPU and in float64 on the card (exact below
    2^53), which has no integer matmul."""
    if a_vals.is_cuda:
        return (a_vals.to(torch.float64) @ b_vals.to(torch.float64).T).to(
            torch.int32)
    return (a_vals.to(torch.int64) @ b_vals.to(torch.int64).T).to(
        torch.int32)
