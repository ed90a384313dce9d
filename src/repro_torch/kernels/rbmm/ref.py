"""Plain PyTorch version of the RBMM kernel (unblocked Eq. 7)."""
from __future__ import annotations

from typing import Optional

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
