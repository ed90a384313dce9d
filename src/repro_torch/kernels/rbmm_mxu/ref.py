"""Plain PyTorch version of the packed-weight MMA kernel."""
from __future__ import annotations

import torch

from repro_torch.core import packing


def rbmm_mxu(a_vals: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """a_vals (..., M, K) values @ unpack±1(w_packed (..., P, Kw)).T in
    float32 -> (..., M, P); exact for binary values (integer sums < 2^24)."""
    k = a_vals.shape[-1]
    w = packing.unpack_signs(w_packed, k, dtype=torch.float32)
    return a_vals.to(torch.float32) @ w.transpose(-1, -2)
