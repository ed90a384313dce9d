"""Plain PyTorch version of the pack kernel."""
from __future__ import annotations

import torch

from repro_torch.core import packing


def pack_threshold(x: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """bits = x >= theta (theta broadcast against x), compared in theta's
    dtype (float32 for float x, so a bf16 x meets an un-rounded float32
    threshold), packed LSB-first along the last axis -> int32 words."""
    return packing.pack_bits(x.to(theta.dtype) >= theta)
