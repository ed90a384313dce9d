"""Binarization helpers (port of ``repro.core.binarize``).

Only the deploy-time weight scale is ported; the straight-through
estimators belong to the training face, which is not ported yet.
"""
from __future__ import annotations

import torch


def init_weight_scale(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-output-channel mean(|w|) over the contraction axis (BiT init)."""
    return w.abs().mean(dim=axis, keepdim=True)
