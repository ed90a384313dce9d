"""PyTorch/CUDA port of the COBRA binary-transformer reproduction.

The JAX package ``repro`` is the reference; this package computes the same
functions with hand-written Hopper kernels (``repro_torch.kernels``) on the
card and their plain PyTorch versions on the CPU.  It imports nothing of
the JAX package.

Packed binary words are ``torch.int32`` tensors holding the reference's
exact ``uint32`` bits (LSB-first, zero pad bits).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; asking for
    it without a card raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, but "
            f"torch.cuda.is_available() is False; pass device='cpu' to "
            f"run the plain PyTorch versions on the CPU")
    return dev


def to_device(tree, device):
    """A copy of a nested dict/list param tree with every tensor moved to
    ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return tree.to(resolve_device(device))
