"""Public wrapper for the packed-weight MMA kernel.

Contract: ``rbmm_mxu(a_vals (..., M, K) bfloat16, w_packed (..., P, Kw))``
with ``Kw >= ceil(K/32)`` int32 words returns the ``(..., M, P)`` float32
product of ``a_vals`` (±1 or {0,1} values) against the ±1 weight matrix
encoded in ``w_packed``.  The weights are unpacked inside the kernel's
shared-memory tile, so device memory only ever holds 1-bit weights.

Shape rules of the kernel, applied here: the kernel reads ``a_vals`` by
TMA, whose rows must start 16 bytes apart, so for ``K % 8 != 0`` (or a
base that is not 16-byte aligned) the wrapper hands it a copy with K padded
by zeros to a multiple of 8 (``pad_k``; ceil8(K) <= 32 * Kw always holds,
and a zero value adds nothing whatever its weight bit); and ``tile_for``
picks the output tile, the largest of ``TILES`` whose grid fills the card.

Dispatch: CUDA tensors launch ``csrc/rbmm_mxu.cu``; CPU tensors take
``ref.rbmm_mxu``; meta tensors the shape-only route
(``kernels.use_kernel``).  ``rbmm_mxu.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch import census, kernels
from repro_torch.kernels import work
from repro_torch.core import packing
from repro_torch.kernels.rbmm_mxu import ref

_ARGTYPES = ([kernels.PTR, kernels.PTR] + [kernels.I64] * 5 +
             [kernels.INT, kernels.INT, kernels.PTR])

# the compiled (BM, BN) output tiles of csrc/rbmm_mxu.cu, largest first
# (two consumer warpgroups where the grid allows: one warpgroup a block
# hid the unpack and the loads worse at both main shapes)
TILES = ((128, 128), (128, 64), (64, 64))
H100_SMS = 132


def tile_for(batch: int, m: int, p: int, sms: int = H100_SMS):
    """The first of ``TILES`` whose grid has at least one block per SM;
    the smallest tile when none does."""
    for bm, bn in TILES:
        if batch * -(-m // bm) * -(-p // bn) >= sms:
            return bm, bn
    return TILES[-1]


def pad_k(a_vals: torch.Tensor) -> torch.Tensor:
    """``a_vals`` with K zero-padded to a multiple of 8 and a 16-byte
    aligned base, as the kernel's TMA reads it (``a_vals`` itself when it
    already is)."""
    k = a_vals.shape[-1]
    if k % 8 == 0 and a_vals.data_ptr() % 16 == 0:
        return a_vals
    return torch.nn.functional.pad(a_vals, (0, -k % 8))


def _check(a_vals: torch.Tensor, w_packed: torch.Tensor) -> None:
    if w_packed.dtype != torch.int32:
        raise TypeError(f"rbmm_mxu: w_packed must be int32 words, got "
                        f"{w_packed.dtype}")
    if a_vals.dim() < 2 or a_vals.shape[:-2] != w_packed.shape[:-2]:
        raise ValueError(f"rbmm_mxu needs (..., M, K) and (..., P, Kw) with "
                         f"equal leading dims, got {tuple(a_vals.shape)} "
                         f"and {tuple(w_packed.shape)}")
    k = a_vals.shape[-1]
    if w_packed.shape[-1] * packing.WORD < k:
        raise ValueError(f"rbmm_mxu: w_packed too short: "
                         f"{w_packed.shape[-1] * packing.WORD} < {k}")


def rbmm_mxu(a_vals: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    _check(a_vals, w_packed)
    on = kernels.use_kernel(a_vals, w_packed)
    if on == "cpu":
        return ref.rbmm_mxu(a_vals, w_packed)
    if a_vals.dtype != torch.bfloat16:
        raise TypeError(f"rbmm_mxu: the kernel takes bfloat16 values, got "
                        f"{a_vals.dtype}")
    kernels.require_contiguous("rbmm_mxu", a_vals, w_packed)
    m = a_vals.shape[-2]
    p, kw = w_packed.shape[-2:]
    batch = math.prod(a_vals.shape[:-2])
    out = torch.empty(a_vals.shape[:-1] + (p,), dtype=torch.float32,
                      device=a_vals.device)
    a8 = pad_k(a_vals)
    if on == "meta":
        census.kernel("rbmm_mxu", work.mxu(batch, m, a_vals.shape[-1], p,
                                        a_vals, w_packed, out))
        return out
    bm, bn = tile_for(batch, m, p)
    kernels.launch("cobra_rbmm_mxu", _ARGTYPES, a_vals.device,
                   a8.data_ptr(), w_packed.data_ptr(), batch, m, p,
                   a8.shape[-1], kw, bm, bn, out.data_ptr())
    rbmm_mxu.launches += 1
    return out


rbmm_mxu.launches = 0
