"""Public wrapper for the packed-weight MMA kernel.

Contract: ``rbmm_mxu(a_vals (..., M, K) bfloat16, w_packed (..., P, Kw))``
with ``Kw >= ceil(K/32)`` int32 words returns the ``(..., M, P)`` float32
product of ``a_vals`` (±1 or {0,1} values) against the ±1 weight matrix
encoded in ``w_packed``.  The weights are unpacked inside the kernel's
shared-memory tile, so device memory only ever holds 1-bit weights.

Dispatch: CUDA tensors launch ``csrc/rbmm_mxu.cu``; CPU tensors take
``ref.rbmm_mxu``.  ``rbmm_mxu.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.core import packing
from repro_torch.kernels.rbmm_mxu import ref

_ARGTYPES = [kernels.PTR, kernels.PTR] + [kernels.I64] * 5 + [kernels.PTR]


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
    if not kernels.use_kernel(a_vals, w_packed):
        return ref.rbmm_mxu(a_vals, w_packed)
    if a_vals.dtype != torch.bfloat16:
        raise TypeError(f"rbmm_mxu: the kernel takes bfloat16 values, got "
                        f"{a_vals.dtype}")
    kernels.require_contiguous("rbmm_mxu", a_vals, w_packed)
    m, k = a_vals.shape[-2:]
    p, kw = w_packed.shape[-2:]
    batch = math.prod(a_vals.shape[:-2])
    out = torch.empty(a_vals.shape[:-1] + (p,), dtype=torch.float32,
                      device=a_vals.device)
    kernels.launch("cobra_rbmm_mxu", _ARGTYPES, a_vals.device,
                   a_vals.data_ptr(), w_packed.data_ptr(), batch, m, p, k, kw,
                   out.data_ptr())
    rbmm_mxu.launches += 1
    return out


rbmm_mxu.launches = 0
