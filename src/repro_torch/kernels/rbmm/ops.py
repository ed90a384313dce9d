"""Public wrapper for the integer RBMM kernel (paper Eq. 7).

Contract: packed operands ``a (..., M, ceil(K/32))`` and
``b (..., P, ceil(K/32))`` int32 with equal leading dims give the
``(..., M, P)`` int32 product of the underlying value matrices:
``2*popcount(a XNOR b) - (K + 2*pad)`` for the ±1 "xnor" scheme, or
``2*popcount(a AND b) - K + dc`` for the {0,1} "and_dc" scheme, where the
don't-care count ``dc (..., M)`` is derived from ``a`` when not given.
The leading dims let decode attention score one query group against its
KV head's whole ring in one launch.

Dispatch: CUDA tensors launch ``csrc/rbmm.cu``; CPU tensors take
``ref.rbmm_int``.  ``rbmm_int.launches`` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.core import packing
from repro_torch.kernels.rbmm import ref

SCHEMES = ("xnor", "and_dc")
_ARGTYPES = ([kernels.PTR] * 3 + [kernels.I64] * 5 + [kernels.INT,
                                                      kernels.PTR])


def _check(a, b, k, scheme, dc) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"rbmm_int takes int32 words, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() < 2 or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"rbmm_int needs (..., M, Kp) and (..., P, Kp) "
                         f"with equal leading dims, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    kp = packing.packed_len(k)
    if a.shape[-1] != kp or b.shape[-1] != kp:
        raise ValueError(f"rbmm_int: operands must carry ceil(k/32)={kp} "
                         f"words for k={k}, got {a.shape[-1]} and "
                         f"{b.shape[-1]}")
    if dc is not None and (dc.dtype != torch.int32 or
                           dc.shape != a.shape[:-1]):
        raise ValueError(f"dc must be int32 of shape {tuple(a.shape[:-1])},"
                         f" got {dc.dtype} {tuple(dc.shape)}")


def rbmm_int(a: torch.Tensor, b: torch.Tensor, k: int, *,
             scheme: str = "xnor",
             dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check(a, b, k, scheme, dc)
    if not kernels.use_kernel(a, b, dc):
        return ref.rbmm_int(a, b, k, scheme=scheme, dc=dc)
    kernels.require_contiguous("rbmm_int", a, b, dc)
    m, p = a.shape[-2], b.shape[-2]
    batch = math.prod(a.shape[:-2])
    out = torch.empty(a.shape[:-1] + (p,), dtype=torch.int32,
                      device=a.device)
    kernels.launch("cobra_rbmm_int", _ARGTYPES, a.device, a.data_ptr(),
                   b.data_ptr(), kernels.ptr(dc), batch, m, p, a.shape[-1],
                   k, SCHEMES.index(scheme), out.data_ptr())
    rbmm_int.launches += 1
    return out


rbmm_int.launches = 0
