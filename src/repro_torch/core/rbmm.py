"""RBMM — real 1-bit binary matrix multiplication (paper §III-B, Eq. 7).

Port of ``repro.core.rbmm.rbmm_int`` and its dispatch rule:

  signed   x signed  ("xnor")  : a.b = 2*popcount(XNOR(a, b)) - K
  unsigned x signed  ("and_dc"): a.b = 2*popcount(AND(a, b))  - K + delta

Routes (``impl``):
  popcount : the ``rbmm_int`` kernel on the packed words.
  mxu      : the activations are unpacked to bf16 ±1 / {0,1} values and the
             ``rbmm_mxu`` kernel multiplies them with the packed weights
             on the tensor cores (exact: |acc| <= K < 2^24).
  dense    : same as mxu (the JAX package's dense route is its oracle).
  auto     : M <= 16 (decode, memory-bound) -> popcount, else mxu.

On CPU tensors each kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.kernels.rbmm import ops as rbmm_ops
from repro_torch.kernels.rbmm_mxu import ops as mxu_ops

SCHEMES = ("xnor", "and_dc")
IMPLS = ("popcount", "mxu", "dense", "auto")


def _check(scheme: str, impl: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def resolve_impl(impl: str, m: int) -> str:
    """'auto' dispatch: small-M (decode GEMV, memory-bound) -> popcount,
    large-M (prefill, compute-bound) -> mxu."""
    if impl != "auto":
        return impl
    return "popcount" if m <= 16 else "mxu"


def _unpack_operand(p: torch.Tensor, k: int,
                    scheme_side: str) -> torch.Tensor:
    """(..., M, Kp) words -> (..., M, K) bf16 values: 'signed' -> ±1,
    'unsigned' -> {0,1}."""
    bits = packing.unpack_bits(p, k)
    if scheme_side == "signed":
        bits = 2 * bits - 1
    return bits.to(torch.bfloat16)


def rbmm_int(a: torch.Tensor, b: torch.Tensor, k: int, *,
             scheme: str = "xnor", dc: Optional[torch.Tensor] = None,
             impl: str = "popcount") -> torch.Tensor:
    """Integer RBMM on packed operands.

    a: (..., M, Kp) int32 words, rows packed along K (LSB-first); xnor
       bits encode {-1 -> 0, +1 -> 1}, and_dc bits {0 -> 0, 1 -> 1}.
    b: (..., P, Kp) int32 words of the logical (K, P) matrix's columns,
       always signed; leading dims equal a's.
    dc: optional don't-care counts (..., M) for and_dc.
    Returns (..., M, P) int32, exactly ``unpacked(a) @ unpacked(b).T``.
    """
    _check(scheme, impl)
    impl = resolve_impl(impl, a.shape[-2])
    if impl in ("mxu", "dense"):
        a_side = "signed" if scheme == "xnor" else "unsigned"
        out = mxu_ops.rbmm_mxu(_unpack_operand(a, k, a_side), b)
        return out.to(torch.int32)  # exact integers; dc is not needed
    return rbmm_ops.rbmm_int(a, b, k, scheme=scheme, dc=dc)
