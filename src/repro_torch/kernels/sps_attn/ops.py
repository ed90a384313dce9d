"""Public wrappers for the fused SPS binary attention kernel.

Contract: causal softmax-free SPS attention on packed head bits — scores
``c = 2*popcount(q XNOR k) - (d_h + 2*pad)`` (the Eq. 7 pad correction, so
d_h need not be a multiple of 32), probability ``c >= theta[h]``, context
``probs @ v`` as int32 — with the L x L score matrix never materialised.

``sps_attention`` keeps the TPU kernel's signature for one sequence:
q_bits, k_bits ``(H, L, ceil(d_h/32))``; ``v`` is V^T packed along L,
``(H, d_h, ceil(L/32))``, for ``path="vpu"``, or ``(H, L, d_h)`` ±1 values
for ``path="mxu"``, which the wrapper packs to V^T (the function is the
same, so one kernel serves both).  ``sps_attention_gqa`` is the batched
entry the model calls: q ``(B, H, L, dhp)``, k ``(B, Hkv, L, dhp)``, V^T
``(B, Hkv, d_h, ceil(L/32))``; query head h reads KV head ``h // (H/Hkv)``.

Padding contract: operands carry exactly ``ceil(d_h/32)`` words with zero
pad bits; the wrappers check the word count and raise.

Dispatch: CUDA tensors launch ``csrc/sps_attn.cu``; CPU tensors take
``ref.sps_attention_gqa``.  ``sps_attention_gqa.launches`` counts kernel
launches (``sps_attention`` goes through it).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core import packing
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.sps_attn import ref

MAX_DH = 256  # the kernel keeps a (32, d_h) int32 accumulator per block
_ARGTYPES = [kernels.PTR] * 4 + [kernels.I64] * 5 + [kernels.INT,
                                                     kernels.PTR]


def _validate(q_bits: torch.Tensor, k_bits: torch.Tensor, d_h: int) -> None:
    dhp = packing.packed_len(d_h)
    if q_bits.shape[-1] != dhp or k_bits.shape[-1] != dhp:
        raise ValueError(
            f"sps_attention: packed operands must carry ceil(d_h/32)="
            f"{dhp} words for d_h={d_h}, got q={q_bits.shape[-1]} "
            f"k={k_bits.shape[-1]} — repack with repro_torch.core.packing "
            f"(pad bits must be 0)")


def _check_gqa(q, k, vt, theta, d_h) -> None:
    _validate(q, k, d_h)
    for name, t in (("q_bits", q), ("k_bits", k), ("vt_bits", vt),
                    ("theta", theta)):
        if t.dtype != torch.int32:
            raise TypeError(f"sps_attention: {name} must be int32, got "
                            f"{t.dtype}")
    if q.dim() != 4 or k.dim() != 4 or vt.dim() != 4:
        raise ValueError("sps_attention_gqa takes q (B,H,L,dhp), k "
                         "(B,Hkv,L,dhp) and vt (B,Hkv,d_h,ceil(L/32))")
    b, h, length, _ = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != length or hkv == 0 or h % hkv:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (KV heads must divide heads)")
    want = (b, hkv, d_h, packing.packed_len(length))
    if tuple(vt.shape) != want:
        raise ValueError(f"vt_bits must be {want}, got {tuple(vt.shape)}")
    if tuple(theta.shape) != (h,):
        raise ValueError(f"theta must be ({h},), got {tuple(theta.shape)}")


def sps_attention_gqa(q_bits: torch.Tensor, k_bits: torch.Tensor,
                      vt_bits: torch.Tensor, theta: torch.Tensor, *,
                      d_h: int, causal: bool = True) -> torch.Tensor:
    _check_gqa(q_bits, k_bits, vt_bits, theta, d_h)
    if not kernels.use_kernel(q_bits, k_bits, vt_bits, theta):
        return ref.sps_attention_gqa(q_bits, k_bits, vt_bits, theta,
                                     d_h=d_h, causal=causal)
    if d_h > MAX_DH:
        raise ValueError(f"sps_attention: the kernel takes d_h <= {MAX_DH}"
                         f", got {d_h}")
    kernels.require_contiguous("sps_attention", q_bits, k_bits, vt_bits,
                               theta)
    b, h, length, _ = q_bits.shape
    out = torch.empty((b, h, length, d_h), dtype=torch.int32,
                      device=q_bits.device)
    kernels.launch("cobra_sps_attention", _ARGTYPES, q_bits.device,
                   q_bits.data_ptr(), k_bits.data_ptr(), vt_bits.data_ptr(),
                   theta.data_ptr(), b, h, k_bits.shape[1], length, d_h,
                   int(causal), out.data_ptr())
    sps_attention_gqa.launches += 1
    return out


sps_attention_gqa.launches = 0


def sps_attention(q_bits: torch.Tensor, k_bits: torch.Tensor,
                  v: torch.Tensor, theta: torch.Tensor, *, d_h: int,
                  causal: bool = True, path: str = "vpu") -> torch.Tensor:
    """One sequence, the TPU kernel's signature -> (H, L, d_h) int32."""
    _validate(q_bits, k_bits, d_h)
    if path == "vpu":
        vt = v
    elif path == "mxu":
        zero = torch.zeros((), device=v.device, dtype=torch.int32
                           if v.dtype == torch.int32 else torch.float32)
        vt = pack_ops.pack_threshold(v.transpose(-1, -2), zero)
    else:
        raise ValueError(f"path must be 'vpu' or 'mxu', got {path!r}")
    return sps_attention_gqa(q_bits[None], k_bits[None], vt[None],
                             theta.to(torch.int32), d_h=d_h,
                             causal=causal)[0]
