"""RBMM — real 1-bit binary matrix multiplication (paper §III-B, Eq. 7).

Port of ``repro.core.rbmm``, with the JAX functions' signatures:

  signed   x signed  ("xnor")  : a.b = 2*popcount(XNOR(a, b)) - K
  unsigned x signed  ("and_dc"): a.b = 2*popcount(AND(a, b))  - K + delta

Routes (``impl``):
  popcount : the ``rbmm_int`` kernel on the packed words; for
             ``rbmm_binary`` the threshold-fused ``rbmm_binary`` kernel.
  mxu      : the activations are unpacked to bf16 ±1 / {0,1} values and the
             ``rbmm_mxu`` kernel multiplies them with the packed weights
             on the tensor cores (exact: |acc| <= K < 2^24); the don't-care
             count is not needed and is ignored, as in the JAX package.
  dense    : same as mxu (the JAX package's dense route is its oracle).
  auto     : M <= 16 (decode, memory-bound) -> popcount, else mxu.

Leading dims broadcast as in the JAX package: a 2-D ``b`` (weights) serves
every leading index of ``a``.  Quantization fusion (Eq. 9/10):
``rbmm_binary`` emits the next layer's bits from the integer scores with
one compare ``c >= theta`` and returns the DC RETURN.  FFN blocking
(Eq. 11): ``ffn_blocked`` computes ReLU(X Y) Z as R rank-d blocks.

On CPU tensors each kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels.rbmm import ops as rbmm_ops
from repro_torch.kernels.rbmm_mxu import ops as mxu_ops

SCHEMES = ("xnor", "and_dc")
IMPLS = ("popcount", "mxu", "dense", "auto")
_I32 = torch.iinfo(torch.int32)


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


def int_threshold(theta, device) -> torch.Tensor:
    """``theta`` as int32 with ``c >= theta`` unchanged for every int32
    score c: a float is rounded up (exact, since |c| <= K < 2^24) and
    saturated to the int32 range; NaN, which no score reaches, becomes
    INT32_MAX, which none reaches either (|c| <= K)."""
    t = torch.as_tensor(theta, device=device)
    if t.dtype == torch.int32:
        return t
    if t.is_floating_point():
        t = torch.ceil(t.double()).nan_to_num(nan=_I32.max)
    return t.clamp(_I32.min, _I32.max).to(torch.int32)


def astype_int32(t: torch.Tensor) -> torch.Tensor:
    """A float tensor to int32 as the JAX package's ``astype(int32)``
    converts: toward zero, saturated to the int32 range, NaN -> 0."""
    t = t.nan_to_num(nan=0.0).double().clamp(_I32.min, _I32.max)
    return t.to(torch.int32)


def _unpack_operand(p: torch.Tensor, k: int,
                    scheme_side: str) -> torch.Tensor:
    """(..., M, Kp) words -> (..., M, K) bf16 values: 'signed' -> ±1,
    'unsigned' -> {0,1}."""
    bits = packing.unpack_bits(p, k)
    if scheme_side == "signed":
        bits = 2 * bits - 1
    return bits.to(torch.bfloat16)


def _fit(t: Optional[torch.Tensor], shape) -> Optional[torch.Tensor]:
    """``t`` broadcast to ``shape``, copied only where an axis really is
    broadcast: a tensor that has the shape already passes untouched, so a
    strided operand still meets the kernel wrapper's contiguity check."""
    if t is None or t.shape == shape:
        return t
    return t.expand(shape).contiguous()


def _aligned(a: torch.Tensor, b: torch.Tensor, *per_row: torch.Tensor):
    """Operands with equal leading dims for the kernels, which take them
    so.  A 2-D ``b`` serves every row of a contiguous ``a``: a's leading
    dims fold into M (with the per-row tensors, each ``(..., M, X)`` or
    ``(..., M)`` shaped like a's rows).  Otherwise the leading dims
    broadcast, and only the broadcast operands are copied.  Returns
    (a, b, per_row, unfold), where ``unfold`` gives an output of the
    folded rows a's leading dims back."""
    rows = a.shape[:-1]
    if b.dim() == 2 and a.dim() > 2 and a.is_contiguous():
        folded = [None if t is None else
                  t.reshape((-1,) + t.shape[len(rows):]) for t in per_row]
        return (a.reshape(-1, a.shape[-1]), b, folded,
                lambda t: t.reshape(rows + t.shape[1:]))
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    return (_fit(a, lead + a.shape[-2:]), _fit(b, lead + b.shape[-2:]),
            [None if t is None else _fit(t, lead + t.shape[len(rows) - 1:])
             for t in per_row], lambda t: t)


# ---------------------------------------------------------------------------
# Integer RBMM (Eq. 7)
# ---------------------------------------------------------------------------


def rbmm_int(a: torch.Tensor, b: torch.Tensor, k: int, *,
             scheme: str = "xnor", dc: Optional[torch.Tensor] = None,
             impl: str = "popcount") -> torch.Tensor:
    """Integer RBMM on packed operands.

    a: (..., M, Kp) int32 words, rows packed along K (LSB-first); xnor
       bits encode {-1 -> 0, +1 -> 1}, and_dc bits {0 -> 0, 1 -> 1}.
    b: (..., P, Kp) int32 words of the logical (K, P) matrix's columns,
       always signed; leading dims broadcast against a's.
    dc: optional don't-care counts (..., M) for and_dc.
    Returns (..., M, P) int32, exactly ``unpacked(a) @ unpacked(b).T``.
    """
    _check(scheme, impl)
    impl = resolve_impl(impl, a.shape[-2])
    a, b, (dc,), unfold = _aligned(a, b, _fit(dc, a.shape[:-1]))
    if impl in ("mxu", "dense"):
        a_side = "signed" if scheme == "xnor" else "unsigned"
        out = mxu_ops.rbmm_mxu(_unpack_operand(a, k, a_side), b)
        return unfold(out.to(torch.int32))  # exact integers; no dc needed
    return unfold(rbmm_ops.rbmm_int(a, b, k, scheme=scheme, dc=dc))


# ---------------------------------------------------------------------------
# Quantization-fused RBMM (Eq. 9/10)
# ---------------------------------------------------------------------------


def rbmm_binary(a: torch.Tensor, b: torch.Tensor, k: int, theta, *,
                scheme: str = "xnor", dc: Optional[torch.Tensor] = None,
                impl: str = "popcount", return_dc: bool = False,
                pack_output: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Quantization-fused RBMM: bits_j = (c_j >= theta_j), Eq. 10.

    theta: (P,) or broadcastable to (..., M, P), integer or float (a float
    threshold meets the integer score as the JAX package's float compare
    does; see ``int_threshold``).

    Returns (bits, dc_return):
      bits: packed (..., M, ceil(P/32)) int32 words if pack_output, else
            (..., M, P) int32 in {0,1}.
      dc_return: (..., M) int32 count of zeros among the P outputs (the
            paper's DC RETURN) if return_dc, else None.
    The popcount route runs the fused ``rbmm_binary`` kernel; mxu/dense
    compute the scores on that route (ignoring ``dc``, as the JAX package
    does), then threshold and pack.
    """
    _check(scheme, impl)
    theta = int_threshold(theta, a.device)
    impl = resolve_impl(impl, a.shape[-2])
    p = b.shape[-2]
    if impl in ("mxu", "dense"):
        c = rbmm_int(a, b, k, scheme=scheme, dc=dc, impl=impl)
        bits = (c >= theta).to(torch.int32)
        dc_out = (p - bits.sum(-1, dtype=torch.int32)) if return_dc \
            else None
        return (packing.pack_bits(bits) if pack_output else bits), dc_out
    out_shape = torch.broadcast_shapes(a.shape[:-1] + (p,),
                                       b.shape[:-2] + (1, p), theta.shape)
    rows = out_shape[:-1]
    a, b, (dc, theta), unfold = _aligned(
        _fit(a, rows + a.shape[-1:]), b, _fit(dc, rows),
        theta.expand(out_shape))
    bits, dc_out = rbmm_ops.rbmm_binary(
        a, b, k, theta, scheme=scheme, dc=dc, pack_output=pack_output)
    return unfold(bits), (unfold(dc_out) if return_dc else None)


# ---------------------------------------------------------------------------
# Split-K compositionality (Eq. 8)
# ---------------------------------------------------------------------------


def rbmm_int_split_k(a: torch.Tensor, b: torch.Tensor, k: int, splits: int,
                     *, scheme: str = "xnor",
                     dc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 8: partial RBVMs over S word-chunks accumulate to the full
    result.  Exact for any splits dividing Kp.  ``dc`` is accepted and
    not read, as in the JAX package: each chunk derives its own
    don't-care count from its words."""
    kp = a.shape[-1]
    if kp % splits:
        raise ValueError(f"splits={splits} must divide packed len {kp}")
    step = kp // splits
    total = None
    for s in range(splits):
        a_s = a[..., s * step:(s + 1) * step].contiguous()
        b_s = b[..., s * step:(s + 1) * step].contiguous()
        k_s = min(step * packing.WORD, k - s * step * packing.WORD)
        dc_s = packing.dc_count(a_s, k_s) if scheme == "and_dc" else None
        part = rbmm_int(a_s, b_s, k_s, scheme=scheme, dc=dc_s)
        total = part if total is None else total + part
    return total


# ---------------------------------------------------------------------------
# Blocked FFN (Eq. 11)
# ---------------------------------------------------------------------------


def ffn_blocked(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, k: int,
                theta1, r: int, *, impl: str = "popcount") -> torch.Tensor:
    """E = ReLU(X Y) Z  as  sum_r ReLU(X Y_r) Z_r   (Eq. 11).

    x: (..., M, Kp) packed signed activations (K = d).
    y: (FF, Kp) packed signed W1 columns (FF = R*d).
    z: (R, D, d_blk/32) packed signed W2 columns, pre-split by chunk.
    theta1: (FF,) fused unsigned+ReLU thresholds for the first layer.
    Returns (..., M, D) int32 accumulated over R blocks; per block one
    rbmm_binary (F1, packed bits and their DC RETURN) feeds one and_dc
    rbmm_int (F2), so only l x d_blk bits are ever live.
    """
    _check("xnor", impl)
    ff = y.shape[-2]
    if ff % r:
        raise ValueError(f"R={r} must divide FF={ff}")
    d_blk = ff // r
    theta1 = int_threshold(theta1, x.device)
    acc = None
    for s in range(r):
        y_s = y[..., s * d_blk:(s + 1) * d_blk, :]
        th_s = theta1[..., s * d_blk:(s + 1) * d_blk]
        h_bits, h_dc = rbmm_binary(x, y_s, k, th_s, scheme="xnor",
                                   impl=impl, return_dc=True,
                                   pack_output=True)
        part = rbmm_int(h_bits, z[s], d_blk, scheme="and_dc", dc=h_dc,
                        impl=impl)
        acc = part if acc is None else acc.add_(part)
    return acc


def split_w2_for_blocked_ffn(w2_packed_by_chunk: torch.Tensor
                             ) -> torch.Tensor:
    """Identity helper documenting the expected Z layout: (R, D, d//32)."""
    return w2_packed_by_chunk


# ---------------------------------------------------------------------------
# Mode wrappers — the paper's M1-M4 / F1-F2
# ---------------------------------------------------------------------------


def mode_m1_qkv(x, w, k: int, theta, *,
                impl: str = "popcount") -> torch.Tensor:
    """M1: Q/K/V projection (l x d x d), quantized binary output."""
    bits, _ = rbmm_binary(x, w, k, theta, scheme="xnor", impl=impl)
    return bits


def mode_m2_score(q, kmat, d_h: int, lam_theta, *,
                  mask: Optional[torch.Tensor] = None,
                  impl: str = "popcount"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M2: attention scores -> SPS bits (..., h, l, l) unpacked, int32, and
    DC HEADs (..., h, l); ``mask`` True = masked out -> bit 0."""
    c = rbmm_int(q, kmat, d_h, scheme="xnor", impl=impl)
    bits = (c >= int_threshold(lam_theta, c.device)).to(torch.int32)
    if mask is not None:
        bits = torch.where(mask, torch.zeros_like(bits), bits)
    dc = bits.shape[-1] - bits.sum(-1, dtype=torch.int32)
    return bits, dc


def mode_m3_context(probs_packed, v_t, l: int, dc, theta, *,
                    impl: str = "popcount") -> torch.Tensor:
    """M3: context = probs ({0,1}) x V^T -> quantized binary output bits."""
    bits, _ = rbmm_binary(probs_packed, v_t, l, theta, scheme="and_dc",
                          dc=dc, impl=impl)
    return bits


def mode_m4_linear(x, w, k: int, *, impl: str = "popcount") -> torch.Tensor:
    """M4: MHA output projection -> integer output for LayerNorm."""
    return rbmm_int(x, w, k, scheme="xnor", impl=impl)


def mode_f1_ffn1(x, w1, k: int, theta_relu, *, impl: str = "popcount"
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """F1: FFN layer I with fused ReLU+unsigned binarization; DC FULL out."""
    return rbmm_binary(x, w1, k, theta_relu, scheme="xnor", impl=impl,
                       return_dc=True)


def mode_f2_ffn2(h_bits, w2, ff: int, dc, *,
                 acc: Optional[torch.Tensor] = None,
                 impl: str = "popcount") -> torch.Tensor:
    """F2: FFN layer II, {0,1} x {-1,1} -> integer, accumulated."""
    out = rbmm_int(h_bits, w2, ff, scheme="and_dc", dc=dc, impl=impl)
    if acc is not None:
        out = out + acc
    return out


# ---------------------------------------------------------------------------
# Dense-simulation twin (QAT forward; the oracle the packed path must match)
# ---------------------------------------------------------------------------


def rbmm_sim(a_vals: torch.Tensor, b_vals: torch.Tensor) -> torch.Tensor:
    """Float matmul of already-binarized value matrices: a (..., M, K) in
    {-1,1} or {0,1}; b (..., P, K) in {-1,1}.  Integer-exact in float32
    (|acc| <= K < 2^24), so int32 out."""
    out = torch.matmul(a_vals.to(torch.float32),
                       b_vals.to(torch.float32).transpose(-1, -2))
    return out.to(torch.int32)
