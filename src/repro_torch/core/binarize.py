"""Binarization functions (BiT-style) and the paper's fused integer
thresholds (port of ``repro.core.binarize``).

Two quantization schemes (paper Eq. 9):
  signed   {-1,+1}:  x_b = sign((x - beta) / alpha)          (weights, Q/K/V acts)
  unsigned {0, 1}:   x_b = clip(round((x - beta)/alpha),0,1) (post-ReLU acts,
                                                              attention probs)

Training runs latent full-precision tensors through straight-through
estimators (``torch.autograd.Function``s with the JAX package's
``custom_vjp`` rules); deployment folds (alpha, beta) into one integer
threshold theta per output channel (Eq. 10), which ``repro_torch.core.rbmm``
consumes.  Hard bits are ``torch.int32`` {0, 1} (the JAX package's
``uint32``).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def promote(x: Tensor, *others) -> Tensor:
    """``x`` cast to the dtype JAX gives ``x`` combined with ``others``.

    JAX promotes a bfloat16 array against a float32 parameter of any rank
    to float32; torch keeps bfloat16 when the float32 tensor is 0-d.  The
    QAT faces cast first, so both packages round at the same places."""
    tensors = [t.dtype for t in others if isinstance(t, Tensor)]
    dt = functools.reduce(torch.promote_types, tensors, x.dtype)
    return x.to(dt)


# ---------------------------------------------------------------------------
# STE primitives
# ---------------------------------------------------------------------------


class _SignSTE(torch.autograd.Function):
    """sign(x) with sign(0) := +1 (``torch.sign`` gives 0 there); clipped
    straight-through gradient: g passes where |x| <= 1 (BinaryConnect/BiT)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return (x >= 0).to(x.dtype) * 2 - 1

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


class _RoundSTE(torch.autograd.Function):
    """Round half UP, floor(x + 0.5) (``torch.round`` rounds half to even):
    keeps the Eq. 10 threshold fusion exact at integer-derived values on
    .5 boundaries.  Identity gradient."""

    @staticmethod
    def forward(ctx, x):
        return torch.floor(x + 0.5)

    @staticmethod
    def backward(ctx, g):
        return g


class _Clip(torch.autograd.Function):
    """clamp(x, lo, hi) with ``jnp.clip``'s gradient: 1 inside, 0 outside
    and 1/2 at either bound (JAX's max and min split a tie between their
    operands; ``torch.clamp`` passes all of it).  The bounds are hit
    exactly whenever a rounded value is clipped, as in the unsigned
    scheme."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        inside = ((x > lo) & (x < hi)).to(g.dtype)
        tie = ((x == lo) | (x == hi)).to(g.dtype)
        return g * (inside + 0.5 * tie), None, None


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """``jnp.clip(x, lo, hi)``, its gradient included."""
    return _Clip.apply(x, lo, hi)


def sign_ste(x: Tensor) -> Tensor:
    """sign with straight-through gradient; sign(0) := +1 (paper)."""
    return _SignSTE.apply(x)


def round_ste(x: Tensor) -> Tensor:
    return _RoundSTE.apply(x)


# ---------------------------------------------------------------------------
# Weight binarization (signed scheme, per-output-channel scale)
# ---------------------------------------------------------------------------


def init_weight_scale(w: Tensor, axis: int = 0) -> Tensor:
    """Per-output-channel mean(|w|) over the contraction axis (BiT init)."""
    return w.abs().mean(dim=axis, keepdim=True)


def binarize_weight(w: Tensor, alpha: Optional[Tensor] = None,
                    axis: int = 0) -> Tuple[Tensor, Tensor]:
    """W ~= alpha * sign(W); alpha defaults to mean(|w|) over ``axis``.
    Returns (w_binary_pm1, alpha)."""
    if alpha is None:
        alpha = init_weight_scale(w, axis)
    return sign_ste(w), alpha


# ---------------------------------------------------------------------------
# Activation binarization (elastic, learnable alpha/beta)
# ---------------------------------------------------------------------------


def binarize_act_signed(x: Tensor, alpha: Tensor, beta: Tensor) -> Tensor:
    """{-1,+1} elastic binarization with STE; output is alpha * sign(..)."""
    x = promote(x, alpha, beta)
    return alpha * sign_ste((x - beta) / alpha.clamp_min(1e-6))


def binarize_act_unsigned(x: Tensor, alpha: Tensor, beta: Tensor) -> Tensor:
    """{0,1} elastic binarization: alpha * clip(round((x-beta)/alpha), 0, 1)."""
    x = promote(x, alpha, beta)
    z = (x - beta) / alpha.clamp_min(1e-6)
    return alpha * clip(round_ste(z), 0.0, 1.0)


def bits_signed(x: Tensor, alpha=1.0, beta=0.0) -> Tensor:
    """Hard {0,1} bits of the signed scheme (bit = x - beta >= 0)."""
    return ((promote(x, beta) - beta) >= 0).to(torch.int32)


def bits_unsigned(x: Tensor, alpha, beta=0.0) -> Tensor:
    """Hard bits of the unsigned scheme: clip(round_half_up((x-b)/a),0,1)
    == (x >= beta + alpha/2), alpha and beta taken in x's dtype."""
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device).clamp_min(
        1e-6)
    b = torch.as_tensor(beta, dtype=x.dtype, device=x.device)
    return (x >= b + 0.5 * a).to(torch.int32)


# ---------------------------------------------------------------------------
# Fused integer thresholds (paper Eq. 10)
# ---------------------------------------------------------------------------


def fused_threshold(alpha: Tensor, beta: Tensor, scheme: str,
                    relu: bool = False) -> Tensor:
    """theta_j such that binarize(c_j) == (c_j >= theta_j) on integer RBMM
    outputs c.  signed: theta = beta.  unsigned: theta = round(alpha/2 +
    beta) (half to even, as ``jnp.round``); after a ReLU, max(0, that)."""
    if scheme == "signed":
        return beta
    if scheme != "unsigned":
        raise ValueError(f"unknown scheme {scheme!r}")
    theta = torch.round(0.5 * alpha + beta)
    return theta.clamp_min(0.0) if relu else theta


def apply_threshold(c: Tensor, theta: Tensor) -> Tensor:
    """Binarize an integer matmul output with the fused threshold -> {0,1}."""
    return (c >= theta).to(torch.int32)
