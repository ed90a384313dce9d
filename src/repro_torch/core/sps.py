"""SPS — Shifted Polarized Softmax (paper §III-A) and its threshold search
(port of ``repro.core.sps``).

SPS replaces ``binarize(softmax(QK^T/sqrt(d_h)))`` with a direct
polarization

    SPS(z) = 1[z >= lambda_{i,k}]          (Eq. 3/4)

with per-layer / per-head (default) / per-row thresholds lambda found by a
grid search over [0, 1] (step 0.05) minimizing the Channel Distortion Rate
(MSE, Eq. 5/6) against the BiT softmax + elastic binarization attention on
a calibration set, then fixed while the weights fine-tune.

Integer-domain folding: with binarized Q, K (scales alpha_q, alpha_k) the
condition z = alpha_q*alpha_k*c / sqrt(d_h) >= lambda on the integer RBMM
accumulator c becomes c >= theta, theta = ceil(lambda * sqrt(d_h) /
(alpha_q * alpha_k)): one integer compare, the ``sps_attention`` and
``paged_gather_decode`` kernels' threshold operand.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

GRID_STEP = 0.05
GRANULARITIES = ("layer", "head", "row")


# the 21 float32 values i * 0.05 of Eq. 6, as the JAX package's
DEFAULT_GRID = torch.arange(21, dtype=torch.float32) * GRID_STEP


# ---------------------------------------------------------------------------
# SPS forward
# ---------------------------------------------------------------------------


def sps(z: Tensor, lam: Tensor) -> Tensor:
    """Eq. 3: polarize scores to {0,1}.  ``lam`` broadcasts against z
    ((), (H,1,1) or (H,L,1) for the layer / head / row granularity)."""
    return (z >= lam).to(z.dtype)


class _SPSSTE(torch.autograd.Function):
    """The hard 0/1 step forward; backward passes g to z and -g to lambda
    where |z - lambda| <= width, lambda's share summed down to its own
    shape (JAX reduces over the broadcast axes in its custom VJP;
    autograd does not reduce a custom Function's gradient)."""

    @staticmethod
    def forward(ctx, z, lam, width):
        ctx.save_for_backward(z, lam)
        ctx.width = width
        return (z >= lam).to(z.dtype)

    @staticmethod
    def backward(ctx, g):
        z, lam = ctx.saved_tensors
        win = ((z - lam).abs() <= ctx.width).to(g.dtype)
        gz = g * win
        glam = (-g * win).sum_to_size(lam.shape)
        return gz, glam, None


def sps_ste(z: Tensor, lam: Tensor, ste_width: float = 1.0) -> Tensor:
    """SPS with a straight-through gradient window (the training
    surrogate): the hard step forward, gradient where |z - lam| <=
    ``ste_width`` (BiT's clipped-STE convention)."""
    return _SPSSTE.apply(z, lam, ste_width)


def integer_threshold(lam: Tensor, d_h: int, alpha_q: Tensor,
                      alpha_k: Tensor) -> Tensor:
    """Fold lambda, 1/sqrt(d_h) and the binarization scales into the
    integer RBMM threshold: c >= theta <=> alpha_q*alpha_k*c/sqrt(d_h) >=
    lambda.  Float, as the JAX package returns it."""
    scale = (alpha_q * alpha_k) / math.sqrt(d_h)
    return torch.ceil(lam / scale.clamp_min(1e-12))


# ---------------------------------------------------------------------------
# BiT reference attention probability (Eq. 2): the search target
# ---------------------------------------------------------------------------


def att_prob_bit(z: Tensor, alpha=0.5,
                 mask: Optional[Tensor] = None) -> Tensor:
    """clip(round(softmax(z)/alpha), 0, 1) with optional masking
    (True = drop); z: (..., L, L) scores QK^T/sqrt(d_h)."""
    if mask is not None:
        z = torch.where(mask, float("-inf"), z)
    p = torch.softmax(z, dim=-1)
    a = torch.as_tensor(alpha, dtype=p.dtype, device=p.device).clamp_min(
        1e-6)
    return torch.round(p / a).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# CDR + search (Eq. 5/6)
# ---------------------------------------------------------------------------


def cdr(a1: Tensor, a2: Tensor, axes: Tuple[int, ...]) -> Tensor:
    """Channel Distortion Rate: MSE between two attention maps over
    ``axes``."""
    d = (a1.to(torch.float32) - a2.to(torch.float32)) ** 2
    return d.mean(dim=axes)


def _reduce_axes(granularity: str, ndim: int) -> Tuple[int, ...]:
    # z: (B, H, L, L).  layer -> scalar; head -> (H,); row -> (H, L).
    if granularity == "layer":
        return tuple(range(ndim))
    if granularity == "head":
        return (0,) + tuple(range(2, ndim))
    if granularity == "row":
        return (0, ndim - 1)
    raise ValueError(f"granularity must be one of {GRANULARITIES}")


def search_thresholds(z: Tensor, target: Tensor, *,
                      granularity: str = "head",
                      grid: Optional[Tensor] = None,
                      mask: Optional[Tensor] = None
                      ) -> Tuple[Tensor, Tensor]:
    """Grid-search lambda* minimizing CDR(target, SPS(z; lambda)) (Eq. 6).

    z:      (B, H, L, L) calibration scores (already 1/sqrt(d_h)-scaled).
    target: (B, H, L, L) BiT binarized attention probs (``att_prob_bit``).
    Returns (lambda*, cdr*): layer -> ((), ()), head -> ((H,), (H,)), row
    -> ((H, L), (H, L)); ties go to the smallest lambda (the first
    minimum, as ``jnp.argmin``).  One grid point at a time, so no
    (G, B, H, L, L) tensor."""
    grid = DEFAULT_GRID.to(z.device) if grid is None else grid
    axes = _reduce_axes(granularity, z.ndim)
    losses = []
    for lam in grid:
        probs = sps(z, lam)
        if mask is not None:
            probs = torch.where(mask, 0.0, probs)
        losses.append(cdr(target, probs, axes))
    losses = torch.stack(losses)                   # (G, *unit_shape)
    best = torch.argmin(losses, dim=0)
    return grid[best], torch.gather(losses, 0, best[None])[0]


@dataclasses.dataclass
class SPSCalibration:
    """Search result for one attention layer."""
    lam: Tensor             # per granularity unit
    cdr: Tensor
    granularity: str

    def lam_broadcast(self) -> Tensor:
        """lambda shaped to broadcast against (B, H, L, L) scores."""
        if self.granularity == "layer":
            return self.lam
        if self.granularity == "head":
            return self.lam[:, None, None]
        return self.lam[:, :, None]           # row: (H, L, 1)


def calibrate_layer(z: Tensor, *, bit_alpha=0.5, granularity: str = "head",
                    mask: Optional[Tensor] = None,
                    grid: Optional[Tensor] = None) -> SPSCalibration:
    """Per-layer calibration: the BiT target from the same scores (Eq. 2),
    then the search (Eq. 6)."""
    target = att_prob_bit(z, bit_alpha, mask)
    lam, c = search_thresholds(z, target, granularity=granularity,
                               grid=grid, mask=mask)
    return SPSCalibration(lam=lam, cdr=c, granularity=granularity)


# ---------------------------------------------------------------------------
# Fig. 3 similarity diagnostics
# ---------------------------------------------------------------------------


def similarity_report(bit_probs: Tensor, sps_probs: Tensor
                      ) -> Dict[str, float]:
    """Cosine similarity, Pearson correlation and row-norm agreement between
    BiT-softmax attention and SPS attention (paper Fig. 3)."""
    a = bit_probs.to(torch.float32).reshape(-1)
    b = sps_probs.to(torch.float32).reshape(-1)
    eps = 1e-8
    cos = torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b)
                             + eps)
    am, bm = a - a.mean(), b - b.mean()
    corr = torch.dot(am, bm) / (torch.linalg.norm(am) *
                                torch.linalg.norm(bm) + eps)
    rn_a = bit_probs.to(torch.float32).sum(-1).reshape(-1)
    rn_b = sps_probs.to(torch.float32).sum(-1).reshape(-1)
    rn = torch.corrcoef(torch.stack([rn_a, rn_b]))[0, 1]
    return {"cosine": float(cos), "pearson": float(corr),
            "row_norm_corr": float(rn)}
