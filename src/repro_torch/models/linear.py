"""BinaryDense: the COBRA linear layer (port of ``repro.models.linear``).

QAT face — latent fp weights, BiT-style (``apply``):
    y = alpha_a * alpha_w,j * (s_a . s_w,j) + bias_j
with s_a = sign((x - beta_a)/alpha_a) and s_w = sign(w_latent) through
straight-through estimators.  The +-1 dot product is a float32 matmul of
+-1 operands (exact: |acc| <= K < 2^24), as the JAX package's einsum with
``preferred_element_type=float32``; like every +-1 product of the JAX
package's training path it lies outside any Pallas kernel.

Deploy face — packed int32 weights (1 bit per value), Eq. 7 RBMM:
    bits_a = (x >= beta_a)                 (the pack kernel)
    c      = RBMM(bits_a, w_packed)        (rbmm_int or rbmm_mxu kernel)
    y      = alpha_a * alpha_w * c + bias
or, quantization-fused (Eq. 10), the next layer's packed bits directly
(the ``rbmm_binary`` kernel):
    bits_y = (c >= theta),  theta = ceil((next_beta - bias) / (alpha_a alpha_w))
``convert()`` maps QAT params to deploy params (pack + keep scales).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import binarize, packing, rbmm
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.models import nn, sharding
from repro_torch.models.sharding import P

Params = Dict[str, Any]

# the size of the mesh axis the deploy specs split packed weights over
# ("model" of the production mesh, ``launch.mesh.make_production_mesh``)
MODEL_PARTITIONS = 16


def act_bits_packed(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Signed-scheme activation bits, packed: bit = x >= beta (float32
    compare, as the JAX package promotes a compute-dtype x against its
    float32 beta)."""
    return pack_ops.pack_threshold(x, beta.to(torch.float32))


def rbmm_placed(bits: torch.Tensor, w: torch.Tensor, k: int, *,
                scheme: str = "xnor", dc: Optional[torch.Tensor] = None,
                impl: str = "auto",
                held: Optional[Tuple[int, int]] = None,
                take: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The decode rule's integer product of (..., M, Kp) bits by packed
    weights ``w`` (..., P, Kp) of K = ``k`` bits, ``w`` this rank's block
    on a mesh (``sharding.placed_block``; unplaced: whole) -> (c int32,
    the output columns [lo, hi) of P that c holds):
      * whole: every column from the whole bits;
      * output rows split: this rank's rows, from the whole bits;
      * packed contraction words split: this rank's words of the bits (of
        all words, or ``held``, the words [lo, hi) ``bits`` hold, which
        must be the block), of their true bit count (32 a word, the last
        block's pad excepted; and_dc derives its don't-care count per
        block: 2 popc(AND) - popc(bits)), the int32 partial sums
        all-reduced over "model" (exact) before any scale: every column.
    ``take`` (N,): only these rows of c (its leading dims and M
    flattened), picked before the exchange, (N, P)."""
    nd = w.dim()
    d, lo, hi = sharding.placed_block(w, (nd - 2, nd - 1))
    p = w.shape[-2] if d != nd - 2 else w.placement.shape[-2]
    if d == nd - 1:
        if held is None:
            bits, dc = bits[..., lo:hi].contiguous(), None
        elif tuple(held) != (lo, hi):
            raise ValueError(f"bits of words {held} meet a weight block of "
                             f"words {(lo, hi)}")
        kb = min(k, packing.WORD * hi) - packing.WORD * lo
        c = _take(rbmm.rbmm_int(bits, w, kb, scheme=scheme, dc=dc,
                                impl=impl), take)
        return sharding.decode_split(w).mesh.all_reduce(c, "model"), (0, p)
    if held is not None:
        raise ValueError(f"a product whole along its words takes every "
                         f"word of its bits, got words {held}")
    c = _take(rbmm.rbmm_int(bits, w, k, scheme=scheme, dc=dc, impl=impl),
              take)
    return c, ((lo, hi) if d == nd - 2 else (0, p))


def _take(c: torch.Tensor, take: Optional[torch.Tensor]) -> torch.Tensor:
    return c if take is None else c.reshape(-1, c.shape[-1]).index_select(
        0, take)


def pm1_matmul(a: torch.Tensor, wb: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """(..., K) +-1 / {0,1} values times (K, P) +-1 weights, summed in
    float32.  Both operands are rounded to ``dtype`` first (exact for
    these values), where the JAX package's einsum takes them, so the
    backward rounds their gradients to ``dtype`` as JAX's does; the
    product itself runs on float32 operands, exact on every device (a
    bfloat16 product would round sums above 256 to bfloat16)."""
    return torch.matmul(a.to(dtype).to(torch.float32),
                        wb.to(dtype).to(torch.float32))


@dataclasses.dataclass(frozen=True)
class BinaryDense:
    in_dim: int
    out_dim: int
    use_bias: bool = False
    # reuses caller-provided activation bits and carries no act scales
    external_act: bool = False
    dtype: torch.dtype = torch.float32
    partition: str = "col"          # col | row | none (sharding of (in, out))

    def init(self, gen: torch.Generator, device) -> Params:
        w = nn.truncated_normal(gen, (self.in_dim, self.out_dim),
                                1.0 / math.sqrt(self.in_dim), device)
        p: Params = {"w_latent": w,
                     "alpha_w": binarize.init_weight_scale(w, axis=0)[0]}
        if not self.external_act:
            p["act_alpha"] = torch.ones((), device=device)
            p["act_beta"] = torch.zeros((), device=device)
        if self.use_bias:
            p["bias"] = torch.zeros(self.out_dim, device=device)
        return p

    def specs(self) -> Params:
        """The QAT params' specs (the JAX package's)."""
        wspec = nn.MATRIX_SPECS[self.partition]
        out_axis = wspec[1]
        p: Params = {"w_latent": wspec, "alpha_w": P(out_axis)}
        if not self.external_act:
            p["act_alpha"] = P()
            p["act_beta"] = P()
        if self.use_bias:
            p["bias"] = P(out_axis)
        return p

    def apply(self, params: Params, x: Optional[torch.Tensor] = None, *,
              act_values: Optional[torch.Tensor] = None,
              act_scale=1.0) -> torch.Tensor:
        """QAT forward -> compute-dtype output.  Either fp ``x`` (..., in),
        which this layer binarizes with its own scales, or ``act_values``
        (+-1 / {0,1} unscaled values: a shared QKV binarization, attention
        probabilities) with ``act_scale``.  The scales multiply after the
        +-1 accumulation, so the integer part is the deploy RBMM's.
        ``params`` may give the weight's signs (``w_sign``, +-1 through
        the straight-through estimator) in place of ``w_latent``, and a
        column range (``w_sign`` (in, n), ``alpha_w`` and ``bias`` (n,))
        gives those n outputs."""
        if self.external_act:
            if act_values is None:
                raise ValueError("a layer with external_act takes "
                                 "act_values")
            a, a_scale = act_values, act_scale
        else:
            if x is None:
                raise ValueError("apply needs x for a layer with its own "
                                 "activation scales")
            alpha = params["act_alpha"].clamp_min(1e-6)
            beta = params["act_beta"]
            a = binarize.sign_ste(
                (binarize.promote(x, alpha, beta) - beta) / alpha)
            a_scale = params["act_alpha"]
        wb = params["w_sign"] if "w_sign" in params else \
            binarize.sign_ste(params["w_latent"])
        return self.finish(params, pm1_matmul(a, wb, self.dtype), a_scale)

    def finish(self, params: Params, y: torch.Tensor,
               act_scale=1.0) -> torch.Tensor:
        """``apply``'s last step: the scales, and the bias, on a +-1 sum
        ``y`` (a column range's from ``sharding.col_product``)."""
        y = y * (params["alpha_w"].to(torch.float32) * torch.as_tensor(
            act_scale, dtype=torch.float32, device=y.device))
        if self.use_bias:
            y = y + params["bias"]
        return y.to(self.dtype)

    def deploy_specs(self) -> Params:
        """The deploy params' specs (the JAX package's): the packed (out,
        ceil(in/32)) words split along "model" on the output rows where
        ``MODEL_PARTITIONS`` divides them, else on the packed contraction
        words (a "row" layer prefers the words)."""
        mp = MODEL_PARTITIONS
        kp_ok = packing.packed_len(self.in_dim) % mp == 0
        out_ok = self.out_dim % mp == 0
        if self.partition == "col":
            wspec = (P("model", None) if out_ok else
                     (P(None, "model") if kp_ok else P(None, None)))
        elif self.partition == "row":
            wspec = (P(None, "model") if kp_ok else
                     (P("model", None) if out_ok else P(None, None)))
        else:
            wspec = P(None, None)
        out_axis = wspec[0] if wspec[0] == "model" else None
        p: Params = {"w_packed": wspec, "alpha_w": P(out_axis)}
        if not self.external_act:
            p["act_alpha"] = P()
            p["act_beta"] = P()
        if self.use_bias:
            p["bias"] = P(out_axis)
        return p

    def init_deploy(self, gen: torch.Generator, device) -> Params:
        """``convert(init(gen, device))``: the master is freed on return."""
        return self.convert(self.init(gen, device))

    def convert(self, params: Params) -> Params:
        """QAT params -> deploy params: (out, ceil(in/32)) packed columns."""
        d: Params = {"w_packed": packing.pack_signs_rows(
                         params["w_latent"].T),
                     "alpha_w": params["alpha_w"]}
        for k in ("act_alpha", "act_beta", "bias"):
            if k in params:
                d[k] = params[k]
        return d

    def apply_deploy(self, params: Params, x: Optional[torch.Tensor] = None,
                     *, bits: Optional[torch.Tensor] = None,
                     act_alpha: Optional[torch.Tensor] = None,
                     scheme: str = "xnor", dc: Optional[torch.Tensor] = None,
                     impl: str = "auto", held: Optional[Tuple[int, int]] = None,
                     cols=None) -> torch.Tensor:
        """Deploy forward -> compute-dtype output.  Either fp ``x`` (this
        layer binarizes and packs it) or packed ``bits`` from upstream with
        ``act_alpha`` (and, for the unsigned scheme, ``dc``).  On a mesh
        (placed params) the product runs on this rank's block of the
        weight (``rbmm_placed``; ``held``: the words ``bits`` hold), and
        this rank's columns of ``cols`` come back (every rank's, or one
        pair for all; default all): a rows block's all-gathered over
        "model" where some rank's rows do not hold its columns
        (``sharding.take_cols``)."""
        if bits is None:
            if self.external_act or x is None:
                raise ValueError("apply_deploy needs x for a layer with its "
                                 "own activation scales, else bits")
            bits = act_bits_packed(x, params["act_beta"])
            act_alpha = params["act_alpha"]
            scheme = "xnor"
        if act_alpha is None:
            raise ValueError("apply_deploy with bits needs act_alpha")
        shape = bits.shape[:-1]
        a2 = bits.reshape(-1, bits.shape[-1])
        dc2 = dc.reshape(-1) if dc is not None else None
        c, own = rbmm_placed(a2, params["w_packed"], self.in_dim,
                             scheme=scheme, dc=dc2, impl=impl, held=held)
        c = c.reshape(shape + (c.shape[-1],))
        y = (c.to(torch.float32) * params["alpha_w"] *
             act_alpha.to(torch.float32))
        if self.use_bias:
            y = y + params["bias"]
        return sharding.take_cols(y.to(self.dtype), sharding.decode_split(
            params["w_packed"]), own, self.out_dim, cols)

    def rows_held(self, params: Params) -> Tuple[int, int]:
        """The output rows [lo, hi) this rank computes: its block where
        the weight is split on its rows, else all."""
        w = params["w_packed"]
        d, lo, hi = sharding.placed_block(w, (w.dim() - 2, w.dim() - 1))
        return (lo, hi) if d == w.dim() - 2 else (0, self.out_dim)

    def words_held(self, params: Params) -> Optional[Tuple[int, int]]:
        """The packed contraction words [lo, hi) this rank multiplies
        where the weight is split on them, else None (every word)."""
        w = params["w_packed"]
        d, lo, hi = sharding.placed_block(w, (w.dim() - 2, w.dim() - 1))
        return (lo, hi) if d == w.dim() - 1 else None

    def _fused(self, params: Params, bits: torch.Tensor,
               theta: torch.Tensor, impl: str, return_dc: bool
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(..., Kp) bits -> packed (..., ceil(out/32)) bits of
        c >= theta, with their zero counts (...,) if asked; on a mesh,
        of this rank's rows (``rows_held``: the threshold needs every
        word, so a weight split on its words raises)."""
        w = params["w_packed"]
        sharding.placed_block(w, (w.dim() - 2,))
        shape = bits.shape[:-1]
        out_bits, dc_ret = rbmm.rbmm_binary(
            bits.reshape(-1, bits.shape[-1]), params["w_packed"],
            self.in_dim, rbmm.astype_int32(theta), scheme="xnor",
            impl=impl, return_dc=return_dc)
        out_bits = out_bits.reshape(shape + (out_bits.shape[-1],))
        return out_bits, (None if dc_ret is None else dc_ret.reshape(shape))

    def apply_deploy_fused(self, params: Params, x: torch.Tensor,
                           next_beta: torch.Tensor, *, impl: str = "auto",
                           return_dc: bool = False
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Deploy forward with Eq. 10 fusion: packed signed bits of
        binarize(y, next_beta) without materializing y (the paper's M1).
        theta_j = ceil((next_beta - bias_j) / (alpha_a * alpha_w_j)), in
        float32 as the JAX package computes it."""
        bits = act_bits_packed(x, params["act_beta"])
        scale = params["act_alpha"] * params["alpha_w"]
        shift = params["bias"] if self.use_bias else 0.0
        theta = torch.ceil((next_beta - shift) / scale.clamp_min(1e-12))
        return self._fused(params, bits, theta, impl, return_dc)

    def apply_deploy_fused_unsigned(
            self, params: Params, x: torch.Tensor, h_alpha: torch.Tensor,
            h_beta: torch.Tensor, *, relu: bool = True, impl: str = "auto",
            return_dc: bool = True, act_alpha: Optional[torch.Tensor] = None,
            act_beta: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """F1: fused ReLU + *unsigned* binarization (Eq. 10, second case).

        bit = (relu(y) >= h_beta + h_alpha/2).  When the fp threshold
        t = h_beta + h_alpha/2 > 0 the ReLU is absorbed (c >= ceil((t-b)/s));
        otherwise every post-ReLU value passes and theta drops to -(K+1)
        (always true, since c >= -K)."""
        if act_alpha is None:
            act_alpha = params["act_alpha"]
        if act_beta is None:
            act_beta = params["act_beta"]
        bits = act_bits_packed(x, act_beta)
        scale = (act_alpha * params["alpha_w"]).clamp_min(1e-12)
        shift = params["bias"] if self.use_bias else 0.0
        t = h_beta + 0.5 * h_alpha
        theta = torch.ceil((t - shift) / scale)
        if relu:
            theta = torch.where(t > 0, theta, float(-(self.in_dim + 1)))
        return self._fused(params, bits,
                           theta.expand(params["w_packed"].shape[-2]), impl,
                           return_dc)
