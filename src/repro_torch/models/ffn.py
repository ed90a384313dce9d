"""Binary FFN (port of ``repro.models.ffn.BinaryFFN``): the QAT face
``apply`` (latent weights through sign STEs, float32 +-1 products, the
hidden layer through the unsigned round STE; dense and expert-stacked)
and the deploy face.

ReLU FFN (BERT family, the paper's exact target):
  F1: the first RBMM with the ReLU and the unsigned binarization fused into
      its threshold (Eq. 10), emitting packed bits and their DC RETURN
      (the rbmm_binary kernel);
  F2: those {0,1} bits against W2 through the and_dc scheme (rbmm_int).
  ``blocked_r`` runs the Eq. 11 blocked form: R chunks of FF, two l x d
  live buffers.

GLU FFN (llama family, and gemma's GELU GLU): gate and up projections are
binary RBMMs sharing one input binarization; ``act(u) * g`` (SiLU, or the
tanh-approximated GELU that ``jax.nn.gelu`` computes by default) stays fp,
is unsigned-binarized and packed (pack kernel), and meets the binary down
projection through the and_dc scheme (F2).

Expert stacking (``num_experts`` > 0): every weight carries a leading E
axis and both faces take (E, C, d) expert buffers, one batched product
per projection (the QAT face's a batched float32 +-1 matmul, the deploy
face's a batched RBMM); the four activation scales stay shared across
experts.

MoE (``BinaryMoE``): capacity-based dispatch of token rows (or of their
packed activation bits) to (E, C, ...) expert buffers, the expert-stacked
FFN, and the gated combine; the router stays float32.  The QAT face
``apply`` also returns the Switch load-balance loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core import binarize, packing, rbmm
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.models import nn, sharding
from repro_torch.models.linear import (BinaryDense, act_bits_packed,
                                       pm1_matmul, rbmm_placed)
from repro_torch.models.sharding import P

Params = Dict[str, Any]

# (act, glu) pairs the port runs
PORTED = (("silu", True), ("gelu", True), ("relu", False))

# the rows of each block of the router's product (``BinaryMoE._probs``)
ROUTER_ROWS = 1024
# the budget of one intermediate of an expert group (``BinaryMoE.group``)
GROUP_BYTES = 2 * 2**30


def glu_act(act: str, u: torch.Tensor) -> torch.Tensor:
    """The GLU's activation of the float32 ``u``: SiLU, or GELU in its
    tanh form (``jax.nn.gelu``'s default, ``approximate=True``)."""
    if act == "gelu":
        return F.gelu(u, approximate="tanh")
    return F.silu(u)


def _stacked(one: Callable[[int], Any], n: int) -> Any:
    """The trees ``one(0) .. one(n - 1)`` stacked on a new leading axis,
    filled one tree at a time, so the temporaries stay one tree's size (a
    ``torch.stack`` of all n would hold every tree and the stack at once;
    arctic's 128 experts hold 13.4 B parameters a layer)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + t.shape)

    def fill(dst, src, e):
        if isinstance(src, dict):
            for k, v in src.items():
                fill(dst[k], v, e)
        else:
            dst[e].copy_(src)

    first = one(0)
    out = alloc(first)
    fill(out, first, 0)
    del first
    for e in range(1, n):
        fill(out, one(e), e)
    return out


def _expert(tree: Any, e: int) -> Any:
    """Expert ``e``'s slice of an expert-stacked tree (views)."""
    if isinstance(tree, dict):
        return {k: _expert(v, e) for k, v in tree.items()}
    return tree[e]


@dataclasses.dataclass(frozen=True)
class BinaryFFN:
    d_model: int
    d_ff: int
    act: str = "silu"               # silu | gelu (GLU) | relu (paper)
    glu: bool = True
    blocked_r: int = 0              # Eq. 11 R (relu path only); 0 = unblocked
    dtype: torch.dtype = torch.float32
    impl: str = "auto"
    # expert stacking: when > 0 all weights get a leading E axis and the
    # deploy face operates on (E, C, d) expert batches
    num_experts: int = 0
    expert_parallel: bool = False   # shard E over "model" instead of ff
    w2_partition: str = "row"       # w2's sharding: row | col

    def __post_init__(self):
        if (self.act, self.glu) not in PORTED:
            raise NotImplementedError(
                f"BinaryFFN act={self.act!r} glu={self.glu} is not ported "
                f"yet; the port runs the SiLU and GELU GLUs and the ReLU "
                f"FFN")
        if self.num_experts and not self.glu:
            raise NotImplementedError(
                "an expert-stacked ReLU FFN is not ported yet; the port's "
                "experts are GLUs")

    def _w1(self) -> BinaryDense:
        return BinaryDense(self.d_model, self.d_ff, external_act=True,
                           dtype=self.dtype, partition="col")

    def _w2(self) -> BinaryDense:
        return BinaryDense(self.d_ff, self.d_model, external_act=True,
                           dtype=self.dtype, partition=self.w2_partition)

    def specs(self) -> Params:
        """The QAT params' specs (the JAX package's): an expert stack's
        leaves take a leading expert entry, "model" when the experts are
        spread over it (``expert_parallel``), else None."""
        return self._specs(BinaryDense.specs)

    def deploy_specs(self) -> Params:
        """The deploy params' specs (the JAX package's ``specs(deploy=
        True)``), expert entries as in ``specs``."""
        return self._specs(BinaryDense.deploy_specs)

    def _specs(self, dense_specs: Callable[[BinaryDense], Params]) -> Params:
        if self.num_experts and self.expert_parallel:
            fix = lambda t: {k: P("model", *(None,) * len(s))
                             for k, s in t.items()}
        elif self.num_experts:
            fix = nn.stack_spec
        else:
            fix = lambda t: t
        w1 = dense_specs(self._w1())
        p: Params = {"w1": fix(w1), "w2": fix(dense_specs(self._w2()))}
        if self.glu:
            p["w3"] = fix(w1)
        for k in ("act_alpha", "act_beta", "h_alpha", "h_beta"):
            p[k] = P()
        return p

    def _build(self, make: Callable[[BinaryDense], Params],
               device) -> Params:
        """The params ``make`` gives each projection, drawn in ``init``'s
        order (an expert stack expert by expert: w1, w2, w3 of expert 0,
        then of expert 1, ...), then the activation scales."""
        def one(_e: int = 0) -> Params:
            p: Params = {"w1": make(self._w1()), "w2": make(self._w2())}
            if self.glu:
                p["w3"] = make(self._w1())
            return p

        p = _stacked(one, self.num_experts) if self.num_experts else one()
        # activation scales are shared across experts (one binarization
        # unit; keeps the dispatch of packed bits expert-agnostic)
        for k, v in (("act_alpha", 1.0), ("act_beta", 0.0),
                     ("h_alpha", 1.0), ("h_beta", 0.0)):
            p[k] = torch.full((), v, device=device)
        return p

    def init(self, gen: torch.Generator, device) -> Params:
        return self._build(lambda layer: layer.init(gen, device), device)

    def init_deploy(self, gen: torch.Generator, device) -> Params:
        """``convert(init(gen, device))`` with one projection's float32
        master alive at a time: each is drawn, converted and freed before
        the next draws (an expert stack fills its packed stack expert by
        expert)."""
        return self._build(lambda layer: layer.init_deploy(gen, device),
                           device)

    def convert(self, params: Params,
                load: Callable[[Any], Any] = lambda t: t) -> Params:
        """QAT params -> deploy params; an expert stack converts expert by
        expert (the JAX package's ``jax.vmap(layer.convert)``), so the
        temporaries stay one expert's size.  ``load`` maps a subtree of
        ``params`` to tensors where it is read (``bridge.deploy_from_jax``
        passes numpy layers): an expert stack loads one expert at a
        time."""
        def conv(layer: BinaryDense, wp: Params) -> Params:
            if self.num_experts:
                return _stacked(
                    lambda e: layer.convert(load(_expert(wp, e))),
                    self.num_experts)
            return layer.convert(load(wp))

        d: Params = {"w1": conv(self._w1(), params["w1"]),
                     "w2": conv(self._w2(), params["w2"])}
        if self.glu:
            d["w3"] = conv(self._w1(), params["w3"])
        for k in ("act_alpha", "act_beta", "h_alpha", "h_beta"):
            d[k] = load(params[k])
        return d

    def _act_fn(self, u: torch.Tensor) -> torch.Tensor:
        return F.relu(u) if self.act == "relu" else glu_act(self.act, u)

    def apply(self, params: Params, x: torch.Tensor,
              split: sharding.Split = sharding.WHOLE) -> torch.Tensor:
        """QAT forward: x (..., d) -> (..., d) in ``dtype``; an expert
        stack takes (E, C, d) and multiplies each expert's rows by its own
        weights (a batched matmul), scaled by alpha_w (E, 1, P)
        (``signs``, then ``apply_experts``).

        ``split`` (``sharding.Split``; a dense FFN on (B, S, d) only):
        ``x`` and the output are this rank's block of the sequence; the
        signs of ``x`` are gathered whole along it, ``w1``/``w3`` give
        this rank's d_ff columns (``sharding.split_range``;
        ``sharding.col_product``: their input gradient goes to the
        positions' ranks by an all-to-all) and the
        mid-activation's binarization runs on them; its {0, 1} values go
        to the ranks whose positions they are (``sharding.to_rows``), and
        ``w2`` multiplies this rank's positions by its whole weight.
        ``params`` may hold ``sharding.Gathered`` leaves."""
        if self.num_experts:
            if split.width > 1:
                raise ValueError("an expert stack splits by expert "
                                 "(apply_experts); only a dense FFN splits "
                                 "its columns along \"model\"")
            sc = self.scales(params)
            return self.apply_experts(params, self.signs(params, x, sc),
                                      scales=sc)
        spans = sharding.ranges(self.d_ff, split)

        def take(leaf, dim, signs=False):
            return sharding.columns(leaf, dim, spans, split, signs)

        w1, w3 = ({"w_sign": take(params[k]["w_latent"], -1, True),
                   "alpha_w": take(params[k]["alpha_w"], -1)}
                  if k in params else None for k in ("w1", "w3"))
        w2 = {"w_sign": sharding.whole(params["w2"]["w_latent"], True),
              "alpha_w": sharding.whole(params["w2"]["alpha_w"])}
        sc = self.scales(params)
        act_alpha, h_alpha, h_beta = sc["act_alpha"], sc["h_alpha"], \
            sc["h_beta"]
        s_own = self.signs(params, x, sc)
        s_x = sharding.seq_gather(s_own.detach(), split, signs=True)

        def scale(wp, y, a_scale):
            return y * wp["alpha_w"] * a_scale

        def cols(k, wp):
            return scale(wp, sharding.col_product(
                s_own, s_x, wp["w_sign"], params[k]["w_latent"], split,
                spans, self.dtype), act_alpha)

        h = self._act_fn(cols("w1", w1))
        if self.glu:
            h = h * cols("w3", w3)
        ha = h_alpha.clamp_min(1e-6)
        h_vals = binarize.clip(binarize.round_ste((h - h_beta) / ha), 0.0,
                               1.0)
        h_vals = sharding.to_rows(h_vals, split, spans, signed=False)
        return scale(w2, pm1_matmul(h_vals, w2["w_sign"], self.dtype),
                     h_alpha).to(self.dtype)

    @staticmethod
    def scales(params: Params) -> Params:
        """The four activation scales, gathered whole (once a forward:
        each gather of a placed leaf adds a reduction to the backward)."""
        return {k: sharding.whole(params[k]) for k in
                ("act_alpha", "act_beta", "h_alpha", "h_beta")}

    def signs(self, params: Params, x: torch.Tensor,
              scales: Optional[Params] = None) -> torch.Tensor:
        """The QAT input binarization of ``x``: sign((x - act_beta) /
        act_alpha) through the straight-through estimator (+-1 values);
        the scales are shared by an expert stack's experts, so a token's
        signs serve each expert it claims.  ``scales``: ``scales(params)``
        where the caller has them."""
        sc = scales or self.scales(params)
        act_alpha, act_beta = sc["act_alpha"], sc["act_beta"]
        alpha = act_alpha.clamp_min(1e-6)
        return binarize.sign_ste(
            (binarize.promote(x, alpha, act_beta) - act_beta) / alpha)

    def apply_experts(self, params: Params, s: torch.Tensor,
                      split: sharding.Split = sharding.WHOLE,
                      scales: Optional[Params] = None) -> torch.Tensor:
        """An expert stack's QAT face on +-1 input values ``s`` (E', C, d)
        -> (E', C, d) in ``dtype``: each expert's rows times its +-1
        weights (batched float32 products, ``pm1_matmul``), scaled by
        alpha_w (E', 1, P) and the activation scale, the GLU, the hidden
        layer's round STE, the down projection.  E' is every expert, or,
        with ``split`` (an expert-parallel stack split along "model"),
        this rank's block of them (``sharding.ranges``), whose leaves are
        gathered over the data axes only (``sharding.columns``: the
        gradient is this block's whole one).  ``params`` may hold
        ``sharding.Gathered`` leaves; the weights travel as sign bits
        (``scales`` as in ``signs``)."""
        spans = sharding.ranges(self.num_experts, split)

        def stack_leaf(leaf, signs=False):
            return sharding.columns(leaf, 0, spans, split, signs)

        sc = scales or self.scales(params)
        act_alpha, h_alpha, h_beta = sc["act_alpha"], sc["h_alpha"], \
            sc["h_beta"]

        def proj(k, v, a_scale):
            y = pm1_matmul(v, stack_leaf(params[k]["w_latent"], True),
                           self.dtype)
            return y * stack_leaf(params[k]["alpha_w"])[:, None, :] * a_scale

        h = self._act_fn(proj("w1", s, act_alpha))
        if self.glu:
            h = h * proj("w3", s, act_alpha)
        ha = h_alpha.clamp_min(1e-6)
        h_vals = binarize.clip(binarize.round_ste((h - h_beta) / ha), 0.0,
                               1.0)
        return proj("w2", h_vals, h_alpha).to(self.dtype)

    def apply_deploy(self, params: Params, x: Optional[torch.Tensor] = None,
                     *, bits: Optional[torch.Tensor] = None,
                     take: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deploy forward, fp in and out; a fully binary matmul chain.
        Either fp ``x`` (binarized here) or, for the GLU FFN, pre-packed
        ``bits``; the ReLU FFN binarizes inside its fused F1 and takes
        ``x`` only, as in the JAX package.  An expert stack (GLU only)
        takes (E, C, d) rows or (E, C, Kp) bits; ``take`` (N,) picks the
        rows (of the E * C) whose outputs come back, (N, d).

        On a mesh (placed params; ``linear.rbmm_placed``) ``w1``/``w3``
        give this rank's d_ff columns where they are split on their rows,
        the mid-activation's bits of them feed ``w2``'s block of words
        where that block is exactly them (nothing crosses between the
        two), else they are put together whole (``sharding.join_bits``);
        ``w2``'s int32 partials are all-reduced over "model" (its words
        split) or its rows' outputs all-gathered: only the rows ``take``
        picks cross."""
        if self.glu:
            return self._deploy_glu(params, x, bits=bits, take=take)
        if bits is not None or take is not None:
            raise ValueError("the ReLU FFN takes fp x, not packed bits")
        if self.blocked_r:
            return self._deploy_relu_blocked(params, x)
        return self._deploy_relu(params, x)

    def _mm_int(self, wp: Params, bits: torch.Tensor, k: int,
                scheme: str = "xnor", dc: Optional[torch.Tensor] = None,
                held: Optional[Tuple[int, int]] = None,
                take: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RBMM of (..., Kp) bits against packed weights -> (c, alpha_w),
        c of the output columns that ``rows_held`` names on a mesh
        (``linear.rbmm_placed``); an expert stack multiplies (E, C, Kp)
        bits by its (E, P, Kp) words in one batched RBMM, scaled by (E, 1,
        P), or with ``take`` the picked rows' (N, P) by their experts'
        (N, P)."""
        if self.num_experts:
            c, _ = rbmm_placed(bits, wp["w_packed"], k, scheme=scheme,
                               dc=dc, impl=self.impl, held=held, take=take)
            if take is None:
                return c, wp["alpha_w"][:, None, :]
            return c, wp["alpha_w"].index_select(0, take // bits.shape[-2])
        shape = bits.shape[:-1]
        c, _ = rbmm_placed(bits.reshape(-1, bits.shape[-1]), wp["w_packed"],
                           k, scheme=scheme,
                           dc=None if dc is None else dc.reshape(-1),
                           impl=self.impl, held=held)
        return c.reshape(shape + (c.shape[-1],)), wp["alpha_w"]

    def _to_w2(self, params: Params, words: torch.Tensor,
               own: Tuple[int, int], dc: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Tuple[int, int]],
                          Optional[torch.Tensor]]:
        """The mid-activation's packed bits of this rank's d_ff columns
        ``own`` (and their don't-care count) -> (bits, the words they
        hold, dc) for ``w2``: as they are where ``w2``'s block of words is
        exactly them, or where they are every column; else every rank's
        put together whole (``sharding.join_bits``; dc derived by the
        product)."""
        held = self._w2().words_held(params["w2"])
        lo, hi = own        # every rank's block as wide: each decides alike
        if held is not None and (hi - lo) % packing.WORD == 0 and \
                held == (lo // packing.WORD, hi // packing.WORD):
            return words, held, dc
        if own == (0, self.d_ff):
            return words, None, dc
        split = sharding.decode_split(params["w1"]["w_packed"])
        n = hi - lo
        spans = [(r * n, (r + 1) * n) for r in range(split.width)]
        return sharding.join_bits(words, split, spans, self.d_ff), None, None

    def _w2_out(self, params: Params, c2: torch.Tensor,
                scale2: torch.Tensor) -> torch.Tensor:
        """``w2``'s outputs, scaled, in ``dtype``: every column (a rows
        block's all-gathered)."""
        y = (c2.to(torch.float32) * scale2 * params["h_alpha"]).to(self.dtype)
        return sharding.take_cols(
            y, sharding.decode_split(params["w2"]["w_packed"]),
            self._w2().rows_held(params["w2"]), self.d_model)

    def _deploy_relu(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Unblocked F1 -> F2 with the fused ReLU+unsigned threshold."""
        w1 = self._w1()
        h_bits, dc = w1.apply_deploy_fused_unsigned(
            params["w1"], x, params["h_alpha"], params["h_beta"],
            relu=self.act == "relu", impl=self.impl,
            act_alpha=params["act_alpha"], act_beta=params["act_beta"])
        h_bits, held, dc = self._to_w2(params, h_bits,
                                       w1.rows_held(params["w1"]), dc)
        c2, scale2 = self._mm_int(params["w2"], h_bits, self.d_ff,
                                  scheme="and_dc", dc=dc, held=held)
        return self._w2_out(params, c2, scale2)

    def _deploy_relu_blocked(self, params: Params,
                             x: torch.Tensor) -> torch.Tensor:
        """Eq. 11: R-chunked F1/F2 with two live l x d buffers (whole
        weights only: a placed block raises)."""
        for k in ("w1", "w2"):
            sharding.placed_block(params[k]["w_packed"], ())
        r = self.blocked_r
        bits = act_bits_packed(x, params["act_beta"])
        shape = bits.shape[:-1]
        a2 = bits.reshape(-1, bits.shape[-1])
        d_blk = self.d_ff // r
        # theta1 per FF channel (fused ReLU+unsigned), float32
        scale1 = (params["act_alpha"] * params["w1"]["alpha_w"]
                  ).clamp_min(1e-12)
        t = params["h_beta"] + 0.5 * params["h_alpha"]
        theta1 = torch.where(t > 0, torch.ceil(t / scale1),
                             float(-(self.d_model + 1)))
        # W2 (d, FF/32) -> (R, d, d_blk/32): chunk s is z[s], contiguous
        z = params["w2"]["w_packed"].reshape(
            self.d_model, r, d_blk // packing.WORD).transpose(0, 1)
        c2 = rbmm.ffn_blocked(a2, params["w1"]["w_packed"], z.contiguous(),
                              self.d_model, rbmm.astype_int32(theta1), r,
                              impl="popcount")
        c2 = c2.reshape(shape + (self.d_model,))
        y = (c2.to(torch.float32) * params["w2"]["alpha_w"] *
             params["h_alpha"])
        return y.to(self.dtype)

    def _deploy_glu(self, params: Params, x: Optional[torch.Tensor] = None,
                    *, bits: Optional[torch.Tensor] = None,
                    take: Optional[torch.Tensor] = None) -> torch.Tensor:
        if bits is None:
            bits = act_bits_packed(x, params["act_beta"])
        c_u, scale1 = self._mm_int(params["w1"], bits, self.d_model)
        c_g, scale3 = self._mm_int(params["w3"], bits, self.d_model)
        aa = params["act_alpha"]
        u = c_u.to(torch.float32) * scale1 * aa
        g = c_g.to(torch.float32) * scale3 * aa
        h = glu_act(self.act, u) * g                   # fp elementwise
        h_bits = pack_ops.pack_threshold(
            h, params["h_beta"] + 0.5 * params["h_alpha"])
        h_bits, held, _ = self._to_w2(params, h_bits,
                                      self._w1().rows_held(params["w1"]))
        # the and_dc RBMM derives dc = d_ff - popcount(h_bits) from the
        # words, which is the JAX package's d_ff - sum(hb)
        c2, scale2 = self._mm_int(params["w2"], h_bits, self.d_ff,
                                  scheme="and_dc", held=held, take=take)
        return self._w2_out(params, c2, scale2)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BinaryMoE:
    """Capacity-routed mixture of binary GLU experts: the QAT face
    ``apply`` (returns the Switch load-balance loss too) and the deploy
    face.

    Each of the N = prod(x.shape[:-1]) rows (padded and inactive rows of a
    pooled step included, as in the JAX package) claims its ``top_k``
    experts in token-major order; a claim past an expert's ``capacity``
    slots is dropped (its gate zeroed).  ``capacity`` is a host int from
    the shapes alone, so the forward reads nothing on the host.
    ``dispatch_bits`` dispatches the rows' packed activation bits (legal
    because the activation scales are shared across experts) instead of
    the fp rows.  ``dense_residual`` (arctic) adds a dense FFN on the
    undispatched rows.  The router's product is float32 as PyTorch runs it
    by default, TF32 off: the card must choose the experts the CPU
    chooses.  In the QAT face the gradient reaches the router through the
    gates and the load-balance loss; a dropped claim's rows get none (the
    trash row is cut off, and its combine weight is 0)."""
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False
    act: str = "silu"
    glu: bool = True
    dtype: torch.dtype = torch.float32
    impl: str = "auto"
    dispatch_bits: bool = False
    expert_parallel: bool = True
    w2_partition: str = "row"

    def _experts(self) -> BinaryFFN:
        return BinaryFFN(self.d_model, self.d_ff, act=self.act, glu=self.glu,
                         dtype=self.dtype, impl=self.impl,
                         num_experts=self.num_experts,
                         expert_parallel=self.expert_parallel,
                         w2_partition=self.w2_partition)

    def _residual_ffn(self) -> BinaryFFN:
        return BinaryFFN(self.d_model, self.d_ff, act=self.act, glu=self.glu,
                         dtype=self.dtype, impl=self.impl,
                         w2_partition=self.w2_partition)

    def _router(self) -> nn.Dense:
        return nn.Dense(self.d_model, self.num_experts, use_bias=False,
                        partition="none")

    def specs(self) -> Params:
        p: Params = {"router": self._router().specs(),
                     "experts": self._experts().specs()}
        if self.dense_residual:
            p["residual"] = self._residual_ffn().specs()
        return p

    def deploy_specs(self) -> Params:
        """The deploy params' specs (the JAX package's ``specs(deploy=
        True)``): the router stays float32 and whole."""
        p: Params = {"router": self._router().specs(),
                     "experts": self._experts().deploy_specs()}
        if self.dense_residual:
            p["residual"] = self._residual_ffn().deploy_specs()
        return p

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {"router": self._router().init(gen, device),
                     "experts": self._experts().init(gen, device)}
        if self.dense_residual:
            p["residual"] = self._residual_ffn().init(gen, device)
        return p

    def init_deploy(self, gen: torch.Generator, device) -> Params:
        """``convert(init(gen, device))`` in ``init``'s order: the router
        (kept float32), the experts one at a time, the residual FFN."""
        p: Params = {"router": self._router().init(gen, device),
                     "experts": self._experts().init_deploy(gen, device)}
        if self.dense_residual:
            p["residual"] = self._residual_ffn().init_deploy(gen, device)
        return p

    def convert(self, params: Params,
                load: Callable[[Any], Any] = lambda t: t) -> Params:
        """QAT params -> deploy params (``load`` as ``BinaryFFN.convert``
        takes it)."""
        d: Params = {"router": load(params["router"]),
                     "experts": self._experts().convert(params["experts"],
                                                        load)}
        if self.dense_residual:
            d["residual"] = self._residual_ffn().convert(params["residual"],
                                                         load)
        return d

    def capacity(self, n: int) -> int:
        """Slots per expert for ``n`` routed rows."""
        return int(max(1, math.ceil(
            n * self.top_k * self.capacity_factor / self.num_experts)))

    def group(self, rows: int) -> int:
        """The experts the deploy face runs at once on buffers of ``rows``
        rows an expert: as many as keep the group's largest intermediate
        (an int32 or float32 (group, rows, max(d_ff, d_model)) product)
        within ``GROUP_BYTES``, at least one.  From the shapes alone, so
        every rank runs as many groups."""
        per = rows * max(self.d_ff, self.d_model) * 4
        return max(1, min(self.num_experts, GROUP_BYTES // per))

    # -- dispatch ------------------------------------------------------------

    def _probs(self, params: Params, x2: torch.Tensor) -> torch.Tensor:
        """The router's float32 softmax over experts, (N, E).  Above
        ``ROUTER_ROWS`` rows the product runs on blocks of exactly that
        many rows (the last padded with zero rows), so a row's logits are
        the sums a product of that shape gives it however many rows there
        are: a mesh rank that routes its own positions picks the experts,
        and the gates, one device picks for them (a library may block the
        reduction by the row count)."""
        dense = self._router()
        x = x2.to(torch.float32)
        n = x.shape[0]
        if n <= ROUTER_ROWS:
            logits = dense.apply(params["router"], x)
        else:
            if n % ROUTER_ROWS:
                x = torch.cat([x, x.new_zeros((-n % ROUTER_ROWS,
                                               x.shape[1]))])
            logits = torch.cat([dense.apply(params["router"], t)
                                for t in x.split(ROUTER_ROWS)])[:n]
        return torch.softmax(logits.to(torch.float32), dim=-1)

    def _route(self, params: Params, x2: torch.Tensor,
               split: sharding.Split = sharding.WHOLE, segments: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor, int]:
        """x2: (N, d) -> (gates (N, k) float32, expert idx (N, k), slot
        (N, k), keep (N, k), capacity).  Among equal probabilities the
        lowest expert index ranks first, as ``lax.top_k`` ranks them (a
        stable descending sort; ``torch.topk`` promises no order).

        Where ``x2`` is the whole batch (one device), as the JAX package:
        each claim's slot is its place among the claims on its expert in
        token order, capacity C = ``capacity(N)``, keep = slot < C.  Where
        the global batch's positions are shared over ranks
        (``sharding.claim_shares``: the data axes of the context, and
        "model" where ``split`` splits the sequence), ``x2`` holds this
        rank's ``segments`` equal segments (one for each batch row, in row
        order): C counts the global batch's rows, keep holds where the
        claim's global slot (from every share's per-segment counts,
        ``sharding.claim_offsets``) is below C, and slot is the claim's row
        in this rank's buffer, its place among this rank's claims on its
        expert; capacity is the buffer's rows, min(N, C).  A rank's claims
        on an expert take increasing global slots, so the kept ones come
        first, and they fit: top-k picks distinct experts."""
        probs = self._probs(params, x2)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :self.top_k], idx[:, :self.top_k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        return (gates, idx) + self._slots(idx, split, segments)

    def _slots(self, idx: torch.Tensor, split: sharding.Split = sharding.WHOLE,
               segments: int = 1) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """The claims ``idx`` (N, k) -> (slot, keep, capacity) as
        ``_route`` gives them."""
        n, e = idx.shape[0], self.num_experts
        # each (token, k) claim's place among this rank's claims on its
        # expert
        flat = idx.reshape(-1)
        onehot = (flat[:, None] == torch.arange(e, device=idx.device)).to(
            torch.int32)
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
        slot = torch.gather(pos, 1, flat[:, None])[:, 0].reshape(
            n, self.top_k)
        _, axes, shares = sharding.claim_shares(split)
        if not axes:
            capacity = self.capacity(n)
            return slot, slot < capacity, capacity
        capacity = self.capacity(n * shares)
        off = sharding.claim_offsets(
            onehot.reshape(segments, -1, e).sum(1, dtype=torch.int32), split,
            idx)
        first = torch.gather(off, 1, idx.reshape(segments, -1))
        keep = slot + first.reshape(n, self.top_k) < capacity
        return slot, keep, min(n, capacity)

    def _aux_loss(self, params: Params, x2: torch.Tensor,
                  split: sharding.Split = sharding.WHOLE) -> torch.Tensor:
        """Switch load-balance loss: E * sum over experts of (the share of
        rows whose first choice it is) * (its mean probability).  The
        router runs again, as in the JAX package, so the gradient is the
        sum over both uses; the argmax takes the first maximum, as
        ``jnp.argmax``.  Where the batch's positions are shared over ranks
        (as ``_route`` reads them) the first choices are counted over
        every share and each rank returns its rows' part of the mean
        probability's term: the parts sum to the global batch's loss.
        Ranks of "model" that hold the same positions (a sequence
        ``split`` keeps whole) each return a width's share of that."""
        probs = self._probs(params, x2)
        top1 = torch.argmax(probs, dim=-1)
        first = (top1[:, None] == torch.arange(
            self.num_experts, device=x2.device)).to(torch.float32)
        mesh, axes, shares = sharding.claim_shares(split)
        if not axes:
            aux = self.num_experts * torch.sum(first.mean(0) *
                                               probs.mean(0))
        else:
            n = float(x2.shape[0] * shares)
            frac = mesh.all_reduce(first.sum(0), axes) / n
            aux = self.num_experts * torch.sum(frac * probs.sum(0) / n)
        if split.width > 1 and not split.seq:
            aux = aux / split.width
        return aux

    def _dispatch(self, x2: torch.Tensor, idx: torch.Tensor,
                  slot: torch.Tensor, keep: torch.Tensor,
                  capacity: int, experts: int = 0) -> torch.Tensor:
        """Token rows (fp, or packed words) placed into (E, C, ...) expert
        buffers (``experts`` of them where given, ``idx`` counted from the
        first): each kept claim writes its own (expert, slot) row once,
        dropped claims the one trash row past the E * C real ones, which
        is cut off (the JAX package scatter-adds fp rows and scatter-maxes
        uint32 words onto zeros; the port's int32 words would lose bit 31
        to a max, and a placement gives both packages' values)."""
        k, e = idx.shape[1], experts or self.num_experts
        trash = e * capacity
        dest = torch.where(keep, idx * capacity + slot, trash).reshape(-1)
        rows = x2.repeat_interleave(k, dim=0)
        buf = x2.new_zeros((trash + 1,) + tuple(x2.shape[1:]))
        buf.index_copy_(0, dest, rows)
        return buf[:trash].view((e, capacity) + tuple(x2.shape[1:]))

    @staticmethod
    def _sources(idx: torch.Tensor, slot: torch.Tensor,
                 capacity: int) -> torch.Tensor:
        """(N * k,) the expert-buffer row of each claim (a dropped one's
        clamped to a real row, whose gate is 0)."""
        return (idx * capacity + slot.clamp(0, capacity - 1)).reshape(-1)

    @staticmethod
    def _weigh(got: torch.Tensor, gates: torch.Tensor,
               keep: torch.Tensor) -> torch.Tensor:
        """The claims' expert outputs (N * k, d) weighted by the gates (a
        dropped claim's gate is 0) and summed per row, (N, d) float32."""
        n, k = gates.shape
        w = (gates * keep.to(gates.dtype))[:, :, None]
        return (got.reshape(n, k, -1) * w).sum(1)

    def _combine(self, out_buf: torch.Tensor, gates: torch.Tensor,
                 idx: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
        """(E, C, d) expert outputs gathered back to (N, d), weighted by
        the gates, in float32."""
        src = self._sources(idx, slot, out_buf.shape[1])
        got = out_buf.reshape(-1, out_buf.shape[-1]).index_select(0, src)
        return self._weigh(got, gates, keep)

    def _stack(self, ep: Params, key: str, rows: torch.Tensor,
               gates: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor,
               keep: torch.Tensor, cap: int) -> torch.Tensor:
        """The deploy face of the whole expert stack ``ep`` on buffers of
        ``cap`` rows an expert, dispatched from ``rows`` (fp rows or their
        packed bits, ``key``), combined: (N, d) float32.  The experts run
        ``group(cap)`` at a time, each group on its own claims' buffer;
        each claim takes its output row from its expert's group, and the
        gated sum runs once over them all (the same sums as one group)."""
        experts, e = self._experts(), self.num_experts
        g = self.group(cap)
        src = self._sources(idx, slot, cap)
        got = None
        for g0 in range(0, e, g):
            g1 = min(e, g0 + g)
            inside = (idx >= g0) & (idx < g1)
            buf = self._dispatch(rows, idx - g0, slot, keep & inside, cap,
                                 g1 - g0)
            out = experts.apply_deploy(_experts_of(ep, g0, g1),
                                       **{key: buf})
            part = out.reshape(-1, out.shape[-1]).index_select(
                0, (src - g0 * cap).clamp(0, (g1 - g0) * cap - 1))
            got = part if got is None else torch.where(
                inside.reshape(-1, 1), part, got)
        return self._weigh(got, gates, keep)

    def _claimed(self, ep: Params, key: str, buf: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
        """The expert stack's outputs (N * k, d) at the claims' buffer
        rows ``src``, on a mesh (``ep`` this rank's placed blocks of the
        stack; ``buf`` (E, C, ...) its dispatched ``key`` input)."""
        experts, w1 = self._experts(), ep["w1"]["w_packed"]
        by, e0, e1 = sharding.placed_block(w1, (0, 1, 2))
        if by != 0:
            return experts.apply_deploy(ep, take=src, **{key: buf})
        cap = buf.shape[1]
        own = (src >= e0 * cap) & (src < e1 * cap)
        local = tree.map(lambda t: t.view(t.shape), ep)   # blocks, whole
        got = experts.apply_deploy(
            local, take=(src - e0 * cap).clamp(0, (e1 - e0) * cap - 1),
            **{key: buf[e0:e1]})
        got = torch.where(own[:, None], got.to(torch.float32), 0.0)
        return sharding.decode_split(w1).mesh.all_reduce(
            got, "model").to(self.dtype)

    def _exchanged(self, ep: Params, split: sharding.Split) -> bool:
        """Does the QAT face send the claims to their experts' ranks: an
        expert-parallel stack whose leaves lie split on their experts
        along "model" (placed ``sharding.Gathered`` leaves), on a sequence
        ``split`` splits?"""
        pl = getattr(ep["w1"]["w_latent"], "placement", None)
        return (self.expert_parallel and split.seq and split.width > 1 and
                pl is not None and pl.dims.get("model") == 0)

    def _expert_parallel(self, ep: Params, x2: torch.Tensor,
                         gates: torch.Tensor, idx: torch.Tensor,
                         keep: torch.Tensor,
                         split: sharding.Split) -> torch.Tensor:
        """The QAT face of an expert stack split by expert over "model"
        (``_exchanged``), on this rank's rows ``x2`` (N, d) -> (N, d)
        float32 combined.  The rows' signs are taken here; each kept claim
        goes to its expert's rank as sign bits (``sharding.to_experts``:
        rank j's share padded to the static bound min(k N, (E / m) min(N,
        C)) rows), which places the claims it gets at rows of its own
        experts' buffer ((E / m, min(m N, C), d): the data index's claims
        on an expert, in the order they come) and runs its experts on it
        (``BinaryFFN.apply_experts``, the leaves gathered over the data
        axes only); each claim's float32 output row comes back
        (``sharding.from_experts``) and the gates weigh it here.  The
        gradients travel the other way."""
        experts, e, k = self._experts(), self.num_experts, self.top_k
        m, n, dev = split.width, x2.shape[0], x2.device
        em = e // m
        cap = self.capacity(n * sharding.claim_shares(split)[2])
        bound = min(k * n, em * min(n, cap))
        sc = experts.scales(ep)
        s = experts.signs(ep, x2, sc)
        # each kept claim's slot among those for its expert's rank
        dest = (idx // em).reshape(-1)
        kept = keep.reshape(-1)
        to = ((dest[:, None] == torch.arange(m, device=dev)) &
              kept[:, None]).to(torch.int32)
        pos = torch.gather(torch.cumsum(to, 0, dtype=torch.int32) - 1, 1,
                           dest[:, None])[:, 0]
        slot = torch.where(kept, dest * bound + pos, m * bound).long()
        src = torch.full((m * bound + 1,), n, dtype=torch.long,
                         device=dev).index_copy_(
            0, slot, torch.arange(n * k, device=dev) // k)[:-1]
        tags = torch.full((m * bound + 1,), em, dtype=torch.int32,
                          device=dev).index_copy_(
            0, slot, (idx % em).reshape(-1).to(torch.int32))[:-1]
        got, got_tags = sharding.to_experts(s, src, tags.reshape(m, bound),
                                            split)
        # the claims this rank's experts get, at rows of their buffer
        rows = min(n * m, cap)
        t = got_tags.reshape(-1).long()
        onehot = (t[:, None] == torch.arange(em, device=dev)).to(torch.int32)
        place = torch.gather(torch.cumsum(onehot, 0, dtype=torch.int32) - 1,
                             1, t.clamp(max=em - 1)[:, None])[:, 0]
        at = torch.where(t < em, t * rows + place, em * rows)
        buf = got.new_zeros((em * rows + 1, got.shape[-1])).index_copy(
            0, at, got.reshape(-1, got.shape[-1]))
        out = experts.apply_experts(ep, buf[:em * rows].view(em, rows, -1),
                                    split, sc)
        back = sharding.from_experts(out.reshape(em * rows, -1), at, slot,
                                     split)
        return self._weigh(back, gates, keep)

    # -- faces ---------------------------------------------------------------

    @staticmethod
    def _segments(x: torch.Tensor) -> int:
        """The segments of a face's input (B, S, d): its batch rows (one
        for rows (N, d))."""
        return x.shape[0] if x.dim() == 3 else 1

    def apply(self, params: Params, x: torch.Tensor,
              split: sharding.Split = sharding.WHOLE
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """QAT forward: x (..., d) -> (y (..., d) in ``dtype``,
        {"moe_aux_loss": the load-balance loss}).  Capacity, top-k,
        dispatch and combine are the deploy face's; the experts run their
        QAT face on the (E, C, d) buffer of fp rows.

        ``split`` (``sharding.Split``; ``Block.qat``'s): ``x`` (B, S, d)
        is this rank's block of the sequence, routed here (``_route``: its
        own claims, at the global capacity and slots), and ``params`` may
        hold ``sharding.Gathered`` leaves.  The experts run on this rank's
        buffer with their +-1 weights gathered whole as sign bits, or, an
        expert-parallel stack split over "model", on the experts' ranks
        (``_expert_parallel``); a ``residual`` FFN takes the column split
        of a dense FFN (``BinaryFFN.apply``)."""
        shape = x.shape
        x2 = x.reshape(-1, self.d_model)
        params = dict(params, router=sharding.materialize(params["router"]))
        gates, idx, slot, keep, cap = self._route(params, x2, split,
                                                  self._segments(x))
        ep = params["experts"]
        if self._exchanged(ep, split):
            y = self._expert_parallel(ep, x2, gates, idx, keep, split)
        else:
            out_buf = self._experts().apply(
                ep, self._dispatch(x2, idx, slot, keep, cap))
            y = self._combine(out_buf, gates, idx, slot, keep)
        if self.dense_residual:
            y = y + self._residual_ffn().apply(
                params["residual"], x, split=split).reshape(y.shape)
        aux = {"moe_aux_loss": self._aux_loss(params, x2, split)}
        return y.reshape(shape).to(self.dtype), aux

    def apply_deploy(self, params: Params, x: torch.Tensor,
                     split: Optional[sharding.Split] = None) -> torch.Tensor:
        """Deploy forward: route (the router whole), dispatch, the expert
        stack on its buffers (``_stack``: whole weights, in groups of
        experts), the gated combine.  On a split prefill (``split``,
        ``sharding.prefill_split``; the params gathered whole) ``x`` (B,
        S, d) holds this rank's block of the sequence, routed at the
        global capacity and slots (``_route``).  On a mesh decode (placed
        params) only the claims' rows of the stack's outputs are kept
        (``take``), the buffers keep the global batch's C rows an expert,
        and the stack runs on this rank's block: split on its
        rows and words as a dense FFN (``BinaryFFN.apply_deploy``), or by
        expert (``expert_parallel``): this rank's experts' buffers run
        whole, each claim takes its expert's rank's row and zeros on the
        others, and the float32 rows are summed over "model" (exact: one
        term of each is not zero)."""
        shape, split = x.shape, split or sharding.WHOLE
        x2 = x.reshape(-1, self.d_model)
        gates, idx, slot, keep, cap = self._route(params, x2, split,
                                                  self._segments(x))
        ep = params["experts"]
        rows = (act_bits_packed(x2, ep["act_beta"]) if self.dispatch_bits
                else x2)
        key = "bits" if self.dispatch_bits else "x"
        if getattr(ep["w1"]["w_packed"], "placement", None) is None:
            y = self._stack(ep, key, rows, gates, idx, slot, keep, cap)
        else:
            # a decode step keeps its buffers of C rows an expert
            cap = self.capacity(x2.shape[0] * sharding.claim_shares(split)[2])
            buf = self._dispatch(rows, idx, slot, keep, cap)
            y = self._weigh(self._claimed(ep, key, buf, self._sources(
                idx, slot, cap)), gates, keep)
        if self.dense_residual:
            y = y + self._residual_ffn().apply_deploy(params["residual"], x2)
        return y.reshape(shape).to(self.dtype)


def _experts_of(ep: Params, e0: int, e1: int) -> Params:
    """Experts [e0, e1) of an expert stack's deploy params (views; the
    shared activation scales as they are)."""
    return {k: tree.map(lambda t: t[e0:e1], v) if k in ("w1", "w2", "w3")
            else v for k, v in ep.items()}
