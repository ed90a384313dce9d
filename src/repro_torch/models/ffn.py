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

from repro_torch.core import binarize, packing, rbmm
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.models import nn
from repro_torch.models.linear import BinaryDense, act_bits_packed, pm1_matmul

Params = Dict[str, Any]

# (act, glu) pairs the port runs
PORTED = (("silu", True), ("gelu", True), ("relu", False))


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
                           dtype=self.dtype)

    def _w2(self) -> BinaryDense:
        return BinaryDense(self.d_ff, self.d_model, external_act=True,
                           dtype=self.dtype)

    def init(self, gen: torch.Generator, device) -> Params:
        def one(_e: int = 0) -> Params:
            p: Params = {"w1": self._w1().init(gen, device),
                         "w2": self._w2().init(gen, device)}
            if self.glu:
                p["w3"] = self._w1().init(gen, device)
            return p

        p = _stacked(one, self.num_experts) if self.num_experts else one()
        # activation scales are shared across experts (one binarization
        # unit; keeps the dispatch of packed bits expert-agnostic)
        for k, v in (("act_alpha", 1.0), ("act_beta", 0.0),
                     ("h_alpha", 1.0), ("h_beta", 0.0)):
            p[k] = torch.full((), v, device=device)
        return p

    def convert(self, params: Params) -> Params:
        """QAT params -> deploy params; an expert stack converts expert by
        expert (the JAX package's ``jax.vmap(layer.convert)``), so the
        temporaries stay one expert's size."""
        def conv(layer: BinaryDense, wp: Params) -> Params:
            if self.num_experts:
                return _stacked(lambda e: layer.convert(_expert(wp, e)),
                                self.num_experts)
            return layer.convert(wp)

        d: Params = {"w1": conv(self._w1(), params["w1"]),
                     "w2": conv(self._w2(), params["w2"])}
        if self.glu:
            d["w3"] = conv(self._w1(), params["w3"])
        for k in ("act_alpha", "act_beta", "h_alpha", "h_beta"):
            d[k] = params[k]
        return d

    def _act_fn(self, u: torch.Tensor) -> torch.Tensor:
        return F.relu(u) if self.act == "relu" else glu_act(self.act, u)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """QAT forward: x (..., d) -> (..., d) in ``dtype``; an expert
        stack takes (E, C, d) and multiplies each expert's rows by its own
        weights (a batched matmul), scaled by alpha_w (E, 1, P)."""
        alpha = params["act_alpha"].clamp_min(1e-6)
        beta = params["act_beta"]
        s_x = binarize.sign_ste(
            (binarize.promote(x, alpha, beta) - beta) / alpha)

        def mm(wp, a, a_scale):
            y = pm1_matmul(a, binarize.sign_ste(wp["w_latent"]), self.dtype)
            alpha_w = (wp["alpha_w"][:, None, :] if self.num_experts
                       else wp["alpha_w"])
            return y * alpha_w * a_scale

        u = mm(params["w1"], s_x, params["act_alpha"])
        h = self._act_fn(u)
        if self.glu:
            h = h * mm(params["w3"], s_x, params["act_alpha"])
        ha = params["h_alpha"].clamp_min(1e-6)
        h_vals = binarize.clip(binarize.round_ste(
            (h - params["h_beta"]) / ha), 0.0, 1.0)
        return mm(params["w2"], h_vals, params["h_alpha"]).to(self.dtype)

    def apply_deploy(self, params: Params, x: Optional[torch.Tensor] = None,
                     *, bits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deploy forward, fp in and out; a fully binary matmul chain.
        Either fp ``x`` (binarized here) or, for the GLU FFN, pre-packed
        ``bits``; the ReLU FFN binarizes inside its fused F1 and takes
        ``x`` only, as in the JAX package.  An expert stack (GLU only)
        takes (E, C, d) rows or (E, C, Kp) bits."""
        if self.glu:
            return self._deploy_glu(params, x, bits=bits)
        if bits is not None:
            raise ValueError("the ReLU FFN takes fp x, not packed bits")
        if self.blocked_r:
            return self._deploy_relu_blocked(params, x)
        return self._deploy_relu(params, x)

    def _mm_int(self, wp: Params, bits: torch.Tensor, k: int,
                scheme: str = "xnor", dc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """RBMM of (..., Kp) bits against packed weights -> (c, alpha_w);
        an expert stack multiplies (E, C, Kp) bits by its (E, P, Kp)
        words in one batched RBMM, scaled by (E, 1, P)."""
        if self.num_experts:
            c = rbmm.rbmm_int(bits, wp["w_packed"], k, scheme=scheme, dc=dc,
                              impl=self.impl)
            return c, wp["alpha_w"][:, None, :]
        shape = bits.shape[:-1]
        c = rbmm.rbmm_int(bits.reshape(-1, bits.shape[-1]), wp["w_packed"],
                          k, scheme=scheme,
                          dc=None if dc is None else dc.reshape(-1),
                          impl=self.impl)
        return c.reshape(shape + (c.shape[-1],)), wp["alpha_w"]

    def _deploy_relu(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Unblocked F1 -> F2 with the fused ReLU+unsigned threshold."""
        h_bits, dc = self._w1().apply_deploy_fused_unsigned(
            params["w1"], x, params["h_alpha"], params["h_beta"],
            relu=self.act == "relu", impl=self.impl,
            act_alpha=params["act_alpha"], act_beta=params["act_beta"])
        c2, scale2 = self._mm_int(params["w2"], h_bits, self.d_ff,
                                  scheme="and_dc", dc=dc)
        y = c2.to(torch.float32) * scale2 * params["h_alpha"]
        return y.to(self.dtype)

    def _deploy_relu_blocked(self, params: Params,
                             x: torch.Tensor) -> torch.Tensor:
        """Eq. 11: R-chunked F1/F2 with two live l x d buffers."""
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
                    *, bits: Optional[torch.Tensor] = None) -> torch.Tensor:
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
        # the and_dc RBMM derives dc = d_ff - popcount(h_bits) from the
        # words, which is the JAX package's d_ff - sum(hb)
        c2, scale2 = self._mm_int(params["w2"], h_bits, self.d_ff,
                                  scheme="and_dc")
        y = c2.to(torch.float32) * scale2 * params["h_alpha"]
        return y.to(self.dtype)


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

    def _experts(self) -> BinaryFFN:
        return BinaryFFN(self.d_model, self.d_ff, act=self.act, glu=self.glu,
                         dtype=self.dtype, impl=self.impl,
                         num_experts=self.num_experts)

    def _residual_ffn(self) -> BinaryFFN:
        return BinaryFFN(self.d_model, self.d_ff, act=self.act, glu=self.glu,
                         dtype=self.dtype, impl=self.impl)

    def _router(self) -> nn.Dense:
        return nn.Dense(self.d_model, self.num_experts, use_bias=False)

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {"router": self._router().init(gen, device),
                     "experts": self._experts().init(gen, device)}
        if self.dense_residual:
            p["residual"] = self._residual_ffn().init(gen, device)
        return p

    def convert(self, params: Params) -> Params:
        d: Params = {"router": params["router"],
                     "experts": self._experts().convert(params["experts"])}
        if self.dense_residual:
            d["residual"] = self._residual_ffn().convert(params["residual"])
        return d

    def capacity(self, n: int) -> int:
        """Slots per expert for ``n`` routed rows."""
        return int(max(1, math.ceil(
            n * self.top_k * self.capacity_factor / self.num_experts)))

    # -- dispatch ------------------------------------------------------------

    def _probs(self, params: Params, x2: torch.Tensor) -> torch.Tensor:
        """The router's float32 softmax over experts, (N, E)."""
        logits = self._router().apply(params["router"], x2.to(torch.float32))
        return torch.softmax(logits.to(torch.float32), dim=-1)

    def _route(self, params: Params, x2: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor, int]:
        """x2: (N, d) -> (gates (N, k) float32, expert idx (N, k), slot
        (N, k), keep (N, k), capacity).  Among equal probabilities the
        lowest expert index ranks first, as ``lax.top_k`` ranks them (a
        stable descending sort; ``torch.topk`` promises no order)."""
        n, e = x2.shape[0], self.num_experts
        probs = self._probs(params, x2)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :self.top_k], idx[:, :self.top_k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        capacity = self.capacity(n)
        # each (token, k) claim's position among the claims on its expert
        flat = idx.reshape(-1)
        onehot = (flat[:, None] == torch.arange(e, device=x2.device)).to(
            torch.int32)
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
        slot = torch.gather(pos, 1, flat[:, None])[:, 0].reshape(
            n, self.top_k)
        return gates, idx, slot, slot < capacity, capacity

    def _aux_loss(self, params: Params, x2: torch.Tensor) -> torch.Tensor:
        """Switch load-balance loss: E * sum over experts of (the share of
        rows whose first choice it is) * (its mean probability).  The
        router runs again, as in the JAX package, so the gradient is the
        sum over both uses; the argmax takes the first maximum, as
        ``jnp.argmax``."""
        probs = self._probs(params, x2)
        top1 = torch.argmax(probs, dim=-1)
        frac = (top1[:, None] == torch.arange(
            self.num_experts, device=x2.device)).to(torch.float32).mean(0)
        return self.num_experts * torch.sum(frac * probs.mean(0))

    def _dispatch(self, x2: torch.Tensor, idx: torch.Tensor,
                  slot: torch.Tensor, keep: torch.Tensor,
                  capacity: int) -> torch.Tensor:
        """Token rows (fp, or packed words) placed into (E, C, ...) expert
        buffers: each kept claim writes its own (expert, slot) row once,
        dropped claims the one trash row past the E * C real ones, which
        is cut off (the JAX package scatter-adds fp rows and scatter-maxes
        uint32 words onto zeros; the port's int32 words would lose bit 31
        to a max, and a placement gives both packages' values)."""
        k = idx.shape[1]
        trash = self.num_experts * capacity
        dest = torch.where(keep, idx * capacity + slot, trash).reshape(-1)
        rows = x2.repeat_interleave(k, dim=0)
        buf = x2.new_zeros((trash + 1,) + tuple(x2.shape[1:]))
        buf.index_copy_(0, dest, rows)
        return buf[:trash].view((self.num_experts, capacity) +
                                tuple(x2.shape[1:]))

    @staticmethod
    def _combine(out_buf: torch.Tensor, gates: torch.Tensor,
                 idx: torch.Tensor, slot: torch.Tensor,
                 keep: torch.Tensor) -> torch.Tensor:
        """(E, C, d) expert outputs gathered back to (N, d), weighted by
        the gates (a dropped claim's gate is 0), in float32."""
        n, k = idx.shape
        capacity = out_buf.shape[1]
        src = (idx * capacity + slot.clamp(0, capacity - 1)).reshape(-1)
        got = out_buf.reshape(-1, out_buf.shape[-1]).index_select(0, src)
        w = (gates * keep.to(gates.dtype))[:, :, None]
        return (got.reshape(n, k, -1) * w).sum(1)

    # -- faces ---------------------------------------------------------------

    def apply(self, params: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """QAT forward: x (..., d) -> (y (..., d) in ``dtype``,
        {"moe_aux_loss": the load-balance loss}).  Capacity, top-k,
        dispatch and combine are the deploy face's; the experts run their
        QAT face on the (E, C, d) buffer of fp rows."""
        shape = x.shape
        x2 = x.reshape(-1, self.d_model)
        gates, idx, slot, keep, cap = self._route(params, x2)
        out_buf = self._experts().apply(
            params["experts"], self._dispatch(x2, idx, slot, keep, cap))
        y = self._combine(out_buf, gates, idx, slot, keep)
        if self.dense_residual:
            y = y + self._residual_ffn().apply(params["residual"], x2)
        aux = {"moe_aux_loss": self._aux_loss(params, x2)}
        return y.reshape(shape).to(self.dtype), aux

    def apply_deploy(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, self.d_model)
        gates, idx, slot, keep, cap = self._route(params, x2)
        experts = self._experts()
        if self.dispatch_bits:
            bits2 = act_bits_packed(x2, params["experts"]["act_beta"])
            out_buf = experts.apply_deploy(
                params["experts"],
                bits=self._dispatch(bits2, idx, slot, keep, cap))
        else:
            out_buf = experts.apply_deploy(
                params["experts"], self._dispatch(x2, idx, slot, keep, cap))
        y = self._combine(out_buf, gates, idx, slot, keep)
        if self.dense_residual:
            y = y + self._residual_ffn().apply_deploy(params["residual"], x2)
        return y.reshape(shape).to(self.dtype)
