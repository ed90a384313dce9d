"""Binary FFN, deploy face (port of ``repro.models.ffn.BinaryFFN``).

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
projection through the and_dc scheme (F2).  ``BinaryMoE`` is not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing, rbmm
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.models.linear import BinaryDense, act_bits_packed

Params = Dict[str, Any]

# (act, glu) pairs the port runs
PORTED = (("silu", True), ("gelu", True), ("relu", False))


def glu_act(act: str, u: torch.Tensor) -> torch.Tensor:
    """The GLU's activation of the float32 ``u``: SiLU, or GELU in its
    tanh form (``jax.nn.gelu``'s default, ``approximate=True``)."""
    if act == "gelu":
        return F.gelu(u, approximate="tanh")
    return F.silu(u)


@dataclasses.dataclass(frozen=True)
class BinaryFFN:
    d_model: int
    d_ff: int
    act: str = "silu"               # silu | gelu (GLU) | relu (paper)
    glu: bool = True
    blocked_r: int = 0              # Eq. 11 R (relu path only); 0 = unblocked
    dtype: torch.dtype = torch.float32
    impl: str = "auto"

    def __post_init__(self):
        if (self.act, self.glu) not in PORTED:
            raise NotImplementedError(
                f"BinaryFFN act={self.act!r} glu={self.glu} is not ported "
                f"yet; the port runs the SiLU and GELU GLUs and the ReLU "
                f"FFN")

    def _w1(self) -> BinaryDense:
        return BinaryDense(self.d_model, self.d_ff, external_act=True,
                           dtype=self.dtype)

    def _w2(self) -> BinaryDense:
        return BinaryDense(self.d_ff, self.d_model, external_act=True,
                           dtype=self.dtype)

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {"w1": self._w1().init(gen, device),
                     "w2": self._w2().init(gen, device)}
        if self.glu:
            p["w3"] = self._w1().init(gen, device)
        for k, v in (("act_alpha", 1.0), ("act_beta", 0.0),
                     ("h_alpha", 1.0), ("h_beta", 0.0)):
            p[k] = torch.full((), v, device=device)
        return p

    def convert(self, params: Params) -> Params:
        d: Params = {"w1": self._w1().convert(params["w1"]),
                     "w2": self._w2().convert(params["w2"])}
        if self.glu:
            d["w3"] = self._w1().convert(params["w3"])
        for k in ("act_alpha", "act_beta", "h_alpha", "h_beta"):
            d[k] = params[k]
        return d

    def apply_deploy(self, params: Params, x: Optional[torch.Tensor] = None,
                     *, bits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deploy forward, fp in and out; a fully binary matmul chain.
        Either fp ``x`` (binarized here) or, for the GLU FFN, pre-packed
        ``bits``; the ReLU FFN binarizes inside its fused F1 and takes
        ``x`` only, as in the JAX package."""
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
        """RBMM of (..., Kp) bits against packed weights -> (c, alpha_w)."""
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
