"""Binary GLU FFN, deploy face (port of ``repro.models.ffn.BinaryFFN``).

Gate and up projections are binary RBMMs sharing one input binarization;
``silu(u) * g`` stays fp, is unsigned-binarized and packed (pack kernel),
and meets the binary down projection through the and_dc scheme (F2).  The
ReLU variants, Eq. 11 blocking and ``BinaryMoE`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import rbmm
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.models.linear import BinaryDense, act_bits_packed

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class BinaryFFN:
    d_model: int
    d_ff: int
    dtype: torch.dtype = torch.float32
    impl: str = "auto"

    def _w1(self) -> BinaryDense:
        return BinaryDense(self.d_model, self.d_ff, external_act=True,
                           dtype=self.dtype)

    def _w2(self) -> BinaryDense:
        return BinaryDense(self.d_ff, self.d_model, external_act=True,
                           dtype=self.dtype)

    def init(self, gen: torch.Generator, device) -> Params:
        p: Params = {"w1": self._w1().init(gen, device),
                     "w2": self._w2().init(gen, device),
                     "w3": self._w1().init(gen, device)}
        for k, v in (("act_alpha", 1.0), ("act_beta", 0.0),
                     ("h_alpha", 1.0), ("h_beta", 0.0)):
            p[k] = torch.full((), v, device=device)
        return p

    def convert(self, params: Params) -> Params:
        d: Params = {"w1": self._w1().convert(params["w1"]),
                     "w2": self._w2().convert(params["w2"]),
                     "w3": self._w1().convert(params["w3"])}
        for k in ("act_alpha", "act_beta", "h_alpha", "h_beta"):
            d[k] = params[k]
        return d

    def apply_deploy(self, params: Params,
                     x: torch.Tensor) -> torch.Tensor:
        return self._deploy_glu(params, x)

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

    def _deploy_glu(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        bits = act_bits_packed(x, params["act_beta"])
        c_u, scale1 = self._mm_int(params["w1"], bits, self.d_model)
        c_g, scale3 = self._mm_int(params["w3"], bits, self.d_model)
        aa = params["act_alpha"]
        u = c_u.to(torch.float32) * scale1 * aa
        g = c_g.to(torch.float32) * scale3 * aa
        h = F.silu(u) * g                              # fp elementwise
        h_bits = pack_ops.pack_threshold(
            h, params["h_beta"] + 0.5 * params["h_alpha"])
        # the and_dc RBMM derives dc = d_ff - popcount(h_bits) from the
        # words, which is the JAX package's d_ff - sum(hb)
        c2, scale2 = self._mm_int(params["w2"], h_bits, self.d_ff,
                                  scheme="and_dc")
        y = c2.to(torch.float32) * scale2 * params["h_alpha"]
        return y.to(self.dtype)
