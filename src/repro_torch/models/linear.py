"""BinaryDense: the COBRA linear layer (port of ``repro.models.linear``).

Deploy face — packed int32 weights (1 bit per value), Eq. 7 RBMM:
    bits_a = (x >= beta_a)                 (the pack kernel)
    c      = RBMM(bits_a, w_packed)        (rbmm_int or rbmm_mxu kernel)
    y      = alpha_a * alpha_w * c + bias
``convert()`` maps QAT params to deploy params (pack + keep scales).  The
quantization-fused faces (``apply_deploy_fused*``) serve only the ReLU FFN
and are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core import binarize, packing, rbmm
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.models import nn

Params = Dict[str, Any]


def act_bits_packed(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Signed-scheme activation bits, packed: bit = x >= beta (float32
    compare, as the JAX package promotes a compute-dtype x against its
    float32 beta)."""
    return pack_ops.pack_threshold(x, beta.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class BinaryDense:
    in_dim: int
    out_dim: int
    use_bias: bool = False
    # reuses caller-provided activation bits and carries no act scales
    external_act: bool = False
    dtype: torch.dtype = torch.float32

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

    def convert(self, params: Params) -> Params:
        """QAT params -> deploy params: (out, ceil(in/32)) packed columns."""
        d: Params = {"w_packed": packing.pack_signs(params["w_latent"].T),
                     "alpha_w": params["alpha_w"]}
        for k in ("act_alpha", "act_beta", "bias"):
            if k in params:
                d[k] = params[k]
        return d

    def apply_deploy(self, params: Params, x: Optional[torch.Tensor] = None,
                     *, bits: Optional[torch.Tensor] = None,
                     act_alpha: Optional[torch.Tensor] = None,
                     scheme: str = "xnor", dc: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> torch.Tensor:
        """Deploy forward -> compute-dtype output.  Either fp ``x`` (this
        layer binarizes and packs it) or packed ``bits`` from upstream with
        ``act_alpha`` (and, for the unsigned scheme, ``dc``)."""
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
        c = rbmm.rbmm_int(a2, params["w_packed"], self.in_dim,
                          scheme=scheme, dc=dc2, impl=impl)
        c = c.reshape(shape + (self.out_dim,))
        y = (c.to(torch.float32) * params["alpha_w"] *
             act_alpha.to(torch.float32))
        if self.use_bias:
            y = y + params["bias"]
        return y.to(self.dtype)
