"""Attention block, deploy faces (port of ``repro.models.blocks.Block`` for
``kind="attn"``; the other kinds are not ported yet).  The residual
stream stays fp (BiT convention)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import SPSAttention
from repro_torch.models.ffn import BinaryFFN

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


@dataclasses.dataclass(frozen=True)
class Block:
    """One decoder layer: RMSNorm, SPS attention, RMSNorm, SiLU-GLU FFN."""
    cfg: ModelConfig

    def __post_init__(self):
        cfg = self.cfg
        if (cfg.window_size or cfg.local_global_ratio or cfg.moe.num_experts
                or cfg.ssm is not None or cfg.norm != "rmsnorm"
                or not cfg.d_ff or not cfg.glu or cfg.act != "silu"):
            raise NotImplementedError(
                f"{cfg.name}: the port runs full-attention blocks with "
                f"RMSNorm and a SiLU-GLU FFN only; the rest is not ported "
                f"yet")

    def _attn(self) -> SPSAttention:
        cfg = self.cfg
        return SPSAttention(
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            causal=cfg.causal, use_rope=cfg.rope_theta > 0,
            rope_theta=cfg.rope_theta or 10_000.0, qkv_bias=cfg.attn_bias,
            sps_granularity=cfg.binary.sps_granularity,
            dtype=compute_dtype(cfg), impl=cfg.binary.impl,
            score_impl=cfg.binary.score_impl)

    def _ffn(self) -> BinaryFFN:
        cfg = self.cfg
        return BinaryFFN(cfg.d_model, cfg.d_ff, dtype=compute_dtype(cfg),
                         impl=cfg.binary.impl)

    def _norm(self) -> nn.RMSNorm:
        return nn.RMSNorm(self.cfg.d_model)

    def init(self, gen: torch.Generator, device) -> Params:
        return {"attn": self._attn().init(gen, device),
                "ffn": self._ffn().init(gen, device),
                "norm1": self._norm().init(device),
                "norm2": self._norm().init(device)}

    def convert(self, params: Params) -> Params:
        return {"attn": self._attn().convert(params["attn"]),
                "ffn": self._ffn().convert(params["ffn"]),
                "norm1": params["norm1"], "norm2": params["norm2"]}

    def deploy_prefill(self, params: Params, x: torch.Tensor, *,
                       positions=None, cache_size: int = 0
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        norm = self._norm()
        h = norm.apply(params["norm1"], x)
        a_out, kv = self._attn().deploy_prefill(
            params["attn"], h, positions=positions, cache_size=cache_size)
        x = x + a_out
        x = x + self._ffn().apply_deploy(params["ffn"],
                                         norm.apply(params["norm2"], x))
        return x, ({"attn": kv} if kv is not None else {})

    def init_cache(self, batch: int, max_len: int,
                   device) -> Dict[str, Any]:
        return {"attn": self._attn().init_cache(batch, max_len, device)}

    def deploy_decode(self, params: Params, x: torch.Tensor,
                      cache: Dict[str, Any]
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        norm = self._norm()
        h = norm.apply(params["norm1"], x)
        a_out, kv = self._attn().deploy_decode(params["attn"], h,
                                               cache["attn"])
        x = x + a_out
        x = x + self._ffn().apply_deploy(params["ffn"],
                                         norm.apply(params["norm2"], x))
        return x, dict(cache, attn=kv)
