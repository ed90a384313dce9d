"""Attention block, deploy faces (port of ``repro.models.blocks.Block`` for
``kind="attn"``; the other kinds are not ported yet).  The residual
stream stays fp (BiT convention).  The norm is ``cfg.norm`` (RMSNorm or
LayerNorm) and the FFN the SiLU or GELU GLU or the ReLU FFN (Eq. 11
blocked when ``cfg.binary.ffn_block_r`` is set).  A block's ``window`` (0:
full attention) masks its attention and sizes its decode ring, as in the
JAX package: gemma's local:global stacks build blocks that differ in it
only."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import PageSpec, SPSAttention
from repro_torch.models.ffn import PORTED, BinaryFFN

Params = Dict[str, Any]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


@dataclasses.dataclass(frozen=True)
class Block:
    """One layer: norm, SPS attention, norm, binary FFN."""
    cfg: ModelConfig
    window: int = 0

    def __post_init__(self):
        cfg = self.cfg
        if (cfg.moe.num_experts or cfg.ssm is not None
                or cfg.norm not in ("rmsnorm", "layernorm")
                or not cfg.d_ff or (cfg.act, cfg.glu) not in PORTED):
            raise NotImplementedError(
                f"{cfg.name}: the port runs attention blocks with RMSNorm "
                f"or LayerNorm and a SiLU or GELU GLU or a ReLU FFN only; "
                f"the rest is not ported yet")

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
        return BinaryFFN(cfg.d_model, cfg.d_ff, act=cfg.act, glu=cfg.glu,
                         blocked_r=cfg.binary.ffn_block_r,
                         dtype=compute_dtype(cfg), impl=cfg.binary.impl)

    def _norm(self):
        return nn.make_norm(self.cfg.norm, self.cfg.d_model)

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
                       positions=None, cache_size: int = 0,
                       seq_lens=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Whole-sequence forward; ``seq_lens`` (B,) takes a ragged,
        right-padded batch (see ``SPSAttention.deploy_prefill``)."""
        norm = self._norm()
        h = norm.apply(params["norm1"], x)
        a_out, kv = self._attn().deploy_prefill(
            params["attn"], h, positions=positions, window=self.window,
            cache_size=cache_size, seq_lens=seq_lens)
        x = x + a_out
        x = x + self._ffn().apply_deploy(params["ffn"],
                                         norm.apply(params["norm2"], x))
        return x, ({"attn": kv} if kv is not None else {})

    def deploy_prefill_chunk(self, params: Params, x: torch.Tensor,
                             cache: Dict[str, Any], *, start=None,
                             valid_len=None
                             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Cache-resuming chunk prefill: x (B, C, d) continues sequences
        whose first ``start`` tokens already live in ``cache`` (see
        ``SPSAttention.deploy_prefill_chunk``); rows with ``valid_len == 0``
        write nothing."""
        norm = self._norm()
        h = norm.apply(params["norm1"], x)
        a_out, kv = self._attn().deploy_prefill_chunk(
            params["attn"], h, cache["attn"], window=self.window,
            start=start, valid_len=valid_len)
        x = x + a_out
        x = x + self._ffn().apply_deploy(params["ffn"],
                                         norm.apply(params["norm2"], x))
        return x, dict(cache, attn=kv)

    def deploy_verify_chunk(self, params: Params, x: torch.Tensor,
                            cache: Dict[str, Any], *, start=None,
                            valid=None) -> Tuple[torch.Tensor, Any]:
        """Speculative verify: the block over a candidate chunk WITHOUT
        writing the cache; returns (out, the attention's projections) for
        ``commit_chunk`` (see ``SPSAttention.deploy_verify_chunk``)."""
        norm = self._norm()
        h = norm.apply(params["norm1"], x)
        a_out, proj = self._attn().deploy_verify_chunk(
            params["attn"], h, cache["attn"], window=self.window,
            start=start, valid=valid)
        x = x + a_out
        x = x + self._ffn().apply_deploy(params["ffn"],
                                         norm.apply(params["norm2"], x))
        return x, proj

    def commit_chunk(self, cache: Dict[str, Any], proj, start,
                     n_commit) -> Dict[str, Any]:
        """Write the accepted prefix of a verified chunk into this block's
        attention cache, in place (rows with n_commit == 0 untouched)."""
        self._attn().commit_chunk(cache["attn"], proj, start, n_commit)
        return cache

    def init_cache(self, batch: int, max_len: int, device,
                   paged: Optional[PageSpec] = None) -> Dict[str, Any]:
        """Empty decode cache: a contiguous ring of min(window or
        max_len, max_len), or with ``paged`` a page arena of
        ``paged.arena_pages`` pages and block tables covering the layer's
        logical ring, ``paged.ring_for(window)`` (windowed groups are
        fully provisioned: they are bounded by the window)."""
        attn = self._attn()
        if paged is None:
            return {"attn": attn.init_cache(
                batch, min(self.window or max_len, max_len), device)}
        ring = paged.ring_for(self.window)
        return {"attn": attn.init_paged_cache(
            batch, ring_len=ring, page_size=paged.page_size,
            num_blocks=paged.blocks_for_ring(ring),
            num_pages=paged.arena_pages(ring, batch), device=device)}

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
