"""Transformer blocks (port of ``repro.models.blocks.Block``): the QAT face
``qat`` and the deploy faces of every kind:
``kind`` "attn" (norm, SPS attention, norm, binary FFN), "hybrid" (the
attention and a Mamba branch in parallel on the same normed input, their
outputs averaged, then the FFN), the xLSTM cells "mlstm" / "slstm" (norm
and the cell, no FFN) and the encoder-decoder's decoder layer "dec"
(norm, causal self-attention, norm, cross-attention over the encoder's
output, norm, FFN).  ``causal`` (None: ``cfg.causal``) makes an
attention block bidirectional, as an encoder's are; RoPE stays on there,
and only cross-attention takes none.
The residual stream stays fp (BiT convention).  The norm is ``cfg.norm``
(RMSNorm or LayerNorm) and the FFN the SiLU or GELU GLU or the ReLU FFN
(Eq. 11 blocked when ``cfg.binary.ffn_block_r`` is set), or, with
``cfg.moe.num_experts``, a ``BinaryMoE`` of such experts, which every
deploy face applies to the whole (pooled) input, as the JAX package's
do.  A block's ``window`` (0: full attention) masks its attention and
sizes its decode ring, as in the JAX package: gemma's local:global stacks
build blocks that differ in it only.

Caches are per-layer dicts: "attn" a ``KVCache`` ring or ``PagedKVCache``,
"mamba" a ``MambaCache``, "cell" an ``XLSTMCache``, "cross" the static
binary memory of a "dec" layer (a ``KVCache`` that decode reads and never
writes).  The chunk and decode
faces update every part IN PLACE (the recurrent carries by ``copy_``) and
return the cache they were given, so a captured graph of a step and the
engine hold the same tensors."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import PageSpec, SPSAttention
from repro_torch.models.ffn import PORTED, BinaryFFN, BinaryMoE
from repro_torch.models.ssm import MambaBlock, MLSTMBlock, SLSTMBlock

Params = Dict[str, Any]

KINDS = ("attn", "hybrid", "mlstm", "slstm", "dec")
RECURRENT = ("mamba", "cell")   # the cache parts that hold carries


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _ffn_from_cfg(cfg: ModelConfig):
    if cfg.moe.num_experts:
        return BinaryMoE(
            d_model=cfg.d_model, d_ff=cfg.d_ff,
            num_experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor,
            dense_residual=cfg.moe.dense_residual,
            act=cfg.act, glu=cfg.glu, dtype=compute_dtype(cfg),
            impl=cfg.binary.impl,
            dispatch_bits=cfg.binary.moe_dispatch_bits)
    return BinaryFFN(cfg.d_model, cfg.d_ff, act=cfg.act, glu=cfg.glu,
                     blocked_r=cfg.binary.ffn_block_r,
                     dtype=compute_dtype(cfg), impl=cfg.binary.impl)


def _store(dst, src) -> None:
    """Copy a new carry into the cache's carry tensors, in place."""
    for d, s in zip(dst, src):
        d.copy_(s)


@dataclasses.dataclass(frozen=True)
class Block:
    """One layer of ``kind`` (see the module docstring)."""
    cfg: ModelConfig
    kind: str = "attn"
    window: int = 0
    causal: Optional[bool] = None

    def __post_init__(self):
        cfg = self.cfg
        if self.kind not in KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind "
                             f"{self.kind!r}; kinds are {KINDS}")
        if self.kind not in ("attn", "dec") and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a {self.kind!r} block needs "
                             f"cfg.ssm")
        if cfg.norm not in ("rmsnorm", "layernorm") or (
                self._has_ffn and (not cfg.d_ff or
                                   (cfg.act, cfg.glu) not in PORTED)):
            raise NotImplementedError(
                f"{cfg.name}: the port runs blocks with RMSNorm or "
                f"LayerNorm, and attention blocks with a SiLU or GELU GLU "
                f"or a ReLU FFN (or a mixture of them); the rest is not "
                f"ported yet")

    @property
    def _has_ffn(self) -> bool:
        return self.kind in ("attn", "hybrid", "dec")

    def _attn(self, cross: bool = False) -> SPSAttention:
        cfg = self.cfg
        return SPSAttention(
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            causal=cfg.causal if self.causal is None else self.causal,
            use_rope=cfg.rope_theta > 0 and not cross,
            rope_theta=cfg.rope_theta or 10_000.0, qkv_bias=cfg.attn_bias,
            sps_granularity=cfg.binary.sps_granularity,
            dtype=compute_dtype(cfg), impl=cfg.binary.impl,
            score_impl=cfg.binary.score_impl, cross=cross,
            attn_mode=cfg.binary.attn_mode)

    def _ffn(self):
        return _ffn_from_cfg(self.cfg)

    def _norm(self):
        return nn.make_norm(self.cfg.norm, self.cfg.d_model)

    def _parts(self) -> Dict[str, Any]:
        """The block's submodules by param key, as the JAX ``_parts``."""
        cfg, dt = self.cfg, compute_dtype(self.cfg)
        parts: Dict[str, Any] = {}
        if self.kind in ("attn", "hybrid", "dec"):
            parts["attn"] = self._attn()
        if self.kind == "dec":
            parts["cross"] = self._attn(cross=True)
        if self.kind == "hybrid":
            parts["mamba"] = MambaBlock(
                cfg.d_model, state_size=cfg.ssm.state_size,
                conv_width=cfg.ssm.conv_width, expand=cfg.ssm.expand,
                dtype=dt)
        if self.kind == "mlstm":
            parts["cell"] = MLSTMBlock(cfg.d_model, cfg.num_heads,
                                       expand=cfg.ssm.expand, dtype=dt)
        if self.kind == "slstm":
            parts["cell"] = SLSTMBlock(cfg.d_model, expand=cfg.ssm.expand,
                                       dtype=dt)
        if self._has_ffn:
            parts["ffn"] = self._ffn()
        return parts

    def init(self, gen: torch.Generator, device) -> Params:
        p = {name: mod.init(gen, device)
             for name, mod in self._parts().items()}
        p["norm1"] = self._norm().init(device)
        if self._has_ffn:
            p["norm2"] = self._norm().init(device)
        if self.kind == "dec":
            p["norm_x"] = self._norm().init(device)
        return p

    def convert(self, params: Params) -> Params:
        out = {name: mod.convert(params[name])
               for name, mod in self._parts().items()}
        for name in ("norm1", "norm2", "norm_x"):
            if name in params:
                out[name] = params[name]
        return out

    def qat(self, params: Params, x: torch.Tensor, *, positions=None,
            window=None, memory=None, collect_scores: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """QAT forward of any kind: "attn" x + attn(norm1(x)); "hybrid"
        the attention and the Mamba branch on the same norm1(x), averaged;
        "dec" then + cross-attention of norm_x(x) over ``memory``; each
        then + the FFN of norm2 of that (a MoE's load-balance loss lands
        in aux as "moe_aux_loss"); the xLSTM cells x + cell(norm1(x)),
        no FFN.  The block's own ``window`` unless one is given.  Returns
        (x, aux) with the attention's aux keys prefixed "attn_"."""
        if self.kind == "dec" and memory is None:
            raise ValueError("a 'dec' block's QAT face needs memory")
        if window is None and self.window:
            window = self.window
        parts = self._parts()
        aux: Dict[str, torch.Tensor] = {}
        h = self._norm().apply(params["norm1"], x)
        if "cell" in parts:
            return x + parts["cell"].apply(params["cell"], h), aux
        a_out, a_aux = parts["attn"].qat(
            params["attn"], h, positions=positions, window=window,
            collect_scores=collect_scores)
        aux.update({f"attn_{k}": v for k, v in a_aux.items()})
        if self.kind == "hybrid":
            a_out = 0.5 * (a_out + parts["mamba"].apply(params["mamba"], h))
        x = x + a_out
        if self.kind == "dec":
            c_out, _ = parts["cross"].qat(
                params["cross"], self._norm().apply(params["norm_x"], x),
                memory=memory)
            x = x + c_out
        h2 = self._norm().apply(params["norm2"], x)
        if isinstance(parts["ffn"], BinaryMoE):
            f_out, f_aux = parts["ffn"].apply(params["ffn"], h2)
            aux.update(f_aux)
        else:
            f_out = parts["ffn"].apply(params["ffn"], h2)
        return x + f_out, aux

    def _ffn_residual(self, params: Params,
                      x: torch.Tensor) -> torch.Tensor:
        if not self._has_ffn:
            return x
        return x + self._ffn().apply_deploy(
            params["ffn"], self._norm().apply(params["norm2"], x))

    def _cross_residual(self, params: Params, x: torch.Tensor,
                        mem) -> torch.Tensor:
        """A "dec" layer's cross-attention over its memory cache."""
        return x + self._parts()["cross"].attend_memory(
            params["cross"], self._norm().apply(params["norm_x"], x), mem)

    def deploy_prefill(self, params: Params, x: torch.Tensor, *,
                       positions=None, cache_size: int = 0,
                       seq_lens=None,
                       memory: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Whole-sequence forward; ``seq_lens`` (B,) takes a ragged,
        right-padded batch (see ``SPSAttention.deploy_prefill``; the
        recurrent carries freeze past each length).  With ``cache_size``
        the decode cache: the attention ring and the carries at each
        sequence's end.  A "dec" layer attends over ``memory`` (B, S_enc,
        d), the encoder's output, projected here into the binary memory
        that its cache keeps as "cross"; it takes no ``seq_lens``."""
        if seq_lens is not None and self.kind == "dec":
            raise ValueError("ragged prefill (seq_lens) does not support "
                             "enc-dec decoder blocks")
        parts = self._parts()
        h = self._norm().apply(params["norm1"], x)
        cache: Dict[str, Any] = {}
        if self.kind in ("attn", "hybrid", "dec"):
            a_out, kv = parts["attn"].deploy_prefill(
                params["attn"], h, positions=positions, window=self.window,
                cache_size=cache_size, seq_lens=seq_lens)
            if kv is not None:
                cache["attn"] = kv
            if self.kind == "hybrid":
                m = parts["mamba"].apply(
                    params["mamba"], h, deploy=True,
                    return_state=bool(cache_size), seq_lens=seq_lens)
                if cache_size:
                    m, cache["mamba"] = m
                a_out = 0.5 * (a_out + m)
            x = x + a_out
            if self.kind == "dec":
                mem = parts["cross"].build_memory_cache(params["cross"],
                                                        memory)
                x = self._cross_residual(params, x, mem)
                if cache_size:
                    cache["cross"] = mem
        else:
            out = parts["cell"].apply(
                params["cell"], h, deploy=True,
                return_state=bool(cache_size), seq_lens=seq_lens)
            if cache_size:
                out, cache["cell"] = out
            x = x + out
        return self._ffn_residual(params, x), cache

    def deploy_prefill_chunk(self, params: Params, x: torch.Tensor,
                             cache: Dict[str, Any], *, start=None,
                             valid_len=None
                             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Cache-resuming chunk prefill: x (B, C, d) continues sequences
        whose first ``start`` tokens already live in ``cache`` (see
        ``SPSAttention.deploy_prefill_chunk``); the recurrent carries
        resume from the cache (``state=``) and the new ones are copied
        back in place.  Rows with ``valid_len == 0`` write no attention
        bits and keep every carry bit for bit.  Enc-dec decoder layers
        have no chunk face."""
        if self.kind == "dec":
            raise ValueError(
                "chunked prefill does not support enc-dec decoder blocks "
                f"(kind={self.kind!r})")
        parts = self._parts()
        h = self._norm().apply(params["norm1"], x)
        if self.kind in ("attn", "hybrid"):
            a_out, _ = parts["attn"].deploy_prefill_chunk(
                params["attn"], h, cache["attn"], window=self.window,
                start=start, valid_len=valid_len)
            if self.kind == "hybrid":
                m_out, mc = parts["mamba"].apply(
                    params["mamba"], h, deploy=True, return_state=True,
                    seq_lens=valid_len, state=cache["mamba"])
                _store(cache["mamba"], mc)
                a_out = 0.5 * (a_out + m_out)
            x = x + a_out
        else:
            out, cc = parts["cell"].apply(
                params["cell"], h, deploy=True, return_state=True,
                seq_lens=valid_len, state=cache["cell"])
            _store(cache["cell"], cc)
            x = x + out
        return self._ffn_residual(params, x), cache

    def _attention_only(self, face: str) -> None:
        if self.kind != "attn":
            raise ValueError(
                f"{face} resumes attention caches only, not kind="
                f"{self.kind!r} (recurrent families decode "
                f"non-speculatively)")

    def deploy_verify_chunk(self, params: Params, x: torch.Tensor,
                            cache: Dict[str, Any], *, start=None,
                            valid=None) -> Tuple[torch.Tensor, Any]:
        """Speculative verify: the block over a candidate chunk WITHOUT
        writing the cache; returns (out, the attention's projections) for
        ``commit_chunk`` (see ``SPSAttention.deploy_verify_chunk``).
        Attention blocks only."""
        self._attention_only("speculative verify")
        h = self._norm().apply(params["norm1"], x)
        a_out, proj = self._attn().deploy_verify_chunk(
            params["attn"], h, cache["attn"], window=self.window,
            start=start, valid=valid)
        return self._ffn_residual(params, x + a_out), proj

    def commit_chunk(self, cache: Dict[str, Any], proj, start,
                     n_commit) -> Dict[str, Any]:
        """Write the accepted prefix of a verified chunk into this block's
        attention cache, in place (rows with n_commit == 0 untouched)."""
        self._attention_only("the speculative commit")
        self._attn().commit_chunk(cache["attn"], proj, start, n_commit)
        return cache

    def init_cache(self, batch: int, max_len: int, device,
                   paged: Optional[PageSpec] = None,
                   memory_len: int = 0) -> Dict[str, Any]:
        """Empty decode cache: the attention part a contiguous ring of
        min(window or max_len, max_len), or with ``paged`` a page arena
        of ``paged.arena_pages`` pages and block tables covering the
        layer's logical ring, ``paged.ring_for(window)`` (windowed groups
        are fully provisioned: they are bounded by the window); the
        recurrent carries at their init values, dense either way; a "dec"
        layer's memory of ``memory_len`` (at least 1) positions."""
        parts = self._parts()
        cache: Dict[str, Any] = {}
        if "attn" in parts:
            attn = parts["attn"]
            if paged is None:
                cache["attn"] = attn.init_cache(
                    batch, min(self.window or max_len, max_len), device)
            else:
                ring = paged.ring_for(self.window)
                cache["attn"] = attn.init_paged_cache(
                    batch, ring_len=ring, page_size=paged.page_size,
                    num_blocks=paged.blocks_for_ring(ring),
                    num_pages=paged.arena_pages(ring, batch), device=device)
        if "cross" in parts:
            cache["cross"] = parts["cross"].init_cache(
                batch, memory_len or 1, device)
        for name in RECURRENT:
            if name in parts:
                cache[name] = parts[name].init_cache(batch, device)
        return cache

    def reset_rows(self, cache: Dict[str, Any],
                   fresh: torch.Tensor) -> None:
        """Put the recurrent carries of the rows where ``fresh`` (B,) is
        True back to their ``init_cache`` values, in place and without a
        host sync; other rows and the attention part stay as they are."""
        parts = self._parts()
        for name in RECURRENT:
            if name in cache:
                for t, v in zip(cache[name], parts[name].init_values()):
                    t.masked_fill_(fresh.reshape((-1,) + (1,) *
                                                 (t.dim() - 1)), v)

    def deploy_decode(self, params: Params, x: torch.Tensor,
                      cache: Dict[str, Any]
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One token per sequence: the attention cache and the carries
        advance in place; a "dec" layer reads its memory ("cross") and
        never writes it."""
        parts = self._parts()
        h = self._norm().apply(params["norm1"], x)
        if self.kind in ("attn", "hybrid", "dec"):
            a_out, _ = parts["attn"].deploy_decode(params["attn"], h,
                                                   cache["attn"])
            if self.kind == "hybrid":
                m_out, mc = parts["mamba"].decode_step(
                    params["mamba"], h, cache["mamba"])
                _store(cache["mamba"], mc)
                a_out = 0.5 * (a_out + m_out)
            x = x + a_out
            if self.kind == "dec":
                x = self._cross_residual(params, x, cache["cross"])
        else:
            out, cc = parts["cell"].decode_step(params["cell"], h,
                                                cache["cell"])
            _store(cache["cell"], cc)
            x = x + out
        return self._ffn_residual(params, x), cache
