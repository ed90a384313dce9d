"""Decoder-only LM, deploy faces (port of ``repro.models.lm.LMModel``).

  prefill_with_cache  whole-prompt deploy forward that builds the
                      per-layer contiguous binary ring caches, or (with
                      ``caches=``) one chunk continuing sequences already
                      in ring or paged caches
  decode_step         one token per sequence against those caches

Blocks are a plain list of per-layer param dicts (the JAX package stacks
them for ``scan``; ``repro_torch.bridge`` unstacks).  As in the JAX
package, prefill runs the residual stream in ``compute_dtype`` while
decode keeps the float32 embedding (projection outputs are still rounded
to ``compute_dtype``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import PageSpec
from repro_torch.models.blocks import Block, compute_dtype

Params = Dict[str, Any]

VOCAB_PAD = 256  # embeddings pad to a multiple of this; logits are sliced


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


@dataclasses.dataclass(frozen=True)
class LMModel:
    cfg: ModelConfig

    def __post_init__(self):
        if not self.cfg.tie_embeddings or self.cfg.frontend_tokens:
            raise NotImplementedError(
                "the port runs tied-embedding token-only decoders only")
        self._block()   # raises for block kinds not ported yet

    def _block(self) -> Block:
        return Block(self.cfg)

    def _embed(self) -> nn.Embedding:
        return nn.Embedding(padded_vocab(self.cfg.vocab_size),
                            self.cfg.d_model)

    def _norm(self) -> nn.RMSNorm:
        return nn.RMSNorm(self.cfg.d_model)

    # -- params ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Params:
        """QAT params drawn from ``gen``, on ``gen``'s device."""
        dev = gen.device
        return {"embed": self._embed().init(gen, dev),
                "final_norm": self._norm().init(dev),
                "blocks": [self._block().init(gen, dev)
                           for _ in range(self.cfg.num_layers)]}

    def convert(self, params: Params) -> Params:
        out = {k: v for k, v in params.items() if k != "blocks"}
        out["blocks"] = [self._block().convert(bp)
                         for bp in params["blocks"]]
        return out

    # -- embedding / head -----------------------------------------------------

    def _scale(self, x: torch.Tensor) -> torch.Tensor:
        """x * sqrt(d), with sqrt(d) taken in float32 and rounded to x's
        dtype before the product, as the JAX package does."""
        d = torch.tensor(self.cfg.d_model, dtype=torch.float32)
        return x * d.sqrt().to(x.dtype).item()

    def _embed_tokens(self, params: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        x = self._embed().apply(params["embed"], tokens)
        return self._scale(x.to(compute_dtype(self.cfg)))

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self._norm().apply(params["final_norm"], x)
        lg = self._embed().attend(params["embed"], x)
        return lg[..., :self.cfg.vocab_size]

    @staticmethod
    def _last_real(x: torch.Tensor,
                   sl: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, S, d) -> (B, 1, d) hidden at each sequence's last real token
        (the padded end when ``sl`` is None)."""
        if sl is None:
            return x[:, -1:]
        idx = (sl.long() - 1).clamp(0, x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), idx][:, None]

    # -- deploy faces ---------------------------------------------------------

    def prefill_with_cache(self, dparams: Params, tokens: torch.Tensor, *,
                           max_len: int = 0,
                           seq_lens: Optional[torch.Tensor] = None,
                           caches: Optional[List[Dict[str, Any]]] = None,
                           start: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """tokens (B, S) -> (logits (B, 1, V) at the last token, per-layer
        caches with rings of ``max_len``).

        Continuation mode (chunked prefill): with ``caches`` the tokens are
        the next chunk of sequences whose first ``start[b]`` tokens
        (default: the caches' own lengths) are written; ``seq_lens`` is
        each row's real chunk width, logits come at each row's last real
        token, and ``max_len`` is ignored.  The caches update in place.
        Ragged whole-prompt prefill (``seq_lens`` without ``caches``) is
        not ported yet."""
        if caches is not None:
            return self._prefill_continue(dparams, tokens, caches,
                                          start=start, seq_lens=seq_lens)
        if seq_lens is not None:
            raise NotImplementedError(
                "ragged whole-prompt prefill (seq_lens without caches=) is "
                "not ported yet")
        if max_len <= 0:
            raise ValueError("prefill_with_cache needs max_len > 0 (or "
                             "caches= for chunk continuation)")
        x = self._embed_tokens(dparams, tokens)
        caches_out: List[Dict[str, Any]] = []
        for bp in dparams["blocks"]:
            x, cache = self._block().deploy_prefill(bp, x,
                                                    cache_size=max_len)
            caches_out.append(cache)
        return self._logits(dparams, self._last_real(x, None)), caches_out

    def _prefill_continue(self, dparams: Params, tokens: torch.Tensor,
                          caches: List[Dict[str, Any]], *,
                          start: Optional[torch.Tensor],
                          seq_lens: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """One chunk of a cache-resuming prefill (see prefill_with_cache)."""
        x = self._embed_tokens(dparams, tokens)
        new_caches: List[Dict[str, Any]] = []
        for bp, cache in zip(dparams["blocks"], caches):
            x, c = self._block().deploy_prefill_chunk(
                bp, x, cache, start=start, valid_len=seq_lens)
            new_caches.append(c)
        return self._logits(dparams, self._last_real(x, seq_lens)), new_caches

    def init_caches(self, batch: int, max_len: int, device,
                    paged: Optional[PageSpec] = None
                    ) -> List[Dict[str, Any]]:
        """Empty per-layer decode caches for a pool of ``batch`` slots;
        ``paged`` switches them to the page-arena layout (``max_len`` is
        then superseded by ``paged.capacity``)."""
        return [self._block().init_cache(batch, max_len, device,
                                         paged=paged)
                for _ in range(self.cfg.num_layers)]

    def reset_recurrent_rows(self, caches: List[Dict[str, Any]],
                             fresh: torch.Tensor) -> List[Dict[str, Any]]:
        """Reset the recurrent carries of the pool rows marked ``fresh``.
        Attention rings need no per-row reset (a chunk starting at 0 masks
        every stale slot), so for the attention-only stacks the port runs
        this is the identity; recurrent blocks are not ported yet."""
        return caches

    def decode_step(self, dparams: Params, token: torch.Tensor,
                    caches: List[Dict[str, Any]]
                    ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """token: (B, 1).  Returns (logits (B, 1, V), caches); the ring
        tensors are updated in place."""
        x = self._scale(self._embed().apply(dparams["embed"], token))
        new_caches = []
        for bp, cache in zip(dparams["blocks"], caches):
            x, c = self._block().deploy_decode(bp, x, cache)
            new_caches.append(c)
        return self._logits(dparams, x), new_caches


def build_model(cfg: ModelConfig) -> LMModel:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port builds "
            f"dense decoders")
    return LMModel(cfg)
