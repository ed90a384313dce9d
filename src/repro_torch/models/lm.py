"""LM wrapper, deploy faces (port of ``repro.models.lm.LMModel``).

  prefill_logits      deploy full-sequence forward, no cache: the encoder
                      face of bert-base-cobra (bidirectional attention,
                      untied head), and any decoder's whole-prompt logits
  prefill_with_cache  whole-prompt deploy forward that builds the
                      per-layer contiguous binary ring caches, or (with
                      ``caches=``) one chunk continuing sequences already
                      in ring or paged caches
  decode_step         one token per sequence against those caches
  verify_with_cache   speculative decode: logits at every position of a
                      candidate chunk, the caches unwritten; then
                      ``commit_chunks`` writes each sequence's accepted
                      prefix; ``truncate_deploy`` builds the layer-truncated
                      draft on the trunk's own weights

Blocks are a plain list of per-layer param dicts (the JAX package stacks
them for ``scan``; ``repro_torch.bridge`` unstacks).  The layer plan is the
JAX package's: every layer has ``cfg.window_size``, except in a
local:global stack (``cfg.local_global_ratio`` r), where layer i is global
(full attention) when i % (r + 1) == r.  Each layer's window masks its
attention and sizes its ring.  As in the JAX
package, prefill runs the residual stream in ``compute_dtype`` while
decode keeps the float32 embedding (projection outputs are still rounded
to ``compute_dtype``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import nn
from repro_torch.models.attention import PageSpec
from repro_torch.models.blocks import Block, compute_dtype

Params = Dict[str, Any]

VOCAB_PAD = 256  # embeddings pad to a multiple of this; logits are sliced


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


@functools.lru_cache(maxsize=None)
def _sqrt_rounded(d: int, dtype: torch.dtype) -> float:
    """sqrt(d) taken in float32 and rounded to ``dtype``, as the JAX
    package scales the embedding; computed once per width and dtype, so
    the forward reads no tensor on the host."""
    return torch.tensor(d, dtype=torch.float32).sqrt().to(dtype).item()


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(block kind, window)] of the decoder stack (JAX ``_layer_plan``;
    the port's blocks are all attention)."""
    plan = []
    for i in range(cfg.num_layers):
        w = cfg.window_size
        if cfg.local_global_ratio:
            r = cfg.local_global_ratio
            w = 0 if i % (r + 1) == r else cfg.window_size
        plan.append(("attn", w))
    return plan


@dataclasses.dataclass(frozen=True)
class LMModel:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.frontend_tokens:
            raise NotImplementedError(
                "frontend stubs are not ported yet; the port runs "
                "token-only models")
        self._block()   # raises for block kinds not ported yet

    def _block(self, window: int = 0) -> Block:
        return Block(self.cfg, window=window)

    @property
    def plan(self) -> List[Tuple[str, int]]:
        """(block kind, window) per layer, as the JAX package's."""
        return layer_plan(self.cfg)

    def _blocks(self) -> List[Block]:
        return [self._block(w) for _, w in self.plan]

    def _embed(self) -> nn.Embedding:
        return nn.Embedding(padded_vocab(self.cfg.vocab_size),
                            self.cfg.d_model)

    def _head(self) -> Optional[nn.Dense]:
        if self.cfg.tie_embeddings:
            return None
        return nn.Dense(self.cfg.d_model, padded_vocab(self.cfg.vocab_size),
                        use_bias=False)

    def _norm(self):
        return nn.make_norm(self.cfg.norm, self.cfg.d_model)

    # -- params ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Params:
        """QAT params drawn from ``gen``, on ``gen``'s device."""
        dev = gen.device
        p = {"embed": self._embed().init(gen, dev),
             "final_norm": self._norm().init(dev)}
        head = self._head()
        if head is not None:
            p["head"] = head.init(gen, dev)
        p["blocks"] = [self._block().init(gen, dev)
                       for _ in range(self.cfg.num_layers)]
        return p

    def convert(self, params: Params) -> Params:
        out = {k: v for k, v in params.items() if k != "blocks"}
        out["blocks"] = [self._block().convert(bp)
                         for bp in params["blocks"]]
        return out

    # -- embedding / head -----------------------------------------------------

    def _scale(self, x: torch.Tensor) -> torch.Tensor:
        """x * sqrt(d), with sqrt(d) taken in float32 and rounded to x's
        dtype before the product, as the JAX package does."""
        return x * _sqrt_rounded(self.cfg.d_model, x.dtype)

    def _embed_tokens(self, params: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        x = self._embed().apply(params["embed"], tokens)
        return self._scale(x.to(compute_dtype(self.cfg)))

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self._norm().apply(params["final_norm"], x)
        head = self._head()
        if head is None:
            lg = self._embed().attend(params["embed"], x)
        else:
            lg = head.apply(params["head"], x)
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

    def prefill_logits(self, dparams: Params, tokens, *,
                       device="cuda") -> torch.Tensor:
        """Deploy full-sequence forward, no cache: tokens (B, S) -> logits
        (B, S, V).  Attention is causal or bidirectional as ``cfg.causal``
        says.  ``dparams`` must already lie on ``device`` (CUDA by default;
        pass ``device="cpu"`` for the plain versions); ``tokens`` are
        moved there."""
        dev = resolve_device(device)
        on = dparams["embed"]["embedding"].device
        if on.type != dev.type or dev.index not in (None, on.index):
            raise ValueError(f"prefill_logits(device={str(device)!r}): the "
                             f"params lie on {on}; build them there or "
                             f"move them with repro_torch.to_device")
        x = self._embed_tokens(dparams, torch.as_tensor(tokens, device=dev))
        for blk, bp in zip(self._blocks(), dparams["blocks"]):
            x, _ = blk.deploy_prefill(bp, x)
        return self._logits(dparams, x)

    def prefill_with_cache(self, dparams: Params, tokens: torch.Tensor, *,
                           max_len: int = 0,
                           seq_lens: Optional[torch.Tensor] = None,
                           caches: Optional[List[Dict[str, Any]]] = None,
                           start: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """tokens (B, S) -> (logits (B, 1, V) at the last token, per-layer
        caches with rings of min(window or max_len, max_len): a windowed
        layer keeps its last ``window`` tokens).

        ``seq_lens`` (B,) takes a ragged, right-padded batch: attention
        masks the keys past each sequence's length, each ring holds its
        sequence's own last min(len, ring) tokens and length, and the
        logits come at each sequence's last real token.

        Continuation mode (chunked prefill): with ``caches`` the tokens are
        the next chunk of sequences whose first ``start[b]`` tokens
        (default: the caches' own lengths) are written; ``seq_lens`` is
        each row's real chunk width, logits come at each row's last real
        token, and ``max_len`` is ignored.  The caches update in place and
        come back as the same objects."""
        if caches is not None:
            return self._prefill_continue(dparams, tokens, caches,
                                          start=start, seq_lens=seq_lens)
        if max_len <= 0:
            raise ValueError("prefill_with_cache needs max_len > 0 (or "
                             "caches= for chunk continuation)")
        x = self._embed_tokens(dparams, tokens)
        sl = None if seq_lens is None else torch.as_tensor(
            seq_lens, device=x.device).to(torch.int32)
        caches_out: List[Dict[str, Any]] = []
        for blk, bp in zip(self._blocks(), dparams["blocks"]):
            x, cache = blk.deploy_prefill(
                bp, x, cache_size=min(blk.window or max_len, max_len),
                seq_lens=sl)
            caches_out.append(cache)
        return self._logits(dparams, self._last_real(x, sl)), caches_out

    def _prefill_continue(self, dparams: Params, tokens: torch.Tensor,
                          caches: List[Dict[str, Any]], *,
                          start: Optional[torch.Tensor],
                          seq_lens: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """One chunk of a cache-resuming prefill (see prefill_with_cache):
        the caches given, updated in place, come back."""
        x = self._embed_tokens(dparams, tokens)
        for blk, bp, cache in zip(self._blocks(), dparams["blocks"], caches):
            x, _ = blk.deploy_prefill_chunk(
                bp, x, cache, start=start, valid_len=seq_lens)
        return self._logits(dparams, self._last_real(x, seq_lens)), caches

    def verify_with_cache(self, dparams: Params, tokens: torch.Tensor,
                          caches: List[Dict[str, Any]], *,
                          start: Optional[torch.Tensor] = None,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, List[Any]]:
        """Speculative verify forward: a (B, C) candidate chunk (the pending
        token and C-1 drafted tokens per sequence) against the cached
        prefix, WITHOUT writing the caches.  Returns (logits (B, C, V) at
        every chunk position, per-layer attention projections): row j
        scores the token after prefix + chunk[:j+1], so the caller accepts
        a prefix per sequence and ``commit_chunks`` exactly that many.

        The residual stream keeps ``decode_step``'s precision (the float32
        embedding; the JAX package's verify casts it to ``compute_dtype``
        as chunked prefill does), so each position computes what a decode
        step would and greedy speculative decode equals plain decode in
        bf16 too.  In float32 the two are the same function."""
        x = self._scale(self._embed().apply(dparams["embed"], tokens))
        projs: List[Any] = []
        for blk, bp, cache in zip(self._blocks(), dparams["blocks"], caches):
            x, proj = blk.deploy_verify_chunk(
                bp, x, cache, start=start, valid=valid)
            projs.append(proj)
        return self._logits(dparams, x), projs

    def commit_chunks(self, caches: List[Dict[str, Any]], projs: List[Any],
                      start: torch.Tensor, n_commit: torch.Tensor
                      ) -> List[Dict[str, Any]]:
        """Commit the first ``n_commit[b]`` verified positions at
        ``start[b]`` into every layer's cache, in place; rows with
        n_commit == 0 keep their content and length.  Returns the caches
        given."""
        for blk, cache, proj in zip(self._blocks(), caches, projs):
            blk.commit_chunk(cache, proj, start, n_commit)
        return caches

    def truncate_deploy(self, dparams: Params, num_layers: int
                        ) -> Tuple["LMModel", Params]:
        """Layer-truncated self-speculative draft: the first
        ``num_layers`` blocks of this model, with the embedding, final
        norm and head SHARED.  The draft's params hold the trunk's own
        tensors (nothing is copied); only its caches are its own.
        Returns (draft_model, draft_dparams)."""
        n = num_layers
        if not 1 <= n <= self.cfg.num_layers:
            raise ValueError(f"draft depth {n} outside [1, "
                             f"{self.cfg.num_layers}]")
        dd = {k: v for k, v in dparams.items() if k != "blocks"}
        dd["blocks"] = dparams["blocks"][:n]
        return LMModel(self.cfg.truncated(n)), dd

    def init_caches(self, batch: int, max_len: int, device,
                    paged: Optional[PageSpec] = None
                    ) -> List[Dict[str, Any]]:
        """Empty per-layer decode caches for a pool of ``batch`` slots;
        ``paged`` switches them to the page-arena layout (``max_len`` is
        then superseded by ``paged.capacity``; a windowed layer's ring is
        its window either way)."""
        return [blk.init_cache(batch, max_len, device, paged=paged)
                for blk in self._blocks()]

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
        """token: (B, 1).  Returns (logits (B, 1, V), caches): the caches
        given, their tensors (lengths included) updated in place, so a
        captured graph of the step and its caller hold the same caches."""
        x = self._scale(self._embed().apply(dparams["embed"], token))
        for blk, bp, cache in zip(self._blocks(), dparams["blocks"], caches):
            x, _ = blk.deploy_decode(bp, x, cache)
        return self._logits(dparams, x), caches


def build_model(cfg: ModelConfig) -> LMModel:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port builds "
            f"dense and MoE models")
    return LMModel(cfg)
