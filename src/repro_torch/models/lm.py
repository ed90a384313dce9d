"""LM wrappers (port of ``repro.models.lm``): the decoder-only ``LMModel``
(every LM family, with the frontend stub of the [vlm] archs) and the
encoder-decoder ``EncDecModel`` (seamless' backbone).

  train_loss / qat_logits / qat_hidden
                      QAT forward of every family (``EncDecModel``:
                      ``train_loss`` and ``encode(..., deploy=False)``),
                      each block under ``torch.utils.checkpoint`` unless
                      ``cfg.remat`` is "none"; a MoE stack's load-balance
                      losses summed over its blocks
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
a uniform stack for ``scan``; ``repro_torch.bridge`` unstacks).  The layer
plan is the JAX package's: a block kind per layer ("attn"; "hybrid" for
``family="hybrid"``; for ``family="ssm"`` "slstm" at every
``cfg.ssm.slstm_every``-th layer, "mlstm" elsewhere) and a window: every
layer has ``cfg.window_size``, except in a local:global stack
(``cfg.local_global_ratio`` r), where layer i is global (full attention)
when i % (r + 1) == r.  Each layer's window masks its attention and sizes
its ring.  Recurrent layers carry their state in the caches beside (or,
for xLSTM, instead of) the rings.  As in the JAX
package, prefill runs the residual stream in ``compute_dtype`` while
decode keeps the float32 embedding (projection outputs are still rounded
to ``compute_dtype``).

The frontend stub (``cfg.frontend_tokens`` F, as internvl2's InternViT):
the caller passes precomputed embeddings (B, F, ``frontend_dim``); one fp
projection maps them to d_model, and they are prepended to the token
embeddings, so the prefill covers F + S positions and decode continues at
position F + S.  Frontend models prefill whole prompts only: chunk
continuation, speculative verify and the truncated draft raise, as they
serve token-only decoders.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


def _on_device(dparams: Params, device) -> torch.device:
    """The device an entry point runs on, which must hold ``dparams``."""
    dev = resolve_device(device)
    on = dparams["embed"]["embedding"].device
    if on.type != dev.type or dev.index not in (None, on.index):
        raise ValueError(f"prefill_logits(device={str(device)!r}): the "
                         f"params lie on {on}; build them there or move "
                         f"them with repro_torch.to_device")
    return dev


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """[(block kind, window)] of the decoder stack (JAX ``_layer_plan``)."""
    plan = []
    for i in range(cfg.num_layers):
        if cfg.family == "hybrid":
            kind = "hybrid"
        elif cfg.family == "ssm":
            every = cfg.ssm.slstm_every if cfg.ssm else 0
            kind = "slstm" if (every and (i + 1) % every == 0) else "mlstm"
        else:
            kind = "attn"
        w = cfg.window_size
        if cfg.local_global_ratio:
            r = cfg.local_global_ratio
            w = 0 if i % (r + 1) == r else cfg.window_size
        plan.append((kind, w))
    return plan


def _qat_stack(cfg: ModelConfig, blocks: List[Block], layers: List[Params],
               x: torch.Tensor, memory: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The QAT face of a stack of blocks, layer by layer: (x, the MoE
    load-balance losses summed in layer order, float32).  With
    ``cfg.remat`` other than "none" each block is a
    ``torch.utils.checkpoint`` (its activations recomputed in the
    backward), as the JAX package wraps each block in ``jax.checkpoint``;
    the recomputation gives the same values."""
    aux = torch.zeros((), device=x.device)
    for blk, bp in zip(blocks, layers):
        def run(xx, mem, blk=blk, bp=bp):
            y, a = blk.qat(bp, xx, memory=mem)
            return y, a.get("moe_aux_loss", torch.zeros((),
                                                       device=xx.device))

        if cfg.remat != "none" and torch.is_grad_enabled():
            # the QAT forward draws no random numbers: no RNG state to
            # keep (reading it is not allowed in a captured step)
            x, a = checkpoint(run, x, memory, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = run(x, memory)
        aux = aux + a
    return x, aux


def _nll(logits: torch.Tensor, labels
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean NLL over the valid labels (>= 0), valid mask, denominator)
    of float32 logits."""
    labels = torch.as_tensor(labels, device=logits.device)
    valid = labels >= 0
    lab = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    denom = valid.sum().clamp_min(1)
    return torch.where(valid, nll, 0.0).sum() / denom, valid, denom


@dataclasses.dataclass(frozen=True)
class LMModel:
    cfg: ModelConfig

    def __post_init__(self):
        for kind, w in set(self.plan):
            self._block(kind, w)   # raises for what is not ported yet

    def _block(self, kind: str = "attn", window: int = 0) -> Block:
        return Block(self.cfg, kind=kind, window=window)

    @property
    def plan(self) -> List[Tuple[str, int]]:
        """(block kind, window) per layer, as the JAX package's."""
        return layer_plan(self.cfg)

    def _blocks(self) -> List[Block]:
        return [self._block(k, w) for k, w in self.plan]

    @property
    def uniform(self) -> bool:
        """One block kind throughout (the JAX package stacks such a stack
        for ``scan``; a mixed one, xlstm's, stays a list there too)."""
        return len({k for k, _ in self.plan}) == 1

    @property
    def stacked(self) -> Tuple[str, ...]:
        """The param subtrees whose JAX counterparts stack their layers
        on a leading axis (the optimizer's decay rule and the gradient
        compression's scale read them so): "blocks" of a uniform stack,
        none of a mixed one."""
        return ("blocks",) if self.uniform else ()

    def _embed(self) -> nn.Embedding:
        return nn.Embedding(padded_vocab(self.cfg.vocab_size),
                            self.cfg.d_model)

    def _head(self) -> Optional[nn.Dense]:
        if self.cfg.tie_embeddings:
            return None
        return nn.Dense(self.cfg.d_model, padded_vocab(self.cfg.vocab_size),
                        use_bias=False)

    def _frontend(self) -> Optional[nn.Dense]:
        if not self.cfg.frontend_tokens:
            return None
        return nn.Dense(self.frontend_dim, self.cfg.d_model, use_bias=False)

    @property
    def frontend_dim(self) -> int:
        return min(self.cfg.d_model, 1024)

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
        frontend = self._frontend()
        if frontend is not None:
            p["frontend"] = frontend.init(gen, dev)
        p["blocks"] = [blk.init(gen, dev) for blk in self._blocks()]
        return p

    def convert(self, params: Params) -> Params:
        out = {k: v for k, v in params.items() if k != "blocks"}
        out["blocks"] = [blk.convert(bp) for blk, bp
                         in zip(self._blocks(), params["blocks"])]
        return out

    # -- embedding / head -----------------------------------------------------

    def _scale(self, x: torch.Tensor) -> torch.Tensor:
        """x * sqrt(d), with sqrt(d) taken in float32 and rounded to x's
        dtype before the product, as the JAX package does."""
        return x * _sqrt_rounded(self.cfg.d_model, x.dtype)

    def _embed_tokens(self, params: Params, tokens: torch.Tensor,
                      frontend_embeds=None) -> torch.Tensor:
        """Token embeddings in ``compute_dtype``, scaled; with the frontend
        stub the projected ``frontend_embeds`` (cast to ``compute_dtype``
        first) before them, in the dtype both promote to, as the JAX
        package concatenates them."""
        x = self._embed().apply(params["embed"], tokens)
        x = self._scale(x.to(compute_dtype(self.cfg)))
        if not self.cfg.frontend_tokens:
            return x
        if frontend_embeds is None:
            raise ValueError(f"{self.cfg.name} needs frontend_embeds "
                             f"(B, {self.cfg.frontend_tokens}, "
                             f"{self.frontend_dim})")
        fe = self._frontend().apply(
            params["frontend"],
            torch.as_tensor(frontend_embeds, device=x.device).to(x.dtype))
        dt = torch.promote_types(fe.dtype, x.dtype)
        return torch.cat([fe.to(dt), x.to(dt)], dim=1)

    def _token_only(self, face: str) -> None:
        if self.cfg.frontend_tokens:
            raise ValueError(f"{face} serves token-only decoders")

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

    # -- QAT face -------------------------------------------------------------

    def qat_hidden(self, params: Params, tokens: torch.Tensor, *,
                   frontend_embeds=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens (B, S) -> (hidden (B, F + S, d) before the final norm,
        {"moe_aux_loss": the blocks' load-balance losses summed in layer
        order, 0 without a MoE}).  Runs on the device of ``params``."""
        dev = params["embed"]["embedding"].device
        x = self._embed_tokens(params, torch.as_tensor(tokens, device=dev),
                               frontend_embeds)
        x, aux = _qat_stack(self.cfg, self._blocks(), params["blocks"], x)
        return x, {"moe_aux_loss": aux}

    def qat_logits(self, params: Params, tokens: torch.Tensor, *,
                   frontend_embeds=None) -> torch.Tensor:
        """QAT forward -> logits (B, F + S, V), float32."""
        x, _ = self.qat_hidden(params, tokens,
                               frontend_embeds=frontend_embeds)
        return self._logits(params, x)

    def train_loss(self, params: Params, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens (B, S), labels (B, S) with -1 = ignore, and the
        frontend stub's frontend_embeds.  Returns (loss_total, metrics):
        the mean next-token NLL over valid labels plus the z-loss
        1e-4 * logsumexp^2 over them plus 0.01 * the MoE load-balance
        loss; metrics "loss" (the NLL alone), "moe_aux", "tokens"."""
        x, aux = self.qat_hidden(params, batch["tokens"],
                                 frontend_embeds=batch.get(
                                     "frontend_embeds"))
        if self.cfg.frontend_tokens:
            x = x[:, self.cfg.frontend_tokens:]
        logits = self._logits(params, x).to(torch.float32)
        loss, valid, denom = _nll(logits, batch["labels"])
        zl = 1e-4 * torch.logsumexp(logits, dim=-1) ** 2
        loss_total = (loss + torch.where(valid, zl, 0.0).sum() / denom +
                      0.01 * aux["moe_aux_loss"])
        metrics = {"loss": loss, "moe_aux": aux["moe_aux_loss"],
                   "tokens": valid.sum()}
        return loss_total, metrics

    # -- deploy faces ---------------------------------------------------------

    def prefill_logits(self, dparams: Params, tokens, *,
                       frontend_embeds=None,
                       device="cuda") -> torch.Tensor:
        """Deploy full-sequence forward, no cache: tokens (B, S) -> logits
        (B, S, V), or (B, F + S, V) with the frontend stub's
        ``frontend_embeds`` (B, F, ``frontend_dim``).  Attention is causal
        or bidirectional as ``cfg.causal`` says.  ``dparams`` must already
        lie on ``device`` (CUDA by default; pass ``device="cpu"`` for the
        plain versions); the inputs are moved there."""
        dev = _on_device(dparams, device)
        x = self._embed_tokens(dparams, torch.as_tensor(tokens, device=dev),
                               frontend_embeds)
        for blk, bp in zip(self._blocks(), dparams["blocks"]):
            x, _ = blk.deploy_prefill(bp, x)
        return self._logits(dparams, x)

    def prefill_with_cache(self, dparams: Params, tokens: torch.Tensor, *,
                           max_len: int = 0,
                           seq_lens: Optional[torch.Tensor] = None,
                           caches: Optional[List[Dict[str, Any]]] = None,
                           start: Optional[torch.Tensor] = None,
                           frontend_embeds=None
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
        come back as the same objects.

        With the frontend stub, ``frontend_embeds`` (B, F, ``frontend_dim``)
        go before the tokens: the rings hold F + S tokens (``max_len``
        must cover them and the new ones) and ``seq_lens`` count the
        tokens only.  Frontend models have no continuation mode."""
        if caches is not None:
            if frontend_embeds is not None or self.cfg.frontend_tokens:
                raise ValueError("chunked prefill serves token-only "
                                 "decoders")
            return self._prefill_continue(dparams, tokens, caches,
                                          start=start, seq_lens=seq_lens)
        if max_len <= 0:
            raise ValueError("prefill_with_cache needs max_len > 0 (or "
                             "caches= for chunk continuation)")
        x = self._embed_tokens(dparams, tokens, frontend_embeds)
        sl = None if seq_lens is None else torch.as_tensor(
            seq_lens, device=x.device).to(torch.int32) + \
            self.cfg.frontend_tokens
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
        self._token_only("speculative verify")
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
        Returns (draft_model, draft_dparams).  A frontend model has no
        draft: its verify raises."""
        self._token_only("the speculative draft")
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
        """Put the recurrent carries (mamba conv/h, xLSTM c/n/m) of the
        pool rows marked by ``fresh`` (B,) bool back to their
        ``init_cache`` values (not plain zeros: sLSTM's normalizer and the
        max-gate stabilizers init off zero), in place and without a host
        sync (the unified step's graph runs it), leaving other rows
        untouched.  Attention rings need no per-row reset: a chunk
        starting at 0 masks every stale slot and its first write sets the
        length.  Returns the caches given."""
        fresh = torch.as_tensor(fresh).to(torch.bool)
        for blk, cache in zip(self._blocks(), caches):
            blk.reset_rows(cache, fresh)
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


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t backbone)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncDecModel:
    """The encoder-decoder: the frontend stub's fp projection of the
    caller's embeddings (B, S_enc, ``frontend_dim``), applied as given (no
    cast, as in the JAX package), then ``num_encoder_layers``
    bidirectional attention blocks (RoPE on) and ``enc_norm``: the memory.
    The decoder: ``num_layers`` "dec" blocks (causal self-attention, then
    cross-attention over the memory, then the FFN), ``final_norm`` and the
    untied head.  Its token embedding is cast to ``compute_dtype`` at
    prefill and at decode alike, as the JAX package casts it (the
    decoder-only ``LMModel`` keeps it float32 at decode).  Each decoder
    cache holds the self-attention ring ("attn") and the static binary
    memory ("cross"), which decode reads and never writes.  Prefill takes
    whole, equal-length prompts; there is no chunk face."""
    cfg: ModelConfig

    def __post_init__(self):
        self._enc_block()
        self._dec_block()

    @property
    def enc_layers(self) -> int:
        return self.cfg.num_encoder_layers

    @property
    def stacked(self) -> Tuple[str, ...]:
        """The param subtrees the JAX package stacks on a leading layer
        axis (see ``LMModel.stacked``)."""
        return ("encoder", "decoder")

    def train_loss(self, params: Params, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: frontend_embeds (B, S_enc, ``frontend_dim``), tokens (B,
        S), labels (B, S) with -1 = ignore.  Returns (loss, metrics): the
        mean next-token NLL over valid labels, with no z-loss and no MoE
        term (the JAX package's encoder-decoder loss); metrics "loss",
        "tokens" and "moe_aux" (0)."""
        dev = params["embed"]["embedding"].device
        memory = self.encode(params, torch.as_tensor(
            batch["frontend_embeds"], device=dev), deploy=False)
        x = self._embed_tokens(params, torch.as_tensor(batch["tokens"],
                                                       device=dev))
        x, _ = _qat_stack(self.cfg, [self._dec_block()] * self.cfg.num_layers,
                          params["decoder"], x, memory)
        logits = self._logits(params, x).to(torch.float32)
        loss, valid, _ = _nll(logits, batch["labels"])
        return loss, {"loss": loss, "tokens": valid.sum(),
                      "moe_aux": torch.zeros((), device=dev)}

    def _enc_block(self) -> Block:
        return Block(self.cfg, kind="attn", causal=False)

    def _dec_block(self) -> Block:
        return Block(self.cfg, kind="dec")

    def _embed(self) -> nn.Embedding:
        return nn.Embedding(padded_vocab(self.cfg.vocab_size),
                            self.cfg.d_model)

    def _head(self) -> nn.Dense:
        return nn.Dense(self.cfg.d_model, padded_vocab(self.cfg.vocab_size),
                        use_bias=False)

    def _frontend(self) -> nn.Dense:
        return nn.Dense(self.frontend_dim, self.cfg.d_model, use_bias=False)

    @property
    def frontend_dim(self) -> int:
        return min(self.cfg.d_model, 1024)

    def _norm(self):
        return nn.make_norm(self.cfg.norm, self.cfg.d_model)

    # -- params ---------------------------------------------------------------

    def init(self, gen: torch.Generator) -> Params:
        """QAT params drawn from ``gen``, on ``gen``'s device."""
        dev = gen.device
        enc, dec = self._enc_block(), self._dec_block()
        return {"embed": self._embed().init(gen, dev),
                "frontend": self._frontend().init(gen, dev),
                "head": self._head().init(gen, dev),
                "enc_norm": self._norm().init(dev),
                "final_norm": self._norm().init(dev),
                "encoder": [enc.init(gen, dev)
                            for _ in range(self.enc_layers)],
                "decoder": [dec.init(gen, dev)
                            for _ in range(self.cfg.num_layers)]}

    def convert(self, params: Params) -> Params:
        out = {k: v for k, v in params.items()
               if k not in ("encoder", "decoder")}
        out["encoder"] = [self._enc_block().convert(lp)
                          for lp in params["encoder"]]
        out["decoder"] = [self._dec_block().convert(lp)
                          for lp in params["decoder"]]
        return out

    # -- deploy faces ---------------------------------------------------------

    def encode(self, params: Params, frontend_embeds: torch.Tensor, *,
               deploy: bool = True) -> torch.Tensor:
        """frontend_embeds (B, S_enc, ``frontend_dim``) -> the memory (B,
        S_enc, d), in the dtype the projection gives them: through the
        deploy params' encoder, or with ``deploy=False`` through the QAT
        params' (each block checkpointed as ``cfg.remat`` says)."""
        x = self._frontend().apply(params["frontend"], frontend_embeds)
        blk = self._enc_block()
        if deploy:
            for lp in params["encoder"]:
                x, _ = blk.deploy_prefill(lp, x)
        else:
            x, _ = _qat_stack(self.cfg, [blk] * self.enc_layers,
                              params["encoder"], x)
        return self._norm().apply(params["enc_norm"], x)

    def _embed_tokens(self, params: Params,
                      tokens: torch.Tensor) -> torch.Tensor:
        x = self._embed().apply(params["embed"], tokens)
        x = x.to(compute_dtype(self.cfg))
        return x * _sqrt_rounded(self.cfg.d_model, x.dtype)

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = self._norm().apply(params["final_norm"], x)
        return self._head().apply(params["head"],
                                  x)[..., :self.cfg.vocab_size]

    def _decoder(self, dparams: Params, tokens: torch.Tensor,
                 frontend_embeds, cache_size: int = 0):
        """Encode, then the decoder stack over the tokens: (hidden (B, S,
        d), per-layer caches when ``cache_size``)."""
        dev = tokens.device
        memory = self.encode(dparams, torch.as_tensor(frontend_embeds,
                                                      device=dev))
        x = self._embed_tokens(dparams, tokens)
        blk, caches = self._dec_block(), []
        for lp in dparams["decoder"]:
            x, cache = blk.deploy_prefill(lp, x, memory=memory,
                                          cache_size=cache_size)
            caches.append(cache)
        return x, caches

    def prefill_logits(self, dparams: Params, tokens, *, frontend_embeds,
                       device="cuda") -> torch.Tensor:
        """Deploy forward, no cache: tokens (B, S) and frontend_embeds (B,
        S_enc, ``frontend_dim``) -> logits (B, S, V).  ``dparams`` must
        already lie on ``device`` (CUDA by default; ``device="cpu"`` for
        the plain versions); the inputs are moved there."""
        dev = _on_device(dparams, device)
        x, _ = self._decoder(dparams, torch.as_tensor(tokens, device=dev),
                             frontend_embeds)
        return self._logits(dparams, x)

    def prefill_with_cache(self, dparams: Params, tokens: torch.Tensor, *,
                           max_len: int, frontend_embeds
                           ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """tokens (B, S) -> (logits (B, 1, V) at the last token, per-layer
        caches: self-attention rings of ``max_len`` and the memory of
        S_enc positions)."""
        if max_len <= 0:
            raise ValueError("prefill_with_cache needs max_len > 0")
        x, caches = self._decoder(dparams, tokens, frontend_embeds,
                                  cache_size=max_len)
        return self._logits(dparams, x[:, -1:]), caches

    def init_caches(self, batch: int, max_len: int, device,
                    paged: Optional[PageSpec] = None,
                    memory_len: int = 0) -> List[Dict[str, Any]]:
        """Empty per-layer decode caches: rings of ``max_len`` and a memory
        of ``memory_len`` positions (at least 1).  The decoder serves
        from contiguous rings only."""
        if paged is not None:
            raise ValueError("the encoder-decoder serves contiguous rings "
                             "only, through the static path")
        blk = self._dec_block()
        return [blk.init_cache(batch, max_len, device,
                               memory_len=memory_len)
                for _ in range(self.cfg.num_layers)]

    def decode_step(self, dparams: Params, token: torch.Tensor,
                    caches: List[Dict[str, Any]]
                    ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """token: (B, 1).  Returns (logits (B, 1, V), caches): the caches
        given, their rings and lengths updated in place (the memory
        read only)."""
        x = self._embed_tokens(dparams, token)
        blk = self._dec_block()
        for lp, cache in zip(dparams["decoder"], caches):
            x, _ = blk.deploy_decode(lp, x, cache)
        return self._logits(dparams, x), caches


def build_model(cfg: ModelConfig):
    """The JAX package's rule: an ``EncDecModel`` for the audio family or
    any encoder layers, an ``LMModel`` otherwise."""
    if cfg.family == "audio" or cfg.num_encoder_layers:
        return EncDecModel(cfg)
    return LMModel(cfg)
