"""Serve engine (port of ``repro.serve.engine``): static batches and
continuous batching on a pooled binary KV cache.

  static      ``generate(prompts_2d)``: one equal-length batch prefills
              once, then decode steps run lockstep to a fixed horizon.
  continuous  ``generate([prompts])`` / ``serve(requests)``: a scheduling
              policy admits requests into a fixed pool of cache slots and
              ONE pooled forward per engine iteration advances every
              in-flight stream.  Iterations with an in-flight prefill run
              the chunk-continuation forward (``prefill_with_cache`` with
              ``caches=``) over the whole pool: prefill rows carry their
              next chunk, decode rows ride as width-1 chunks, empty slots
              are inactive rows (valid = 0).  Pure-decode iterations run
              ``decode_step``.  Slots retire on EOS or budget and are
              backfilled on the next iteration.

With ``CacheConfig.paged`` the per-slot rings are a shared page arena plus
block tables: pages return at retirement, and when the arena runs dry the
lowest-priority slot is preempted back to the queue (recompute on
resume).  ``prefix_share`` maps requests with a common prompt prefix onto
one refcounted copy of its full pages, with copy-on-write before a decode
write would diverge a shared page.  ``PolicyConfig.prefill_chunk`` streams
long prompts one chunk per iteration beside the decode rows.  The host
logic is the JAX package's, decision for decision, so with greedy sampling
and arrivals at 0 both engines give the same tokens, preemptions and page
statistics.

The steps the JAX engine jits run here as captured CUDA graphs
(``serve/graphs.py``): the static decode step at its batch, the pooled
decode step, and the unified forward once per chunk width, each captured
at first use and replayed after, with the captures counted by kind as the
JAX engine counts its traces (``EngineReport.unified_compiles`` /
``engine_compiles``).  A graph reads the addresses it was captured with,
so the engine keeps its caches (one set per pool shape, updated in place,
where JAX donates them to the jitted step) and one device block table per
ring group, refreshed in place from the host's tables; host inputs are
copied into each graph's static buffers.  Sampling runs eagerly on the
replayed logits.  Prefill of the static batch, the copy-on-write page
copies and all host bookkeeping run between replays.

Frontend models (internvl2's patch embeddings before the prompt) and the
encoder-decoder (seamless: the frame embeddings go through the encoder,
the decoder attends over its binary memory) serve through the static path
only, ``generate(prompts_2d, frontend_embeds=...)``, as in the JAX
package: the pool of the decode graph takes the prefilled caches, the
decoder's static memories included.

Recurrent families (hymba's hybrid blocks, xlstm's cells) ride the same
steps: a prefill chunk resumes each row's carries from the pool (rows
starting a prompt are first put back to the carries' init values, inside
the unified graph), inactive rows keep theirs, and the carries update in
place as the rings do.  A layer without attention has no ring group, so
a pure-xLSTM stack has no page arena; its requests are not capped by the
cache length.  Speculative decode needs an attention-only stack: a
recurrent one decodes plainly, as in the JAX package.

``SpecConfig.k`` adds speculative decode on the pure-decode iterations: a
draft (the first ``draft_layers`` blocks of the trunk on its own weights,
or an independent draft passed to the engine) proposes k tokens per slot
from its own contiguous ring pool, ONE verify forward of the trunk scores
all k+1 positions without writing its caches, acceptance picks each
slot's prefix, exactly that prefix commits to the trunk, and the draft's
rings roll back to the committed tokens.  The whole iteration is one
captured graph (kind ``spec``): greedy acceptance is an in-graph argmax,
and the stochastic samplers draw by inverting cumulative sums at uniforms
that the engine's generator draws before the replay and copies into the
graph's inputs, so no generator runs inside a graph.  On mixed iterations
the draft pool ingests the same chunk in the same unified graph.  Greedy
output equals plain decode token for token where every path computes the
same function, i.e. in float32: in bf16 a decode step keeps a float32
residual stream and the unified forward a bf16 one, so the tokens of any
run, speculative or not, depend on which iterations were mixed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import packing
from repro_torch.models.attention import KVCache, PagedKVCache, PageSpec
from repro_torch.serve import graphs as graphs_lib
from repro_torch.serve import kvcache, sampler as sampler_lib
from repro_torch.serve.policy import (PolicyConfig, Scheduler,
                                      SchedulingPolicy, _pow2_bucket,
                                      make_policy)

__all__ = ["CacheConfig", "SpecConfig", "PolicyConfig", "ServeConfig",
           "SLO", "Request", "Scheduler", "SchedulingPolicy",
           "ServeEngine"]


@dataclasses.dataclass
class CacheConfig:
    """KV-cache layout (``ServeConfig.cache``).

    max_len: contiguous ring size (>= prompt + new tokens).
    paged: a page arena + block tables instead of per-slot rings (served
      by the continuous path only).
    page_size: tokens per page, a positive multiple of 32.
    max_blocks: block-table width; default ceil(max_len / page_size).
      Capacity is ``max_blocks * page_size``.
    num_pages: usable arena pages; default fully provisioned
      (num_slots * max_blocks).  Fewer is safe: exhaustion preempts.
    prefix_share: paged mode only: share the full pages of common prompt
      prefixes (refcounted, copy-on-write).
    """
    max_len: int = 2048
    paged: bool = False
    page_size: int = 32
    max_blocks: Optional[int] = None
    num_pages: Optional[int] = None
    prefix_share: bool = True

    def page_spec(self) -> PageSpec:
        if self.max_blocks is not None:
            blocks = self.max_blocks
        else:
            blocks = (-(-self.max_len // self.page_size)
                      if self.page_size > 0 else 1)
        return PageSpec(page_size=self.page_size, max_blocks=blocks,
                        num_pages=self.num_pages or 0)


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decode knobs (``ServeConfig.spec``).

    k: drafted tokens per slot per pure-decode iteration, verified by one
      pooled k+1-token forward; accepted prefixes commit, rejected tails
      never reach the trunk's caches.  None disables.
    draft_layers: depth of the layer-truncated draft on the trunk's own
      weights (clamped to the stack; a full-depth draft accepts
      everything).  Ignored when ``ServeEngine`` gets an explicit draft.
    """
    k: Optional[int] = None
    draft_layers: int = 1

    def __post_init__(self):
        if self.k is not None and self.k < 1:
            raise ValueError(f"spec_decode must draft at least one token "
                             f"per step, got {self.k}")
        if self.k is not None and self.draft_layers < 1:
            raise ValueError(f"spec_draft_layers must be >= 1, got "
                             f"{self.draft_layers}")


_FLAT_CACHE = ("max_len", "paged", "page_size", "max_blocks", "num_pages",
               "prefix_share")
_FLAT_SPEC = {"spec_decode": "k", "spec_draft_layers": "draft_layers"}
_FLAT_POLICY = ("prefill_chunk",)


class ServeConfig:
    """Engine-level serving knobs, grouped as in the JAX package.

    sampler / temperature / top_k / seed: token sampling (greedy |
      temperature | top_k; ``seed`` seeds a ``torch.Generator``).
    num_slots: continuous-batching pool size.
    eos_id: default retirement token (``Request.eos_id`` overrides).
    cache: ``CacheConfig``; spec: ``SpecConfig``; policy: ``PolicyConfig``.

    The JAX package's deprecated flat keywords (``max_len=``,
    ``paged=``, ``prefill_chunk=``, ``spec_decode=``, ...) still construct:
    they map onto the sub-configs with one ``DeprecationWarning``, and the
    read-through properties (``cfg.max_len``, ``cfg.spec_decode``, ...)
    read them back.
    """

    def __init__(self, *, sampler: str = "greedy",
                 temperature: float = 1.0, top_k: int = 40, seed: int = 0,
                 num_slots: int = 4, eos_id: Optional[int] = None,
                 cache: Optional[CacheConfig] = None,
                 spec: Optional[SpecConfig] = None,
                 policy: Optional[PolicyConfig] = None, **flat):
        self.sampler = sampler
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.num_slots = num_slots
        self.eos_id = eos_id
        cache = cache if cache is not None else CacheConfig()
        spec = spec if spec is not None else SpecConfig()
        policy = policy if policy is not None else PolicyConfig()
        if flat:
            unknown = [k for k in flat if k not in _FLAT_CACHE and
                       k not in _FLAT_SPEC and k not in _FLAT_POLICY]
            if unknown:
                raise TypeError(f"ServeConfig got unexpected keyword "
                                f"arguments {sorted(unknown)}")
            warnings.warn(
                f"flat ServeConfig keywords {sorted(flat)} are "
                f"deprecated: pass cache=CacheConfig(...), "
                f"spec=SpecConfig(...) and/or policy=PolicyConfig(...)",
                DeprecationWarning, stacklevel=2)
            ck = {k: v for k, v in flat.items() if k in _FLAT_CACHE}
            if ck:
                cache = dataclasses.replace(cache, **ck)
            sk = {_FLAT_SPEC[k]: v for k, v in flat.items()
                  if k in _FLAT_SPEC}
            if sk:
                spec = dataclasses.replace(spec, **sk)
            pk = {k: v for k, v in flat.items() if k in _FLAT_POLICY}
            if pk:
                policy = dataclasses.replace(policy, **pk)
        self.cache = cache
        self.spec = spec
        self.policy = policy

    def _fields(self) -> tuple:
        return (self.sampler, self.temperature, self.top_k, self.seed,
                self.num_slots, self.eos_id, self.cache, self.spec,
                self.policy)

    def __repr__(self) -> str:
        return (f"ServeConfig(sampler={self.sampler!r}, "
                f"temperature={self.temperature}, top_k={self.top_k}, "
                f"seed={self.seed}, num_slots={self.num_slots}, "
                f"eos_id={self.eos_id}, cache={self.cache}, "
                f"spec={self.spec}, policy={self.policy})")

    def __eq__(self, other) -> bool:
        if not isinstance(other, ServeConfig):
            return NotImplemented
        return self._fields() == other._fields()

    def page_spec(self) -> PageSpec:
        return self.cache.page_spec()

    @property
    def max_len(self) -> int:
        return self.cache.max_len

    @property
    def paged(self) -> bool:
        return self.cache.paged

    @property
    def page_size(self) -> int:
        return self.cache.page_size

    @property
    def max_blocks(self) -> Optional[int]:
        return self.cache.max_blocks

    @property
    def num_pages(self) -> Optional[int]:
        return self.cache.num_pages

    @property
    def prefix_share(self) -> bool:
        return self.cache.prefix_share

    @property
    def prefill_chunk(self) -> Optional[int]:
        return self.policy.prefill_chunk

    @property
    def spec_decode(self) -> Optional[int]:
        return self.spec.k

    @property
    def spec_draft_layers(self) -> int:
        return self.spec.draft_layers


@dataclasses.dataclass
class SLO:
    """Per-request latency targets (None = unconstrained): time to first
    token from ``arrival_s`` and mean seconds per later token."""
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None

    def met(self, ttft_s: Optional[float], tpot_s: float) -> bool:
        if self.ttft_s is not None and (ttft_s is None or
                                        ttft_s > self.ttft_s):
            return False
        if self.tpot_s is not None and tpot_s > self.tpot_s:
            return False
        return True


@dataclasses.dataclass
class Request:
    """One request for the continuous engine.

    rid: caller-chosen id; results key on it.  tokens: (S,) int32 prompt.
    max_new_tokens: generation budget, kept across preemption.
    eos_id: retirement token (falls back to ``ServeConfig.eos_id``).
    priority: higher runs first; the lowest is preempted first.
    tenant: traffic class for quotas and the per-tenant rollup.
    arrival_s: open-loop arrival offset from serve() start; the request is
      invisible to admission until the engine clock reaches it.
    slo: latency targets for the goodput accounting.
    """
    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    priority: int = 0
    tenant: str = "default"
    arrival_s: float = 0.0
    slo: Optional[SLO] = None


class _SlotState:
    """Host-side generation state of one decoding slot."""

    __slots__ = ("request", "generated", "eos_id", "cache_len", "admit_seq")

    def __init__(self, request: Request, eos_id: Optional[int],
                 prompt_len: int, admit_seq: int,
                 resumed: Sequence[int] = ()):
        self.request = request
        self.generated: List[int] = list(resumed)
        self.eos_id = request.eos_id if request.eos_id is not None else eos_id
        self.cache_len = prompt_len       # tokens written to the cache
        self.admit_seq = admit_seq

    def push(self, token: int) -> bool:
        """Record a token; True when the request should retire."""
        self.generated.append(token)
        if self.eos_id is not None and token == self.eos_id:
            return True
        return len(self.generated) >= self.request.max_new_tokens


class _PrefillState:
    """An in-flight prefill occupying a slot: ``toks`` is prompt + tokens
    generated before a preemption (``pre``), ``done`` the tokens already
    written.  It becomes a decoding slot when its last chunk lands."""

    __slots__ = ("request", "toks", "pre", "done", "admit_seq")

    def __init__(self, request: Request, toks: np.ndarray,
                 pre: Sequence[int], admit_seq: int):
        self.request = request
        self.toks = toks
        self.pre: List[int] = list(pre)
        self.done = 0
        self.admit_seq = admit_seq


def _attention_only(model) -> bool:
    """Every block of ``model``'s plan is attention."""
    plan = getattr(model, "plan", None)
    return plan is not None and {k for k, _ in plan} == {"attn"}


def _rollback_draft(cache: KVCache, k0: torch.Tensor, vt0: torch.Tensor,
                    len0: torch.Tensor, start: torch.Tensor,
                    n_commit: torch.Tensor, active: torch.Tensor,
                    span: int) -> None:
    """Put a draft ring back to its committed state, in place (the JAX
    engine's ``rollback_draft``).  The draft steps wrote positions start
    .. start+span-1 of each active row; every ring slot whose last writer
    among them lies at or past start + n_commit takes its content from
    before the steps (``k0``, ``vt0``): on a windowed ring that the steps
    wrapped, the slots of tokens still inside the committed window too.
    An active row's length becomes start + n_commit, an inactive row's
    goes back to ``len0`` (its n_commit is 0, so it restores the slots of
    positions start.. with start as the engine passes it; a free slot's
    next request starts at 0 and reads none of its old slots).  Same
    last-writer slot map as ``SPSAttention._write_chunk``."""
    w = cache.k_bits.shape[2]
    s_all = torch.arange(w, device=k0.device)
    lv = start + span                          # end of the steps' writes
    t_new = lv[:, None] - 1 - torch.remainder(
        lv[:, None] - 1 - s_all[None, :], w)                    # (B, W)
    rejected = t_new >= (start + n_commit)[:, None]
    cache.k_bits.copy_(torch.where(rejected[:, None, :, None], k0,
                                   cache.k_bits))
    rej_w = packing.pack_bits(rejected)
    cache.vt_bits.copy_((cache.vt_bits & ~rej_w[:, None, None, :]) |
                        (vt0 & rej_w[:, None, None, :]))
    cache.length.copy_(torch.where(active != 0, start + n_commit, len0))


class ServeEngine:
    def __init__(self, model, dparams, cfg: ServeConfig, draft_model=None,
                 draft_dparams=None, *,
                 policy: Optional[SchedulingPolicy] = None, device="cuda"):
        """``dparams`` must already lie on ``device`` (CUDA by default;
        asking for CUDA without a card raises).  ``draft_model`` /
        ``draft_dparams`` optionally supply an independent speculative
        draft (an attention-only decoder with its own params, on the same
        device); with ``cfg.spec.k`` and no explicit draft, the
        layer-truncated draft on the trunk's own weights is built at the
        first speculative ``serve``.  ``policy`` optionally injects a
        ``SchedulingPolicy`` reused across ``serve`` calls; by default
        each call builds one from ``cfg.policy``."""
        self.model = model
        self.dparams = dparams
        self.cfg = cfg
        self.device = resolve_device(device)
        self._policy_proto = policy
        if (draft_model is None) != (draft_dparams is None):
            raise ValueError("pass draft_model and draft_dparams together")
        self.draft_model = draft_model
        self.draft_dparams = draft_dparams
        # the captured steps (the JAX engine's ``_decode_jit`` /
        # ``_unified_jit`` / ``_spec_jit`` and their ``_compiles``) and the
        # caches they read, by pool shape (batch, max_len, PageSpec or
        # None); the draft's contiguous rings by (batch, ring length)
        self._graphs = graphs_lib.StepGraphs(self.device)
        self._pools: Dict[tuple, list] = {}
        # the last serve's page arenas by logical ring length (one per
        # ring group), kept for their per-group statistics
        self.arenas: Dict[int, kvcache.PageArena] = {}
        self._draft_pools: Dict[tuple, list] = {}
        self._sample = {
            "greedy": lambda lg, g: sampler_lib.greedy(lg),
            "temperature": lambda lg, g: sampler_lib.temperature(
                lg, g, cfg.temperature),
            "top_k": lambda lg, g: sampler_lib.top_k(
                lg, g, cfg.top_k, cfg.temperature),
        }[cfg.sampler]

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.cfg.seed)

    def _pool_caches(self, batch: int, spec: Optional[PageSpec],
                     memory_len: int = 0) -> Tuple[tuple, list]:
        """(key, caches): the engine's caches for a pool of ``batch`` rows
        (and, for an encoder-decoder, memories of ``memory_len``
        positions), built at first use and kept, since a captured step
        reads them at fixed addresses.  The paged layers of a ring group
        share one device block table."""
        key = (batch, self.cfg.max_len, spec, memory_len)
        caches = self._pools.get(key)
        if caches is None:
            kw = {"memory_len": memory_len} if memory_len else {}
            caches = self.model.init_caches(batch, self.cfg.max_len,
                                            self.device, paged=spec, **kw)
            if spec:
                tables: Dict[int, torch.Tensor] = {}
                for i, ring in enumerate(self._layer_rings(spec)):
                    pg = caches[i].get("attn")
                    if ring is not None and isinstance(pg, PagedKVCache):
                        t = tables.setdefault(ring, pg.block_table)
                        caches[i] = dict(caches[i],
                                         attn=pg._replace(block_table=t))
            self._pools[key] = caches
        return key, caches

    def _draft_caches(self, batch: int, ring: int) -> Tuple[tuple, list]:
        """(key, caches): the draft's contiguous rings for a pool of
        ``batch`` rows, kept as ``_pool_caches`` keeps the trunk's.  They
        are a small unshared pool, but cover the trunk's capacity."""
        key = (batch, ring)
        caches = self._draft_pools.get(key)
        if caches is None:
            caches = self.draft_model.init_caches(batch, ring, self.device)
            self._draft_pools[key] = caches
        return key, caches

    def _decode_graph(self, key: tuple,
                      caches: list) -> graphs_lib.StepGraph:
        """The pooled decode step of the caches of ``key``: tokens (B, 1)
        -> logits (B, 1, V)."""
        return self._graphs.get("decode", key, lambda: (
            lambda tokens: self.model.decode_step(self.dparams, tokens,
                                                  caches)[0],
            {"tokens": (key[0], 1)}, graphs_lib.cache_tensors(caches)))

    def _unified_graph(self, key: tuple, caches: list, width: int,
                       draft: Optional[Tuple[tuple, list]] = None
                       ) -> graphs_lib.StepGraph:
        """The unified forward over the whole pool at one chunk width:
        tokens (B, width), start, valid, fresh (B,) -> logits (B, 1, V) at
        each row's last real token.  With ``draft`` = (key, caches) the
        draft pool ingests the same chunk in the same graph, so its rings
        follow the trunk's."""
        dcaches = draft[1] if draft else None

        def forward(tokens, start, valid, fresh):
            self.model.reset_recurrent_rows(caches, fresh != 0)
            logits, _ = self.model.prefill_with_cache(
                self.dparams, tokens, caches=caches, start=start,
                seq_lens=valid)
            if dcaches is not None:
                self.draft_model.prefill_with_cache(
                    self.draft_dparams, tokens, caches=dcaches, start=start,
                    seq_lens=valid)
            return logits

        b = key[0]
        state = graphs_lib.cache_tensors(caches) + (
            graphs_lib.cache_tensors(dcaches) if dcaches else [])
        gkey = (key, width) + ((draft[0],) if draft else ())
        return self._graphs.get("unified", gkey, lambda: (
            forward, {"tokens": (b, width), "start": (b,), "valid": (b,),
                      "fresh": (b,)}, state))

    def spec_forward(self, caches: list, dcaches: list
                     ) -> Callable[..., torch.Tensor]:
        """One pooled speculative iteration (the JAX engine's
        ``_build_spec_step``) on these trunk and draft caches, as a
        function of tokens (B, 1) pending, start (B,) the trunk's lengths,
        active (B,) 0/1 and, for the stochastic samplers, ``rand`` (B,
        2k+2) integers below 2**23 (the uniforms: k+1 draft draws, k
        acceptances, one residual draw).  It updates both caches in place
        and returns (B, k+2) int64: each row's k+1 output tokens, then its
        accepted count.

          1. the draft proposes from the pending token (k+1 decode steps;
             the last ingests d_k, so its rings cover every outcome)
          2. the trunk scores all k+1 positions in one verify forward
             that writes nothing
          3. acceptance: greedy argmax matching, or rejection sampling
          4. exactly the accepted prefix (nothing for inactive rows)
             commits to the trunk, and the draft rolls back: every ring
             slot whose last writer was a rejected position takes its
             content from before step 1, and the length follows
             (``_rollback_draft``, the JAX engine's rollback).

        The draft's caches update in place, so step 1 overwrites what
        the rollback needs: their rings and lengths are copied first.
        On a windowed draft layer the ring is the window, so the steps
        may wrap it and overwrite tokens still in the committed window:
        the restore brings those back too."""
        k = self.cfg.spec_decode
        smp = self.cfg.sampler
        stochastic = smp != "greedy"
        temp, top = self.cfg.temperature, self.cfg.top_k
        draft, ddparams = self.draft_model, self.draft_dparams

        def forward(tokens, start, active, rand=None):
            u = sampler_lib.uniforms(rand) if stochastic else None
            saved = [(c["attn"].k_bits.clone(), c["attn"].vt_bits.clone(),
                      c["attn"].length.clone()) for c in dcaches]
            tok, drafts, qs = tokens, [], []
            for i in range(k + 1):
                lg, _ = draft.decode_step(ddparams, tok, dcaches)
                if stochastic:
                    q = sampler_lib.sampling_probs(lg[:, -1], smp, temp, top)
                    nxt = sampler_lib.categorical(q, u[:, i])
                    qs.append(q)
                else:
                    nxt = torch.argmax(lg[:, -1], dim=-1)
                drafts.append(nxt)
                tok = nxt[:, None]
            drafts_bk = torch.stack(drafts[:k], dim=1)         # (B, k)
            logits, projs = self.model.verify_with_cache(
                self.dparams, torch.cat([tokens, drafts_bk], dim=1), caches,
                start=start)
            out, n_acc = sampler_lib.speculative_accept(
                drafts_bk, torch.stack(qs[:k], dim=1) if stochastic else None,
                logits, sampler=smp, temp=temp, k=top,
                u=u[:, k + 1:] if stochastic else None)
            n_commit = torch.where(active != 0, n_acc.to(torch.int64) + 1, 0)
            self.model.commit_chunks(caches, projs, start, n_commit)
            for c, (k0, vt0, len0) in zip(dcaches, saved):
                _rollback_draft(c["attn"], k0, vt0, len0, start, n_commit,
                                active, k + 1)
            return torch.cat([out.to(torch.int64),
                              n_acc.to(torch.int64)[:, None]], dim=1)

        return forward

    def _spec_graph(self, key: tuple, caches: list,
                    draft: Tuple[tuple, list]) -> graphs_lib.StepGraph:
        """The speculative iteration of ``spec_forward`` as one graph,
        captured once per pool shape and k."""
        b, k = key[0], self.cfg.spec_decode
        shapes = {"tokens": (b, 1), "start": (b,), "active": (b,)}
        if self.cfg.sampler != "greedy":
            shapes["rand"] = (b, 2 * k + 2)
        return self._graphs.get("spec", (key, draft[0], k), lambda: (
            self.spec_forward(caches, draft[1]), shapes,
            graphs_lib.cache_tensors(caches) +
            graphs_lib.cache_tensors(draft[1])))

    # -- public API ---------------------------------------------------------

    def generate(self, prompts, *, max_new_tokens: int,
                 frontend_embeds=None,
                 stream_cb: Optional[Callable] = None):
        """A (B, S) array of prompts -> static batching: (tokens (B,
        max_new_tokens) int32 numpy, EngineReport), ``stream_cb(step,
        tokens)`` after the prefill and every decode step.  A frontend
        model or an encoder-decoder takes its ``frontend_embeds`` (B, F,
        ``model.frontend_dim``) here, static batching only.

        A list of 1-D prompts -> continuous batching over the slot pool:
        (list of per-prompt token arrays, EngineReport), ``stream_cb(rid,
        index, token)`` per token."""
        ndim = getattr(prompts, "ndim", None)
        if ndim == 2:
            return self._generate_static(np.asarray(prompts),
                                         max_new_tokens, frontend_embeds,
                                         stream_cb)
        if ndim is not None and ndim != 1:
            raise ValueError(f"prompts array must be (B, S), got "
                             f"{ndim}-D; a single prompt is [prompt] or "
                             f"prompt[None, :]")
        if ndim == 1:
            raise ValueError("single 1-D prompt: pass prompt[None, :] for "
                             "static batching or [prompt] for continuous")
        if frontend_embeds is not None:
            raise ValueError("frontend models serve via the static path "
                             "(pass an equal-length (B, S) batch)")
        requests = [Request(rid=i, tokens=np.asarray(p, np.int32),
                            max_new_tokens=max_new_tokens)
                    for i, p in enumerate(prompts)]
        results, report = self.serve(requests, stream_cb=stream_cb)
        return [results[r.rid] for r in requests], report

    # -- static batching ----------------------------------------------------

    @torch.inference_mode()
    def _generate_static(self, prompts: np.ndarray, max_new_tokens: int,
                         frontend_embeds, stream_cb
                         ) -> Tuple[np.ndarray, kvcache.EngineReport]:
        if self.cfg.paged:
            raise ValueError(
                "paged caches serve through the continuous path: pass a "
                "list of prompts (or set CacheConfig.paged=False for the "
                "static batch path)")
        b, s = prompts.shape
        gen = self._generator()
        toks = torch.as_tensor(prompts.astype(np.int64), device=self.device)
        kw = {}
        if frontend_embeds is not None:
            kw["frontend_embeds"] = torch.as_tensor(frontend_embeds,
                                                    device=self.device)
        logits, prefilled = self.model.prefill_with_cache(
            self.dparams, toks, max_len=self.cfg.max_len, **kw)
        # the decode graph's caches take the prefilled rings (and an
        # encoder-decoder's memories, whose length the prefill fixed)
        mem = prefilled[0].get("cross")
        key, caches = self._pool_caches(
            b, None, 0 if mem is None else mem.k_bits.shape[2])
        for dst, src in zip(graphs_lib.cache_tensors(caches),
                            graphs_lib.cache_tensors(prefilled)):
            dst.copy_(src)
        del prefilled
        token = self._sample(logits, gen)
        out = [token.cpu().numpy()]
        if stream_cb:
            stream_cb(0, out[-1])
        for t in range(1, max_new_tokens):
            logits = self._decode_graph(key, caches)(tokens=out[-1])
            token = self._sample(logits[:, -1:], gen)
            out.append(token.cpu().numpy())
            if stream_cb:
                stream_cb(t, out[-1])
        report = kvcache.cache_report(caches, seq_len=s + max_new_tokens,
                                      batch=b)
        return np.concatenate(out, axis=1), report

    # -- continuous batching ------------------------------------------------

    @property
    def _ragged_ok(self) -> bool:
        """Speculative decode needs an attention-only stack: the verify
        scores candidates without writing state, which recurrent carries
        cannot do."""
        return _attention_only(self.model)

    def _resolve_draft(self) -> None:
        """The draft: the explicit independent one if given, else the
        first ``spec_draft_layers`` blocks of the trunk on its weights."""
        if self.draft_model is not None:
            if not _attention_only(self.draft_model):
                raise ValueError("speculative draft must be an attention-"
                                 "only decoder stack")
            return
        n = min(self.cfg.spec_draft_layers, self.model.cfg.num_layers)
        self.draft_model, self.draft_dparams = self.model.truncate_deploy(
            self.dparams, n)

    def _layer_rings(self, spec: PageSpec) -> List[Optional[int]]:
        """Per-layer logical ring length of the paged attention caches:
        the layer's window, or the capacity for full attention; None for
        a layer without attention (xLSTM cells).  Layers of one ring
        length form a ring group: one arena's bookkeeping and one device
        block table."""
        return [spec.ring_for(w) if kind in ("attn", "hybrid") else None
                for kind, w in self.model.plan]

    def _sync_tables(self, caches, arenas, rings) -> None:
        """Copy dirty host block tables into the device table of their ring
        group, in place (the layers of a group share that one tensor, and
        the captured steps read it at its fixed address)."""
        if not any(a.dirty for a in arenas.values()):
            return
        done = set()
        for c, ring in zip(caches, rings):
            if ring in arenas and ring not in done and \
                    isinstance(c.get("attn"), PagedKVCache):
                self._graphs.upload(c["attn"].block_table,
                                    arenas[ring].block_tables)
                done.add(ring)
        for a in arenas.values():
            a.dirty = False

    def _page_keys(self, toks: np.ndarray) -> List[bytes]:
        """Hash-cons keys of a prompt's FULL pages: key j is a chain digest
        over tokens[: (j+1) * page_size], the prefix that determines the
        page's words (equal keys => bitwise-equal pages)."""
        page = self.cfg.page_size
        h = hashlib.blake2b(digest_size=16)
        keys: List[bytes] = []
        toks = np.ascontiguousarray(toks, np.int32)
        for j in range(len(toks) // page):
            h.update(toks[j * page:(j + 1) * page].tobytes())
            keys.append(h.digest())
        return keys

    @staticmethod
    def _copy_pages(caches, rings, copies: Dict[int, List[Tuple[int, int]]]):
        """Copy-on-write payloads on the device, in place: page ``old``
        duplicates into ``new`` in every layer of the ring group.  Sources
        are gathered before the scatter; duplicate destinations keep the
        last writer (a COW page freed by a preemption in the same sweep
        can be handed to a later COW)."""
        for c, ring in zip(caches, rings):
            if ring in copies and isinstance(c.get("attn"), PagedKVCache):
                last = {new: old for old, new in copies[ring]}
                dev = c["attn"].k_pages.device
                news = torch.tensor(list(last.keys()), device=dev)
                olds = torch.tensor(list(last.values()), device=dev)
                pg = c["attn"]
                pg.k_pages[news] = pg.k_pages[olds]
                pg.vt_pages[news] = pg.vt_pages[olds]
        return caches

    @torch.inference_mode()
    def serve(self, requests: Sequence[Request], *,
              stream_cb: Optional[Callable] = None
              ) -> Tuple[Dict[int, np.ndarray], kvcache.EngineReport]:
        """Run the continuous-batching loop to completion; returns
        ({rid: generated tokens}, EngineReport).  Each iteration: host-side
        admission, paged growth (preempting when the arena runs dry) and
        the copy-on-write sweep, then ONE pooled forward, the unified
        chunk+decode forward while any prefill is in flight and the pooled
        decode (or speculative draft-verify-commit) step otherwise.
        Decoder-only token models only, as in the JAX package: frontend
        models and the encoder-decoder serve through the static path."""
        if (getattr(self.model.cfg, "frontend_tokens", 0)
                or not hasattr(self.model, "plan")):
            raise ValueError("continuous batching serves decoder-only "
                             "token models")
        spec = self.cfg.page_spec() if self.cfg.paged else None
        # full-attention layers cap a request at the ring (contiguous:
        # max_len) or the block-table capacity (paged): past it the ring
        # would wrap over the request's own oldest K/V.  Windowed layers
        # wrap by design (their ring is the window); recurrent carries
        # have no length.
        full_attn = any(k in ("attn", "hybrid") and not w
                        for k, w in self.model.plan)
        for r in requests:
            if len(r.tokens) == 0:
                raise ValueError(f"request {r.rid}: empty prompt "
                                 "(prefill needs at least one token)")
            if r.max_new_tokens <= 0:
                raise ValueError(f"request {r.rid}: max_new_tokens must "
                                 "be positive")
            if full_attn and len(r.tokens) + r.max_new_tokens > (
                    spec.capacity if spec else self.cfg.max_len):
                if spec:
                    raise ValueError(
                        f"request {r.rid}: prompt ({len(r.tokens)}) + "
                        f"budget ({r.max_new_tokens}) exceeds the paged "
                        f"capacity (max_blocks * page_size = "
                        f"{spec.capacity}); raise CacheConfig.max_blocks")
                raise ValueError(
                    f"request {r.rid}: prompt ({len(r.tokens)}) + budget "
                    f"({r.max_new_tokens}) exceeds the cache ring "
                    f"(max_len={self.cfg.max_len}); raise CacheConfig."
                    f"max_len")
        policy = (self._policy_proto if self._policy_proto is not None
                  else make_policy(self.cfg.policy))
        for r in requests:
            policy.add(r)
        pool = kvcache.SlotPool(max(1, min(self.cfg.num_slots,
                                           len(requests) or 1)))
        chunk = self.cfg.prefill_chunk
        # traffic clock and per-request latency stamps (keyed by rid, so
        # they survive preemption)
        t0 = time.perf_counter()
        metrics: Dict[int, Dict[str, Optional[float]]] = {
            r.rid: {"arrival": float(getattr(r, "arrival_s", 0.0)),
                    "first": None, "last": None}
            for r in requests}
        preempt_counts: Dict[str, int] = {}
        # speculative decode needs an attention-only stack
        spec_k = self.cfg.spec_decode if (self.cfg.spec_decode and
                                          self._ragged_ok) else None
        # positions a decode row may write per pure-decode iteration: the
        # pending token, plus the k drafted ones when speculating
        span = (spec_k + 1) if spec_k else 1
        arenas: Dict[int, kvcache.PageArena] = {}
        rings: List[Optional[int]] = []
        if spec:
            rings = self._layer_rings(spec)
            for ring in rings:
                if ring is None or ring in arenas:
                    continue
                arenas[ring] = kvcache.PageArena(
                    spec.arena_pages(ring, pool.num_slots), spec.page_size,
                    pool.num_slots, spec.blocks_for_ring(ring), ring)
        # the pool's caches, kept by the engine for its captured steps and
        # cleared as the JAX engine's fresh init_caches (recurrent
        # carries back to their init values)
        key, caches = self._pool_caches(pool.num_slots, spec)
        draft = None         # (key, caches) of the draft's ring pool
        if spec_k:
            self._resolve_draft()
            draft = self._draft_caches(
                pool.num_slots, spec.capacity if spec else self.cfg.max_len)
        for t in graphs_lib.cache_tensors(caches) + (
                graphs_lib.cache_tensors(draft[1]) if draft else []):
            t.zero_()
        self.model.reset_recurrent_rows(
            caches, torch.ones(pool.num_slots, dtype=torch.bool,
                               device=self.device))
        token_buf = np.zeros((pool.num_slots, 1), np.int32)
        states: Dict[int, _SlotState] = {}
        inflight: Dict[int, _PrefillState] = {}
        results: Dict[int, np.ndarray] = {}
        resumed: Dict[int, List[int]] = {}   # rid -> tokens before preempt
        gen = self._generator()
        prefill_batches = 0  # iterations that admitted >= 1 request
        prefill_chunks = 0   # chunk advances of chunk-split prompts
        preemptions = 0
        admit_seq = 0
        iterations = 0
        dispatches = 0       # pooled forwards run: one per iteration
        spec_steps = 0
        spec_slot_steps = 0  # (active slot, verify step) pairs
        spec_drafted = 0
        spec_accepted = 0
        peak_pages = 0       # simultaneous peak across all arenas

        def release_slot(slot: int) -> _SlotState:
            st = states.pop(slot)
            pool.release(slot)
            for arena in arenas.values():
                arena.release(slot)
            return st

        def retire(slot: int) -> None:
            st = release_slot(slot)
            results[st.request.rid] = np.asarray(st.generated, np.int32)

        def preempt(slot: int) -> None:
            """Evict a slot back to the queue (recompute on resume)."""
            victim = (states.get(slot) or inflight[slot]).request
            tenant = getattr(victim, "tenant", "default")
            preempt_counts[tenant] = preempt_counts.get(tenant, 0) + 1
            policy.on_preempt(victim)
            if slot in inflight:
                st = inflight.pop(slot)
                pool.release(slot)
                for arena in arenas.values():
                    arena.release(slot)
                if st.pre:
                    resumed[st.request.rid] = list(st.pre)
                policy.requeue(st.request)
                return
            dst = release_slot(slot)
            resumed[dst.request.rid] = list(dst.generated)
            policy.requeue(dst.request)

        def pick_victim() -> int:
            def keyf(s):
                stt = states.get(s) or inflight[s]
                freeable = sum(a.freeable_pages(s) for a in arenas.values())
                return policy.victim_key(stt.request, stt.admit_seq,
                                         freeable)
            return min(list(states) + list(inflight), key=keyf)

        def peak() -> None:
            nonlocal peak_pages
            peak_pages = max(peak_pages, sum(
                a.used_pages for a in arenas.values()))

        def slo_endangered() -> bool:
            """A decoding row with a TPOT budget has waited more than half
            of it since its last token (the adaptive-chunk trigger)."""
            now_s = time.perf_counter() - t0
            for st in states.values():
                slo = getattr(st.request, "slo", None)
                if slo is None or slo.tpot_s is None:
                    continue
                last = metrics[st.request.rid]["last"]
                if last is not None and now_s - last > 0.5 * slo.tpot_s:
                    return True
            return False

        def plan_width() -> int:
            """This iteration's unified chunk width: the configured chunk
            (policy-adjusted), else the power-of-two bucket covering the
            longest remaining prompt."""
            if chunk:
                return policy.chunk_width(chunk, slo_endangered())
            rem = max(len(st.toks) - st.done for st in inflight.values())
            return _pow2_bucket(rem)

        def emit(st: _SlotState, tok: int) -> bool:
            m = metrics[st.request.rid]
            now_s = time.perf_counter() - t0
            if m["first"] is None:
                m["first"] = now_s
            m["last"] = now_s
            policy.on_tokens(st.request, 1)
            if stream_cb:
                stream_cb(st.request.rid, len(st.generated), tok)
            return st.push(tok)

        while policy or pool.active_count:
            # -- admission: host bookkeeping only ------------------------
            admitted_any = False
            while policy and pool.free_count:
                now_s = time.perf_counter() - t0
                hint = chunk
                if not hint and inflight:
                    hint = _pow2_bucket(max(len(st.toks) - st.done
                                            for st in inflight.values()))
                req = policy.pop_admissible(now_s, hint)
                if req is None:
                    break
                pre = resumed.get(req.rid, [])
                plen = len(req.tokens) + len(pre)
                slot = pool.alloc(req.rid)
                if arenas and self.cfg.prefix_share:
                    keys = self._page_keys(np.concatenate(
                        [np.asarray(req.tokens, np.int32),
                         np.asarray(pre, np.int32)]))
                    for arena in arenas.values():
                        arena.set_prefix_keys(slot, keys, plen)
                # chunk-split prompts reserve their first chunk's pages;
                # whole prompts reserve prompt + the first decode write
                reserve = chunk if (chunk and plen > chunk) else plen + 1
                if arenas and not all(a.can_grow(slot, reserve)
                                      for a in arenas.values()):
                    for arena in arenas.values():
                        arena.release(slot)
                    pool.release(slot)
                    policy.requeue(req)       # no pages yet; retry later
                    break
                for arena in arenas.values():
                    arena.grow(slot, reserve)
                toks = np.concatenate(
                    [np.asarray(req.tokens, np.int32),
                     np.asarray(resumed.pop(req.rid, []), np.int32)])
                inflight[slot] = _PrefillState(req, toks, pre, admit_seq)
                policy.on_admit(req)
                admit_seq += 1
                admitted_any = True
            if admitted_any:
                prefill_batches += 1
            if not (states or inflight):
                # open-loop idle gap: sleep toward the next arrival
                nxt = policy.next_arrival_s()
                if nxt is not None:
                    gap = t0 + nxt - time.perf_counter()
                    if gap > 0:
                        time.sleep(min(gap, 0.005))
                continue
            # -- paged growth and the copy-on-write sweep; preempt on
            # exhaustion.  Prefill rows grow to their chunk's end (+ the
            # first decode write when it lands the prompt), decode rows by
            # the write span (1; k+1 on a speculative iteration), and every
            # shared page a decode write would diverge is copied first.
            # The width is planned once and shared with the forward below,
            # so growth covers exactly what it writes.
            width_now = plan_width() if inflight else 0
            if arenas:
                copies: Dict[int, List[Tuple[int, int]]] = {}
                while states or inflight:
                    ok = True
                    dspan = span if (spec_k and not inflight) else 1
                    for slot in sorted(set(states) | set(inflight)):
                        if slot in inflight:
                            ist = inflight[slot]
                            n = min(width_now, len(ist.toks) - ist.done)
                            final = ist.done + n == len(ist.toks)
                            target = ist.done + n + (1 if final else 0)
                        else:
                            target = states[slot].cache_len + dspan
                        if not all(a.grow(slot, target)
                                   for a in arenas.values()):
                            ok = False
                            break
                    if ok:
                        for ring, a in arenas.items():
                            for slot in sorted(states):
                                base = states[slot].cache_len
                                done_lp = set()
                                for pos in range(base, base + dspan):
                                    lp, page = a.write_page(slot, pos)
                                    if page == 0 or lp in done_lp:
                                        continue
                                    done_lp.add(lp)
                                    if a.refcount(page) > 1:
                                        if not a.can_cow():
                                            ok = False
                                            break
                                        copies.setdefault(ring, []).append(
                                            a.cow(slot, lp))
                                    elif a.page_key(page) is not None:
                                        a.invalidate_key(page)
                                if not ok:
                                    break
                            if not ok:
                                break
                    if ok:
                        break
                    preempt(pick_victim())
                    preemptions += 1
                if not (states or inflight):
                    continue
                if copies:
                    # before the forward writes anything: (old, new) are
                    # snapshots of the sweep-time page contents
                    self._copy_pages(caches, rings, copies)
                peak()
                self._sync_tables(caches, arenas, rings)
            # -- ONE pooled forward advances every in-flight stream ------
            if inflight:
                width = width_now
                toks_buf = np.zeros((pool.num_slots, width), np.int64)
                start_buf = np.zeros((pool.num_slots,), np.int64)
                valid_buf = np.zeros((pool.num_slots,), np.int64)
                fresh_buf = np.zeros((pool.num_slots,), np.int64)
                advance: Dict[int, int] = {}
                for slot in sorted(inflight):
                    ist = inflight[slot]
                    n = min(width, len(ist.toks) - ist.done)
                    toks_buf[slot, :n] = ist.toks[ist.done:ist.done + n]
                    start_buf[slot] = ist.done
                    valid_buf[slot] = n
                    fresh_buf[slot] = ist.done == 0
                    advance[slot] = n
                for slot in sorted(states):
                    toks_buf[slot, 0] = token_buf[slot, 0]
                    start_buf[slot] = states[slot].cache_len
                    valid_buf[slot] = 1
                logits = self._unified_graph(key, caches, width, draft)(
                    tokens=toks_buf, start=start_buf, valid=valid_buf,
                    fresh=fresh_buf)
                nxt_np = self._sample(logits, gen).cpu().numpy()
                iterations += 1
                dispatches += 1
                pool.tick(busy=len(states) + len(inflight))
                # decode rows first: a decoding slot's token streams before
                # the first token of a prefill landing its last chunk
                for slot in sorted(states):
                    st = states[slot]
                    st.cache_len += 1
                    tok = int(nxt_np[slot, 0])
                    token_buf[slot, 0] = tok
                    if emit(st, tok):
                        retire(slot)
                for slot in sorted(inflight):
                    ist = inflight[slot]
                    if chunk and len(ist.toks) > chunk:
                        prefill_chunks += 1
                    ist.done += advance[slot]
                    if ist.done < len(ist.toks):
                        continue
                    del inflight[slot]
                    sst = _SlotState(ist.request, self.cfg.eos_id,
                                     len(ist.toks), ist.admit_seq, ist.pre)
                    states[slot] = sst
                    tok = int(nxt_np[slot, 0])
                    token_buf[slot, 0] = tok
                    if emit(sst, tok):
                        retire(slot)
            elif spec_k:
                # pure-decode speculative iteration: draft k, verify k+1,
                # commit the accepted prefix, roll the draft back
                start_buf = np.zeros((pool.num_slots,), np.int64)
                active_buf = np.zeros((pool.num_slots,), np.int64)
                for slot in states:
                    start_buf[slot] = states[slot].cache_len
                    active_buf[slot] = 1
                inputs = dict(tokens=token_buf, start=start_buf,
                              active=active_buf)
                if self.cfg.sampler != "greedy":
                    inputs["rand"] = torch.randint(
                        0, 2 ** sampler_lib.UNIFORM_BITS,
                        (pool.num_slots, 2 * spec_k + 2), generator=gen,
                        device=self.device)
                res = self._spec_graph(key, caches, draft)(
                    **inputs).cpu().numpy()
                out_np, n_np = res[:, :spec_k + 1], res[:, spec_k + 1]
                iterations += 1
                dispatches += 1
                pool.tick(busy=len(states))
                token_buf = out_np[np.arange(pool.num_slots), n_np][:, None]
                spec_steps += 1
                spec_slot_steps += len(states)
                for slot in sorted(states):
                    st = states[slot]
                    n = int(n_np[slot])
                    spec_drafted += spec_k
                    spec_accepted += n
                    st.cache_len += n + 1
                    for i in range(n + 1):
                        if emit(st, int(out_np[slot, i])):
                            retire(slot)
                            break
                # the arena's rollback: pages grown for the candidate span
                # un-grow to the committed length (counted as rollback
                # frees, never as retirements)
                for slot in sorted(states):
                    for a in arenas.values():
                        a.truncate(slot, states[slot].cache_len)
            else:
                # pure-decode iteration: the pooled decode step
                logits = self._decode_graph(key, caches)(tokens=token_buf)
                toks = self._sample(logits[:, -1:], gen).cpu().numpy()
                iterations += 1
                dispatches += 1
                pool.tick(busy=len(states))
                token_buf = toks.copy()
                for slot in sorted(states):
                    st = states[slot]
                    st.cache_len += 1
                    if emit(st, int(toks[slot, 0])):
                        retire(slot)

        self.arenas = arenas
        report = kvcache.cache_report(
            caches,
            seq_len=spec.capacity if spec else self.cfg.max_len,
            batch=pool.num_slots,
            slot_lengths=kvcache.slot_lengths(caches),
            active=[s in states for s in range(pool.num_slots)],
            busy_slot_steps=pool.busy_slot_steps,
            decode_steps=pool.decode_steps,
            arenas=list(arenas.values()) if arenas else None,
            spec_drafted=spec_drafted if spec_k else None,
            spec_accepted=spec_accepted, spec_slot_steps=spec_slot_steps,
            iterations=iterations, dispatches=dispatches,
            compiles=dict(self._graphs.captures))
        report.prefill_batches = float(prefill_batches)
        report.prefill_chunks = float(prefill_chunks)
        report.requests = float(len(requests))
        report.spec_steps = float(spec_steps)
        report.preemptions = float(preemptions)
        if spec:
            # the per-step simultaneous peak the loop observed
            report.peak_page_utilization = (
                peak_pages / max(sum(a.num_pages
                                     for a in arenas.values()), 1))
            pb = 0.0
            for c, ring in zip(caches, rings):
                if ring is None or not isinstance(c.get("attn"),
                                                  PagedKVCache):
                    continue
                pg = c["attn"]
                per_page = 4 * (pg.k_pages[0].numel() +
                                pg.vt_pages[0].numel())
                pb += arenas[ring].peak_pages * per_page
            report.peak_page_bytes = float(pb)
        # -- traffic rollup: SLO attainment, goodput, per-tenant latency --
        elapsed_s = max(time.perf_counter() - t0, 1e-9)
        good_tokens = 0
        slo_met = 0
        tstats: Dict[str, Dict[str, object]] = {}
        for r in requests:
            m = metrics[r.rid]
            n = len(results.get(r.rid, ()))
            ttft = (m["first"] - m["arrival"]
                    if m["first"] is not None else None)
            tpot = ((m["last"] - m["first"]) / (n - 1)) if n > 1 else 0.0
            slo = getattr(r, "slo", None)
            ok = slo is None or slo.met(ttft, tpot)
            if ok:
                slo_met += 1
                good_tokens += n
            t = tstats.setdefault(getattr(r, "tenant", "default"), {
                "requests": 0.0, "tokens": 0.0, "slo_met": 0.0,
                "preemptions": 0.0, "_ttfts": []})
            t["requests"] += 1.0
            t["tokens"] += float(n)
            t["slo_met"] += 1.0 if ok else 0.0
            if ttft is not None:
                t["_ttfts"].append(ttft)
        all_ttfts: List[float] = []
        for tenant, t in tstats.items():
            t["preemptions"] = float(preempt_counts.get(tenant, 0))
            arr = t.pop("_ttfts")
            all_ttfts.extend(arr)
            t["ttft_p50_s"] = float(np.percentile(arr, 50)) if arr else None
            t["ttft_p99_s"] = float(np.percentile(arr, 99)) if arr else None
        report.elapsed_s = float(elapsed_s)
        report.goodput_under_slo = good_tokens / elapsed_s
        report.slo_attainment = slo_met / max(len(requests), 1)
        report.ttft_p50_s = (float(np.percentile(all_ttfts, 50))
                             if all_ttfts else None)
        report.ttft_p99_s = (float(np.percentile(all_ttfts, 99))
                             if all_ttfts else None)
        report.tenants = tstats
        return results, report
