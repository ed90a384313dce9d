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
statistics.  The caches are updated in place, so the port has no jit and
no buffer donation.

Speculative decode (``SpecConfig.k``) and the flat ``ServeConfig``
keywords are not ported yet.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.attention import PagedKVCache, PageSpec
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
    """Speculative-decode knobs (``ServeConfig.spec``), kept for equality
    with the JAX config.  ``k`` set makes ``serve`` raise: speculative
    decode is not ported yet."""
    k: Optional[int] = None
    draft_layers: int = 1

    def __post_init__(self):
        if self.k is not None and self.k < 1:
            raise ValueError(f"spec_decode must draft at least one token "
                             f"per step, got {self.k}")
        if self.k is not None and self.draft_layers < 1:
            raise ValueError(f"spec_draft_layers must be >= 1, got "
                             f"{self.draft_layers}")


class ServeConfig:
    """Engine-level serving knobs, grouped as in the JAX package.

    sampler / temperature / top_k / seed: token sampling (greedy |
      temperature | top_k; ``seed`` seeds a ``torch.Generator``).
    num_slots: continuous-batching pool size.
    eos_id: default retirement token (``Request.eos_id`` overrides).
    cache: ``CacheConfig``; spec: ``SpecConfig``; policy: ``PolicyConfig``.

    The JAX package's deprecated flat keywords (``max_len=``,
    ``paged=``, ...) are not ported yet; the read-through properties
    (``cfg.max_len``, ``cfg.paged``, ...) are.
    """

    def __init__(self, *, sampler: str = "greedy",
                 temperature: float = 1.0, top_k: int = 40, seed: int = 0,
                 num_slots: int = 4, eos_id: Optional[int] = None,
                 cache: Optional[CacheConfig] = None,
                 spec: Optional[SpecConfig] = None,
                 policy: Optional[PolicyConfig] = None, **flat):
        if flat:
            raise NotImplementedError(
                f"flat ServeConfig keywords {sorted(flat)} are not ported "
                f"yet: pass cache=CacheConfig(...), spec=SpecConfig(...) "
                f"and/or policy=PolicyConfig(...)")
        self.sampler = sampler
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.num_slots = num_slots
        self.eos_id = eos_id
        self.cache = cache if cache is not None else CacheConfig()
        self.spec = spec if spec is not None else SpecConfig()
        self.policy = policy if policy is not None else PolicyConfig()

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


class ServeEngine:
    def __init__(self, model, dparams, cfg: ServeConfig, *,
                 policy: Optional[SchedulingPolicy] = None, device="cuda"):
        """``dparams`` must already lie on ``device`` (CUDA by default;
        asking for CUDA without a card raises).  ``policy`` optionally
        injects a ``SchedulingPolicy`` reused across ``serve`` calls;
        by default each call builds one from ``cfg.policy``."""
        self.model = model
        self.dparams = dparams
        self.cfg = cfg
        self.device = resolve_device(device)
        self._policy_proto = policy
        self._sample = {
            "greedy": lambda lg, g: sampler_lib.greedy(lg),
            "temperature": lambda lg, g: sampler_lib.temperature(
                lg, g, cfg.temperature),
            "top_k": lambda lg, g: sampler_lib.top_k(
                lg, g, cfg.top_k, cfg.temperature),
        }[cfg.sampler]

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.cfg.seed)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- public API ---------------------------------------------------------

    def generate(self, prompts, *, max_new_tokens: int,
                 stream_cb: Optional[Callable] = None):
        """A (B, S) array of prompts -> static batching: (tokens (B,
        max_new_tokens) int32 numpy, EngineReport), ``stream_cb(step,
        tokens)`` after the prefill and every decode step.

        A list of 1-D prompts -> continuous batching over the slot pool:
        (list of per-prompt token arrays, EngineReport), ``stream_cb(rid,
        index, token)`` per token."""
        ndim = getattr(prompts, "ndim", None)
        if ndim == 2:
            return self._generate_static(np.asarray(prompts),
                                         max_new_tokens, stream_cb)
        if ndim is not None and ndim != 1:
            raise ValueError(f"prompts array must be (B, S), got "
                             f"{ndim}-D; a single prompt is [prompt] or "
                             f"prompt[None, :]")
        if ndim == 1:
            raise ValueError("single 1-D prompt: pass prompt[None, :] for "
                             "static batching or [prompt] for continuous")
        requests = [Request(rid=i, tokens=np.asarray(p, np.int32),
                            max_new_tokens=max_new_tokens)
                    for i, p in enumerate(prompts)]
        results, report = self.serve(requests, stream_cb=stream_cb)
        return [results[r.rid] for r in requests], report

    # -- static batching ----------------------------------------------------

    @torch.inference_mode()
    def _generate_static(self, prompts: np.ndarray, max_new_tokens: int,
                         stream_cb) -> Tuple[np.ndarray,
                                             kvcache.EngineReport]:
        if self.cfg.paged:
            raise ValueError(
                "paged caches serve through the continuous path: pass a "
                "list of prompts (or set CacheConfig.paged=False for the "
                "static batch path)")
        b, s = prompts.shape
        gen = self._generator()
        toks = self._tensor(prompts.astype(np.int64))
        logits, caches = self.model.prefill_with_cache(
            self.dparams, toks, max_len=self.cfg.max_len)
        token = self._sample(logits, gen)
        out = [token.cpu().numpy()]
        if stream_cb:
            stream_cb(0, out[-1])
        for t in range(1, max_new_tokens):
            logits, caches = self.model.decode_step(self.dparams, token,
                                                    caches)
            token = self._sample(logits[:, -1:], gen)
            out.append(token.cpu().numpy())
            if stream_cb:
                stream_cb(t, out[-1])
        report = kvcache.cache_report(caches, seq_len=s + max_new_tokens,
                                      batch=b)
        return np.concatenate(out, axis=1), report

    # -- continuous batching ------------------------------------------------

    def _layer_rings(self, spec: PageSpec) -> List[Optional[int]]:
        """Per-layer logical ring length of the paged attention caches
        (every ported block is full attention)."""
        return [spec.ring_for(0)] * self.model.cfg.num_layers

    def _sync_tables(self, caches, arenas, rings):
        """Push dirty host block tables to the device, once per ring group:
        the layers of a group share one device copy (the port passes no
        buffers through a jit, so nothing forbids the sharing)."""
        if not any(a.dirty for a in arenas.values()):
            return caches
        tables = {ring: self._tensor(a.block_tables)
                  for ring, a in arenas.items()}
        out = []
        for c, ring in zip(caches, rings):
            if ring is not None and isinstance(c.get("attn"), PagedKVCache):
                c = dict(c, attn=c["attn"]._replace(block_table=tables[ring]))
            out.append(c)
        for a in arenas.values():
            a.dirty = False
        return out

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
        decode step otherwise."""
        if self.cfg.spec_decode:
            raise NotImplementedError(
                "speculative decode (SpecConfig.k) is not ported yet")
        spec = self.cfg.page_spec() if self.cfg.paged else None
        for r in requests:
            if len(r.tokens) == 0:
                raise ValueError(f"request {r.rid}: empty prompt "
                                 "(prefill needs at least one token)")
            if r.max_new_tokens <= 0:
                raise ValueError(f"request {r.rid}: max_new_tokens must "
                                 "be positive")
            if len(r.tokens) + r.max_new_tokens > (
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
        caches = self.model.init_caches(pool.num_slots, self.cfg.max_len,
                                        self.device, paged=spec)
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
            # exhaustion.  The width is planned once and shared with the
            # forward below, so growth covers exactly what it writes.
            width_now = plan_width() if inflight else 0
            if arenas:
                copies: Dict[int, List[Tuple[int, int]]] = {}
                while states or inflight:
                    ok = True
                    for slot in sorted(set(states) | set(inflight)):
                        if slot in inflight:
                            ist = inflight[slot]
                            n = min(width_now, len(ist.toks) - ist.done)
                            final = ist.done + n == len(ist.toks)
                            target = ist.done + n + (1 if final else 0)
                        else:
                            target = states[slot].cache_len + 1
                        if not all(a.grow(slot, target)
                                   for a in arenas.values()):
                            ok = False
                            break
                    if ok:
                        for ring, a in arenas.items():
                            for slot in sorted(states):
                                lp, page = a.write_page(
                                    slot, states[slot].cache_len)
                                if page == 0:
                                    continue
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
                    if ok:
                        break
                    preempt(pick_victim())
                    preemptions += 1
                if not (states or inflight):
                    continue
                if copies:
                    # before the forward writes anything: (old, new) are
                    # snapshots of the sweep-time page contents
                    caches = self._copy_pages(caches, rings, copies)
                peak()
                caches = self._sync_tables(caches, arenas, rings)
            # -- ONE pooled forward advances every in-flight stream ------
            if inflight:
                width = width_now
                toks_buf = np.zeros((pool.num_slots, width), np.int32)
                start_buf = np.zeros((pool.num_slots,), np.int32)
                valid_buf = np.zeros((pool.num_slots,), np.int32)
                fresh_buf = np.zeros((pool.num_slots,), bool)
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
                caches = self.model.reset_recurrent_rows(
                    caches, self._tensor(fresh_buf))
                logits, caches = self.model.prefill_with_cache(
                    self.dparams, self._tensor(toks_buf.astype(np.int64)),
                    caches=caches, start=self._tensor(start_buf),
                    seq_lens=self._tensor(valid_buf))
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
            else:
                # pure-decode iteration: the pooled decode step
                logits, caches = self.model.decode_step(
                    self.dparams, self._tensor(token_buf.astype(np.int64)),
                    caches)
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

        report = kvcache.cache_report(
            caches,
            seq_len=spec.capacity if spec else self.cfg.max_len,
            batch=pool.num_slots,
            slot_lengths=kvcache.slot_lengths(caches),
            active=[s in states for s in range(pool.num_slots)],
            busy_slot_steps=pool.busy_slot_steps,
            decode_steps=pool.decode_steps,
            arenas=list(arenas.values()) if arenas else None,
            iterations=iterations, dispatches=dispatches)
        report.prefill_batches = float(prefill_batches)
        report.prefill_chunks = float(prefill_chunks)
        report.requests = float(len(requests))
        report.spec_steps = 0.0
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
