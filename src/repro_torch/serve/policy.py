"""Pluggable scheduling policies for the continuous-batching engine (port
of ``repro.serve.policy``: pure Python, the same decisions in the same
order).

The engine loop (repro_torch.serve.engine) stays policy-agnostic: each
iteration it asks ONE ``SchedulingPolicy`` object

  which queued request to admit next   ``pop_admissible`` — the open-loop
      arrival gate lives here too: a request whose ``arrival_s`` is still
      in the future is invisible until the engine clock reaches it,
  which slot to preempt                ``victim_key`` — when the page
      arena runs dry the engine evicts the slot minimizing this key,
  how wide to chunk this iteration     ``chunk_width`` — the TTFT/TPOT
      adaptive-chunk hook: shrink the prefill chunk when decode rows are
      SLO-endangered so their next token lands sooner,

and reports back what happened (``on_admit`` / ``on_tokens`` /
``on_preempt``) so stateful policies can keep fairness accounts.

Three concrete policies ship:

  fifo   the priority heap order — highest priority first, FIFO within the
         class, preempted requests resume at the head of their class.
         The default; byte-identical scheduling to the pre-policy engine.
  wave   prompt-length-aware wave packing: among the arrived requests of
         the top priority class, prefer one whose power-of-two prompt
         bucket fits the width the unified step is already planning this
         iteration (``width_hint``), so admissions ride existing compile
         buckets instead of widening the wave.  Falls back to FIFO when
         nothing fits (and degenerates to FIFO under chunked prefill,
         where every chunk already fits the fixed width).
  quota  per-tenant token quotas with fair-share preemption: tenants
         carry weights (``PolicyConfig.quotas``); admission picks the
         arrived top-class request of the tenant with the LOWEST
         served-tokens/weight ratio (deficit fair-share), and preemption
         prefers victims from the MOST over-served tenant.

``PolicyConfig.cow_victims`` refines ANY policy's victim choice using the
refcount stats the page arena already keeps: among equal-priority
candidates, prefer the slot whose eviction returns the most pages to the
free list right now (sole-owner pages only — shared prefix pages stay
with their other readers, so evicting a COW-heavy slot frees little).

The ``Scheduler`` heap lives here (moved from engine.py, which re-exports
it) so policies and the queue share one module with no import cycle.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.packing import WORD


def _pow2_bucket(n: int, lo: int = 16) -> int:
    """Smallest power of two >= n (>= lo) — the unified-step width
    buckets that bound compile count to O(log max_prompt)."""
    b = lo
    while b < n:
        b <<= 1
    return b


@dataclasses.dataclass
class PolicyConfig:
    """Traffic-policy knobs, grouped on ``ServeConfig.policy``.

    Attributes:
      kind: scheduling policy — ``fifo`` (priority heap, the default),
        ``wave`` (prompt-length-aware wave packing) or ``quota``
        (per-tenant deficit fair-share).
      prefill_chunk: chunked/streamed prefill width in tokens (None =
        whole prompts load in one unified iteration).  Must be a
        positive multiple of 32 (the uint32 packing word, so chunk
        boundaries never straddle a V^T word).  Prompts longer than the
        chunk stream one chunk per engine iteration THROUGH the pooled
        unified forward, fused with the decode rows.
      adaptive_chunk: TTFT/TPOT-SLO-driven chunk width — when any decode
        row is SLO-endangered (time since its last token exceeds half
        its ``SLO.tpot_s`` budget) the iteration's prefill chunk shrinks
        to ``min_chunk`` so the decode rows' next tokens land sooner.
        Only two widths ever trace (``prefill_chunk`` and ``min_chunk``),
        so the compile bound is unchanged.  Requires ``prefill_chunk``.
      min_chunk: the adaptive floor; positive multiple of 32, no wider
        than ``prefill_chunk``.
      quotas: tenant name -> weight for ``kind="quota"`` (fair share is
        proportional to weight; unlisted tenants weigh 1.0).
      cow_victims: refine preemption using PageArena refcounts — among
        equal-priority victims prefer the slot whose eviction frees the
        most sole-owner pages (COW-heavy / share-light slots go first).
    """
    kind: str = "fifo"
    prefill_chunk: Optional[int] = None
    adaptive_chunk: bool = False
    min_chunk: int = 32
    quotas: Optional[Dict[str, float]] = None
    cow_victims: bool = False

    def __post_init__(self):
        if self.kind not in ("fifo", "wave", "quota"):
            raise ValueError(f"unknown policy kind {self.kind!r}: "
                             f"expected fifo | wave | quota")
        if self.prefill_chunk is not None and (
                self.prefill_chunk <= 0 or
                self.prefill_chunk % WORD):
            raise ValueError(
                f"prefill_chunk must be a positive multiple of the "
                f"packing word ({WORD}), got {self.prefill_chunk}")
        if self.min_chunk <= 0 or self.min_chunk % WORD:
            raise ValueError(
                f"min_chunk must be a positive multiple of the packing "
                f"word ({WORD}), got {self.min_chunk}")
        if self.adaptive_chunk and self.prefill_chunk is None:
            raise ValueError("adaptive_chunk needs prefill_chunk set "
                             "(there is no width to shrink otherwise)")
        if self.quotas is not None:
            for tenant, w in self.quotas.items():
                if w <= 0:
                    raise ValueError(f"quota weight for tenant "
                                     f"{tenant!r} must be positive, "
                                     f"got {w}")


class Scheduler:
    """Priority admission queue (FIFO within a priority class).

    ``pop`` returns the highest-priority request, oldest first among ties
    — with the default priority 0 everywhere this is plain FIFO.
    ``requeue`` reinserts a preempted request at the head of its class so
    it resumes before newer peers (the most recently requeued first).
    Fairness/wave-packing policies slot in here without touching the
    engine loop (see ``SchedulingPolicy``).

    Implementation: a heap on ``(-priority, arrival_seq)`` — ``pop`` is
    O(log n) instead of the old full-deque scan the engine paid on every
    step.  ``add`` draws increasing sequence numbers (FIFO within class);
    ``requeue`` draws decreasing ones (ahead of every queued peer, and of
    any earlier requeue)."""

    def __init__(self, requests: Sequence = ()):
        self._heap: List[Tuple[int, int, object]] = []
        self._seq = 0        # add(): increasing (FIFO within class)
        self._front = 0      # requeue(): decreasing (before peers)
        for r in requests:
            self.add(r)

    def add(self, request) -> None:
        """Enqueue a request behind its priority-class peers."""
        self._seq += 1
        heapq.heappush(self._heap, (-request.priority, self._seq, request))

    def requeue(self, request) -> None:
        """Reinsert a preempted request ahead of its priority-class
        peers so it resumes before newer work."""
        self._front -= 1
        heapq.heappush(self._heap, (-request.priority, self._front,
                                    request))

    def pop(self):
        """Remove and return the next request (highest priority, FIFO
        within the class)."""
        return heapq.heappop(self._heap)[2]

    def _drain(self) -> List[Tuple[int, int, object]]:
        """Take every (key, seq, request) entry out of the heap —
        policies filter/select over them, then ``_refill`` the rest with
        their ORIGINAL keys so heap order (requeue precedence included)
        is preserved exactly."""
        entries, self._heap = self._heap, []
        return entries

    def _refill(self, entries: Sequence[Tuple[int, int, object]]) -> None:
        self._heap = list(entries)
        heapq.heapify(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


class SchedulingPolicy:
    """The engine's traffic-policy surface (default: FIFO/priority).

    Wraps the ``Scheduler`` heap and adds the hooks the serve loop calls;
    subclasses override ``_select`` (admission order within the arrived
    top-priority class) and/or ``victim_key`` (preemption order).  One
    policy instance drives one ``serve()`` call at a time."""

    def __init__(self, cfg: Optional[PolicyConfig] = None):
        self.cfg = cfg if cfg is not None else PolicyConfig()
        self._sched = Scheduler()

    # -- queue face ---------------------------------------------------------

    def add(self, request) -> None:
        self._sched.add(request)

    def requeue(self, request) -> None:
        self._sched.requeue(request)

    def __len__(self) -> int:
        return len(self._sched)

    def __bool__(self) -> bool:
        return bool(self._sched)

    # -- admission ----------------------------------------------------------

    def next_arrival_s(self) -> Optional[float]:
        """Earliest ``arrival_s`` among queued requests (None when the
        queue is empty) — the engine sleeps toward it when the pool has
        nothing to run (open-loop idle gap)."""
        if not self._sched._heap:
            return None
        return min(getattr(e[2], "arrival_s", 0.0)
                   for e in self._sched._heap)

    def pop_admissible(self, now_s: float,
                       width_hint: Optional[int] = None):
        """Pop the next request to admit at engine-clock ``now_s``.

        Only requests whose ``arrival_s`` has passed are candidates (the
        open-loop gate); among those, the top priority class is selected
        and ``_select`` picks within it.  Returns None when nothing has
        arrived yet.  Unpicked entries keep their original heap keys, so
        requeue precedence and FIFO order survive intact."""
        entries = self._sched._drain()
        arrived = [e for e in entries
                   if getattr(e[2], "arrival_s", 0.0) <= now_s]
        if not arrived:
            self._sched._refill(entries)
            return None
        top = min(e[0] for e in arrived)          # key is -priority
        cands = [e for e in arrived if e[0] == top]
        pick = self._select(cands, width_hint)
        self._sched._refill([e for e in entries if e is not pick])
        return pick[2]

    def _select(self, cands: List[Tuple[int, int, object]],
                width_hint: Optional[int]):
        """Pick one entry from the arrived top-priority class.  Default:
        lowest sequence number — FIFO, requeues first."""
        return min(cands, key=lambda e: e[1])

    # -- accounting hooks ---------------------------------------------------

    def on_admit(self, request) -> None:
        """A request entered a slot (fresh admission or resume)."""

    def on_tokens(self, request, n: int) -> None:
        """``n`` generated tokens streamed for ``request``."""

    def on_preempt(self, request) -> None:
        """A slot was evicted back to the queue."""

    # -- preemption ---------------------------------------------------------

    def victim_key(self, request, admit_seq: int,
                   freeable_pages: int) -> Tuple:
        """Preemption order: the slot minimizing this key is evicted.
        Default matches the pre-policy engine exactly — lowest priority
        first, most recently admitted among ties.  ``cow_victims``
        inserts the arena's sole-owner page count so COW-heavy slots
        (whose eviction actually returns pages) go first."""
        if self.cfg.cow_victims:
            return (request.priority, -freeable_pages, -admit_seq)
        return (request.priority, -admit_seq)

    # -- adaptive chunk ------------------------------------------------------

    def chunk_width(self, base: Optional[int],
                    endangered: bool) -> Optional[int]:
        """Prefill chunk width for this iteration.  With
        ``adaptive_chunk``, an SLO-endangered decode row shrinks the
        chunk to ``min_chunk`` so the pooled forward returns (and the
        endangered row's next token lands) sooner; only the two widths
        ever trace."""
        if base is None or not self.cfg.adaptive_chunk or not endangered:
            return base
        return min(base, self.cfg.min_chunk)


class WavePackingPolicy(SchedulingPolicy):
    """Prompt-length-aware wave packing (``kind="wave"``).

    The unified step pads every admitted prompt to a power-of-two width
    bucket; admitting a long prompt into a short wave widens the bucket
    for everyone.  Within the arrived top-priority class this policy
    prefers requests whose bucket FITS the iteration's planned width
    (``width_hint``) — they pad into the already-planned dispatch for
    free — falling back to plain FIFO when nothing fits (never starves:
    the FIFO head is admitted and the wave widens to cover it)."""

    def _select(self, cands, width_hint):
        if width_hint:
            fits = [e for e in cands
                    if _pow2_bucket(len(e[2].tokens)) <= width_hint]
            if fits:
                return min(fits, key=lambda e: e[1])
        return min(cands, key=lambda e: e[1])


class QuotaPolicy(SchedulingPolicy):
    """Per-tenant deficit fair-share (``kind="quota"``).

    Each tenant's *deficit* is served tokens / quota weight
    (``PolicyConfig.quotas``; unlisted tenants weigh 1.0).  Admission
    picks the arrived top-priority request of the lowest-deficit tenant
    (FIFO within the tenant), so over time token grants converge to the
    weight proportions whenever every tenant has queued work — and a
    tenant with no queued work cedes its share instead of banking it.
    Preemption inverts the rule: victims come from the MOST over-served
    tenant first (then the ``cow_victims`` refinement, then most recently
    admitted)."""

    def __init__(self, cfg: Optional[PolicyConfig] = None):
        super().__init__(cfg)
        self.served: Dict[str, int] = {}   # tenant -> granted tokens

    def _weight(self, tenant: str) -> float:
        quotas = self.cfg.quotas or {}
        return float(quotas.get(tenant, 1.0))

    def deficit(self, tenant: str) -> float:
        """Served tokens normalized by weight — lower = more underserved."""
        return self.served.get(tenant, 0) / self._weight(tenant)

    def on_tokens(self, request, n: int) -> None:
        tenant = getattr(request, "tenant", "default")
        self.served[tenant] = self.served.get(tenant, 0) + n

    def _select(self, cands, width_hint):
        return min(cands, key=lambda e: (
            self.deficit(getattr(e[2], "tenant", "default")), e[1]))

    def victim_key(self, request, admit_seq, freeable_pages):
        tail = ((-freeable_pages, -admit_seq) if self.cfg.cow_victims
                else (-admit_seq,))
        return (request.priority,
                -self.deficit(getattr(request, "tenant", "default"))) + tail


def make_policy(cfg: Optional[PolicyConfig] = None) -> SchedulingPolicy:
    """Instantiate the policy ``cfg.kind`` names (fresh queue state)."""
    cfg = cfg if cfg is not None else PolicyConfig()
    cls = {"fifo": SchedulingPolicy, "wave": WavePackingPolicy,
           "quota": QuotaPolicy}[cfg.kind]
    return cls(cfg)
