"""Pooled binary KV-cache bookkeeping and the serving report (port of
``repro.serve.kvcache``).

The cache tensors live in the model layers (``KVCache`` rings or
``PagedKVCache`` page arenas, and the recurrent layers' carries,
``MambaCache`` / ``XLSTMCache``); a slot pool is those caches with
batch == num_slots plus the host-side bookkeeping here: ``SlotPool``
(which rows are live) and ``PageArena`` (refcounted pages, hash-consed
prompt-prefix keys, copy-on-write).  ``cache_report`` builds the typed
``EngineReport``.  The slot-surgery functions (``insert_slots``,
``extract_slots``, ``writeback_slots``, ``reset_slots``) move whole slots
of decode state between a pool and per-request caches; ``ServeEngine``
does not call them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.ssm import MambaCache, XLSTMCache

Caches = List[Dict[str, Any]]

_PACKED_FIELDS = ("k_bits", "vt_bits", "k_pages", "vt_pages")
_PARTS = (KVCache, PagedKVCache, MambaCache, XLSTMCache)


def _leaves(caches: Caches) -> Iterator[Tuple[str, int, int]]:
    """(field name, elements, bytes per element) of every cache leaf, the
    recurrent carries' too.  A paged cache's host-int ``ring_len`` counts
    as the 0-d int32 the JAX package holds."""
    for layer in caches:
        for part in layer.values():
            if not isinstance(part, _PARTS):
                raise TypeError(f"cannot size cache part {type(part)}")
            for name, t in zip(part._fields, part):
                if isinstance(t, torch.Tensor):
                    yield name, t.numel(), t.element_size()
                else:
                    yield name, 1, 4


def cache_bytes(caches: Caches) -> int:
    """Device bytes held by the caches (pages, rings, tables, lengths)."""
    return sum(n * size for _, n, size in _leaves(caches))


def bf16_equivalent_bytes(caches: Caches) -> int:
    """What the same caches would cost with bf16 K/V: a packed word holds
    32 values (64 bytes in bf16); other leaves count 2 bytes per element,
    as the JAX package counts them."""
    return sum(n * (64 if name in _PACKED_FIELDS else 2)
               for name, n, _ in _leaves(caches))


@dataclasses.dataclass
class EngineReport:
    """Typed serving report, the JAX package's schema field for field.

    A field is ``None`` when its feature did not run.  ``as_dict()``
    returns every field; the dict face (``report["key"]``, ``in``,
    ``get``, ``keys``, ``items``) treats ``None`` fields as absent keys.

    Field groups: memory (always set), slots, pages, spec, engine,
    traffic (see ``repro.serve.kvcache.EngineReport``).  In the port
    ``unified_compiles`` and ``engine_compiles`` count the engine's CUDA
    graph captures (``serve/graphs.py``) where the JAX package counts the
    XLA traces of its jitted steps: one per step kind and shape on both.
    """
    # memory (always set)
    total_bytes: float = 0.0
    bytes_per_token: float = 0.0
    bf16_equivalent_bytes: float = 0.0
    compression_vs_bf16: float = 0.0
    # slot pool
    slots_total: Optional[float] = None
    slots_active: Optional[float] = None
    occupancy: Optional[float] = None
    mean_slot_len: Optional[float] = None
    max_slot_len: Optional[float] = None
    decode_steps: Optional[float] = None
    slot_utilization: Optional[float] = None
    # page arena
    pages_total: Optional[float] = None
    pages_used: Optional[float] = None
    pages_free: Optional[float] = None
    page_utilization: Optional[float] = None
    peak_page_utilization: Optional[float] = None
    page_fragmentation: Optional[float] = None
    pages_reserved: Optional[float] = None
    pages_shared: Optional[float] = None
    prefix_lookups: Optional[float] = None
    prefix_hits: Optional[float] = None
    prefix_hit_rate: Optional[float] = None
    cow_copies: Optional[float] = None
    pages_freed_retire: Optional[float] = None
    pages_freed_rollback: Optional[float] = None
    peak_page_bytes: Optional[float] = None
    # speculative decode
    spec_drafted: Optional[float] = None
    spec_accepted: Optional[float] = None
    spec_accept_rate: Optional[float] = None
    spec_tokens_per_step: Optional[float] = None
    spec_steps: Optional[float] = None
    # engine loop
    iterations: Optional[float] = None
    dispatches_per_iteration: Optional[float] = None
    unified_compiles: Optional[float] = None
    engine_compiles: Optional[float] = None
    prefill_batches: Optional[float] = None
    prefill_chunks: Optional[float] = None
    requests: Optional[float] = None
    preemptions: Optional[float] = None
    # traffic / SLO
    elapsed_s: Optional[float] = None
    goodput_under_slo: Optional[float] = None
    slo_attainment: Optional[float] = None
    ttft_p50_s: Optional[float] = None
    ttft_p99_s: Optional[float] = None
    tenants: Optional[Dict[str, Dict[str, Any]]] = None

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    def as_dict(self) -> Dict[str, Any]:
        """Every field, ``None`` where the feature was off."""
        return {name: getattr(self, name) for name in self.field_names()}

    def __getitem__(self, key: str) -> Any:
        val = getattr(self, key) if key in self.field_names() else None
        if val is None:
            raise KeyError(key)
        return val

    def __setitem__(self, key: str, val: Any) -> None:
        if key not in self.field_names():
            raise KeyError(key)
        setattr(self, key, val)

    def __contains__(self, key: object) -> bool:
        return key in self.field_names() and getattr(self, key) is not None

    def get(self, key: str, default: Any = None) -> Any:
        val = getattr(self, key) if key in self.field_names() else None
        return default if val is None else val

    def keys(self) -> List[str]:
        return [k for k in self.field_names() if getattr(self, k) is not None]

    def items(self) -> Iterator[Tuple[str, Any]]:
        return ((k, getattr(self, k)) for k in self.keys())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())


def cache_report(caches: Caches, *, seq_len: int, batch: int,
                 slot_lengths: Optional[Sequence[int]] = None,
                 active: Optional[Sequence[bool]] = None,
                 busy_slot_steps: int = 0, decode_steps: int = 0,
                 arenas: Optional[Sequence["PageArena"]] = None,
                 spec_drafted: Optional[int] = None,
                 spec_accepted: int = 0, spec_slot_steps: int = 0,
                 iterations: Optional[int] = None,
                 dispatches: int = 0,
                 compiles: Optional[Dict[str, int]] = None) -> EngineReport:
    """Memory report, plus the slot group with ``slot_lengths``, the page
    group with ``arenas``, the spec group with ``spec_drafted`` (drafted
    tokens; ``spec_slot_steps`` counts (active slot, verify step) pairs)
    and the engine group with ``iterations`` (the
    semantics of every field are those of the JAX package's
    ``cache_report``; ``seq_len * batch`` is the nominal capacity behind
    ``bytes_per_token``).  ``compiles`` is the engine's captures by step
    kind (``unified``, ``decode``, ``spec``): ``unified_compiles`` counts
    the unified forward's, ``engine_compiles`` all of them."""
    total = cache_bytes(caches)
    bf16 = bf16_equivalent_bytes(caches)
    report = EngineReport(total_bytes=float(total),
                          bytes_per_token=float(total / max(seq_len * batch,
                                                            1)),
                          bf16_equivalent_bytes=float(bf16),
                          compression_vs_bf16=float(bf16) / max(total, 1))
    if slot_lengths is not None:
        lens = np.asarray(slot_lengths, np.int64)
        act = (np.asarray(active, bool) if active is not None
               else np.ones(len(lens), bool))
        report.slots_total = float(len(lens))
        report.slots_active = float(act.sum())
        report.occupancy = float(act.mean()) if len(lens) else 0.0
        report.mean_slot_len = float(lens[act].mean()) if act.any() else 0.0
        report.max_slot_len = float(lens[act].max()) if act.any() else 0.0
        report.decode_steps = float(decode_steps)
        report.slot_utilization = (
            busy_slot_steps / max(decode_steps * len(slot_lengths), 1))
    if arenas is not None:
        arenas = list(arenas)
        tot = sum(a.num_pages for a in arenas)
        used = sum(a.used_pages for a in arenas)
        peak = sum(a.peak_pages for a in arenas)
        report.pages_total = float(tot)
        report.pages_used = float(used)
        report.pages_free = float(tot - used)
        report.page_utilization = used / max(tot, 1)
        report.peak_page_utilization = peak / max(tot, 1)
        # internal fragmentation sampled at each arena's peak occupancy
        peak_alloc = sum(a.peak_pages * a.page_size for a in arenas)
        report.page_fragmentation = (
            sum(a.peak_frag * a.peak_pages * a.page_size for a in arenas)
            / max(peak_alloc, 1))
        # the trash page of each arena is bookkeeping, counted apart
        report.pages_reserved = float(len(arenas))
        report.pages_shared = float(sum(a.shared_pages for a in arenas))
        lookups = sum(a.prefix_lookups for a in arenas)
        hits = sum(a.share_hits for a in arenas)
        report.prefix_lookups = float(lookups)
        report.prefix_hits = float(hits)
        report.prefix_hit_rate = hits / max(lookups, 1)
        report.cow_copies = float(sum(a.cow_copies for a in arenas))
        report.pages_freed_retire = float(sum(a.retire_frees
                                              for a in arenas))
        report.pages_freed_rollback = float(sum(a.rollback_frees
                                                for a in arenas))
    if spec_drafted is not None:
        report.spec_drafted = float(spec_drafted)
        report.spec_accepted = float(spec_accepted)
        report.spec_accept_rate = spec_accepted / max(spec_drafted, 1)
        report.spec_tokens_per_step = (
            (spec_accepted + spec_slot_steps) / max(spec_slot_steps, 1))
    if iterations is not None:
        report.iterations = float(iterations)
        report.dispatches_per_iteration = dispatches / max(iterations, 1)
        compiles = compiles or {}
        report.unified_compiles = float(compiles.get("unified", 0))
        report.engine_compiles = float(sum(compiles.values()))
    return report


# -- slot-level cache surgery ---------------------------------------------
#
# A pool is the per-layer caches with batch == num_slots.  Each function
# takes the pool and updates it IN PLACE (the JAX package returns a new
# pool), so a captured graph that holds the pool's tensors sees the change;
# it returns the pool given.


def _slot_index(slots, part) -> torch.Tensor:
    """``slots`` as an index on the device of the cache ``part``."""
    return torch.as_tensor(slots, device=part[0].device).long()


def _parts(*pools: Caches) -> Iterator[Tuple[Any, ...]]:
    """The matching cache parts of each layer of ``pools``."""
    for layers in zip(*pools):
        for name in layers[0]:
            yield tuple(layer[name] for layer in layers)


def _insert_paged(pg: PagedKVCache, ring: KVCache,
                  idx: torch.Tensor) -> None:
    """Scatter per-request contiguous rings into a paged pool's pages.

    Ring slot s becomes logical slot s: page ``s // page_size``, offset
    ``s % page_size``, resolved through the pool's block-table rows at
    ``idx``.  So the ring is wrap-free (its slot s holds token s), or as
    long as the pool's ring group (a windowed layer's ring of the window,
    wrapped: both place token t at slot t % ring).  Positions past a
    slot's table (or past its mapped pages) go to the trash page 0."""
    n, _, w_r, _ = ring.k_bits.shape
    dev = pg.k_pages.device
    page = pg.k_pages.shape[2]
    nblk = pg.block_table.shape[1]
    bt = pg.block_table[idx].long()                          # (n, nblk)

    def pages_of(slot0: torch.Tensor) -> torch.Tensor:
        lp = slot0 // page
        beyond = lp >= nblk
        return torch.where(beyond[None], 0,
                           bt[:, torch.where(beyond, 0, lp)])
    s = torch.arange(w_r, device=dev)
    pg.k_pages[pages_of(s), :, (s % page).expand(n, w_r)] = \
        ring.k_bits.transpose(1, 2)
    # V^T words: ring word j covers slots 32j..32j+31, inside one page
    # (page_size % 32 == 0): page 32j // page, in-page word (32j % page)/32
    j32 = torch.arange(ring.vt_bits.shape[-1], device=dev) * packing.WORD
    pg.vt_pages[pages_of(j32), :, :,
                ((j32 % page) // packing.WORD).expand(n, -1)] = \
        ring.vt_bits.permute(0, 3, 1, 2)
    pg.length[idx] = ring.length.to(torch.int32)


def insert_slots(pool: Caches, seq_caches: Caches, slots) -> Caches:
    """Write per-request caches (leading batch n == len(slots), from a
    prefill: contiguous rings) into pool rows ``slots``.  A ring pool
    takes whole rows; a paged pool takes the rings page by page through
    its block-table rows (``_insert_paged``), which the caller mapped.
    Ring rows and recurrent carries are written row by row."""
    for p, s in _parts(pool, seq_caches):
        idx = _slot_index(slots, p)
        if isinstance(p, PagedKVCache):
            _insert_paged(p, s, idx)
        else:
            for dst, src in zip(p, s):
                dst[idx] = src.to(dst.dtype)
    return pool


def extract_slots(pool: Caches, slots) -> Caches:
    """The decode state of ``slots`` as a batch-n cache list, the read
    side of ``insert_slots``.  Ring rows are copied out; a paged cache
    keeps the pool's page arenas themselves (shared, not copied) with the
    rows' block tables and lengths, so a chunk prefill on the view writes
    straight into the pool's pages.  Recurrent carries are copied out as
    ring rows are.  ``writeback_slots`` commits it."""
    out = []
    for layer in pool:
        view = {}
        for name, p in layer.items():
            idx = _slot_index(slots, p)
            if isinstance(p, PagedKVCache):
                view[name] = p._replace(block_table=p.block_table[idx],
                                        length=p.length[idx])
            else:
                view[name] = type(p)(*[t[idx] for t in p])
        out.append(view)
    return out


def writeback_slots(pool: Caches, sub: Caches, slots) -> Caches:
    """Commit an ``extract_slots`` view back into the pool: ring rows and
    recurrent carries are written back; a paged cache takes the view's
    pages (the pool's own tensors when the view wrote in place) and the
    rows' lengths, while its block tables stay the pool's (the host's
    ``PageArena`` owns them)."""
    for p, s in _parts(pool, sub):
        idx = _slot_index(slots, p)
        if isinstance(p, PagedKVCache):
            for dst, src in ((p.k_pages, s.k_pages),
                             (p.vt_pages, s.vt_pages)):
                if src is not dst:
                    dst.copy_(src)
            p.length[idx] = s.length.to(torch.int32)
        else:
            for dst, src in zip(p, s):
                dst[idx] = src.to(dst.dtype)
    return pool


def reset_slots(pool: Caches, slots) -> Caches:
    """Zero the decode state of ``slots``: ring rows, lengths and
    recurrent carries (zeros, as the JAX package's, not the carries' init
    values: a slot's next request starts fresh through
    ``LMModel.reset_recurrent_rows``); a paged cache zeroes the rows'
    block tables (unmapping their pages, whose contents stay for the next
    owner to overwrite) and lengths."""
    for (p,) in _parts(pool):
        idx = _slot_index(slots, p)
        if isinstance(p, PagedKVCache):
            p.block_table[idx] = 0
            p.length[idx] = 0
        else:
            for t in p:
                t[idx] = 0
    return pool


def slot_lengths(caches: Caches) -> np.ndarray:
    """Per-slot token counts, read from the first layer's attention cache
    (every layer advances in lockstep); a stack without attention carries
    no position: zeros of the pool size, as the JAX package reports."""
    for layer in caches:
        if "attn" in layer:
            return layer["attn"].length.cpu().numpy()
    for layer in caches:
        for part in layer.values():
            return np.zeros((part[0].shape[0],), np.int32)
    return np.zeros((0,), np.int32)


class PageArena:
    """Refcounted free-list bookkeeping for one ring group's page arena
    (the JAX package's ``PageArena``, line for line).

    Layers sharing a logical ring length allocate in lockstep, so one
    arena's block tables mirror into every layer of the group.  Physical
    page ids are 1..num_pages; id 0 is the trash page.  Prefix sharing:
    pages carry refcounts and a hash-cons table from page keys (chain
    digests over the token prefix that produces a page's words) to pages;
    ``grow`` adopts a hash-consed page instead of allocating, ``cow``
    privatizes a shared page before a divergent write, and a page frees
    only when its last reader leaves.  ``dirty`` marks host tables that
    the device copies have not seen yet.
    """

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 num_blocks: int, ring_len: int):
        if num_pages < num_blocks:
            raise ValueError(
                f"arena of {num_pages} pages cannot back one full "
                f"sequence ({num_blocks} blocks) — admission would "
                f"deadlock")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_blocks = num_blocks
        self.ring_len = ring_len
        self._free: List[int] = list(range(num_pages, 0, -1))  # pop() -> 1,2..
        self.block_tables = np.zeros((num_slots, num_blocks), np.int32)
        self._counts = np.zeros((num_slots,), np.int64)
        self._lengths = np.zeros((num_slots,), np.int64)
        self._ref = np.zeros((num_pages + 1,), np.int64)
        self._key_page: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self._promises: Dict[int, List[bytes]] = {}
        self.share_hits = 0        # pages adopted instead of allocated
        self.prefix_lookups = 0    # prefix pages that tried the table
        self.cow_copies = 0
        self.retire_frees = 0      # frees by release (retire / preempt)
        self.rollback_frees = 0    # frees by truncate
        self.peak_pages = 0
        self.peak_frag = 0.0       # internal fragmentation at peak occupancy
        self.dirty = True

    # -- capacity ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def allocated_tokens(self) -> int:
        return self.used_pages * self.page_size

    @property
    def live_tokens(self) -> int:
        return int(np.minimum(self._lengths, self.ring_len).sum())

    @property
    def shared_pages(self) -> int:
        """Usable pages mapped by more than one slot (never the trash)."""
        return int((self._ref > 1).sum())

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def freeable_pages(self, slot: int) -> int:
        """Sole-owner pages that ``release(slot)`` would free now."""
        n = int(self._counts[slot])
        return sum(1 for lp in range(n)
                   if self._ref[int(self.block_tables[slot, lp])] == 1)

    def page_key(self, page: int) -> Optional[bytes]:
        return self._page_key.get(page)

    def blocks_for(self, length: int) -> int:
        """Logical pages holding ``length`` tokens (ring-capped)."""
        return -(-min(length, self.ring_len) // self.page_size)

    def set_prefix_keys(self, slot: int, keys: Sequence[bytes],
                        prompt_len: int) -> None:
        """Record ``slot``'s admission-time keys for its FULL prompt pages
        (only when the whole prompt fits the ring: a wrapped ring's pages
        no longer hold the pure prefix)."""
        if prompt_len <= self.ring_len:
            n = min(len(keys), prompt_len // self.page_size)
            self._promises[slot] = list(keys[:n])
        else:
            self._promises[slot] = []

    def _prefix_hits(self, slot: int, have: int, need: int) -> int:
        keys = self._promises.get(slot, ())
        return sum(1 for lp in range(have, min(need, len(keys)))
                   if keys[lp] in self._key_page)

    def can_grow(self, slot: int, length: int) -> bool:
        need = self.blocks_for(length)
        have = int(self._counts[slot])
        return (need - have - self._prefix_hits(slot, have, need)
                <= len(self._free))

    # -- alloc / free ------------------------------------------------------

    def _note_peak(self) -> None:
        if self.used_pages >= self.peak_pages:
            self.peak_pages = self.used_pages
            self.peak_frag = 1 - (self.live_tokens /
                                  max(self.allocated_tokens, 1))

    def grow(self, slot: int, length: int) -> bool:
        """Map pages covering ``length`` tokens for ``slot``, adopting
        hash-consed pages under its promises; False (mapping nothing) when
        the arena cannot satisfy it."""
        need = self.blocks_for(length)
        have = int(self._counts[slot])
        if not self.can_grow(slot, length):
            return False
        keys = self._promises.get(slot, ())
        for lp in range(have, need):
            key = keys[lp] if lp < len(keys) else None
            page = self._key_page.get(key) if key is not None else None
            if key is not None:
                self.prefix_lookups += 1
            if page is not None:
                self._ref[page] += 1
                self.share_hits += 1
            else:
                page = self._free.pop()
                self._ref[page] = 1
                if key is not None:
                    self._key_page[key] = page
                    self._page_key[page] = key
            self.block_tables[slot, lp] = page
        self._lengths[slot] = max(int(self._lengths[slot]), length)
        if need > have:
            self._counts[slot] = need
            self.dirty = True
            self._note_peak()
        return True

    def release(self, slot: int) -> None:
        """Drop ``slot``'s reference on every page and unmap its row; a
        page (and its key) frees with its last reader."""
        n = int(self._counts[slot])
        for lp in range(n):
            page = int(self.block_tables[slot, lp])
            self._ref[page] -= 1
            if self._ref[page] == 0:
                self._free.append(page)
                self.retire_frees += 1
                self.invalidate_key(page)
        if n:
            self.block_tables[slot, :n] = 0
            self.dirty = True
        self._counts[slot] = 0
        self._lengths[slot] = 0
        self._promises.pop(slot, None)

    def truncate(self, slot: int, length: int) -> int:
        """Un-grow ``slot`` to the pages covering ``length`` tokens; frees
        count as rollback frees.  Returns the pages freed."""
        need = self.blocks_for(length)
        have = int(self._counts[slot])
        freed = 0
        for lp in range(need, have):
            page = int(self.block_tables[slot, lp])
            self._ref[page] -= 1
            if self._ref[page] == 0:
                self._free.append(page)
                self.rollback_frees += 1
                freed += 1
                self.invalidate_key(page)
            self.block_tables[slot, lp] = 0
        if have > need:
            self._counts[slot] = need
            self.dirty = True
        self._lengths[slot] = min(int(self._lengths[slot]), length)
        return freed

    # -- copy-on-write -----------------------------------------------------

    def write_page(self, slot: int, pos: int) -> Tuple[int, int]:
        """(logical page, physical page) a decode write at ``pos`` hits."""
        lp = (pos % self.ring_len) // self.page_size
        return lp, int(self.block_tables[slot, lp])

    def can_cow(self) -> bool:
        return bool(self._free)

    def cow(self, slot: int, lp: int) -> Tuple[int, int]:
        """Move ``slot``'s logical page ``lp`` onto a fresh page; returns
        ``(old, new)`` for the device copy.  Caller checks ``can_cow``."""
        old = int(self.block_tables[slot, lp])
        new = self._free.pop()
        self._ref[old] -= 1
        self._ref[new] = 1
        self.block_tables[slot, lp] = new
        self.cow_copies += 1
        self.dirty = True
        self._note_peak()
        return old, new

    def invalidate_key(self, page: int) -> None:
        """Retire ``page``'s hash-cons key."""
        key = self._page_key.pop(page, None)
        if key is not None:
            self._key_page.pop(key, None)


class SlotPool:
    """Free-list bookkeeping over a pooled cache batch: which rows are
    live, which request owns each, and utilization counters."""

    def __init__(self, num_slots: int):
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        self.num_slots = num_slots
        self._free: List[int] = list(range(num_slots))[::-1]  # pop() -> 0,1,..
        self._owner: Dict[int, Any] = {}
        self.busy_slot_steps = 0
        self.decode_steps = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return len(self._owner)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self._owner)

    def owner(self, slot: int):
        return self._owner.get(slot)

    def alloc(self, rid) -> int:
        """Claim a free slot for request ``rid``; raises when full."""
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        slot = self._free.pop()
        self._owner[slot] = rid
        return slot

    def release(self, slot: int):
        """Free ``slot`` (reusable at once); returns the owning rid."""
        rid = self._owner.pop(slot)
        self._free.append(slot)
        return rid

    def tick(self, busy: Optional[int] = None) -> None:
        """Record one pooled step; ``busy`` overrides the busy-slot count."""
        self.decode_steps += 1
        self.busy_slot_steps += self.active_count if busy is None else busy

    @property
    def utilization(self) -> float:
        return self.busy_slot_steps / max(
            self.decode_steps * self.num_slots, 1)
