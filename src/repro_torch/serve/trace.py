"""Replayable open-loop traffic traces for the serving engine (port of
``repro.serve.trace``: numpy only; the same seed gives the same records and
byte-identical JSON as the JAX package).

A *trace* is a list of plain-dict request records — arrival offsets,
tenant labels, prompts, budgets and per-request SLOs — generated
deterministically from a seed and replayed open-loop: ``as_requests``
turns the records into ``repro_torch.serve.engine.Request`` objects whose
``arrival_s`` gates admission, so the engine sees requests arrive over
time instead of all-queued-upfront (the closed-loop toy the benchmark
used before).

Arrival process: Poisson by default (exponential inter-arrival gaps at
``arrival_rate`` requests/second) or heavy-tailed (Pareto gaps with
shape ``heavy_tail``, scaled to the same mean rate) — the bursty regime
where SLO-aware scheduling actually earns its keep: a Pareto burst piles
prompts onto the pool at once, and goodput under SLO separates policies
that raw throughput cannot.

Tenant mix: each request draws a tenant proportional to
``TenantSpec.weight``.  A tenant can carry a shared-system-prompt
population (``system_prompt_len`` tokens, ``system_prompts`` distinct
variants) — every request opens with one of the tenant's variants, which
is exactly the prefix-sharing workload (hash-consed pages collapse the
copies) and the COW-victim workload (evicting a sharer frees little).

Determinism: the same ``TraceConfig`` produces the same records, and
``to_json`` is canonical (sorted keys, fixed separators) — same seed =>
byte-identical JSON.  CI pins this, so a trace file IS a reproducible
benchmark input.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import SLO, Request

TraceRecord = Dict[str, Any]


@dataclasses.dataclass
class TenantSpec:
    """One traffic class in the mix.

    Attributes:
      name: tenant label (``Request.tenant``).
      weight: share of the request mix AND the fair-share quota weight
        the benchmark hands to ``PolicyConfig.quotas``.
      ttft_slo_s / tpot_slo_s: per-request SLO targets stamped on every
        request of this tenant (None = unconstrained).
      system_prompt_len: shared system-prompt prefix length in tokens
        (0 = none); make it a multiple of the page size so the whole
        prefix is shareable.
      system_prompts: number of DISTINCT system-prompt variants in this
        tenant's population (each request picks one uniformly).
      priority: ``Request.priority`` for every request of this tenant.
    """
    name: str
    weight: float = 1.0
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    system_prompt_len: int = 0
    system_prompts: int = 1
    priority: int = 0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"positive, got {self.weight}")
        if self.system_prompt_len < 0 or self.system_prompts < 1:
            raise ValueError(f"tenant {self.name!r}: bad system-prompt "
                             f"population")


@dataclasses.dataclass
class TraceConfig:
    """Knobs for ``generate_trace``.

    Attributes:
      n_requests: trace length.
      arrival_rate: mean arrivals per second.
      heavy_tail: Pareto shape for inter-arrival gaps (smaller = burstier;
        must be > 1 so the mean exists).  None = Poisson arrivals.
      mean_prompt / max_prompt: body length distribution (geometric-ish
        exponential, clipped to [1, max_prompt]); the tenant's system
        prompt is prepended ON TOP of the body.
      mean_new / max_new: per-request generation budget distribution.
      vocab: token id range for the synthetic prompts.
      tenants: the traffic mix (weights need not sum to 1).
      seed: RNG seed — same seed, same trace, byte-identical JSON.
    """
    n_requests: int = 32
    arrival_rate: float = 8.0
    heavy_tail: Optional[float] = None
    mean_prompt: int = 48
    max_prompt: int = 256
    mean_new: int = 12
    max_new: int = 64
    vocab: int = 256
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)
    seed: int = 0

    def __post_init__(self):
        if self.n_requests < 1 or self.arrival_rate <= 0:
            raise ValueError("need n_requests >= 1 and arrival_rate > 0")
        if self.heavy_tail is not None and self.heavy_tail <= 1:
            raise ValueError(f"heavy_tail (Pareto shape) must be > 1 for "
                             f"a finite mean gap, got {self.heavy_tail}")
        if not self.tenants:
            raise ValueError("need at least one TenantSpec")


def _gaps(cfg: TraceConfig, rng: np.random.Generator) -> np.ndarray:
    """Inter-arrival gaps with mean 1/arrival_rate: exponential
    (Poisson process) or Pareto (heavy-tailed bursts)."""
    mean_gap = 1.0 / cfg.arrival_rate
    if cfg.heavy_tail is None:
        return rng.exponential(mean_gap, cfg.n_requests)
    a = cfg.heavy_tail
    # Pareto(a, xm) has mean a*xm/(a-1); choose xm to hit mean_gap
    xm = mean_gap * (a - 1.0) / a
    return xm * (1.0 + rng.pareto(a, cfg.n_requests))


def generate_trace(cfg: TraceConfig) -> List[TraceRecord]:
    """Deterministically expand ``cfg`` into replayable request records.

    Each record carries: rid, tenant, arrival_s, prompt (token list,
    tenant system prompt prepended), max_new_tokens, priority,
    ttft_slo_s, tpot_slo_s.  Floats are rounded to microseconds so the
    canonical JSON is platform-stable."""
    rng = np.random.default_rng(cfg.seed)
    # per-tenant system-prompt variant populations, drawn up front so
    # the variants are stable regardless of the request mix
    pools: Dict[str, List[List[int]]] = {}
    for t in cfg.tenants:
        pools[t.name] = [
            rng.integers(0, cfg.vocab, t.system_prompt_len,
                         dtype=np.int64).tolist()
            for _ in range(t.system_prompts)]
    weights = np.asarray([t.weight for t in cfg.tenants], np.float64)
    weights = weights / weights.sum()
    arrivals = np.cumsum(_gaps(cfg, rng))
    arrivals -= arrivals[0]          # the trace opens at t = 0
    records: List[TraceRecord] = []
    for rid in range(cfg.n_requests):
        t = cfg.tenants[int(rng.choice(len(cfg.tenants), p=weights))]
        body_len = int(np.clip(rng.exponential(cfg.mean_prompt),
                               1, cfg.max_prompt))
        body = rng.integers(0, cfg.vocab, body_len, dtype=np.int64)
        sysp = pools[t.name][int(rng.integers(len(pools[t.name])))]
        new = int(np.clip(rng.exponential(cfg.mean_new), 1, cfg.max_new))
        records.append({
            "rid": rid,
            "tenant": t.name,
            "arrival_s": round(float(arrivals[rid]), 6),
            "prompt": list(sysp) + body.tolist(),
            "max_new_tokens": new,
            "priority": t.priority,
            "ttft_slo_s": t.ttft_slo_s,
            "tpot_slo_s": t.tpot_slo_s,
        })
    return records


def to_json(trace: Sequence[TraceRecord]) -> str:
    """Canonical JSON: sorted keys, fixed separators — the same trace
    always serializes to the same bytes (CI pins this)."""
    return json.dumps(list(trace), sort_keys=True,
                      separators=(",", ":"))


def from_json(text: str) -> List[TraceRecord]:
    """Inverse of ``to_json``."""
    return json.loads(text)


def as_requests(trace: Sequence[TraceRecord]) -> List[Request]:
    """Materialize trace records as engine ``Request``s (arrival-gated,
    SLO-stamped) for ``ServeEngine.serve``."""
    out: List[Request] = []
    for rec in trace:
        slo = None
        if (rec.get("ttft_slo_s") is not None or
                rec.get("tpot_slo_s") is not None):
            slo = SLO(ttft_s=rec.get("ttft_slo_s"),
                      tpot_s=rec.get("tpot_slo_s"))
        out.append(Request(
            rid=rec["rid"],
            tokens=np.asarray(rec["prompt"], np.int32),
            max_new_tokens=rec["max_new_tokens"],
            priority=rec.get("priority", 0),
            tenant=rec.get("tenant", "default"),
            arrival_s=float(rec.get("arrival_s", 0.0)),
            slo=slo))
    return out
