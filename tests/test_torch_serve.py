"""Port parity of continuous serving, on the CPU: the host-side
bookkeeping (``PageArena``, ``SlotPool``, the scheduling policies, the
copy-on-write page copy), the trace generator, the config and report
schemas, and ``ServeEngine.serve`` against the JAX engine on the smoke
config (greedy, every arrival at 0, so the schedule depends on tokens
only): contiguous continuous batching, and a paged pool with prefix
sharing, chunked prefill and an arena small enough to preempt."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.attention import PagedKVCache as JPaged
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro.serve import kvcache as jkv
from repro.serve import policy as jpolicy
from repro.serve import trace as jtrace
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models import attention as tattention
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import policy as tpolicy
from repro_torch.serve import trace as ttrace

TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")


def _arena_state(a):
    return (a.block_tables.tolist(), a._ref.tolist(), list(a._free),
            a._counts.tolist(), a._lengths.tolist(), dict(a._key_page),
            a.share_hits, a.prefix_lookups, a.cow_copies, a.retire_frees,
            a.rollback_frees, a.peak_pages, a.peak_frag, a.used_pages,
            a.shared_pages, a.live_tokens, a.dirty)


def test_page_arena_scripted_states_equal_jax():
    """One scripted run of grows, shared prefixes, copy-on-write, key
    retirement, truncation and releases: both arenas answer and end every
    step in the same state."""
    arenas = [m.PageArena(8, 32, 3, 4, 128) for m in (jkv, tkv)]
    keys = [bytes([i]) * 16 for i in range(4)]
    script = [
        ("set_prefix_keys", 0, keys[:3], 100), ("can_grow", 0, 100),
        ("grow", 0, 100), ("set_prefix_keys", 1, keys[:2], 70),
        ("can_grow", 1, 70), ("grow", 1, 70), ("freeable_pages", 1),
        ("write_page", 1, 40), ("refcount", 1), ("can_cow",),
        ("cow", 1, 1), ("page_key", 1), ("invalidate_key", 1),
        ("grow", 2, 128), ("can_grow", 1, 128), ("grow", 1, 128),
        ("truncate", 2, 33), ("freeable_pages", 0), ("release", 0),
        ("set_prefix_keys", 0, keys[:3], 300), ("grow", 0, 64),
        ("release", 1), ("release", 2), ("release", 0)]
    for op, *args in script:
        got = [getattr(a, op)(*args) for a in arenas]
        assert got[0] == got[1], (op, args)
        assert _arena_state(arenas[0]) == _arena_state(arenas[1]), op


def test_slot_pool_scripted_states_equal_jax():
    pools = [m.SlotPool(3) for m in (jkv, tkv)]
    for op, *args in [("alloc", 10), ("alloc", 11), ("tick",),
                      ("release", 0), ("alloc", 12), ("tick", 1),
                      ("alloc", 13), ("owner", 2), ("release", 1),
                      ("tick",)]:
        got = [getattr(p, op)(*args) for p in pools]
        assert got[0] == got[1], op
        assert len({(p.free_count, p.active_count, tuple(p.active_slots),
                     p.utilization, p.busy_slot_steps, p.decode_steps)
                    for p in pools}) == 1, op
    for m in (jkv, tkv):
        full = m.SlotPool(1)
        full.alloc(0)
        with pytest.raises(RuntimeError, match="exhausted"):
            full.alloc(1)
        with pytest.raises(ValueError):
            m.SlotPool(0)


@dataclasses.dataclass
class _Req:
    rid: int
    tokens: np.ndarray
    priority: int = 0
    tenant: str = "default"
    arrival_s: float = 0.0


@pytest.mark.parametrize("kind,cow", [("fifo", False), ("wave", True),
                                      ("quota", True)])
def test_policies_admit_and_evict_in_the_same_order(kind, cow):
    rng = np.random.default_rng(1)
    reqs = [_Req(i, np.zeros(int(rng.integers(1, 200)), np.int32),
                 priority=int(rng.integers(0, 2)),
                 tenant=("a", "b", "c")[i % 3],
                 arrival_s=float(rng.uniform(0, 2)))
            for i in range(12)]
    quotas = {"a": 2.0, "b": 0.5}
    pols = [m.make_policy(m.PolicyConfig(kind=kind, quotas=quotas,
                                         cow_victims=cow,
                                         prefill_chunk=64,
                                         adaptive_chunk=True))
            for m in (jpolicy, tpolicy)]
    for p in pols:
        for r in reqs:
            p.add(r)
    now, picked, requeued = 0.0, [[], []], [set(), set()]
    while pols[0]:
        now += 0.3
        for i, p in enumerate(pols):
            hint = (32, 64, None)[len(picked[i]) % 3]
            r = p.pop_admissible(now, hint)
            picked[i].append(None if r is None else r.rid)
            if r is not None:
                p.on_admit(r)
                p.on_tokens(r, r.rid % 5 + 1)
                if r.rid % 4 == 0 and r.rid not in requeued[i]:
                    requeued[i].add(r.rid)      # preempted once, requeued
                    p.on_preempt(r)
                    p.requeue(r)
            assert p.next_arrival_s() == pols[0].next_arrival_s()
        assert picked[0] == picked[1]
        assert len(pols[0]) == len(pols[1])
    victims = [sorted(range(12), key=lambda i: p.victim_key(
        reqs[i], i, (7 * i) % 5)) for p in pols]
    assert victims[0] == victims[1]
    for endangered in (False, True):
        assert (pols[0].chunk_width(128, endangered) ==
                pols[1].chunk_width(128, endangered))
    assert tpolicy._pow2_bucket(33) == jpolicy._pow2_bucket(33) == 64
    with pytest.raises(ValueError, match="multiple"):
        tpolicy.PolicyConfig(prefill_chunk=48)


def test_copy_pages_matches_jax():
    """Copy-on-write payloads, duplicate destinations included (the last
    writer wins); every page compared, the trash page too."""
    rng = np.random.default_rng(2)
    u32 = lambda shape: rng.integers(0, 2**32, shape, dtype=np.uint64
                                     ).astype(np.uint32)
    kp, vt = u32((7, 1, 32, 1)), u32((7, 1, 32, 1))
    bt, ln = np.zeros((2, 2), np.int32), np.zeros(2, np.int32)
    jc = [{"attn": JPaged(jnp.asarray(kp), jnp.asarray(vt),
                          jnp.asarray(bt), jnp.asarray(ln), jnp.int32(64))}]
    tc = [{"attn": tattention.PagedKVCache(
        *(torch.from_numpy(a.view(np.int32)) for a in (kp, vt)),
        torch.from_numpy(bt), torch.from_numpy(ln), 64)}]
    copies = {64: [(1, 4), (2, 5), (3, 4), (6, 1)]}
    jc = jengine.ServeEngine._copy_pages(jc, [64], copies)
    tc = tengine.ServeEngine._copy_pages(tc, [64], copies)
    for name in ("k_pages", "vt_pages"):
        np.testing.assert_array_equal(
            getattr(tc[0]["attn"], name).numpy().view(np.uint32),
            np.asarray(getattr(jc[0]["attn"], name)))


@pytest.mark.parametrize("heavy", [None, 1.5])
def test_trace_json_is_byte_equal_to_jax(heavy):
    def cfg(m):
        return m.TraceConfig(
            n_requests=20, heavy_tail=heavy, vocab=1000, seed=4,
            tenants=(m.TenantSpec("chat", weight=2.0, ttft_slo_s=0.5,
                                  tpot_slo_s=0.05, system_prompt_len=64,
                                  system_prompts=2, priority=1),
                     m.TenantSpec("batch")))
    text = ttrace.to_json(ttrace.generate_trace(cfg(ttrace)))
    assert text == jtrace.to_json(jtrace.generate_trace(cfg(jtrace)))
    got = ttrace.as_requests(ttrace.from_json(text))
    want = jtrace.as_requests(jtrace.from_json(text))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert (g.rid, g.max_new_tokens, g.priority, g.tenant, g.arrival_s,
                g.slo == tengine.SLO(**dataclasses.asdict(w.slo))
                if w.slo else g.slo is None) == \
            (w.rid, w.max_new_tokens, w.priority, w.tenant, w.arrival_s,
             True)


def test_configs_and_report_schema_match_jax():
    assert tkv.EngineReport.field_names() == jkv.EngineReport.field_names()
    for t, j in ((tengine.CacheConfig, jengine.CacheConfig),
                 (tengine.SpecConfig, jengine.SpecConfig),
                 (tpolicy.PolicyConfig, jpolicy.PolicyConfig),
                 (ttrace.TenantSpec, jtrace.TenantSpec),
                 (tengine.Request, jengine.Request),
                 (tengine.SLO, jengine.SLO)):
        assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
            [(f.name, f.default) for f in dataclasses.fields(j)], t
    cache = dict(max_len=96, paged=True, page_size=32, num_pages=4)
    t, j = (m.ServeConfig(num_slots=3, cache=m.CacheConfig(**cache))
            for m in (tengine, jengine))
    assert repr(t) == repr(j) and t == tengine.ServeConfig(
        num_slots=3, cache=tengine.CacheConfig(**cache))
    assert dataclasses.asdict(t.page_spec()) == dataclasses.asdict(
        j.page_spec())
    assert (t.max_len, t.paged, t.prefill_chunk, t.spec_decode) == \
        (j.max_len, j.paged, j.prefill_chunk, j.spec_decode)
    for bad in (dict(page_size=48), dict(max_blocks=0),
                dict(max_blocks=4, num_pages=2)):
        with pytest.raises(ValueError):
            tattention.PageSpec(**bad)
    with pytest.warns(DeprecationWarning, match="flat ServeConfig"):
        t = tengine.ServeConfig(max_len=64)
    with pytest.warns(DeprecationWarning, match="flat ServeConfig"):
        j = jengine.ServeConfig(max_len=64)
    assert repr(t) == repr(j) and t.max_len == 64


# -- the engine against the JAX engine ----------------------------------------

TRACE = dict(n_requests=8, mean_prompt=24, max_prompt=60, mean_new=6,
             max_new=10, vocab=256, seed=0)


@pytest.fixture(scope="module")
def smoke():
    jm = jbuild(jbase.get_smoke_config("smollm-135m"))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(
        jax.jit(jm.init)(jax.random.PRNGKey(0))))
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config("smollm-135m")),
                tdp=bridge.from_jax_params(dp, device="cpu"))


def _serve_both(smoke, cache, policy=None):
    out = []
    for m, tr, model, dp, kw in (
            (jengine, jtrace, smoke["jm"], smoke["jdp"], {}),
            (tengine, ttrace, smoke["tm"], smoke["tdp"], {"device": "cpu"})):
        reqs = tr.as_requests(tr.generate_trace(tr.TraceConfig(
            tenants=(tr.TenantSpec("default", system_prompt_len=32),),
            **TRACE)))
        for r in reqs:
            r.arrival_s = 0.0
        cfg = m.ServeConfig(num_slots=4, cache=m.CacheConfig(**cache),
                            policy=m.PolicyConfig(**(policy or {})))
        out.append(m.ServeEngine(model, dp, cfg, **kw).serve(reqs))
    (jres, jrep), (tres, trep) = out
    assert sorted(tres) == sorted(jres) == list(range(TRACE["n_requests"]))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]),
                                      err_msg=f"rid {rid}")
    keys = [k for k in jrep.keys() if k not in TIMING]
    assert sorted(k for k in trep.keys() if k not in TIMING) == sorted(keys)
    for k in keys:
        assert trep[k] == pytest.approx(jrep[k]), k
    return trep


def test_serve_contiguous_continuous_equals_jax(smoke):
    rep = _serve_both(smoke, dict(max_len=128))
    assert "pages_total" not in rep and rep.iterations > 0
    assert rep.dispatches_per_iteration == 1.0


def test_serve_paged_prefix_share_chunked_preempting_equals_jax(smoke):
    rep = _serve_both(smoke, dict(max_len=128, paged=True, page_size=32,
                                  max_blocks=3, num_pages=5),
                      dict(prefill_chunk=32))
    assert rep.preemptions >= 1 and rep.prefix_hits >= 1
    assert rep.prefill_chunks >= 1 and rep.peak_page_utilization == 1.0
    assert rep.pages_used == 0 and rep.pages_reserved == 1
