"""Serving gemma3-27b's smoke config in the port against the JAX package on
the CPU: 6 layers in a 5:1 local:global plan (layers 0-4 local with a
window of 8, layer 5 global), GQA 2:1 at d_h = 32, the GELU GLU, a tied
head, float32.

Held: continuous paged serving by rid on two ring groups (the local
layers' rings of 8 tokens, one page a slot, fully provisioned; the global
layer's of the capacity on a short arena, so preemptions occur; prefix
sharing only in the global group: a prompt longer than a ring shares no
page of it); speculative serving whose one-layer draft (local layer 0)
wraps its ring of 8, by rid; one speculative iteration's outputs, trunk
caches and draft rollback on active and inactive rows against the JAX
engine's step; the admission guard (only full-attention layers cap a
request); the slot-surgery functions on a pool of two ring groups.
Tokens by rid and reports equal; caches and lengths bitwise.  Params are
the JAX package's, scales and thresholds moved off their init values,
bridged through numpy."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.attention import PageSpec as JPageSpec
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro.serve import kvcache as jkv
from repro.serve import trace as jtrace
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.attention import PageSpec as TPageSpec
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import trace as ttrace

TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    a = np.array(tree)
    if name.endswith("_alpha"):
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta"):
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "sps_lambda":
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


@functools.lru_cache(maxsize=None)
def _models():
    jm = jbuild(jbase.get_smoke_config("gemma3-27b"))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config("gemma3-27b")),
                tdp=bridge.from_jax_params(dp, device="cpu"))


def _assert_cache_equal(jc, tc):
    if isinstance(tc, PagedKVCache):
        pairs = ((tc.k_pages[1:], jc.k_pages[1:]),
                 (tc.vt_pages[1:], jc.vt_pages[1:]))
        assert tc.ring_len == int(jc.ring_len)
    else:
        pairs = ((tc.k_bits, jc.k_bits), (tc.vt_bits, jc.vt_bits))
    for t, j in pairs:
        np.testing.assert_array_equal(_u32(t), np.asarray(j))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _assert_caches_equal(jcs, tcs):
    for j, t in zip(jcs, tcs):
        _assert_cache_equal(j["attn"], t["attn"])


TRACE = dict(n_requests=8, mean_prompt=24, max_prompt=60, mean_new=6,
             max_new=10, vocab=256, seed=0)


def _serve_both(spec_k=None):
    """The trace on 4 slots with a shared 32-token system prompt, chunks
    of 32, paged ring groups (local: 4 slots x 1 page; global: 5 pages of
    3 blocks, so preemptions occur), on the JAX engine and the port's."""
    m = _models()
    out = []
    for mod, tr, model, dp, kw in (
            (jengine, jtrace, m["jm"], m["jdp"], {}),
            (tengine, ttrace, m["tm"], m["tdp"], {"device": "cpu"})):
        reqs = tr.as_requests(tr.generate_trace(tr.TraceConfig(
            tenants=(tr.TenantSpec("default", system_prompt_len=32),),
            **TRACE)))
        for r in reqs:
            r.arrival_s = 0.0
        cfg = mod.ServeConfig(num_slots=4, cache=mod.CacheConfig(
            max_len=96, paged=True, page_size=32, max_blocks=3, num_pages=5),
            policy=mod.PolicyConfig(prefill_chunk=32),
            spec=mod.SpecConfig(k=spec_k, draft_layers=1))
        out.append(mod.ServeEngine(model, dp, cfg, **kw).serve(reqs))
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


def test_serve_paged_ring_groups_equals_jax():
    rep = _serve_both()
    assert rep.preemptions >= 1 and rep.prefix_hits >= 1
    assert rep.pages_total == 5 + 4


def test_speculative_serve_with_wrapping_draft_equals_jax():
    rep = _serve_both(spec_k=4)
    assert rep.spec_steps >= 1 and rep.spec_drafted >= 1


def test_spec_iteration_rollback_matches_jax():
    """One greedy speculative iteration (k = 4) on contiguous pools after a
    prefill of 14 tokens: the draft (local layer 0, a ring of 8) wraps
    during its 5 steps.  Rows 0 and 1 active, row 2 inactive with
    ``start`` 0 (a free slot, as the engine passes it) and 14 tokens in
    its rings.  Outputs, accepted counts, the trunk's caches and the
    draft's rings and lengths equal the JAX engine's step on every row."""
    m = _models()
    b, k, ring = 3, 4, 32
    toks = np.random.default_rng(6).integers(0, 256, (b, 14)).astype(
        np.int32)
    start = np.array([14, 14, 0], np.int32)
    active = np.array([1, 1, 0])
    pending = np.random.default_rng(7).integers(0, 256, (b, 1)).astype(
        np.int32)
    jeng = jengine.ServeEngine(m["jm"], m["jdp"], jengine.ServeConfig(
        num_slots=b, cache=jengine.CacheConfig(max_len=ring),
        spec=jengine.SpecConfig(k=k)))
    jeng._resolve_draft()
    jeng._build_spec_step()
    pre = functools.partial(jax.jit, static_argnames=("max_len",))
    _, jc = pre(jeng.model.prefill_with_cache)(
        jeng.dparams, jnp.asarray(toks), max_len=ring)
    _, jd = pre(jeng.draft_model.prefill_with_cache)(
        jeng.draft_dparams, jnp.asarray(toks), max_len=ring)
    out, n_acc, _, jc, jd, _ = jeng._spec_jit(
        jeng.dparams, jeng.draft_dparams, jnp.asarray(pending), jc, jd,
        jnp.asarray(start), jnp.asarray(active.astype(bool)),
        jax.random.PRNGKey(0))
    teng = tengine.ServeEngine(m["tm"], m["tdp"], tengine.ServeConfig(
        num_slots=b, cache=tengine.CacheConfig(max_len=ring),
        spec=tengine.SpecConfig(k=k)), device="cpu")
    teng._resolve_draft()
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    _, tc = teng.model.prefill_with_cache(teng.dparams, t(toks),
                                          max_len=ring)
    _, td = teng.draft_model.prefill_with_cache(teng.draft_dparams, t(toks),
                                                max_len=ring)
    assert td[0]["attn"].k_bits.shape[2] == 8
    res = teng.spec_forward(tc, td)(tokens=t(pending), start=t(start),
                                    active=t(active))
    np.testing.assert_array_equal(res[:, :k + 1].numpy(), np.asarray(out))
    np.testing.assert_array_equal(res[:, k + 1].numpy(), np.asarray(n_acc))
    _assert_caches_equal(jc, tc)
    _assert_caches_equal(jd, td)


def test_admission_guard_caps_full_attention_only():
    """A request longer than ``max_len`` is refused when a layer is full
    attention (gemma's layer 5), and served, equal to the JAX engine, by
    a stack whose every layer is windowed (smollm's smoke config with a
    window of 16: its rings wrap by design)."""
    m = _models()
    req = dict(rid=0, tokens=np.arange(30, dtype=np.int32), max_new_tokens=6)
    for mod, model, dp, kw in ((jengine, m["jm"], m["jdp"], {}),
                               (tengine, m["tm"], m["tdp"],
                                {"device": "cpu"})):
        eng = mod.ServeEngine(model, dp, mod.ServeConfig(
            num_slots=1, cache=mod.CacheConfig(max_len=32)), **kw)
        with pytest.raises(ValueError, match="exceeds the cache ring"):
            eng.serve([mod.Request(**req)])
    jm = jbuild(jbase.get_smoke_config("smollm-135m").with_(window_size=16))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(jax.jit(jm.init)(
        jax.random.PRNGKey(1))))
    tm = tbuild(tbase.get_smoke_config("smollm-135m").with_(window_size=16))
    out = []
    for mod, model, p, kw in (
            (jengine, jm, jax.tree.map(jnp.asarray, dp), {}),
            (tengine, tm, bridge.from_jax_params(dp, device="cpu"),
             {"device": "cpu"})):
        eng = mod.ServeEngine(model, p, mod.ServeConfig(
            num_slots=1, cache=mod.CacheConfig(max_len=32)), **kw)
        out.append(eng.serve([mod.Request(**req)])[0][0])
    assert len(out[1]) == 6
    np.testing.assert_array_equal(out[1], np.asarray(out[0]))


def test_slot_surgery_on_ring_groups_matches_jax():
    """Ragged prefills of 20, 5, 13 and 40 tokens (rings of 8, wrapped
    past 8, in the local layers; of 64 in the global one) inserted into a
    paged pool of 5 slots on two ring groups (local: one page a slot;
    global: 3 blocks over 12 pages), two extracted, a decode step on the
    view, written back, a slot reset: every pool and the view equal to
    JAX's."""
    m = _models()
    lens = np.array([20, 5, 13, 40], np.int32)
    toks = np.random.default_rng(12).integers(0, 256, (4, 40))
    toks = np.where(np.arange(40) < lens[:, None], toks, 0).astype(np.int32)
    _, jseq = jax.jit(functools.partial(m["jm"].prefill_with_cache,
                                        max_len=64))(
        m["jdp"], jnp.asarray(toks), seq_lens=jnp.asarray(lens))
    _, tseq = m["tm"].prefill_with_cache(m["tdp"], torch.from_numpy(toks),
                                         max_len=64,
                                         seq_lens=torch.from_numpy(lens))
    spec = dict(page_size=32, max_blocks=3, num_pages=12)
    tables = {8: np.arange(1, 6, dtype=np.int32)[:, None],
              96: np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0], [6, 7, 8],
                            [9, 10, 11]], np.int32)}
    jpool = [dict(c, attn=c["attn"]._replace(block_table=jnp.asarray(
        tables[int(c["attn"].ring_len)])))
        for c in m["jm"].init_caches(5, 0, paged=JPageSpec(**spec))]
    tpool = m["tm"].init_caches(5, 0, "cpu", paged=TPageSpec(**spec))
    for c in tpool:
        c["attn"].block_table.copy_(torch.from_numpy(
            tables[c["attn"].ring_len]))
    at, ext = [3, 0, 4, 1], [4, 1]
    jpool = jkv.insert_slots(jpool, jseq, at)
    tkv.insert_slots(tpool, tseq, at)
    _assert_caches_equal(jpool, tpool)
    jview = jkv.extract_slots(jpool, jnp.asarray(ext))
    tview = tkv.extract_slots(tpool, ext)
    tok = np.array([[7], [200]], np.int32)
    _, jview = jax.jit(m["jm"].decode_step)(m["jdp"], jnp.asarray(tok),
                                            jview)
    m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tview)
    _assert_caches_equal(jview, tview)
    jpool = jkv.writeback_slots(jpool, jview, jnp.asarray(ext))
    tkv.writeback_slots(tpool, tview, ext)
    _assert_caches_equal(jpool, tpool)
    jpool = jkv.reset_slots(jpool, [3])
    tkv.reset_slots(tpool, [3])
    _assert_caches_equal(jpool, tpool)
    np.testing.assert_array_equal(tkv.slot_lengths(tpool),
                                  [5, 41, 0, 0, 14])
