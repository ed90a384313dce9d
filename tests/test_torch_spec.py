"""Speculative decode in the port, on the CPU, against the JAX package on
the same params (float32 smoke config, weights carried across through
``repro_torch.bridge``, inputs drawn from seeded numpy generators).

Held: the verify and commit faces of the attention (ring and paged) and
of the model (words and lengths bitwise, outputs and logits within ATOL,
rows that commit nothing untouched); the truncated draft on the trunk's
own tensors; the samplers' distributions and greedy acceptance; the
rejection-sampling acceptance by its first token's distribution (torch's
generator draws other numbers than ``jax.random``, so by a chi-squared
test, as the JAX package's own test does); greedy speculative serving
equal to the JAX engine's speculative serving and to the port's plain
serving in every cache layout, with equal reports (spec counters,
rollback frees, captures); a full-depth draft that accepts everything;
an independent draft that rejects and frees pages; the draft's rings
after the rollback equal to a draft that ingested only the committed
tokens; and ``ServeConfig``'s flat keywords."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.blocks import Block as JBlock
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro.serve import sampler as jsampler
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import sampler as tsampler

ATOL = 1e-4
TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jbase.get_smoke_config("smollm-135m")
    jm = jbuild(jcfg)
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(
        jax.jit(jm.init)(jax.random.PRNGKey(0))))
    # an independent draft that disagrees with the trunk: one layer and an
    # untied head, params from seed 123 (a tied random-weight model
    # predicts much as any other tied one does)
    dcfg = dict(tie_embeddings=False, num_layers=1)
    jdm = jbuild(jcfg.with_(**dcfg))
    ddp = jax.tree.map(np.asarray, jax.jit(jdm.convert)(
        jax.jit(jdm.init)(jax.random.PRNGKey(123))))
    return dict(jcfg=jcfg, jm=jm, dp=dp, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config("smollm-135m")),
                tdp=bridge.from_jax_params(dp, device="cpu"),
                jdm=jdm, jddp=jax.tree.map(jnp.asarray, ddp),
                tdm=tbuild(tbase.get_smoke_config("smollm-135m").with_(
                    **dcfg)),
                tddp=bridge.from_jax_params(ddp, device="cpu"))


def _to_torch_cache(jc):
    if hasattr(jc, "block_table"):
        return PagedKVCache(_t(jc.k_pages), _t(jc.vt_pages),
                            _t(jc.block_table), _t(jc.length),
                            int(jc.ring_len))
    return KVCache(_t(jc.k_bits), _t(jc.vt_bits), _t(jc.length))


def _assert_cache_equal(jc, tc):
    """Words and lengths bitwise; a paged cache on pages 1.. (the trash
    page 0 takes unwritten slots in an order neither package fixes)."""
    if isinstance(tc, PagedKVCache):
        pairs = ((tc.k_pages[1:], jc.k_pages[1:]),
                 (tc.vt_pages[1:], jc.vt_pages[1:]))
    else:
        pairs = ((tc.k_bits, jc.k_bits), (tc.vt_bits, jc.vt_bits))
    for t, j in pairs:
        np.testing.assert_array_equal(_u32(t), np.asarray(j))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=0)


def _snapshot(cache):
    return type(cache)(*[t.clone() if isinstance(t, torch.Tensor) else t
                         for t in cache])


# -- model faces ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_verify_and_commit_chunk_match_jax(smoke, layout):
    """Ragged prefixes, then a verify of 5 candidates per row (the cache
    is left as it was) and a commit of 0, 3 and 5 of them: the output
    within ATOL, the projections, words and lengths bitwise."""
    jp = jax.tree.map(lambda t: t[0], smoke["dp"]["blocks"])["attn"]
    tp = smoke["tdp"]["blocks"][0]["attn"]
    jattn = JBlock(smoke["jcfg"])._parts()["attn"]
    tattn = TBlock(smoke["tm"].cfg)._attn()
    b, c_len = 3, 5
    rng = np.random.default_rng(11)
    if layout == "paged":
        jc = jattn.init_paged_cache(b, ring_len=128, page_size=32,
                                    num_blocks=4, num_pages=10)
        bt = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 0, 0]], np.int32)
        jc = jc._replace(block_table=jnp.asarray(bt))
    else:
        jc = jattn.init_cache(b, 100)
    tc = _to_torch_cache(jc)
    valid = np.array([20, 33, 5], np.int32)
    x = rng.standard_normal((b, 40, 96)).astype(np.float32)
    _, jc = jax.jit(jattn.deploy_prefill_chunk)(
        jp, jnp.asarray(x), jc, start=jnp.zeros(b, jnp.int32),
        valid_len=jnp.asarray(valid))
    tattn.deploy_prefill_chunk(tp, torch.from_numpy(x), tc,
                               start=torch.zeros(b, dtype=torch.int64),
                               valid_len=torch.from_numpy(valid))
    before = _snapshot(tc)
    x = rng.standard_normal((b, c_len, 96)).astype(np.float32)
    jout, (jk, jsv) = jax.jit(jattn.deploy_verify_chunk)(
        jp, jnp.asarray(x), jc, start=jnp.asarray(valid))
    tout, (tk, tv) = tattn.deploy_verify_chunk(
        tp, torch.from_numpy(x), tc, start=torch.from_numpy(valid))
    _close(tout, jout)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jsv) > 0)
    for t, t0 in zip(tc, before):           # the verify wrote nothing
        if isinstance(t, torch.Tensor):
            assert torch.equal(t, t0)
    n_commit = np.array([0, 3, 5], np.int32)
    jc = jax.jit(jattn.commit_chunk)(jc, (jk, jsv), jnp.asarray(valid),
                                     jnp.asarray(n_commit))
    out = tattn.commit_chunk(tc, (tk, tv), torch.from_numpy(valid),
                             torch.from_numpy(n_commit))
    assert out is tc
    _assert_cache_equal(jc, tc)
    assert int(tc.length[0]) == valid[0]    # n_commit 0: length kept
    if layout == "ring":                    # ... and its ring untouched
        assert torch.equal(tc.k_bits[0], before.k_bits[0])
        assert torch.equal(tc.vt_bits[0], before.vt_bits[0])


def test_verify_with_cache_logits_and_commit_chunks_match_jax(smoke):
    """The model's verify gives logits at every chunk position within
    ATOL of JAX's; committing 2, 0 and 4 positions gives JAX's caches
    bitwise; the caches come back as the same objects."""
    jm, tm = smoke["jm"], smoke["tm"]
    b = 3
    rng = np.random.default_rng(12)
    jc = jm.init_caches(b, 64)
    tc = tm.init_caches(b, 64, "cpu")
    toks = rng.integers(0, 256, (b, 24)).astype(np.int32)
    valid = np.array([24, 9, 17], np.int32)
    _, jc = jax.jit(jm.prefill_with_cache)(
        smoke["jdp"], jnp.asarray(toks), caches=jc,
        start=jnp.zeros(b, jnp.int32), seq_lens=jnp.asarray(valid))
    tm.prefill_with_cache(smoke["tdp"], torch.from_numpy(toks), caches=tc,
                          start=torch.zeros(b, dtype=torch.int64),
                          seq_lens=torch.from_numpy(valid))
    chunk = rng.integers(0, 256, (b, 5)).astype(np.int32)
    jl, jprojs = jax.jit(jm.verify_with_cache)(
        smoke["jdp"], jnp.asarray(chunk), jc, start=jnp.asarray(valid))
    tl, tprojs = tm.verify_with_cache(smoke["tdp"], torch.from_numpy(chunk),
                                      tc, start=torch.from_numpy(valid))
    assert tl.shape == (b, 5, 256)
    _close(tl, jl)
    n_commit = np.array([2, 0, 4], np.int32)
    jc = jax.jit(jm.commit_chunks)(jc, jprojs, jnp.asarray(valid),
                                   jnp.asarray(n_commit))
    out = tm.commit_chunks(tc, tprojs, torch.from_numpy(valid),
                           torch.from_numpy(n_commit))
    assert out is tc
    for j, t in zip(jc, tc):
        _assert_cache_equal(j["attn"], t["attn"])


def test_verify_computes_decode_steps_in_bf16(smoke):
    """In bfloat16 the verify keeps decode's float32 residual stream, so
    its logits at position j are those of the j-th decode step (within
    the head matmul's float32 rounding, 1e-5, where a bf16 residual moves
    them by ~1e-2) and committing all 5 positions writes the caches five
    decode steps write, bitwise."""
    tm = tbuild(tbase.get_smoke_config("smollm-135m").with_(
        compute_dtype="bfloat16"))
    tdp = smoke["tdp"]
    b = 3
    rng = np.random.default_rng(17)
    caches = tm.init_caches(b, 64, "cpu")
    toks = torch.from_numpy(rng.integers(0, 256, (b, 24)))
    valid = torch.tensor([24, 9, 17])
    tm.prefill_with_cache(tdp, toks, caches=caches,
                          start=torch.zeros(b, dtype=torch.int64),
                          seq_lens=valid)
    stepped = [dict(attn=_snapshot(c["attn"])) for c in caches]
    chunk = torch.from_numpy(rng.integers(0, 256, (b, 5)))
    logits, projs = tm.verify_with_cache(tdp, chunk, caches, start=valid)
    tm.commit_chunks(caches, projs, valid, torch.full((b,), 5))
    for j in range(5):
        lg, _ = tm.decode_step(tdp, chunk[:, j:j + 1], stepped)
        np.testing.assert_allclose(logits[:, j].numpy(), lg[:, 0].numpy(),
                                   atol=1e-5, rtol=0)
        assert torch.equal(logits[:, j].argmax(-1), lg[:, 0].argmax(-1))
    for c, s in zip(caches, stepped):
        for x, y in zip(c["attn"], s["attn"]):
            assert torch.equal(x, y)


def test_truncate_deploy_shares_the_trunks_tensors(smoke):
    tm, tdp = smoke["tm"], smoke["tdp"]
    with pytest.raises(ValueError):
        tm.cfg.truncated(0)
    with pytest.raises(ValueError):
        tm.cfg.truncated(tm.cfg.num_layers + 1)
    draft, dd = tm.truncate_deploy(tdp, 1)
    assert draft.cfg.num_layers == 1 and len(dd["blocks"]) == 1
    assert dd["embed"] is tdp["embed"] and dd["blocks"][0] is tdp["blocks"][0]
    ptrs = lambda tree: {id(t): t.data_ptr() for t in jax.tree.leaves(tree)}
    assert ptrs(dd).items() <= ptrs(tdp).items()      # nothing copied
    jdraft, jdd = smoke["jm"].truncate_deploy(smoke["jdp"], 1)
    toks = np.random.default_rng(13).integers(0, 256, (2, 6))
    _close(draft.prefill_logits(dd, torch.from_numpy(toks), device="cpu"),
           jdraft.prefill_logits(jdd, jnp.asarray(toks, jnp.int32)))


# -- samplers --------------------------------------------------------------------


def test_sampling_probs_match_jax():
    """All three samplers within 1e-6 of JAX's on random logits, and on
    ties: top_k keeps the lowest indices among equal logits, as
    ``lax.top_k`` does."""
    rng = np.random.default_rng(14)
    cases = [rng.standard_normal((4, 3, 300)).astype(np.float32),
             np.array([[0.0, 2.0, 2.0, -1.0, 1.0]], np.float32),
             np.array([[0.0, 1.0, 1.0, 1.0, -1.0, 1.0]], np.float32)]
    for logits in cases:
        for smp, kw in (("greedy", {}), ("temperature", dict(temp=0.7)),
                        ("top_k", dict(temp=1.3, k=2))):
            got = tsampler.sampling_probs(torch.from_numpy(logits), smp, **kw)
            want = np.asarray(jsampler.sampling_probs(jnp.asarray(logits),
                                                      smp, **kw))
            np.testing.assert_array_equal(got.numpy() > 0, want > 0)
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_greedy_speculative_accept_matches_jax():
    """Random logits with drafts that match the target argmax for a
    random prefix: outputs and accepted counts bitwise."""
    rng = np.random.default_rng(15)
    b, k, v = 64, 4, 7
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    tgt = logits.argmax(-1)
    drafts = rng.integers(0, v, (b, k)).astype(np.int32)
    keep = rng.integers(0, k + 1, b)
    for r in range(b):
        drafts[r, :keep[r]] = tgt[r, :keep[r]]
    jout, jn = jsampler.speculative_accept(jnp.asarray(drafts), None,
                                           jnp.asarray(logits), None)
    tout, tn = tsampler.speculative_accept(torch.from_numpy(drafts), None,
                                           torch.from_numpy(logits))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tn.dtype == tout.dtype == torch.int32
    assert set(tn.tolist()) == set(range(k + 1))


def test_speculative_first_token_distribution():
    """The first token of a stochastic verify is distributed as the target
    sampler's, whatever the draft: chi-squared over 4,000 rows (the JAX
    package's test, on torch's generator; three seeds)."""
    v, k, trials = 5, 2, 4000
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed)
        q_logits = torch.from_numpy(
            rng.normal(size=(1, k, v)).astype(np.float32))
        t_logits = torch.from_numpy(
            rng.normal(size=(1, k + 1, v)).astype(np.float32))
        q = torch.softmax(q_logits, -1).expand(trials, k, v)
        drafts = torch.multinomial(q.reshape(-1, v), 1, generator=gen
                                   ).reshape(trials, k)
        out, _ = tsampler.speculative_accept(
            drafts, q, t_logits.expand(trials, k + 1, v), gen,
            sampler="temperature", temp=1.0)
        obs = np.bincount(out[:, 0].numpy(), minlength=v).astype(np.float64)
        exp = torch.softmax(t_logits[0, 0], -1).numpy() * trials
        chi2 = ((obs - exp) ** 2 / np.maximum(exp, 1e-9)).sum()
        # df = v - 1 = 4; 26.0 is far beyond the 99.99th percentile
        assert chi2 < 26.0, (seed, chi2, obs, exp)


# -- the engine ------------------------------------------------------------------


def _cfg(mod, num_slots, cache, k=None, draft_layers=1, chunk=None):
    return mod.ServeConfig(
        num_slots=num_slots, cache=mod.CacheConfig(**cache),
        spec=mod.SpecConfig(k=k, draft_layers=draft_layers),
        policy=mod.PolicyConfig(prefill_chunk=chunk))


def _prompts(lens, seed, shared=0):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(0, 256, (shared,)).astype(np.int32)
    return [np.concatenate([sysp, rng.integers(0, 256, (n,)).astype(
        np.int32)]) for n in lens]


def _assert_reports_equal(jrep, trep):
    for name in trep.field_names():
        if name not in TIMING:
            assert trep.get(name) == jrep.get(name), name


LAYOUTS = {"contig": dict(cache=dict(max_len=128)),
           "paged": dict(cache=dict(max_len=128, paged=True,
                                    prefix_share=False)),
           "paged+share": dict(cache=dict(max_len=128, paged=True)),
           "paged+share+chunk": dict(cache=dict(max_len=128, paged=True),
                                     chunk=32),
           "chunk": dict(cache=dict(max_len=128), chunk=32)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_spec_serve_equals_jax_and_plain(smoke, layout):
    """The JAX package's five layouts of ``test_greedy_spec_identical_dense``:
    speculative tokens equal the JAX engine's speculative tokens and the
    port's plain tokens; the whole report (spec counters, rollback frees,
    captures) equals JAX's, and the captures by kind equal its traces."""
    kw = LAYOUTS[layout]
    prompts = _prompts((5, 45, 9), seed=3, shared=40)
    jeng = jengine.ServeEngine(smoke["jm"], smoke["jdp"],
                               _cfg(jengine, 2, k=4, **kw))
    jout, jrep = jeng.generate(prompts, max_new_tokens=6)
    teng = tengine.ServeEngine(smoke["tm"], smoke["tdp"],
                               _cfg(tengine, 2, k=4, **kw), device="cpu")
    tout, trep = teng.generate(prompts, max_new_tokens=6)
    plain, _ = tengine.ServeEngine(smoke["tm"], smoke["tdp"],
                                   _cfg(tengine, 2, **kw),
                                   device="cpu").generate(
        prompts, max_new_tokens=6)
    for i, (j, t, p) in enumerate(zip(jout, tout, plain)):
        np.testing.assert_array_equal(t, j, err_msg=f"request {i}")
        np.testing.assert_array_equal(t, p, err_msg=f"request {i}")
    assert trep["spec_steps"] > 0 and trep["spec_tokens_per_step"] >= 1.0
    _assert_reports_equal(jrep, trep)
    assert teng._graphs.captures == jeng._compiles


def test_full_depth_draft_accepts_everything(smoke):
    """A draft as deep as the trunk is the trunk: every draft accepted,
    k+1 tokens per verify step, the plain tokens."""
    tm, tdp = smoke["tm"], smoke["tdp"]
    prompts = _prompts((6, 9), seed=5)
    cache = dict(max_len=64)
    out, rep = tengine.ServeEngine(
        tm, tdp, _cfg(tengine, 2, cache, k=3,
                      draft_layers=tm.cfg.num_layers),
        device="cpu").generate(prompts, max_new_tokens=7)
    ref, _ = tengine.ServeEngine(tm, tdp, _cfg(tengine, 2, cache),
                                 device="cpu").generate(prompts,
                                                        max_new_tokens=7)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    assert rep["spec_accept_rate"] == 1.0
    assert rep["spec_tokens_per_step"] == 4.0


def test_independent_draft_rejects_and_frees_rollback_pages(smoke):
    """An independent draft (seed 123) disagrees with the trunk while
    the candidate span crosses page boundaries: the tokens stay the
    plain ones and JAX's, and rollback frees pages, as many as JAX's."""
    p = _prompts((30,), seed=31)[0]
    cache = dict(max_len=128, paged=True, page_size=32)
    jres, jrep = jengine.ServeEngine(
        smoke["jm"], smoke["jdp"], _cfg(jengine, 1, cache, k=4),
        draft_model=smoke["jdm"], draft_dparams=smoke["jddp"],
    ).serve([jengine.Request(rid=0, tokens=p, max_new_tokens=40)])
    with pytest.raises(ValueError, match="together"):
        tengine.ServeEngine(smoke["tm"], smoke["tdp"],
                            _cfg(tengine, 1, cache, k=4),
                            draft_model=smoke["tdm"], device="cpu")
    tres, trep = tengine.ServeEngine(
        smoke["tm"], smoke["tdp"], _cfg(tengine, 1, cache, k=4),
        smoke["tdm"], smoke["tddp"], device="cpu",
    ).serve([tengine.Request(rid=0, tokens=p, max_new_tokens=40)])
    plain, _ = tengine.ServeEngine(smoke["tm"], smoke["tdp"],
                                   _cfg(tengine, 1, dict(max_len=128)),
                                   device="cpu").generate(
        p[None, :], max_new_tokens=40)
    np.testing.assert_array_equal(tres[0], plain[0])
    np.testing.assert_array_equal(tres[0], jres[0])
    _assert_reports_equal(jrep, trep)
    assert trep["spec_accept_rate"] < 1.0
    assert trep["pages_freed_rollback"] > 0


def test_draft_rings_after_rollback_equal_committed_only(smoke):
    """Three speculative iterations of ``spec_forward`` (temperature
    sampling, so some drafts are accepted and some rejected) on three
    rows, the third inactive: the draft's rings and lengths equal, bit
    for bit, those of a draft that ingested only the committed tokens;
    the trunk's equal a trunk that ingested them as chunks."""
    tm, tdp = smoke["tm"], smoke["tdp"]
    b, k, ring = 3, 4, 64
    cfg = tengine.ServeConfig(num_slots=b, sampler="temperature",
                              temperature=2.0,
                              cache=tengine.CacheConfig(max_len=ring),
                              spec=tengine.SpecConfig(k=k))
    eng = tengine.ServeEngine(tm, tdp, cfg, device="cpu")
    eng._resolve_draft()
    draft, ddp = eng.draft_model, eng.draft_dparams
    rng = np.random.default_rng(16)
    toks = torch.from_numpy(rng.integers(0, 256, (b, 24)))
    lens = torch.tensor([24, 11, 7])

    def prefilled(model, params):
        caches = model.init_caches(b, ring, "cpu")
        model.prefill_with_cache(params, toks, caches=caches,
                                 start=torch.zeros(b, dtype=torch.int64),
                                 seq_lens=lens)
        return caches

    trunk, dcaches = prefilled(tm, tdp), prefilled(draft, ddp)
    want_t, want_d = prefilled(tm, tdp), prefilled(draft, ddp)
    step = eng.spec_forward(trunk, dcaches)
    active = torch.tensor([1, 1, 0])
    pending = torch.from_numpy(rng.integers(0, 256, (b, 1)))
    start = lens.clone()
    gen = torch.Generator().manual_seed(0)
    accepted = set()
    with torch.inference_mode():
        for _ in range(3):
            rand = torch.randint(0, 2 ** tsampler.UNIFORM_BITS,
                                 (b, 2 * k + 2), generator=gen)
            res = step(tokens=pending, start=start, active=active, rand=rand)
            out, n_acc = res[:, :k + 1], res[:, k + 1]
            n_commit = torch.where(active != 0, n_acc + 1, 0)
            accepted.update(n_acc[:2].tolist())
            committed = torch.cat([pending, out[:, :k]], dim=1)
            for model, params, caches in ((tm, tdp, want_t),
                                          (draft, ddp, want_d)):
                model.prefill_with_cache(params, committed, caches=caches,
                                         start=start, seq_lens=n_commit)
            pending = out.gather(1, n_acc[:, None])
            start = start + n_commit
    assert min(accepted) < k and max(accepted) > 0
    for got, want in ((dcaches, want_d), (trunk, want_t)):
        for g, w in zip(got, want):
            for a, c in zip(g["attn"], w["attn"]):
                assert torch.equal(a, c)


# -- config ------------------------------------------------------------------------


@pytest.mark.parametrize("flat", [
    dict(max_len=96, paged=True, page_size=32, max_blocks=3, num_pages=5,
         prefix_share=False, prefill_chunk=32),
    dict(spec_decode=3, spec_draft_layers=2),
], ids=["cache+policy", "spec"])
def test_flat_keywords_map_as_jax(flat):
    """The deprecated flat keywords build the same sub-configs as the JAX
    package's, with one DeprecationWarning; an unknown keyword beside
    them is a TypeError in both."""
    built = {}
    for mod in (jengine, tengine):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            built[mod] = mod.ServeConfig(num_slots=3, **flat)
        assert [w.category for w in caught] == [DeprecationWarning]
        with pytest.raises(TypeError, match="bogus"):
            mod.ServeConfig(bogus=1, **flat)
    j, t = built[jengine], built[tengine]
    for part in ("cache", "spec", "policy"):
        assert (dataclasses.asdict(getattr(t, part)) ==
                dataclasses.asdict(getattr(j, part))), part
    for name in ("max_len", "paged", "prefill_chunk", "spec_decode",
                 "spec_draft_layers", "num_slots"):
        assert getattr(t, name) == getattr(j, name), name
