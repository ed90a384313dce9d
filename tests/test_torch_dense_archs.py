"""The rest of the dense family in the port, against the JAX package on
the CPU: granite-3-2b (GQA 4:1) and qwen1.5-32b (MHA, QKV bias, untied
head) at their float32 smoke sizes, and a narrow qwen-shaped config with
qwen's full head width (2 layers, d = 256, 2 heads of d_h = 128, G = 1,
bias), which the smoke config (d_h = 32) cannot show.

Held per config: prefill then greedy decode steps; ragged chunks
continuing ring and paged caches, then a decode step; the speculative
verify and commit; and continuous paged serving (prefix sharing, chunked
prefill, preemption) by the JAX engine and the port's, greedy tokens by
rid and reports equal.  Words, caches and lengths bitwise; logits within
ATOL (the frameworks sum RMSNorm, RoPE and the head in other orders).
Params are the JAX package's, with scales, thresholds and the QKV bias
moved off their init values, bridged through numpy."""
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
from repro.serve import trace as jtrace
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.attention import PageSpec as TPageSpec
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import trace as ttrace

ATOL = 1e-4
B, S, MAX_LEN = 2, 20, 32
# the narrow config: qwen's head width and G = 1 at a CPU test's size
NARROW = dict(d_model=256, num_heads=2, num_kv_heads=2)
CONFIGS = {"granite-3-2b": ("granite-3-2b", {}),
           "qwen1.5-32b": ("qwen1.5-32b", {}),
           "qwen d_h=128": ("qwen1.5-32b", NARROW)}
TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    a = np.array(tree)
    if name.endswith("_alpha") or name == "bit_alpha":
        return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
    if name.endswith("_beta") or name == "bias":
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "sps_lambda":
        return (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


@functools.lru_cache(maxsize=None)
def _models(key: str):
    arch, kw = CONFIGS[key]
    jcfg = jbase.get_smoke_config(arch).with_(**kw)
    tcfg = tbase.get_smoke_config(arch).with_(**kw)
    jm = jbuild(jcfg)
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp), tm=tbuild(tcfg),
                tdp=bridge.from_jax_params(dp, device="cpu"))


def _assert_cache_equal(jc, tc):
    if isinstance(tc, PagedKVCache):
        pairs = ((tc.k_pages[1:], jc.k_pages[1:]),
                 (tc.vt_pages[1:], jc.vt_pages[1:]))
    else:
        pairs = ((tc.k_bits, jc.k_bits), (tc.vt_bits, jc.vt_bits))
    for t, j in pairs:
        np.testing.assert_array_equal(_u32(t), np.asarray(j))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _assert_caches_equal(jcs, tcs):
    for j, t in zip(jcs, tcs):
        _assert_cache_equal(j["attn"], t["attn"])


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_prefill_then_decode_steps(key):
    m = _models(key)
    cfg = m["tm"].cfg
    assert (cfg.resolved_head_dim, cfg.num_heads // cfg.num_kv_heads) == {
        "granite-3-2b": (32, 2), "qwen1.5-32b": (32, 1),
        "qwen d_h=128": (128, 1)}[key]
    toks = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    jl, jc = jax.jit(functools.partial(m["jm"].prefill_with_cache,
                                       max_len=MAX_LEN))(
        m["jdp"], jnp.asarray(toks))
    tl, tc = m["tm"].prefill_with_cache(m["tdp"], torch.from_numpy(toks),
                                        max_len=MAX_LEN)
    _close(tl, jl)
    jdec = jax.jit(m["jm"].decode_step)
    for step in range(3):
        _assert_caches_equal(jc, tc)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok,
                                      err_msg=f"step {step}")
        jl, jc = jdec(m["jdp"], jnp.asarray(tok), jc)
        tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tc)
        _close(tl, jl)
    _assert_caches_equal(jc, tc)


def _pools(m, b, layout):
    """Empty JAX and port pools of ``b`` slots: rings of 100, or arenas
    of 10 pages of 32 with the same block tables (4 blocks a row)."""
    if layout == "ring":
        return m["jm"].init_caches(b, 100), m["tm"].init_caches(b, 100,
                                                                 "cpu")
    table = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 10, 0]], np.int32)
    spec = dict(page_size=32, max_blocks=4, num_pages=10)
    jc = [dict(c, attn=c["attn"]._replace(block_table=jnp.asarray(table)))
          for c in m["jm"].init_caches(b, 0, paged=JPageSpec(**spec))]
    tc = m["tm"].init_caches(b, 0, "cpu", paged=TPageSpec(**spec))
    for c in tc:
        c["attn"].block_table.copy_(torch.from_numpy(table))
    return jc, tc


def _chunks(m, jc, tc, rng, b):
    """Two ragged chunks of 24 from position 0 (a row inactive in the
    second); returns the lengths written."""
    start = np.zeros(b, np.int32)
    jfn = jax.jit(m["jm"].prefill_with_cache)
    for valid in ([24, 11, 3], [24, 0, 19]):
        valid = np.asarray(valid, np.int32)
        toks = rng.integers(0, 256, (b, 24)).astype(np.int32)
        jl, jc = jfn(m["jdp"], jnp.asarray(toks), caches=jc,
                     start=jnp.asarray(start), seq_lens=jnp.asarray(valid))
        tl, _ = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks), caches=tc,
            start=torch.from_numpy(start), seq_lens=torch.from_numpy(valid))
        live = valid > 0          # logits at each live row's last real token
        _close(tl[live], np.asarray(jl)[live])
        _assert_caches_equal(jc, tc)
        start = start + valid
    return jc, start


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_chunks_then_decode(key, layout):
    m = _models(key)
    b = 3
    rng = np.random.default_rng(2)
    jc, tc = _pools(m, b, layout)
    jc, _ = _chunks(m, jc, tc, rng, b)
    tok = rng.integers(0, 256, (b, 1)).astype(np.int32)
    jl, jc = jax.jit(m["jm"].decode_step)(m["jdp"], jnp.asarray(tok), jc)
    tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tc)
    _close(tl, jl)
    _assert_caches_equal(jc, tc)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_verify_and_commit(key):
    """A verify of 5 candidates per row after ragged chunks on a paged
    pool (the caches untouched), then commits of 2, 0 and 5."""
    m = _models(key)
    b = 3
    rng = np.random.default_rng(3)
    jc, tc = _pools(m, b, "paged")
    jc, start = _chunks(m, jc, tc, rng, b)
    chunk = rng.integers(0, 256, (b, 5)).astype(np.int32)
    jl, jprojs = jax.jit(m["jm"].verify_with_cache)(
        m["jdp"], jnp.asarray(chunk), jc, start=jnp.asarray(start))
    tl, tprojs = m["tm"].verify_with_cache(
        m["tdp"], torch.from_numpy(chunk), tc, start=torch.from_numpy(start))
    assert tl.shape == (b, 5, 256)
    _close(tl, jl)
    _assert_caches_equal(jc, tc)
    n_commit = np.array([2, 0, 5], np.int32)
    jc = jax.jit(m["jm"].commit_chunks)(jc, jprojs, jnp.asarray(start),
                                        jnp.asarray(n_commit))
    assert m["tm"].commit_chunks(tc, tprojs, torch.from_numpy(start),
                                 torch.from_numpy(n_commit)) is tc
    _assert_caches_equal(jc, tc)


TRACE = dict(n_requests=8, mean_prompt=24, max_prompt=60, mean_new=6,
             max_new=10, vocab=256, seed=0)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_serve_paged_equals_jax(key):
    """Continuous paged serving on 4 slots with a shared 32-token system
    prompt, a 5-page arena (preemptions) and chunks of 32: greedy tokens
    by rid and the reports equal (captures included)."""
    m = _models(key)
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
            max_len=128, paged=True, page_size=32, max_blocks=3,
            num_pages=5), policy=mod.PolicyConfig(prefill_chunk=32))
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
    assert trep.preemptions >= 1 and trep.prefix_hits >= 1
