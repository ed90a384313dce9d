"""Port parity of the paged path, on the CPU: the plain
``paged_gather_decode`` against the JAX kernel (interpret mode) and both
JAX oracles, the paged and chunked attention faces, and the continuous
engine on a paged pool.

Words, tables and integer outputs must be bitwise equal; float outputs
agree within ATOL (float32 sums in another order, see
``test_torch_models.py``).  Caches are compared on pages 1..P and on
live rows only: the trash page 0 takes the writes of unmapped rows, in an
order neither framework fixes."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.paged_attn import kernel as jpk
from repro.kernels.paged_attn import ref as jpref
from repro.models.blocks import Block as JBlock
from repro.models.lm import build_model as jbuild
from repro.serve import engine as jengine
from repro.serve import trace as jtrace
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.kernels.paged_attn import ops as tops
from repro_torch.kernels.paged_attn import ref as tref
from repro_torch.models.attention import KVCache, PagedKVCache
from repro_torch.models.blocks import Block as TBlock
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine
from repro_torch.serve import trace as ttrace

ATOL = 1e-4


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, shape, k):
    """Random words with k true bits per row (zero pad bits)."""
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = w.shape[-1] * 32 - k
    if pad:
        w[..., -1] &= np.uint32((1 << (32 - pad)) - 1)
    return w


def _pages(rng, b, h, hkv, dh, page, nblk, pages, ring):
    """The JAX kernel tests' inputs: random pages (page 0 included),
    tables with trash entries, ragged lengths past the ring, a length 0."""
    dhp = (dh + 31) // 32
    kp = _words(rng, (pages + 1, hkv, page, dhp), dh)
    vt = _words(rng, (pages + 1, hkv, dh, page // 32), page)
    q = _words(rng, (b, h, dhp), dh)
    bt = rng.integers(0, pages + 1, (b, nblk)).astype(np.int32)
    lens = rng.integers(0, ring + 20, (b,)).astype(np.int32)
    lens[0] = 0
    th = rng.integers(-12, 12, (b, h)).astype(np.int32)
    return q, kp, vt, bt, lens, th


@pytest.mark.parametrize("b,h,hkv,dh,page,nblk,pages,ring", [
    (2, 4, 2, 32, 32, 3, 5, 96),          # GQA, full ring
    (3, 3, 1, 64, 64, 2, 4, 128),         # 1 KV head, page 64
    (2, 2, 2, 32, 32, 2, 3, 48),          # ring < nblk * page
    (1, 6, 3, 32, 64, 2, 5, 128),         # G=2, page 64
    (2, 4, 4, 32, 32, 1, 2, 32),          # MHA, single block
    (3, 9, 3, 48, 32, 3, 6, 96),          # d_h = 48: pad bits
])
def test_plain_paged_decode_matches_jax_kernel_and_oracles(
        b, h, hkv, dh, page, nblk, pages, ring):
    rng = np.random.default_rng(b * 1000 + h * 100 + page + dh)
    q, kp, vt, bt, lens, th = _pages(rng, b, h, hkv, dh, page, nblk, pages,
                                     ring)
    got = tops.paged_gather_decode(_t(q), _t(kp), _t(vt), _t(bt), _t(lens),
                                   ring, _t(th), d_h=dh)
    assert got.dtype == torch.int32 and got.shape == (b, h, dh)
    dense = tref.paged_gather_decode(_t(q), _t(kp), _t(vt), _t(bt),
                                     _t(lens), ring, _t(th), d_h=dh)
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    j = [jnp.asarray(a) for a in (q, kp, vt, bt, lens)]
    args = (*j, jnp.int32(ring), jnp.asarray(th))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jpk.paged_gather_decode(*args, d_h=dh, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jpref.paged_gather_decode(*args, d_h=dh)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jpref.paged_gather_decode_popcount(*args, d_h=dh)))


def test_wrapper_rejects_bad_word_counts_and_page_sizes():
    rng = np.random.default_rng(0)
    q, kp, vt, bt, lens, th = (_t(a) for a in _pages(rng, 2, 2, 1, 32, 32,
                                                     2, 3, 64))
    call = functools.partial(tops.paged_gather_decode, ring_len=64)
    with pytest.raises(ValueError, match="ceil"):
        call(q, kp, vt, bt, lens, theta=th, d_h=48)     # 1 word, d_h 48
    with pytest.raises(ValueError, match="ceil"):
        call(torch.cat([q, q], -1), kp, vt, bt, lens, theta=th, d_h=32)
    with pytest.raises(ValueError, match="multiple of 32"):
        call(q, kp[:, :, :16], vt, bt, lens, theta=th, d_h=32)
    with pytest.raises(ValueError, match="multiple of 32"):
        call(q, kp, torch.cat([vt, vt], -1), bt, lens, theta=th, d_h=32)
    with pytest.raises(TypeError, match="int32"):
        call(q, kp, vt, bt.long(), lens, theta=th, d_h=32)


# -- attention faces ---------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    jcfg = jbase.get_smoke_config("smollm-135m")
    jm = jbuild(jcfg)
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(
        jax.jit(jm.init)(jax.random.PRNGKey(0))))
    tm = tbuild(tbase.get_smoke_config("smollm-135m"))
    return dict(jcfg=jcfg, jm=jm, dp=dp, tm=tm,
                tdp=bridge.from_jax_params(dp, device="cpu"))


def _attn_layer0(smoke):
    jp = jax.tree.map(lambda t: t[0], smoke["dp"]["blocks"])["attn"]
    tp = smoke["tdp"]["blocks"][0]["attn"]
    return (JBlock(smoke["jcfg"])._parts()["attn"], jp,
            TBlock(smoke["tm"].cfg)._attn(), tp)


def _to_torch_cache(jc):
    if hasattr(jc, "block_table"):
        return PagedKVCache(_t(jc.k_pages), _t(jc.vt_pages),
                            _t(jc.block_table), _t(jc.length),
                            int(jc.ring_len))
    return KVCache(_t(jc.k_bits), _t(jc.vt_bits), _t(jc.length))


def _assert_cache_equal(jc, tc, live):
    if isinstance(tc, PagedKVCache):
        np.testing.assert_array_equal(_u32(tc.k_pages)[1:],
                                      np.asarray(jc.k_pages)[1:])
        np.testing.assert_array_equal(_u32(tc.vt_pages)[1:],
                                      np.asarray(jc.vt_pages)[1:])
    else:
        np.testing.assert_array_equal(_u32(tc.k_bits),
                                      np.asarray(jc.k_bits))
        np.testing.assert_array_equal(_u32(tc.vt_bits),
                                      np.asarray(jc.vt_bits))
    np.testing.assert_array_equal(tc.length.numpy()[live],
                                  np.asarray(jc.length)[live])


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=0)


def test_deploy_decode_paged_matches_jax(smoke):
    """Random pages and a table with a trash entry and an aliased page;
    two decode steps (the second reads what the first wrote)."""
    jattn, jp, tattn, tp = _attn_layer0(smoke)
    b, nblk, pages = 3, 3, 5
    rng = np.random.default_rng(5)
    jc = jattn.init_paged_cache(b, ring_len=nblk * 32, page_size=32,
                                num_blocks=nblk, num_pages=pages)
    bt = np.array([[1, 2, 0], [3, 0, 0], [4, 5, 1]], np.int32)
    jc = jc._replace(
        k_pages=jnp.asarray(_words(rng, jc.k_pages.shape, 32)),
        vt_pages=jnp.asarray(_words(rng, jc.vt_pages.shape, 32)),
        block_table=jnp.asarray(bt),
        length=jnp.asarray([40, 7, 0], jnp.int32))
    tc = _to_torch_cache(jc)
    jdec = jax.jit(jattn.deploy_decode)
    for _ in range(2):
        x = rng.standard_normal((b, 1, 96)).astype(np.float32)
        jout, jc = jdec(jp, jnp.asarray(x), jc)
        tout, tc = tattn.deploy_decode(tp, torch.from_numpy(x), tc)
        _close(tout, jout)
        _assert_cache_equal(jc, tc, live=slice(None))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_chunks_then_decode_match_jax(smoke, layout):
    """Ragged chunks continue ragged prefixes (an inactive row, a row
    whose chunk ends early), then a decode step, on both layouts."""
    jattn, jp, tattn, tp = _attn_layer0(smoke)
    b, c_len = 3, 32
    rng = np.random.default_rng(7)
    if layout == "paged":
        jc = jattn.init_paged_cache(b, ring_len=128, page_size=32,
                                    num_blocks=4, num_pages=10)
        bt = np.array([[1, 2, 3, 0], [4, 5, 6, 7], [8, 9, 0, 0]], np.int32)
        jc = jc._replace(block_table=jnp.asarray(bt))
    else:
        jc = jattn.init_cache(b, 100)
    tc = _to_torch_cache(jc)
    start = np.zeros(b, np.int32)
    live = np.array([True, True, True])
    jchunk = jax.jit(jattn.deploy_prefill_chunk)
    for valid in ([32, 20, 9], [32, 32, 0], [7, 32, 25]):
        valid = np.asarray(valid, np.int32)
        x = rng.standard_normal((b, c_len, 96)).astype(np.float32)
        jout, jc = jchunk(jp, jnp.asarray(x), jc, start=jnp.asarray(start),
                          valid_len=jnp.asarray(valid))
        tout, tc = tattn.deploy_prefill_chunk(
            tp, torch.from_numpy(x), tc, start=torch.from_numpy(start),
            valid_len=torch.from_numpy(valid))
        for r in range(b):       # pad rows are garbage in both packages
            _close(tout[r, :valid[r]], np.asarray(jout)[r, :valid[r]])
        _assert_cache_equal(jc, tc, live)
        start = start + valid
    x = rng.standard_normal((b, 1, 96)).astype(np.float32)
    jout, jc = jax.jit(jattn.deploy_decode)(jp, jnp.asarray(x), jc)
    tout, tc = tattn.deploy_decode(tp, torch.from_numpy(x), tc)
    _close(tout, jout)
    _assert_cache_equal(jc, tc, live)


# -- the continuous engine on a paged pool -----------------------------------

TRACE = dict(n_requests=8, mean_prompt=24, max_prompt=60, mean_new=6,
             max_new=10, vocab=256, seed=3)
TIMING = ("elapsed_s", "goodput_under_slo", "ttft_p50_s", "ttft_p99_s",
          "tenants")


def _requests(mod, tenant_prompt=0):
    cfg = mod.TraceConfig(tenants=(mod.TenantSpec(
        "default", system_prompt_len=tenant_prompt),), **TRACE)
    reqs = mod.as_requests(mod.generate_trace(cfg))
    for r in reqs:
        r.arrival_s = 0.0           # schedules depend on tokens only
    return reqs


def _engines(smoke, num_slots, cache, policy=None):
    """The JAX engine and the port's on the same params and settings."""
    def cfg(mod):
        return mod.ServeConfig(num_slots=num_slots,
                               cache=mod.CacheConfig(**cache),
                               policy=mod.PolicyConfig(**(policy or {})))
    jeng = jengine.ServeEngine(smoke["jm"], jax.tree.map(jnp.asarray,
                                                         smoke["dp"]),
                               cfg(jengine))
    teng = tengine.ServeEngine(smoke["tm"], smoke["tdp"], cfg(tengine),
                               device="cpu")
    return jeng, teng


def _assert_reports_equal(jrep, trep):
    keys = [k for k in jrep.keys()
            if k not in TIMING + ("unified_compiles", "engine_compiles")]
    assert "iterations" in keys
    for k in keys:
        assert trep[k] == pytest.approx(jrep[k]), k
    assert trep.unified_compiles is None and trep.engine_compiles is None


def test_serve_paged_tokens_and_report_equal_jax(smoke):
    jeng, teng = _engines(smoke, 4, dict(max_len=128, paged=True,
                                         page_size=32, prefix_share=False))
    jres, jrep = jeng.serve(_requests(jtrace))
    streamed = []
    tres, trep = teng.serve(_requests(ttrace),
                            stream_cb=lambda *a: streamed.append(a))
    assert sorted(tres) == sorted(jres) == list(range(8))
    for rid in jres:
        np.testing.assert_array_equal(tres[rid], np.asarray(jres[rid]))
    assert len(streamed) == sum(len(t) for t in tres.values())
    _assert_reports_equal(jrep, trep)
    assert trep.pages_total == 16 and trep.pages_used == 0


def test_generate_list_of_prompts_matches_jax(smoke):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (30, 29, 5, 40, 2)]
    jeng, teng = _engines(smoke, 2, dict(max_len=64, paged=True,
                                         page_size=32, num_pages=3),
                          dict(prefill_chunk=32))
    jout, jrep = jeng.generate(prompts, max_new_tokens=5)
    tout, trep = teng.generate(prompts, max_new_tokens=5)
    assert len(tout) == len(prompts)
    for j, t in zip(jout, tout):
        assert t.dtype == np.int32 and t.shape == (5,)
        np.testing.assert_array_equal(t, np.asarray(j))
    _assert_reports_equal(jrep, trep)
    assert trep.preemptions >= 1 and trep.prefill_chunks >= 1
    with pytest.raises(ValueError, match="continuous path"):
        teng.generate(np.stack([p[:2] for p in prompts]), max_new_tokens=2)
