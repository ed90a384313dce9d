"""mixtral-8x22b's and arctic-480b's smoke configs in the port against the
JAX package on the CPU: 2 layers, d = 128, GQA 2:1 at d_h = 32, float32;
mixtral 4 experts (a window of 16 on every layer), arctic 8 experts and the
dense residual (full attention); both top-2 and dropless.

Held: the configs (full and smoke, field for field) and
``param_count`` / ``active_param_count`` of the full configs;
``prefill_logits``; ``prefill_with_cache`` then greedy decode, and the
port's static engine (``generate``) giving the same ids and JAX's
``cache_report``; ragged chunks continuing
ring caches and paged caches (mixtral's ring group of 16 tokens lies below
a page of 32: one page a row), then a decode step; the verify and commit.
Words, caches and lengths bitwise; logits within ATOL (the frameworks sum
RMSNorm, RoPE, the router and the head in other orders).  Params are the
JAX package's, scales and thresholds moved off their init values, bridged
through numpy."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.attention import PageSpec as JPageSpec
from repro.models.lm import build_model as jbuild
from repro.serve import kvcache as jkv
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.launch import kernel_times
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.attention import PageSpec as TPageSpec
from repro_torch.models.ffn import BinaryMoE
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as tengine

ATOL = 1e-4
B, S, MAX_LEN = 2, 20, 48
ARCHS = ("mixtral-8x22b", "arctic-480b")


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
def _models(arch):
    jm = jbuild(jbase.get_smoke_config(arch))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config(arch)),
                tdp=bridge.from_jax_params(dp, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit(arch: str, face: str, **static):
    """The JAX model's face, jitted once for the file (``static`` bound)."""
    return jax.jit(functools.partial(getattr(_models(arch)["jm"], face),
                                     **static))


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


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=0)


def test_configs_and_param_counts_match_jax():
    for arch in ARCHS:
        for get in ("get_config", "get_smoke_config"):
            tcfg = getattr(tbase, get)(arch)
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(
                getattr(jbase, get)(arch))
            assert tcfg.family == "moe"
        full, jfull = tbase.get_config(arch), jbase.get_config(arch)
        assert full.param_count() == jfull.param_count()
        assert full.active_param_count() == jfull.active_param_count()
        smoke = tbase.get_smoke_config(arch)
        # the smoke configs are dropless: cf >= E / k
        assert smoke.moe.capacity_factor >= \
            smoke.moe.num_experts / smoke.moe.top_k
    mix, arc = (tbase.get_config(a) for a in ARCHS)
    assert (mix.moe.num_experts, mix.window_size, arc.moe.num_experts,
            arc.moe.dense_residual) == (8, 4096, 128, True)
    ffn = tbuild(mix.truncated(1))._block()._ffn()
    assert isinstance(ffn, BinaryMoE) and ffn.capacity(8) == 4
    assert tbuild(arc.truncated(1))._block()._ffn().capacity(8) == 1
    # the card's kernel table (``kernel_times.MOE_CALLS``) sizes its calls
    # by the same capacities: (E, capacity, ...) operands
    names = " ".join(kernel_times.MOE_CALLS)
    for call in ("mixtral decode experts w1/w3 (8,4,192)",
                 "mixtral verify experts w1/w3 (8,20,6144)",
                 "mixtral prefill experts w1/w3 (8,2048,6144)",
                 "arctic decode experts w1/w3 (128,1,224)",
                 "arctic prefill experts w1/w3 (128,32,7168)"):
        assert call in names, call


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_matches_jax(arch):
    m = _models(arch)
    toks = np.random.default_rng(4).integers(0, 256, (B, 40)).astype(
        np.int32)
    jl = jax.jit(m["jm"].prefill_logits)(m["jdp"], jnp.asarray(toks))
    tl = m["tm"].prefill_logits(m["tdp"], torch.from_numpy(toks),
                                device="cpu")
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps(arch):
    """Rings of 16 (mixtral's window, wrapped by the 20-token prompt) or
    48 (arctic); 5 greedy decode steps; the port's static engine gives the
    same greedy ids."""
    m = _models(arch)
    toks = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    jl, jc = _jit(arch, "prefill_with_cache", max_len=MAX_LEN)(
        m["jdp"], jnp.asarray(toks))
    tl, tc = m["tm"].prefill_with_cache(m["tdp"], torch.from_numpy(toks),
                                        max_len=MAX_LEN)
    ring = 16 if arch == "mixtral-8x22b" else MAX_LEN
    assert [c["attn"].k_bits.shape[2] for c in tc] == [ring] * 2
    _close(tl, jl)
    greedy, after = [], {}
    for step in range(5):
        after[step] = jc        # JAX's caches after ``step`` decode steps
        _assert_caches_equal(jc, tc)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok,
                                      err_msg=f"step {step}")
        greedy.append(tok)
        jl, jc = _jit(arch, "decode_step")(m["jdp"], jnp.asarray(tok), jc)
        tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tc)
        _close(tl, jl)
    _assert_caches_equal(jc, tc)
    eng = tengine.ServeEngine(m["tm"], m["tdp"], tengine.ServeConfig(
        cache=tengine.CacheConfig(max_len=MAX_LEN)), device="cpu")
    toks_out, rep = eng.generate(toks, max_new_tokens=5)
    np.testing.assert_array_equal(toks_out, np.concatenate(greedy, 1))
    # the engine's caches after its 4 decode steps, as the JAX engine
    # reports them
    jrep = jkv.cache_report(after[4], seq_len=S + 5, batch=B)
    assert sorted(rep.keys()) == sorted(jrep.keys())
    for k in jrep.keys():
        assert rep[k] == pytest.approx(jrep[k]), k


SPEC = dict(page_size=32, max_blocks=3, num_pages=9)
TABLES = {16: np.array([[1], [2], [3]], np.int32),
          96: np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)}


def _pools(m, b, layout):
    """Empty JAX and port pools of ``b`` slots: rings of 100 (16 in
    mixtral's windowed layers), or paged pools with the same block tables
    (mixtral: the ring group of 16 tokens, one page a row; arctic: 3
    blocks over 9 pages)."""
    if layout == "ring":
        return m["jm"].init_caches(b, 100), m["tm"].init_caches(b, 100,
                                                                 "cpu")
    jc = m["jm"].init_caches(b, 0, paged=JPageSpec(**SPEC))
    jc = [dict(c, attn=c["attn"]._replace(block_table=jnp.asarray(
        TABLES[int(c["attn"].ring_len)]))) for c in jc]
    tc = m["tm"].init_caches(b, 0, "cpu", paged=TPageSpec(**SPEC))
    for c in tc:
        c["attn"].block_table.copy_(torch.from_numpy(
            TABLES[c["attn"].ring_len]))
    return jc, tc


def _chunks(arch, m, jc, tc, rng, b):
    start = np.zeros(b, np.int32)
    jfn = _jit(arch, "prefill_with_cache")
    for valid in ([24, 11, 3], [24, 0, 19]):
        valid = np.asarray(valid, np.int32)
        toks = rng.integers(0, 256, (b, 24)).astype(np.int32)
        jl, jc = jfn(m["jdp"], jnp.asarray(toks), caches=jc,
                     start=jnp.asarray(start), seq_lens=jnp.asarray(valid))
        tl, _ = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks), caches=tc,
            start=torch.from_numpy(start), seq_lens=torch.from_numpy(valid))
        live = valid > 0
        _close(tl[live], np.asarray(jl)[live])
        _assert_caches_equal(jc, tc)
        start = start + valid
    return jc, start


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunks_then_decode(arch, layout):
    """Two pooled chunks of 24 (a row idle in the second: it still routes
    and takes capacity, as in JAX), then a decode step."""
    m = _models(arch)
    b = 3
    rng = np.random.default_rng(2)
    jc, tc = _pools(m, b, layout)
    if layout == "paged":
        ring = 16 if arch == "mixtral-8x22b" else 96
        assert {c["attn"].ring_len for c in tc} == {ring}
        assert tc[0]["attn"].block_table.shape == (b, -(-ring // 32))
    jc, _ = _chunks(arch, m, jc, tc, rng, b)
    tok = rng.integers(0, 256, (b, 1)).astype(np.int32)
    jl, jc = _jit(arch, "decode_step")(m["jdp"], jnp.asarray(tok), jc)
    tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tc)
    _close(tl, jl)
    _assert_caches_equal(jc, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_verify_and_commit(arch):
    m = _models(arch)
    b = 3
    rng = np.random.default_rng(3)
    jc, tc = _pools(m, b, "paged")
    jc, start = _chunks(arch, m, jc, tc, rng, b)
    chunk = rng.integers(0, 256, (b, 5)).astype(np.int32)
    jl, jprojs = _jit(arch, "verify_with_cache")(
        m["jdp"], jnp.asarray(chunk), jc, start=jnp.asarray(start))
    tl, tprojs = m["tm"].verify_with_cache(
        m["tdp"], torch.from_numpy(chunk), tc, start=torch.from_numpy(start))
    _close(tl, jl)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))
    _assert_caches_equal(jc, tc)
    n_commit = np.array([2, 0, 5], np.int32)
    jc = _jit(arch, "commit_chunks")(jc, jprojs, jnp.asarray(start),
                                     jnp.asarray(n_commit))
    m["tm"].commit_chunks(tc, tprojs, torch.from_numpy(start),
                          torch.from_numpy(n_commit))
    _assert_caches_equal(jc, tc)
