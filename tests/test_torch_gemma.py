"""gemma3-27b's smoke config in the port against the JAX package on the CPU:
6 layers in a 5:1 local:global plan (layers 0-4 local with a window of 8,
layer 5 global), GQA 2:1 at d_h = 32, the GELU GLU, a tied head, float32.

Held: the layer plan; ``prefill_logits``; ``prefill_with_cache`` (rings of
8 for the local layers, of ``max_len`` for the global one) then greedy
decode; ragged chunks continuing ring caches and paged ring groups (the
local group of 8-token rings, the global one of the capacity), then a
decode step; the verify and commit; the port's static ``generate``, equal to
JAX's greedy ids; the GELU GLU FFN.  Serving is in
``test_torch_gemma_serve.py``.
Words, caches and lengths bitwise; logits within ATOL (the frameworks sum
RMSNorm, RoPE and the head in other orders).  Params are the JAX
package's, scales and thresholds moved off their init values, bridged
through numpy."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.attention import PageSpec as JPageSpec
from repro.models.ffn import BinaryFFN as JFFN
from repro.models.lm import _layer_plan
from repro.models.lm import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.attention import PageSpec as TPageSpec
from repro_torch.models.ffn import BinaryFFN as TFFN
from repro_torch.models.ffn import glu_act
from repro_torch.models.linear import act_bits_packed
from repro_torch.models.lm import build_model as tbuild
from repro_torch.models.lm import layer_plan
from repro_torch.serve import engine as tengine

ATOL = 1e-4
B, S, MAX_LEN = 2, 20, 48


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


@functools.lru_cache(maxsize=None)
def _jit(face: str, **static):
    """The JAX model's face, jitted once for the file (``static`` bound)."""
    return jax.jit(functools.partial(getattr(_models()["jm"], face),
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


def test_layer_plan_matches_jax():
    for arch, kw in (("gemma3-27b", {}), ("smollm-135m", {}),
                     ("smollm-135m", dict(window_size=16))):
        for get in ("get_config", "get_smoke_config"):
            jcfg = getattr(jbase, get)(arch).with_(**kw)
            tcfg = getattr(tbase, get)(arch).with_(**kw)
            assert layer_plan(tcfg) == _layer_plan(jcfg)
    plan = layer_plan(tbase.get_config("gemma3-27b").truncated(12))
    assert [i for i, (_, w) in enumerate(plan) if not w] == [5, 11]
    assert {w for _, w in plan} == {0, 1024}


def test_prefill_logits_matches_jax():
    """JAX scans the layers with the window as per-layer data on its
    dense mask; the port runs each layer's window through the kernel's
    operand: the same integers."""
    m = _models()
    toks = np.random.default_rng(4).integers(0, 256, (B, 40)).astype(
        np.int32)
    jl = jax.jit(m["jm"].prefill_logits)(m["jdp"], jnp.asarray(toks))
    tl = m["tm"].prefill_logits(m["tdp"], torch.from_numpy(toks),
                                device="cpu")
    _close(tl, jl)


def test_prefill_then_decode_steps():
    """Rings of 8 (local, wrapped by the 20-token prompt) and of 48
    (global); 5 greedy decode steps."""
    m = _models()
    toks = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    jl, jc = _jit("prefill_with_cache", max_len=MAX_LEN)(
        m["jdp"], jnp.asarray(toks))
    tl, tc = m["tm"].prefill_with_cache(m["tdp"], torch.from_numpy(toks),
                                        max_len=MAX_LEN)
    assert [c["attn"].k_bits.shape[2] for c in tc] == [8] * 5 + [MAX_LEN]
    _close(tl, jl)
    greedy = []
    for step in range(5):
        _assert_caches_equal(jc, tc)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok,
                                      err_msg=f"step {step}")
        greedy.append(tok)
        jl, jc = _jit("decode_step")(m["jdp"], jnp.asarray(tok), jc)
        tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tc)
        _close(tl, jl)
    _assert_caches_equal(jc, tc)
    # the port's static engine (its decode step a graph object) gives
    # the same greedy ids
    eng = tengine.ServeEngine(m["tm"], m["tdp"], tengine.ServeConfig(
        cache=tengine.CacheConfig(max_len=MAX_LEN)), device="cpu")
    toks_out, _ = eng.generate(toks, max_new_tokens=5)
    np.testing.assert_array_equal(toks_out, np.concatenate(greedy, 1))


SPEC = dict(page_size=32, max_blocks=3, num_pages=9)


def _pools(m, b, layout):
    """Empty JAX and port pools of ``b`` slots: rings (8 local, 100
    global), or paged ring groups (local: one page a row; global: 3
    blocks over 9 pages) with the same block tables."""
    if layout == "ring":
        return m["jm"].init_caches(b, 100), m["tm"].init_caches(b, 100,
                                                                 "cpu")
    tables = {8: np.array([[1], [2], [3]], np.int32),
              96: np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)}
    jc = m["jm"].init_caches(b, 0, paged=JPageSpec(**SPEC))
    jc = [dict(c, attn=c["attn"]._replace(block_table=jnp.asarray(
        tables[int(c["attn"].ring_len)]))) for c in jc]
    tc = m["tm"].init_caches(b, 0, "cpu", paged=TPageSpec(**SPEC))
    for c in tc:
        c["attn"].block_table.copy_(torch.from_numpy(
            tables[c["attn"].ring_len]))
    return jc, tc


def _chunks(m, jc, tc, rng, b):
    start = np.zeros(b, np.int32)
    jfn = _jit("prefill_with_cache")
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
def test_chunks_then_decode(layout):
    m = _models()
    b = 3
    rng = np.random.default_rng(2)
    jc, tc = _pools(m, b, layout)
    jc, _ = _chunks(m, jc, tc, rng, b)
    tok = rng.integers(0, 256, (b, 1)).astype(np.int32)
    jl, jc = _jit("decode_step")(m["jdp"], jnp.asarray(tok), jc)
    tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tc)
    _close(tl, jl)
    _assert_caches_equal(jc, tc)


def test_verify_and_commit():
    m = _models()
    b = 3
    rng = np.random.default_rng(3)
    jc, tc = _pools(m, b, "paged")
    jc, start = _chunks(m, jc, tc, rng, b)
    chunk = rng.integers(0, 256, (b, 5)).astype(np.int32)
    jl, jprojs = _jit("verify_with_cache")(
        m["jdp"], jnp.asarray(chunk), jc, start=jnp.asarray(start))
    tl, tprojs = m["tm"].verify_with_cache(
        m["tdp"], torch.from_numpy(chunk), tc, start=torch.from_numpy(start))
    _close(tl, jl)
    _assert_caches_equal(jc, tc)
    n_commit = np.array([2, 0, 5], np.int32)
    jc = _jit("commit_chunks")(jc, jprojs, jnp.asarray(start),
                               jnp.asarray(n_commit))
    m["tm"].commit_chunks(tc, tprojs, torch.from_numpy(start),
                          torch.from_numpy(n_commit))
    _assert_caches_equal(jc, tc)


def test_gelu_glu_ffn_matches_jax():
    """The GELU GLU deploy FFN (d = 128, d_ff = 256) on 64 rows.  Both
    packages take the same integer gate and up products; h = gelu(u) * g
    (``jax.nn.gelu``'s tanh form against ``F.gelu(approximate="tanh")``)
    may round apart by an ulp, so it is held within 1e-5, and a bit of h's
    binarization could flip only where h lies within an ulp of the
    threshold: on these draws none may (0 of 16,384 bits).  The outputs
    within ATOL."""
    jf = JFFN(128, 256, act="gelu", glu=True)
    tf = TFFN(128, 256, act="gelu", glu=True)
    p = _perturb(jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(8))),
                 np.random.default_rng(8))
    dp = jax.tree.map(np.asarray, jf.convert(p))
    tp = bridge.from_jax_params(dp, device="cpu")
    x = np.random.default_rng(9).standard_normal((64, 128)).astype(
        np.float32)
    bits = act_bits_packed(torch.from_numpy(x), tp["act_beta"])
    aa = tp["act_alpha"]
    c_u, s1 = tf._mm_int(tp["w1"], bits, 128)
    c_g, s3 = tf._mm_int(tp["w3"], bits, 128)
    u = c_u.to(torch.float32) * s1 * aa
    g = c_g.to(torch.float32) * s3 * aa
    h_t = (glu_act("gelu", u) * g).numpy()
    h_j = np.asarray(jf._act_fn(jnp.asarray(u.numpy())) *
                     jnp.asarray(g.numpy()))
    np.testing.assert_allclose(h_t, h_j, atol=1e-5, rtol=0)
    thr = float(tp["h_beta"] + 0.5 * tp["h_alpha"])
    assert ((h_t >= thr) != (h_j >= thr)).sum() == 0
    assert 0 < (h_t >= thr).mean() < 1
    jy = jf.apply_deploy(jax.tree.map(jnp.asarray, dp), jnp.asarray(x))
    ty = tf.apply_deploy(tp, torch.from_numpy(x))
    _close(ty, jy)
