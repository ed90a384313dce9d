"""seamless-m4t-large-v2's smoke config (the encoder-decoder: 2 encoder
and 2 decoder layers, d = 128, 4/4 heads, the ReLU FFN, LayerNorm, an
untied head, 8 frontend frames) in the port against the JAX package on the
CPU, float32.

Held: the configs; ``build_model``'s rule; the bridge's split of the
stacked ``encoder`` and ``decoder`` subtrees; ``encode``;
``prefill_logits``; ``prefill_with_cache`` (rings and memories bitwise)
then decode steps, each step's logits against JAX's (greedy ids exact);
the JAX package's ``test_encdec_decode_matches_prefill`` on the port (a
decode step equals the prefill at its position); the static engine's
greedy tokens against JAX's jitted greedy decode, its report's cache bytes
against JAX's ``cache_report`` (the memories counted); the launches of
every kernel wrapper on the path against ``kernel_times.encdec_calls``,
which sizes the card run's table; and the refusals (continuous serving,
paged pools, params on another device).  Logits within ATOL + RTOL *
|JAX|.  Params are the JAX package's, scales and thresholds moved off
their init values, bridged through numpy."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.lm import build_model as jbuild
from repro.serve import kvcache as jkv
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.rbmm import ops as rbmm_ops
from repro_torch.kernels.rbmm_mxu import ops as mxu_ops
from repro_torch.kernels.sps_attn import ops as sps_ops
from repro_torch.launch import kernel_times
from repro_torch.models.attention import PageSpec
from repro_torch.models.lm import EncDecModel, LMModel
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as E
from repro_torch.serve import kvcache as tkv

ATOL, RTOL = 1e-4, 1e-5
ARCH = "seamless-m4t-large-v2"
B, S = 2, 12


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
    jm = jbuild(jbase.get_smoke_config(ARCH))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return dict(jm=jm, dp=dp, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config(ARCH)),
                tdp=bridge.from_jax_params(dp, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit(face: str, **static):
    return jax.jit(functools.partial(getattr(_models()["jm"], face),
                                     **static))


def _inputs(seed=0, b=B, s=S):
    cfg = tbase.get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    fe = rng.standard_normal((b, cfg.frontend_tokens, min(cfg.d_model,
                                                          1024)),
                             dtype=np.float32)
    return toks, fe


def _close(t, j, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _same_caches(tcs, jcs):
    assert len(tcs) == len(jcs)
    for tc, jc in zip(tcs, jcs):
        assert sorted(tc) == sorted(jc) == ["attn", "cross"]
        for name in tc:
            t, j = tc[name], jc[name]
            np.testing.assert_array_equal(_u32(t.k_bits), np.asarray(j.k_bits))
            np.testing.assert_array_equal(_u32(t.vt_bits),
                                          np.asarray(j.vt_bits))
            np.testing.assert_array_equal(t.length.numpy(),
                                          np.asarray(j.length))


def test_configs_and_model_rule_match_jax():
    for arch in (ARCH, "internvl2-76b"):
        for get in ("get_config", "get_smoke_config"):
            tcfg, jcfg = getattr(tbase, get)(arch), getattr(jbase, get)(arch)
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            assert tcfg.param_count() == jcfg.param_count()
            assert type(tbuild(tcfg)).__name__ == type(jbuild(jcfg)).__name__
    cfg = tbase.get_config(ARCH)
    assert (cfg.num_layers, cfg.num_encoder_layers, cfg.d_model,
            cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size,
            cfg.act, cfg.glu, cfg.norm, cfg.binary.ffn_block_r) == (
        24, 24, 1024, 16, 16, 8192, 256206, "relu", False, "layernorm", 0)
    assert isinstance(tbuild(cfg), EncDecModel)
    assert isinstance(tbuild(tbase.get_config("internvl2-76b")), LMModel)
    # any encoder layers make an encoder-decoder, as in the JAX package
    assert isinstance(tbuild(tbase.get_smoke_config("smollm-135m").with_(
        num_encoder_layers=1)), EncDecModel)


def test_bridge_splits_the_encoder_and_decoder_stacks():
    m = _models()
    tdp, dp = m["tdp"], m["dp"]
    assert sorted(tdp) == sorted(dp) == ["decoder", "embed", "enc_norm",
                                         "encoder", "final_norm",
                                         "frontend", "head"]
    assert len(tdp["encoder"]) == len(tdp["decoder"]) == 2
    for key in ("encoder", "decoder"):
        for i, layer in enumerate(tdp[key]):
            np.testing.assert_array_equal(
                _u32(layer["attn"]["wq"]["w_packed"]),
                np.asarray(dp[key]["attn"]["wq"]["w_packed"][i]))
    np.testing.assert_array_equal(
        _u32(tdp["decoder"][1]["cross"]["wk"]["w_packed"]),
        np.asarray(dp["decoder"]["cross"]["wk"]["w_packed"][1]))
    assert sorted(tdp["decoder"][0]) == ["attn", "cross", "ffn", "norm1",
                                         "norm2", "norm_x"]
    # the port's own init has the same tree, layer lists and all
    own = m["tm"].convert(m["tm"].init(torch.Generator().manual_seed(0)))
    assert sorted(own) == sorted(tdp)
    assert sorted(own["decoder"][0]) == sorted(tdp["decoder"][0])


def test_encode_matches_jax():
    m = _models()
    _, fe = _inputs()
    with torch.inference_mode():
        got = m["tm"].encode(m["tdp"], torch.from_numpy(fe))
    want = _jit("encode", deploy=True)(m["jdp"], jnp.asarray(fe))
    assert got.shape == (B, 8, 128) and got.dtype == torch.float32
    _close(got, want, "memory")


def test_prefill_logits_matches_jax():
    m = _models()
    toks, fe = _inputs(1)
    with torch.inference_mode():
        got = m["tm"].prefill_logits(m["tdp"], toks, frontend_embeds=fe,
                                     device="cpu")
    want = _jit("prefill_logits")(m["jdp"], jnp.asarray(toks),
                                  frontend_embeds=jnp.asarray(fe))
    assert got.shape == (B, S, 256)
    _close(got, want, "logits")


def test_prefill_with_cache_then_decode_matches_jax():
    m = _models()
    toks, fe = _inputs(2)
    max_len = S + 4
    with torch.inference_mode():
        lg, tcs = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks).long(), max_len=max_len,
            frontend_embeds=torch.from_numpy(fe))
    jlg, jcs = _jit("prefill_with_cache", max_len=max_len)(
        m["jdp"], jnp.asarray(toks), frontend_embeds=jnp.asarray(fe))
    _close(lg, jlg, "prefill")
    _same_caches(tcs, jcs)
    jdec = _jit("decode_step")
    for step in range(3):
        tok = lg[:, -1:].argmax(-1)
        jtok = jnp.argmax(jlg[:, -1:], -1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        with torch.inference_mode():
            lg, tcs = m["tm"].decode_step(m["tdp"], tok, tcs)
        jlg, jcs = jdec(m["jdp"], jtok.astype(jnp.int32), jcs)
        _close(lg, jlg, f"decode step {step}")
    _same_caches(tcs, jcs)


def test_decode_matches_prefill():
    """The JAX package's ``test_encdec_decode_matches_prefill`` on the
    port: a decode step after a prefill of S - 1 tokens gives the whole
    prefill's logits at position S - 1."""
    m = _models()
    tm, tdp = m["tm"], m["tdp"]
    toks, fe = _inputs(3)
    t = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full = tm.prefill_logits(tdp, t, frontend_embeds=fe, device="cpu")
        _, caches = tm.prefill_with_cache(tdp, t[:, :S - 1], max_len=S + 4,
                                          frontend_embeds=fe)
        step, _ = tm.decode_step(tdp, t[:, S - 1:], caches)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               atol=ATOL, rtol=RTOL)


@functools.lru_cache(maxsize=None)
def _jax_greedy(n_new: int, max_len: int):
    """JAX's greedy static decode, jitted once: the engine's loop."""
    jm = _models()["jm"]

    def run(dp, toks, fe):
        lg, caches = jm.prefill_with_cache(dp, toks, max_len=max_len,
                                           frontend_embeds=fe)
        tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
        out = [tok]
        for _ in range(n_new - 1):
            lg, caches = jm.decode_step(dp, tok, caches)
            tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
            out.append(tok)
        return jnp.concatenate(out, 1), caches
    return jax.jit(run)


def test_static_engine_matches_jax_greedy():
    m = _models()
    toks, fe = _inputs(4)
    n_new, max_len = 6, S + 8
    eng = E.ServeEngine(m["tm"], m["tdp"], E.ServeConfig(
        cache=E.CacheConfig(max_len=max_len)), device="cpu")
    got, report = eng.generate(toks, max_new_tokens=n_new,
                               frontend_embeds=fe)
    want, jcaches = _jax_greedy(n_new, max_len)(m["jdp"], jnp.asarray(toks),
                                                jnp.asarray(fe))
    np.testing.assert_array_equal(got, np.asarray(want))
    # the pool took the memories' length from the prefill
    (key, pool), = eng._pools.items()
    assert key == (B, max_len, None, 8)
    assert pool[0]["cross"].k_bits.shape == (B, 4, 8, 1)
    # the report counts every leaf, the memories included, as JAX's
    jrep = jkv.cache_report(jcaches, seq_len=S + n_new, batch=B)
    for f in ("total_bytes", "bf16_equivalent_bytes", "compression_vs_bf16"):
        assert report[f] == pytest.approx(jrep[f]), f
    assert tkv.cache_bytes(pool) == report["total_bytes"]


def test_continuous_serving_and_paged_pools_refuse_the_encoder_decoder():
    m = _models()
    toks, fe = _inputs(5)
    eng = E.ServeEngine(m["tm"], m["tdp"], E.ServeConfig(
        cache=E.CacheConfig(max_len=32)), device="cpu")
    with pytest.raises(ValueError, match="static path"):
        eng.generate(list(toks), max_new_tokens=2, frontend_embeds=fe)
    with pytest.raises(ValueError, match="decoder-only token models"):
        eng.generate(list(toks), max_new_tokens=2)
    with pytest.raises(ValueError, match="contiguous rings only"):
        m["tm"].init_caches(B, 32, "cpu", paged=PageSpec(max_blocks=1))
    with pytest.raises(ValueError, match="params lie on cpu"):
        m["tm"].prefill_logits(m["tdp"], toks, frontend_embeds=fe,
                               device="meta")


def _trace_calls(monkeypatch):
    """Record every kernel wrapper's call as ``encdec_calls`` specs it:
    {(kernel, spec): calls}."""
    seen = collections.Counter()

    def rec(mod, name, kernel, spec):
        orig = getattr(mod, name)

        def f(*a, **kw):
            seen[(kernel, spec(*a, **kw))] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, f)

    rec(pack_ops, "pack_threshold", "pack_threshold", lambda x, th: (
        tuple(x.shape), str(x.dtype).split(".")[1], tuple(th.shape),
        not x.is_contiguous()))
    rec(rbmm_ops, "rbmm_int", "rbmm_int",
        lambda a, b, k, scheme="xnor", dc=None: (
            tuple(a.shape[:-2]), a.shape[-2], b.shape[-2], k, scheme))
    rec(rbmm_ops, "rbmm_binary", "rbmm_binary",
        lambda a, b, k, theta, scheme="xnor", dc=None, causal=False,
        pack_output=False: (a.shape[-2], b.shape[-2], k))
    rec(mxu_ops, "rbmm_mxu", "rbmm_mxu", lambda a, w: (
        a.shape[-2], a.shape[-1], w.shape[-2], bool((a >= 0).all())))
    rec(sps_ops, "sps_attention_gqa", "sps_attention",
        lambda q, k, vt, th, d_h, causal=True, lens=None, window=0: (
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], d_h, causal,
            lens, window, 0))
    return seen


def test_encdec_calls_match_the_traced_path(monkeypatch):
    """``kernel_times.encdec_calls``, which sizes the card run's table
    (``ENCDEC_CALLS``) and its launch checks from a config, at smoke size:
    each path's calls and launches per step equal the kernel wrappers'
    calls in a static prefill (the encoder, then the decoder over the
    prompt) and a static decode step."""
    m = _models()
    tm, tdp = m["tm"], m["tdp"]
    b, s, new = 3, 20, 4
    table = kernel_times.encdec_calls(tm.cfg, (b, s, new))
    toks, fe = _inputs(6, b, s)
    seen = _trace_calls(monkeypatch)
    runs = {}
    with torch.inference_mode():
        seen.clear()
        lg, caches = tm.prefill_with_cache(
            tdp, torch.from_numpy(toks).long(), max_len=s + new,
            frontend_embeds=torch.from_numpy(fe))
        runs["prefill"] = dict(seen)
        seen.clear()
        tm.decode_step(tdp, lg[:, -1:].argmax(-1), caches)
        runs["decode"] = dict(seen)
    for path, calls in runs.items():
        want = collections.Counter()
        for name, (kernel, spec, n) in table.items():
            if name.startswith(f"{kernel} seamless {path} "):
                want[(kernel, spec)] += n
        assert dict(want) == calls, path
