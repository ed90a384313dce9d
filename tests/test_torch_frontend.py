"""The frontend stub on the decoder-only model: internvl2-76b's smoke
config (2 layers, d = 128, 4/2 heads, the SiLU GLU, RoPE, an untied head,
8 patch embeddings prepended to the prompt) in the port against the JAX
package on the CPU, float32.

Held: ``prefill_logits`` with ``frontend_embeds`` (logits at all F + S
positions); ``prefill_with_cache`` (rings of F + S + new tokens bitwise)
then decode steps continuing at position F + S; the ragged prefill, whose
``seq_lens`` count the tokens only; the static engine's greedy tokens
against JAX's jitted greedy decode; the CLI on both frontend archs; the
dtypes of a bfloat16 config's streams against JAX's (the projected
patches promote the prefill's residual stream to float32, the
encoder-decoder's encoder runs float32 and its decoder bfloat16, at
prefill and decode alike); and the refusals JAX makes (continuous
serving, chunk continuation, speculative verify; the port also refuses
the truncated draft).  Logits within ATOL + RTOL * |JAX|.  Params are
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
from repro.models.lm import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as serve_cli
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import engine as E

ATOL, RTOL = 1e-4, 1e-5
ARCH = "internvl2-76b"
B, S, F = 2, 12, 8


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
    return dict(jm=jm, jdp=jax.tree.map(jnp.asarray, dp),
                tm=tbuild(tbase.get_smoke_config(ARCH)),
                tdp=bridge.from_jax_params(dp, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jit(face: str, **static):
    return jax.jit(functools.partial(getattr(_models()["jm"], face),
                                     **static))


def _inputs(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (b, s)).astype(np.int32)
    fe = rng.standard_normal((b, F, 128), dtype=np.float32)
    return toks, fe


def _close(t, j, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _same_rings(tcs, jcs):
    for tc, jc in zip(tcs, jcs):
        t, j = tc["attn"], jc["attn"]
        np.testing.assert_array_equal(_u32(t.k_bits), np.asarray(j.k_bits))
        np.testing.assert_array_equal(_u32(t.vt_bits), np.asarray(j.vt_bits))
        np.testing.assert_array_equal(t.length.numpy(), np.asarray(j.length))


def test_prefill_logits_with_frontend_matches_jax():
    m = _models()
    toks, fe = _inputs(1)
    with torch.inference_mode():
        got = m["tm"].prefill_logits(m["tdp"], toks, frontend_embeds=fe,
                                     device="cpu")
    want = _jit("prefill_logits")(m["jdp"], jnp.asarray(toks),
                                  frontend_embeds=jnp.asarray(fe))
    assert got.shape == (B, F + S, 256)
    _close(got, want, "logits")
    with pytest.raises(ValueError, match="needs frontend_embeds"):
        m["tm"].prefill_logits(m["tdp"], toks, device="cpu")


def test_prefill_with_cache_then_decode_matches_jax():
    m = _models()
    toks, fe = _inputs(2)
    max_len = F + S + 4
    with torch.inference_mode():
        lg, tcs = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks).long(), max_len=max_len,
            frontend_embeds=torch.from_numpy(fe))
    jlg, jcs = _jit("prefill_with_cache", max_len=max_len)(
        m["jdp"], jnp.asarray(toks), frontend_embeds=jnp.asarray(fe))
    _close(lg, jlg, "prefill")
    _same_rings(tcs, jcs)
    assert (tcs[0]["attn"].length == F + S).all()
    jdec = _jit("decode_step")
    for step in range(3):
        tok = lg[:, -1:].argmax(-1)
        jtok = jnp.argmax(jlg[:, -1:], -1)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        with torch.inference_mode():
            lg, tcs = m["tm"].decode_step(m["tdp"], tok, tcs)
        jlg, jcs = jdec(m["jdp"], jtok.astype(jnp.int32), jcs)
        _close(lg, jlg, f"decode step {step}")
    _same_rings(tcs, jcs)


def test_ragged_prefill_counts_tokens_after_the_frontend():
    m = _models()
    toks, fe = _inputs(3)
    lens = np.array([S, 5], np.int32)
    max_len = F + S + 4
    with torch.inference_mode():
        lg, tcs = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks).long(), max_len=max_len,
            frontend_embeds=torch.from_numpy(fe),
            seq_lens=torch.from_numpy(lens))
    jlg, jcs = _jit("prefill_with_cache", max_len=max_len)(
        m["jdp"], jnp.asarray(toks), frontend_embeds=jnp.asarray(fe),
        seq_lens=jnp.asarray(lens))
    _close(lg, jlg, "ragged prefill")
    _same_rings(tcs, jcs)
    np.testing.assert_array_equal(tcs[0]["attn"].length.numpy(), lens + F)


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
        return jnp.concatenate(out, 1)
    return jax.jit(run)


def test_static_engine_matches_jax_greedy():
    m = _models()
    toks, fe = _inputs(4)
    n_new, max_len = 6, F + S + 8
    eng = E.ServeEngine(m["tm"], m["tdp"], E.ServeConfig(
        cache=E.CacheConfig(max_len=max_len)), device="cpu")
    got, report = eng.generate(toks, max_new_tokens=n_new,
                               frontend_embeds=fe)
    want = _jax_greedy(n_new, max_len)(m["jdp"], jnp.asarray(toks),
                                       jnp.asarray(fe))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert report["compression_vs_bf16"] > 1


def test_frontend_models_refuse_the_token_only_faces():
    m = _models()
    tm, tdp = m["tm"], m["tdp"]
    toks, fe = _inputs(5)
    eng = E.ServeEngine(tm, tdp, E.ServeConfig(
        cache=E.CacheConfig(max_len=32)), device="cpu")
    with pytest.raises(ValueError, match="static path"):
        eng.generate(list(toks), max_new_tokens=2, frontend_embeds=fe)
    with pytest.raises(ValueError, match="decoder-only token models"):
        eng.serve([E.Request(rid=0, tokens=toks[0], max_new_tokens=2)])
    t = torch.from_numpy(toks).long()
    with torch.inference_mode():
        _, caches = tm.prefill_with_cache(tdp, t, max_len=32,
                                          frontend_embeds=fe)
        with pytest.raises(ValueError, match="chunked prefill"):
            tm.prefill_with_cache(tdp, t[:, :2], caches=caches)
        with pytest.raises(ValueError, match="speculative verify"):
            tm.verify_with_cache(tdp, t[:, :2], caches)
        with pytest.raises(ValueError, match="speculative draft"):
            tm.truncate_deploy(tdp, 1)
    # a token-only model refuses frontend embeddings on a chunk too
    tok_only = tbuild(tbase.get_smoke_config("smollm-135m"))
    with pytest.raises(ValueError, match="chunked prefill"):
        tok_only.prefill_with_cache({}, t, caches=[], frontend_embeds=fe)


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_serve_cli_draws_frontend_embeds(arch, capsys):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out, out


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_bf16_streams_keep_jax_dtypes():
    """In bfloat16 the prepended patches (projected in float32) promote
    the decoder-only prefill's stream to float32; an encoder-decoder's
    encoder runs float32 (its frontend is applied as given) and its
    decoder bfloat16.  The port's streams and logits have JAX's dtypes."""
    for arch in (ARCH, "seamless-m4t-large-v2"):
        jcfg = jbase.get_smoke_config(arch).with_(compute_dtype="bfloat16")
        tcfg = tbase.get_smoke_config(arch).with_(compute_dtype="bfloat16")
        jm, tm = jbuild(jcfg), tbuild(tcfg)
        jp = jax.eval_shape(lambda k: jm.convert(jm.init(k)),
                            jax.random.PRNGKey(0))
        with torch.inference_mode():
            tp = tm.convert(tm.init(torch.Generator().manual_seed(0)))
            toks, fe = _inputs(6)
            t = torch.from_numpy(toks).long()
            jt, jfe = jnp.asarray(toks), jnp.asarray(fe)
            if arch == ARCH:
                pairs = [(tm._embed_tokens(tp, t, fe),
                          jax.eval_shape(jm._embed_tokens, jp, jt, jfe))]
            else:
                pairs = [(tm.encode(tp, torch.from_numpy(fe)),
                          jax.eval_shape(functools.partial(
                              jm.encode, deploy=True), jp, jfe)),
                         (tm._embed_tokens(tp, t[:, :1]),
                          jax.eval_shape(jm._embed_tokens, jp, jt[:, :1]))]
            lg, caches = tm.prefill_with_cache(tp, t, max_len=F + S + 2,
                                               frontend_embeds=fe)
            jlg, jcaches = jax.eval_shape(functools.partial(
                jm.prefill_with_cache, max_len=F + S + 2), jp, jt,
                frontend_embeds=jfe)
            pairs.append((lg, jlg))
            dec = tm.decode_step(tp, lg[:, -1:].argmax(-1), caches)[0]
            pairs.append((dec, jax.eval_shape(
                jm.decode_step, jp, jnp.zeros((B, 1), jnp.int32),
                jcaches)[0]))
        for i, (got, want) in enumerate(pairs):
            assert _dtype(got) == str(want.dtype), (arch, i)
            assert tuple(got.shape) == want.shape, (arch, i)
