"""hymba-1.5b's and xlstm-350m's smoke configs in the port against the JAX
package on the CPU, float32: hymba 2 hybrid layers (attention with a window
of 16, GQA 2:1 at d_h = 32, and a Mamba branch of state 4, averaged, then
the SiLU GLU), xlstm 4 layers (mLSTM, sLSTM, mLSTM, sLSTM; 2 heads, no
FFN).

Held: the configs, ``param_count`` and the layer plans; ``prefill_logits``;
``prefill_with_cache`` then greedy decode (held to JAX's jitted faces:
ids exact); the ragged whole-prompt prefill; two pooled chunks on a paged
pool (hymba's ring group of 16 tokens, one page a row; xlstm has no
attention) with an idle row, then a decode step; ``reset_recurrent_rows``
(the init carries exactly, in place, other rows untouched); the extract
-> park -> write back elsewhere -> resume round trip of
``test_recurrent_resume.py`` (bitwise equal to the port's whole-prompt
prefill inserted into the slot); ``slot_lengths`` / ``cache_bytes`` /
``bf16_equivalent_bytes``; and ``kernel_times.recurrent_calls``, the card
run's table of kernel calls, against the calls the path makes at smoke
size.  Attention words and lengths bitwise; logits and carries within
ATOL + RTOL * |JAX| (the frameworks sum RMSNorm, the scans and the head in
other orders).  Params are the JAX package's, scales and thresholds moved
off their init values, bridged through numpy."""
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
from repro.models.attention import PageSpec as JPageSpec
from repro.models.lm import _layer_plan
from repro.models.lm import build_model as jbuild
from repro.serve import kvcache as jkv
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.kernels.paged_attn import ops as paged_ops
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.rbmm import ops as rbmm_ops
from repro_torch.kernels.rbmm_mxu import ops as mxu_ops
from repro_torch.kernels.sps_attn import ops as sps_ops
from repro_torch.launch import kernel_times
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.attention import PageSpec as TPageSpec
from repro_torch.models.lm import build_model as tbuild
from repro_torch.models.lm import layer_plan
from repro_torch.serve import kvcache as tkv

ATOL, RTOL = 1e-4, 1e-5
B, S, MAX_LEN = 2, 20, 32
ARCHS = ("hymba-1.5b", "xlstm-350m")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng, name) for v in tree]
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


def _close(t, j, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _assert_caches_close(jcs, tcs):
    """Attention words and lengths bitwise (pages 1.. of a paged cache),
    recurrent carries within tolerance."""
    assert len(jcs) == len(tcs)
    for i, (jc, tc) in enumerate(zip(jcs, tcs)):
        assert sorted(jc) == sorted(tc), i
        for name, t in tc.items():
            j = jc[name]
            if name == "attn":
                if isinstance(t, PagedKVCache):
                    pairs = ((t.k_pages[1:], j.k_pages[1:]),
                             (t.vt_pages[1:], j.vt_pages[1:]))
                else:
                    pairs = ((t.k_bits, j.k_bits), (t.vt_bits, j.vt_bits))
                for a, b in pairs:
                    np.testing.assert_array_equal(_u32(a), np.asarray(b))
                np.testing.assert_array_equal(t.length.numpy(),
                                              np.asarray(j.length))
            else:
                for f, a, b in zip(t._fields, t, j):
                    _close(a, b, f"layer {i} {name}.{f}")


def _tensors(caches):
    return [t for layer in caches for part in layer.values() for t in part
            if isinstance(t, torch.Tensor)]


def _toks(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_configs_and_plans_match_jax():
    for arch in ARCHS:
        for get in ("get_config", "get_smoke_config"):
            tcfg, jcfg = getattr(tbase, get)(arch), getattr(jbase, get)(arch)
            assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            assert layer_plan(tcfg) == _layer_plan(jcfg)
            assert tcfg.param_count() == jcfg.param_count()
    hymba, xlstm = (tbase.get_config(a) for a in ARCHS)
    assert layer_plan(hymba) == [("hybrid", 1024)] * 32
    kinds = [k for k, _ in layer_plan(xlstm)]
    assert kinds.count("slstm") == 4 and kinds[5] == "slstm" and \
        kinds.count("mlstm") == 20
    # full width and depth build, CUDA by default
    for cfg in (hymba, xlstm):
        assert tbuild(cfg).cfg.num_layers == cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_matches_jax(arch):
    m = _models(arch)
    toks = _toks(4, (B, 30))
    jl = jax.jit(m["jm"].prefill_logits)(m["jdp"], jnp.asarray(toks))
    with torch.inference_mode():
        tl = m["tm"].prefill_logits(m["tdp"], torch.from_numpy(toks),
                                    device="cpu")
    _close(tl, jl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_greedy_decode_matches_jax(arch):
    """A 20-token prompt (hymba's rings of 16 wrap), then 5 greedy decode
    steps on jitted JAX and the port: equal ids, caches at every step."""
    m = _models(arch)
    toks = _toks(1, (B, S))
    jl, jc = _jit(arch, "prefill_with_cache", max_len=MAX_LEN)(
        m["jdp"], jnp.asarray(toks))
    with torch.inference_mode():
        tl, tc = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks), max_len=MAX_LEN)
        _close(tl, jl)
        for step in range(5):
            _assert_caches_close(jc, tc)
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok,
                                          err_msg=f"step {step}")
            jl, jc = _jit(arch, "decode_step")(m["jdp"], jnp.asarray(tok),
                                               jc)
            tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok),
                                         tc)
            _close(tl, jl, f"step {step}")
    _assert_caches_close(jc, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_matches_jax(arch):
    """Right-padded rows of 20 and 7 tokens: rings and carries at each
    row's own length, logits at its last real token."""
    m = _models(arch)
    toks, lens = _toks(2, (B, S)), np.array([S, 7], np.int32)
    jl, jc = _jit(arch, "prefill_with_cache", max_len=MAX_LEN)(
        m["jdp"], jnp.asarray(toks), seq_lens=jnp.asarray(lens))
    with torch.inference_mode():
        tl, tc = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks), max_len=MAX_LEN,
            seq_lens=torch.from_numpy(lens))
    _close(tl, jl)
    _assert_caches_close(jc, tc)


SPEC = dict(page_size=32, max_blocks=3, num_pages=5)


def _pools(m, b):
    """Empty JAX and port pools of ``b`` slots on the paged layout (the
    attention's ring group of hymba's window, 16 tokens: one page a row,
    mapped to pages 1..b; xlstm has no attention part)."""
    jc = m["jm"].init_caches(b, 0, paged=JPageSpec(**SPEC))
    tc = m["tm"].init_caches(b, 0, "cpu", paged=TPageSpec(**SPEC))
    table = np.arange(1, b + 1, dtype=np.int32)[:, None]
    jc = [dict(c, attn=c["attn"]._replace(block_table=jnp.asarray(table)))
          if "attn" in c else c for c in jc]
    for c in tc:
        if "attn" in c:
            c["attn"].block_table.copy_(torch.from_numpy(table))
    return jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_chunks_then_decode_match_jax(arch):
    """Two pooled chunks of 24 (row 1 idle in the second: its carries stay
    bit for bit), then a decode step of every row."""
    m = _models(arch)
    b = 3
    jc, tc = _pools(m, b)
    start = np.zeros(b, np.int32)
    jfn = _jit(arch, "prefill_with_cache")
    with torch.inference_mode():
        for i, valid in enumerate(([24, 11, 3], [24, 0, 19])):
            valid = np.asarray(valid, np.int32)
            toks = _toks(10 + i, (b, 24))
            idle = [t[1].clone() for t in _tensors(tc)]
            jl, jc = jfn(m["jdp"], jnp.asarray(toks), caches=jc,
                         start=jnp.asarray(start),
                         seq_lens=jnp.asarray(valid))
            tl, _ = m["tm"].prefill_with_cache(
                m["tdp"], torch.from_numpy(toks), caches=tc,
                start=torch.from_numpy(start),
                seq_lens=torch.from_numpy(valid))
            live = valid > 0
            _close(tl[live], np.asarray(jl)[live])
            _assert_caches_close(jc, tc)
            start = start + valid
        # row 1 was idle in the second chunk
        for t, t0 in zip(_tensors(tc), idle):
            if t.dim() and t.shape[0] == b and t.dtype == torch.float32:
                assert torch.equal(t[1], t0)
        tok = _toks(12, (b, 1))
        jl, jc = _jit(arch, "decode_step")(m["jdp"], jnp.asarray(tok), jc)
        tl, tc = m["tm"].decode_step(m["tdp"], torch.from_numpy(tok), tc)
    _close(tl, jl)
    _assert_caches_close(jc, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_recurrent_rows_restores_init_exactly(arch):
    """After a chunk dirties every row, resetting rows 0 and 2 puts their
    carries back to the exact ``init_cache`` values, in place (the same
    tensors), row 1 and the attention parts untouched; as JAX's."""
    m = _models(arch)
    b = 3
    jc, tc = _pools(m, b)
    toks, valid = _toks(13, (b, 24)), np.full(b, 24, np.int32)
    start = np.zeros(b, np.int32)
    _, jc = _jit(arch, "prefill_with_cache")(
        m["jdp"], jnp.asarray(toks), caches=jc, start=jnp.asarray(start),
        seq_lens=jnp.asarray(valid))
    fresh = np.array([True, False, True])
    jr = m["jm"].reset_recurrent_rows(jc, jnp.asarray(fresh))
    with torch.inference_mode():
        m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks), caches=tc,
            start=torch.from_numpy(start), seq_lens=torch.from_numpy(valid))
        before = [t.clone() for t in _tensors(tc)]
        ptrs = [t.data_ptr() for t in _tensors(tc)]
        out = m["tm"].reset_recurrent_rows(tc, torch.from_numpy(fresh))
    assert out is tc and [t.data_ptr() for t in _tensors(tc)] == ptrs
    init = m["tm"].init_caches(b, 0, "cpu", paged=TPageSpec(**SPEC))
    n_carries = 0
    flat = iter(before)
    for layer, lz in zip(tc, init):
        for name, part in layer.items():
            for t, z in zip(part, lz[name]):
                if not isinstance(t, torch.Tensor):
                    continue        # a paged cache's host-int ring_len
                t0 = next(flat)
                if name == "attn":
                    assert torch.equal(t, t0)
                    continue
                n_carries += 1
                assert torch.equal(t[fresh], z[fresh])
                assert torch.equal(t[1], t0[1])
    assert n_carries > 0
    _assert_caches_close(jr, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_extract_writeback_resume_round_trip(arch):
    """``test_recurrent_resume.py``'s round trip in the port: chunk 1 (32
    tokens) into slot 0, extract its mid-prefill state, park it, write it
    back into slot 1 of a fresh pool, resume chunk 2 (13 tokens) there:
    the pool equals the whole 45-token prefill inserted into slot 1,
    bitwise (the whole-prompt prefill is held to JAX's above), as JAX's
    own round trip equals its whole prefill."""
    m = _models(arch)
    tm, tdp = m["tm"], m["tdp"]
    toks = _toks(5, (45,))
    with torch.inference_mode():
        logits_w, seq = tm.prefill_with_cache(
            tdp, torch.from_numpy(toks[None]), max_len=64)
        pool_w = tkv.insert_slots(tm.init_caches(2, 64, "cpu"), seq, [1])

        def chunk_in(pool, slot, part, start):
            buf = np.zeros((1, 32), np.int32)
            buf[0, :len(part)] = part
            sub = tkv.extract_slots(pool, [slot])
            logits, sub = tm.prefill_with_cache(
                tdp, torch.from_numpy(buf), caches=sub,
                start=torch.tensor([start]),
                seq_lens=torch.tensor([len(part)]))
            return logits, tkv.writeback_slots(pool, sub, [slot])

        pool = tm.init_caches(2, 64, "cpu")
        _, pool = chunk_in(pool, 0, toks[:32], 0)
        parked = tkv.extract_slots(pool, [0])
        pool = tkv.writeback_slots(tm.init_caches(2, 64, "cpu"), parked, [1])
        logits_c, pool = chunk_in(pool, 1, toks[32:], 32)
    for a, b in zip(_tensors(pool_w), _tensors(pool)):
        assert torch.equal(a, b)
    assert torch.equal(logits_w, logits_c)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_lengths_and_cache_bytes_match_jax(arch):
    """``slot_lengths`` (xlstm: no attention, zeros of the pool size, as
    JAX's), ``cache_bytes`` (the carries count) and the bf16 equivalent
    of a pool after a ragged prefill of 2 rows inserted into slots 2 and
    0 of 3."""
    m = _models(arch)
    toks, lens = _toks(6, (B, S)), np.array([9, S], np.int32)
    _, jseq = _jit(arch, "prefill_with_cache", max_len=MAX_LEN)(
        m["jdp"], jnp.asarray(toks), seq_lens=jnp.asarray(lens))
    jpool = jkv.insert_slots(m["jm"].init_caches(3, MAX_LEN), jseq, [2, 0])
    with torch.inference_mode():
        _, seq = m["tm"].prefill_with_cache(
            m["tdp"], torch.from_numpy(toks), max_len=MAX_LEN,
            seq_lens=torch.from_numpy(lens))
        pool = tkv.insert_slots(m["tm"].init_caches(3, MAX_LEN, "cpu"), seq,
                                [2, 0])
    got = tkv.slot_lengths(pool)
    np.testing.assert_array_equal(got, np.asarray(jkv.slot_lengths(jpool)))
    assert got.shape == (3,)
    assert tkv.cache_bytes(pool) == jkv.cache_bytes(jpool)
    assert tkv.bf16_equivalent_bytes(pool) == jkv.bf16_equivalent_bytes(
        jpool)
    for p in (pool, seq):
        assert tkv.cache_bytes(p) > sum(
            t.numel() * t.element_size() for layer in p
            for name, part in layer.items() if name == "attn"
            for t in part if isinstance(t, torch.Tensor))


def _trace_calls(monkeypatch):
    """Record every kernel wrapper's call as ``recurrent_calls`` specs it:
    {(kernel, spec): calls}.  Paged decode lengths are data: (lo, hi) are
    dropped from its spec."""
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
    rec(rbmm_ops, "rbmm_int", "rbmm_int", lambda a, b, k, scheme="xnor", dc=None: (
        tuple(a.shape[:-2]), a.shape[-2], b.shape[-2], k, scheme))
    rec(mxu_ops, "rbmm_mxu", "rbmm_mxu", lambda a, w: (
        a.shape[-2], a.shape[-1], w.shape[-2], bool((a >= 0).all())))
    rec(sps_ops, "sps_attention_gqa", "sps_attention",
        lambda q, k, vt, th, d_h, causal=True, lens=None, window=0: (
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], d_h, causal,
            lens, window, 0))
    rec(paged_ops, "paged_gather_decode", "paged_gather_decode",
        lambda q, kp, vp, bt, lens, ring, th, d_h: (
            q.shape[0], q.shape[1], kp.shape[1], d_h, kp.shape[2],
            bt.shape[1], kp.shape[0] - 1, ring, 0))
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_calls_match_the_traced_path(arch, monkeypatch):
    """``kernel_times.recurrent_calls``, which sizes the card run's table
    (``RECURRENT_CALLS``) and its launch checks from a config, at smoke
    size: each path's calls and launches per step equal the kernel
    wrappers' calls in a static prefill, a static decode step, a paged
    pure-decode iteration and a mixed (unified chunk) iteration."""
    m = _models(arch)
    tm, tdp, cfg = m["tm"], m["tdp"], m["tm"].cfg
    b, s, new, slots, chunk = 2, 40, 8, 3, 32
    table = kernel_times.recurrent_calls(
        cfg, (b, s, new), slots, chunk, SPEC["page_size"],
        SPEC["max_blocks"], SPEC["num_pages"])
    seen = _trace_calls(monkeypatch)
    runs = {}
    with torch.inference_mode():
        seen.clear()
        lg, caches = tm.prefill_with_cache(
            tdp, torch.from_numpy(_toks(7, (b, s))), max_len=s + new)
        runs["prefill"] = dict(seen)
        seen.clear()
        tm.decode_step(tdp, lg.argmax(-1), caches)
        runs["decode"] = dict(seen)
        _, pool = _pools(m, slots)
        seen.clear()
        tm.prefill_with_cache(
            tdp, torch.from_numpy(_toks(8, (slots, chunk))), caches=pool,
            start=torch.zeros(slots, dtype=torch.int64),
            seq_lens=torch.tensor([chunk, 5, 0]))
        runs["mixed"] = dict(seen)
        seen.clear()
        tm.decode_step(tdp, torch.zeros(slots, 1, dtype=torch.int64), pool)
        runs["pure-decode"] = dict(seen)
    short = cfg.name.split("-")[0]
    for path, got in runs.items():
        want = collections.Counter()
        for name, (kernel, spec, n) in table.items():
            if name.startswith(f"{kernel} {short} {path} "):
                if kernel == "paged_gather_decode":
                    spec = spec[:8] + spec[10:]
                want[(kernel, spec)] += n
        assert got == dict(want), path
        assert kernel_times.path_launches(table, short, path) == {
            k: sum(n for (kk, _), n in got.items() if kk == k)
            for k in {k for k, _ in got}}
