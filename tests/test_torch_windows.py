"""Sliding windows in the port, against the JAX package on the CPU.

Held here, at the attention of the gemma3 smoke config (d = 128, 4 query
heads over 2 KV heads of d_h = 32, window 8, RoPE at theta 1e6):
  * ``sps_attention``'s plain version with its own operands (``window``,
    ``lens``, a row table of thresholds) against the JAX package's jnp
    masked attention (``SPSAttention._mask`` and ``_theta_rows``), and
    without them against the JAX kernel in interpret mode;
  * the windowed whole-prompt prefill, whole and ragged, below, at and
    above ``window + q_chunk`` (JAX takes its sliced ``window_chunk``
    path only above; both give the same integers), and once against the
    full-attention output on the same input (the window must show);
  * ring decode on a ring of the window, across its wrap;
  * chunk prefill with the window on ring and paged caches (a paged ring
    group of 8 tokens on pages of 32), then a decode step;
  * the speculative verify and commit on a wrapped windowed ring.
Words, caches and lengths bitwise; fp outputs within ATOL (the frameworks
sum RoPE and the output scale in other orders)."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.kernels.sps_attn import kernel as jsk
from repro.models.attention import SPSAttention as JAttn
from repro_torch import bridge
from repro_torch.kernels.sps_attn import ops as tsops
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.attention import SPSAttention as TAttn

ATOL = 1e-4
WINDOW = 8
SHAPE = dict(d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
             rope_theta=1_000_000.0)


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _words(rng, shape, k):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = shape[-1] * 32 - k
    if pad:
        w[..., -1] &= np.uint32((1 << (32 - pad)) - 1)
    return w


# -- the kernel's plain version ------------------------------------------------


def _jax_masked(q, k, vt, theta, d_h, lens, window):
    """The JAX package's jnp masked attention on packed words: scores by
    ``packing.xnor_popcount_score``, thresholds by ``_theta_rows``, the
    mask by ``_mask`` (causal, window) and ``seq_lens`` as its prefill
    body applies them, the and_dc context by popcount."""
    b, h, length, _ = q.shape
    g = h // k.shape[1]
    attn = JAttn(d_model=32, num_heads=h, num_kv_heads=k.shape[1],
                 head_dim=d_h, sps_granularity="row" if theta.ndim == 2
                 else "head")
    kh, vth = np.repeat(k, g, 1), np.repeat(vt, g, 1)
    c = jpacking.xnor_popcount_score(jnp.asarray(q)[:, :, :, None],
                                     jnp.asarray(kh)[:, :, None], d_h)
    rows = jnp.arange(length)
    th = attn._theta_rows(jnp.asarray(theta), rows)[None]
    m = attn._mask(rows, rows, length, window or None)[None, None]
    if lens is not None:
        m = m & (rows[None, None, None, :] <
                 jnp.asarray(lens)[:, None, None, None])
    probs = jnp.where(m, (c >= th).astype(jnp.uint32), jnp.uint32(0))
    pc = jax.lax.population_count(
        jpacking.pack_bits(probs)[:, :, :, None, :] &
        jnp.asarray(vth)[:, :, None]).astype(jnp.int32).sum(-1)
    return np.asarray(2 * pc - probs.sum(-1, dtype=jnp.int32)[..., None])


@pytest.mark.parametrize("case", [
    dict(window=1), dict(window=5, lens=(40, 17)),
    dict(rows=16), dict(window=7, rows=24, lens=(3, 40))])
def test_sps_plain_operands_match_jax_masked(case):
    """L = 40 (the row tables of 16 and 24 columns clamp), GQA 2:1,
    d_h = 48 (pad bits), causal."""
    rng = np.random.default_rng(len(str(case)))
    b, h, hkv, length, dh = 2, 4, 2, 40, 48
    q = _words(rng, (b, h, length, 2), dh)
    k = _words(rng, (b, hkv, length, 2), dh)
    vt = _words(rng, (b, hkv, dh, 2), length)
    cols = case.get("rows")
    theta = rng.integers(-8, 9, (h, cols) if cols else (h,)).astype(
        np.int32)
    lens = case.get("lens")
    window = case.get("window", 0)
    got = tsops.sps_attention_gqa(
        _t(q), _t(k), _t(vt), _t(theta), d_h=dh, causal=True,
        lens=None if lens is None else torch.tensor(lens, dtype=torch.int32),
        window=window)
    want = _jax_masked(q, k, vt, theta, dh, lens, window)
    np.testing.assert_array_equal(got.numpy(), want)
    full = tsops.sps_attention_gqa(_t(q), _t(k), _t(vt),
                                   _t(theta[:, 0] if cols else theta),
                                   d_h=dh, causal=True)
    assert not torch.equal(got, full), "the operands must show"


@pytest.mark.parametrize("causal", [True, False])
def test_sps_plain_without_operands_matches_jax_kernel(causal):
    """window = 0 and an (H,) theta: the JAX kernel's contract, held to
    that kernel in interpret mode."""
    rng = np.random.default_rng(11 + causal)
    h, length, dh = 3, 77, 48
    q = _words(rng, (1, h, length, 2), dh)
    k = _words(rng, (1, 1, length, 2), dh)
    vt = _words(rng, (1, 1, dh, 3), length)
    th = rng.integers(-8, 9, (h,)).astype(np.int32)
    got = tsops.sps_attention_gqa(_t(q), _t(k), _t(vt), _t(th), d_h=dh,
                                  causal=causal, window=0)
    want = jsk.sps_attention(
        jnp.asarray(q[0]), jnp.asarray(np.repeat(k[0], h, 0)),
        jnp.asarray(np.repeat(vt[0], h, 0)), jnp.asarray(th), d_h=dh,
        causal=causal, bq=32, bk=32, interpret=True)
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(want))


# -- the attention module ------------------------------------------------------


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
def _attn():
    ja, ta = JAttn(**SHAPE), TAttn(**SHAPE)
    qat = _perturb(jax.tree.map(np.asarray, ja.init(jax.random.PRNGKey(3))),
                   np.random.default_rng(3))
    dp = jax.tree.map(np.asarray, ja.convert(qat))
    return ja, ta, jax.tree.map(jnp.asarray, dp), \
        bridge.from_jax_params(dp, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit(face: str):
    """The JAX attention's face, jitted (the window and sizes static)."""
    static = {"deploy_prefill": ("window", "cache_size"),
              "deploy_prefill_chunk": ("window",),
              "deploy_verify_chunk": ("window",)}.get(face, ())
    return jax.jit(getattr(_attn()[0], face), static_argnames=static)


def _x(rng, b, s):
    return rng.standard_normal((b, s, SHAPE["d_model"])).astype(np.float32)


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def _same_cache(jc, tc) -> None:
    if isinstance(tc, PagedKVCache):
        pairs = ((tc.k_pages[1:], jc.k_pages[1:]),
                 (tc.vt_pages[1:], jc.vt_pages[1:]))
    else:
        pairs = ((tc.k_bits, jc.k_bits), (tc.vt_bits, jc.vt_bits))
    for t, j in pairs:
        np.testing.assert_array_equal(_u32(t), np.asarray(j))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("s", [200, 264, 300])
def test_windowed_prefill_matches_jax(s, ragged):
    """S below, at and above window + q_chunk (8 + 256); the ring of the
    window keeps each row's last 8 tokens."""
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(s + ragged)
    x = _x(rng, 2, s)
    lens = np.array([s, s - 37], np.int32) if ragged else None
    jout, jc = _jit("deploy_prefill")(
        jp, jnp.asarray(x), window=WINDOW, cache_size=WINDOW,
        seq_lens=None if lens is None else jnp.asarray(lens))
    tout, tc = ta.deploy_prefill(
        tp, torch.from_numpy(x), window=WINDOW, cache_size=WINDOW,
        seq_lens=None if lens is None else torch.from_numpy(lens))
    _close(tout, jout)
    _same_cache(jc, tc)
    if s == 300 and not ragged:
        full, _ = ta.deploy_prefill(tp, torch.from_numpy(x))
        assert not torch.allclose(full, tout), "the window must show"


def test_ring_decode_across_the_wrap():
    """A ring of the window (8) after a prefill of 5 tokens (and of 11, a
    ring already wrapped), then 7 decode steps: every step's output and
    ring equal to JAX's."""
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(21)
    for s in (5, 11):
        x = _x(rng, 2, s)
        _, jc = _jit("deploy_prefill")(jp, jnp.asarray(x), window=WINDOW,
                                       cache_size=WINDOW)
        _, tc = ta.deploy_prefill(tp, torch.from_numpy(x), window=WINDOW,
                                  cache_size=WINDOW)
        for step in range(7):
            xt = _x(rng, 2, 1)
            jout, jc = _jit("deploy_decode")(jp, jnp.asarray(xt), jc)
            tout, tc = ta.deploy_decode(tp, torch.from_numpy(xt), tc)
            _close(tout, jout)
            _same_cache(jc, tc)
        assert int(tc.length[0]) == s + 7 > WINDOW


def _empty(layout, b):
    """Empty JAX and port caches: rings of the window, or a paged ring
    group of 8 tokens (one page of 32 a row)."""
    if layout == "ring":
        return (JAttn(**SHAPE).init_cache(b, WINDOW),
                TAttn(**SHAPE).init_cache(b, WINDOW, "cpu"))
    table = np.arange(1, b + 1, dtype=np.int32)[:, None]
    jc = JAttn(**SHAPE).init_paged_cache(b, ring_len=WINDOW, page_size=32,
                                         num_blocks=1, num_pages=b)
    jc = jc._replace(block_table=jnp.asarray(table))
    tc = TAttn(**SHAPE).init_paged_cache(b, ring_len=WINDOW, page_size=32,
                                         num_blocks=1, num_pages=b,
                                         device="cpu")
    tc.block_table.copy_(torch.from_numpy(table))
    return jc, tc


def _chunks(jc, tc, rng):
    """Ragged chunks of 12 (wider than the window) from 0, a row inactive
    in the second; returns (jc, tc, lengths)."""
    ja, ta, jp, tp = _attn()
    start = np.zeros(3, np.int32)
    for valid in ([12, 5, 3], [12, 0, 11], [4, 9, 12]):
        valid = np.asarray(valid, np.int32)
        x = _x(rng, 3, 12)
        jout, jc = _jit("deploy_prefill_chunk")(
            jp, jnp.asarray(x), jc, window=WINDOW, start=jnp.asarray(start),
            valid_len=jnp.asarray(valid))
        tout, tc = ta.deploy_prefill_chunk(
            tp, torch.from_numpy(x), tc, window=WINDOW,
            start=torch.from_numpy(start), valid_len=torch.from_numpy(valid))
        for r in np.nonzero(valid)[0]:
            _close(tout[r, :valid[r]], np.asarray(jout)[r, :valid[r]])
        _same_cache(jc, tc)
        start = start + valid
    return jc, tc, start


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_windowed_chunks_then_decode(layout):
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(31)
    jc, tc = _empty(layout, 3)
    jc, tc, _ = _chunks(jc, tc, rng)
    xt = _x(rng, 3, 1)
    jout, jc = _jit("deploy_decode")(jp, jnp.asarray(xt), jc)
    tout, tc = ta.deploy_decode(tp, torch.from_numpy(xt), tc)
    _close(tout, jout)
    _same_cache(jc, tc)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_windowed_verify_and_commit(layout):
    """A verify of 6 candidates on wrapped windowed rings (the cache
    untouched), then commits of 2, 0 and 6."""
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(41)
    jc, tc = _empty(layout, 3)
    jc, tc, start = _chunks(jc, tc, rng)
    x = _x(rng, 3, 6)
    jout, jproj = _jit("deploy_verify_chunk")(jp, jnp.asarray(x), jc,
                                              window=WINDOW,
                                              start=jnp.asarray(start))
    tout, tproj = ta.deploy_verify_chunk(tp, torch.from_numpy(x), tc,
                                         window=WINDOW,
                                         start=torch.from_numpy(start))
    _close(tout, jout)
    _same_cache(jc, tc)
    n_commit = np.array([2, 0, 6], np.int32)
    jc = _jit("commit_chunk")(jc, jproj, jnp.asarray(start),
                              jnp.asarray(n_commit))
    assert ta.commit_chunk(tc, tproj, torch.from_numpy(start),
                           torch.from_numpy(n_commit)) is tc
    _same_cache(jc, tc)
