"""The ``row`` SPS granularity in the port, against the JAX package on the
CPU.  Each query head's lambda is a table of 512 columns; a query at
absolute position p reads column min(p, 511).

A zero table (the initial lambda) is constant, so it would compute what
``head`` does and hide a wrong column: every test draws a seeded,
non-zero (H, 512) table and hands the same draw to both packages, and the
positions cross 511.  Held at the attention of a narrow config (d = 128,
4 query heads over 2 KV heads of d_h = 32): the whole-prompt prefill
(whole and ragged, 520 rows), chunks continuing ring and paged caches
across position 511 and decode steps after them (the paged decode passes
the per-(sequence, head) thresholds gathered by position), the verify and
commit; at the model: smollm-135m's smoke config with ``row``, prefill
then greedy decode.  Words, caches and lengths bitwise; fp outputs within
ATOL."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.attention import SPSAttention as JAttn
from repro.models.lm import build_model as jbuild
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models.attention import ROW_TABLE, PagedKVCache
from repro_torch.models.attention import SPSAttention as TAttn
from repro_torch.models.lm import build_model as tbuild

ATOL = 1e-4
SHAPE = dict(d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
             sps_granularity="row")
RING = 640


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _perturb(tree, rng, name=""):
    """Scales and offsets off their init values; the lambda table (zeros
    at init) drawn around 0 with a spread that moves each column's
    integer threshold."""
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
        return (a + 0.4 * rng.standard_normal(a.shape)).astype(np.float32)
    return a


@functools.lru_cache(maxsize=None)
def _attn():
    ja, ta = JAttn(**SHAPE), TAttn(**SHAPE)
    qat = _perturb(jax.tree.map(np.asarray, ja.init(jax.random.PRNGKey(5))),
                   np.random.default_rng(5))
    assert qat["sps_lambda"].shape == (4, ROW_TABLE)
    dp = jax.tree.map(np.asarray, ja.convert(qat))
    return ja, ta, jax.tree.map(jnp.asarray, dp), \
        bridge.from_jax_params(dp, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit(face: str):
    return jax.jit(getattr(_attn()[0], face),
                   static_argnames=("cache_size",)
                   if face == "deploy_prefill" else ())


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


def test_theta_table_varies_by_column():
    """The drawn table gives each head thresholds that change across the
    columns a test reads (so a wrong column would show)."""
    _, ta, _, tp = _attn()
    th = ta._theta_int(tp)
    assert th.shape == (4, ROW_TABLE) and th.dtype == torch.int32
    for cols in ((0, 40), (495, 512)):
        assert (th[:, cols[0]:cols[1]].amax(1) >
                th[:, cols[0]:cols[1]].amin(1)).all()


@pytest.mark.parametrize("ragged", [False, True])
def test_row_prefill_matches_jax(ragged):
    """520 rows: the last 9 read the table's column 511."""
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(1 + ragged)
    x = _x(rng, 2, 520)
    lens = np.array([520, 513], np.int32) if ragged else None
    jout, jc = _jit("deploy_prefill")(
        jp, jnp.asarray(x), cache_size=RING,
        seq_lens=None if lens is None else jnp.asarray(lens))
    tout, tc = ta.deploy_prefill(
        tp, torch.from_numpy(x), cache_size=RING,
        seq_lens=None if lens is None else torch.from_numpy(lens))
    _close(tout, jout)
    _same_cache(jc, tc)
    if not ragged:
        # the same table shifted by one column gives other outputs
        shifted = dict(tp, sps_lambda=torch.roll(tp["sps_lambda"], 1, 1))
        other, _ = ta.deploy_prefill(shifted, torch.from_numpy(x))
        assert not torch.allclose(other, tout)


def _empty(layout, b):
    if layout == "ring":
        return (JAttn(**SHAPE).init_cache(b, RING),
                TAttn(**SHAPE).init_cache(b, RING, "cpu"))
    nblk = RING // 32
    table = 1 + np.arange(b * nblk, dtype=np.int32).reshape(b, nblk)
    jc = JAttn(**SHAPE).init_paged_cache(b, ring_len=RING, page_size=32,
                                         num_blocks=nblk, num_pages=b * nblk)
    jc = jc._replace(block_table=jnp.asarray(table))
    tc = TAttn(**SHAPE).init_paged_cache(b, ring_len=RING, page_size=32,
                                         num_blocks=nblk, num_pages=b * nblk,
                                         device="cpu")
    tc.block_table.copy_(torch.from_numpy(table))
    return jc, tc


def _chunks(jc, tc, rng, widths):
    """Ragged chunks from position 0 (a row inactive in one); the second
    chunk's rows cross position 511.  Returns (jc, tc, lengths)."""
    ja, ta, jp, tp = _attn()
    start = np.zeros(2, np.int32)
    for valid in widths:
        valid = np.asarray(valid, np.int32)
        x = _x(rng, 2, int(valid.max()))
        jout, jc = _jit("deploy_prefill_chunk")(
            jp, jnp.asarray(x), jc, start=jnp.asarray(start),
            valid_len=jnp.asarray(valid))
        tout, tc = ta.deploy_prefill_chunk(
            tp, torch.from_numpy(x), tc, start=torch.from_numpy(start),
            valid_len=torch.from_numpy(valid))
        for r in np.nonzero(valid)[0]:
            _close(tout[r, :valid[r]], np.asarray(jout)[r, :valid[r]])
        _same_cache(jc, tc)
        start = start + valid
    return jc, tc, start


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_row_chunks_then_decode_across_511(layout):
    """Chunks of 505 / 500 then 12 / 0 / 16 rows (positions 493..520),
    then 3 decode steps at positions 505..520."""
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(7)
    jc, tc = _empty(layout, 2)
    jc, tc, start = _chunks(jc, tc, rng, ([505, 500], [12, 0], [0, 16]))
    assert list(start) == [517, 516]
    for _ in range(3):
        xt = _x(rng, 2, 1)
        jout, jc = _jit("deploy_decode")(jp, jnp.asarray(xt), jc)
        tout, tc = ta.deploy_decode(tp, torch.from_numpy(xt), tc)
        _close(tout, jout)
        _same_cache(jc, tc)


def test_row_decode_reads_each_position_column():
    """Ring decode at positions 505..513 after a prefill of 505 tokens,
    each step equal to JAX's (the columns 505..511, then 511 clamped)."""
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(9)
    x = _x(rng, 2, 505)
    _, jc = _jit("deploy_prefill")(jp, jnp.asarray(x), cache_size=RING)
    _, tc = ta.deploy_prefill(tp, torch.from_numpy(x), cache_size=RING)
    for _ in range(9):
        xt = _x(rng, 2, 1)
        jout, jc = _jit("deploy_decode")(jp, jnp.asarray(xt), jc)
        tout, tc = ta.deploy_decode(tp, torch.from_numpy(xt), tc)
        _close(tout, jout)
        _same_cache(jc, tc)


def test_row_verify_and_commit():
    """A verify of 6 candidates at positions 505..511 and 500..506 on a
    paged pool (the cache untouched), then commits of 6 and 2."""
    ja, ta, jp, tp = _attn()
    rng = np.random.default_rng(11)
    jc, tc = _empty("paged", 2)
    jc, tc, start = _chunks(jc, tc, rng, ([505, 500],))
    x = _x(rng, 2, 6)
    jout, jproj = _jit("deploy_verify_chunk")(jp, jnp.asarray(x), jc,
                                              start=jnp.asarray(start))
    tout, tproj = ta.deploy_verify_chunk(tp, torch.from_numpy(x), tc,
                                         start=torch.from_numpy(start))
    _close(tout, jout)
    _same_cache(jc, tc)
    n_commit = np.array([6, 2], np.int32)
    jc = _jit("commit_chunk")(jc, jproj, jnp.asarray(start),
                              jnp.asarray(n_commit))
    ta.commit_chunk(tc, tproj, torch.from_numpy(start),
                    torch.from_numpy(n_commit))
    _same_cache(jc, tc)


def test_row_model_prefill_then_greedy_decode():
    """smollm-135m's smoke config with ``row`` (2 layers): prefill of 508
    tokens, then 6 greedy decode steps across position 511: ids equal,
    logits within ATOL, rings bitwise."""
    jbin = dataclasses.replace(jbase.get_smoke_config("smollm-135m").binary,
                               sps_granularity="row")
    tbin = dataclasses.replace(tbase.get_smoke_config("smollm-135m").binary,
                               sps_granularity="row")
    jm = jbuild(jbase.get_smoke_config("smollm-135m").with_(
        binary=jbin, num_layers=2))
    tm = tbuild(tbase.get_smoke_config("smollm-135m").with_(
        binary=tbin, num_layers=2))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    jdp, tdp = jax.tree.map(jnp.asarray, dp), bridge.from_jax_params(
        dp, device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 508)).astype(
        np.int32)
    jl, jc = jax.jit(functools.partial(jm.prefill_with_cache, max_len=520))(
        jdp, jnp.asarray(toks))
    tl, tc = tm.prefill_with_cache(tdp, torch.from_numpy(toks), max_len=520)
    jdec = jax.jit(jm.decode_step)
    for step in range(6):
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok,
                                      err_msg=f"step {step}")
        jl, jc = jdec(jdp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tdp, torch.from_numpy(tok), tc)
    _close(tl, jl)
    for j, t in zip(jc, tc):
        _same_cache(j["attn"], t["attn"])
