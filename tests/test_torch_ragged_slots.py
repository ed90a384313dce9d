"""Ragged whole-prompt prefill and the slot-surgery API of the port,
against the JAX package on the CPU.

  * ``sps_attention``'s ``lens`` operand (the port's own: the TPU kernel
    masks one global length) against the JAX package's dense oracle with
    the values of keys past each sequence's length set to 0, causal and
    bidirectional;
  * ``LMModel.prefill_with_cache(seq_lens=...)`` against JAX's, with
    lengths 1 and longer than the ring among them: logits at each row's
    last real token within ATOL, ring caches and lengths bitwise; and each
    row's ring equal to that row's own unpadded prefill;
  * ``insert_slots``, ``extract_slots``, ``writeback_slots`` and
    ``reset_slots`` on ring and paged pools against JAX's (words, block
    tables and lengths bitwise; pages 1.., since the trash page 0 takes
    colliding writes in an order neither package fixes), with a decode
    step on the extracted view between extract and write-back.

float32 smoke configs (smollm-135m, and qwen1.5-32b for the QKV bias and
G = 1); the JAX side runs jitted, as its own tests run it."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.sps_attn import ref as jsps_ref
from repro.models.attention import PageSpec as JPageSpec
from repro.models.lm import build_model as jbuild
from repro.serve import kvcache as jkv
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.kernels.sps_attn import ops as sps_ops
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.attention import PageSpec as TPageSpec
from repro_torch.models.lm import build_model as tbuild
from repro_torch.serve import kvcache as tkv

ATOL = 1e-4
S, W = 40, 32                       # padded prompt width, ring length
LENS = np.array([1, 40, 17, 33], np.int32)   # 1, > W, < W, just > W


def _t(a) -> torch.Tensor:
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _perturb(tree, rng, name=""):
    """Scales, thresholds and the QKV bias moved off their init values,
    so the binarizations and the SPS threshold are non-trivial."""
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
def _models(arch: str):
    jm = jbuild(jbase.get_smoke_config(arch))
    qat = _perturb(jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0))), np.random.default_rng(0))
    dp = jax.tree.map(np.asarray, jax.jit(jm.convert)(qat))
    return (jm, jax.tree.map(jnp.asarray, dp),
            tbuild(tbase.get_smoke_config(arch)),
            bridge.from_jax_params(dp, device="cpu"))


def _assert_cache_equal(jc, tc):
    if isinstance(tc, PagedKVCache):
        pairs = ((tc.k_pages[1:], jc.k_pages[1:]),
                 (tc.vt_pages[1:], jc.vt_pages[1:]),
                 (tc.block_table, jc.block_table))
    else:
        pairs = ((tc.k_bits, jc.k_bits), (tc.vt_bits, jc.vt_bits))
    for t, j in pairs:
        np.testing.assert_array_equal(_u32(t), np.asarray(j).astype(
            np.uint32))
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _assert_pools_equal(jpool, tpool):
    assert len(jpool) == len(tpool)
    for j, t in zip(jpool, tpool):
        _assert_cache_equal(j["attn"], t["attn"])


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=0)


# -- sps_attention's lens -------------------------------------------------------


def _words(rng, shape, k):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    pad = shape[-1] * 32 - k
    if pad:
        w[..., -1] &= np.uint32((1 << (32 - pad)) - 1)
    return w


@pytest.mark.parametrize("causal", [True, False])
def test_sps_lens_matches_jax_dense_oracle(causal):
    """GQA 4:2, d_h = 48, L = 70 over two 64-row tiles' worth of keys;
    lens 1, 70, 33 and 64.  Every row, pad rows included, equals the JAX
    oracle with keys >= lens[b] given value 0; lens = L is lens = None."""
    rng = np.random.default_rng(1)
    b, h, hkv, length, dh = 4, 4, 2, 70, 48
    lens = np.array([1, 70, 33, 64], np.int32)
    q = _words(rng, (b, h, length, 2), dh)
    k = _words(rng, (b, hkv, length, 2), dh)
    v = 2 * rng.integers(0, 2, (b, hkv, length, dh)) - 1
    vt = np.asarray(jsps_ref.v_transpose_packed(jnp.asarray(v)))
    th = rng.integers(-8, 9, (h,)).astype(np.int32)
    got = sps_ops.sps_attention_gqa(_t(q), _t(k), _t(vt), _t(th), d_h=dh,
                                    causal=causal, lens=_t(lens))
    g = h // hkv
    for i in range(b):
        vm = np.where(np.arange(length)[:, None] < lens[i], v[i], 0)
        want = jsps_ref.sps_attention(
            jnp.asarray(q[i]), jnp.asarray(np.repeat(k[i], g, 0)),
            jnp.asarray(np.repeat(vm, g, 0)), jnp.asarray(th), d_h=dh,
            causal=causal)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want),
                                      err_msg=f"sequence {i}")
    full = np.full(b, length, np.int32)
    assert torch.equal(
        sps_ops.sps_attention_gqa(_t(q), _t(k), _t(vt), _t(th), d_h=dh,
                                  causal=causal, lens=_t(full)),
        sps_ops.sps_attention_gqa(_t(q), _t(k), _t(vt), _t(th), d_h=dh,
                                  causal=causal))


def test_sps_lens_is_checked():
    z = torch.zeros((2, 2, 8, 1), dtype=torch.int32)
    vt = torch.zeros((2, 2, 32, 1), dtype=torch.int32)
    th = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="lens must be"):
        sps_ops.sps_attention_gqa(z, z, vt, th, d_h=32,
                                  lens=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="lens must be int32"):
        sps_ops.sps_attention_gqa(z, z, vt, th, d_h=32,
                                  lens=torch.zeros(2, dtype=torch.int64))


# -- ragged whole-prompt prefill ------------------------------------------------


def _ragged_tokens(seed):
    toks = np.random.default_rng(seed).integers(0, 256, (len(LENS), S))
    return np.where(np.arange(S) < LENS[:, None], toks, 0).astype(np.int32)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen1.5-32b"])
def test_ragged_prefill_matches_jax(arch):
    jm, jdp, tm, tdp = _models(arch)
    toks = _ragged_tokens(2)
    jl, jc = jax.jit(functools.partial(jm.prefill_with_cache, max_len=W))(
        jdp, jnp.asarray(toks), seq_lens=jnp.asarray(LENS))
    tl, tc = tm.prefill_with_cache(tdp, torch.from_numpy(toks), max_len=W,
                                   seq_lens=torch.from_numpy(LENS))
    assert tl.shape == (len(LENS), 1, 256)
    _close(tl, jl)
    for j, t in zip(jc, tc):
        _assert_cache_equal(j["attn"], t["attn"])
    # the caller's lengths are not the cache's: a decode step moves only
    # the latter
    seq_lens = torch.from_numpy(LENS.copy())
    _, tc = tm.prefill_with_cache(tdp, torch.from_numpy(toks), max_len=W,
                                  seq_lens=seq_lens)
    tm.decode_step(tdp, torch.zeros((len(LENS), 1), dtype=torch.int32), tc)
    assert torch.equal(seq_lens, torch.from_numpy(LENS))
    assert torch.equal(tc[0]["attn"].length, seq_lens + 1)


def test_ragged_rows_equal_their_own_prefill():
    """Each row of the ragged batch gives the ring and, within ATOL, the
    logits of that row's prompt prefilled alone at its own length."""
    _, _, tm, tdp = _models("qwen1.5-32b")
    toks = _ragged_tokens(3)
    tl, tc = tm.prefill_with_cache(tdp, torch.from_numpy(toks), max_len=W,
                                   seq_lens=torch.from_numpy(LENS))
    for i, n in enumerate(LENS):
        ol, oc = tm.prefill_with_cache(
            tdp, torch.from_numpy(toks[i:i + 1, :n]), max_len=W)
        _close(tl[i:i + 1], ol.numpy())
        for t, o in zip(tc, oc):
            t, o = t["attn"], o["attn"]
            assert torch.equal(t.k_bits[i:i + 1], o.k_bits)
            assert torch.equal(t.vt_bits[i:i + 1], o.vt_bits)
            assert int(t.length[i]) == int(o.length[0]) == n


# -- slot surgery ---------------------------------------------------------------


SLOTS, INSERT_AT, EXTRACT = 5, [3, 0, 4, 1], [4, 1]
PAGE, BLOCKS, PAGES = 32, 3, 12
TABLE = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0], [6, 7, 8],
                  [9, 10, 11]], np.int32)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_slot_surgery_matches_jax(layout):
    """insert four ragged prefills into a pool of five slots, extract two,
    decode one token on the view, write it back, reset one slot: every
    step's pool (and the view) equal to JAX's."""
    jm, jdp, tm, tdp = _models("smollm-135m")
    toks = _ragged_tokens(4)
    # paged: wrap-free rings of 64 (two pages of 32), the longest prompt 40
    ring = W if layout == "ring" else 2 * PAGE
    _, jseq = jax.jit(functools.partial(jm.prefill_with_cache,
                                        max_len=ring))(
        jdp, jnp.asarray(toks), seq_lens=jnp.asarray(LENS))
    _, tseq = tm.prefill_with_cache(tdp, torch.from_numpy(toks),
                                    max_len=ring,
                                    seq_lens=torch.from_numpy(LENS))
    if layout == "ring":
        jpool = jm.init_caches(SLOTS, W)
        tpool = tm.init_caches(SLOTS, W, "cpu")
    else:
        jpool = jm.init_caches(SLOTS, 0, paged=JPageSpec(
            page_size=PAGE, max_blocks=BLOCKS, num_pages=PAGES))
        tpool = tm.init_caches(SLOTS, 0, "cpu", paged=TPageSpec(
            page_size=PAGE, max_blocks=BLOCKS, num_pages=PAGES))
        jpool = [dict(c, attn=c["attn"]._replace(
            block_table=jnp.asarray(TABLE))) for c in jpool]
        for c in tpool:
            c["attn"].block_table.copy_(torch.from_numpy(TABLE))
    _assert_pools_equal(jpool, tpool)
    jpool = jkv.insert_slots(jpool, jseq, INSERT_AT)
    assert tkv.insert_slots(tpool, tseq, INSERT_AT) is tpool
    _assert_pools_equal(jpool, tpool)

    jview = jkv.extract_slots(jpool, jnp.asarray(EXTRACT))
    tview = tkv.extract_slots(tpool, EXTRACT)
    _assert_pools_equal(jview, tview)
    if layout == "paged":        # the view shares the pool's pages
        assert tview[0]["attn"].k_pages is tpool[0]["attn"].k_pages
    tok = np.array([[7], [200]], np.int32)
    jl, jview = jax.jit(jm.decode_step)(jdp, jnp.asarray(tok), jview)
    tl, tview = tm.decode_step(tdp, torch.from_numpy(tok), tview)
    _close(tl, jl)
    jpool = jkv.writeback_slots(jpool, jview, jnp.asarray(EXTRACT))
    assert tkv.writeback_slots(tpool, tview, EXTRACT) is tpool
    _assert_pools_equal(jpool, tpool)
    lengths = tkv.slot_lengths(tpool)
    np.testing.assert_array_equal(lengths, [LENS[1], LENS[3] + 1, 0,
                                            LENS[0], LENS[2] + 1])

    jpool = jkv.reset_slots(jpool, [3])
    assert tkv.reset_slots(tpool, [3]) is tpool
    _assert_pools_equal(jpool, tpool)
    assert tkv.slot_lengths(tpool)[3] == 0
