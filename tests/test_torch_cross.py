"""Cross-attention and the encoder-decoder's decoder block in the port
against the JAX package on the CPU, float32.

Held: ``SPSAttention.build_memory_cache`` (K bits and V^T words bitwise,
the length) at memories of S_enc = 8 and 40 positions, so the last V^T
word carries pad bits; ``attend_memory`` at query widths S = 1 (a decode
step: the query reads row 0 of the ``row`` table, as in the JAX package)
and S = 12, over both memories, at the ``layer``, ``head`` and ``row``
granularities, with 2 query heads per KV head (G = 2: M = G*S = 2 takes
the in-flight packing, M = 24 the pack kernel's); the "dec" block of
seamless-m4t-large-v2's smoke config (causal self-attention, then
cross-attention, then the ReLU FFN): ``deploy_prefill`` with its cache
(the ring and the memory "cross", bitwise) and decode steps after it,
which read the memory and leave it unwritten; the refusals of the faces a
"dec" block lacks (ragged prefill, chunks, speculative verify).  Outputs
within ATOL + RTOL * |JAX|.  Params are the JAX package's, scales,
thresholds and the lambda tables moved off their init values, bridged
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
from repro.models import blocks as jblocks
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.models import blocks as tblocks

ATOL, RTOL = 1e-4, 1e-5
ARCH = "seamless-m4t-large-v2"
B = 2


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


def _cfgs(gran: str, kv: int):
    """The smoke config (4 heads) at ``gran`` with ``kv`` KV heads, in
    both packages."""
    out = []
    for base in (jbase, tbase):
        cfg = base.get_smoke_config(ARCH)
        out.append(cfg.with_(num_kv_heads=kv, binary=dataclasses.replace(
            cfg.binary, sps_granularity=gran)))
    return out


@functools.lru_cache(maxsize=None)
def _cross(gran: str, kv: int = 2):
    """(JAX cross module, its deploy params, the port's module, its
    params), the params the JAX package's, perturbed."""
    jcfg, tcfg = _cfgs(gran, kv)
    jm = jblocks._attn_from_cfg(jcfg, cross=True)
    qat = _perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))),
                   np.random.default_rng(1))
    dp = jax.tree.map(np.asarray, jm.convert(qat))
    tm = tblocks.Block(tcfg, kind="dec")._parts()["cross"]
    return jm, jax.tree.map(jnp.asarray, dp), tm, bridge.from_jax_params(
        dp, device="cpu")


@functools.lru_cache(maxsize=None)
def _jit_cross(gran: str, face: str):
    return jax.jit(getattr(_cross(gran)[0], face))


@functools.lru_cache(maxsize=None)
def _dec():
    jcfg, tcfg = (b.get_smoke_config(ARCH) for b in (jbase, tbase))
    jb = jblocks.Block(jcfg, kind="dec")
    qat = _perturb(jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(2))),
                   np.random.default_rng(2))
    dp = jax.tree.map(np.asarray, jb.convert(qat))
    return dict(jb=jb, jdp=jax.tree.map(jnp.asarray, dp),
                tb=tblocks.Block(tcfg, kind="dec"),
                tdp=bridge.from_jax_params(dp, device="cpu"), d=tcfg.d_model)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


def _same_cache(t, j):
    np.testing.assert_array_equal(_u32(t.k_bits), np.asarray(j.k_bits))
    np.testing.assert_array_equal(_u32(t.vt_bits), np.asarray(j.vt_bits))
    np.testing.assert_array_equal(t.length.numpy(), np.asarray(j.length))


@pytest.mark.parametrize("s_enc", [8, 40])
def test_memory_cache_words_bitwise(s_enc):
    jm, jdp, tm, tdp = _cross("head")
    mem = _x(s_enc, B, s_enc, tm.d_model)
    got = tm.build_memory_cache(tdp, torch.from_numpy(mem))
    want = _jit_cross("head", "build_memory_cache")(jdp, jnp.asarray(mem))
    assert got.k_bits.shape == (B, 2, s_enc, 1)
    assert got.vt_bits.shape == (B, 2, tm.head_dim, -(-s_enc // 32))
    _same_cache(got, want)
    # pad bits of the last V^T word stay zero
    pad = -s_enc % 32
    if pad:
        assert not (_u32(got.vt_bits)[..., -1] >> np.uint32(32 - pad)).any()


@pytest.mark.parametrize("gran", ["layer", "head", "row"])
@pytest.mark.parametrize("s_enc", [8, 40])
@pytest.mark.parametrize("s", [1, 12])
def test_attend_memory_matches_jax(s, s_enc, gran):
    jm, jdp, tm, tdp = _cross(gran)
    mem = _x(100 + s_enc, B, s_enc, tm.d_model)
    x = _x(200 + s, B, s, tm.d_model)
    with torch.inference_mode():
        tmem = tm.build_memory_cache(tdp, torch.from_numpy(mem))
        got = tm.attend_memory(tdp, torch.from_numpy(x), tmem)
    jmem = _jit_cross(gran, "build_memory_cache")(jdp, jnp.asarray(mem))
    want = _jit_cross(gran, "attend_memory")(jdp, jnp.asarray(x), jmem)
    assert got.shape == (B, s, tm.d_model)
    _close(got, want, f"S={s} S_enc={s_enc} {gran}")


def test_attend_memory_masks_past_the_memory_length():
    """Columns at or past ``mem.length`` never reach the context: a memory
    whose tail is cut by its length equals the shorter memory."""
    _, _, tm, tdp = _cross("row")
    mem = torch.from_numpy(_x(7, B, 40, tm.d_model))
    x = torch.from_numpy(_x(8, B, 12, tm.d_model))
    with torch.inference_mode():
        full = tm.build_memory_cache(tdp, mem)
        cut = full._replace(length=torch.full((B,), 33, dtype=torch.int32))
        short = tm.build_memory_cache(tdp, mem[:, :33])
        np.testing.assert_array_equal(
            tm.attend_memory(tdp, x, cut).numpy(),
            tm.attend_memory(tdp, x, short).numpy())


def test_dec_block_prefill_then_decode_matches_jax():
    m = _dec()
    jb, jdp, tb, tdp, d = m["jb"], m["jdp"], m["tb"], m["tdp"], m["d"]
    s, s_enc, max_len = 10, 40, 16
    x, mem = _x(11, B, s, d), _x(12, B, s_enc, d)
    steps = [_x(13 + i, B, 1, d) for i in range(3)]
    with torch.inference_mode():
        out, cache = tb.deploy_prefill(tdp, torch.from_numpy(x),
                                       memory=torch.from_numpy(mem),
                                       cache_size=max_len)
        assert sorted(cache) == ["attn", "cross"]
        cross = [t.clone() for t in cache["cross"]]
        outs = [tb.deploy_decode(tdp, torch.from_numpy(xs), cache)[0]
                for xs in steps]
    jout, jcache = jax.jit(functools.partial(jb.deploy_prefill,
                                             cache_size=max_len))(
        jdp, jnp.asarray(x), memory=jnp.asarray(mem))
    _close(out, jout, "prefill")
    _same_cache(cache["cross"], jcache["cross"])
    jdec = jax.jit(jb.deploy_decode)
    for i, xs in enumerate(steps):
        jo, jcache = jdec(jdp, jnp.asarray(xs), jcache)
        _close(outs[i], jo, f"decode step {i}")
    _same_cache(cache["attn"], jcache["attn"])
    # decode reads the memory and never writes it
    for a, b in zip(cross, cache["cross"]):
        assert torch.equal(a, b)


def test_dec_block_refuses_the_faces_it_lacks():
    m = _dec()
    tb, tdp, d = m["tb"], m["tdp"], m["d"]
    x = torch.from_numpy(_x(21, B, 4, d))
    mem = torch.from_numpy(_x(22, B, 8, d))
    with pytest.raises(ValueError, match="seq_lens"):
        tb.deploy_prefill(tdp, x, memory=mem,
                          seq_lens=torch.tensor([4, 3]))
    _, cache = tb.deploy_prefill(tdp, x, memory=mem, cache_size=8)
    with pytest.raises(ValueError, match="chunked prefill"):
        tb.deploy_prefill_chunk(tdp, x, cache)
    with pytest.raises(ValueError, match="speculative verify"):
        tb.deploy_verify_chunk(tdp, x, cache)
    empty = tb.init_cache(B, 8, "cpu", memory_len=8)
    assert empty["cross"].k_bits.shape == (B, 4, 8, 1)
    assert tb.init_cache(B, 8, "cpu")["cross"].k_bits.shape[2] == 1
